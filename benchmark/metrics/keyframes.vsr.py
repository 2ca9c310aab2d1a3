"""EDVR calls an output frame: the program's vsr_keyframes counts over its vsr_frames counts (both once a backward chunk)."""

from benchmark.harness.spans import counts, inWindow


def read(run):
    events = inWindow(run)
    if events is None:
        return None
    frames = sum(counts(events, "vsr_frames"))
    return sum(counts(events, "vsr_keyframes")) / frames if frames else None
