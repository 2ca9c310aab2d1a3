"""Input megapixels of every image completed in the window over the window's seconds."""

from benchmark.harness.readers import mpxPerSecond


def read(run):
    return mpxPerSecond(run, "inPx")
