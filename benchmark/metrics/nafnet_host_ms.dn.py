"""Host ms an image inside the program's moe.nafnet.* spans (the encoder, the middle blocks, the decoder, once each a model call): the host's issue of NAFNet's work (on the card, each stage's CUDA graph replay; elsewhere its Python and launches), and any wait for the card inside it.  None where the window holds no such span."""

from benchmark.harness.spans import inWindow, perItem, union


def read(run):
    spans = [(s, e) for n, s, e in inWindow(run) or () if n.startswith("moe.nafnet.")]
    return perItem(run, union(spans) * 1e3) if spans else None
