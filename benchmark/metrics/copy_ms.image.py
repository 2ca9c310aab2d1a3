"""Device ms an image in host-to-device and device-to-host copies (the chain's upload and toFloatHost)."""

from benchmark.harness.readers import copyMs


def read(run):
    return copyMs(run)
