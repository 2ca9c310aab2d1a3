"""Device ms an output frame in host-to-device and device-to-host copies (fromBuffer and toFloatHost)."""

from benchmark.harness.readers import copyMs


def read(run):
    return copyMs(run)
