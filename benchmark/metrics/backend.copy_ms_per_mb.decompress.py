"""backend.copy_ms_per_mb.decompress: summed device time of the trace's
gpu_memcpy events (host to device and back) inside the decompress calls, per
MB."""

from harness import reduce


def read(run):
    return reduce.device_ms_per_mb(run, "decompress", "gpu_memcpy")
