"""backend.copy_ms_per_mb.compress: summed device time of the trace's
gpu_memcpy events (host to device and back) inside the compress calls, per
MB."""

from harness import reduce


def read(run):
    return reduce.device_ms_per_mb(run, "compress", "gpu_memcpy")
