"""codes.module_t_ms_per_mb: module T's runtime_ms, as the program's own --json
report gives it (the code build and the .cod writer), summed over the
window's compresses, per MB."""

from harness import reduce


def read(run):
    return reduce.module_t_ms_per_mb(run)
