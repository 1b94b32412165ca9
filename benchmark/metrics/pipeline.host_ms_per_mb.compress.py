"""pipeline.host_ms_per_mb.compress: the pipeline stages' own host time in a
compress: the pipeline entry's wall less the time its thread spends inside
public methods of the backend, per MB."""

from harness import reduce


def read(run):
    return reduce.pipeline_host_ms_per_mb(run, "compress")
