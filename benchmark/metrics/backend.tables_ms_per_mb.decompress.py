"""backend.tables_ms_per_mb.decompress: the decompress calls' code tables on
the host: the summed duration of the program's ``shafa.backend.tables``
spans inside them (each decode batch's K2/K3 or K5/K6 tables, built on the
host and uploaded), per MB restored."""

from harness import program_spans


def read(run):
    return program_spans.span_ms_per_mb(run, "decompress",
                                        "shafa.backend.tables")
