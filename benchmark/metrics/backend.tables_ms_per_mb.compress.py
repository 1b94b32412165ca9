"""backend.tables_ms_per_mb.compress: the compress calls' code tables on the
host: the summed duration of the program's ``shafa.backend.tables`` spans
inside them (each pack batch's packed sizes and K1's tables, built on the
host and uploaded), per MB of input."""

from harness import program_spans


def read(run):
    return program_spans.span_ms_per_mb(run, "compress",
                                        "shafa.backend.tables")
