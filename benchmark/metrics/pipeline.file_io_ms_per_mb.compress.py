"""pipeline.file_io_ms_per_mb.compress: the compress calls' file IO: the
summed duration of the program's ``shafa.io.*`` spans (a file's open,
reads or writes, close and rename: the input and the four sidecars) inside
them, per MB of input."""

from harness import program_spans


def read(run):
    return program_spans.span_ms_per_mb(run, "compress", "shafa.io.")
