"""pipeline.file_io_ms_per_mb.decompress: the decompress calls' file IO: the
summed duration of the program's ``shafa.io.*`` spans (a file's open,
reads or writes, close and rename: the .cod, the archive and the restored
file) inside them, per MB restored."""

from harness import program_spans


def read(run):
    return program_spans.span_ms_per_mb(run, "decompress", "shafa.io.")
