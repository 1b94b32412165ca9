"""dist.join_ms_per_mb.decompress: the decompress calls' joins of their
cards' results on the host: the summed duration of the program's
``shafa.dist.join`` spans inside them (arrays concatenated in block
order, lists of rows joined), per MB restored. None with one card, or from a
program without the span."""

from harness import program_spans


def read(run):
    return program_spans.span_ms_per_mb(run, "decompress", "shafa.dist.join")
