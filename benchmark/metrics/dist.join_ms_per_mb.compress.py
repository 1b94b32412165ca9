"""dist.join_ms_per_mb.compress: the compress calls' joins of their
cards' results on the host: the summed duration of the program's
``shafa.dist.join`` spans inside them (arrays concatenated in block
order, lists of rows joined), per MB of input. None with one card, or from a
program without the span."""

from harness import program_spans


def read(run):
    return program_spans.span_ms_per_mb(run, "compress", "shafa.dist.join")
