"""dist.run_ms_per_mb.decompress: the decompress calls' wait on their cards:
the summed duration of the program's ``shafa.dist.run`` spans inside
them (on the calling thread, each call of ``dist.ShardedBackend`` from
handing its block ranges to the cards' workers to the last result),
per MB restored. None with one card, or from a program without the span."""

from harness import program_spans


def read(run):
    return program_spans.span_ms_per_mb(run, "decompress", "shafa.dist.run")
