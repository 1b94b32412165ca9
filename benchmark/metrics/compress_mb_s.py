"""compress_mb_s: MB (10^6 bytes) of every compress of the window over the sum
of those calls' walls (host clock around cli.main, closed after a sync)."""

from harness import reduce


def read(run):
    return reduce.rate_mb_s(run, "compress")
