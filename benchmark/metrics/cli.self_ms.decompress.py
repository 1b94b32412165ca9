"""cli.self_ms.decompress: the CLI's own time in a decompress: each call's wall
less the wall of the pipeline entry it calls, both on the host's clock (the
probes' wrapper), mean over the window's calls, in ms."""

from harness import reduce


def read(run):
    return reduce.cli_self_ms(run, "decompress")
