"""kernels.decompress_roofline: the least bytes of the decompress calls over
the card's HBM bandwidth, as a share (%) of the summed time of every kernel
event inside them, whatever its name."""

from harness import reduce


def read(run):
    return reduce.kernels_roofline(run, "decompress")
