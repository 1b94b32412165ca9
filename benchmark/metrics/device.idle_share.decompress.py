"""device.idle_share.decompress: 1 - the union of kernel, memcpy and memset
intervals inside the decompress calls over the sum of their spans, in %, the
mean over the cards."""

from harness import reduce


def read(run):
    return reduce.idle_share(run, "decompress")
