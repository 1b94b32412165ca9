"""device.idle_share.compress: 1 - the union of kernel, memcpy and memset
intervals inside the compress calls over the sum of their spans, in %, the
mean over the cards."""

from harness import reduce


def read(run):
    return reduce.idle_share(run, "compress")
