"""kernels.wide_decode_roofline: the 17-32-bit decode route's share of its
roofline. Of the decompress calls that hold a
``shafa.backend.decode_batch32`` span and no ``shafa.backend.decode_batch``
span (every block on that route), the least bytes (the archive read and
the file restored, ``reduce.least_bytes``) over the card's HBM bandwidth,
as a share (%) of the summed time of the kernel events that start inside
those calls' ``decode_batch32`` spans (K5, K6, K1's bits variant, K4 and
the small kernels between them, whatever their names). None where no call
qualifies."""

import bisect

from harness import peaks, reduce
from harness.trace import in_windows

WIDE, NARROW = "shafa.backend.decode_batch32", "shafa.backend.decode_batch"


def read(run):
    bw = peaks.HBM_BYTES_PER_S.get(run.device_kind)
    calls = sorted((c for c in run.of("decompress") if c.span_us),
                   key=lambda c: c.span_us)
    if bw is None or not calls:
        return None
    starts = [c.span_us[0] for c in calls]
    wide = [[] for _ in calls]
    narrow = set()
    for s in run.spans:
        if s.name not in (WIDE, NARROW):
            continue
        j = bisect.bisect_right(starts, s.start_us) - 1
        if j < 0 or s.start_us >= calls[j].span_us[1]:
            continue
        if s.name == WIDE:
            wide[j].append((s.start_us, s.end_us))
        else:
            narrow.add(j)
    chosen = [j for j, w in enumerate(wide) if w and j not in narrow]
    windows = sorted(w for j in chosen for w in wide[j])
    kernel_s = sum(e.end_us - e.start_us
                   for e in in_windows(run.device_events, windows)
                   if e.cat == "kernel") / 1e6
    if kernel_s <= 0:
        return None
    return sum(reduce.least_bytes(run, calls[j]) for j in chosen) \
        / bw / kernel_s * 100.0
