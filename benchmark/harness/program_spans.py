"""Readings of the program's own spans (``shafa_tpu_torch/tracing.py``).

The traced run's trace holds every ``record_function`` range as a span
(``trace.read``); the program names its own ``shafa.<layer>.<step>``. A
span counts for a call when it starts inside the call's
``bench.call.<direction>`` span. A checkout of the program without these
spans gives None.
"""

from __future__ import annotations

import bisect


def span_ms_per_mb(run, direction: str, prefix: str):
    """Summed duration of the spans whose names start with prefix inside
    the direction's calls, in ms per MB (10^6 bytes) of those calls' pool
    files; None where the calls hold no such span."""
    cs = [c for c in run.of(direction) if c.span_us]
    windows = sorted(c.span_us for c in cs)
    starts = [a for a, _ in windows]
    total_us, found = 0.0, False
    for s in run.spans:
        if not s.name.startswith(prefix):
            continue
        j = bisect.bisect_right(starts, s.start_us) - 1
        if j >= 0 and s.start_us < windows[j][1]:
            total_us += s.end_us - s.start_us
            found = True
    if not found:
        return None
    return total_us / 1e3 / (sum(c.file_bytes for c in cs) / 1e6)
