"""Arithmetic shared by the metric readers (``metrics/<name>.py``).

Host-clock numbers come from the calls' walls; traced numbers from the
spans the probes recorded and from the device events of the trace that
start inside a call's ``bench.call.<direction>`` span. "Per MB" is per
10^6 bytes of the pool file that the call compressed or restored.
"""

from __future__ import annotations

import numpy as np

from . import peaks
from .trace import in_windows, union_us


def _mb(calls) -> float:
    return sum(c.file_bytes for c in calls) / 1e6


def rate_mb_s(run, direction: str):
    """MB of every call of the direction over the sum of their walls."""
    cs = run.of(direction)
    walls = sum(c.wall_s for c in cs)
    return _mb(cs) / walls if cs and walls > 0 else None


def p95_ms(run, direction: str):
    walls = [c.wall_s for c in run.of(direction)]
    return float(np.percentile(walls, 95)) * 1e3 if walls else None


def cli_self_ms(run, direction: str):
    """Mean of each call's wall less its pipeline entry's wall."""
    cs = [c for c in run.of(direction) if c.pipeline_s is not None]
    if not cs:
        return None
    return sum(c.wall_s - c.pipeline_s for c in cs) / len(cs) * 1e3


def pipeline_host_ms_per_mb(run, direction: str):
    """The pipeline entry's wall less its thread's time in the backend's
    methods, per MB."""
    cs = [c for c in run.of(direction)
          if c.pipeline_s is not None and c.backend_s is not None]
    if not cs:
        return None
    return sum(c.pipeline_s - c.backend_s for c in cs) * 1e3 / _mb(cs)


def module_t_ms_per_mb(run):
    cs = [c for c in run.of("compress") if c.module_t_ms is not None]
    return sum(c.module_t_ms for c in cs) / _mb(cs) if cs else None


def _traced(run, direction: str):
    """The direction's calls that have a span, their spans sorted, and the
    device events inside them; None where the trace has no device work."""
    cs = [c for c in run.of(direction) if c.span_us]
    if not cs or not run.device_events:
        return None
    windows = sorted(c.span_us for c in cs)
    return cs, windows, in_windows(run.device_events, windows)


def device_ms_per_mb(run, direction: str, cat: str):
    """Summed device time of the events of category cat, per MB."""
    t = _traced(run, direction)
    if t is None:
        return None
    cs, _, events = t
    return sum(e.end_us - e.start_us for e in events
               if e.cat == cat) / 1e3 / _mb(cs)


def least_bytes(run, call) -> int:
    """The bytes any implementation must move for a call: the input, the
    .rle and the archive of a compress; the archive and the restored file
    of a decompress."""
    comp = next(c for c in run.calls
                if c.direction == "compress" and c.index == call.index)
    archive = sum(size for suffix, (size, _) in comp.outputs.items()
                  if suffix.endswith(".shaf"))
    if call.direction == "decompress":
        return archive + call.file_bytes
    rle = comp.outputs.get(".rle", (0, ""))[0]
    return call.file_bytes + rle + archive


def kernels_roofline(run, direction: str):
    """The least bytes over the card's HBM bandwidth, as a share (%) of
    the summed time of every kernel inside the direction's calls."""
    bw = peaks.HBM_BYTES_PER_S.get(run.device_kind)
    t = _traced(run, direction)
    if bw is None or t is None:
        return None
    cs, _, events = t
    kernel_s = sum(e.end_us - e.start_us for e in events
                   if e.cat == "kernel") / 1e6
    if kernel_s <= 0:
        return None
    return sum(least_bytes(run, c) for c in cs) / bw / kernel_s * 100.0


def idle_share(run, direction: str):
    """1 - the union of device work inside the direction's calls over the
    sum of their spans, in %, averaged over the cell's cards."""
    t = _traced(run, direction)
    if t is None:
        return None
    _, windows, events = t
    span_us = sum(b - a for a, b in windows)
    shares = []
    for d in range(run.chips):
        busy = union_us((e.start_us, e.end_us) for e in events
                        if e.device == d)
        shares.append(1.0 - busy / span_us)
    return sum(shares) / len(shares) * 100.0
