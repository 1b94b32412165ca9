"""The traced run's profiler, and the reduction of its trace.

``torch.profiler`` over the window, host activity and the cards'; the trace
is exported as Chrome JSON into the run's temporary directory, read, and
deleted. Device work is the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events (the categories of
``shafa_tpu_torch/profile_main_path.py::DEVICE_CATS``); spans are its
``user_annotation`` events, the record_function ranges that the harness
opens. ``union_us`` is the interval union of ``profile_main_path``'s
``device_busy``.
"""

from __future__ import annotations

import bisect
import collections
import json
import os

import torch

from .record import DeviceEvent, Span

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profiler(cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def read(prof, path: str) -> tuple[list, list, int]:
    """(device events, spans, bytes of the exported trace) of a finished
    profile."""
    prof.export_chrome_trace(path)
    size = os.path.getsize(path)
    try:
        with open(path) as fp:
            events = json.load(fp).get("traceEvents", [])
    finally:
        os.remove(path)
    dev, spans = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        ts, dur = float(ev["ts"]), float(ev["dur"])
        cat = ev.get("cat")
        if cat in DEVICE_CATS:
            args = ev.get("args") or {}
            dev.append(DeviceEvent(int(args.get("device", ev.get("pid", 0))),
                                   cat, str(ev.get("name", "?")), ts,
                                   ts + dur))
        elif cat == "user_annotation":
            spans.append(Span(str(ev.get("name", "?")), ts, ts + dur))
    dev.sort(key=lambda e: e.start_us)
    spans.sort(key=lambda s: s.start_us)
    return dev, spans, size


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def busy_intervals(intervals) -> list[tuple[float, float]]:
    """The union of intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def in_windows(events, windows) -> list:
    """The events that start inside one of the sorted, disjoint
    (start, end) windows, each clipped to its window."""
    starts = [w[0] for w in windows]
    out = []
    for e in events:
        j = bisect.bisect_right(starts, e.start_us) - 1
        if j >= 0 and e.start_us < windows[j][1]:
            out.append(DeviceEvent(e.device, e.cat, e.name, e.start_us,
                                   min(e.end_us, windows[j][1])))
    return out


def attach_spans(calls, spans) -> None:
    """Give each call the span its ``bench.call.<direction>`` range has in
    the trace (the k-th such range is the k-th call of that direction)."""
    by_dir = collections.defaultdict(list)
    for s in spans:
        if s.name.startswith("bench.call."):
            by_dir[s.name[len("bench.call."):]].append(s)
    for direction, ranges in by_dir.items():
        mine = [c for c in calls if c.direction == direction]
        for c, s in zip(mine, ranges):
            c.span_us = (s.start_us, s.end_us)


def breakdown(events, spans, window) -> dict:
    """The device operations that took most time in the window, and the
    idle gaps of the window (no card busy) summed by the innermost span
    open across each gap's middle; at most 10 of each, in seconds."""
    lo, hi = window
    inside = [e for e in events if lo <= e.start_us < hi]
    per_op = collections.Counter()
    for e in inside:
        per_op[e.name[:160]] += (e.end_us - e.start_us) / 1e6
    busy = busy_intervals((e.start_us, min(e.end_us, hi)) for e in inside)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    per_gap = collections.Counter()
    active, si = [], 0
    for a, b in gaps:
        mid = (a + b) / 2
        while si < len(spans) and spans[si].start_us <= mid:
            active.append(spans[si])
            si += 1
        while active and active[-1].end_us < mid:
            active.pop()
        name = active[-1].name if active else "(no span)"
        per_gap[name] += (b - a) / 1e6
    return {"device_ops": [[n, s] for n, s in per_op.most_common(10)],
            "idle_gaps": [[n, s] for n, s in per_gap.most_common(10)]}
