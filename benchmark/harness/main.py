"""One run of one cell: set-up, the measured window, the check against the
plain reference, the metrics, and the result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

The run's window is cut into ``PROCESSES`` segments of ``seconds /
PROCESSES`` each, run one after the other by fresh processes (``child.py``;
the first also draws the pool on the card and plans the run's round trips
from the write cap). This process touches no card until they have all
ended: then it reads their records, computes the plain reference on the
card (``verify``), and judges every call.

``setup_s`` is the set-up of the run's first process, from this process's
start to the first timed call: this process's start-up, then the child's
imports, the CUDA context, the pool drawn and written, the kernels built
or loaded, one warm-up round trip, and, traced, one under the profiler, so
that its start-up stays out of the window. The later processes' set-ups,
the same work less the pool, are printed on an earlier line.
``--trace 1`` runs the segments under torch.profiler with the
spans of ``probes`` and reports the cell's per-layer metrics instead of
its end-to-end ones.

Earlier lines of standard output give the cards, the calls and walls,
the bytes written, the pool's decode routes and each card's peak memory;
the last is the result, one JSON object. The numbers compared, each
beside its limit, are the last lines of standard error and the result's
last key, "checks".
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from . import env, reduce, spec, verify
from .record import Call, DeviceEvent, Run, Span

#: Fresh processes a run: a process's host speed, steady over its life,
#: differs from the next one's by up to 40% on the H100 hosts measured.
PROCESSES = 4
RUN_PY = Path(__file__).resolve().parents[1] / "run.py"
#: trace-clock offset between processes' segments (their clocks differ)
SEGMENT_US = 1e13


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def spawn(task: dict) -> dict | None:
    """Run a child process on the task; its record, or None if it failed."""
    r = subprocess.run([sys.executable, str(RUN_PY), "--child",
                        task["in"]], stdout=subprocess.DEVNULL)
    if r.returncode != 0 or not os.path.isfile(task["out"]):
        print(f"process {task['index']} of the run exited {r.returncode}",
              file=sys.stderr)
        return None
    with open(task["out"]) as fp:
        return json.load(fp)


def _calls(records: list[dict], offset: float) -> list[Call]:
    out = []
    for r in records:
        c = Call(**r)
        if c.span_us:
            c.span_us = (c.span_us[0] + offset, c.span_us[1] + offset)
        out.append(c)
    return out


def main(argv=None, start: float | None = None, require_chip: bool = True,
         checkout: Path = spec.CHECKOUT) -> int:
    start = time.perf_counter() if start is None else start
    args = parse(argv)
    cell = spec.load(args.workload, checkout)
    env.prepare(checkout, cell.chips)
    import torch
    cuda = torch.cuda.is_available()
    if require_chip and (not cuda or torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if cuda else 0}", file=sys.stderr)
        return 2
    if importlib.util.find_spec("shafa_tpu_torch") is None:
        print("the program (shafa_tpu_torch) is not importable",
              file=sys.stderr)
        return 3
    traffic, config = cell.traffic, cell.config
    k = PROCESSES
    work = tempfile.mkdtemp(prefix="shafa_bench_")
    try:
        setup_s = None
        recs, failed_rts, total, pool = [], 0, None, None
        written = 0
        for j in range(k):
            task = {"checkout": str(checkout), "workload": args.workload,
                    "seed": args.seed, "seconds": args.seconds / k,
                    "trace": args.trace, "work": work, "index": j,
                    "processes": k, "pool": pool,
                    "cap": int(traffic["write_cap_bytes"]) - written,
                    "in": os.path.join(work, f"task{j}.json"),
                    "out": os.path.join(work, f"out{j}.json")}
            if total is None:
                task.update(n=None, first=0)
            else:
                task.update(n=total // k + (1 if j < total % k else 0),
                            first=j * (total // k) + min(j, total % k))
            with open(task["in"], "w") as fp:
                json.dump(task, fp)
            t_spawn = time.perf_counter()
            rec = spawn(task)
            if rec is None:
                if pool is None:
                    return 5
                failed_rts += task["n"]
                continue
            if pool is None:
                pool, total = rec["pool"], rec["total"]
                pool_digests = rec["pool_digests"]
            if setup_s is None:  # (the child's clock, if not this one's)
                setup_s = (rec["t_window"] - start
                           if rec["t_window"] >= t_spawn else
                           t_spawn - start + rec["t_window"] - rec["t_start"])
            written += rec["written"]
            recs.append(rec)
        banned = sorted(set(env.banned_modules()).union(
            *[r["banned"] for r in recs]))
        if banned:
            print(f"loaded in a process of the run: {', '.join(banned)}",
                  file=sys.stderr)
            return 4

        calls, warm, events, spans, segments = [], [], [], [], []
        for j, rec in enumerate(recs):
            off = j * SEGMENT_US
            calls += _calls(rec["calls"], off)
            warm += _calls(rec["warm"], off)
            events += [DeviceEvent(d, c, n, a + off, b + off)
                       for d, c, n, a, b in rec.get("events", [])]
            spans += [Span(n, a + off, b + off)
                      for n, a, b in rec.get("spans", [])]
            marked = [c.span_us for c in calls if c.span_us
                      and c.span_us[0] >= off]
            if marked:
                segments.append((min(a for a, _ in marked),
                                 max(b for _, b in marked)))

        t_ref = time.perf_counter()
        dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
        data = []
        for path in pool:
            with open(path, "rb") as fp:
                data.append(fp.read())
        want, side = verify.expected(data, config["block_bytes"],
                                     dev)
        numbers = verify.judge(calls + warm, want)
        numbers["failed_calls"] += 2 * failed_rts
        numbers["pool_modified"] = sum(
            verify.digest_bytes(raw) != list(d)
            for raw, d in zip(data, pool_digests))
        del data
        ref_s = time.perf_counter() - t_ref

        window_s = sum(r["window_s"] for r in recs)
        run = Run(args.workload, config, traffic, args.seconds, cell.chips,
                  torch.cuda.get_device_name(0) if cuda else "cpu", calls,
                  setup_s, window_s, traced=bool(args.trace),
                  device_events=events, spans=spans)
        metrics = {}
        for m in (cell.per_layer if args.trace else cell.end_to_end):
            value = spec.reader(m["name"], checkout)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

        peaks = [max(p) for p in zip(*[r["peaks"] for r in recs])] \
            if recs and recs[0]["peaks"] else []
        device = {"platform": "gpu" if cuda else "cpu",
                  "kind": run.device_kind, "count": cell.chips,
                  "memory_peak_bytes": max(peaks, default=0)}
        result = {"correct": verify.passed(numbers),
                  "attempted": len(calls) + 2 * failed_rts,
                  "failed": numbers["failed_calls"], "metrics": metrics,
                  "device": device}
        if args.trace and segments:
            from . import trace as trace_mod
            busy = [0.0] * cell.chips
            ops, gaps = collections.Counter(), collections.Counter()
            for lo, hi in segments:
                for d in range(cell.chips):
                    busy[d] += trace_mod.union_us(
                        (e.start_us, min(e.end_us, hi)) for e in events
                        if e.device == d and lo <= e.start_us < hi)
                b = trace_mod.breakdown(events, spans, (lo, hi))
                ops.update(dict(b["device_ops"]))
                gaps.update(dict(b["idle_gaps"]))
            device["busy_s"] = sum(busy) / len(busy) / 1e6
            device["window_s"] = sum(hi - lo for lo, hi in segments) / 1e6
            result["breakdown"] = {
                "device_ops": [[n, s] for n, s in ops.most_common(10)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(10)]}

        for line in env.cards():
            print(f"card: {line}")
        print(f"processes: {len(recs)} of {k}; round trips planned "
              f"{total}; work directory on {env.filesystem(work)}")
        for j, rec in enumerate(recs):
            print(f"process {j}: set-up {rec['t_window'] - rec['t_start']:.3f}"
                  f" s after its start, window {rec['window_s']:.3f} s, "
                  f"{len(rec['calls']) // 2} round trips, user "
                  f"{rec['rusage'][0]:.3f} s, sys {rec['rusage'][1]:.3f} s, "
                  f"kernel build {rec['build_s']:.3f} s; {rec['probe']}")
        for direction in ("compress", "decompress"):
            w = sorted(c.wall_s * 1e3 for c in run.of(direction))
            if w:
                print(f"{direction} walls ms: min {w[0]:.3f}, median "
                      f"{w[len(w) // 2]:.3f}, p95 "
                      f"{reduce.p95_ms(run, direction):.3f}, max "
                      f"{w[-1]:.3f}; first: "
                      + " ".join(f"{c.wall_s * 1e3:.1f}"
                                 for c in run.of(direction)[:16]))
        print(f"bytes written: {written} (cap {traffic['write_cap_bytes']})")
        routes = collections.Counter()
        for sc in side:
            routes.update(sc.route_counts())
        longest = [max(sc.max_code_len) for sc in side]
        print(f"pool: {len(side)} files, modes "
              f"{''.join(sorted({sc.mode for sc in side}))}; blocks by code "
              f"length {dict(routes)}; longest code {min(longest)}-"
              f"{max(longest)} bits")
        for d, p in enumerate(peaks):
            print(f"card {d} peak memory (max_memory_allocated): {p} B")
        print(f"set-up s: {setup_s}; window s: {window_s}; reference check "
              f"s: {ref_s}")
        result["checks"] = {n: {"value": v, "limit": verify.LIMITS[n]}
                            for n, v in numbers.items()}
        for n, v in numbers.items():
            print(f"check {n}: {v} (limit {verify.LIMITS[n]})",
                  file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)
