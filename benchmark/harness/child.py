"""One process's share of a run (``run.py --child <task.json>``).

A run's window is cut into segments, one for each of the run's
processes (``main.PROCESSES``), run one after the other: a
process's host speed, steady over its life, differs from the next one's
on the H100 hosts measured, and a run's numbers then average several.
Each process imports the program, does one warm-up round trip, resets the
cards' peak memory, runs its round trips (``calls.RoundTrips.window``), and
writes what it saw to ``task["out"]``. The first process also draws the
pool on the card from the seed, writes it, and sets the number of round
trips of the run from the write cap (``plan``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import resource
import sys
from pathlib import Path

from . import calls as calls_mod
from . import env, spec


def _program():
    """The program's modules the harness drives and wraps."""
    from shafa_tpu_torch import (cli, codes, device, dist, formats,
                                 pipeline)
    from shafa_tpu_torch.kernels import _build
    return dict(cli=cli, codes=codes, device=device, dist=dist,
                formats=formats, pipeline=pipeline, _build=_build)


def plan(cap: int, pool_bytes: int, rt_bytes: int, processes: int) -> int:
    """Round trips of the window: what the write cap leaves after the
    pool and every process's warm-up round trip, 2% of room a trip."""
    per = rt_bytes * 1.02
    return max(processes, int((cap - pool_bytes - processes * per) // per))


def _write_pool(pool, work: str) -> tuple[list[str], list]:
    from .verify import digest_bytes
    pool_dir = os.path.join(work, "pool")
    os.makedirs(pool_dir, exist_ok=True)
    paths, digests = [], []
    for i, data in enumerate(pool):
        paths.append(os.path.join(pool_dir, f"f{i:03d}.bin"))
        with open(paths[-1], "wb") as fp:
            fp.write(data.tobytes())
        digests.append(digest_bytes(data.tobytes()))
    return paths, digests


def run(task: dict, start: float) -> dict:
    """Do the task; returns what the parent reads."""
    checkout = Path(task["checkout"])
    cell = spec.load(task["workload"], checkout)
    env.prepare(checkout, cell.chips)
    import torch
    prog = _program()
    cuda = torch.cuda.is_available()
    n_cards = torch.cuda.device_count() if cuda else 0

    def sync():
        for d in range(n_cards):
            torch.cuda.synchronize(d)

    out = {"t_start": start}
    traffic = cell.traffic
    written = 0
    if task["pool"] is None:
        import gen
        dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
        pool = gen.make_pool(cell.config, traffic["file_bytes"],
                             traffic["pool"], task["seed"], dev)
        paths, out["pool_digests"] = _write_pool(pool, task["work"])
        written += sum(d.size for d in pool)
        del pool
        if cuda:
            torch.cuda.empty_cache()
    else:
        paths = task["pool"]
    out["pool"] = paths

    from . import trace as trace_mod
    probes = span = None
    if task["trace"]:
        from torch.profiler import record_function

        from .probes import Probes
        probes, span = Probes(prog), record_function
    work = os.path.join(task["work"], f"p{task['index']}")
    os.mkdir(work)
    rts = calls_mod.RoundTrips(prog["cli"], cell.config["block_flag"], work,
                              sync, probes, span)
    first_pool = task["first"] % len(paths)
    if task["trace"]:
        with trace_mod.profiler(cuda):
            warm, rt_bytes = rts.round_trip(paths[first_pool], -1 -
                                               task["index"], first_pool,
                                               True)
    else:
        warm, rt_bytes = rts.round_trip(paths[first_pool],
                                           -1 - task["index"], first_pool)
    written += rt_bytes
    out["rt_bytes"] = rt_bytes
    out["build_s"] = prog["_build"].build_seconds
    n, first = task["n"], task["first"]
    if n is None:  # the first process plans the run
        k = task["processes"]
        out["total"] = total = plan(int(traffic["write_cap_bytes"]),
                                    written - rt_bytes, rt_bytes, k)
        n = total // k + (1 if total % k else 0)
    for d in range(n_cards):
        torch.cuda.reset_peak_memory_stats(d)

    prof = None
    if task["trace"]:
        probes.install()
        prof = trace_mod.profiler(cuda)
        prof.__enter__()
    use0 = resource.getrusage(resource.RUSAGE_SELF)
    try:
        calls, w, t0, window_s = rts.window(
            paths, n, task["seconds"], task["cap"] - written, first,
            with_json=bool(task["trace"]))
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            probes.remove()
    use1 = resource.getrusage(resource.RUSAGE_SELF)
    written += w
    if prof is not None:
        events, spans, trace_bytes = trace_mod.read(
            prof, os.path.join(work, "trace.json"))
        trace_mod.attach_spans(calls, spans)
        written += trace_bytes
        out["events"] = [dataclasses.astuple(e) for e in events]
        out["spans"] = [dataclasses.astuple(s) for s in spans]
    out.update(t_window=t0, window_s=window_s, written=written,
               calls=[dataclasses.asdict(c) for c in calls],
               warm=[dataclasses.asdict(c) for c in warm],
               peaks=[torch.cuda.max_memory_allocated(d)
                      for d in range(n_cards)],
               banned=env.banned_modules(),
               rusage=[use1.ru_utime - use0.ru_utime,
                       use1.ru_stime - use0.ru_stime],
               probe=env.host_probe())
    return out


def main(path: str, start: float) -> int:
    with open(path) as fp:
        task = json.load(fp)
    out = run(task, start)
    tmp = task["out"] + ".tmp"
    with open(tmp, "w") as fp:
        json.dump(out, fp)
    os.replace(tmp, task["out"])
    sys.stdout.flush()
    return 0
