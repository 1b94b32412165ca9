"""The load generator: paced round trips through the CLI, file to file.

A round trip is one compress, ``cli.main([path, "-b", B])`` (modules F, T
and C), then the decompress of the archive it wrote, ``cli.main([archive])``
(module D with the RLE expansion). Each runs in a directory of its own,
where the input is a hard link to a file of the pool; the link is removed
before the decompress, so the restored file is one that the decompress
wrote. Each call's wall is a host clock around ``cli.main``, closed after
every visible card is synchronised, with stdout sent to a sink. Between
calls, outside every wall, the harness hashes what the call wrote and
removes it, so that a run keeps at most one round trip's files on disk.

Round trip k starts at the later of the end of round trip k - 1 (with its
hashing) and its slot, and only if that is inside the window and its bytes
fit under the write cap (``RoundTrips.window``).
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import hashlib
import json
import os
import shutil
import sys
import time
import traceback

from .record import Call


class _Sink:
    def write(self, s: str) -> int:
        return len(s)

    def flush(self) -> None:
        pass


def digest(path: str) -> list:
    """[size, blake2b hex] of a file (verify.digest_bytes of its bytes)."""
    with open(path, "rb") as fp:
        h = hashlib.file_digest(fp, lambda: hashlib.blake2b(digest_size=16))
    return [os.path.getsize(path), h.hexdigest()]


class RoundTrips:
    """Runs round trips of one cell. ``sync`` waits for every visible card;
    ``probes`` (traced runs) times the pipeline and the backend and gives
    ``span(name)``, a record_function context."""

    def __init__(self, cli, block_flag: str, work: str, sync, probes=None,
                 span=None):
        self.cli = cli
        self.block_flag = block_flag
        self.work = work
        self.sync = sync
        self.probes = probes
        self.span = span or (lambda name: contextlib.nullcontext())

    def _call(self, argv: list[str], direction: str
              ) -> tuple[float, float, int]:
        if self.probes is not None:
            self.probes.reset()
        self.sync()
        with contextlib.redirect_stdout(_Sink()), \
                self.span(f"bench.call.{direction}"):
            t0 = time.perf_counter()
            try:
                rc = self.cli.main(argv)
            except Exception:  # a crash is a failed call, reported below
                traceback.print_exc(file=sys.stderr)
                rc = -1
            self.sync()
            wall = time.perf_counter() - t0
        return t0, wall, rc

    def _traced(self, call: Call) -> None:
        if self.probes is not None:
            call.pipeline_s = self.probes.pipeline_s
            call.backend_s = self.probes.backend_s

    def round_trip(self, pool_path: str, k: int, pool_index: int,
                   with_json: bool = False) -> tuple[list[Call], int]:
        """One round trip of a pool file; its two calls and the bytes it
        wrote. Its files are hashed and removed before it returns."""
        d = os.path.join(self.work, f"rt{k}")
        os.mkdir(d)
        base = os.path.basename(pool_path)
        inp = os.path.join(d, base)
        try:
            os.link(pool_path, inp)
        except OSError:
            os.symlink(pool_path, inp)
        size = os.path.getsize(pool_path)
        jpath = os.path.join(d, "report.json")
        argv = [inp, "-b", self.block_flag] + (
            ["--json", jpath] if with_json else [])
        t0, wall, rc = self._call(argv, "compress")
        comp = Call("compress", k, pool_index, size, wall, rc, {}, t0)
        self._traced(comp)
        with self.span("bench.between_calls"):
            names = [n for n in sorted(os.listdir(d))
                     if n.startswith(base) and n != base]
            with cf.ThreadPoolExecutor(len(names) or 1) as ex:
                found = ex.map(digest, [os.path.join(d, n) for n in names])
                comp.outputs = {n[len(base):]: h
                                for n, h in zip(names, found)}
            if with_json and os.path.isfile(jpath):
                with open(jpath) as fp:
                    mods = json.load(fp).get("modules", [])
                comp.module_t_ms = sum(m["runtime_ms"] for m in mods
                                       if m["module"] == "t") or None
            archive = inp + (".rle.shaf" if ".rle.shaf" in comp.outputs
                             else ".shaf")
            os.unlink(inp)
        t0, wall, rc = self._call([archive], "decompress")
        dec = Call("decompress", k, pool_index, size, wall, rc, {}, t0)
        self._traced(dec)
        with self.span("bench.between_calls"):
            if os.path.isfile(inp):
                dec.outputs["restored"] = digest(inp)
            written = sum(os.path.getsize(os.path.join(d, n))
                          for n in os.listdir(d))
            shutil.rmtree(d)
        return [comp, dec], written

    def window(self, pool_paths: list[str], n: int, seconds: float,
               cap: int, first: int = 0, with_json: bool = False
               ) -> tuple[list[Call], int, float, float]:
        """Round trips first .. first + n - 1 (pool file k % len(pool)),
        round trip k at slot ``t0 + (k - first) * seconds / n`` or at the
        end of the one before, whichever is later; none starts after
        ``seconds`` or once its pool file's bytes would pass ``cap``. The
        calls, the bytes written, the window's start (perf_counter) and
        its length to the end of the last call."""
        interval = seconds / max(n, 1)
        seen: dict[int, int] = {}
        calls: list[Call] = []
        written = 0
        t0 = time.perf_counter()
        end = t0
        for k in range(first, first + n):
            i = k % len(pool_paths)
            est = seen.get(i, max(seen.values(), default=0) * 1.02)
            if written + est > cap:
                break
            slot = t0 + (k - first) * interval
            with self.span("bench.between_calls"):
                wait = slot - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
            if time.perf_counter() >= t0 + seconds:
                break
            rt, nb = self.round_trip(pool_paths[i], k, i, with_json)
            seen[i] = nb
            written += nb
            calls.extend(rt)
            end = rt[-1].start_s + rt[-1].wall_s
        return calls, written, t0, end - t0
