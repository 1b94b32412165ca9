"""Where the time of the port's main path goes.

    python -m shafa_tpu_torch.profile_main_path [--bytes N] [--runs R]
                                                [--corpus mixed|text]
                                                [--block m|M]
                                                [--trace-dir DIR]

Writes a seeded corpus of N bytes (default 200,000,000; one of the two that
chip_smoke.py uses: the synthetic mix, whose codes have at most 16 bits, or
the text with rare bytes, whose blocks have codes of 17-32 bits) and drives
the CLI round trip at -b m (or --block M: 64 MiB blocks),
``cli.main([path, "-b", "m"])`` then ``cli.main([path + ".rle.shaf"])``.
Above pipeline.STREAM_THRESHOLD (256 MiB) both directions take the
streaming pipelines, whose stages and IO waits are timed too:

  1. one warm-up round trip, then R untraced ones: wall seconds of each
     compress and decompress;
  2. one round trip with a timer around each stage function listed in
     STAGES, the device synchronized before and after each call: inclusive
     seconds and calls (nested stages count in their callers too);
  3. one round trip under torch.profiler: the device is busy for the union
     of the kernel, memcpy and memset intervals of the trace; the busy
     share is that union over the traced wall. The device operations with
     the largest summed durations follow.

Every round trip must be bit-exact. The device is the backend's (CUDA, or
SHAFA_TORCH_DEVICE); on the CPU the trace has no device intervals and the
busy share reads "not measured".
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import cli, device, formats, pipeline
from . import codes as codes_mod
from .kernels import decode as kdecode
from .kernels import expand as kexpand
from .kernels import histogram as khist
from .kernels import ops as kops
from .kernels import pack as kpack
from .kernels import rle as krle

#: (owner, attribute) of every function the stage-timed run times.
STAGES = [
    (pipeline, "_open_read"), (pipeline, "_read_blocks"),
    (formats, "write_freq_arrays"), (formats, "write_cod_tables"),
    (formats, "write_shaf_header"), (formats, "write_shaf_block"),
    (formats, "parse_cod_tables"), (formats, "parse_shaf_frames"),
    (codes_mod, "build_code_tables"), (device, "tables_to_device"),
    (device.TorchBackend, "_upload"), (device.TorchBackend, "fused_encode"),
    (device.TorchBackend, "fused_rle_sizes"),
    (device.TorchBackend, "fused_rle_hists"),
    (device.TorchBackend, "fused_rle_bytes"),
    (device.TorchBackend, "fused_pack"), (device.TorchBackend, "_pack_rows"),
    (device.TorchBackend, "fused_decode"),
    (device.TorchBackend, "_expand_rows"),
    (krle, "rle_encode_hist"), (krle, "rle_payloads"),
    (khist, "histogram_batch"), (kpack, "pack_batch"),
    (kops, "compact_rows"), (kdecode, "decode_batch"),
    (kdecode, "rank_planes"),
    (kdecode, "decode_rows"), (kdecode, "decode_batch32"),
    (kdecode, "rank_planes32"), (kdecode, "fsm32_packs"),
    (kdecode, "emit_packs"), (kdecode, "emit_bits_rows"),
    (kexpand, "rle_expand_sizes"), (kexpand, "rle_expand"),
    (pipeline, "compress_pipeline_streaming"),
    (pipeline, "_module_d_shafa_streaming"), (device.TorchBackend, "pack"),
    (device, "_stack_blocks"), (pipeline._Progress, "save"),
    (pipeline._Overlap, "take"), (pipeline._Overlap, "write"),
    (pipeline._Overlap, "drain"),
]

#: Chrome-trace categories of work on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def synthetic(n: int, seed: int) -> bytes:
    """Mixed-entropy corpus: runs, printable text, random bytes in spans of
    2-60 KB (a copy of bench.py::synthetic, which imports jax)."""
    rng = np.random.default_rng(seed)
    parts = []
    total = 0
    while total < n:
        kind = rng.integers(0, 3)
        ln = int(rng.integers(2000, 60000))
        if kind == 0:
            parts.append(np.full(ln, rng.integers(0, 256), np.uint8))
        elif kind == 1:
            parts.append(rng.integers(32, 127, ln).astype(np.uint8))
        else:
            parts.append(rng.integers(0, 256, ln).astype(np.uint8))
        total += ln
    return np.concatenate(parts)[:n].tobytes()


def text_with_rare_bytes(n: int) -> bytes:
    """Text or logs that hold occasional control or UTF-8 bytes.

    The 95 printable ASCII bytes follow a Zipf law with exponent 1.1 (ranks
    in a seeded order); each of the 161 other byte values has a probability
    of 10^U(-8, -4); runs of 4-15 spaces cover about 15% of the file. At
    8 MiB blocks the rare bytes get Shannon-Fano codes of 17-24 bits, and
    RLE saves enough for R mode. The seed is fixed (11)."""
    rng = np.random.default_rng(11)
    printable = np.arange(32, 127)
    other = np.setdiff1d(np.arange(256), printable)
    prob = np.zeros(256)
    prob[other] = 10.0 ** rng.uniform(-8, -4, other.size)
    zipf = 1.0 / np.arange(1, printable.size + 1) ** 1.1
    prob[rng.permutation(printable)] = zipf / zipf.sum() * (1 - prob.sum())
    out = np.searchsorted(np.cumsum(prob), rng.random(n) * prob.sum())
    out = np.minimum(out, 255).astype(np.uint8)
    n_runs = int(0.15 * n / 9.5)
    starts = rng.integers(0, max(n - 16, 1), n_runs)
    ends = starts + rng.integers(4, 16, n_runs)
    cover = np.bincount(starts, minlength=n + 1) \
        - np.bincount(ends, minlength=n + 1)
    out[np.cumsum(cover[:n]) > 0] = ord(" ")
    return out.tobytes()


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def round_trip(path: str, data: bytes,
               block: str = "m") -> tuple[float, float]:
    """Compress and decompress path through the CLI at -b block; wall
    seconds of each. Leaves path holding data again, and no sidecars."""
    with contextlib.redirect_stdout(io.StringIO()):
        _sync()
        t0 = time.perf_counter()
        rc_c = cli.main([path, "-b", block])
        _sync()
        t1 = time.perf_counter()
        os.rename(path, path + ".orig")
        t2 = time.perf_counter()
        rc_d = cli.main([path + ".rle.shaf"])
        _sync()
        t3 = time.perf_counter()
    if rc_c or rc_d:
        raise RuntimeError(f"CLI exited {rc_c} / {rc_d}")
    with open(path, "rb") as fp:
        if fp.read() != data:
            raise RuntimeError("round trip is not bit-exact")
    os.replace(path + ".orig", path)
    for ext in (".rle", ".rle.freq", ".rle.cod", ".rle.shaf"):
        os.remove(path + ext)
    return t1 - t0, t3 - t2


@contextlib.contextmanager
def stage_timers():
    """Time every function of STAGES; yields {name: [seconds, calls]}."""
    acc = collections.defaultdict(lambda: [0.0, 0])
    saved = []
    for owner, attr in STAGES:
        fn = owner.__dict__[attr]
        name = f"{owner.__name__.rsplit('.', 1)[-1]}.{attr}"

        def timed(*args, _fn=fn, _name=name, **kwargs):
            _sync()
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                _sync()
                acc[_name][0] += time.perf_counter() - t0
                acc[_name][1] += 1
        saved.append((owner, attr, fn))
        setattr(owner, attr, timed)
    try:
        yield acc
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def device_busy(trace: dict) -> tuple[float, list]:
    """Union seconds of the trace's device intervals, and (summed ms, count,
    name) per device operation, largest first."""
    spans = []
    per_op = collections.defaultdict(lambda: [0.0, 0])
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS:
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
            spans.append((ts, ts + dur))
            per_op[ev.get("name", "?")][0] += dur / 1e3
            per_op[ev.get("name", "?")][1] += 1
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    ops = sorted(((ms, n, name) for name, (ms, n) in per_op.items()),
                 reverse=True)
    return busy_us / 1e6, ops


def profiled_round_trip(path: str, data: bytes, trace_dir: str | None,
                        block: str = "m"):
    """One round trip per direction under torch.profiler; prints the busy
    share and the longest device operations of each."""
    kind = device.default_device().type
    for direction in ("compress", "decompress"):
        with contextlib.redirect_stdout(io.StringIO()):
            argv = [path, "-b", block] if direction == "compress" \
                else [path + ".rle.shaf"]
            if direction == "decompress":
                os.rename(path, path + ".orig")
            with cli.profiler(kind) as prof:
                t0 = time.perf_counter()
                rc = cli.main(argv)
                _sync()
                wall = time.perf_counter() - t0
        if rc:
            raise RuntimeError(f"CLI exited {rc} under the profiler")
        tmp = os.path.join(os.path.dirname(path), f"trace_{direction}.json")
        prof.export_chrome_trace(tmp)
        with open(tmp) as fp:
            busy, ops = device_busy(json.load(fp))
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            shutil.move(tmp, os.path.join(trace_dir, os.path.basename(tmp)))
        else:
            os.remove(tmp)
        share = f"{busy / wall:.3f}" if ops else "not measured"
        print(f"traced {direction}: wall {wall:.4f} s, device busy "
              f"{busy:.4f} s (union of {', '.join(DEVICE_CATS)} intervals),"
              f" busy share {share}")
        for ms, n, name in ops[:25]:
            print(f"  {ms:10.3f} ms x {n:5d}  {name[:100]}")
    with open(path, "rb") as fp:
        if fp.read() != data:
            raise RuntimeError("traced round trip is not bit-exact")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m shafa_tpu_torch."
                                 "profile_main_path", description=__doc__
                                 .split("\n\n")[0])
    ap.add_argument("--bytes", type=int, default=200_000_000)
    ap.add_argument("--corpus", choices=("mixed", "text"), default="mixed")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--block", choices=("m", "M"), default="m",
                    help="-b of the compress: 8 MiB or 64 MiB blocks")
    ap.add_argument("--trace-dir", default=None,
                    help="keep the Chrome traces here")
    args = ap.parse_args(argv)

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv"], capture_output=True,
            text=True, check=False).stdout.strip()
    except FileNotFoundError:
        smi = "nvidia-smi: not available"
    print(smi)
    print(f"device {device.default_device()}, torch {torch.__version__}, "
          f"{args.bytes} bytes of the {args.corpus} corpus at -b "
          f"{args.block}", flush=True)
    work = tempfile.mkdtemp(prefix="shafa_profile_")
    try:
        data = (synthetic(args.bytes, 0) if args.corpus == "mixed"
                else text_with_rare_bytes(args.bytes))
        path = os.path.join(work, "corpus.bin")
        with open(path, "wb") as fp:
            fp.write(data)
        mb = args.bytes / 1e6
        # warm-up: kernel build, allocator, caches
        round_trip(path, data, args.block)
        for i in range(args.runs):
            c, d = round_trip(path, data, args.block)
            print(f"untraced run {i}: compress {c:.4f} s ({mb / c:.1f} MB/s)"
                  f", decompress {d:.4f} s ({mb / d:.1f} MB/s)")
        with stage_timers() as acc:
            c, d = round_trip(path, data, args.block)
        print(f"stage-timed run: compress {c:.4f} s, decompress {d:.4f} s;"
              " inclusive seconds per stage (calls):")
        for name, (sec, n) in sorted(acc.items(), key=lambda kv: -kv[1][0]):
            print(f"  {name:40s} {sec:9.4f} s {n:5d}")
        profiled_round_trip(path, data, args.trace_dir, args.block)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")
    return 0


if __name__ == "__main__":
    sys.exit(main())
