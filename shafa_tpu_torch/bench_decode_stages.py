"""Decode-chain microbenchmark of the port: the time of each stage of the
decode path, with its inputs resident on the device.

    python -m shafa_tpu_torch.bench_decode_stages [total_bytes] [block_bytes]

Port of bench_decode_stages.py: total_bytes (default 64 MiB) of the
seeded synthetic corpus (profile_main_path.synthetic, seed 0) in blocks of
block_bytes (default 8 MiB), SHAFA_BENCH_REPS (default 3) timed calls per
stage. The decode inputs are built on the host, as the original builds
them: RLE, histograms and packed payloads from the port's oracle, code
tables from codes.build_code_tables. The payloads stack into one
(B, P) batch as the port's decode batches stack (P a multiple of 1024).

The first line is the card's name and power limit (nvidia-smi). Each stage
prints ``name  ms  GB/s  (first call s)``: the mean of the timed calls
after a first one, timed with CUDA events on the card (the host clock
where SHAFA_TORCH_DEVICE=cpu runs the plain versions), and the rate over
the bytes the original counts for that stage (packed payload, RLE stream
or expanded bytes). The stages carry their counterparts' names:

  rank_planes (K2, which reads the payload bytes: the original's
      windows32 stage has no counterpart), fsm_v4 (K7), emit_packs (K1 on
      K7's packs) when the longest code has at most 16 bits;
  fused v5 chain: K2, K3, the route of _decode_fused_tpu;
  expand_sizes: the token scan of rle_expand_prep;
  expand (K4), which writes the compacted output: the counterpart of both
      expand_pages and expand_compact.

SHAFA_BENCH_V3 (default off) times K6 at 32 states on K2's planes, the
second half of the original's legacy branch, whose XLA stage 1 has no
counterpart. SHAFA_BENCH_XLA_EXPAND has no counterpart. Checks, each
making main() return 1: K7 -> emit_packs gives K3's rows and underrun
flags (and, with SHAFA_BENCH_V3, K6 gives K7's packs as interleave_packs
lays them out); K4 gives its plain version's bytes; the expanded bytes
equal the corpus.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import codes as codes_mod
from . import oracle
from .device import _bucket, _stack_blocks, default_device, tables_to_device
from .kernels import decode as kdecode
from .kernels import expand as kexpand
from .profile_main_path import synthetic


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip()
    except FileNotFoundError:
        return "nvidia-smi: not available"
    return out.splitlines()[0] if out else "nvidia-smi gave no answer"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timeit(name: str, fn, nbytes: int, reps: int, dev: torch.device) -> float:
    """Seconds per call of fn after a first call; prints the stage line."""
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    first = time.perf_counter() - t0
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        dt = start.elapsed_time(end) / 1e3 / reps
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = (time.perf_counter() - t0) / reps
    print(f"{name:28s} {dt * 1e3:9.3f} ms   {nbytes / dt / 1e9:8.2f} GB/s"
          f"   (first call {first:.1f}s)", flush=True)
    return dt


def _check(what: str, ok: bool, failed: list[str]) -> None:
    print(f"{what}: {ok}", flush=True)
    if not ok:
        failed.append(what)


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    size = int(args[0]) if len(args) > 0 else 64 << 20
    block = int(args[1]) if len(args) > 1 else 8 << 20
    reps = int(os.environ.get("SHAFA_BENCH_REPS", 3))
    print(card_line(), flush=True)
    dev = default_device()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})", flush=True)

    raw = np.frombuffer(synthetic(size, 0), np.uint8)
    blocks = [raw[i:i + block] for i in range(0, size, block)]
    print(f"batch: {len(blocks)} blocks x {_bucket(block)} bytes padded "
          f"({size / 1e6:.0f} MB)", flush=True)
    enc_blocks = [oracle.rle_encode(blk) for blk in blocks]
    hist = np.stack([oracle.histogram(e) for e in enc_blocks])
    tables = codes_mod.build_code_tables(hist.astype(np.int64))
    max_len = int(tables.lens.max())
    print(f"max code len: {max_len}", flush=True)
    if max_len > 32:
        print("codes over 32 bits decode on the host: no device stage",
              file=sys.stderr, flush=True)
        return 1
    payloads = [np.frombuffer(oracle.pack(e, tables.lens[i], tables.vals[i]),
                              np.uint8) for i, e in enumerate(enc_blocks)]
    counts = np.array([e.size for e in enc_blocks], np.int32)
    packed_bytes = sum(p.size for p in payloads)
    enc_bytes = int(counts.sum())
    print(f"rle {enc_bytes / 1e6:.1f} MB -> packed {packed_bytes / 1e6:.1f} "
          "MB", flush=True)
    pst, plens = _stack_blocks(payloads, minimum=1024)
    py = torch.from_numpy(pst).to(dev)
    pl = torch.from_numpy(plens).to(dev)
    cts = torch.from_numpy(counts).to(dev)
    out_p = _bucket(int(counts.max()))
    stride_words = max(out_p, 512) // 4
    failed: list[str] = []

    # the production decode (the port's route for this code width) gives
    # the rows that the checks and the expand stages take
    if max_len <= 16:
        dt = tables_to_device(tables, dev, decode=True)
        s_states = 8 if max_len <= 8 else 16

        def decode():
            return kdecode.decode_batch(py, pl, dt.pc16, dt.ls, dt.lut12,
                                        cts, out_p, s_states)
    else:
        pc32, ls32, ncodes = (torch.from_numpy(a).to(dev) for a in
                              kdecode.rank_tables32(kdecode.decode_tables_batch(
                                  tables.lens, tables.vals)))

        def decode():
            return kdecode.decode_batch32(py, pl, pc32, ls32, ncodes, cts,
                                          out_p)
    dec, under = decode()
    _check("no underrun", not bool(under.any()), failed)

    if max_len <= 16:
        k2_args = (py, dt.pc16, dt.ls, dt.lut12)
        timeit("rank_planes (K2)", lambda: kdecode.rank_planes(*k2_args),
               packed_bytes, reps, dev)
        ls8 = kdecode.rank_planes(*k2_args)
        timeit(f"fsm_v4 S={s_states} (K7)",
               lambda: kdecode.fsm_packs(ls8, pl, cts, s_states),
               packed_bytes, reps, dev)
        packs = kdecode.fsm_packs(ls8, pl, cts, s_states)
        if os.environ.get("SHAFA_BENCH_V3", "0") != "0":
            print("decode_stage1 (xla): no counterpart in the port; K6 runs "
                  "on K2's planes", flush=True)
            timeit("fsm32 S=32 (K6)",
                   lambda: kdecode.fsm32_packs(ls8, pl, cts), enc_bytes, reps,
                   dev)
            _check("K6 gives K7's packs", all(
                torch.equal(a, b) for a, b in
                zip(kdecode.fsm32_packs(ls8, pl, cts),
                    (*kdecode.interleave_packs(*packs[:4]), packs[4]))),
                failed)
        del ls8
        timeit("emit_packs (K1)",
               lambda: kdecode.emit_packs(*packs[:4], pl, stride_words),
               enc_bytes, reps, dev)
        rows = kdecode.emit_packs(*packs[:4], pl, stride_words)
        _check("K7 -> emit_packs gives K3's rows",
               torch.equal(rows[:, :out_p], dec)
               and torch.equal(packs[4], under), failed)
        del packs, rows
        # bench_decode_stages.py:179 labels this stage "fused v4 chain",
        # though _decode_fused_tpu runs the v5 kernel (K3)
        timeit("fused v5 chain (K2, K3)", decode, packed_bytes, reps, dev)
    else:
        print(f"v4 chain stages skipped: longest code {max_len} bits > 16",
              flush=True)

    timeit("expand_sizes", lambda: kexpand.rle_expand_prep(dec, cts),
           enc_bytes, reps, dev)
    prep = kexpand.rle_expand_prep(dec, cts)
    total = int(prep["out_len"].sum())
    print(f"expanded: {total / 1e6:.1f} MB", flush=True)
    timeit("expand (K4)", lambda: kexpand.rle_expand_compact(prep, total),
           total, reps, dev)
    out = kexpand.rle_expand_compact(prep, total)
    _check("K4 gives its plain version's bytes", torch.equal(
        out, kexpand.expand_tokens_plain(prep["cum"], prep["sym"],
                                         prep["out_base"], total)), failed)
    _check("the expanded bytes equal the corpus",
           out.cpu().numpy().tobytes() == raw.tobytes(), failed)
    if os.environ.get("SHAFA_BENCH_XLA_EXPAND", "0") != "0":
        print("rle_expand_compact (xla): no counterpart in the port",
              flush=True)
    if failed:
        print(f"bench_decode_stages: FAIL: {failed}", file=sys.stderr,
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
