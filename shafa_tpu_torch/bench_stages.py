"""Encode-chain microbenchmark of the port: the time of each stage of the
fused encode, with its inputs resident on the device.

    python -m shafa_tpu_torch.bench_stages [total_bytes] [block_bytes]

Port of bench_stages.py: total_bytes (default 64 MiB) of the seeded
synthetic corpus (profile_main_path.synthetic, seed 0) in blocks of
block_bytes (default 8 MiB), stacked into one (B, P) batch on the device;
SHAFA_BENCH_REPS (default 5) timed calls per stage. The first line is the
card's name and power limit (nvidia-smi). Each stage prints ``name  ms
GB/s  (first call s)`` as bench_decode_stages.timeit gives it: the mean of
the timed calls after a first one, CUDA events on the card, the host clock
on the CPU (SHAFA_TORCH_DEVICE=cpu runs the plain versions). The stages, in
the original's order:

  rle_encode: krle.rle_encode_hist, K8: the RLE rows, their lengths and
      their histograms, which the fused encode takes;
  rle_payloads (old route), emit_bits_rows (old route), beneath it: the
      route that K8 replaced, no longer on any path: the run analysis in
      plain torch (K8's plain version's first part) and K1's bits variant
      on its payloads;
  histogram(raw): the 256-bin histograms of the raw rows (plain torch),
      which the N mode and -c f take;
  codes (host, C++): codes.build_code_tables on the host clock;
  pack_words(production): K1's LUT variant through kpack.pack_batch, every
      row at its 512 B-aligned word offset of one buffer;
  compact_words: the packed rows' exact bytes back to back on the device,
      torch.cat of each row's [4 woff, 4 woff + byte_len) slice of K1's
      buffer (torch slicing: on the TPU this was a K1 call). The
      production route instead downloads K1's buffer once and slices it on
      the host (device.TorchBackend._pack_rows).

Beneath each device stage, ``roofline[name]`` gives the least time the card
could take: the bytes the stage must move (the lanes the data fills read
once, its outputs written once, its tables) over the H100's 3.35 TB/s, and
the share of it attained. Integer work has no peak in the card's data
sheet, so no operations bound is given. The original's v5e roofline (HBM,
VPU, MXU) has no counterpart.

One check the original lacks: the device's RLE rows equal the port's
oracle.rle_encode of each block, and each row's packed bytes equal
oracle.pack of its RLE stream under the same code tables, or main returns
1. Decode stages are bench_decode_stages.py's.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from . import codes as codes_mod
from . import oracle
from .bench_decode_stages import card_line, timeit
from .device import (DeviceUnavailableError, _stack_blocks, default_device,
                     tables_to_device)
from .kernels import emit as kemit
from .kernels import histogram as khist
from .kernels import ops as kops
from .kernels import pack as kpack
from .kernels import rle as krle
from .profile_main_path import synthetic

#: HBM bytes per second of one H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12


def roofline(name: str, dt: float, moved: int, dev) -> None:
    """Print the stage's bytes bound beside its time (the share attained is
    a card's number: not measured on the CPU)."""
    bound = moved / HBM_BYTES_PER_S
    share = (f"{bound / dt * 100:6.2f}%" if dev.type == "cuda" else
             "not measured (not on the card)")
    print(f"  roofline[{name}]: bound {bound * 1e3:9.4f} ms (bytes-bound: "
          f"{moved} B at 3.35 TB/s)  attained {share}", flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    size = int(args[0]) if len(args) > 0 else 64 << 20
    block = int(args[1]) if len(args) > 1 else 8 << 20
    reps = int(os.environ.get("SHAFA_BENCH_REPS", 5))
    print(card_line(), flush=True)
    try:
        dev = default_device()
    except DeviceUnavailableError as e:
        print(f"bench_stages: {e} (SHAFA_TORCH_DEVICE=cpu runs on the CPU)",
              file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})", flush=True)

    raw = np.frombuffer(synthetic(size, 0), np.uint8)
    blocks = [raw[i:i + block] for i in range(0, size, block)]
    stacked, lens = _stack_blocks(blocks)
    b, p = stacked.shape
    print(f"batch: {b} blocks x {p} bytes padded ({size / 1e6:.0f} MB)",
          flush=True)
    x = torch.from_numpy(stacked).to(dev)
    ld = torch.from_numpy(lens).to(dev)

    # --- encode chain ------------------------------------------------------
    enc, enc_len, hist = krle.rle_encode_hist(x, ld)
    enc_sizes = enc_len.cpu().numpy()
    enc_bytes = int(enc_sizes.sum())
    dt = timeit("rle_encode", lambda: krle.rle_encode_hist(x, ld), size,
                reps, dev)
    roofline("rle_encode", dt,
             size + nbytes(ld) + enc_bytes + nbytes(enc_len, hist), dev)
    # the route before K8: the analysis writes each lane's (val, bitlen)
    # pair, which K1 reads
    dt = timeit("  rle_payloads (old route)",
                lambda: krle.rle_payloads(x, ld), size, reps, dev)
    roofline("rle_payloads", dt, size + nbytes(ld) + 8 * size, dev)
    val, bitlen, _ = krle.rle_payloads(x, ld)
    stride = krle.rle_out_bound(p) // 4
    dt = timeit("  emit_bits_rows (old route)",
                lambda: kemit.emit_bits_rows(val, bitlen, ld, stride),
                enc_bytes, reps, dev)
    roofline("emit_bits_rows", dt, 8 * size + nbytes(ld) + enc_bytes, dev)
    del val, bitlen
    print(f"  rle out: {enc_bytes / 1e6:.1f} MB", flush=True)

    dt = timeit("histogram(raw)", lambda: khist.histogram_batch(x, ld),
                size, reps, dev)
    roofline("histogram", dt, size + nbytes(ld) + 8 * 256 * b, dev)
    hist = hist.cpu().numpy()

    t0 = time.perf_counter()
    tables = codes_mod.build_code_tables(hist)
    print(f"{'codes (host, C++)':28s} {(time.perf_counter() - t0) * 1e3:9.3f}"
          " ms", flush=True)
    if int(tables.lens.max()) > 32:
        print("code length > 32 bits: the bench corpus must stay on the "
              "device path", file=sys.stderr)
        return 1

    dtab = tables_to_device(tables, dev)
    byte_lens = kpack.pack_byte_lens(
        hist, np.clip(tables.lens.astype(np.int32), 0, 32))
    woff_np, need = kemit.aligned_offsets(byte_lens)
    woff = torch.from_numpy(woff_np).to(dev)
    pack_args = (enc, enc_len.to(torch.int32), dtab.lut_len, dtab.lut_val,
                 woff, need)
    packed_bytes = int(byte_lens.sum())
    dt = timeit("pack_words(production)",
                lambda: kpack.pack_batch(*pack_args), enc_bytes, reps, dev)
    roofline("pack_words", dt,
             enc_bytes + nbytes(*pack_args[1:5]) + 4 * need, dev)
    words = kpack.pack_batch(*pack_args)
    print(f"  packed: {packed_bytes / 1e6:.1f} MB", flush=True)

    buf = words.view(torch.uint8)

    def compact_words():
        return torch.cat([buf[4 * int(w):4 * int(w) + int(m)]
                          for w, m in zip(woff_np, byte_lens)])

    dt = timeit("compact_words", compact_words, packed_bytes, reps, dev)
    roofline("compact_words", dt, 2 * packed_bytes, dev)
    packed = compact_words().cpu().numpy()

    # --- the check ---------------------------------------------------------
    enc_rows = kops.compact_rows(enc, enc_sizes).cpu().numpy()
    failed = []
    e0 = c0 = 0
    for i, blk in enumerate(blocks):
        rle_row = enc_rows[e0:e0 + int(enc_sizes[i])]
        row = packed[c0:c0 + int(byte_lens[i])]
        e0 += int(enc_sizes[i])
        c0 += int(byte_lens[i])
        if not np.array_equal(rle_row, oracle.rle_encode(blk)):
            failed.append(f"block {i}: RLE row")
        elif row.tobytes() != oracle.pack(rle_row, tables.lens[i],
                                          tables.vals[i]):
            failed.append(f"block {i}: packed bytes")
    print(f"RLE rows and packed bytes equal the oracle's: {not failed}",
          flush=True)
    if failed:
        print(f"bench_stages: FAIL: {failed}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
