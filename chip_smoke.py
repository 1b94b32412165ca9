"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA card.

    python3 chip_smoke.py        (from the repository root, one CUDA card)
    python3 chip_smoke.py --scale-out    (several cards: build, the 200 MB
                                          mixed round trip, phase 6's
                                          multi-host and multi-device parts
                                          and phase 12 at D = 1, 2, 4)

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. the build of the CUDA kernels from shafa_tpu_torch/kernels/csrc/, and
     every kernel's registers and spills as ``nvcc -Xptxas -v`` gave them;
  3. every kernel of the paths against its plain PyTorch version on the
     card, on the paths' shapes, exact equality, both timed with CUDA
     events: K8 (the RLE encode with its histogram; out_len, the bytes
     below it and the histogram) on the (8, 8 MiB) first batches of the
     mixed and of the text corpus, K1's bits variant on K8's plain
     version's payloads of the mixed batch, K1-K4 and K7 on the 200 MB
     mixed corpus's batches (K4 from the decode batch's RLE rows, its
     three launches timed together without the sizes' download, its plain
     version the token scan of rle_expand_prep and expand_tokens_plain;
     K7's interleaved packs on the planes K3 takes, then K2 -> K7 -> K1
     must give K3's rows; K1's time beside that of its output's memset
     alone), K5 (below each row's
     payload, where its planes are specified), K6 (its interleaved (B, 2P)
     vals and lens and its underrun flags) and K4 (untimed) on the (4, 8
     MiB) decode batch of the 200 MB text corpus, and K9 (a decode batch's
     rank tables and 12-bit table, built on the card) against the host
     builders, exact, on the mixed decode batch's (4, 256) code tables
     (untimed) and, timed, on the (64, 256) code tables of 64 blocks of
     640 KiB of the text corpus (the text_K cells' decode batch); beside
     each, the least
     time the card could take (bytes over 3.35 TB/s) and, for K4,
     torch.repeat_interleave, the one PyTorch call that computes the
     expansion from the token fields;
  4. K5 and the whole 17-32-bit decode chain on a hand-built complete table
     with codes of 26-32 bits against the NumPy oracle (the case of the JAX
     kernel's window fault); K2 once, K3 and K7 20 times each, at 8 and 16
     states, against their plain versions on rows at the edges of the
     look-back and K3's output words (a full row cut by its count, a row
     that ends on a tile boundary and underruns past the row width,
     123,457 bytes, 1 byte); K1, each variant 20 times, on rows at the
     edges of its tiles and look-back (1 lane, a tile boundary and one
     lane past it, spans of 0-bit lanes, 32-bit payloads straddling words;
     P a multiple of 16 and not), K5 on rows that end on and just past a
     tile, K4 5 times on its edge rows (k4_edge_rows), and K8 100 times on
     its edge rows (k8_edge_rows: runs that end at a tile's last and first
     three bytes, 0x00 runs of 1-3 and 254-511 bytes across tiles, an
     8 MiB one-byte row, an alternating 0x00 / x row, lengths 0-3 and a
     tile +- 1 with the bytes past them equal to the last);
  5. two main paths through ``shafa_tpu_torch.cli.main([path, "-b", "m"])``
     and back from their .rle.shaf, each bit-exact, with the launch counts
     set to 0 before and read after: the 200,000,000-byte mixed corpus
     (codes of at most 16 bits: K8, K1 LUT, K2-K4) and the
     200,000,000-byte text corpus with rare bytes (every block with codes
     of 17-32 bits: K8, K1, K5, K6, K4); both in the R mode, no block
     decoded on the host on either, and no plain stage runs
     (plain_stages: rle.token_starts, decode.interleave_packs,
     rle.rle_payloads, rle._rle_analyze, histogram.histogram_batch, each
     replaced by a function that raises);
  6. scale-out and the CLI's extras on the 200 MB mixed corpus, each
     fatal on failure, with launch counts read around it (on a host with
     n >= 2 cards, each rank sees half of them and D is n, all real):
     - multi-host: two processes (multiprocessing spawn) joined over gloo
       on this one card (COORDINATOR_ADDRESS at a free local port,
       NUM_PROCESSES=2, PROCESS_ID), each warmed up untimed on a small
       one-process round trip, then calling ``cli.main([path, "-b",
       "m"])`` and ``cli.main([path + ".rle.shaf"])``: .rle, .rle.freq,
       .rle.cod and .rle.shaf equal to those of 5 by SHA-256, the
       decompress bit-exact, each rank launching K8 and K1 LUT in its
       compress and K2, K3, K4 in its decompress, both ranks on one card
       (the same device uuid); each direction's wall printed;
     - multi-device: dist.ShardedBackend over [cuda:0, cuda:0] (two worker
       threads on one card; real multi-GPU is not exercised on a one-card
       box): ``dryrun.dryrun_multichip(2)``, then the round trip through
       ``cli.main`` with dist.block_devices giving the two entries, so that
       the CLI builds the sharded backend; sidecars equal to 5's;
     - ``--check`` at -b K on the first 4 MiB of the mixed and of the text
       corpus (the text reaching K5 and K6): bit-exact, and CheckedBackend
       compared a fused stage with the NumPy oracle in each direction;
     - ``--profile DIR`` on 20 MB of the mixed corpus at -b m: sidecars
       equal to an unprofiled run's (timed beside it), bit-exact, and the
       two traces in DIR name K1's, K2's, K3's, K4's and K8's kernels;
  7. the streaming path, with the 200 MB corpora freed first: a 1 GiB file
     of the mixed corpus (16 blocks of 64 MiB) through
     ``cli.main([path, "-b", "M"])``, which must stream in F, C and D and
     take the R mode; its .rle, .rle.freq, .rle.cod and .rle.shaf against
     those of the resident compress of a copy of the
     file (pipeline.STREAM_THRESHOLD raised for it, then restored), by
     SHA-256; the decompress of the streamed .rle.shaf and the RLE-only
     decode of its .rle (``-m d``, which streams, the .rle being above
     256 MiB), each bit-exact by SHA-256; launch counts read around each
     streaming step (K8, K1 LUT, K2, K3, K4), no block decoded on the
     host, the plain stages refused as in 5; the walls, MB/s and device
     memory peaks printed. Each file is deleted once it has been compared
     (about 4.5 GB at the peak). Then K8 and K1-K4 against their plain
     versions, exact and timed, on the inputs that this path gave them
     (one 64 MiB block a batch): K8 on the compress's first RLE encode
     batch, K1 bits on K8's plain version's payloads of it, K1 LUT on its
     first pack batch, K2 and K3 on the decompress's first decode batch,
     K4 on the first RLE rows of the decompress and of the RLE-only
     decode;
  8. the text corpus at -b M: 5 blocks of 64 MiB (335,544,320 bytes)
     through ``cli.main([path, "-b", "M"])`` and back, F and C streaming
     (and D, with the threshold lowered to 64 MiB for its 196 MB archive),
     bit-exact, every block's longest code 17-32 bits, no block decoded on
     the host, no plain stage run, walls and device peaks printed; K8, K1
     (both variants), K5, K6, K4 launched; then K1 LUT on the
     compress's first pack batch and K5 and K6 on the decompress's first
     decode batch (one 64 MiB block) against their plain versions, exact
     and timed, each on the whole row (K6's plain version composes the
     row's functions a chunk of lanes at a time, so that it fits);
  9. the decode-stage path: ``shafa_tpu_torch.bench_decode_stages.main``
     at its defaults (64 MiB of the synthetic corpus in 8 MiB blocks; K2,
     K7, K1, K3, K4 and its own checks), launch counts read around it;
  10. the bench path: ``shafa_tpu_torch.bench.run`` at its defaults (100 MB
     encode, 64 MB decode, 16 MB round trip, 100 MB streaming compress)
     with a budget of 300 s and scaling off; its JSON line printed with the
     card; a byte that differs, a section that ran out of time, or a line
     without roundtrip_bit_exact, decode_mb_s and streaming_e2e_mb_s
     fails; K8, K1 LUT, K2, K3, K4 must launch;
  11. the bench_stages path: ``shafa_tpu_torch.bench_stages.main`` at its
     defaults (64 MiB in 8 MiB blocks): each encode stage timed, with its
     bytes bound, and its check against the oracle; K8 and K1 LUT;
  12. the bench_scaling path: ``shafa_tpu_torch.bench_scaling.parent`` on
     24 blocks of 8 MiB at D = 1, 2, 4, 8, each count that has as many
     distinct cards (D = 1 alone on a one-card host; worker threads
     sharing one card are phase 6's D=2 round trip); every row's RLE
     streams and payloads equal by SHA-256, the first row's equal to the
     oracle's; K8 and K1 LUT;
  13. the sidecars of a 16 MB mixed and a 16 MB random file at -b K against
     the same CLI with ``--backend numpy``; no module of shafa_tpu and no
     jax imported in the whole run.

Each path of 5-12 has its launch counts set to 0 just before it and read
just after. The line before the last holds the kernels' JSON record
(``launches`` sums the counts of those paths, ``launches_by_path`` keeps
each); the last line is the device JSON line. Without a CUDA card, or
without the repository beside it, the script exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

CORPUS_BYTES = 200_000_000
#: BASELINE.md's 1 GiB configuration, at -b M (64 MiB blocks)
STREAM_BYTES = 1 << 30
SIDECAR_BYTES = 16_000_000
#: --check runs on this much of each 200 MB corpus, at -b K
CHECK_BYTES = 4 << 20
#: --profile runs on this much of the mixed corpus, at -b m (3 blocks)
PROFILE_BYTES = 20_000_000
#: the text corpus at -b M: 5 blocks of 64 MiB, above the 256 MiB streaming
#: threshold
TEXT_STREAM_BLOCKS = 5
TEXT_STREAM_BYTES = TEXT_STREAM_BLOCKS * (64 << 20)
#: pipeline.STREAM_THRESHOLD for that file's decompress: its .rle.shaf is
#: below 256 MiB, and the decompress is to stream too
TEXT_D_THRESHOLD = 64 << 20
#: bench_scaling's total and block on the card: the 200 MB cell's shape,
#: 24 blocks of 8 MiB (its 4 MiB / 64 KiB default times launch overhead)
SCALING_BYTES = 24 * (8 << 20)
#: bench.py's wall-clock budget here (its own default is 1100 s)
BENCH_BUDGET_S = 300.0
#: keys the bench's last line must carry: each a section that ran to its end
BENCH_KEYS = ("roundtrip_bit_exact", "decode_mb_s", "streaming_e2e_mb_s")
RLE_EXTS = (".rle", ".rle.freq", ".rle.cod", ".rle.shaf")
SEED = 0
BLOCK = 8 << 20

#: HBM bytes per second of one H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12

SOURCES = {
    "emit_bits": ("shafa_tpu_torch/kernels/csrc/emit.cu",
                  "shafa_tpu/kernels/emit_pallas.py:128"),
    "emit_coded": ("shafa_tpu_torch/kernels/csrc/emit.cu",
                   "shafa_tpu/kernels/emit_pallas.py:128"),
    "rank": ("shafa_tpu_torch/kernels/csrc/rank.cu",
             "shafa_tpu/kernels/decode.py:365"),
    "fsm_decode": ("shafa_tpu_torch/kernels/csrc/fsm_decode.cu",
                   "shafa_tpu/kernels/decode.py:1142"),
    "fsm_packs": ("shafa_tpu_torch/kernels/csrc/fsm_decode.cu",
                  "shafa_tpu/kernels/decode.py:930"),
    "expand": ("shafa_tpu_torch/kernels/csrc/expand.cu",
               "shafa_tpu/kernels/expand_pallas.py:64"),
    "rank32": ("shafa_tpu_torch/kernels/csrc/rank32.cu",
               "shafa_tpu/kernels/decode.py:485"),
    "fsm32": ("shafa_tpu_torch/kernels/csrc/fsm32.cu",
              "shafa_tpu/kernels/decode.py:631"),
    "rle_encode": ("shafa_tpu_torch/kernels/csrc/rle_encode.cu",
                   "shafa_tpu/kernels/rle.py:85"),
    # no TPU kernel: the JAX package builds these tables on the host
    "decode_tables": ("shafa_tpu_torch/kernels/csrc/decode_tables.cu",
                      "none (host NumPy, shafa_tpu/kernels/decode.py:95, "
                      ":330, :466)"),
}

#: Kernels each main path must launch. K1's bits variant ("emit_bits")
#: runs only where codes of 17-32 bits decode (K6 -> K1) and in the
#: decode-stage benchmark: every compress encodes with K8 ("rle_encode").
PATH_KERNELS = {
    "mixed": ("rle_encode", "emit_coded", "decode_tables", "rank",
              "fsm_decode", "expand_sizes", "expand"),
    "text": ("rle_encode", "emit_bits", "emit_coded", "decode_tables",
             "rank32", "fsm32", "expand_sizes", "expand"),
    "streaming": ("rle_encode", "emit_coded", "rank", "fsm_decode",
                  "expand_sizes", "expand"),
    "decode_stages": ("fsm_packs", "rank", "fsm_decode", "expand_sizes",
                      "expand", "emit_bits"),
    "multihost": ("rle_encode", "emit_coded", "rank", "fsm_decode",
                  "expand_sizes", "expand"),
    "multidevice": ("rle_encode", "emit_coded", "rank", "fsm_decode",
                    "expand_sizes", "expand"),
    "check": ("rle_encode", "emit_bits", "emit_coded", "rank", "fsm_decode",
              "rank32", "fsm32", "expand_sizes", "expand"),
    "profile": ("rle_encode", "emit_coded", "rank", "fsm_decode",
                "expand_sizes", "expand"),
    "text_stream": ("rle_encode", "emit_bits", "emit_coded", "rank32",
                    "fsm32", "expand_sizes", "expand"),
    # the corpus's codes have 9-10 bits: neither K5 nor K6 runs
    "bench": ("rle_encode", "emit_coded", "rank", "fsm_decode",
              "expand_sizes", "expand"),
    "bench_stages": ("rle_encode", "emit_coded"),
    "bench_scaling": ("rle_encode", "emit_coded"),
}

#: Kernels each rank of the multi-host run must launch, per direction.
RANK_KERNELS = {"compress": ("rle_encode", "emit_coded"),
                "decompress": ("rank", "fsm_decode", "expand_sizes",
                               "expand")}

#: Decode kernels each corpus's --check round trip must launch.
CHECK_KERNELS = {"mixed": ("rle_encode", "rank", "fsm_decode"),
                 "text": ("rle_encode", "rank32", "fsm32")}

#: A name in the --profile trace of each kernel of the mixed path.
TRACE_KERNELS = {"K1": "emit_tiles", "K2": "rank_lut", "K3": "fsm16_tile",
                 "K4": "expand_tiles", "K8": "rle_enc_onepass"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def timed_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, after a warm-up
    call)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(name, kernel, plain, moved: int, unpack) -> dict:
    """Kernel vs plain version on the same inputs: exact, then timed. The
    bound is the moved bytes at the card's memory rate: the lanes this
    data fills (not a batch's padding) read once, the outputs they give
    written once, and the tables."""
    import torch
    out = kernel()
    got = [t.to(torch.int64) for t in unpack(out)]
    want = [t.to(torch.int64) for t in unpack(plain())]
    torch.cuda.synchronize()
    shapes = [(tuple(g.shape), tuple(w.shape)) for g, w in zip(got, want)]
    if any(a != b for a, b in shapes):
        fail(f"{name}: the kernel's outputs and its plain version's differ "
             f"in shape: {[s for s in shapes if s[0] != s[1]][:4]}")
    err = max(int((g - w).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    if err:
        fail(f"{name}: kernel differs from its plain version "
             f"(max abs err {err})")
    del got, want, out
    ms = timed_ms(kernel, 5)
    plain_ms = timed_ms(plain, 2)
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                library_ms=None)


def encode_on_card(data: bytes, dev, rows: int):
    """The first rows blocks of data through the main path's encode on the
    card: the RLE rows and their histograms (K8), code tables, the pack
    (K1's LUT variant). Returns (x, lengths, RLE streams, their lengths,
    tables, payloads, the pack's arguments)."""
    import torch
    from shafa_tpu_torch import codes as codes_mod
    from shafa_tpu_torch.device import tables_to_device
    from shafa_tpu_torch.kernels import emit, pack, rle

    x, ld = batch_on_card(data, dev, rows)
    enc, enc_len, hist = rle.rle_encode_hist(x, ld)
    hist = hist.cpu().numpy()
    tables = codes_mod.build_code_tables(hist)
    dt = tables_to_device(tables, dev)
    byte_lens = pack.pack_byte_lens(hist, np.clip(tables.lens, 0, 32))
    woff_np, need = emit.aligned_offsets(byte_lens)
    woff = torch.from_numpy(woff_np).to(dev)
    src_len = enc_len.to(torch.int32)
    pack_args = (enc, src_len, dt.lut_len, dt.lut_val, woff, need)
    buf = emit.emit_coded(*pack_args).cpu().numpy().view(np.uint8)
    payloads = [buf[4 * int(w):4 * int(w) + int(n)]
                for w, n in zip(woff_np, byte_lens)]
    return x, ld, enc, enc_len, tables, payloads, pack_args


def batch_on_card(data: bytes, dev, rows: int):
    """The first rows BLOCK-byte blocks of data as the main path stacks
    them, on the card: (x, lengths)."""
    from shafa_tpu_torch.device import _stack_blocks
    stacked, lens = _stack_blocks([np.frombuffer(data, np.uint8, BLOCK,
                                                 i * BLOCK)
                                   for i in range(rows)])
    return torch_from(stacked, dev), torch_from(lens, dev)


def compare_k8(name: str, x, lengths) -> dict:
    """K8 against its plain version on the same (B, P) batch: out_len, each
    row's bytes below it and hist, exact; both timed. The bound counts the
    rows' valid bytes read once, the RLE bytes written once, the lengths
    and the histograms."""
    from shafa_tpu_torch.kernels import rle
    _, out_len, hist = rle.rle_encode_hist(x, lengths)

    def unpack(out):
        enc, n, h = out
        return [n, h] + [enc[i, :int(k)] for i, k in enumerate(n.tolist())]
    return compare(name, lambda: rle.rle_encode_hist(x, lengths),
                   lambda: rle.rle_encode_hist_plain(x, lengths),
                   int(lengths.sum()) + nbytes(lengths)
                   + int(out_len.sum()) + nbytes(out_len, hist), unpack)


def kernel_phase(data: bytes, dev) -> list[dict]:
    """K8, K1-K4 and K7 against their plain versions on the main path's
    shapes: one (8, 8 MiB) batch of the corpus for K8 and K1 (its bits
    variant on K8's plain version's payloads), and the (4, 8 MiB) decode
    batch that the main path builds from its payloads for K2-K4 and K7."""
    import torch
    from shafa_tpu_torch import codes as codes_mod
    from shafa_tpu_torch.device import (_bucket, _stack_blocks,
                                        tables_to_device)
    from shafa_tpu_torch.kernels import decode, emit, expand, rle

    x, ld, enc, enc_len, tables, payloads, pack_args = encode_on_card(
        data, dev, 8)
    results = [dict(name="rle_encode", shape=list(x.shape),
                    **compare_k8("K8 rle_encode", x, ld))]
    val, bitlen, _ = rle.rle_payloads(x, ld)
    stride = rle.rle_out_bound(BLOCK) // 4
    r = compare("K1 emit_bits",
                lambda: emit.emit_bits_rows(val, bitlen, ld, stride),
                lambda: emit.emit_bits_rows_plain(val, bitlen, ld, stride),
                8 * int(ld.sum()) + nbytes(ld) + int(enc_len.sum()),
                lambda rows_: [rows_[i, :int(n)] for i, n in
                               enumerate(enc_len.tolist())])
    # K1's share that zeroes its output (torch.zeros in the wrapper)
    r["memset_ms"] = timed_ms(lambda: torch.zeros(
        8 * stride, dtype=torch.int32, device=dev), 5)
    results.append(dict(name="emit_bits", shape=list(val.shape), **r))
    del val, bitlen

    r = compare("K1 emit_coded", lambda: emit.emit_coded(*pack_args),
                lambda: emit.emit_coded_plain(*pack_args),
                int(enc_len.sum()) + nbytes(*pack_args[1:5])
                + 4 * pack_args[5], lambda flat: [flat])
    r["memset_ms"] = timed_ms(lambda: torch.zeros(
        pack_args[5], dtype=torch.int32, device=dev), 5)
    results.append(dict(name="emit_coded", shape=list(enc.shape), **r))
    counts_np = enc_len.cpu().numpy().astype(np.int32)
    del x, enc, pack_args

    # the main path's decode batch: rows of the first 4 blocks
    drows = 4
    pst, plens = _stack_blocks(payloads[:drows], minimum=1024)
    # per payload byte: K2 reads the byte and K5 a 4-byte window, each
    # writes 8 int32 plane entries; K3/K6/K7 read those 32 bytes, K6/K7
    # write 4 int32 packs
    payload = int(plens.sum())
    sub = codes_mod.CodeTables(tables.lens[:drows], tables.vals[:drows])
    if int(sub.lens.max()) > 16:
        fail("the corpus's first blocks have codes over 16 bits")
    dd = tables_to_device(sub, dev, decode=True)
    host_tables_equal("K9 decode_tables on the mixed decode batch", sub,
                      (dd.pc16, dd.ls, dd.lut12), wide=False)
    s_states = 8 if int(sub.lens.max()) <= 8 else 16
    out_p = _bucket(int(counts_np[:drows].max()))
    px = torch.from_numpy(pst).to(dev)
    k2_tables = (dd.pc16, dd.ls, dd.lut12)
    r = compare("K2 rank",
                lambda: decode.rank_planes(px, *k2_tables),
                lambda: decode.rank_planes_plain(px, dd.pc16, dd.ls),
                33 * payload + nbytes(*k2_tables),
                lambda t: [t])
    results.append(dict(name="rank", shape=list(px.shape), **r))
    ls8 = decode.rank_planes(px, *k2_tables)
    pl = torch.from_numpy(plens).to(dev)
    cnt = torch.from_numpy(counts_np[:drows].copy()).to(dev)
    r = compare("K3 fsm_decode",
                lambda: decode.decode_rows(ls8, pl, cnt, s_states, out_p),
                lambda: decode.decode_rows_plain(ls8, pl, cnt, s_states,
                                                 out_p),
                32 * payload + nbytes(pl, cnt) + int(cnt.sum()) + drows,
                lambda t: list(t))
    results.append(dict(name="fsm_decode", shape=[drows, pst.shape[1]], **r))
    dec, under = decode.decode_rows(ls8, pl, cnt, s_states, out_p)
    if bool(under.any()):
        fail("K3 flagged underrun on the corpus")
    r = compare("K7 fsm_packs",
                lambda: decode.fsm_packs(ls8, pl, cnt, s_states),
                lambda: decode.fsm_packs_plain(ls8, pl, cnt, s_states),
                48 * payload + nbytes(pl, cnt) + drows, lambda t: list(t))
    results.append(dict(name="fsm_packs", shape=[drows, pst.shape[1]], **r))
    del ls8
    rows, under_v4 = decode.decode_batch_packs(px, pl, *k2_tables, cnt,
                                               out_p, s_states)
    if not (torch.equal(rows, dec) and torch.equal(under_v4, under)):
        fail("K2 -> K7 -> K1 does not give K3's rows")
    del rows
    print(f"K2 -> K7 -> K1 gives K3's rows on the mixed corpus's (4, 8 MiB) "
          f"decode batch at {s_states} states", flush=True)
    # K4 from the decode batch's RLE rows: passes A-C (the sizes' download
    # excluded) against the token scan and expand_tokens_plain; the bound
    # counts the RLE bytes read once and the expanded bytes written once
    total = k4_total(dec, cnt)
    if total != drows * BLOCK:
        fail(f"K4 sizes: {total} expanded bytes, expected {drows * BLOCK}")
    r = compare("K4 expand",
                lambda: expand.rle_expand(expand.rle_expand_sizes(dec, cnt),
                                          total),
                lambda: k4_plain(dec, cnt, total),
                int(cnt.sum()) + nbytes(cnt) + total, lambda t: [t])
    out = expand.rle_expand(expand.rle_expand_sizes(dec, cnt), total)
    if out.cpu().numpy().tobytes() != data[:drows * BLOCK]:
        fail("K1 -> K4 chain does not reproduce the corpus")
    # the library call for the same expansion: per-token counts in
    # (computed beforehand), the same back-to-back bytes out
    prep = expand.rle_expand_prep(dec, cnt)
    cnt_flat = torch.diff(prep["cum"], dim=1,
                          prepend=torch.zeros_like(prep["cum"][:, :1]))
    cnt_flat = cnt_flat.reshape(-1)
    sym_flat = prep["sym"].reshape(-1)
    del prep
    lib = torch.repeat_interleave(sym_flat, cnt_flat, output_size=total)
    if not torch.equal(lib, out):
        fail("torch.repeat_interleave disagrees with K4")
    del lib, out
    r["library_ms"] = timed_ms(
        lambda: torch.repeat_interleave(sym_flat, cnt_flat,
                                        output_size=total), 5)
    results.append(dict(name="expand", shape=list(dec.shape), **r))
    return results


def k4_total(x, lengths) -> int:
    """The rows' expanded bytes in all, from K4's sizes, checked against
    the plain version's."""
    import torch
    from shafa_tpu_torch.kernels import expand
    sizes = expand.rle_expand_sizes(x, lengths)["out_len"]
    plain = expand.rle_expand_prep(x, lengths)["out_len"]
    if not torch.equal(sizes, plain):
        fail(f"K4 sizes {sizes.tolist()} differ from the plain version's "
             f"{plain.tolist()}")
    return int(sizes.sum())


def k4_plain(x, lengths, total: int):
    """K4's plain version: the token scan, then expand_tokens_plain."""
    from shafa_tpu_torch.kernels import expand
    prep = expand.rle_expand_prep(x, lengths)
    return expand.expand_tokens_plain(prep["cum"], prep["sym"],
                                      prep["out_base"], total)


def k4_edge_rows(tile: int, seed: int) -> list[np.ndarray]:
    """K4's edge rows for tiles of `tile` RLE bytes: escapes that start at
    the last three bytes of tiles 1, 2 and 3, then literals and escapes of
    count 0, 255 or any, cut inside a triple; a row that ends on a lone
    0x00; an all-escape row of count 255, whose output spans about 85
    tiles' input a tile; rows of 0, 1, 2 and 3 bytes (a truncated triple,
    an escape of count 0); a last row of literals that makes the batch's
    total not a multiple of 16."""
    import torch
    from shafa_tpu_torch.device import _stack_blocks
    from shafa_tpu_torch.kernels import expand
    rng = np.random.default_rng(seed)

    def literals(n):
        return rng.integers(1, 256, n).astype(np.uint8)

    def escape(count):
        return np.array([0, rng.integers(0, 256), count], np.uint8)

    def stream(n):
        parts, size = [], 0
        while size < n:
            if rng.random() < 0.4:
                part = escape(int(rng.choice([0, 255, rng.integers(0, 256)])))
            else:
                part = literals(int(rng.integers(1, 8)))
            parts.append(part)
            size += part.size
        return np.concatenate(parts)

    edge, size = [], 0
    for k, d in ((1, 3), (2, 2), (3, 1)):  # escape at byte k * tile - d
        edge += [literals(k * tile - d - size), escape(int(rng.integers(256)))]
        size = k * tile - d + 3
    edge += [stream(2 * tile), np.array([0, 7], np.uint8)]
    rows = [np.concatenate(edge), np.zeros(0, np.uint8),
            np.array([65], np.uint8), np.array([0, 66], np.uint8),
            np.concatenate([stream(5 * tile), np.zeros(1, np.uint8)]),
            np.array([0, 67, 0], np.uint8),
            np.tile(np.array([0, 9, 255], np.uint8), 3 * tile)]
    x, lens = _stack_blocks(rows)
    total = int(expand.rle_expand_prep(torch.from_numpy(x),
                                       torch.from_numpy(lens))["out_len"].sum())
    rows.append(literals(1 if (total + 1) % 16 else 2))
    return rows


#: 0x00 runs that k8_edge_rows lays across tile boundaries
K8_ZERO_RUNS = (1, 2, 3, 254, 255, 256, 510, 511)


def k8_edge_rows(tile: int, width: int, seed: int):
    """K8's edge rows for tiles of `tile` input bytes, (B, width) uint8 and
    (B,) int32 lengths, every byte past a row's length equal to its last
    valid byte: runs of 1-5 bytes and one of tile // 2 that end at tiles'
    last three bytes and first three; 0x00 runs of K8_ZERO_RUNS bytes, each
    across a tile boundary; a one-byte row of the full width; a one-byte
    row cut 2 bytes past a 255 split (a short literal remainder) and a 0x00
    row cut 3 bytes past one (an escaped remainder); an alternating
    0x00 / x row (output 2 * width); rows of lengths 0-3 and tile - 1, tile
    and tile + 1; a row of short runs over 4 bytes (0x00 among them)."""
    rng = np.random.default_rng(seed)

    def distinct(n):
        """n nonzero bytes, none equal to the one before it."""
        out = rng.integers(1, 255, n).astype(np.uint8)
        same = np.flatnonzero(out[1:] == out[:-1]) + 1
        out[same] = np.where(out[same - 1] == 255, 1, out[same - 1] + 1)
        return out

    def other(*near):
        return next(int(v) for v in rng.permutation(np.arange(1, 256))
                    if v not in near)

    rows, lens = [], []

    def add(row, n):
        row = np.array(row[:width], np.uint8)
        row = np.concatenate([row, np.zeros(width - row.size, np.uint8)])
        row[n:] = row[n - 1] if n else 5
        rows.append(row)
        lens.append(n)

    row = distinct(width)
    ends = [k * tile + d for k, d in enumerate((-3, -2, -1, 0, 1, 2), 1)]
    for end, r in zip(ends, (3, 4, 2, 5, tile // 2, 1)):
        row[end - r + 1:end + 1] = other(row[end - r], row[end + 1])
    add(row, ends[-1] + 1)
    row, pos = distinct(width), tile
    for r in K8_ZERO_RUNS:
        start = pos - r // 2
        row[start:start + r] = 0
        pos = (-(-(start + r + 2) // tile) + 1) * tile
    if pos > width:
        raise ValueError(f"k8_edge_rows: {width} bytes hold no zero runs "
                         f"at tiles of {tile}")
    add(row, pos)
    add(np.full(width, 0x41), width)
    m = (width // 2) // 255
    add(np.full(width, 7), 255 * m + 2)
    add(np.zeros(width), 255 * m + 3)
    alt = distinct(width)
    alt[0::2] = 0
    add(alt, width)
    for n in (0, 1, 2, 3, tile - 1, tile, tile + 1):
        add(rng.choice(np.array([0, 1, 2, 200], np.uint8), width), n)
    runs = np.repeat(rng.choice(np.array([0, 1, 2, 200], np.uint8), width),
                     rng.integers(1, 7, width))
    add(runs, width - 7)
    return np.stack(rows), np.array(lens, np.int32)


def k5_tables(tables, dev) -> list:
    """K5's tables of a CodeTables batch on the card: pc32, ls, ncodes and
    the 12-bit table."""
    from shafa_tpu_torch.kernels import decode
    tabs = decode.rank_tables32(decode.decode_tables_batch(tables.lens,
                                                           tables.vals))
    return [torch_from(a, dev) for a in (*tabs, decode.rank_lut12_32(*tabs))]


def host_tables_equal(name: str, tables, got, wide: bool) -> None:
    """K9's tables on the card against the host builders' (decode.
    decode_tables_plain), exact."""
    from shafa_tpu_torch.device import _code_hi32
    from shafa_tpu_torch.kernels import decode
    want = decode.decode_tables_plain(torch_from(tables.lens, "cpu"),
                                      torch_from(_code_hi32(tables), "cpu"),
                                      wide)
    if len(got) != len(want) or any(
            g.dtype != w.dtype or not np.array_equal(g.cpu().numpy(),
                                                     w.numpy())
            for g, w in zip(got, want)):
        fail(f"{name}: the card's tables differ from the host builders'")


def decode_tables_row(text: bytes, dev) -> dict:
    """K9 against the host builders on the wide route, exact, then timed:
    the code tables of the text corpus's first 64 blocks of 640 KiB (-b
    K), a text_K decode batch. The bound counts the code lengths and codes
    read once and the tables written once."""
    from shafa_tpu_torch import codes as codes_mod, oracle
    from shafa_tpu_torch.device import _code_hi32
    from shafa_tpu_torch.kernels import decode
    rows, block = 64, 640 << 10
    tables = codes_mod.build_code_tables(np.stack(
        [oracle.histogram(np.frombuffer(text, np.uint8, block, i * block))
         for i in range(rows)]))
    if not (tables.lens.max(axis=1) > 16).all():
        fail("the text corpus's 640 KiB blocks have codes of at most 16 "
             "bits")
    lens, hi32 = torch_from(tables.lens, dev), torch_from(
        _code_hi32(tables), dev)
    got = decode.decode_tables_on_device(lens, hi32, True)
    host_tables_equal("K9 decode_tables", tables, got, True)
    r = compare("K9 decode_tables",
                lambda: decode.decode_tables_on_device(lens, hi32, True),
                lambda: [t.to(dev) for t in decode.decode_tables_plain(
                    lens, hi32, True)],
                nbytes(lens, hi32, *got), lambda t: list(t))
    return dict(name="decode_tables", shape=[rows, 256], **r)


def torch_from(a: np.ndarray, dev):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def below_payload(plens):
    """unpack of K5's planes for compare: the entries below each row's
    payload length (the kernel leaves the others unspecified)."""
    import torch
    b = plens.shape[0]

    def unpack(planes):
        p = planes.shape[1] // b
        below = torch.arange(p, device=planes.device)[None, :] \
            < plens.to(planes.device)[:, None]
        return [planes.reshape(8, b, p)[:, below]]
    return unpack


def kernel32_phase(text: bytes, dev) -> list[dict]:
    """K8 against its plain version on the text corpus's first (8, 8 MiB)
    batch (printed here), then K5 and K6 against theirs on the 17-32-bit
    path's decode batch: the payloads of the text corpus's first 4 blocks,
    as the main path packs them, in one (4, 8 MiB) batch."""
    import torch
    from shafa_tpu_torch.device import _bucket, _stack_blocks
    from shafa_tpu_torch.kernels import decode, expand

    x, ld = batch_on_card(text, dev, 8)
    r = compare_k8("K8 rle_encode on the text corpus", x, ld)
    print(f"rle_encode on the text corpus: shape {list(x.shape)} kernel "
          f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
          f"{r['bound_ms']:.3f} ms, exact", flush=True)
    del x, ld
    drows = 4
    _, _, enc, enc_len, tables, payloads, _ = encode_on_card(text, dev,
                                                             drows)
    maxlen = int(tables.lens.max())
    if not 16 < maxlen <= 32:
        fail(f"the text corpus's first blocks have codes of {maxlen} bits")
    pst, plens = _stack_blocks(payloads, minimum=1024)
    payload = int(plens.sum())
    counts_np = enc_len.cpu().numpy().astype(np.int32)
    k5 = k5_tables(tables, dev)
    px = torch.from_numpy(pst).to(dev)
    pl = torch.from_numpy(plens).to(dev)
    cnt = torch.from_numpy(counts_np).to(dev)
    results = []
    # K5 reads 1 B and writes 32 B of planes per payload byte, and its tables
    r = compare("K5 rank32",
                lambda: decode.rank_planes32(px, pl, *k5),
                lambda: decode.rank_planes32_plain(px, *k5[:3]),
                33 * payload + nbytes(*k5), below_payload(pl))
    results.append(dict(name="rank32", shape=list(px.shape), **r))
    planes = decode.rank_planes32(px, pl, *k5)
    r = compare("K6 fsm32",
                lambda: decode.fsm32_packs(planes, pl, cnt),
                lambda: decode.fsm32_packs_plain(planes, pl, cnt),
                48 * payload + nbytes(pl, cnt) + drows, lambda t: list(t))
    results.append(dict(name="fsm32", shape=[drows, pst.shape[1]], **r))
    del planes
    results.append(decode_tables_row(text, dev))
    dec, under = decode.decode_batch32(px, pl, *k5, cnt,
                                       _bucket(int(counts_np.max())))
    if bool(under.any()):
        fail("K6 flagged underrun on the text corpus")
    for i, n in enumerate(counts_np):
        if not torch.equal(dec[i, :n], enc[i, :n]):
            fail(f"K5 -> K6 -> K1 does not give row {i}'s RLE stream")
    total = k4_total(dec, cnt)
    if not torch.equal(expand.rle_expand(expand.rle_expand_sizes(dec, cnt),
                                         total), k4_plain(dec, cnt, total)):
        fail("K4 differs from its plain version on the text decode batch")
    print(f"text corpus decode batch: codes up to {maxlen} bits, "
          f"{int((tables.lens > 16).sum(axis=1).max())} symbols of a row "
          f"over 16 bits; K4 exact vs plain on its {total} bytes",
          flush=True)
    return results


def canonical_tables(lens_list, rows: int):
    """CodeTables of rows copies of the complete canonical code with these
    lengths (symbol s gets lens_list[s])."""
    from shafa_tpu_torch import codes as codes_mod
    lens = np.zeros((rows, 256), np.uint8)
    vals = np.zeros((rows, 256), np.uint64)
    code = prev = 0
    for s, ln in enumerate(lens_list):
        code <<= ln - prev
        lens[:, s] = ln
        vals[:, s] = np.uint64(code) << np.uint64(64 - ln)
        code += 1
        prev = ln
    return codes_mod.CodeTables(lens, vals)


def fault_phase(dev) -> None:
    """K5 and the whole 17-32-bit chain against oracle.unpack on a complete
    canonical table with codes of 26-32 bits, most of the symbols drawn
    from the long codes: the window at bit 8j+s needs byte j+4."""
    import torch
    from shafa_tpu_torch import oracle
    from shafa_tpu_torch.device import _bucket, _stack_blocks
    from shafa_tpu_torch.kernels import decode

    tables = canonical_tables(list(range(1, 32)) + [32, 32], 1)
    rng = np.random.default_rng(SEED)
    blk = rng.integers(25, 33, 300_000).astype(np.uint8)
    payload = oracle.pack(blk, tables.lens[0], tables.vals[0])
    st, plens = _stack_blocks([np.frombuffer(payload, np.uint8)],
                              minimum=1024)
    k5 = k5_tables(tables, dev)
    x = torch.from_numpy(st).to(dev)
    pl = torch.from_numpy(plens).to(dev)
    unpack = below_payload(pl)
    if not torch.equal(unpack(decode.rank_planes32(x, pl, *k5))[0],
                       unpack(decode.rank_planes32_plain(x, *k5[:3]))[0]):
        fail("K5 differs from its plain version on 26-32-bit codes")
    dec, under = decode.decode_batch32(
        x, pl, *k5, torch.tensor([blk.size], dtype=torch.int32, device=dev),
        _bucket(blk.size))
    want = oracle.unpack(payload, tables.row_strings(0), blk.size)
    if bool(under.any()) or not np.array_equal(
            dec[0, :blk.size].cpu().numpy(), want) \
            or not np.array_equal(want, blk):
        fail("the 17-32-bit chain differs from oracle.unpack on 26-32-bit "
             "codes")
    print(f"26-32-bit codes: K5 exact vs plain, K5 -> K6 -> K1 equals "
          f"oracle.unpack on {blk.size} symbols ({len(payload)} payload "
          "bytes)", flush=True)


def edge_phase(dev) -> None:
    """K2 once, K3 and K7 20 times each against their plain versions on a
    (4, 4 MiB) batch of random payload bytes under a complete code (1-16
    bits at 16 states, all 8 bits at 8): a full row cut by its count inside
    a tile, a row that ends on a tile boundary and underruns (its symbols
    pass the row width, where K3 drops them), a row of 123,457 bytes, a row
    of 1 byte. A look-back that reads a neighbour's count too early, or an
    edge word two tiles share, shows only in some runs."""
    import torch
    from shafa_tpu_torch.device import tables_to_device
    from shafa_tpu_torch.kernels import _build, decode

    rng = np.random.default_rng(SEED + 6)
    p = 4 << 20
    tile = _build.library().shafa_fsm_decode_tile_bytes()
    plens = np.array([p, 977 * tile, 123_457, 1], np.int32)
    st = rng.integers(0, 256, (4, p), dtype=np.uint8)
    st[np.arange(p)[None, :] >= plens[:, None]] = 0
    st[3, 0] = 0  # 1-bit codes at 16 states, one 8-bit code at 8
    for s_states, lens_list in ((16, list(range(1, 16)) + [16, 16]),
                                (8, [8] * 256)):
        dd = tables_to_device(canonical_tables(lens_list, 4), dev,
                              decode=True)
        px = torch.from_numpy(st).to(dev)
        planes = decode.rank_planes(px, dd.pc16, dd.ls, dd.lut12)
        if not torch.equal(planes,
                           decode.rank_planes_plain(px, dd.pc16, dd.ls)):
            fail(f"K2 differs from its plain version on the edge rows at "
                 f"{s_states} states")
        pl = torch.from_numpy(plens).to(dev)
        cnt = torch.tensor([3_000_000, 2 ** 31 - 1, 100_000, s_states // 8],
                           dtype=torch.int32, device=dev)
        out_p = 4 << 20
        want = decode.decode_rows_plain(planes, pl, cnt, s_states, out_p)
        if want[1].tolist() != [False, True, False, False]:
            fail(f"edge rows at {s_states} states: underrun flags "
                 f"{want[1].tolist()}")
        for _ in range(20):
            got = decode.decode_rows(planes, pl, cnt, s_states, out_p)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                fail(f"K3 differs from its plain version on the edge rows "
                     f"at {s_states} states")
        del want, got
        want = decode.fsm_packs_plain(planes, pl, cnt, s_states)
        for _ in range(20):
            got = decode.fsm_packs(planes, pl, cnt, s_states)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                fail(f"K7 differs from its plain version on the edge rows "
                     f"at {s_states} states")
        del planes, want, got
        torch.cuda.empty_cache()
    print("edge rows (4, 4 MiB): K2 exact vs plain, K3 and K7 exact vs plain "
          "in 20 runs each at 8 and 16 states", flush=True)


def k4_edge_phase(dev) -> None:
    """K4 5 times against its plain version on its edge rows
    (k4_edge_rows)."""
    import torch
    from shafa_tpu_torch.device import _stack_blocks
    from shafa_tpu_torch.kernels import _build, expand

    rows = k4_edge_rows(_build.library().shafa_expand_tile_bytes(), SEED + 9)
    st, lens = _stack_blocks(rows)
    x, ln = torch_from(st, dev), torch_from(lens, dev)
    total = k4_total(x, ln)
    if total % 16 == 0:
        fail(f"K4 edge rows: {total} expanded bytes, a multiple of 16")
    want = k4_plain(x, ln, total)
    for _ in range(5):
        if not torch.equal(expand.rle_expand(expand.rle_expand_sizes(x, ln),
                                             total), want):
            fail("K4 differs from its plain version on its edge rows")
    print(f"K4 edge rows ({len(rows)} rows of {lens.tolist()} RLE bytes, "
          f"{total} bytes expanded): exact vs plain in 5 runs", flush=True)


#: K8's launches on its edge rows: a look-back race that shows only
#: sometimes gets that many chances
K8_EDGE_RUNS = 100


def k8_edge_phase(dev) -> None:
    """K8 K8_EDGE_RUNS times against its plain version on its edge rows
    (k8_edge_rows at its own tile, 8 MiB wide)."""
    import torch
    from shafa_tpu_torch.kernels import _build, rle

    st, lens = k8_edge_rows(_build.library().shafa_rle_encode_tile_bytes(),
                            BLOCK, SEED + 10)
    x, ln = torch_from(st, dev), torch_from(lens, dev)
    want = rle.rle_encode_hist_plain(x, ln)
    sizes = want[1].tolist()
    rows = [want[0][i, :n] for i, n in enumerate(sizes)]
    if sizes[5] != 2 * BLOCK:
        fail(f"K8 edge rows: the alternating row gives {sizes[5]} bytes")
    for _ in range(K8_EDGE_RUNS):
        enc, out_len, hist = rle.rle_encode_hist(x, ln)
        if not (torch.equal(out_len, want[1]) and torch.equal(hist, want[2])
                and all(torch.equal(enc[i, :r.numel()], r)
                        for i, r in enumerate(rows))):
            fail("K8 differs from its plain version on its edge rows")
    del want, rows, enc, x
    torch.cuda.empty_cache()
    print(f"K8 edge rows ({len(lens)} rows of {lens.tolist()} bytes): "
          f"exact vs plain in {K8_EDGE_RUNS} runs", flush=True)


def emit_edge_case(variant: str, aligned: bool, tile: int, dev):
    """K1's edge rows, six rows of P lanes (P a multiple of 16, or not, so
    that lanes are read one at a time): a 1-lane row, rows that end on a
    tile boundary and one lane past it, a row whose tiles 2-40 hold only
    0-bit lanes (they publish 0 to the look-back), a row of 32-bit payloads
    after one 5-bit lane (each straddles two words), a row of 123,457
    lanes; rows start at word offsets that are not 16-byte aligned and the
    buffer ends inside the last row. Returns (kernel, plain) calls."""
    from shafa_tpu_torch.kernels import emit

    rng = np.random.default_rng(SEED + (7 if aligned else 8))
    b, p = 6, 48 * tile + (0 if aligned else 3)
    row_lens = np.array([1, 16 * tile, 16 * tile + 1, p, p, 123_457],
                        np.int32)
    if variant == "bits":
        lens = rng.integers(0, 33, (b, p)).astype(np.int32)
        lens[3, 2 * tile:41 * tile] = 0
        lens[4] = 32
        lens[4, 0] = 5
        args = (rng.integers(0, 1 << 32, (b, p), dtype=np.uint64)
                .astype(np.uint32).view(np.int32), lens, row_lens)
    else:
        x = rng.integers(1, 256, (b, p), dtype=np.uint8)
        x[3, 2 * tile:41 * tile] = 0
        x[4, 0], x[4, 1:] = 1, 255
        lut_len = rng.integers(1, 33, (b, 256)).astype(np.int32)
        lut_len[:, 0] = 0
        lut_len[4, 1], lut_len[4, 255] = 5, 32
        lens = np.take_along_axis(lut_len, x.astype(np.int64), 1)
        args = (x, row_lens, lut_len,
                rng.integers(0, 1 << 32, (b, 256), dtype=np.uint64)
                .astype(np.uint32).view(np.int32))
    words = [(int(lens[r, :n].sum()) + 31) // 32
             for r, n in enumerate(row_lens)]
    woff = np.cumsum([0] + [w + 3 for w in words[:-1]]) + 1
    out_words = int(woff[-1]) + words[-1] // 2
    on_card = [torch_from(a, dev) for a in (*args, woff.astype(np.int32))]
    if variant == "bits":
        return (lambda: emit.emit_bits(*on_card, out_words),
                lambda: emit.emit_bits_plain(*on_card, out_words))
    return (lambda: emit.emit_coded(*on_card, out_words),
            lambda: emit.emit_coded_plain(*on_card, out_words))


def k1_k5_edge_phase(dev) -> None:
    """K1, each variant 20 times at each P, against its plain version on
    its edge rows; K5 against its plain version below each row's payload on
    rows that fill P, end inside a tile, on a tile boundary and one byte
    past it, and hold 1 byte (random bytes under the complete 1-32-bit
    code)."""
    import torch
    from shafa_tpu_torch.kernels import _build, decode

    lib = _build.library()
    for variant in ("bits", "coded"):
        for aligned in (True, False):
            kernel, plain = emit_edge_case(
                variant, aligned, lib.shafa_emit_tile_lanes(), dev)
            want = plain()
            for _ in range(20):
                if not torch.equal(kernel(), want):
                    fail(f"K1 {variant} differs from its plain version on "
                         f"the edge rows (P a multiple of 16: {aligned})")
    tile = lib.shafa_rank32_tile_bytes()
    p = 1 << 16
    plens = np.array([p, 3 * tile + 100, 2 * tile, 2 * tile + 1, 1],
                     np.int32)
    st = np.random.default_rng(SEED + 50).integers(0, 256, (5, p),
                                                   dtype=np.uint8)
    k5 = k5_tables(canonical_tables(list(range(1, 32)) + [32, 32], 5), dev)
    x, pl = torch_from(st, dev), torch_from(plens, dev)
    unpack = below_payload(pl)
    if not torch.equal(unpack(decode.rank_planes32(x, pl, *k5))[0],
                       unpack(decode.rank_planes32_plain(x, *k5[:3]))[0]):
        fail("K5 differs from its plain version on its edge rows")
    print("edge rows: K1 bits and LUT exact vs plain in 20 runs each, P a "
          "multiple of 16 and not; K5 exact vs plain below the payload on "
          f"rows of {plens.tolist()} bytes", flush=True)


#: Blocks that run_cli's calls decoded on the host by design since the
#: phase set it to 0: each call's counter (tracing.counters, which every
#: cli.main resets) added up.
HOST_DECODED = [0]


def run_cli(argv: list[str], log) -> None:
    from shafa_tpu_torch import cli, tracing
    with contextlib.redirect_stdout(log):
        rc = cli.main(argv)
    HOST_DECODED[0] += tracing.counters()["host_decoded_blocks"]
    if rc != 0:
        fail(f"shafa_tpu_torch {' '.join(argv)} exited {rc}")


def plain_stages() -> tuple:
    """(module, name) of the plain-torch stages that no CLI path on the card
    runs in the R mode: K4's plain token scan, K7's plain interleave, K8's
    plain run analysis and histogram_batch (which only raw rows take, in
    the N mode and with -c f)."""
    from shafa_tpu_torch.kernels import decode, histogram, rle
    return ((rle, "token_starts"), (decode, "interleave_packs"),
            (rle, "rle_payloads"), (rle, "_rle_analyze"),
            (histogram, "histogram_batch"))


@contextlib.contextmanager
def refused(*targets):
    """Each (module, name) replaced by a function that raises while the
    block runs: a plain stage that must not run on a path."""
    saved = [(m, n, getattr(m, n)) for m, n in targets]

    def refuse(name):
        def call(*args, **kwargs):
            raise AssertionError(f"{name} ran on a CLI path")
        return call
    for m, n, _ in saved:
        setattr(m, n, refuse(n))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def main_path(work: str, name: str, data: bytes) -> dict:
    """A round trip at -b m through the CLI entry point, with the launch
    counts read around it."""
    import torch
    from shafa_tpu_torch import formats
    from shafa_tpu_torch.kernels import _build

    path = os.path.join(work, f"{name}.bin")
    with open(path, "wb") as fp:
        fp.write(data)
    log = io.StringIO()
    _build.reset_launches()
    HOST_DECODED[0] = 0
    torch.cuda.synchronize()
    with refused(*plain_stages()):
        t0 = time.perf_counter()
        run_cli([path, "-b", "m"], log)
        t1 = time.perf_counter()
        if not os.path.isfile(path + ".rle.shaf"):
            fail(f"{name}: compress did not take the R mode (.rle.shaf "
                 "missing)")
        os.rename(path, path + ".orig")
        t2 = time.perf_counter()
        run_cli([path + ".rle.shaf"], log)
        t3 = time.perf_counter()
    launches = dict(_build.launches)
    sidecars = {e: sha256(path + e) for e in RLE_EXTS}
    with open(path, "rb") as fp:
        if fp.read() != data:
            fail(f"{name}: the 200 MB round trip is not bit-exact")
    missing = [k for k in PATH_KERNELS[name] if launches[k] < 1]
    if missing:
        fail(f"{name}: {missing} not launched on the main path: {launches}")
    if HOST_DECODED[0]:
        fail(f"{name}: {HOST_DECODED[0]} blocks decoded on the host")
    with open(path + ".rle.cod", "rb") as fp:
        _, _, tables = formats.parse_cod_tables(fp.read())
    maxlen = tables.lens.max(axis=1)
    for f in (path, path + ".orig", path + ".rle"):
        os.remove(f)
    return dict(launches=launches, compress_s=t1 - t0, decompress_s=t3 - t2,
                shaf_bytes=os.path.getsize(path + ".rle.shaf"),
                blocks=len(maxlen), maxlen=(int(maxlen.min()),
                                            int(maxlen.max())),
                sidecars=sidecars)


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fp:
        for chunk in iter(lambda: fp.read(64 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


@contextlib.contextmanager
def recorded(module, *names):
    """Each named function of module wrapped to keep the reports it returns
    while the block runs: {name: [reports, ...]}."""
    calls = {n: [] for n in names}
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls[name].append(out[1])
            return out
        return call
    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


@contextlib.contextmanager
def captured(*targets):
    """Each (module, name) wrapped to keep a host copy of the arguments of
    its first call under each label: yields ({(label, name): args}, arm),
    where arm(label) sets the label (None keeps nothing)."""
    import torch
    got = {}
    label = [None]
    saved = [(m, n, getattr(m, n)) for m, n in targets]

    def wrap(name, fn):
        def call(*args):
            if label[0] is not None and (label[0], name) not in got:
                got[label[0], name] = tuple(
                    a.to("cpu", copy=True) if isinstance(a, torch.Tensor)
                    else a for a in args)
            return fn(*args)
        return call
    for m, n, fn in saved:
        setattr(m, n, wrap(n, fn))
    try:
        yield got, lambda new: label.__setitem__(0, new)
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def streaming_path(work: str) -> dict:
    """BASELINE's 1 GiB -b M round trip through the streaming pipelines, the
    resident compress of the same file beside it, and the RLE-only decode
    of the streamed .rle; launch counts read around each streaming step
    and summed. The arguments of the first call of each kernel's entry in
    each streaming step are kept on the host for stream_kernel_phase."""
    import torch
    from shafa_tpu_torch import pipeline
    from shafa_tpu_torch.kernels import _build, decode, expand, pack, rle
    from shafa_tpu_torch.profile_main_path import synthetic

    path = os.path.join(work, "stream.bin")
    data = synthetic(STREAM_BYTES, SEED)
    want = hashlib.sha256(data).hexdigest()
    with open(path, "wb") as fp:
        fp.write(data)
    del data
    exts = (".rle", ".rle.freq", ".rle.cod", ".rle.shaf")
    launches = {}
    walls = {}
    peaks = {}

    def step(name, argv):
        arm(None if name == "resident" else name)
        _build.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_cli(argv, io.StringIO())
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        peaks[name] = torch.cuda.max_memory_allocated()
        if name != "resident":
            for k, n in _build.launches.items():
                launches[k] = launches.get(k, 0) + n
        print(f"streaming phase, {name}: {walls[name]:.3f} s, launches "
              f"{dict(_build.launches)}", flush=True)

    HOST_DECODED[0] = 0
    with refused(*plain_stages()), \
            recorded(pipeline, "compress_pipeline_streaming",
                     "_module_d_shafa_streaming",
                     "_module_d_rle_streaming") as calls, \
            captured((rle, "rle_encode_hist"), (pack, "pack_batch"),
                     (decode, "decode_batch"),
                     (expand, "rle_expand_sizes")) as (args, arm):
        step("compress", [path, "-b", "M"])
        # F and C are one driver: its call shows that both streamed
        (reps,) = calls["compress_pipeline_streaming"] or [None]
        if reps is None or not reps[0].extra.get("streaming"):
            fail("streaming: the 1 GiB compress did not stream in F and C")
        if not reps[0].extra["compress_rle"] \
                or not os.path.isfile(path + ".rle.shaf"):
            fail("streaming: the 1 GiB compress did not take the R mode")
        streamed = {e: sha256(path + e) for e in exts}
        sizes = {e: os.path.getsize(path + e) for e in exts}

        resident = os.path.join(work, "resident.bin")
        shutil.copyfile(path, resident)
        threshold = pipeline.STREAM_THRESHOLD
        pipeline.STREAM_THRESHOLD = 1 << 62
        try:
            step("resident", [resident, "-b", "M"])
        finally:
            pipeline.STREAM_THRESHOLD = threshold
        if len(calls["compress_pipeline_streaming"]) != 1:
            fail("streaming: the resident compress streamed")
        for e in exts:
            if sha256(resident + e) != streamed[e]:
                fail(f"streaming: {e} differs from the resident compress's")
        for f in (resident,) + tuple(resident + e for e in exts):
            os.remove(f)

        os.remove(path)
        step("decompress", [path + ".rle.shaf"])
        (rep_d,) = calls["_module_d_shafa_streaming"] or [None]
        if rep_d is None or not rep_d.extra.get("streaming"):
            fail("streaming: the decompress did not stream")
        if sha256(path) != want:
            fail("streaming: the 1 GiB round trip is not bit-exact")
        for f in (path, path + ".rle.shaf", path + ".rle.cod"):
            os.remove(f)

        step("rle_decode", [path + ".rle", "-m", "d"])
        if len(calls["_module_d_rle_streaming"]) != 1:
            fail("streaming: the RLE-only decode of the .rle did not "
                 "stream")
        if sha256(path) != want:
            fail("streaming: the RLE-only decode is not bit-exact")
        for f in (path, path + ".rle", path + ".rle.freq"):
            os.remove(f)
        arm(None)
    missing = [k for k in PATH_KERNELS["streaming"] if launches.get(k, 0) < 1]
    if missing:
        fail(f"streaming: {missing} not launched: {launches}")
    if HOST_DECODED[0]:
        fail(f"streaming: {HOST_DECODED[0]} blocks decoded on the host")
    return dict(launches=launches, walls=walls, peaks=peaks, sizes=sizes,
                blocks=reps[0].n_blocks, args=args)


def stream_kernel_phase(args: dict, dev) -> list[dict]:
    """K8 and K1-K4 against their plain versions on the inputs that the
    streaming path gave them (streaming_path's first call of each entry,
    one 64 MiB block a batch): K8 on the compress's first RLE encode batch,
    K1 bits on K8's plain version's payloads of it, K1 LUT on its first
    pack batch, K2 and K3 on the decompress's first decode batch, K4 on
    the first RLE rows of the decompress and of the RLE-only decode. Exact
    equality, both timed."""
    import torch
    from shafa_tpu_torch.kernels import decode, emit, expand, rle

    def on_card(key):
        if key not in args:
            fail(f"streaming: {key[1]} was not called in the {key[0]} step")
        return [a.to(dev) if isinstance(a, torch.Tensor) else a
                for a in args[key]]

    x, ld = on_card(("compress", "rle_encode_hist"))
    results = [dict(name="rle_encode", shape=list(x.shape),
                    **compare_k8("K8 rle_encode at the streaming shapes", x,
                                 ld))]
    val, bitlen, out_len = rle.rle_payloads(x, ld)
    ld = ld.to(torch.int32)
    stride = rle.rle_out_bound(x.shape[1]) // 4
    r = compare("K1 emit_bits at the streaming shapes",
                lambda: emit.emit_bits_rows(val, bitlen, ld, stride),
                lambda: emit.emit_bits_rows_plain(val, bitlen, ld, stride),
                8 * int(ld.sum()) + nbytes(ld) + int(out_len.sum()),
                lambda rows_: [rows_[i, :int(n)] for i, n in
                               enumerate(out_len.tolist())])
    results.append(dict(name="emit_bits", shape=list(val.shape), **r))
    del x, val, bitlen

    pack_args = on_card(("compress", "pack_batch"))
    r = compare("K1 emit_coded at the streaming shapes",
                lambda: emit.emit_coded(*pack_args),
                lambda: emit.emit_coded_plain(*pack_args),
                int(pack_args[1].sum()) + nbytes(*pack_args[1:5])
                + 4 * pack_args[5], lambda flat: [flat])
    results.append(dict(name="emit_coded", shape=list(pack_args[0].shape),
                        **r))
    del pack_args

    px, pl, pc16, ls, lut12, cnt, out_p, s_states = on_card(
        ("decompress", "decode_batch"))
    payload = int(pl.sum())
    r = compare("K2 rank at the streaming shapes",
                lambda: decode.rank_planes(px, pc16, ls, lut12),
                lambda: decode.rank_planes_plain(px, pc16, ls),
                33 * payload + nbytes(pc16, ls, lut12), lambda t: [t])
    results.append(dict(name="rank", shape=list(px.shape), **r))
    ls8 = decode.rank_planes(px, pc16, ls, lut12)
    r = compare("K3 fsm_decode at the streaming shapes",
                lambda: decode.decode_rows(ls8, pl, cnt, s_states, out_p),
                lambda: decode.decode_rows_plain(ls8, pl, cnt, s_states,
                                                 out_p),
                32 * payload + nbytes(pl, cnt) + int(cnt.sum())
                + px.shape[0], lambda t: list(t))
    results.append(dict(name="fsm_decode", shape=list(px.shape), **r))
    del ls8, px

    for step in ("decompress", "rle_decode"):
        dec, lens = on_card((step, "rle_expand_sizes"))
        total = k4_total(dec, lens)
        r = compare(f"K4 expand at the streaming shapes ({step})",
                    lambda: expand.rle_expand(
                        expand.rle_expand_sizes(dec, lens), total),
                    lambda: k4_plain(dec, lens, total),
                    int(lens.sum()) + nbytes(lens) + total, lambda t: [t])
        results.append(dict(name="expand", step=step,
                            shape=list(dec.shape), **r))
        del dec
    torch.cuda.empty_cache()
    return results


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def patched(owner, name, value):
    """owner.name set to value while the block runs."""
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def multihost_rank(rank: int, path: str, ports, barrier, results,
                   repo: str, visible: str | None) -> None:
    """One of multihost_path's two processes (started by spawn): after an
    untimed one-process warm-up, the CLI's compress of path, then its
    decompress, each a multi-host run joined over gloo at its own port;
    launch counts read around each. Rank 0 moves the input aside between
    the two, while rank 1 waits at the barrier. visible, where given, is
    the rank's CUDA_VISIBLE_DEVICES."""
    if visible is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = visible
    sys.path.insert(0, repo)
    import torch
    from shafa_tpu_torch import cli, tracing
    from shafa_tpu_torch.kernels import _build

    from shafa_tpu_torch.profile_main_path import synthetic

    _build.library()
    props = torch.cuda.get_device_properties(0)
    uuids = [str(torch.cuda.get_device_properties(i).uuid)
             for i in range(torch.cuda.device_count())]
    # warm-up, untimed: a one-process round trip of a small file on the
    # rank's cards, as the one-process run it is compared with is warm
    warm = f"{path}.warm{rank}"
    with open(warm, "wb") as fp:
        fp.write(synthetic(PROFILE_BYTES, rank))
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main([warm, "-b", "m"]) or cli.main([warm + ".rle.shaf"])
    for f in [warm] + [warm + e for e in RLE_EXTS]:
        if os.path.exists(f):
            os.remove(f)
    if rc:
        results.put((rank, "warm-up", dict(rc=rc)))
        return
    os.environ.update(NUM_PROCESSES="2", PROCESS_ID=str(rank))
    for step, argv, port in (("compress", [path, "-b", "m"], ports[0]),
                             ("decompress", [path + ".rle.shaf"], ports[1])):
        os.environ["COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
        barrier.wait()
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        results.put((rank, step, dict(
            rc=rc, s=time.perf_counter() - t0,
            launches=dict(_build.launches),
            host_decoded=tracing.counters()["host_decoded_blocks"],
            card=props.name, uuids=uuids)))
        if rc:
            return
        barrier.wait()
        if step == "compress" and rank == 0:
            os.rename(path, path + ".orig")


def multihost_path(work: str, data: bytes, want: dict,
                   visible=None) -> dict:
    """The 200 MB mixed corpus through ``cli.main([path, "-b", "m"])`` and
    back in two processes joined over gloo: both on the one card, or, with
    visible (two CUDA_VISIBLE_DEVICES values), each on its own cards. Their
    sidecars must equal the one-process run's (want: SHA-256 by
    extension), the decompress must be bit-exact, and each rank must have
    launched its direction's kernels."""
    import multiprocessing as mp
    import queue

    path = os.path.join(work, "mh.bin")
    with open(path, "wb") as fp:
        fp.write(data)
    ctx = mp.get_context("spawn")
    barrier = ctx.Barrier(2, timeout=300)
    results = ctx.Queue()
    ports = (free_port(), free_port())
    procs = [ctx.Process(target=multihost_rank, args=(
        rank, path, ports, barrier, results,
        os.path.dirname(os.path.abspath(__file__)),
        None if visible is None else visible[rank])) for rank in (0, 1)]
    got = {}
    t_start = time.perf_counter()
    try:
        for p in procs:
            p.start()
        while len(got) < 4:
            try:
                rank, step, res = results.get(timeout=5)
            except queue.Empty:
                for rank, p in enumerate(procs):
                    if not p.is_alive() and (rank, "decompress") not in got:
                        fail(f"multihost: rank {rank} ended with "
                             f"{p.exitcode} before its results")
                if time.perf_counter() - t_start > 900:
                    fail("multihost: the two ranks took over 900 s")
                continue
            got[rank, step] = res
            if res["rc"]:
                fail(f"multihost: rank {rank}'s {step} exited {res['rc']}")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    for e in RLE_EXTS:
        if sha256(path + e) != want[e]:
            fail(f"multihost: {e} differs from the one-process run's")
    if sha256(path) != hashlib.sha256(data).hexdigest():
        fail("multihost: the two-rank round trip is not bit-exact")
    launches = {}
    for (rank, step), res in got.items():
        missing = [k for k in RANK_KERNELS[step] if res["launches"][k] < 1]
        if missing:
            fail(f"multihost: rank {rank} launched no {missing} in its "
                 f"{step}: {res['launches']}")
        if res["host_decoded"]:
            fail(f"multihost: rank {rank} decoded {res['host_decoded']} "
                 "blocks on the host")
        for k, n in res["launches"].items():
            launches[k] = launches.get(k, 0) + n
    ranks = [got[r, "compress"]["uuids"] for r in (0, 1)]
    if visible is None and ranks[0] != ranks[1]:
        fail(f"multihost: the ranks ran on {ranks}, not on one card")
    if visible is not None and set(ranks[0]) & set(ranks[1]):
        fail(f"multihost: the ranks shared cards: {ranks}")
    for f in (path, path + ".orig") + tuple(path + e for e in RLE_EXTS):
        os.remove(f)
    return dict(launches=launches,
                walls={step: [got[r, step]["s"] for r in (0, 1)]
                       for step in ("compress", "decompress")},
                card=got[0, "compress"]["card"], uuids=ranks,
                by_rank={f"{r} {s}": got[r, s]["launches"] for r, s in got})


def multidevice_path(work: str, data: bytes, want: dict, devs) -> dict:
    """dist.ShardedBackend over devs, or over every visible card where devs
    is None: the dry run (shafa_tpu_torch.dryrun.dryrun_multichip), then
    the 200 MB mixed corpus through ``cli.main([path, "-b", "m"])`` and
    back. With devs given (two entries that are both the one card),
    dist.block_devices gives them, so that the CLI builds the sharded
    backend as it does on a host with several cards. Sidecars equal to the
    one-device run's by SHA-256, bit-exact, launch counts read around the
    round trip."""
    import torch
    from shafa_tpu_torch import dist, dryrun
    from shafa_tpu_torch.kernels import _build

    block_devices = dist.block_devices
    n_devices = len(devs or block_devices())
    t0 = time.perf_counter()
    dryrun.dryrun_multichip(n_devices, devices=devs)
    dry_s = time.perf_counter() - t0
    path = os.path.join(work, "md.bin")
    with open(path, "wb") as fp:
        fp.write(data)
    made = []
    make = dist.make_backend

    def make_recorded(*args, **kwargs):
        made.append(make(*args, **kwargs))
        return made[-1]
    HOST_DECODED[0] = 0
    _build.reset_launches()
    torch.cuda.synchronize()
    with patched(dist, "block_devices",
                 lambda devices=None: devs or block_devices(devices)), \
            patched(dist, "make_backend", make_recorded), \
            refused(*plain_stages()):
        t0 = time.perf_counter()
        run_cli([path, "-b", "m"], io.StringIO())
        t1 = time.perf_counter()
        os.rename(path, path + ".orig")
        t2 = time.perf_counter()
        run_cli([path + ".rle.shaf"], io.StringIO())
        t3 = time.perf_counter()
    launches = dict(_build.launches)
    for b in made:
        b.close()
    if [(type(b).__name__, len(b.devices)) for b in made] \
            != [("ShardedBackend", n_devices)] * 2:
        fail(f"multidevice: the CLI built {made}")
    for e in RLE_EXTS:
        if sha256(path + e) != want[e]:
            fail(f"multidevice: {e} differs from the one-device run's")
    if sha256(path) != hashlib.sha256(data).hexdigest():
        fail("multidevice: the D=2 round trip is not bit-exact")
    missing = [k for k in PATH_KERNELS["multidevice"] if launches[k] < 1]
    if missing:
        fail(f"multidevice: {missing} not launched: {launches}")
    if HOST_DECODED[0]:
        fail("multidevice: blocks decoded on the host")
    for f in (path, path + ".orig") + tuple(path + e for e in RLE_EXTS):
        os.remove(f)
    return dict(launches=launches, dryrun_s=dry_s, compress_s=t1 - t0,
                decompress_s=t3 - t2,
                devices=[str(d) for d in made[0].devices])


def scale_out(work: str, data: bytes, runs: dict, dev, card: str) -> None:
    """The multi-host and multi-device phases, held against runs["mixed"]
    (the one-process round trip of the same data). On one card: two ranks
    share it, and D=2 is [dev, dev]. On n >= 2 cards: each rank sees half
    of them, and D is all n."""
    import torch
    n = torch.cuda.device_count()
    one = runs["mixed"]
    halves = None if n < 2 else [
        ",".join(map(str, range(n // 2))),
        ",".join(map(str, range(n // 2, n)))]
    res = runs["multihost"] = multihost_path(work, data, one["sidecars"],
                                             halves)
    w = res["walls"]
    where = ("both on one card" if halves is None else
             f"rank 0 on cards {halves[0]}, rank 1 on cards {halves[1]}")
    print(f"multi-host, 2 ranks joined over gloo, {where} ({res['card']}, "
          f"device uuids by rank {res['uuids']}) on {card}: mixed 200 MB "
          f"-b m compress {max(w['compress']):.3f} s (ranks "
          f"{w['compress'][0]:.3f} / {w['compress'][1]:.3f} s; one process "
          f"{one['compress_s']:.3f} s), decompress "
          f"{max(w['decompress']):.3f} s (ranks {w['decompress'][0]:.3f} / "
          f"{w['decompress'][1]:.3f} s; one process "
          f"{one['decompress_s']:.3f} s); .rle, .rle.freq, .rle.cod, "
          ".rle.shaf equal to the one-process run's by SHA-256, round trip "
          f"bit-exact, launches by rank and direction {res['by_rank']}",
          flush=True)
    res = runs["multidevice"] = multidevice_path(
        work, data, one["sidecars"], [dev, dev] if n < 2 else None)
    what = (f"D=2 on one card (two worker threads on {dev}; real multi-GPU "
            "is not exercised on a one-card box)" if n < 2 else
            f"D={n} on {n} cards")
    print(f"multi-device {what}, dist.ShardedBackend over {res['devices']} "
          f"on {card}: dryrun_multichip {res['dryrun_s']:.3f} s; mixed "
          f"200 MB -b m compress {res['compress_s']:.3f} s (one device "
          f"{one['compress_s']:.3f} s), decompress {res['decompress_s']:.3f} "
          f"s (one device {one['decompress_s']:.3f} s); sidecars equal to "
          "the one-device run's by SHA-256, round trip bit-exact, launches "
          f"{res['launches']}", flush=True)


def check_path(work: str, corpora: dict) -> dict:
    """``cli.main([path, "-b", "K", "--check"])`` and back on the first
    CHECK_BYTES of the mixed and of the text corpus: bit-exact, and
    pipeline.CheckedBackend compared at least one fused stage with the
    NumPy oracle in each direction; the text reaches K5 and K6."""
    from shafa_tpu_torch import pipeline
    from shafa_tpu_torch.kernels import _build

    stages = []
    cmp = pipeline.CheckedBackend._cmp

    def cmp_recorded(self, stage, got, want):
        stages.append(stage)
        return cmp(self, stage, got, want)
    launches, walls = {}, {}
    with patched(pipeline.CheckedBackend, "_cmp", cmp_recorded):
        for name, need in CHECK_KERNELS.items():
            data = corpora[name][:CHECK_BYTES]
            path = os.path.join(work, f"check_{name}.bin")
            with open(path, "wb") as fp:
                fp.write(data)
            _build.reset_launches()
            seen = []
            for argv in ([path, "-b", "K", "--check"], None):
                if argv is None:
                    os.rename(path, path + ".orig")
                    shaf = [path + e for e in (".rle.shaf", ".shaf")
                            if os.path.isfile(path + e)][0]
                    argv = [shaf, "--check"]
                stages.clear()
                t0 = time.perf_counter()
                run_cli(argv, io.StringIO())
                walls[name, "decompress" if seen else "compress"] = \
                    time.perf_counter() - t0
                seen.append(sorted(set(stages)))
            with open(path, "rb") as fp:
                if fp.read() != data:
                    fail(f"check {name}: the --check round trip is not "
                         "bit-exact")
            if not any(s.startswith("fused_") for s in seen[0]) \
                    or "fused_decode" not in seen[1]:
                fail(f"check {name}: CheckedBackend compared {seen}")
            missing = [k for k in need if _build.launches[k] < 1]
            if missing:
                fail(f"check {name}: {missing} not launched: "
                     f"{_build.launches}")
            for k, n in _build.launches.items():
                launches[k] = launches.get(k, 0) + n
            print(f"--check {name} {len(data)} bytes -b K on the card: "
                  f"compress {walls[name, 'compress']:.3f} s (compared "
                  f"{', '.join(seen[0])}), decompress "
                  f"{walls[name, 'decompress']:.3f} s (compared "
                  f"{', '.join(seen[1])}), bit-exact, launches "
                  f"{dict(_build.launches)}", flush=True)
            for f in os.listdir(work):
                if f.startswith(f"check_{name}.bin"):
                    os.remove(os.path.join(work, f))
    return dict(launches=launches, walls=walls)


def profile_path(work: str, data: bytes) -> dict:
    """``cli.main([path, "-b", "m", "--profile", DIR])`` and back on
    PROFILE_BYTES of the mixed corpus: sidecars equal to an unprofiled
    run's, bit-exact, and the traces in DIR name K1-K4's and K8's kernels.
    The unprofiled round trip of the same bytes is timed beside it."""
    import torch
    from shafa_tpu_torch.kernels import _build

    data = data[:PROFILE_BYTES]
    path = os.path.join(work, "prof.bin")
    ref = os.path.join(work, "prof_ref.bin")
    trace_dir = os.path.join(work, "traces")
    for p in (path, ref):
        with open(p, "wb") as fp:
            fp.write(data)
    launches, walls, plain_walls = {}, {}, {}
    for step, argv in (("compress", [ref, "-b", "m"]),
                       ("decompress", [ref + ".rle.shaf"])):
        if step == "decompress":
            os.rename(ref, ref + ".orig")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_cli(argv, io.StringIO())
        plain_walls[step] = time.perf_counter() - t0
    os.rename(ref + ".orig", ref)
    for step, argv in (("compress", [path, "-b", "m"]),
                       ("decompress", [path + ".rle.shaf"])):
        if step == "decompress":
            for e in RLE_EXTS:
                if sha256(path + e) != sha256(ref + e):
                    fail(f"profile: {e} differs from an unprofiled run's")
            os.rename(path, path + ".orig")
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_cli(argv + ["--profile", trace_dir], io.StringIO())
        walls[step] = time.perf_counter() - t0
        for k, n in _build.launches.items():
            launches[k] = launches.get(k, 0) + n
    with open(path, "rb") as fp:
        if fp.read() != data:
            fail("profile: the profiled round trip is not bit-exact")
    traces = sorted(f for f in os.listdir(trace_dir)
                    if f.endswith(".pt.trace.json"))
    if len(traces) != 2:
        fail(f"profile: {traces} in the trace directory, not two traces")
    names = set()
    for t in traces:
        with open(os.path.join(trace_dir, t)) as fp:
            names.update(ev.get("name", "") for ev in
                         json.load(fp)["traceEvents"]
                         if ev.get("cat") == "kernel")
    found = {k: sum(sub in n for n in names)
             for k, sub in TRACE_KERNELS.items()}
    if not all(found.values()):
        fail(f"profile: the traces name no kernel of "
             f"{[k for k, n in found.items() if not n]}")
    missing = [k for k in PATH_KERNELS["profile"] if launches[k] < 1]
    if missing:
        fail(f"profile: {missing} not launched: {launches}")
    size = sum(os.path.getsize(os.path.join(trace_dir, t)) for t in traces)
    shutil.rmtree(trace_dir)
    for f in os.listdir(work):
        if f.startswith("prof"):
            os.remove(os.path.join(work, f))
    return dict(launches=launches, walls=walls, plain_walls=plain_walls,
                traces=len(traces), trace_bytes=size,
                kernel_names=len(names))


def text_stream_path(work: str) -> dict:
    """The text corpus at -b M above the streaming threshold:
    TEXT_STREAM_BYTES through ``cli.main([path, "-b", "M"])`` and back.
    F, C and D must stream (D with pipeline.STREAM_THRESHOLD at
    TEXT_D_THRESHOLD, the archive being smaller than the input), every
    block's longest code must be 17-32 bits
    (K5 -> K6 -> K1 in the decompress), no block decoded on the host, the
    round trip bit-exact; walls and device peaks kept. The arguments of
    the compress's first pack batch and the decompress's first 17-32-bit
    decode batch are kept on the host for text_kernel_phase."""
    import torch
    from shafa_tpu_torch import formats, pipeline
    from shafa_tpu_torch.kernels import _build, decode, pack
    from shafa_tpu_torch.profile_main_path import text_with_rare_bytes

    path = os.path.join(work, "text_stream.bin")
    t0 = time.perf_counter()
    data = text_with_rare_bytes(TEXT_STREAM_BYTES)
    make_s = time.perf_counter() - t0
    want = hashlib.sha256(data).hexdigest()
    with open(path, "wb") as fp:
        fp.write(data)
    del data
    launches, walls, peaks = {}, {}, {}
    HOST_DECODED[0] = 0
    with refused(*plain_stages()), \
            recorded(pipeline, "compress_pipeline_streaming",
                     "_module_d_shafa_streaming") as calls, \
            captured((pack, "pack_batch"),
                     (decode, "decode_batch32")) as (args, arm):
        for step, argv, threshold in (
                ("compress", [path, "-b", "M"], pipeline.STREAM_THRESHOLD),
                ("decompress", [path + ".rle.shaf"], TEXT_D_THRESHOLD)):
            if step == "decompress":
                os.remove(path)
            arm(step)
            _build.reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with patched(pipeline, "STREAM_THRESHOLD", threshold):
                run_cli(argv, io.StringIO())
            torch.cuda.synchronize()
            walls[step] = time.perf_counter() - t0
            peaks[step] = torch.cuda.max_memory_allocated()
            for k, n in _build.launches.items():
                launches[k] = launches.get(k, 0) + n
        arm(None)
    (rep,) = calls["compress_pipeline_streaming"] or [None]
    (rep_d,) = calls["_module_d_shafa_streaming"] or [None]
    if rep is None or not rep[0].extra.get("streaming") \
            or not rep[0].extra["compress_rle"]:
        fail("text -b M: the compress did not stream in the R mode")
    if rep_d is None or not rep_d.extra.get("streaming"):
        fail("text -b M: the decompress did not stream")
    if sha256(path) != want:
        fail("text -b M: the round trip is not bit-exact")
    with open(path + ".rle.cod", "rb") as fp:
        _, _, tables = formats.parse_cod_tables(fp.read())
    maxlen = tables.lens.max(axis=1)
    if len(maxlen) != TEXT_STREAM_BLOCKS or not (
            16 < int(maxlen.min()) <= int(maxlen.max()) <= 32):
        fail(f"text -b M: longest codes {maxlen.tolist()}, not 17-32 bits "
             "in every 64 MiB block")
    missing = [k for k in PATH_KERNELS["text_stream"] if launches[k] < 1]
    if missing:
        fail(f"text -b M: {missing} not launched: {launches}")
    if HOST_DECODED[0]:
        fail(f"text -b M: {HOST_DECODED[0]} blocks decoded on the host")
    sizes = {e: os.path.getsize(path + e) for e in RLE_EXTS}
    for f in (path,) + tuple(path + e for e in RLE_EXTS):
        os.remove(f)
    return dict(launches=launches, walls=walls, peaks=peaks, sizes=sizes,
                maxlen=maxlen.tolist(), make_s=make_s, args=args)


def text_kernel_phase(args: dict, dev) -> list[dict]:
    """K1 LUT, K5 and K6 against their plain versions on the arguments the
    text -b M path gave them: K1 LUT on the compress's first pack batch,
    K5 and K6 on the decompress's first decode batch (one 64 MiB block,
    codes of 17-32 bits), each on the whole row."""
    import torch
    from shafa_tpu_torch.kernels import decode, emit

    def on_card(key):
        if key not in args:
            fail(f"text -b M: {key[1]} was not called in the {key[0]} step")
        return [a.to(dev) if isinstance(a, torch.Tensor) else a
                for a in args[key]]

    results = []
    pack_args = on_card(("compress", "pack_batch"))
    r = compare("K1 emit_coded at the text -b M shapes",
                lambda: emit.emit_coded(*pack_args),
                lambda: emit.emit_coded_plain(*pack_args),
                int(pack_args[1].sum()) + nbytes(*pack_args[1:5])
                + 4 * pack_args[5], lambda flat: [flat])
    results.append(dict(name="emit_coded", shape=list(pack_args[0].shape),
                        **r))
    del pack_args
    px, pl, pc32, ls, ncodes, lut, cnt, _ = on_card(("decompress",
                                                     "decode_batch32"))
    k5 = (pc32, ls, ncodes, lut)
    payload = int(pl.sum())
    r = compare("K5 rank32 at the text -b M shapes",
                lambda: decode.rank_planes32(px, pl, *k5),
                lambda: decode.rank_planes32_plain(px, *k5[:3]),
                33 * payload + nbytes(*k5), below_payload(pl))
    results.append(dict(name="rank32", shape=list(px.shape), **r))
    planes = decode.rank_planes32(px, pl, *k5)
    b, p = px.shape
    del px
    r = compare("K6 fsm32 at the text -b M shapes",
                lambda: decode.fsm32_packs(planes, pl, cnt),
                lambda: decode.fsm32_packs_plain(planes, pl, cnt),
                48 * payload + nbytes(pl, cnt) + b, lambda t: list(t))
    results.append(dict(name="fsm32", shape=[b, p], **r))
    del planes
    torch.cuda.empty_cache()
    return results


def decode_stages_path() -> dict:
    """The port of bench_decode_stages.py at its defaults, in process, with
    the launch counts read around it."""
    import torch
    from shafa_tpu_torch import bench_decode_stages
    from shafa_tpu_torch.kernels import _build

    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = bench_decode_stages.main([])
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"bench_decode_stages exited {rc}")
    return dict(launches=path_launches("decode_stages"), wall_s=wall)


def path_launches(name: str) -> dict:
    """The launch counts since the last reset; fail unless every kernel of
    path name launched."""
    from shafa_tpu_torch.kernels import _build
    launches = dict(_build.launches)
    missing = [k for k in PATH_KERNELS[name] if launches[k] < 1]
    if missing:
        fail(f"{name}: {missing} not launched: {launches}")
    return launches


def bench_path(card: str) -> dict:
    """The port of bench.py in process at its defaults (100 MB encode,
    64 MB decode, 16 MB round trip, the streaming compress of the 100 MB),
    but a budget of BENCH_BUDGET_S and scaling off. A byte that differs,
    a section that ran out of time or a key of BENCH_KEYS missing from its
    last line fails."""
    import torch
    from shafa_tpu_torch import bench
    from shafa_tpu_torch.kernels import _build

    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        report = bench.run(bench.Settings.from_env(budget=BENCH_BUDGET_S,
                                                   scaling=False))
    except bench.Mismatch as e:
        fail(f"bench: {e}")
    wall = time.perf_counter() - t0
    if report.timed_out:
        fail(f"bench: {report.timed_out} ran out of time")
    missing = [k for k in BENCH_KEYS if k not in report.line]
    if missing or report.line["roundtrip_bit_exact"] is not True:
        fail(f"bench: its line lacks {missing}: {report.line}")
    print(f"bench line on {card}: {json.dumps(report.line)}", flush=True)
    return dict(launches=path_launches("bench"), wall_s=wall,
                line=report.line)


def bench_stages_path() -> dict:
    """The port of bench_stages.py in process at its defaults (64 MiB in
    8 MiB blocks); it prints each stage with its bytes bound."""
    import torch
    from shafa_tpu_torch import bench_stages
    from shafa_tpu_torch.kernels import _build

    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = bench_stages.main([])
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"bench_stages exited {rc}")
    return dict(launches=path_launches("bench_stages"), wall_s=wall)


def bench_scaling_path(counts, card: str) -> dict:
    """The port of bench_scaling.py's parent in process on SCALING_BYTES in
    8 MiB blocks at each of the device counts given that has its cards;
    its rows' bytes must be equal and the first row's the oracle's. D=1
    must run."""
    import torch
    from shafa_tpu_torch import bench, bench_scaling
    from shafa_tpu_torch.kernels import _build

    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = bench_scaling.parent(counts, size=SCALING_BYTES, block=BLOCK)
    except bench.Mismatch as e:
        fail(f"bench_scaling: {e}")
    wall = time.perf_counter() - t0
    if not out["runs"] or out["runs"][0]["devices"] != 1:
        fail(f"bench_scaling: D=1 did not run: {out}")
    print(f"bench_scaling on {card} ({wall:.1f} s with its oracle check): "
          f"{json.dumps(out)}", flush=True)
    return dict(launches=path_launches("bench_scaling"), out=out,
                wall_s=wall)


def sidecar_phase(work: str) -> None:
    """Port's -b K sidecars == the NumPy backend's (--backend numpy)."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import corpus
    for name, data, exts in (
            ("mixed", corpus.mixed(SIDECAR_BYTES, seed=SEED),
             (".rle", ".rle.freq", ".rle.cod", ".rle.shaf")),
            ("random", corpus.incompressible(SIDECAR_BYTES, seed=SEED),
             (".freq", ".cod", ".shaf"))):
        port = os.path.join(work, f"{name}_port.bin")
        ref = os.path.join(work, f"{name}_ref.bin")
        for p in (port, ref):
            with open(p, "wb") as fp:
                fp.write(data)
        run_cli([port, "-b", "K"], io.StringIO())
        run_cli([ref, "-b", "K", "--backend", "numpy"], io.StringIO())
        for ext in exts:
            with open(port + ext, "rb") as a, open(ref + ext, "rb") as b:
                if a.read() != b.read():
                    fail(f"{name}: {ext} differs from the NumPy backend's")
        os.rename(port, port + ".orig")
        run_cli([port + exts[-1]], io.StringIO())
        with open(port, "rb") as fp:
            if fp.read() != data:
                fail(f"{name}: -b K round trip is not bit-exact")
        print(f"sidecars {name} 16 MB -b K: {', '.join(exts)} identical to "
              "the NumPy backend; round trip bit-exact", flush=True)


def foreign_modules() -> list[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("shafa_tpu", "jax", "jaxlib"))


def device_line() -> str:
    import torch
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


def scale_out_only(dev, card: str) -> int:
    """``chip_smoke.py --scale-out``: the one-process 200 MB mixed round
    trip and the scale-out phases alone, for a host with several cards."""
    from shafa_tpu_torch.profile_main_path import synthetic
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    runs = {}
    try:
        data = synthetic(CORPUS_BYTES, SEED)
        main_path(work, "mixed", data)  # warm-up: the card's first work
        res = runs["mixed"] = main_path(work, "mixed", data)
        print(f"main path mixed 200 MB -b m on {card}: compress "
              f"{res['compress_s']:.3f} s, decompress "
              f"{res['decompress_s']:.3f} s, bit-exact", flush=True)
        scale_out(work, data, runs, dev, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    bench_scaling_path((1, 2, 4), card)
    if foreign_modules():
        fail(f"imported: {foreign_modules()}")
    print(device_line(), flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--scale-out"]):
        fail(f"unknown arguments {argv}: none, or --scale-out")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from shafa_tpu_torch.kernels import _build
    except ImportError as e:
        fail(f"the repository is not beside this script ({e})")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave no answer"
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s, one process per source)",
          flush=True)
    for label, prefix in (("K1", "emit_tiles"), ("K2", "rank_lut"),
                          ("K3 and K7 (passes A and B shared; last pass "
                           "<0> K3's, <1> K7's)", "fsm16_"),
                          ("K4", "expand_"), ("K5", "rank32_"),
                          ("K6", "fsm32_"),
                          ("K8 (one pass)", "rle_enc_"),
                          ("K9", "decode_tables")):
        res = _build.resources(prefix)
        if not res:
            fail(f"no ptxas report of {label}'s kernels")
        print(f"{label} registers and spills (nvcc -Xptxas -v): " + "; ".join(
            f"{name} {regs} registers, {st} B spill stores, {ld} B spill "
            "loads" for name, (regs, st, ld) in sorted(res.items())),
            flush=True)

    dev = torch.device("cuda", 0)
    if argv:
        return scale_out_only(dev, card)
    from shafa_tpu_torch import bench_scaling
    from shafa_tpu_torch.profile_main_path import (synthetic,
                                                   text_with_rare_bytes)
    corpora = {"mixed": synthetic(CORPUS_BYTES, SEED),
               "text": text_with_rare_bytes(CORPUS_BYTES)}
    kernels = kernel_phase(corpora["mixed"], dev)
    kernels += kernel32_phase(corpora["text"], dev)
    for k in kernels:
        lib = "" if k["library_ms"] is None else \
            f", library {k['library_ms']:.3f} ms"
        memset = f" (its output's memset alone {k['memset_ms']:.3f} ms)" \
            if "memset_ms" in k else ""
        print(f"{k['name']}: shape {k['shape']} kernel {k['ms']:.3f} ms"
              f"{memset}, plain {k['plain_ms']:.3f} ms, bound "
              f"{k['bound_ms']:.3f} ms{lib}, exact", flush=True)
    fault_phase(dev)
    edge_phase(dev)
    k1_k5_edge_phase(dev)
    k4_edge_phase(dev)
    k8_edge_phase(dev)
    torch.cuda.empty_cache()

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    runs = {}
    try:
        for name, data in corpora.items():
            res = runs[name] = main_path(work, name, data)
            mb = CORPUS_BYTES / 1e6
            print(f"main path {name} 200 MB -b m on {card}: compress "
                  f"{mb / res['compress_s']:.1f} MB/s "
                  f"({res['compress_s']:.3f} s), decompress "
                  f"{mb / res['decompress_s']:.1f} MB/s "
                  f"({res['decompress_s']:.3f} s), ratio "
                  f"{res['shaf_bytes'] / CORPUS_BYTES:.4f}, "
                  f"{res['blocks']} blocks with longest codes of "
                  f"{res['maxlen'][0]}-{res['maxlen'][1]} bits, round trip "
                  f"bit-exact, launches {res['launches']}, host-decoded "
                  "blocks 0, R mode; rle.token_starts, "
                  "decode.interleave_packs, rle.rle_payloads, "
                  "rle._rle_analyze and histogram.histogram_batch never ran",
                  flush=True)
        if not 16 < runs["text"]["maxlen"][0] <= runs["text"]["maxlen"][1] \
                <= 32:
            fail(f"text: longest codes {runs['text']['maxlen']}, not all "
                 "17-32 bits")
        scale_out(work, corpora["mixed"], runs, dev, card)
        runs["check"] = check_path(work, corpora)
        res = runs["profile"] = profile_path(work, corpora["mixed"])
        pw = res["plain_walls"]
        print(f"--profile on {card}: mixed {PROFILE_BYTES} bytes -b m "
              f"compress {res['walls']['compress']:.3f} s, decompress "
              f"{res['walls']['decompress']:.3f} s under torch.profiler "
              f"(unprofiled, just before: {pw['compress']:.3f} s, "
              f"{pw['decompress']:.3f} s); "
              f"sidecars equal to an unprofiled run's, bit-exact; "
              f"{res['traces']} traces ({res['trace_bytes']} bytes) naming "
              f"{res['kernel_names']} kernels, K1-K4's and K8's among them "
              f"({', '.join(TRACE_KERNELS.values())}); launches "
              f"{res['launches']}", flush=True)
        del corpora, data
        res = runs["streaming"] = streaming_path(work)
        mb = STREAM_BYTES / 1e6
        w, pk = res["walls"], res["peaks"]
        print(f"streaming 1 GiB -b M on {card}: {res['blocks']} blocks, "
              f"compress {mb / w['compress']:.1f} MB/s "
              f"({w['compress']:.3f} s; resident compress of the same file "
              f"{w['resident']:.3f} s), decompress "
              f"{mb / w['decompress']:.1f} MB/s ({w['decompress']:.3f} s), "
              f"RLE-only decode of the {res['sizes']['.rle']}-byte .rle "
              f"{mb / w['rle_decode']:.1f} MB/s ({w['rle_decode']:.3f} s), "
              f".rle.shaf {res['sizes']['.rle.shaf']} bytes; device peak "
              f"(max_memory_allocated) compress {pk['compress']} B, "
              f"decompress {pk['decompress']} B, RLE-only decode "
              f"{pk['rle_decode']} B, resident compress {pk['resident']} B; "
              "F, C and D streamed, sidecars equal to the resident "
              "compress's, both decodes bit-exact, launches "
              f"{res['launches']}, host-decoded blocks 0, no plain stage "
              "ran", flush=True)
        for k in stream_kernel_phase(res.pop("args"), dev):
            step = f", {k['step']}" if "step" in k else ""
            print(f"{k['name']} at the streaming shapes{step}: shape "
                  f"{k['shape']} kernel {k['ms']:.3f} ms, plain "
                  f"{k['plain_ms']:.3f} ms, bound {k['bound_ms']:.3f} ms, "
                  "exact", flush=True)
        res = runs["text_stream"] = text_stream_path(work)
        mb = TEXT_STREAM_BYTES / 1e6
        w, pk = res["walls"], res["peaks"]
        print(f"text -b M, {TEXT_STREAM_BYTES} bytes (built in "
              f"{res['make_s']:.1f} s) on {card}: "
              f"{len(res['maxlen'])} blocks of 64 MiB with longest codes of "
              f"{res['maxlen']} bits, compress {mb / w['compress']:.1f} MB/s "
              f"({w['compress']:.3f} s), decompress "
              f"{mb / w['decompress']:.1f} MB/s ({w['decompress']:.3f} s), "
              f".rle.shaf {res['sizes']['.rle.shaf']} bytes; device peak "
              f"(max_memory_allocated) compress {pk['compress']} B, "
              f"decompress {pk['decompress']} B; F, C and D streamed, "
              "bit-exact, every block on K5 -> K6 -> K1, host-decoded "
              f"blocks 0, launches {res['launches']}", flush=True)
        for k in text_kernel_phase(res.pop("args"), dev):
            print(f"{k['name']} at the text -b M shapes: shape {k['shape']} "
                  f"kernel {k['ms']:.3f} ms, plain {k['plain_ms']:.3f} ms, "
                  f"bound {k['bound_ms']:.3f} ms, exact", flush=True)
        res = runs["decode_stages"] = decode_stages_path()
        print(f"decode_stages path (bench_decode_stages.main at its "
              f"defaults) on {card}: {res['wall_s']:.1f} s, its checks "
              f"passed, launches {res['launches']}", flush=True)
        res = runs["bench"] = bench_path(card)
        print(f"bench path (bench.run at its defaults, budget "
              f"{BENCH_BUDGET_S:.0f} s, scaling off) on {card}: "
              f"{res['wall_s']:.1f} s, bit-exact, launches "
              f"{res['launches']}", flush=True)
        res = runs["bench_stages"] = bench_stages_path()
        print(f"bench_stages path (bench_stages.main at its defaults) on "
              f"{card}: {res['wall_s']:.1f} s, its check passed, launches "
              f"{res['launches']}", flush=True)
        res = runs["bench_scaling"] = bench_scaling_path(
            bench_scaling.DEVICE_COUNTS, card)
        ran = [r["devices"] for r in res["out"]["runs"]]
        print(f"bench_scaling path ({SCALING_BYTES} bytes in 8 MiB blocks, "
              f"D = {ran}, skipped {res['out']['skipped']}) on {card}: RLE "
              "streams and payloads equal the oracle's in every row, "
              f"launches {res['launches']}", flush=True)
        sidecar_phase(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if foreign_modules():
        fail(f"imported: {foreign_modules()}")
    print("no module of shafa_tpu and no jax imported", flush=True)

    record = []
    for k in kernels:
        source, replaces = SOURCES[k["name"]]
        record.append(dict(
            name=k["name"], route="cuda", source=source, replaces=replaces,
            launches=sum(r["launches"][k["name"]] for r in runs.values()),
            launches_by_path={path: r["launches"][k["name"]]
                              for path, r in runs.items()},
            **{key: k[key] for key in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")}))
    print(json.dumps({"kernels": record}), flush=True)
    print(device_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
