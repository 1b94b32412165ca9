"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA card.

    python3 chip_smoke.py        (from the repository root, one CUDA card)

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. the build of the CUDA kernels from shafa_tpu_torch/kernels/csrc/, and
     K2's, K3's and K6's registers and spills per kernel as ``nvcc -Xptxas
     -v`` gave them;
  3. every kernel of the paths against its plain PyTorch version on the
     card, on the paths' shapes, exact equality, both timed with CUDA
     events: K1-K4 and K7 on the 200 MB mixed corpus's batches (K7 on the
     planes K3 takes; then K2 -> K7 -> K1 must give K3's rows), K5 and K6
     (its interleaved (B, 2P) vals and lens and its underrun flags) on the
     (4, 8 MiB) decode batch of the 200 MB text corpus; beside each,
     the least time the card could take (bytes over 3.35 TB/s) and, for
     K4, torch.repeat_interleave, the one PyTorch call that computes the
     same;
  4. K5 and the whole 17-32-bit decode chain on a hand-built complete table
     with codes of 26-32 bits against the NumPy oracle (the case of the JAX
     kernel's window fault); K2 once and K3 20 times, at 8 and 16 states,
     against their plain versions on rows at the edges of K3's look-back
     and output words (a full row cut by its count, a row that ends on a
     tile boundary and underruns past the row width, 123,457 bytes, 1
     byte);
  5. two main paths through ``shafa_tpu_torch.cli.main([path, "-b", "m"])``
     and back from their .rle.shaf, each bit-exact, with the launch counts
     set to 0 before and read after: the 200,000,000-byte mixed corpus
     (codes of at most 16 bits: K1-K4) and the 200,000,000-byte text corpus
     with rare bytes (every block with codes of 17-32 bits: K1, K5, K6,
     K4); no block decoded on the host on either;
  6. the decode-stage path: ``shafa_tpu_torch.bench_decode_stages.main``
     at its defaults (64 MiB of the synthetic corpus in 8 MiB blocks; K2,
     K7, K1, K3, K4 and its own checks), launch counts read around it;
  7. the sidecars of a 16 MB mixed and a 16 MB random file at -b K against
     the same CLI with ``--backend numpy``; no module of shafa_tpu and no
     jax imported in the whole run.

The line before the last holds the kernels' JSON record (``launches`` sums
the three paths' counts, ``launches_by_path`` keeps each); the last line is
the device JSON line. Without a CUDA card, or without the repository beside
it, the script exits 1 and prints no result.
"""

from __future__ import annotations

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

CORPUS_BYTES = 200_000_000
SIDECAR_BYTES = 16_000_000
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
}

#: Kernels each main path must launch.
PATH_KERNELS = {
    "mixed": ("emit_bits", "emit_coded", "rank", "fsm_decode", "expand"),
    "text": ("emit_bits", "emit_coded", "rank32", "fsm32", "expand"),
    "decode_stages": ("fsm_packs", "rank", "fsm_decode", "expand",
                      "emit_bits"),
}


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
    err = max(int((g - w).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    if any(g.shape != w.shape for g, w in zip(got, want)) or err:
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
    card: RLE (K1), histograms, code tables, the pack (K1's LUT variant).
    Returns (x, lengths, K1 inputs, RLE streams, their lengths, tables,
    payloads, the pack's arguments)."""
    import torch
    from shafa_tpu_torch import codes as codes_mod
    from shafa_tpu_torch.device import _stack_blocks, tables_to_device
    from shafa_tpu_torch.kernels import emit, histogram, pack, rle

    blocks = [np.frombuffer(data, np.uint8, BLOCK, i * BLOCK)
              for i in range(rows)]
    stacked, lens = _stack_blocks(blocks)
    x = torch.from_numpy(stacked).to(dev)
    ld = torch.from_numpy(lens).to(dev)
    enc, enc_len = rle.rle_encode_batch(x, ld)
    hist = histogram.histogram_batch(enc, enc_len).cpu().numpy()
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


def kernel_phase(data: bytes, dev) -> list[dict]:
    """K1-K4 and K7 against their plain versions on the main path's shapes:
    one (8, 8 MiB) batch of the corpus for K1, and the (4, 8 MiB) decode
    batch that the main path builds from its payloads for K2-K4 and K7."""
    import torch
    from shafa_tpu_torch import codes as codes_mod
    from shafa_tpu_torch.device import (_bucket, _stack_blocks,
                                        tables_to_device)
    from shafa_tpu_torch.kernels import decode, emit, expand, rle

    x, ld, enc, enc_len, tables, payloads, pack_args = encode_on_card(
        data, dev, 8)
    results = []
    val, bitlen, _ = rle.rle_payloads(x, ld)
    stride = rle.rle_out_bound(BLOCK) // 4
    r = compare("K1 emit_bits",
                lambda: emit.emit_bits_rows(val, bitlen, ld, stride),
                lambda: emit.emit_bits_rows_plain(val, bitlen, ld, stride),
                8 * int(ld.sum()) + nbytes(ld) + int(enc_len.sum()),
                lambda rows_: [rows_[i, :int(n)] for i, n in
                               enumerate(enc_len.tolist())])
    results.append(dict(name="emit_bits", shape=list(val.shape), **r))
    del val, bitlen

    r = compare("K1 emit_coded", lambda: emit.emit_coded(*pack_args),
                lambda: emit.emit_coded_plain(*pack_args),
                int(enc_len.sum()) + nbytes(*pack_args[1:5])
                + 4 * pack_args[5], lambda flat: [flat])
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
    prep = expand.rle_expand_prep(dec, cnt)
    total = int(prep["out_len"].sum())
    if total != drows * BLOCK:
        fail(f"K4 prep: {total} expanded bytes, expected {drows * BLOCK}")
    args = (prep["cum"], prep["sym"], prep["out_base"], total)
    r = compare("K4 expand",
                lambda: expand.expand_tokens(*args),
                lambda: expand.expand_tokens_plain(*args),
                9 * int(cnt.sum()) + nbytes(args[2]) + total,
                lambda t: [t])
    out = expand.expand_tokens(*args)
    if out.cpu().numpy().tobytes() != data[:drows * BLOCK]:
        fail("K1 -> K4 chain does not reproduce the corpus")
    # the library call for the same expansion: per-token counts in
    # (computed beforehand), the same back-to-back bytes out
    cnt_flat = torch.diff(prep["cum"], dim=1,
                          prepend=torch.zeros_like(prep["cum"][:, :1]))
    cnt_flat = cnt_flat.reshape(-1)
    sym_flat = prep["sym"].reshape(-1)
    lib = torch.repeat_interleave(sym_flat, cnt_flat, output_size=total)
    if not torch.equal(lib, out):
        fail("torch.repeat_interleave disagrees with K4")
    del lib, out
    r["library_ms"] = timed_ms(
        lambda: torch.repeat_interleave(sym_flat, cnt_flat,
                                        output_size=total), 5)
    results.append(dict(name="expand", shape=list(prep["cum"].shape), **r))
    return results


def kernel32_phase(text: bytes, dev) -> list[dict]:
    """K5 and K6 against their plain versions on the 17-32-bit path's
    decode batch: the payloads of the text corpus's first 4 blocks, as the
    main path packs them, in one (4, 8 MiB) batch."""
    import torch
    from shafa_tpu_torch.device import _bucket, _stack_blocks
    from shafa_tpu_torch.kernels import decode

    drows = 4
    _, _, enc, enc_len, tables, payloads, _ = encode_on_card(text, dev,
                                                             drows)
    maxlen = int(tables.lens.max())
    if not 16 < maxlen <= 32:
        fail(f"the text corpus's first blocks have codes of {maxlen} bits")
    pst, plens = _stack_blocks(payloads, minimum=1024)
    payload = int(plens.sum())
    counts_np = enc_len.cpu().numpy().astype(np.int32)
    pc32, ls, ncodes = (torch.from_numpy(a).to(dev) for a in
                        decode.rank_tables32(decode.decode_tables_batch(
                            tables.lens, tables.vals)))
    w32 = decode.windows32_bytes(torch.from_numpy(pst).to(dev))
    results = []
    r = compare("K5 rank32",
                lambda: decode.rank_planes32(w32, pc32, ls, ncodes),
                lambda: decode.rank_planes32_plain(w32, pc32, ls, ncodes),
                36 * payload + nbytes(pc32, ls, ncodes),
                lambda t: [t])
    results.append(dict(name="rank32", shape=list(w32.shape), **r))
    planes = decode.rank_planes32(w32, pc32, ls, ncodes)
    pl = torch.from_numpy(plens).to(dev)
    cnt = torch.from_numpy(counts_np).to(dev)
    r = compare("K6 fsm32",
                lambda: decode.fsm32_packs(planes, pl, cnt),
                lambda: decode.fsm32_packs_plain(planes, pl, cnt),
                48 * payload + nbytes(pl, cnt) + drows, lambda t: list(t))
    results.append(dict(name="fsm32", shape=[drows, pst.shape[1]], **r))
    dec, under = decode.decode_batch32(
        torch.from_numpy(pst).to(dev), pl, pc32, ls, ncodes, cnt,
        _bucket(int(counts_np.max())))
    if bool(under.any()):
        fail("K6 flagged underrun on the text corpus")
    for i, n in enumerate(counts_np):
        if not torch.equal(dec[i, :n], enc[i, :n]):
            fail(f"K5 -> K6 -> K1 does not give row {i}'s RLE stream")
    print(f"text corpus decode batch: codes up to {maxlen} bits, "
          f"{int((tables.lens > 16).sum(axis=1).max())} symbols of a row "
          "over 16 bits", flush=True)
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
    pc32, ls, ncodes = (torch.from_numpy(a).to(dev) for a in
                        decode.rank_tables32(decode.decode_tables_batch(
                            tables.lens, tables.vals)))
    x = torch.from_numpy(st).to(dev)
    w32 = decode.windows32_bytes(x)
    if not torch.equal(decode.rank_planes32(w32, pc32, ls, ncodes),
                       decode.rank_planes32_plain(w32, pc32, ls, ncodes)):
        fail("K5 differs from its plain version on 26-32-bit codes")
    dec, under = decode.decode_batch32(
        x, torch.from_numpy(plens).to(dev), pc32, ls, ncodes,
        torch.tensor([blk.size], dtype=torch.int32, device=dev),
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
    """K2 once and K3 20 times against their plain versions on a (4, 4
    MiB) batch of random payload bytes under a complete code (1-16 bits at
    16 states, all 8 bits at 8): a full row cut by its count inside a tile,
    a row that ends on a tile boundary and underruns (its symbols pass the
    row width, where K3 drops them), a row of 123,457 bytes, a row of 1
    byte. A look-back that reads a neighbour's count too early, or an edge
    word two tiles share, shows only in some runs."""
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
        del planes, want, got
        torch.cuda.empty_cache()
    print("edge rows (4, 4 MiB): K2 exact vs plain, K3 exact vs plain in 20 "
          "runs each at 8 and 16 states", flush=True)


def run_cli(argv: list[str], log) -> None:
    from shafa_tpu_torch import cli
    with contextlib.redirect_stdout(log):
        rc = cli.main(argv)
    if rc != 0:
        fail(f"shafa_tpu_torch {' '.join(argv)} exited {rc}")


def main_path(work: str, name: str, data: bytes) -> dict:
    """A round trip at -b m through the CLI entry point, with the launch
    counts read around it."""
    import torch
    from shafa_tpu_torch import formats
    from shafa_tpu_torch.device import TorchBackend
    from shafa_tpu_torch.kernels import _build

    path = os.path.join(work, f"{name}.bin")
    with open(path, "wb") as fp:
        fp.write(data)
    log = io.StringIO()
    _build.reset_launches()
    TorchBackend.host_decoded_blocks = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_cli([path, "-b", "m"], log)
    t1 = time.perf_counter()
    if not os.path.isfile(path + ".rle.shaf"):
        fail(f"{name}: compress did not take the R mode (.rle.shaf missing)")
    os.rename(path, path + ".orig")
    t2 = time.perf_counter()
    run_cli([path + ".rle.shaf"], log)
    t3 = time.perf_counter()
    launches = dict(_build.launches)
    with open(path, "rb") as fp:
        if fp.read() != data:
            fail(f"{name}: the 200 MB round trip is not bit-exact")
    missing = [k for k in PATH_KERNELS[name] if launches[k] < 1]
    if missing:
        fail(f"{name}: {missing} not launched on the main path: {launches}")
    if TorchBackend.host_decoded_blocks:
        fail(f"{name}: {TorchBackend.host_decoded_blocks} blocks decoded on "
             "the host")
    with open(path + ".rle.cod", "rb") as fp:
        _, _, tables = formats.parse_cod_tables(fp.read())
    maxlen = tables.lens.max(axis=1)
    for f in (path, path + ".orig", path + ".rle"):
        os.remove(f)
    return dict(launches=launches, compress_s=t1 - t0, decompress_s=t3 - t2,
                shaf_bytes=os.path.getsize(path + ".rle.shaf"),
                blocks=len(maxlen), maxlen=(int(maxlen.min()),
                                            int(maxlen.max())))


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
    launches = dict(_build.launches)
    if rc != 0:
        fail(f"bench_decode_stages exited {rc}")
    missing = [k for k in PATH_KERNELS["decode_stages"] if launches[k] < 1]
    if missing:
        fail(f"decode_stages: {missing} not launched: {launches}")
    return dict(launches=launches, wall_s=wall)


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


def main() -> int:
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
    for label, prefix in (("K2", "rank_lut"), ("K3", "fsm16_"),
                          ("K6", "fsm32_")):
        res = _build.resources(prefix)
        if not res:
            fail(f"no ptxas report of {label}'s kernels")
        print(f"{label} registers and spills (nvcc -Xptxas -v): " + "; ".join(
            f"{name} {regs} registers, {st} B spill stores, {ld} B spill "
            "loads" for name, (regs, st, ld) in sorted(res.items())),
            flush=True)

    from shafa_tpu_torch.profile_main_path import (synthetic,
                                                   text_with_rare_bytes)
    dev = torch.device("cuda", 0)
    corpora = {"mixed": synthetic(CORPUS_BYTES, SEED),
               "text": text_with_rare_bytes(CORPUS_BYTES)}
    kernels = kernel_phase(corpora["mixed"], dev)
    kernels += kernel32_phase(corpora["text"], dev)
    for k in kernels:
        lib = "" if k["library_ms"] is None else \
            f", library {k['library_ms']:.3f} ms"
        print(f"{k['name']}: shape {k['shape']} kernel {k['ms']:.3f} ms, "
              f"plain {k['plain_ms']:.3f} ms, bound {k['bound_ms']:.3f} ms"
              f"{lib}, exact", flush=True)
    fault_phase(dev)
    edge_phase(dev)
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
                  "blocks 0", flush=True)
        if not 16 < runs["text"]["maxlen"][0] <= runs["text"]["maxlen"][1] \
                <= 32:
            fail(f"text: longest codes {runs['text']['maxlen']}, not all "
                 "17-32 bits")
        del corpora
        res = runs["decode_stages"] = decode_stages_path()
        print(f"decode_stages path (bench_decode_stages.main at its "
              f"defaults) on {card}: {res['wall_s']:.1f} s, its checks "
              f"passed, launches {res['launches']}", flush=True)
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
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
