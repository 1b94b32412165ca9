"""K9, a decode batch's tables built on the card
(``kernels/decode.decode_tables_on_device``, ``csrc/decode_tables.cu``),
held to the host builders (``decode_tables_batch`` -> ``rank_tables(32)``
-> ``rank_lut12(_32)``) bit for bit.

On the CPU: the wrapper's plain version against the host builders and,
through K2's and K5's plain versions, against the payloads it decodes; a
NumPy emulation of the kernel's own steps (ranks by key compares, the
branch-free upper bounds, the entry formula, one table on the u32 codes
for both routes) against the host builders on every case; and the
backend's decode of a 17-20-bit block set with the counter
``decode_table_rows_on_device`` at 0. Marked ``gpu`` (skipped without a
card, decided in the ``cuda`` fixture): the kernel against the host
builders at batches of 1 and 64 rows, and a backend round trip whose
counter must equal ``decode_blocks16 + decode_blocks32``. On the card:
``python -m pytest tests/test_torch_decode_tables.py``.
"""

import os

import numpy as np
import pytest
import torch

from shafa_tpu_torch import codes as codes_mod, oracle, pipeline, tracing
from shafa_tpu_torch.device import (TorchBackend, _bucket, _code_hi32,
                                    _stack_blocks)
from shafa_tpu_torch.kernels import _build, decode
from shafa_tpu_torch.profile_main_path import synthetic, text_with_rare_bytes


def _canonical(lens_list):
    """CodeTables row of a complete canonical code with these
    non-decreasing lengths (symbol s gets lens_list[s])."""
    lens = np.zeros((1, 256), np.uint8)
    vals = np.zeros((1, 256), np.uint64)
    code = prev = 0
    for s, ln in enumerate(lens_list):
        code <<= ln - prev
        lens[0, s] = ln
        vals[0, s] = np.uint64(code) << np.uint64(64 - ln)
        code += 1
        prev = ln
    return codes_mod.CodeTables(lens, vals)


def _of(data: bytes):
    return codes_mod.build_code_tables(oracle.histogram(data)[None])


#: name -> CodeTables of one row
CASES = {
    # one code: the code "0" of a one-symbol block
    "one_code": lambda: _of(b"A" * 9),
    # 256 codes of 8 bits
    "all_8bit": lambda: _of(bytes(range(256)) * 4),
    "exactly_16": lambda: _canonical(list(range(1, 16)) + [16, 16]),
    "exactly_17": lambda: _canonical(list(range(1, 17)) + [17, 17]),
    "exactly_32": lambda: _canonical(list(range(1, 32)) + [32, 32]),
    # 244 codes of 19-20 bits under the 12-bit prefix 0xFFF: 256 codes, a
    # range entry of depth 8
    "one_prefix_depth_8": lambda: _canonical(list(range(1, 13)) + [19] * 12
                                             + [20] * 232),
    # 32 codes of 16 bits under 0xFFE and 0xFFF: range entries of depth 4
    "one_prefix_16": lambda: _canonical(list(range(1, 12)) + [16] * 32),
    "text": lambda: _of(text_with_rare_bytes(1 << 20)),
    "mixed": lambda: _of(synthetic(1 << 20, 3)),
}


#: the cases whose codes have at most 16 bits, which both routes take
NARROW = ("one_code", "all_8bit", "exactly_16", "one_prefix_16", "mixed")
ROUTES = [(name, wide) for name in CASES for wide in (False, True)
          if wide or name in NARROW]


def test_narrow_cases_have_codes_of_at_most_16_bits():
    assert [name for name, make in CASES.items()
            if int(make().lens.max()) <= 16] == list(NARROW)


def _rows(name: str, n: int) -> codes_mod.CodeTables:
    """n rows: the case's table, then copies with their symbols permuted
    (the same codes, other ranks' symbols) by seeded permutations."""
    one = CASES[name]()
    rng = np.random.default_rng(n)
    perms = [np.arange(256)] + [rng.permutation(256) for _ in range(n - 1)]
    return codes_mod.CodeTables(
        np.concatenate([one.lens[:, p] for p in perms]),
        np.concatenate([one.vals[:, p] for p in perms]))


def _inputs(tables):
    return (torch.from_numpy(np.ascontiguousarray(tables.lens)),
            torch.from_numpy(_code_hi32(tables)))


def _host(tables, wide: bool):
    """The host builders' tables, as the backend took them before K9."""
    tab = decode.decode_tables_batch(tables.lens, tables.vals)
    if wide:
        pc32, ls, ncodes = decode.rank_tables32(tab)
        return pc32, ls, ncodes, decode.rank_lut12_32(pc32, ls, ncodes)
    pc16, ls = decode.rank_tables(tab)
    return pc16, ls, decode.rank_lut12(pc16, ls)


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _upper_bound(s_pc, nc, w):
    """csrc/decode_tables.cu::upper_bound for every window of w (n, m) at
    once: how many of each row's sorted codes lie at or below it."""
    c = np.zeros(w.shape, np.int64)
    for step in (256, 128, 64, 32, 16, 8, 4, 2, 1):
        idx = np.clip(c + step - 1, 0, 255)
        at = np.take_along_axis(s_pc, idx, axis=1)
        c += np.where((c + step <= nc[:, None]) & (at <= w), step, 0)
    return c


def _k9_emulated(lens: np.ndarray, hi32: np.ndarray, wide: bool):
    """The kernel's steps in NumPy, row by row as its blocks take them."""
    n = lens.shape[0]
    code = hi32.view(np.uint32).astype(np.int64)
    sym = np.arange(256)
    present = lens > 0
    key = np.where(present, (code << 8) | sym, np.iinfo(np.int64).max)
    nc = present.sum(1)
    s_pc = np.zeros((n, 256), np.int64)
    s_ls = np.zeros((n, 256), np.int64)
    for r in range(n):
        rank = (key[r][None, :] < key[r][:, None]).sum(1)
        s_pc[r, rank[present[r]]] = code[r, present[r]]
        s_ls[r, rank[present[r]]] = (sym | (lens[r].astype(np.int64) << 8))[
            present[r]]
    inside = sym[None, :] < nc[:, None]
    if wide:
        pc = np.where(inside, s_pc, 0).astype(np.uint32).view(np.int32)
    else:
        pc = np.where(inside, s_pc >> 16, decode.NO_CODE).astype(np.int32)
    ls = np.where(inside, s_ls, 0).astype(np.int32)
    first = np.broadcast_to(np.arange(4096, dtype=np.int64) << 20, (n, 4096))
    r_lo = _upper_bound(s_pc, nc, first) - 1
    r_hi = _upper_bound(s_pc, nc, first | 0xFFFFF) - 1
    lo = np.maximum(r_lo, 0)
    depth = np.array([int(d).bit_length() for d in (r_hi - lo).ravel()]
                     ).reshape(r_hi.shape)
    one = np.where(r_hi >= 0,
                   np.take_along_axis(s_ls, np.maximum(r_hi, 0), axis=1), 0)
    ent = np.where(r_lo == r_hi, one, decode.LUT_RANGE | (depth << 8) | lo)
    lut = ent.astype(np.uint16).view(np.int16)
    if wide:
        return pc, ls, nc.astype(np.int32), lut
    return pc, ls, lut


@pytest.mark.parametrize("name,wide", ROUTES)
def test_plain_version_is_the_host_builders(name, wide):
    tables = _rows(name, 3)
    _assert_same(decode.decode_tables_on_device(*_inputs(tables), wide),
                 _host(tables, wide))


@pytest.mark.parametrize("name,wide", ROUTES)
def test_kernel_steps_emulated_give_the_host_builders(name, wide):
    tables = _rows(name, 3)
    lens, hi32 = (t.numpy() for t in _inputs(tables))
    _assert_same(_k9_emulated(lens, hi32, wide), _host(tables, wide))


def test_depth_8_range_entry_is_built():
    """The one-prefix case does reach a range entry of depth 8 (entry
    0xFFF: 244 codes), so the emulation was held to one."""
    lut = _host(_rows("one_prefix_depth_8", 1), True)[3]
    e = int(lut[0, 0xFFF]) & 0xFFFF
    assert e & decode.LUT_RANGE and (e >> 8) & 15 == 8


def _packed(name: str, n_blocks: int, rng):
    """Blocks drawn from the case's symbols, their tables and payloads."""
    tables = _rows(name, n_blocks)
    blocks, payloads = [], []
    for i in range(n_blocks):
        syms = np.flatnonzero(tables.lens[i])
        blk = rng.choice(syms, 3000 + 1000 * i).astype(np.uint8)
        blocks.append(blk)
        payloads.append(oracle.pack(blk, tables.lens[i], tables.vals[i]))
    return tables, blocks, payloads


@pytest.mark.parametrize("name,wide", [r for r in ROUTES
                                       if r[0] != "one_code"])
def test_plain_tables_decode_through_k2_and_k5_plain(name, wide):
    """The wrapper's tables (plain version) on the CPU, through K2 -> K3's
    or K5 -> K6 -> K1's plain versions, give back the packed blocks."""
    rng = np.random.default_rng(len(name))
    tables, blocks, payloads = _packed(name, 2, rng)
    tabs = decode.decode_tables_on_device(*_inputs(tables), wide)
    st, plens = _stack_blocks([np.frombuffer(p, np.uint8) for p in payloads],
                              minimum=1024)
    counts = np.array([b.size for b in blocks], np.int32)
    args = [torch.from_numpy(a) for a in (st, plens)]
    out_p = _bucket(int(counts.max()))
    if wide:
        rows, under = decode.decode_batch32(*args, *tabs,
                                            torch.from_numpy(counts), out_p)
    else:
        s_states = 8 if int(tables.lens.max()) <= 8 else 16
        rows, under = decode.decode_batch(*args, *tabs,
                                          torch.from_numpy(counts), out_p,
                                          s_states)
    assert not under.any()
    for i, blk in enumerate(blocks):
        np.testing.assert_array_equal(rows[i, :blk.size].numpy(), blk)


def test_backend_decodes_17_to_20_bit_blocks_on_the_cpu_with_no_card_rows():
    """The backend on the CPU decodes text blocks whose codes reach 17-20
    bits exactly, through the tables' plain version: the counter of rows
    built on the card stays 0."""
    data = np.frombuffer(text_with_rare_bytes(1 << 20), np.uint8)
    blocks = [data[i:i + 150_000] for i in (0, 350_000, 700_000)]
    tables = codes_mod.build_code_tables(
        np.stack([oracle.histogram(b) for b in blocks]))
    assert (tables.lens.max(axis=1) > 16).all()
    assert tables.lens.max() <= 20
    payloads = [oracle.pack(b, tables.lens[i], tables.vals[i])
                for i, b in enumerate(blocks)]
    tracing.reset()
    out = TorchBackend("cpu").fused_decode(payloads, tables,
                                           [b.size for b in blocks],
                                           expand=False)
    for got, blk in zip(out, blocks):
        np.testing.assert_array_equal(got, blk)
    c = tracing.counters()
    assert c["decode_blocks32"] == 3
    assert c["decode_table_rows_on_device"] == 0


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 64])
@pytest.mark.parametrize("name,wide", ROUTES)
def test_kernel_equals_the_host_builders(cuda, name, wide, rows):
    tables = _rows(name, rows)
    lens, hi32 = (t.to(cuda) for t in _inputs(tables))
    before = _build.launches["decode_tables"]
    tracing.reset()
    got = decode.decode_tables_on_device(lens, hi32, wide)
    torch.cuda.synchronize()
    assert _build.launches["decode_tables"] == before + 1
    assert tracing.counters()["decode_table_rows_on_device"] == rows
    assert got[-1].data_ptr() % 16 == 0  # K2 and K5 read the table as int4
    _assert_same([t.cpu().numpy() for t in got], _host(tables, wide))


@pytest.mark.gpu
def test_backend_round_trip_counts_every_decoded_row_on_the_card(
        cuda, tmp_path):
    """Text blocks (codes of 17-20 bits) and mixed ones (at most 16) at
    1 MiB blocks: the decompress restores the file, and K9 built the
    tables of every block the card decoded, on both routes."""
    data = text_with_rare_bytes(3 << 20) + synthetic(2 << 20, 7)
    path = str(tmp_path / "t.bin")
    with open(path, "wb") as fp:
        fp.write(data)
    tb = TorchBackend(cuda)
    pipeline.compress_pipeline(path, False, False, 1 << 20, tb)
    os.rename(path, path + ".orig")
    tracing.reset()
    pipeline.module_d_shafa(path + ".rle.shaf", True, tb)
    with open(path, "rb") as fp:
        assert fp.read() == data
    c = tracing.counters()
    assert c["decode_blocks16"] > 0 and c["decode_blocks32"] > 0
    assert c["decode_table_rows_on_device"] == \
        c["decode_blocks16"] + c["decode_blocks32"] == 5
    assert c["host_decoded_blocks"] == 0
