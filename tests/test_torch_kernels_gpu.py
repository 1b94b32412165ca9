"""K1-K8 on a CUDA card against their plain PyTorch versions.

Marked ``gpu``: without a card every test skips (decided in the ``cuda``
fixture). On the card: ``python -m pytest tests/test_torch_kernels_gpu.py``.
Inputs come from numpy seeds; each kernel runs on CUDA tensors and its plain
version on the same values on the CPU; every comparison is exact.
"""

import os

import numpy as np
import pytest
import torch

from shafa_tpu import codes as codes_mod, oracle
from shafa_tpu_torch import pipeline
from shafa_tpu_torch.device import (TorchBackend, _bucket, _stack_blocks,
                                    tables_to_device)
from shafa_tpu_torch.kernels import _build, decode, emit, expand, rle
from shafa_tpu_torch.profile_main_path import text_with_rare_bytes

from corpus import edge_cases, mixed

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _both(fn, *args):
    """fn on the CPU (plain version) and on the card (kernel)."""
    want = fn(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                for a in args])
    before = dict(_build.launches)
    got = fn(*[torch.from_numpy(a).cuda() if isinstance(a, np.ndarray)
               else a for a in args])
    torch.cuda.synchronize()
    assert _build.launches != before, "the kernel was not launched"
    return want, got


def _payloads(rng, b, p, max_bits=32, min_bits=0):
    lens = rng.integers(min_bits, max_bits + 1, (b, p)).astype(np.int32)
    vals = rng.integers(0, 1 << 32, (b, p), dtype=np.uint64).astype(np.uint32)
    return vals.view(np.int32), lens


@pytest.mark.parametrize("b,p,max_bits,row_lens", [
    (1, 300, 32, [137]),                       # masked lanes
    (4, 700, 32, [700, 0, 33, 512]),           # a zero-length row
    (2, 100_000, 8, [100_000, 99_999]),        # rows of many tiles / pages
    (3, 4096, 32, [4096, 1, 4095]),
])
def test_emit_bits(cuda, b, p, max_bits, row_lens):
    rng = np.random.default_rng(p)
    vals, lens = _payloads(rng, b, p, max_bits)
    lens[0, ::7] = 32
    lens[-1, ::5] = 0
    row_lens = np.array(row_lens, np.int32)
    byte_lens = [(int(lens[r, :n].sum()) + 7) // 8
                 for r, n in enumerate(row_lens)]
    woff, out_words = emit.aligned_offsets(byte_lens)
    want, got = _both(lambda *a: emit.emit_bits(*a, out_words), vals, lens,
                      row_lens, woff)
    assert torch.equal(got.cpu(), want)


def test_emit_coded(cuda):
    rng = np.random.default_rng(8)
    b, p = 3, 50_000
    x = rng.integers(0, 256, (b, p), dtype=np.uint8)
    x[1, :30_000] = 7
    row_lens = np.array([p, 41_000, 64], np.int32)
    hists = np.stack([np.bincount(x[r, :row_lens[r]], minlength=256)
                      for r in range(b)])
    tables = codes_mod.build_code_tables(hists)
    dt = tables_to_device(tables, "cpu")
    byte_lens = [(int((hists[r] * dt.lut_len[r].numpy()).sum()) + 7) // 8
                 for r in range(b)]
    woff, out_words = emit.aligned_offsets(byte_lens)
    want, got = _both(
        lambda x_, rl, ll, lv, wo: emit.emit_coded(x_, rl, ll, lv, wo,
                                                   out_words),
        x, row_lens, dt.lut_len.numpy(), dt.lut_val.numpy(), woff)
    assert torch.equal(got.cpu(), want)
    buf = got.cpu().numpy().view(np.uint8)
    for r in range(b):
        assert buf[4 * woff[r]:4 * woff[r] + byte_lens[r]].tobytes() == \
            oracle.pack(x[r, :row_lens[r]], tables.lens[r], tables.vals[r])


def test_rle_encode(cuda):
    rows = [np.frombuffer(v, np.uint8) for _, v in sorted(
        edge_cases().items())] + [np.frombuffer(mixed(200_000, seed=4),
                                                np.uint8)]
    x, lens = _stack_blocks(rows)
    want, got = _both(rle.rle_encode_batch, x, lens)
    assert torch.equal(got[1].cpu(), want[1])
    for i, n in enumerate(want[1].tolist()):
        assert torch.equal(got[0][i, :n].cpu(), want[0][i, :n])


@pytest.mark.parametrize("case", ["corpus", "edge"])
def test_rle_encode_hist(cuda, case):
    """K8 against its plain version, 5 runs: the corpus rows and a 200 KB
    mixed row, or K8's edge rows at its own tile (chip_smoke.k8_edge_rows,
    1 MiB wide)."""
    from chip_smoke import k8_edge_rows
    if case == "corpus":
        x, lens = _stack_blocks([np.frombuffer(v, np.uint8) for _, v in
                                 sorted(edge_cases().items())]
                                + [np.frombuffer(mixed(200_000, seed=5),
                                                 np.uint8)])
    else:
        tile = _build.library().shafa_rle_encode_tile_bytes()
        x, lens = k8_edge_rows(tile, 1 << 20, seed=2)
    want, got = _both(rle.rle_encode_hist, x, lens)
    on_card = [torch.from_numpy(a).cuda() for a in (x, lens)]
    for run in range(5):
        if run:
            got = rle.rle_encode_hist(*on_card)
        assert torch.equal(got[1].cpu(), want[1])
        assert torch.equal(got[2].cpu(), want[2])
        for i, n in enumerate(want[1].tolist()):
            assert torch.equal(got[0][i, :n].cpu(), want[0][i, :n])


def _archive(blocks):
    hists = np.stack([oracle.histogram(b) for b in blocks])
    tables = codes_mod.build_code_tables(hists)
    payloads = [oracle.pack(b, tables.lens[i], tables.vals[i])
                for i, b in enumerate(blocks)]
    return tables, payloads


def _decode16_case(kind):
    """Blocks, tables, payload batch and counts with codes of at most 16
    bits: all 8-bit codes, a skewed alphabet, or a ragged count and a
    truncated payload."""
    rng = np.random.default_rng(len(kind))
    if kind == "all_8bit":
        b0 = np.tile(np.arange(256, dtype=np.uint8), 64)
        rng.shuffle(b0)
        blocks = [b0]
    elif kind == "skewed":
        probs = 0.85 ** np.arange(40)
        blocks = [rng.choice(40, n, p=probs / probs.sum()).astype(np.uint8)
                  for n in (300_000, 70_000, 5)]
    else:
        blocks = [rng.integers(0, 256, n, dtype=np.uint8)
                  for n in (20_000, 20_000, 3000)]
    tables, payloads = _archive(blocks)
    assert int(tables.lens.max()) <= 16
    counts = np.array([b.size for b in blocks], np.int32)
    if kind == "ragged_underrun":
        counts[0] = 1000
        payloads[1] = payloads[1][: len(payloads[1]) // 2]
    st, plens = _stack_blocks([np.frombuffer(p, np.uint8) for p in payloads],
                              minimum=1024)
    dt = tables_to_device(tables, "cpu", decode=True)
    s_states = 8 if int(tables.lens.max()) <= 8 else 16
    return blocks, counts, st, plens, dt, s_states


@pytest.mark.parametrize("kind", ["all_8bit", "skewed", "ragged_underrun"])
def test_rank_and_fsm_decode(cuda, kind):
    blocks, counts, st, plens, dt, s_states = _decode16_case(kind)
    ls_want, ls_got = _both(decode.rank_planes, st, dt.pc16.numpy(),
                            dt.ls.numpy(), dt.lut12.numpy())
    assert torch.equal(ls_got.cpu(), ls_want)
    out_p = _bucket(int(counts.max()))
    want, got = _both(
        lambda ls8, pl, ct: decode.decode_rows(ls8, pl, ct, s_states, out_p),
        ls_want.numpy(), plens, counts)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])
    assert want[1].tolist() == ([False, True, False]
                                if kind == "ragged_underrun"
                                else [False] * len(blocks))
    for i, n in enumerate(counts):
        if not want[1][i]:
            assert np.array_equal(got[0][i, :n].cpu().numpy(),
                                  blocks[i][:n])


@pytest.mark.parametrize("kind", ["all_8bit", "skewed", "ragged_underrun"])
def test_fsm_packs(cuda, kind):
    """K7's interleaved (B, 2P) vals and lens and its underrun flags against
    its plain version at 8 (all_8bit) and 16 states, 20 runs (its last pass
    takes its offsets from a look-back), and the v4 chain (K2, K7, K1)
    against the K2 -> K3 route on the card."""
    blocks, counts, st, plens, dt, s_states = _decode16_case(kind)
    assert s_states == (8 if kind == "all_8bit" else 16)
    ls8 = decode.rank_planes(torch.from_numpy(st), dt.pc16, dt.ls,
                             dt.lut12).numpy()
    want, got = _both(lambda *a: decode.fsm_packs(*a, s_states), ls8, plens,
                      counts)
    b, p = st.shape
    assert got[0].shape == got[1].shape == (b, 2 * p)
    on_card = [torch.from_numpy(a).cuda() for a in (ls8, plens, counts)]
    for _ in range(20):
        for g, w in zip(decode.fsm_packs(*on_card, s_states), want):
            assert torch.equal(g.cpu(), w)
    args = [torch.from_numpy(a).cuda() for a in (st, plens)] + [
        dt.pc16.cuda(), dt.ls.cuda(), dt.lut12.cuda(),
        torch.from_numpy(counts).cuda(),
        _bucket(int(counts.max())), s_states]
    before = _build.launches["fsm_packs"]
    rows, under = decode.decode_batch_packs(*args)
    assert _build.launches["fsm_packs"] == before + 1
    k3_rows, k3_under = decode.decode_batch(*args)
    assert torch.equal(rows, k3_rows) and torch.equal(under, k3_under)
    assert under.tolist() == ([False, True, False]
                              if kind == "ragged_underrun"
                              else [False] * len(blocks))


@pytest.mark.parametrize("seed", [0, 1])
def test_expand(cuda, seed):
    """K4 (its sizes, then its expansion) against its plain version, 5 runs,
    on random whole-token rows of 5000, 300,000, 0 and 3 bytes (seed 0)
    or on K4's edge rows (seed 1: chip_smoke.k4_edge_rows)."""
    from chip_smoke import k4_edge_rows
    rng = np.random.default_rng(seed)
    rows = []
    for n in (5000, 300_000, 0, 3) if seed == 0 else ():
        out = bytearray()  # whole tokens only: no escape cut at the end
        while len(out) < n:
            if rng.random() < 0.4:
                out += bytes([0, int(rng.integers(0, 256)),
                              int(rng.integers(0, 256))])
            else:
                out.append(int(rng.integers(1, 256)))
        rows.append(np.frombuffer(bytes(out), np.uint8))
    if seed:
        rows = k4_edge_rows(_build.library().shafa_expand_tile_bytes(), seed)
    x, lens = _stack_blocks(rows)
    total = int(expand.rle_expand_sizes(torch.from_numpy(x),
                                        torch.from_numpy(lens))["out_len"]
                .sum())

    def expanded(xs, ls):
        sizes = expand.rle_expand_sizes(xs, ls)
        assert int(sizes["out_len"].sum()) == total
        return expand.rle_expand(sizes, total)
    want, got = _both(expanded, x, lens)
    assert torch.equal(got.cpu(), want)
    on_card = [torch.from_numpy(a).cuda() for a in (x, lens)]
    for _ in range(4):
        assert torch.equal(expanded(*on_card).cpu(), want)
    if seed == 0:
        assert want.numpy().tobytes() == b"".join(
            oracle.rle_expand(r).tobytes() for r in rows)


def _canonical(lens_list):
    """CodeTables row of a complete canonical code with these lengths."""
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


def _k5_tables(tables):
    """K5's tables of a CodeTables batch as numpy arrays: pc32, ls, ncodes
    and the 12-bit table."""
    tabs = decode.rank_tables32(decode.decode_tables_batch(tables.lens,
                                                           tables.vals))
    return [*tabs, decode.rank_lut12_32(*tabs)]


def _assert_equal_below_payload(got, want, plens):
    """K5's planes agree at every lane below each row's payload length (the
    kernel leaves the others unspecified)."""
    b = len(plens)
    p = want.shape[1] // b
    below = torch.from_numpy(np.arange(p)[None, :] < np.asarray(plens)[:, None])
    for g, w in zip(got.reshape(8, b, p), want.reshape(8, b, p)):
        assert torch.equal(g.cpu()[below], w.cpu()[below])


@pytest.mark.parametrize("kind", ["text", "canonical_32_ragged"])
def test_rank32_and_fsm32(cuda, kind):
    rng = np.random.default_rng(len(kind))
    if kind == "text":
        data = np.frombuffer(text_with_rare_bytes(3 << 20), np.uint8)
        blocks = [data[i << 20:(i + 1) << 20] for i in range(3)]
        tables, payloads = _archive(blocks)
    else:  # codes of 1-32 bits; a ragged count and a truncated payload
        wide = _canonical(list(range(1, 32)) + [32, 32])
        blocks = [rng.integers(0, 33, n).astype(np.uint8)
                  for n in (300_000, 70_000, 5)]
        tables = codes_mod.CodeTables(np.repeat(wide.lens, 3, 0),
                                      np.repeat(wide.vals, 3, 0))
        payloads = [oracle.pack(b, tables.lens[i], tables.vals[i])
                    for i, b in enumerate(blocks)]
    assert 16 < int(tables.lens.max()) <= 32
    counts = np.array([b.size for b in blocks], np.int32)
    if kind != "text":
        counts[0] = 1000
        payloads[1] = payloads[1][: len(payloads[1]) // 2]
    st, plens = _stack_blocks([np.frombuffer(p, np.uint8) for p in payloads],
                              minimum=1024)
    tabs = _k5_tables(tables)
    planes_want, planes_got = _both(decode.rank_planes32, st, plens, *tabs)
    _assert_equal_below_payload(planes_got.cpu(), planes_want, plens)
    want, got = _both(decode.fsm32_packs, planes_want.numpy(), plens, counts)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert want[0].shape == want[1].shape == (len(blocks), 2 * st.shape[1])
    under = want[2].tolist()
    assert under == ([False] * 3 if kind == "text" else [False, True, False])
    out_p = _bucket(int(counts.max()))
    dec, dec_under = decode.decode_batch32(
        *[torch.from_numpy(a).cuda() for a in (st, plens, *tabs, counts)],
        out_p)
    assert dec_under.cpu().tolist() == under
    for i, n in enumerate(counts):
        if not under[i]:
            assert np.array_equal(dec[i, :n].cpu().numpy(), blocks[i][:n])


def test_fsm32_repeated_on_rows_of_many_lengths(cuda):
    """K6 20 times in a row against its plain version (on the card) on a
    (4, 4 MiB) batch of random payload bytes, which parse under a complete
    1-32-bit code: a full row cut by its count, a row that ends on a tile
    boundary and underruns, a row of 123,457 bytes, a row of 1 byte. A
    look-back that reads a neighbour's count too early shows only in some
    runs."""
    rng = np.random.default_rng(20)
    p = 4 << 20
    tile = _build.library().shafa_fsm32_tile_bytes()
    plens = np.array([p, 977 * tile, 123_457, 1], np.int32)
    st = rng.integers(0, 256, (4, p), dtype=np.uint8)
    st[3, 0] = 0  # eight 1-bit codes, two of them kept
    wide = _complete_rows(list(range(1, 32)) + [32, 32], 4)
    pl = torch.from_numpy(plens).cuda()
    planes = decode.rank_planes32(
        torch.from_numpy(st).cuda(), pl,
        *[torch.from_numpy(a).cuda() for a in _k5_tables(wide)])
    cnt = torch.tensor([10_000_000, 2 ** 31 - 1, 3 * 123_457, 2],
                       dtype=torch.int32, device=cuda)
    want = decode.fsm32_packs_plain(planes, pl, cnt)
    assert want[2].tolist() == [False, True, False, False]
    before = _build.launches["fsm32"]
    for _ in range(20):
        got = decode.fsm32_packs(planes, pl, cnt)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert _build.launches["fsm32"] == before + 20


def _complete_rows(lens_list, n_rows):
    """CodeTables of n_rows copies of a complete canonical code."""
    one = _canonical(lens_list)
    return codes_mod.CodeTables(np.repeat(one.lens, n_rows, 0),
                                np.repeat(one.vals, n_rows, 0))


#: (longest code, code lengths) of K3's 16- and 8-state edge cases
EDGE_CODES = {16: list(range(1, 16)) + [16, 16], 8: [8] * 256}


@pytest.mark.parametrize("s_states", [16, 8])
def test_fsm_decode_repeated_on_rows_of_many_lengths(cuda, s_states):
    """K3 20 times in a row against its plain version (on the card) on a
    (4, 4 MiB) batch of random payload bytes under a complete code (1-16
    bits, or all 8 bits): a full row cut by its count inside a tile, a row
    that ends on a tile boundary and underruns (at 16 states its symbols
    pass the row width, where K3 drops them), a row of 123,457 bytes, a row
    of 1 byte. A look-back that reads a neighbour's count too early, or an
    edge word that two tiles share, shows only in some runs."""
    rng = np.random.default_rng(30 + s_states)
    p = 4 << 20
    tile = _build.library().shafa_fsm_decode_tile_bytes()
    plens = np.array([p, 977 * tile, 123_457, 1], np.int32)
    st = rng.integers(0, 256, (4, p), dtype=np.uint8)
    st[np.arange(p)[None, :] >= plens[:, None]] = 0
    st[3, 0] = 0  # eight 1-bit codes at 16 states, one 8-bit code at 8
    dt = tables_to_device(_complete_rows(EDGE_CODES[s_states], 4), cuda,
                          decode=True)
    planes = decode.rank_planes(torch.from_numpy(st).cuda(), dt.pc16, dt.ls,
                                dt.lut12)
    pl = torch.from_numpy(plens).cuda()
    cnt = torch.tensor([3_000_000, 2 ** 31 - 1, 100_000, s_states // 8],
                       dtype=torch.int32, device=cuda)
    out_p = 4 << 20
    want = decode.decode_rows_plain(planes, pl, cnt, s_states, out_p)
    assert want[1].tolist() == [False, True, False, False]
    before = _build.launches["fsm_decode"]
    for _ in range(20):
        got = decode.decode_rows(planes, pl, cnt, s_states, out_p)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _build.launches["fsm_decode"] == before + 20


def test_rank_on_rows_that_reach_the_row_width(cuda):
    """K2 against its plain version where the payload fills every byte of
    P, so the windows of the last two bytes read the zeros past it, on a
    skewed 1-16-bit code (one-lookup and range entries) and on rows of
    several tiles and of less than one."""
    rng = np.random.default_rng(40)
    for p in (1 << 20, 1024, 16):
        st = rng.integers(0, 256, (3, p), dtype=np.uint8)
        dt = tables_to_device(_complete_rows(EDGE_CODES[16], 3), "cpu",
                              decode=True)
        assert (dt.lut12.numpy() < 0).any()
        want, got = _both(decode.rank_planes, st, dt.pc16.numpy(),
                          dt.ls.numpy(), dt.lut12.numpy())
        assert torch.equal(got.cpu(), want)


def test_rank_and_fsm_decode_reject_widths_they_do_not_take(cuda):
    """K2 reads a tile's bytes as int4; K3 reads a thread's 8 lanes of a
    plane as two int4 and writes its rows as u32 words."""
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    tables = (torch.zeros((1, 256), dtype=torch.int32, device=cuda),
              torch.zeros((1, 256), dtype=torch.int32, device=cuda),
              torch.zeros((1, 4096), dtype=torch.int16, device=cuda))
    with pytest.raises(ValueError, match="multiple of 16"):
        decode.rank_planes(torch.zeros((1, 1032), dtype=torch.uint8,
                                       device=cuda), *tables)
    planes = torch.zeros((8, 1028), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        decode.decode_rows(planes, one, one, 16, 256)
    planes = torch.zeros((8, 1024), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        decode.decode_rows(planes, one, one, 16, 258)


def _emit_edge_case(variant, aligned, tile):
    """K1's edge rows (six rows of P lanes, P a multiple of 16 or not): a
    1-lane row, rows that end on a tile boundary and one lane past it, a
    row whose tiles 2-40 hold only 0-bit lanes (they publish 0 to the
    look-back), a row of 32-bit payloads after one 5-bit lane (each
    straddles two words), a row of 123,457 lanes. Rows start at word
    offsets that are not 16-byte aligned, and the buffer ends inside the
    last row. Returns (wrapper arguments, the wrapper)."""
    rng = np.random.default_rng(7 if aligned else 8)
    b, p = 6, 48 * tile + (0 if aligned else 3)
    row_lens = np.array([1, 16 * tile, 16 * tile + 1, p, p, 123_457],
                        np.int32)
    if variant == "bits":
        vals, lens = _payloads(rng, b, p)
        lens[3, 2 * tile:41 * tile] = 0
        lens[4] = 32
        lens[4, 0] = 5
    else:
        x = rng.integers(1, 256, (b, p), dtype=np.uint8)
        x[3, 2 * tile:41 * tile] = 0
        x[4, 0], x[4, 1:] = 1, 255
        lut_len = rng.integers(1, 33, (b, 256)).astype(np.int32)
        lut_len[:, 0] = 0
        lut_len[4, 1], lut_len[4, 255] = 5, 32
        lut_val = rng.integers(0, 1 << 32, (b, 256),
                               dtype=np.uint64).astype(np.uint32).view(np.int32)
        lens = np.take_along_axis(lut_len, x.astype(np.int64), 1)
    words = [(int(lens[r, :n].sum()) + 31) // 32
             for r, n in enumerate(row_lens)]
    woff = np.cumsum([0] + [w + 3 for w in words[:-1]]) + 1
    out_words = int(woff[-1]) + words[-1] // 2
    woff = woff.astype(np.int32)
    if variant == "bits":
        return ((vals, lens, row_lens, woff),
                lambda *a: emit.emit_bits(*a, out_words))
    return ((x, row_lens, lut_len, lut_val, woff),
            lambda *a: emit.emit_coded(*a, out_words))


@pytest.mark.parametrize("variant", ["bits", "coded"])
@pytest.mark.parametrize("aligned", [True, False])
def test_emit_repeated_on_edge_rows(cuda, variant, aligned):
    """K1 20 times in a row against its plain version on its edge rows
    (int4 loads where P is a multiple of 16, lane by lane where it is not).
    A look-back that reads a neighbour's bit count too early, or an edge
    word that two tiles share, shows only in some runs."""
    tile = _build.library().shafa_emit_tile_lanes()
    args, fn = _emit_edge_case(variant, aligned, tile)
    want = fn(*[torch.from_numpy(a) for a in args])
    on_card = [torch.from_numpy(a).cuda() for a in args]
    name = "emit_bits" if variant == "bits" else "emit_coded"
    before = _build.launches[name]
    for _ in range(20):
        assert torch.equal(fn(*on_card).cpu(), want)
    assert _build.launches[name] == before + 20


def test_rank32_on_rows_that_end_at_tile_edges(cuda):
    """K5 against its plain version below each row's payload: rows that
    fill P, end inside a tile, on a tile boundary and one byte past it
    and a 1-byte row, random payload bytes under a complete 1-32-bit
    code."""
    rng = np.random.default_rng(50)
    p, tile = 1 << 16, _build.library().shafa_rank32_tile_bytes()
    plens = np.array([p, 3 * tile + 100, 2 * tile, 2 * tile + 1, 1],
                     np.int32)
    st = rng.integers(0, 256, (5, p), dtype=np.uint8)
    tabs = _k5_tables(_complete_rows(list(range(1, 32)) + [32, 32], 5))
    want, got = _both(decode.rank_planes32, st, plens, *tabs)
    _assert_equal_below_payload(got, want, plens)


def test_rank32_and_decode_on_26_to_32_bit_codes(cuda):
    """K5 against its plain version, and K5 -> K6 -> K1 against the NumPy
    oracle, on a complete code whose symbols mostly have 26-32-bit codes:
    the window at bit 8j+s needs byte j+4."""
    rng = np.random.default_rng(32)
    tables = _complete_rows(list(range(1, 32)) + [32, 32], 1)
    blk = rng.integers(25, 33, 100_000).astype(np.uint8)
    payload = oracle.pack(blk, tables.lens[0], tables.vals[0])
    st, plens = _stack_blocks([np.frombuffer(payload, np.uint8)],
                              minimum=1024)
    tabs = _k5_tables(tables)
    want, got = _both(decode.rank_planes32, st, plens, *tabs)
    _assert_equal_below_payload(got, want, plens)
    dec, under = decode.decode_batch32(
        *[torch.from_numpy(a).cuda() for a in (st, plens, *tabs)],
        torch.tensor([blk.size], dtype=torch.int32, device=cuda),
        _bucket(blk.size))
    assert not under.any()
    assert np.array_equal(dec[0, :blk.size].cpu().numpy(), blk)


def test_rank32_rejects_widths_not_a_multiple_of_16(cuda):
    """K5 reads a tile's bytes as int4."""
    tabs = [torch.from_numpy(a).cuda() for a in
            _k5_tables(_complete_rows([1, 1], 1))]
    with pytest.raises(ValueError, match="multiple of 16"):
        decode.rank_planes32(
            torch.zeros((1, 1032), dtype=torch.uint8, device=cuda),
            torch.ones(1, dtype=torch.int32, device=cuda), *tabs)


def test_fsm32_rejects_widths_not_a_multiple_of_8(cuda):
    """K6 reads a thread's 8 lanes of a plane as two int4 loads."""
    planes = torch.zeros((8, 1028), dtype=torch.int32, device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        decode.fsm32_packs(planes, one, one)


def test_backend_round_trip_17_to_32_bit_codes_on_the_card(cuda, tmp_path):
    data = text_with_rare_bytes(6 << 20)
    path = str(tmp_path / "t.bin")
    with open(path, "wb") as fp:
        fp.write(data)
    tb = TorchBackend(cuda)
    _build.reset_launches()
    before = TorchBackend.host_decoded_blocks
    pipeline.compress_pipeline(path, False, False, 2 << 20, tb)
    os.rename(path, path + ".orig")
    pipeline.module_d_shafa(path + ".rle.shaf", True, tb)
    with open(path, "rb") as fp:
        assert fp.read() == data
    assert _build.launches["rank32"] and _build.launches["fsm32"]
    assert TorchBackend.host_decoded_blocks == before


def test_backend_round_trip_on_the_card(cuda, tmp_path):
    from shafa_tpu import pipeline as jpipeline
    data = mixed(3_000_000, seed=5)
    a, b = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    for p in (a, b):
        with open(p, "wb") as fp:
            fp.write(data)
    tb = TorchBackend(cuda)
    pipeline.compress_pipeline(a, False, False, 1 << 20, tb)
    jpipeline.compress_pipeline(b, False, False, 1 << 20,
                                jpipeline.NumpyBackend())
    for ext in (".rle", ".rle.freq", ".rle.cod", ".rle.shaf"):
        with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
            assert fa.read() == fb.read(), ext
    os.rename(a, a + ".orig")
    pipeline.module_d_shafa(a + ".rle.shaf", True, tb)
    with open(a, "rb") as fp:
        assert fp.read() == data

