"""Decode of 17-32-bit codes in shafa_tpu_torch: K5's and K6's plain
versions against the JAX package's Pallas kernels in interpret mode (as
tests/test_decode_scan.py runs them), the whole port decode against the
NumPy oracle, and the backend's routing of a mixed batch. Payloads stay
under 64 KiB; every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shafa_tpu import codes as codes_mod, oracle
from shafa_tpu.kernels import decode as jdec
from shafa_tpu_torch import tracing
from shafa_tpu_torch.device import TorchBackend, _bucket, _stack_blocks
from shafa_tpu_torch.kernels import decode
from shafa_tpu_torch.profile_main_path import text_with_rare_bytes


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


def _stack_tables(tables):
    return codes_mod.CodeTables(np.concatenate([t.lens for t in tables]),
                                np.concatenate([t.vals for t in tables]))


def _text_case(rng):
    """A 40 KB slice of the text corpus, coded with the table of the 1 MiB
    it comes from: its rare bytes have codes of 17-20 bits."""
    data = np.frombuffer(text_with_rare_bytes(1 << 20), np.uint8)
    table = codes_mod.build_code_tables(oracle.histogram(data)[None])
    lo = int(rng.integers(0, data.size - 40_000))
    return table, data[lo:lo + 40_000]


def _batch(rng):
    """Three rows with codes of 17-24 bits: canonical 20- and 24-bit tables
    and the text corpus; row 0 decodes fewer symbols than it holds (a
    ragged count), row 1's payload is cut in half (underrun)."""
    t20 = _canonical(list(range(1, 20)) + [20, 20])
    t24 = _canonical(list(range(1, 24)) + [24, 24])
    t_text, text = _text_case(rng)
    blocks = [rng.integers(0, 21, 6000).astype(np.uint8),
              rng.integers(0, 25, 9000).astype(np.uint8), text]
    tables = _stack_tables([t20, t24, t_text])
    assert 16 < int(tables.lens[2].max()) <= 24
    payloads = [oracle.pack(b, tables.lens[i], tables.vals[i])
                for i, b in enumerate(blocks)]
    payloads[1] = payloads[1][: len(payloads[1]) // 2]
    counts = np.array([4000, blocks[1].size, blocks[2].size], np.int32)
    st, plens = _stack_blocks([np.frombuffer(p, np.uint8) for p in payloads],
                              minimum=1024)
    return tables, blocks, payloads, counts, st, plens


def _k5_tables(tables):
    """K5's tables of a CodeTables batch: pc32, ls, ncodes and the 12-bit
    table, as CPU tensors."""
    tabs = decode.rank_tables32(decode.decode_tables_batch(tables.lens,
                                                           tables.vals))
    return [torch.from_numpy(a)
            for a in (*tabs, decode.rank_lut12_32(*tabs))]


@pytest.fixture(scope="module")
def batch():
    """The batch, K5's planes from the port (plain, from the payload bytes)
    and from the JAX package's Pallas kernel (interpret mode, from the
    windows its caller builds)."""
    tables, blocks, payloads, counts, st, plens = _batch(
        np.random.default_rng(17))
    tabs = _k5_tables(tables)
    planes = decode.rank_planes32(torch.from_numpy(st),
                                  torch.from_numpy(plens), *tabs)
    jw = jdec.windows32_bytes(st)
    ln8, sym8 = jdec.rank_planes32_pallas(
        jw, jnp.pad(jw[:, 1:], ((0, 0), (0, 1))),
        *jdec.rank_tables32(jdec.decode_tables_batch(tables.lens,
                                                     tables.vals)),
        interpret=True)
    return dict(tables=tables, blocks=blocks, payloads=payloads,
                counts=counts, st=st, plens=plens, planes=planes,
                tabs=tabs, ln8=np.asarray(ln8), sym8=np.asarray(sym8))


def test_rank_planes32_matches_pallas(batch):
    """K5's sym | len << 8 planes, split into the JAX kernel's i8 length and
    symbol planes, on tables of at most 24 bits (below the JAX kernel's
    window fault)."""
    planes = batch["planes"].numpy()
    np.testing.assert_array_equal(((planes >> 8) & 63).astype(np.int8),
                                  batch["ln8"])
    np.testing.assert_array_equal(
        (planes & 255).astype(np.uint8).view(np.int8), batch["sym8"])


def _lut32_lookup(lut, pc32, ls, nc, w):
    """K5's lookup of one row's 32-bit windows (csrc/rank32.cu), in numpy:
    the entry of the window's top 12 bits, or the binary search over the
    row's nc codes that a range entry asks for. lut (4096,) int16, pc32
    and ls (256,)."""
    w = np.asarray(w).astype(np.int64)
    pc = np.asarray(pc32).astype(np.int64) & 0xFFFFFFFF
    e = np.asarray(lut)[w >> 20].astype(np.int64)
    lo = e & 255
    r = lo.copy()
    step = (1 << ((e >> 8) & 15)) >> 1
    while step.any():
        nxt = r + step
        take = (step > 0) & (nxt < nc) & (pc[np.minimum(nxt, 255)] <= w)
        r = np.where(take, nxt, r)
        step >>= 1
    found = np.where(pc[lo] <= w, np.asarray(ls).astype(np.int64)[r], 0)
    return np.where(e < 0, found, e)


def _lut32_case(kind):
    """(pc32, ls, ncodes) rows of K5's tables: from the text corpus's code
    table, the complete canonical 1-32-bit code, a single-symbol block, or
    written out where no complete prefix code gives them (codes above
    window 0, a gap, a 12-bit prefix shared by a 12-bit and two 30-bit
    codes)."""
    if kind == "text":
        t, _ = _text_case(np.random.default_rng(3))
    elif kind == "canonical_1_to_32":
        t = _canonical(list(range(1, 32)) + [32, 32])
    elif kind == "single_symbol":  # the code "0" (docs/DEVIATIONS.md §1)
        hist = np.zeros((1, 256), np.int64)
        hist[0, 65] = 9
        t = codes_mod.build_code_tables(hist)
    else:
        pcs = [0x00300000, 0x00300004, 0x00300008, 0x0F000000, 0x80000000]
        lens = [12, 30, 30, 8, 1]
        pc32 = np.zeros((1, 256), np.uint32)
        ls = np.zeros((1, 256), np.int32)
        pc32[0, :len(pcs)] = pcs
        ls[0, :len(pcs)] = [(s + 1) | (ln << 8) for s, ln in enumerate(lens)]
        return pc32.view(np.int32), ls, np.array([len(pcs)], np.int32)
    return decode.rank_tables32(decode.decode_tables_batch(t.lens, t.vals))


@pytest.mark.parametrize("kind", ["text", "canonical_1_to_32",
                                  "single_symbol", "incomplete"])
def test_rank_lut12_32_gives_searchsorted(kind):
    """K5's lookup (the 12-bit table, and the range search where its entry
    asks for one) against searchsorted over the row's codes, on every
    12-bit prefix with its low 20 bits at 0, at all ones and at every
    code's low bits and one either side of them."""
    pc32, ls, ncodes = _lut32_case(kind)
    lut = decode.rank_lut12_32(pc32, ls, ncodes)
    assert lut.shape == (1, 4096) and lut.dtype == np.int16
    nc = int(ncodes[0])
    pc = pc32[0].astype(np.int64) & 0xFFFFFFFF
    low = np.unique(np.concatenate([
        [0, 0xFFFFF], *[((pc[:nc] & 0xFFFFF) + d) & 0xFFFFF
                        for d in (-1, 0, 1)]]))
    w = ((np.arange(4096, dtype=np.int64)[:, None] << 20) | low).ravel()
    r = np.searchsorted(pc[:nc], w, side="right") - 1
    want = np.where(r >= 0, ls[0][np.maximum(r, 0)], 0)
    np.testing.assert_array_equal(_lut32_lookup(lut[0], pc32[0], ls[0], nc, w),
                                  want)
    # the text's short codes resolve in one lookup, its 17-20-bit ones not
    assert (lut[0] < 0).any() == (kind != "single_symbol")


def test_planes_past_the_payload_leave_fsm32_packs_unchanged(batch):
    """K5 leaves its plane entries at or past each row's payload length
    unspecified: garbage there changes neither K6's packs nor its underrun
    flags (fsm32_packs_plain, the function the kernel is held to)."""
    b = batch["plens"].size
    p = batch["planes"].shape[1] // b
    past = np.arange(p)[None, :] >= batch["plens"][:, None]
    junk = batch["planes"].clone().reshape(8, b, p)
    noise = np.random.default_rng(6).integers(-2**31, 2**31, junk.shape)
    junk[:, torch.from_numpy(past)] = torch.from_numpy(
        noise[:, past].astype(np.int32))
    plens, counts = (torch.from_numpy(batch[k]) for k in ("plens", "counts"))
    want = decode.fsm32_packs_plain(batch["planes"], plens, counts)
    got = decode.fsm32_packs_plain(junk.reshape(8, b * p), plens, counts)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _match_pallas(planes, ln8, sym8, plens, counts):
    """K6's interleaved vals / lens and underrun flags against
    _stage2_chain_planes(..., 32): lanes 0::2 hold val1 / len1 and lanes
    1::2 val2 / len2 within each row's payload (the JAX kernel leaves the
    tiles past it unwritten); the port's lanes past it are zero. Returns
    the underrun flags."""
    b = plens.size
    p = planes.shape[1] // b
    vals, lens, under = decode.fsm32_packs(planes, torch.from_numpy(plens),
                                           torch.from_numpy(counts))
    assert vals.shape == lens.shape == (b, 2 * p)
    want = jdec._stage2_chain_planes(
        jnp.asarray(ln8), jnp.asarray(sym8), b, p, jnp.asarray(plens),
        jnp.asarray(counts), 32, interpret=True)
    valid = np.arange(p)[None, :] < plens[:, None]
    for got, w1, w2 in ((vals, want[0], want[1]), (lens, want[2], want[3])):
        got = got.numpy()
        for g, w in ((got[:, 0::2], w1), (got[:, 1::2], w2)):
            np.testing.assert_array_equal(g[valid], np.asarray(w)[valid])
            assert not g[~valid].any()
    np.testing.assert_array_equal(under.numpy(), np.asarray(want[4]))
    return under.tolist()


def test_fsm32_packs_match_pallas(batch):
    """On the JAX kernel's planes (equal to the port's)."""
    assert _match_pallas(batch["planes"], batch["ln8"], batch["sym8"],
                         batch["plens"], batch["counts"]) == \
        [False, True, False]


def _edge_row(case, rng):
    """(payload, count) of one row at a tile edge of K6 (2048 payload bytes
    per tile) under the canonical 1-20-bit code: 1 byte, exactly one tile,
    one tile and a byte, or a count that ends inside a byte's symbols.
    Symbols mostly have short codes, so bytes hold several; a 20-bit code
    every 400 symbols."""
    table = _canonical(list(range(1, 20)) + [20, 20])
    prob = 0.5 ** np.arange(1, 22)
    syms = rng.choice(21, 40_000, p=prob / prob.sum()).astype(np.uint8)
    syms[::400] = 20
    if case == "one_byte":
        syms = np.array([0, 1, 0, 0, 0], np.uint8)  # 0 10 0 0 0 + pad bit
    lens = table.lens[0][syms].astype(np.int64)
    payload = np.frombuffer(oracle.pack(syms, table.lens[0], table.vals[0]),
                            np.uint8)
    plen = {"one_byte": 1, "one_tile": 2048, "tile_and_a_byte": 2049,
            "count_inside_a_byte": 3000}[case]
    payload = payload[:plen]
    starts = np.cumsum(lens) - lens
    count = int(np.sum(starts + lens <= 8 * plen))
    if case == "count_inside_a_byte":
        # a byte where at least six symbols start: keep five of them
        per_byte = np.bincount(starts[starts < 8 * plen] // 8)
        j = int(np.flatnonzero(per_byte[1000:] >= 6)[0]) + 1000
        count = int(np.sum(starts < 8 * j)) + 5
    return table, payload, count


@pytest.mark.parametrize("case", ["one_byte", "one_tile", "tile_and_a_byte",
                                  "count_inside_a_byte"])
def test_fsm32_packs_at_tile_edges_match_pallas(case):
    """Rows at the edges of K6's 2048-byte tiles and of its count clip,
    beside a row of 700 random payload bytes that underruns (any bytes
    parse under a complete code), against the JAX kernel."""
    rng = np.random.default_rng(2048)
    table, payload, count = _edge_row(case, rng)
    tables = _stack_tables([table, table])
    st, plens = _stack_blocks(
        [payload, rng.integers(0, 256, 700, dtype=np.uint8)], minimum=1024)
    counts = np.array([count, 1 << 20], np.int32)
    tabs = _k5_tables(tables)
    planes = decode.rank_planes32(torch.from_numpy(st),
                                  torch.from_numpy(plens), *tabs)
    pn = planes.numpy()
    assert _match_pallas(planes, ((pn >> 8) & 63).astype(np.int8),
                         (pn & 255).astype(np.uint8).view(np.int8), plens,
                         counts) == [False, True]
    out, _ = decode.decode_batch32(
        torch.from_numpy(st), torch.from_numpy(plens), *tabs,
        torch.from_numpy(counts), _bucket(count))
    want = oracle.unpack(payload.tobytes(), table.row_strings(0), count)
    np.testing.assert_array_equal(out[0, :count].numpy(), want)
    assert not out[0, count:].numpy().any()


def test_decode_batch32_matches_oracle(batch):
    out, under = decode.decode_batch32(
        torch.from_numpy(batch["st"]), torch.from_numpy(batch["plens"]),
        *batch["tabs"], torch.from_numpy(batch["counts"]),
        _bucket(int(batch["counts"].max())))
    assert under.tolist() == [False, True, False]
    for i in (0, 2):
        n = int(batch["counts"][i])
        want = oracle.unpack(batch["payloads"][i],
                             batch["tables"].row_strings(i), n)
        np.testing.assert_array_equal(out[i, :n].numpy(), want)
        np.testing.assert_array_equal(want, batch["blocks"][i][:n])
        assert not out[i, n:].numpy().any()


def test_decode_with_32_bit_codes_matches_oracle():
    """A canonical complete table with codes of 1-31, 32 and 32 bits: the
    window at bit 8j+s needs bits of byte j+4, which the JAX kernel takes
    from byte j+1 (ROADMAP queue 3 item 1), so the port is held against
    oracle.unpack here, not against the JAX kernel. Each long code is
    drawn often enough to start at every bit offset."""
    rng = np.random.default_rng(32)
    tables = _canonical(list(range(1, 32)) + [32, 32])
    blk = np.concatenate([rng.integers(0, 33, 3000),
                          rng.integers(25, 33, 3000)]).astype(np.uint8)
    rng.shuffle(blk)
    payload = oracle.pack(blk, tables.lens[0], tables.vals[0])
    st, plens = _stack_blocks([np.frombuffer(payload, np.uint8)],
                              minimum=1024)
    out, under = decode.decode_batch32(
        torch.from_numpy(st), torch.from_numpy(plens), *_k5_tables(tables),
        torch.tensor([blk.size], dtype=torch.int32), _bucket(blk.size))
    assert not under.any()
    want = oracle.unpack(payload, tables.row_strings(0), blk.size)
    np.testing.assert_array_equal(want, blk)
    np.testing.assert_array_equal(out[0, :blk.size].numpy(), want)


@pytest.mark.parametrize("expand", [False, True])
def test_backend_mixed_batch_matches_oracle(expand):
    """TorchBackend("cpu").fused_decode on one batch of every route: codes
    of at most 16 bits (K2, K3), 17-32 bits (K5, K6, K1), over 32 bits and
    a table that is not complete (both on the host, counted)."""
    rng = np.random.default_rng(9)
    raw = [rng.integers(0, 256, 3000, dtype=np.uint8),
           rng.integers(0, 21, 5000).astype(np.uint8),
           rng.integers(0, 35, 2000).astype(np.uint8),
           np.tile(np.array([1, 2, 2, 1, 2], np.uint8), 300)]
    rows = [oracle.rle_encode(r) for r in raw]
    t16 = codes_mod.build_code_tables(oracle.histogram(rows[0])[None])
    incomplete = _canonical([1, 2, 3])  # '111' is no code
    incomplete.lens[0, 3:] = 0
    tables = _stack_tables([t16, _canonical(list(range(1, 20)) + [20, 20]),
                            _canonical(list(range(1, 34)) + [34, 34]),
                            incomplete])
    assert int(tables.lens[0].max()) <= 16
    assert all((tables.lens[i][r] > 0).all() for i, r in enumerate(rows))
    payloads = [oracle.pack(r, tables.lens[i], tables.vals[i])
                for i, r in enumerate(rows)]
    tracing.reset()
    out = TorchBackend("cpu").fused_decode(
        payloads, tables, [r.size for r in rows], expand=expand)
    assert tracing.counters()["host_decoded_blocks"] == 2
    for i, r in enumerate(rows):
        dec = oracle.unpack(payloads[i], tables.row_strings(i), r.size)
        want = oracle.rle_expand(dec) if expand else dec
        np.testing.assert_array_equal(out[i], want, err_msg=f"row {i}")
