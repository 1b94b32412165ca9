"""Decode tables, K2's and K3's plain versions and the backend's decode
routing of shafa_tpu_torch against the JAX package: its host tables, its
rank kernel and its whole decode forced onto the Pallas route in interpret
mode (as tests/test_decode_scan.py runs it), and the numpy oracle."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shafa_tpu import codes as codes_mod, oracle
from shafa_tpu.kernels import decode as jdec
from shafa_tpu.kernels import dispatch
from shafa_tpu_torch.device import TorchBackend, tables_to_device
from shafa_tpu_torch.device import _bucket, _stack_blocks
from shafa_tpu_torch.kernels import decode


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


def _archive(blocks):
    hists = np.stack([oracle.histogram(b) for b in blocks])
    tables = codes_mod.build_code_tables(hists)
    payloads = [oracle.pack(b, tables.lens[i], tables.vals[i])
                for i, b in enumerate(blocks)]
    return tables, payloads


def _blocks(kind, rng):
    if kind == "all_8bit":  # every code exactly 8 bits: s_states == 8
        b0 = np.tile(np.arange(256, dtype=np.uint8), 16)
        rng.shuffle(b0)
        return [b0]
    if kind == "mixed_rows":
        return [rng.integers(0, 256, 3000, dtype=np.uint8),
                np.repeat(rng.integers(0, 5, 700), 3).astype(np.uint8),
                rng.integers(97, 102, 1500).astype(np.uint8)]
    if kind == "skewed_9_to_16_bits":
        parts = [np.full(1 << max(0, 12 - s), s, np.uint8)
                 for s in range(14)]
        b0 = np.concatenate(parts)
        rng.shuffle(b0)
        return [b0]
    raise KeyError(kind)


def test_decode_tables_equal_jax():
    rng = np.random.default_rng(1)
    hists = rng.integers(0, 50, size=(5, 256))
    hists[1, 10:] = 0
    hists[2, :] = 0
    hists[2, 3] = 7  # one symbol: the 1-bit code "0"
    tables = codes_mod.build_code_tables(hists)
    got = decode.decode_tables_batch(tables.lens, tables.vals)
    want = jdec.decode_tables_batch(tables.lens, tables.vals)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def test_rank_tables_agree_with_jax_layout():
    """K2's tables hold what the TPU layout holds: same pivots, codes,
    lengths and symbols in rank order."""
    rng = np.random.default_rng(2)
    tables = codes_mod.build_code_tables(rng.integers(1, 80, size=(3, 256)))
    tab = decode.decode_tables_batch(tables.lens, tables.vals)
    pc16, ls = decode.rank_tables(tab)
    piv16, ncodes, ftab = jdec.rank_tables(tab)
    n = np.asarray(ncodes)
    for r in range(3):
        k = int(n[r])
        codes16 = (ftab[r, 0:16] * 256 + ftab[r, 16:32]).T.ravel()
        np.testing.assert_array_equal(pc16[r, :k], codes16[:k])
        assert (pc16[r, k:] == decode.NO_CODE).all()
        np.testing.assert_array_equal(
            pc16[r, ::16][: -(-k // 16)], piv16.reshape(3, 16)[r,
                                                                :-(-k // 16)])
        lens = np.cumsum(ftab[r, 32:48].T.ravel())
        syms = np.cumsum(ftab[r, 48:64].T.ravel())
        np.testing.assert_array_equal(ls[r, :k] >> 8, lens[:k])
        np.testing.assert_array_equal(ls[r, :k] & 255, syms[:k])


def test_decode_tables_raise_value_error():
    lens = np.zeros((2, 256), np.uint8)
    vals = np.zeros((2, 256), np.uint64)
    lens[0, :2] = 1
    vals[0, 1] = np.uint64(1) << np.uint64(63)
    with pytest.raises(ValueError, match="at least one"):
        decode.decode_tables_batch(lens, vals)  # row 1 has no code


def test_rank_tables_raise_value_error_over_16_bits():
    t = _canonical(list(range(1, 18)) + [18, 18])
    tab = decode.decode_tables_batch(t.lens, t.vals)
    with pytest.raises(ValueError, match="16 bits"):
        decode.rank_tables(tab)


def test_windows_and_rank_planes_match_pallas():
    """K2 takes the payload bytes; the JAX rank kernel takes the windows
    its caller builds from them. The rows' payloads reach the end of the
    batch width, so the last windows read the zeros past it."""
    rng = np.random.default_rng(3)
    blocks = _blocks("mixed_rows", rng)
    tables, payloads = _archive(blocks)
    st, plens = _stack_blocks([np.frombuffer(p, np.uint8) for p in payloads],
                              minimum=1024)
    st[0, plens[0]:] = rng.integers(0, 256, st.shape[1] - plens[0])
    w32 = decode.windows32_bytes(torch.from_numpy(st))
    np.testing.assert_array_equal(w32.numpy(),
                                  np.asarray(jdec.windows32_bytes(st)))
    tab = decode.decode_tables_batch(tables.lens, tables.vals)
    pc16, ls = decode.rank_tables(tab)
    got = decode.rank_planes(torch.from_numpy(st), torch.from_numpy(pc16),
                             torch.from_numpy(ls),
                             torch.from_numpy(decode.rank_lut12(pc16, ls)))
    want = jdec.rank_planes_pallas(jdec.windows32_bytes(st),
                                   *jdec.rank_tables(tab), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _lut_lookup(lut, pc16, ls, w16):
    """K2's lookup of one row's 16-bit windows (csrc/rank.cu), in numpy:
    the entry of the window's top 12 bits, or the binary search that a
    range entry asks for. lut (4096,) int16, pc16 and ls (256,)."""
    w16 = np.asarray(w16).astype(np.int64)
    pc = np.asarray(pc16).astype(np.int64)
    e = np.asarray(lut)[w16 >> 4].astype(np.int64)
    lo = e & 255
    r = lo.copy()
    step = (1 << ((e >> 8) & 15)) >> 1
    while step.any():
        nxt = r + step
        take = (step > 0) & (nxt < 256) & (pc[np.minimum(nxt, 255)] <= w16)
        r = np.where(take, nxt, r)
        step >>= 1
    found = np.where(pc[lo] <= w16, np.asarray(ls).astype(np.int64)[r], 0)
    return np.where(e < 0, found, e)


def _lut_case(kind):
    """(pc16, ls) rows of K2's tables: from a complete canonical code, or
    written out where no complete prefix code gives them."""
    if kind == "all_8bit":
        t = _canonical([8] * 256)
    elif kind == "skewed_9_to_16_bits":
        t, _ = _archive(_blocks(kind, np.random.default_rng(6)))
    elif kind == "lengths_12_and_13":
        t = _canonical(list(range(1, 13)) + [13, 13])
    elif kind == "single_symbol":  # the code "0" (docs/DEVIATIONS.md §1)
        hist = np.zeros((1, 256), np.int64)
        hist[0, 65] = 9
        t = codes_mod.build_code_tables(hist)
    if kind in ("shared_12_bit_prefix", "incomplete"):
        # a 12-bit code and two longer ones under its prefix (not prefix
        # free), then a gap; or codes starting above window 0
        pcs = ([0x0000, 0x0010, 0x0018, 0x001C, 0x8000]
               if kind == "shared_12_bit_prefix" else [0x0300, 0x0301, 0xF000])
        lens = [1, 12, 13, 14, 1] if kind == "shared_12_bit_prefix" \
            else [8, 16, 4]
        pc16 = np.full((1, 256), decode.NO_CODE, np.int32)
        ls = np.zeros((1, 256), np.int32)
        pc16[0, :len(pcs)] = pcs
        ls[0, :len(pcs)] = [(s + 1) | (ln << 8) for s, ln in enumerate(lens)]
        return pc16, ls, max(lens)
    pc16, ls = decode.rank_tables(decode.decode_tables_batch(t.lens, t.vals))
    return pc16, ls, int(t.lens.max())


@pytest.mark.parametrize("kind", ["all_8bit", "skewed_9_to_16_bits",
                                  "lengths_12_and_13", "single_symbol",
                                  "shared_12_bit_prefix", "incomplete"])
def test_rank_lut12_gives_searchsorted_on_every_window(kind):
    """K2's lookup (the 12-bit table, and the range search where its entry
    asks for one) against searchsorted over pc16, on all 65,536 windows."""
    pc16, ls, maxlen = _lut_case(kind)
    assert maxlen == {"all_8bit": 8, "skewed_9_to_16_bits": 13,
                      "lengths_12_and_13": 13, "single_symbol": 1,
                      "shared_12_bit_prefix": 14, "incomplete": 16}[kind]
    lut = decode.rank_lut12(pc16, ls)
    assert lut.shape == (1, 4096) and lut.dtype == np.int16
    ranged = lut[0] < 0
    assert ranged.any() == (maxlen > 12)
    w = np.arange(1 << 16)
    r = np.searchsorted(pc16[0], w, side="right") - 1
    want = np.where(r >= 0, ls[0][np.maximum(r, 0)], 0)
    np.testing.assert_array_equal(
        _lut_lookup(lut[0], pc16[0], ls[0], w), want)
    if kind not in ("shared_12_bit_prefix", "incomplete"):
        # in a complete prefix code, a code of at most 12 bits fills its
        # windows' entries itself
        n = int((pc16[0] < decode.NO_CODE).sum())
        short = (ls[0, :n] >> 8) <= 12
        np.testing.assert_array_equal(lut[0, pc16[0, :n][short] >> 4],
                                      ls[0, :n][short])


def _port_decode(payloads, tables, counts):
    pblocks = [np.frombuffer(p, np.uint8) for p in payloads]
    st, plens = _stack_blocks(pblocks, minimum=1024)
    dt = tables_to_device(tables, "cpu", decode=True)
    ml = int(tables.lens.max())
    out, under = decode.decode_batch(
        torch.from_numpy(st), torch.from_numpy(plens), dt.pc16, dt.ls,
        dt.lut12, torch.tensor(counts, dtype=torch.int32),
        _bucket(int(max(counts))), 8 if ml <= 8 else 16)
    return out.numpy(), under.numpy(), st, plens


@pytest.fixture
def pallas_decode(monkeypatch):
    monkeypatch.setattr(dispatch, "use_pallas_emit", lambda: True)
    monkeypatch.setattr(dispatch, "pallas_interpret", lambda: True)

    def run(st, plens, tables, counts):
        tab = jdec.decode_tables_batch(tables.lens, tables.vals)
        out, under = jdec.decode_batch(
            jnp.asarray(st), jnp.asarray(plens), tab,
            jnp.asarray(np.array(counts, np.int32)),
            _bucket(int(max(counts))), max_len=int(tables.lens.max()))
        return np.asarray(out), np.asarray(under)
    return run


def test_decode_matches_pallas_and_oracle(pallas_decode):
    """One batch through both packages: <=8-bit and 9-16-bit tables, ragged
    counts (fewer symbols than the block holds) and an underrun."""
    rng = np.random.default_rng(5)
    blocks = (_blocks("all_8bit", rng) + _blocks("mixed_rows", rng)
              + _blocks("skewed_9_to_16_bits", rng)
              + [rng.integers(0, 256, 2048, dtype=np.uint8)])
    tables, payloads = _archive(blocks)
    assert 8 < int(tables.lens.max()) <= 16
    payloads[-1] = payloads[-1][: len(payloads[-1]) // 2]  # truncated
    counts = [b.size for b in blocks]
    counts[1] = 1000  # fewer than the block holds
    out, under, st, plens = _port_decode(payloads, tables, counts)
    jout, junder = pallas_decode(st, plens, tables, counts)
    np.testing.assert_array_equal(under, [False] * 5 + [True])
    np.testing.assert_array_equal(under, junder)
    for i, n in enumerate(counts[:-1]):
        np.testing.assert_array_equal(out[i, :n], blocks[i][:n],
                                      err_msg=f"row {i}")
        np.testing.assert_array_equal(out[i, :n], jout[i, :n])
        np.testing.assert_array_equal(
            out[i, :n], oracle.unpack(payloads[i], tables.row_strings(i), n))


@pytest.mark.parametrize("kind", ["all_8bit", "skewed_9_to_16_bits"])
def test_decode_state_widths_match_oracle(kind):
    """s_states 8 (all codes 8 bits) and 16, each on its own batch."""
    rng = np.random.default_rng(len(kind))
    blocks = _blocks(kind, rng)
    tables, payloads = _archive(blocks)
    ml = int(tables.lens.max())
    assert ml == 8 if kind == "all_8bit" else 8 < ml <= 16
    out, under, _, _ = _port_decode(payloads, tables, [blocks[0].size])
    assert not under.any()
    np.testing.assert_array_equal(out[0, :blocks[0].size], blocks[0])
    np.testing.assert_array_equal(
        out[0, :blocks[0].size],
        oracle.unpack(payloads[0], tables.row_strings(0), blocks[0].size))


def test_backend_routes_17_to_32_bit_blocks_to_the_counted_host_decode(
        monkeypatch):
    """17-32-bit blocks take the K5 -> K6 -> K1 route beside a <=16-bit
    block, and host_decoded_blocks, which counts only the rows the backend
    sends to the host by design, does not move."""
    rng = np.random.default_rng(55)
    a = rng.integers(0, 256, 4000, dtype=np.uint8)
    wide = _canonical(list(range(1, 20)) + [20, 20])
    ta = codes_mod.build_code_tables(oracle.histogram(a)[None])
    tables = codes_mod.CodeTables(np.concatenate([ta.lens, wide.lens]),
                                  np.concatenate([ta.vals, wide.vals]))
    b = rng.integers(0, 21, 5000).astype(np.uint8)
    payloads = [oracle.pack(a, tables.lens[0], tables.vals[0]),
                oracle.pack(b, tables.lens[1], tables.vals[1])]
    calls = []
    real = decode.decode_batch32

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)
    monkeypatch.setattr(decode, "decode_batch32", counted)
    before = TorchBackend.host_decoded_blocks
    out = TorchBackend("cpu").fused_decode(payloads, tables, [a.size, b.size],
                                           expand=False)
    assert TorchBackend.host_decoded_blocks == before
    assert len(calls) == 1 and calls[0][0] == 1  # the 17-32-bit row alone
    np.testing.assert_array_equal(out[0], a)
    np.testing.assert_array_equal(out[1], b)


def test_backend_underrun_raises_file_unrecognizable():
    from shafa_tpu_torch.errors import FileUnrecognizableError
    rng = np.random.default_rng(44)
    b0 = rng.integers(0, 256, 2048, dtype=np.uint8)
    tables, payloads = _archive([b0])
    with pytest.raises(FileUnrecognizableError):
        TorchBackend("cpu").fused_decode([payloads[0][:100]], tables,
                                         [b0.size], expand=False)
