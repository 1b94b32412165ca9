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


@pytest.fixture(scope="module")
def batch():
    """The batch, K5's planes from the port (plain) and from the JAX
    package's Pallas kernel (interpret mode)."""
    tables, blocks, payloads, counts, st, plens = _batch(
        np.random.default_rng(17))
    w32 = decode.windows32_bytes(torch.from_numpy(st))
    pc32, ls, ncodes = decode.rank_tables32(
        decode.decode_tables_batch(tables.lens, tables.vals))
    planes = decode.rank_planes32(w32, torch.from_numpy(pc32),
                                  torch.from_numpy(ls),
                                  torch.from_numpy(ncodes))
    jw = jnp.asarray(w32.numpy())
    ln8, sym8 = jdec.rank_planes32_pallas(
        jw, jnp.pad(jw[:, 1:], ((0, 0), (0, 1))),
        *jdec.rank_tables32(jdec.decode_tables_batch(tables.lens,
                                                     tables.vals)),
        interpret=True)
    return dict(tables=tables, blocks=blocks, payloads=payloads,
                counts=counts, st=st, plens=plens, planes=planes,
                tabs=(pc32, ls, ncodes), ln8=np.asarray(ln8),
                sym8=np.asarray(sym8))


def test_rank_planes32_matches_pallas(batch):
    """K5's sym | len << 8 planes, split into the JAX kernel's i8 length and
    symbol planes, on tables of at most 24 bits (below the JAX kernel's
    window fault)."""
    planes = batch["planes"].numpy()
    np.testing.assert_array_equal(((planes >> 8) & 63).astype(np.int8),
                                  batch["ln8"])
    np.testing.assert_array_equal(
        (planes & 255).astype(np.uint8).view(np.int8), batch["sym8"])


def test_fsm32_packs_match_pallas(batch):
    """K6's four pack arrays and underrun flag against
    _stage2_chain_planes(..., 32): lanes within each row's payload equal
    (the JAX kernel leaves the tiles past it unwritten); the port's lanes
    past it are zero."""
    b, p = batch["st"].shape
    got = decode.fsm32_packs(batch["planes"],
                             torch.from_numpy(batch["plens"]),
                             torch.from_numpy(batch["counts"]))
    want = jdec._stage2_chain_planes(
        jnp.asarray(batch["ln8"]), jnp.asarray(batch["sym8"]), b, p,
        jnp.asarray(batch["plens"]), jnp.asarray(batch["counts"]), 32,
        interpret=True)
    valid = np.arange(p)[None, :] < batch["plens"][:, None]
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy()[valid], np.asarray(w)[valid])
        assert not g.numpy()[~valid].any()
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert got[4].tolist() == [False, True, False]


def test_decode_batch32_matches_oracle(batch):
    out, under = decode.decode_batch32(
        torch.from_numpy(batch["st"]), torch.from_numpy(batch["plens"]),
        *map(torch.from_numpy, batch["tabs"]),
        torch.from_numpy(batch["counts"]),
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
    pc32, ls, ncodes = decode.rank_tables32(
        decode.decode_tables_batch(tables.lens, tables.vals))
    out, under = decode.decode_batch32(
        torch.from_numpy(st), torch.from_numpy(plens),
        torch.from_numpy(pc32), torch.from_numpy(ls),
        torch.from_numpy(ncodes), torch.tensor([blk.size], dtype=torch.int32),
        _bucket(blk.size))
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
    before = TorchBackend.host_decoded_blocks
    out = TorchBackend("cpu").fused_decode(
        payloads, tables, [r.size for r in rows], expand=expand)
    assert TorchBackend.host_decoded_blocks == before + 2
    for i, r in enumerate(rows):
        dec = oracle.unpack(payloads[i], tables.row_strings(i), r.size)
        want = oracle.rle_expand(dec) if expand else dec
        np.testing.assert_array_equal(out[i], want, err_msg=f"row {i}")
