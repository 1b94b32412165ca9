"""RLE encode (K8's entry, plain on the CPU), the histogram, the token scan
and the run expansion (K4's entry, plain on the CPU) of shafa_tpu_torch
against the JAX package: its Pallas kernels in interpret mode, its XLA
stages and its numpy oracles. Same inputs from numpy seeds, tests/corpus.py
and chip_smoke.k8_edge_rows; exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shafa_tpu import oracle
from shafa_tpu.kernels import expand_pallas as jexp
from shafa_tpu.kernels import histogram as jhist
from shafa_tpu.kernels import rle as jrle
from shafa_tpu_torch.kernels import _build, expand, histogram, rle

from chip_smoke import k8_edge_rows
from corpus import edge_cases, mixed, runs_heavy


def _stack(rows, minimum=256):
    p = max(minimum, 1 << (max(r.size for r in rows) - 1).bit_length())
    x = np.zeros((len(rows), p), np.uint8)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        x[i, :r.size] = r
        lens[i] = r.size
    return x, lens


def _encode_rows():
    rows = [np.frombuffer(v, np.uint8) for _, v in sorted(
        edge_cases().items())]
    rows += [np.frombuffer(mixed(3000, seed=s), np.uint8) for s in (1, 2)]
    rows.append(np.frombuffer(runs_heavy(2500, seed=3), np.uint8))
    return rows


def test_rle_encode_matches_pallas_and_oracle():
    rows = _encode_rows()
    x, lens = _stack(rows)
    enc, out_len = rle.rle_encode_batch(torch.from_numpy(x),
                                        torch.from_numpy(lens))
    assert enc.shape == (x.shape[0], rle.rle_out_bound(x.shape[1]))
    jenc, jlen = jrle.rle_encode_batch_pallas(jnp.asarray(x),
                                              jnp.asarray(lens),
                                              interpret=True)
    jenc, jlen = np.asarray(jenc), np.asarray(jlen)
    np.testing.assert_array_equal(out_len.numpy(), jlen)
    for i, r in enumerate(rows):
        want = oracle.rle_encode(r)
        n = int(out_len[i])
        assert n == want.size
        np.testing.assert_array_equal(enc[i, :n].numpy(), want,
                                      err_msg=f"row {i}")
        np.testing.assert_array_equal(enc[i, :n].numpy(), jenc[i, :n])


#: K8's inputs at CPU size: the corpus rows, and k8_edge_rows at tiles of
#: 64 and 256 bytes (runs across tiles, 0x00 runs of 1-3 and 254-511 bytes,
#: lengths 0-3 and tile +- 1, bytes past each length equal to the last)
ENCODE_HIST_CASES = {
    "corpus": lambda: _stack(_encode_rows()),
    "edge_tile64": lambda: k8_edge_rows(64, 4096, seed=3),
    "edge_tile256": lambda: k8_edge_rows(256, 8192, seed=4),
}


@pytest.mark.parametrize("case", sorted(ENCODE_HIST_CASES))
def test_rle_encode_hist_matches_pallas_histogram_and_oracle(case):
    x, lens = ENCODE_HIST_CASES[case]()
    enc, out_len, hist = rle.rle_encode_hist(torch.from_numpy(x),
                                             torch.from_numpy(lens))
    assert enc.shape == (x.shape[0], rle.rle_out_bound(x.shape[1]))
    assert out_len.dtype == hist.dtype == torch.int64
    jenc, jlen = jrle.rle_encode_batch_pallas(jnp.asarray(x),
                                              jnp.asarray(lens),
                                              interpret=True)
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(
        hist.numpy(), np.asarray(jhist.histogram_batch(jenc, jlen)))
    jenc = np.asarray(jenc)
    for i, n in enumerate(lens):
        want = oracle.rle_encode(x[i, :n])
        assert int(out_len[i]) == want.size, f"row {i}"
        np.testing.assert_array_equal(enc[i, :want.size].numpy(), want,
                                      err_msg=f"row {i}")
        np.testing.assert_array_equal(jenc[i, :want.size], want)
        np.testing.assert_array_equal(hist[i].numpy(),
                                      oracle.histogram(want))


@pytest.mark.parametrize("missing", ["library", "cuda_tensor"])
def test_rle_encode_hist_off_the_cpu_never_takes_the_plain_version(
        missing, monkeypatch, tmp_path):
    """Tensors off the CPU go to K8: without its library (here no nvcc),
    or given tensors that are not CUDA tensors, the wrapper raises."""
    def plain(*args):
        raise AssertionError("the plain version ran off the CPU")
    monkeypatch.setattr(rle, "rle_encode_hist_plain", plain)
    x = torch.zeros((2, 256), dtype=torch.uint8, device="meta")
    lens = torch.zeros(2, dtype=torch.int32, device="meta")
    launched = _build.launches["rle_encode"]
    if missing == "library":
        def no_nvcc():
            raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                               "built")
        monkeypatch.setattr(_build, "ptr", lambda t, *args: 0)
        monkeypatch.setattr(_build, "_lib", None)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build, "_nvcc", no_nvcc)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            rle.rle_encode_hist(x, lens)
    else:
        with pytest.raises(ValueError, match="CUDA tensors only"):
            rle.rle_encode_hist(x, lens)
    assert _build.launches["rle_encode"] == launched


def test_rle_analyze_matches_jax():
    x, lens = _stack(_encode_rows()[:6])
    got = rle._rle_analyze(torch.from_numpy(x), torch.from_numpy(lens))
    want = jrle._rle_analyze(jnp.asarray(x), jnp.asarray(lens))
    for name, g, w in zip(("xi", "valid", "sub_start", "sub_len", "escaped",
                           "contrib"), got, want):
        w = np.asarray(w)
        valid = np.asarray(want[1])
        # sub_len is only defined on valid lanes (both mask it by length)
        if name == "sub_len":
            g, w = g.numpy()[valid], w[valid]
        else:
            g = g.numpy()
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_histogram_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, size=(3, 5000), dtype=np.uint8)
    x[1, :4000] = 9
    lens = np.array([5000, 4100, 0], np.int32)
    got = histogram.histogram_batch(torch.from_numpy(x),
                                    torch.from_numpy(lens))
    assert got.dtype == torch.int64
    want = np.asarray(jhist.histogram_batch(jnp.asarray(x),
                                            jnp.asarray(lens)))
    np.testing.assert_array_equal(got.numpy(), want)


def _rle_stream(rng, n):
    """Random but valid RLE stream bytes (complete escape triples)."""
    out = bytearray()
    while len(out) < n:
        if rng.random() < 0.4:
            out += bytes([0, int(rng.integers(0, 256)),
                          int(rng.integers(0, 256))])
        else:
            out.append(int(rng.integers(1, 256)))
    return np.frombuffer(bytes(out[:n]), np.uint8)  # may cut a triple


EXPAND_CASES = {
    "literals": lambda rng: [np.arange(1, 200, dtype=np.uint8)],
    "escapes": lambda rng: [np.frombuffer(
        b"\x00A\xff\x00B\x04\x00\x00\x01C", np.uint8)],
    "multi_row_mixed": lambda rng: [
        _rle_stream(rng, int(rng.integers(300, 5000))) for _ in range(5)],
    "big_runs_cross_pages": lambda rng: [np.frombuffer(b"".join(
        bytes([0, s % 256, 255]) for s in range(1, 200)), np.uint8)] * 2,
    "row_boundary": lambda rng: [
        np.frombuffer(b"\x00Q\x07", np.uint8),
        np.frombuffer(b"\x00Z\xff" * 40, np.uint8)],
    "empty_and_tiny_rows": lambda rng: [
        np.zeros(0, np.uint8), np.frombuffer(b"A", np.uint8),
        np.frombuffer(b"\x00\x00\x00", np.uint8)],
}


@pytest.mark.parametrize("case", sorted(EXPAND_CASES))
def test_expand_matches_pallas_and_reference(case):
    rng = np.random.default_rng(sorted(EXPAND_CASES).index(case))
    x, lens = _stack(EXPAND_CASES[case](rng))
    _, ref_lens = jexp.rle_expand_pages_reference(x, lens, jexp.PAGE_B)
    out_p = -(-max(1, int(ref_lens.max())) // jexp.PAGE_B) * jexp.PAGE_B
    ref_words, _ = jexp.rle_expand_pages_reference(x, lens, out_p)
    ref = np.asarray(ref_words).view(np.uint8).reshape(x.shape[0], -1)
    jw, jl = jexp.rle_expand_pages(jnp.asarray(x), jnp.asarray(lens), out_p,
                                   interpret=True)
    jb = np.asarray(jw).view(np.uint8).reshape(x.shape[0], -1)
    dev_sizes = expand.rle_expand_sizes(torch.from_numpy(x),
                                        torch.from_numpy(lens))
    sizes = dev_sizes["out_len"].numpy()
    np.testing.assert_array_equal(sizes, ref_lens)
    np.testing.assert_array_equal(sizes, np.asarray(jl))
    flat = expand.rle_expand(dev_sizes, int(sizes.sum())).numpy()
    starts = np.cumsum(sizes) - sizes
    for r, n in enumerate(ref_lens):
        row = flat[starts[r]:starts[r] + n]
        np.testing.assert_array_equal(row, ref[r, :n], err_msg=f"row {r}")
        np.testing.assert_array_equal(row, jb[r, :n])


def test_expand_prep_fields_match_jax():
    rng = np.random.default_rng(7)
    rows = [_rle_stream(rng, int(rng.integers(100, 3000))) for _ in range(4)]
    rows.append(np.zeros(0, np.uint8))
    x, lens = _stack(rows)
    prep = expand.rle_expand_prep(torch.from_numpy(x), torch.from_numpy(lens))
    jprep = {k: np.asarray(v) for k, v in jexp.rle_expand_prep(
        jnp.asarray(x), jnp.asarray(lens)).items()}
    for k in ("cum", "out_len", "out_base"):
        np.testing.assert_array_equal(prep[k].numpy(), jprep[k], err_msg=k)
    is_tok, _, cnt = rle.token_fields(torch.from_numpy(x),
                                      torch.from_numpy(lens))
    jtok, _, _ = jrle._token_fields(jnp.asarray(x), jnp.asarray(lens))
    tok = is_tok.numpy()
    np.testing.assert_array_equal(tok, np.asarray(jtok))
    # the token's symbol and its global start offset, lane by lane
    np.testing.assert_array_equal(prep["sym"].numpy()[tok],
                                  jprep["fill"][tok] & 255)
    start = (prep["out_base"][:, None] + prep["cum"] - cnt).numpy()
    np.testing.assert_array_equal(start[tok], jprep["off"][tok])


def test_token_starts_match_oracle_chain():
    """The composition scan finds the oracle's token chain."""
    rng = np.random.default_rng(9)
    rows = [_rle_stream(rng, 4000), np.frombuffer(b"\x00" * 3000, np.uint8)]
    x, lens = _stack(rows)
    starts = rle.token_starts(torch.from_numpy(x).to(torch.int32)).numpy()
    for i, r in enumerate(rows):
        step = np.where(r == 0, 3, 1).astype(np.int64)
        want = np.zeros(r.size, bool)
        want[oracle._orbit_of_zero(step, r.size)] = True
        np.testing.assert_array_equal(starts[i, :r.size], want)
