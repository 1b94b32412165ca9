"""K4's design (csrc/expand.cu) emulated in numpy at tile sizes of 4, 5, 64
and 4096 RLE bytes, against the port's token_fields and the JAX package's
_token_fields, rle_expand_prep and rle_expand_pages_reference (whose
truncated triples read their missing fields as 0, where the numpy oracle
drops them).

Pass A: each tile's summary, for entry states 0, 1, 2, the exit state and
the counts of the tokens that start in it (a token in the tile's last two
bytes reads its fields from the next tile). Summaries compose in row order;
the composition is checked associative on every row. Pass B: every tile's
entry state and output offset from state 0. Pass C: each tile's tokens from
its entry state, placed at its offset; the tiles' spans must cover the
rows' output exactly once. Inputs: test_torch_rle.EXPAND_CASES and
chip_smoke.k4_edge_rows (escapes at each of a tile's last three bytes,
truncated triples, counts 0 and 255, rows of 0-3 bytes, an all-escape row).
A thread's share of pass A and C (its 16 bytes' token starts, counts and
exit state found with bit masks, expand.cu::chain) is held against the
byte walk on random groups.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shafa_tpu.kernels import expand_pallas as jexp
from shafa_tpu.kernels import rle as jrle
from shafa_tpu_torch.kernels import rle

from chip_smoke import k4_edge_rows
from test_torch_rle import EXPAND_CASES, _stack

TILES = [4, 5, 64, 4096]


def _walk(row, n, lo, hi, q):
    """The tokens that start in row[lo:hi] entered in state q: ([(position,
    symbol, count)], exit state). Fields past n read as 0."""
    def field(i):
        return int(row[i]) if i < n else 0
    toks = []
    for i in range(lo, min(hi, n)):
        if q:
            q -= 1
        elif row[i]:
            toks.append((i, int(row[i]), 1))
        else:
            toks.append((i, field(i + 1), max(field(i + 2), 1)))
            q = 2
    return toks, q


def _summary(row, n, lo, hi):
    """Pass A of one tile: (exit states, count sums) for entries 0, 1, 2."""
    f, c = [], []
    for e in range(3):
        toks, q = _walk(row, n, lo, hi, e)
        f.append(q)
        c.append(sum(t[2] for t in toks))
    return tuple(f), tuple(c)


def _combine(a, b):
    """a then b."""
    return (tuple(b[0][a[0][s]] for s in range(3)),
            tuple(a[1][s] + b[1][a[0][s]] for s in range(3)))


def _tree(sums):
    """The summaries combined pairwise, another bracketing than a left
    fold."""
    while len(sums) > 1:
        sums = [_combine(*sums[i:i + 2]) if i + 1 < len(sums) else sums[i]
                for i in range(0, len(sums), 2)]
    return sums[0]


def _emulate(x, lens, tile):
    """K4's passes on (B, P) rows: per row (tokens as (position, symbol,
    count) in tile order, expanded size), and the output, with the number
    of times each output byte was written."""
    b, p = x.shape
    n_tiles = -(-p // tile)
    rows, sizes = [], []
    for r in range(b):
        n = min(int(lens[r]), p)
        sums = [_summary(x[r], n, k * tile, (k + 1) * tile)
                for k in range(n_tiles)]
        left = functools.reduce(_combine, sums)
        assert _tree(sums) == left  # associative
        q, base, toks = 0, 0, []
        for k, (f, c) in enumerate(sums):  # pass B, then pass C's walk
            tile_toks, exit_q = _walk(x[r], n, k * tile, (k + 1) * tile, q)
            assert exit_q == f[q]
            assert sum(t[2] for t in tile_toks) == c[q]
            toks += [(i, s, cnt, base) for i, s, cnt in tile_toks]
            base += c[q]
            q = f[q]
        assert base == left[1][0]
        rows.append(toks)
        sizes.append(base)
    row_base = np.cumsum(sizes) - sizes
    out = np.zeros(int(sum(sizes)), np.uint8)
    written = np.zeros(out.size, np.int64)
    for r, toks in enumerate(rows):
        off = int(row_base[r])
        for _, s, cnt, _ in toks:
            out[off:off + cnt] = s
            written[off:off + cnt] += 1
            off += cnt
    return rows, np.array(sizes, np.int64), out, written


def _cases():
    cases = {f"expand_{k}": f for k, f in EXPAND_CASES.items()}
    cases["edge_rows"] = None
    return sorted(cases)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("case", _cases())
def test_tile_design_matches_token_fields_and_jax(case, tile):
    if case == "edge_rows":
        rows = k4_edge_rows(tile, seed=tile)
    else:
        name = case[len("expand_"):]
        rows = EXPAND_CASES[name](np.random.default_rng(
            sorted(EXPAND_CASES).index(name)))
    x, lens = _stack(rows)
    toks, sizes, out, written = _emulate(x, lens, tile)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lens)
    is_tok, sym, cnt = (t.numpy() for t in rle.token_fields(xt, lt))
    jtok, jsym, jcnt = (np.asarray(t) for t in jrle._token_fields(
        jnp.asarray(x), jnp.asarray(lens)))
    np.testing.assert_array_equal(is_tok, jtok)
    jprep = {k: np.asarray(v) for k, v in jexp.rle_expand_prep(
        jnp.asarray(x), jnp.asarray(lens)).items()}
    np.testing.assert_array_equal(sizes, jprep["out_len"])
    for r, row_toks in enumerate(toks):
        pos = np.array([t[0] for t in row_toks], np.int64)
        np.testing.assert_array_equal(pos, np.flatnonzero(is_tok[r]))
        np.testing.assert_array_equal([t[1] for t in row_toks], sym[r, pos])
        np.testing.assert_array_equal([t[1] for t in row_toks], jsym[r, pos])
        np.testing.assert_array_equal([t[2] for t in row_toks], cnt[r, pos])
        np.testing.assert_array_equal([t[2] for t in row_toks], jcnt[r, pos])
        # the token's offset in its row: its tile's base and the counts
        # before it in the tile, as the JAX prep's exclusive sums give it
        within = {}
        for i, _, c, base in row_toks:
            k = i // tile
            start = base + within.get(k, 0)
            within[k] = within.get(k, 0) + c
            assert start == jprep["cum"][r, i] - c
    assert (written == 1).all()
    ref, ref_lens = jexp.rle_expand_pages_reference(
        x, lens, -(-max(1, int(sizes.max())) // 4) * 4)
    ref = np.asarray(ref).view(np.uint8).reshape(x.shape[0], -1)
    np.testing.assert_array_equal(ref_lens, sizes)
    assert out.tobytes() == b"".join(ref[r, :n].tobytes()
                                     for r, n in enumerate(sizes))


def _zero_mask(words, v):
    """expand.cu::zero_mask: __vcmpeq4 marks each 0x00 byte 0xFF, the
    multiply gathers a word's 4 marks into 4 bits."""
    z = 0
    for k, w in enumerate(words):
        marks = sum(0xFF << (8 * j) for j in range(4)
                    if (w >> (8 * j)) & 255 == 0)
        e = (marks >> 7) & 0x01010101
        z |= ((((e * 0x00204081) & 0xFFFFFFFF) >> 21) & 0xF) << (4 * k)
    return z & ((1 << v) - 1)


def _chain(b, zero, v, e, n):
    """expand.cu::chain: every valid byte from e on starts a token but for
    the payloads of the escapes met, visited by their 0x00 bytes only."""
    starts = ((1 << v) - 1) & ~((1 << e) - 1) if v > e else 0
    last, extra = e - 3, 0
    z = zero & starts
    while z:
        p = (z & -z).bit_length() - 1
        starts &= ~(6 << p)
        extra += max(int(b[p + 2]) if p + 2 < n else 0, 1) - 1
        last = p
        z = zero & starts & ~((2 << p) - 1)
    return starts, bin(starts).count("1") + extra, max(last + 3 - v, 0)


@pytest.mark.parametrize("zeros", [0.0, 0.02, 0.3, 0.9])
def test_thread_chain_matches_byte_walk(zeros):
    rng = np.random.default_rng(int(zeros * 100))
    for _ in range(3000):
        b = np.where(rng.random(20) < zeros, 0,
                     rng.integers(1, 256, 20)).astype(np.uint8)
        n = int(rng.choice([20, 18, 17, 16, 15, 3, 1]))  # valid bytes
        v = min(n, 16)
        words = [int(b[4 * k:4 * k + 4].view("<u4")[0]) for k in range(4)]
        zero = _zero_mask(words, v)
        assert zero == sum(1 << i for i in range(v) if b[i] == 0)
        for e in range(3):
            toks, q = _walk(b, n, 0, 16, e)
            assert _chain(b, zero, v, e, n) == (
                sum(1 << t[0] for t in toks), sum(t[2] for t in toks), q)
