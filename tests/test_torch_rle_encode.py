"""K8's design (csrc/rle_encode.cu) emulated in numpy at tiles of 16, 64 and
256 input bytes (4, 16 and 16 bytes a thread), against the numpy oracle
(shafa_tpu.oracle.rle_encode, oracle.histogram) and the port's plain
version (rle.rle_encode_hist on the CPU).

Pass A: each tile's last run start. Pass B: an exclusive max-scan over a
row's tiles, the run start in force at each tile's first byte. Pass C1:
each tile's threads take their run start in force and the next run start
after their bytes from the tile's scans and the 254 bytes past the tile,
mark their sub-run starts with a counter modulo 255, and count the bytes
of the sub-runs that start in them. Pass B2: each tile's output offset in
its row. Pass C2: each thread's bytes at its offset; the tiles' spans must
cover each row's output once, and the histogram is the count of the bytes
the threads write. Inputs: chip_smoke.k8_edge_rows at each tile size and
test_torch_rle's corpus rows. A thread's run-start mask, found with byte
compares and a multiply (rle_encode.cu::load_chunk), is held against a byte
walk on random chunks.
"""

import numpy as np
import pytest
import torch

from shafa_tpu import oracle
from shafa_tpu_torch.kernels import rle

from chip_smoke import k8_edge_rows
from test_torch_rle import _encode_rows, _stack

MAX_RUN = 255
HALO = MAX_RUN - 1
#: (tile bytes, bytes a thread), and the edge rows' width at that tile
TILES = [(16, 4, 4096), (64, 16, 4096), (256, 16, 8192)]


def _chunk(row, n, j0, items):
    """A thread's valid bytes and its run-start mask (bit i: byte j0 + i)."""
    v = max(min(n - j0, items), 0)
    starts = 0
    for i in range(v):
        if j0 + i == 0 or row[j0 + i] != row[j0 + i - 1]:
            starts |= 1 << i
    return v, starts


def _low(m):
    return (m & -m).bit_length() - 1


def _tile_threads(row, n, tile0, tile, items, entry):
    """Pass C of one tile entered with run start entry: each thread's
    output bytes, in thread order."""
    threads = tile // items
    chunks = [(tile0 + items * k, *_chunk(row, n, tile0 + items * k, items))
              for k in range(threads)]
    tile_end = tile0 + tile
    halo_next = min(tile_end + HALO, n)
    for j in range(tile_end, min(tile_end + HALO, n)):
        if row[j] != row[j - 1]:
            halo_next = j
            break
    pre = [j0 + s.bit_length() - 1 if s else -1 for j0, _, s in chunks]
    suf = [j0 + _low(s) if s else np.inf for j0, _, s in chunks]
    out = []
    for k, (j0, v, starts) in enumerate(chunks):
        run_start = max([entry] + pre[:k])
        next_after = min(suf[k + 1:] + [halo_next])
        cnt = (j0 - 1 - run_start) % MAX_RUN if j0 > 0 else 0
        subs = 0
        for i in range(v):
            cnt = 0 if starts >> i & 1 else (0 if cnt == MAX_RUN - 1
                                             else cnt + 1)
            if cnt == 0:
                subs |= 1 << i
        mine = []
        while subs:
            i = _low(subs)
            later = starts & ~((2 << i) - 1)
            nxt = j0 + _low(later) if later else next_after
            sym, length = int(row[j0 + i]), min(nxt - (j0 + i), MAX_RUN)
            mine += ([0, sym, length] if length >= 4 or sym == 0
                     else [sym] * length)
            subs &= subs - 1
        out.append(mine)
    return out


def _emulate(x, lens, tile, items):
    """K8's passes over a (B, P) batch: (enc rows, out_len, hist)."""
    b, p = x.shape
    n_tiles = -(-p // tile)
    stride = rle.rle_out_bound(p)
    enc = np.full((b, stride), 0xEE, np.uint8)  # unwritten bytes show
    written = np.zeros((b, stride), np.int64)
    out_len = np.zeros(b, np.int64)
    hist = np.zeros((b, 256), np.int64)
    for r in range(b):
        n = min(max(int(lens[r]), 0), p)
        # A, then B: the run start in force at each tile's first byte
        last = [max([-1] + [j0 + s.bit_length() - 1 for j0, _, s in (
            (t * tile + items * k,
             *_chunk(x[r], n, t * tile + items * k, items))
            for k in range(tile // items)) if s]) if t * tile < n else -1
            for t in range(n_tiles)]
        entry = [max([-1] + last[:t]) for t in range(n_tiles)]
        # C1, B2, C2
        per_tile = [_tile_threads(x[r], n, t * tile, tile, items, entry[t])
                    if t * tile < n else [] for t in range(n_tiles)]
        counts = [sum(map(len, th)) for th in per_tile]
        base = np.cumsum([0] + counts)
        for t, threads in enumerate(per_tile):
            pos = int(base[t])
            for mine in threads:
                enc[r, pos:pos + len(mine)] = mine
                written[r, pos:pos + len(mine)] += 1
                for v in mine:
                    hist[r, v] += 1
                pos += len(mine)
        out_len[r] = base[-1]
        assert (written[r, :base[-1]] == 1).all()
        assert not written[r, base[-1]:].any()
    return enc, out_len, hist


@pytest.mark.parametrize("tile,items,width", TILES)
@pytest.mark.parametrize("case", ["edge", "corpus"])
def test_tile_design_matches_oracle_and_plain_version(case, tile, items,
                                                      width):
    if case == "edge":
        x, lens = k8_edge_rows(tile, width, seed=tile)
    else:
        x, lens = _stack(_encode_rows())
    enc, out_len, hist = _emulate(x, lens, tile, items)
    penc, plen, phist = rle.rle_encode_hist(torch.from_numpy(x),
                                            torch.from_numpy(lens))
    np.testing.assert_array_equal(out_len, plen.numpy())
    np.testing.assert_array_equal(hist, phist.numpy())
    for r, n in enumerate(lens):
        want = oracle.rle_encode(x[r, :n])
        assert out_len[r] == want.size, f"row {r}"
        np.testing.assert_array_equal(enc[r, :want.size], want,
                                      err_msg=f"row {r}")
        np.testing.assert_array_equal(hist[r], oracle.histogram(want))
        np.testing.assert_array_equal(penc[r, :want.size].numpy(), want)


def _mask_by_words(b, prev, v):
    """load_chunk's run-start mask: each 4-byte word against itself shifted
    by one byte (its byte before in the low byte), a per-byte compare
    (__vcmpne4), and the 4 compare bits gathered by a multiply."""
    words = b.view("<u4").astype(np.uint64)
    m = 0
    for k in range(4):
        w = int(words[k])
        shifted = ((w << 8) | prev) & 0xFFFFFFFF
        prev = w >> 24
        ne = sum(0xFF << (8 * i) for i in range(4)
                 if (w >> (8 * i)) & 0xFF != (shifted >> (8 * i)) & 0xFF)
        e = (ne >> 7) & 0x01010101
        m |= (((e * 0x00204081) & 0xFFFFFFFF) >> 21 & 0xF) << (4 * k)
    return m & ((1 << v) - 1)


@pytest.mark.parametrize("alphabet", [2, 3, 256])
def test_thread_run_start_mask_matches_byte_walk(alphabet):
    rng = np.random.default_rng(alphabet)
    for _ in range(400):
        row = rng.integers(0, alphabet, 48).astype(np.uint8)
        j0 = int(rng.choice([0, 16, 32]))
        v = int(rng.integers(0, 17))
        prev = int(row[j0 - 1]) if j0 else (~int(row[0])) & 0xFF
        got = _mask_by_words(row[j0:j0 + 16].copy(), prev, v)
        assert got == _chunk(row, j0 + v, j0, 16)[1]
