"""K8's one-pass design (csrc/rle_encode.cu) emulated in numpy at tiles of
16, 64 and 256 input bytes (4, 16, and 16 or 32 bytes a thread), against
the numpy oracle (shafa_tpu.oracle.rle_encode, oracle.histogram) and the
port's plain version (rle.rle_encode_hist on the CPU).

Persistent blocks take tiles from a ticket, the rows' tiles interleaved
(ticket t: tile t // B of row t % B), each block its next ticket once its
tile's offset is known. Each tile is a generator that a seeded scheduler
steps among the blocks in any order; a tile that must wait on a status word
that has not been published yields. A tile loads its threads' bytes and the
256 bytes past it (the halo, clipped at the row's length), finds the run
start in force at its first byte by a max look-back (a tile with a run start
publishes its last one as its prefix at once; one without publishes an
empty aggregate, walks back and publishes the prefix it found), classifies
each thread's bytes with the kernel's bit masks (plan: sub-run starts, the
255 split, escaped starts, the smear of escaped sub-runs, literals), takes
its output offset from a sum look-back, and stages and stores its bytes as
the kernel does (16 literals as words shifted into place, others byte by
byte; 16-byte words, the edge words byte by byte). Every status word read
must belong to a smaller ticket; the rows' bytes must be written once each;
the histogram is the count of the bytes the threads write. A scheduler that
finds every block waiting fails. Inputs: chip_smoke.k8_edge_rows at each
tile size and test_torch_rle's corpus rows; one case holds a seeded set of
tiles after their aggregates for many steps, so that later tiles walk back
past them. A thread's run-start mask, found with byte compares and a
multiply (rle_encode.cu::load_chunk), and its plan are held against byte
walks on random chunks.
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
HALO_BYTES = 256
STAGE_LEAD = 16
WARP = 32
M32 = 0xFFFFFFFF
AGGREGATE, PREFIX = 1, 2
#: (tile bytes, bytes a thread), and the edge rows' width at that tile; the
#: kernel's threads take 32 bytes each
TILES = [(16, 4, 4096), (64, 16, 4096), (256, 16, 8192), (256, 32, 8192)]


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


def _plan(row, j0, v, starts, rs, nxt, items):
    """rle_encode.cu::plan: (subs, esc, lit) bit masks of a thread's bytes,
    given the last run start before them and the first after them."""
    valid = (1 << v) - 1
    subs = starts
    carried_esc = False
    first = _low(starts) if starts else items
    if first > 0 and v > 0:
        m = (j0 - rs) % MAX_RUN
        if m == 0:
            subs |= 1
        else:
            if MAX_RUN - m < min(first, v):
                subs |= 1 << (MAX_RUN - m)
            s = j0 - m
            end = j0 + _low(subs) if subs else min(nxt, s + MAX_RUN)
            carried_esc = end - s >= 4 or row[j0] == 0
    zero = 0
    for i in range(0, items, 4):  # ne_bytes against 0, gathered
        w = int.from_bytes(bytes(row[j0 + i:j0 + i + 4]), "little")
        e = (~_ne_bytes(w, 0) & 0x80808080) >> 7
        zero |= (((e * 0x00204081) & M32) >> 21 & 0xF) << i
    dn = nxt - j0
    bound = subs | (1 << dn if 0 <= dn < 64 else 0)
    lng = ~((bound >> 1) | (bound >> 2) | (bound >> 3)) & M32
    esc = subs & (lng | zero) & valid
    g, pr, d = esc | int(carried_esc), ~subs & M32, 1
    while d < items:  # the segmented smear, log2(items) steps
        g |= pr & (g << d)
        pr &= pr << d
        d *= 2
    return subs, esc, valid & ~g


def _sub_len(j0, subs, i, nxt):
    later = subs & ~((2 << i) - 1)
    nx = j0 + _low(later) if later else nxt
    return min(nx - (j0 + i), MAX_RUN)


def _thread_bytes(row, j0, subs, esc, lit, nxt, items):
    """The thread's output: per byte in order, the triple at an escaped
    start, the byte at a literal."""
    out = []
    for i in range(items):
        if esc >> i & 1:
            out += [0, int(row[j0 + i]), _sub_len(j0, subs, i, nxt)]
        elif lit >> i & 1:
            out.append(int(row[j0 + i]))
    return out


def _stage(stage, written, o, row, j0, items, lit, mine):
    """The thread's bytes into the staging buffer from byte o on: all
    literals as words shifted into place (full words, then the two edge
    words byte by byte), else byte by byte."""
    if lit == (1 << items) - 1:
        sh, wp = o & 3, o >> 2
        full = range(items // 4) if sh == 0 else range(1, items // 4)
        spans = [(4 * (wp + m), 4) for m in full]
        if sh:
            spans += [(o, 4 - sh), (4 * (wp + items // 4), sh)]
        for lo, n in spans:
            for q in range(lo, lo + n):
                stage[q] = row[j0 + q - o]
                written[q] += 1
    else:
        for q, b in enumerate(mine):
            stage[o + q] = b
            written[o + q] += 1


class _Run:
    """Status words, output and counters of one emulated launch."""

    def __init__(self, x, lens, tile, items, stall):
        self.x, self.tile, self.items = x, tile, items
        self.b, p = x.shape
        self.n_tiles = -(-p // tile)
        self.lens = [min(max(int(n), 0), p) for n in lens]
        self.st = [[[None] * self.n_tiles for _ in range(self.b)]
                   for _ in range(2)]
        self.enc = np.full((self.b, rle.rle_out_bound(p)), 0xEE, np.uint8)
        self.written = np.zeros(self.enc.shape, np.int64)
        self.out_len = np.zeros(self.b, np.int64)
        self.hist = np.zeros((self.b, 256), np.int64)
        self.stall = stall  # tickets held after their aggregates
        self.walked_past = 0  # aggregates that a look-back walked past

    def look_back(self, plane, row, k, ticket, fold):
        """Warp 0's look-back: the fold of the values of tiles before k
        back to the nearest prefix, waiting (yield) while one of them has
        published nothing."""
        st = self.st[plane][row]
        acc, end = 0, k
        while True:
            lanes = range(end - 1, max(end - 1 - WARP, -1), -1)
            while True:
                words = [st[t] for t in lanes]
                for t in lanes:
                    assert t * self.b + row < ticket, "a later ticket read"
                pre = [i for i, w in enumerate(words) if w and w[0] == PREFIX]
                upto = pre[0] + 1 if pre else len(words)
                if all(words[:upto]):
                    break
                yield "wait"
            self.walked_past += sum(w[0] == AGGREGATE for w in words[:upto])
            acc = fold([acc] + [w[1] for w in words[:upto]])
            if pre:
                return acc
            end -= WARP

    def tile_steps(self, ticket):
        """Ticket's tile, yielding "wait" while blocked, "stall" while it
        is held, and "take" when the block takes its next ticket."""
        row, k = ticket % self.b, ticket // self.b
        tile, items, n = self.tile, self.items, self.lens[row]
        xr = self.x[row]
        tile0, tile_end = k * tile, (k + 1) * tile
        chunks = [(tile0 + items * i, *_chunk(xr, n, tile0 + items * i,
                                              items))
                  for i in range(tile // items)]
        halo_end = min(tile_end + HALO, n)
        firsts = [j0 + _low(s) for j0, _, s in (
            (tile_end + items * i, *_chunk(xr, halo_end, tile_end + items * i,
                                           items))
            for i in range(HALO_BYTES // items)) if s]
        s_halo = min(firsts + [halo_end])
        pre = [j0 + s.bit_length() - 1 if s else -1 for j0, _, s in chunks]
        suf = [j0 + _low(s) if s else np.inf for j0, _, s in chunks]
        tile_last = max(pre)
        st1, st2 = self.st[0][row], self.st[1][row]
        st1[k] = (PREFIX, tile_last + 1) if tile_last >= 0 else (AGGREGATE,
                                                                 0)
        carry = -1
        if min(suf[:WARP]) != tile0:  # the first byte continues a run
            if ticket in self.stall and tile_last < 0:
                for _ in range(self.stall[ticket]):
                    yield "stall"
            carry = (yield from self.look_back(0, row, k, ticket, max)) - 1
            if tile_last < 0:
                st1[k] = (PREFIX, carry + 1)
        plans, out = [], []
        for i, (j0, v, starts) in enumerate(chunks):
            rs = max([carry] + pre[:i])
            nxt = min(suf[i + 1:] + [s_halo])
            subs, esc, lit = _plan(xr, j0, v, starts, rs, nxt, items)
            mine = _thread_bytes(xr, j0, subs, esc, lit, nxt, items)
            assert len(mine) == bin(lit).count("1") + 3 * bin(esc).count("1")
            plans.append((lit, mine))
            out += mine
        tot = len(out)
        if k == 0:
            st2[0], base = (PREFIX, tot), 0
        else:
            st2[k] = (AGGREGATE, tot)
            if ticket in self.stall:
                for _ in range(self.stall[ticket]):
                    yield "stall"
            base = yield from self.look_back(1, row, k, ticket, sum)
            st2[k] = (PREFIX, base + tot)
        if tile_end >= n:
            self.out_len[row] = base + tot
        yield "take"
        for b in out:  # literals, escape symbols and lengths, 0x00 marks
            self.hist[row, b] += 1
        lead = STAGE_LEAD  # the tile's output staged from here on
        stage = np.zeros(lead + 3 * tile + 32, np.uint8)
        written = np.zeros(stage.size, np.int64)
        o = lead
        for i, (lit, mine) in enumerate(plans):
            _stage(stage, written, o, xr, chunks[i][0], items, lit, mine)
            o += len(mine)
        assert (written[lead:lead + tot] == 1).all()
        assert not written[:lead].any() and not written[lead + tot:].any()
        # 16-byte words from base & ~15; the edge words byte by byte
        for w in range(base >> 4, -(-(base + tot) // 16)):
            for q in range(16 * w, 16 * w + 16):
                if base <= q < base + tot:
                    self.enc[row, q] = stage[q - (base - lead)]
                    self.written[row, q] += 1


def _emulate(x, lens, tile, items, seed, blocks=5, stall=None):
    """K8's launch over a (B, P) batch, its blocks stepped by a seeded
    scheduler: (enc rows, out_len, hist, look-back's aggregates passed).
    A block holds its tile and, from the tile's "take" on, its next one."""
    run = _Run(x, lens, tile, items, stall or {})
    rng = np.random.default_rng(seed)
    max_len = max(run.lens)
    total = run.b * run.n_tiles
    taken = [0]

    def take():
        taken[0] += 1
        return taken[0] - 1

    def tile_of(t):
        return t if t < total and (t // run.b) * tile < max_len else total

    def start(block):
        """The block's next tile; those past their row's length are
        skipped, each taking another ticket."""
        t = block["next"]
        while t < total and (t // run.b) * tile >= run.lens[t % run.b]:
            t = tile_of(take())
        block["gen"] = run.tile_steps(t) if t < total else None
        return block

    active = [start({"next": tile_of(take())}) for _ in range(blocks)]
    idle = 0
    while any(b["gen"] for b in active):
        block = active[int(rng.integers(len(active)))]
        if block["gen"] is None:
            continue
        try:
            step = next(block["gen"])
        except StopIteration:
            start(block)
            idle = 0
            continue
        if step == "take":
            block["next"] = tile_of(take())
        idle = idle + 1 if step == "wait" else 0
        assert idle < 100 * blocks, "every block waits: no progress"
    for r, n in enumerate(run.out_len):
        assert (run.written[r, :n] == 1).all()
        assert not run.written[r, n:].any()
    return run.enc, run.out_len, run.hist, run.walked_past


def _check(x, lens, enc, out_len, hist):
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


@pytest.mark.parametrize("tile,items,width", TILES)
@pytest.mark.parametrize("case", ["edge", "corpus"])
def test_tile_design_matches_oracle_and_plain_version(case, tile, items,
                                                      width):
    if case == "edge":
        x, lens = k8_edge_rows(tile, width, seed=tile)
    else:
        x, lens = _stack(_encode_rows())
    enc, out_len, hist, _ = _emulate(x, lens, tile, items, seed=tile)
    _check(x, lens, enc, out_len, hist)


@pytest.mark.parametrize("tile,items,width", TILES[:2])
def test_look_back_walks_past_tiles_that_published_only_aggregates(
        tile, items, width):
    """A seeded fifth of the tickets wait many steps after publishing their
    aggregates (of both carries), so that later tiles of their rows walk
    back past them; the one-byte and 0x00 rows hold tiles with no run
    start, whose carry comes from far back."""
    x, lens = k8_edge_rows(tile, width, seed=tile + 1)
    total = x.shape[0] * -(-x.shape[1] // tile)
    rng = np.random.default_rng(tile)
    stall = {int(t): 200 for t in rng.choice(total, total // 5,
                                             replace=False)}
    enc, out_len, hist, walked = _emulate(x, lens, tile, items, seed=7,
                                          blocks=8, stall=stall)
    assert walked > 0
    _check(x, lens, enc, out_len, hist)


def _ne_bytes(a, b):
    """rle_encode.cu::ne_bytes: bit 7 of each byte of a ^ b that is not 0
    (the low 7 bits carried into bit 7 by an add that stays in its
    byte)."""
    x = a ^ b
    return (x | ((x & 0x7F7F7F7F) + 0x7F7F7F7F)) & 0x80808080


def _mask_by_words(b, prev, v):
    """load_chunk's run-start mask: each 4-byte word against itself shifted
    by one byte (its byte before in the low byte), a per-byte compare
    (ne_bytes), and the 4 compare bits gathered by a multiply."""
    words = b.view("<u4").astype(np.uint64)
    m = 0
    for k in range(4):
        w = int(words[k])
        shifted = ((w << 8) | prev) & 0xFFFFFFFF
        prev = w >> 24
        e = (_ne_bytes(w, shifted) >> 7) & 0x01010101
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


@pytest.mark.parametrize("alphabet", [2, 3, 256])
def test_thread_plan_matches_lane_analysis(alphabet):
    """plan's literal and escaped-start masks against a byte walk of the
    whole row (each byte's sub-run, from its run start, cut every 255
    bytes): on rows of long and short runs, 0x00 among them, at thread
    offsets near 255 splits and at the row's end."""
    rng = np.random.default_rng(alphabet + 10)
    for _ in range(60):
        lengths = rng.choice([1, 2, 3, 4, 5, 200, 254, 255, 256, 600],
                             size=12)
        row = np.repeat(rng.integers(0, alphabet, 12).astype(np.uint8),
                        lengths)
        row = np.concatenate([row, np.zeros(32, np.uint8)])
        n = int(rng.integers(1, row.size - 32))
        runs, subs_at = [], []
        for j in range(n):
            if j == 0 or row[j] != row[j - 1]:
                runs.append(j)
            if (j - runs[-1]) % MAX_RUN == 0:
                subs_at.append(j)
        bounds = subs_at + [n]
        sub_of = np.searchsorted(subs_at, np.arange(n), side="right") - 1
        for j0, items in zip(rng.integers(0, n, 30), [16, 32] * 15):
            j0 = int(j0)
            v, starts = _chunk(row, n, j0, items)
            rs = max([r for r in runs if r < j0], default=-1)
            nxt = min([r for r in runs if r >= j0 + items] + [n])
            subs, esc, lit = _plan(row, j0, v, starts, rs, nxt, items)
            want_subs = want_esc = want_lit = 0
            for i in range(v):
                s = sub_of[j0 + i]
                length = bounds[s + 1] - subs_at[s]
                escaped = length >= 4 or row[j0 + i] == 0
                if subs_at[s] == j0 + i:
                    want_subs |= 1 << i
                    want_esc |= int(escaped) << i
                want_lit |= int(not escaped) << i
            assert (subs, esc, lit) == (want_subs, want_esc, want_lit)
