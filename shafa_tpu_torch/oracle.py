"""NumPy oracle: exact, host-side implementations of every codec stage.

Copy of shafa_tpu/oracle.py:1-253: the port's NumPy reference, and the
backend's host route for rows its kernels do not take.

Two tiers per stage:

  * ``slow_*`` — direct transliterations of the format SPEC (not of the C code
    structure): byte-at-a-time, obviously correct. Used only by tests as the
    ground truth on small inputs (alongside the compiled C reference).
  * vectorized numpy — the same math as the device kernels (segment scans,
    rank-decode, pointer doubling), used by the NumPy backend and as the
    differential baseline for the kernels' plain versions.

Format semantics being implemented (citations into the C reference's src/):
  RLE escape rule      f.c:29-55   (run>=4 or symbol 0x00 -> `00 sym count`,
                                    count in [1,255], runs never cross blocks)
  histogram            f.c:63-79   (256-bin count of the emitted stream)
  bit packing          c.c:52-83   (MSB-first concat of codes, zero-padded)
  prefix decode        d.c:514-551 (emit exactly `out_count` symbols; padding
                                    bits ignored by construction)
  RLE expansion        d.c:116-197 (escape triple -> count copies; count 0
                                    still emits one copy, d.c:179-184)
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .errors import FileUnrecognizableError

NUM_SYMBOLS = 256
RLE_MAX_RUN = 255
RLE_MIN_RUN = 4


# ---------------------------------------------------------------------------
# Slow ground-truth versions (tests only)
# ---------------------------------------------------------------------------

def slow_rle_encode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        sym = data[i]
        run = 1
        while i + run < n and data[i + run] == sym and run < RLE_MAX_RUN:
            run += 1
        if run >= RLE_MIN_RUN or sym == 0:
            out += bytes((0, sym, run))
            i += run
        else:
            out.append(sym)
            i += 1
    return bytes(out)


def slow_rle_expand(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        c = data[i]
        if c == 0:
            sym, cnt = data[i + 1], data[i + 2]
            out += bytes([sym]) * (cnt if cnt else 1)
            i += 3
        else:
            out.append(c)
            i += 1
    return bytes(out)


def slow_pack(data: bytes, codes: Sequence[str]) -> bytes:
    bits = "".join(codes[b] for b in data)
    if not bits:
        return b""
    pad = -len(bits) % 8
    bits += "0" * pad
    return int(bits, 2).to_bytes(len(bits) // 8, "big")


def slow_unpack(payload: bytes, codes: Sequence[str], out_count: int) -> bytes:
    tree: dict[str, int] = {c: s for s, c in enumerate(codes) if c}
    out = bytearray()
    cur = ""
    for byte in payload:
        for k in range(7, -1, -1):
            cur += "1" if (byte >> k) & 1 else "0"
            if cur in tree:
                out.append(tree[cur])
                cur = ""
                if len(out) == out_count:
                    return bytes(out)
    if len(out) != out_count:
        raise ValueError("compressed stream exhausted early")
    return bytes(out)


# ---------------------------------------------------------------------------
# Vectorized versions (CPU fallback + kernel baseline)
# ---------------------------------------------------------------------------

def histogram(data: bytes | np.ndarray) -> np.ndarray:
    x = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) else data
    return np.bincount(x, minlength=NUM_SYMBOLS).astype(np.int64)


def rle_segments(x: np.ndarray):
    """Split a block into RLE sub-segments (runs capped at 255).

    Returns (sym, sub_len, escaped): one entry per sub-segment in stream order.
    This is the vectorized formulation shared with the device kernel: run
    boundaries -> segment start indices -> 255-cap splits -> escape decision.
    """
    n = x.size
    if n == 0:
        return (np.empty(0, np.uint8), np.empty(0, np.int64), np.empty(0, bool))
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(x[1:], x[:-1], out=change[1:])
    run_start_idx = np.flatnonzero(change)
    run_id = np.cumsum(change) - 1
    offset = np.arange(n, dtype=np.int64) - run_start_idx[run_id]
    sub_start = change | (offset % RLE_MAX_RUN == 0)
    sub_idx = np.flatnonzero(sub_start)
    sub_end = np.append(sub_idx[1:], n)
    sub_len = sub_end - sub_idx
    sym = x[sub_idx]
    escaped = (sub_len >= RLE_MIN_RUN) | (sym == 0)
    return sym, sub_len, escaped


def rle_encode(data: bytes | np.ndarray) -> np.ndarray:
    x = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) else data
    sym, sub_len, escaped = rle_segments(x)
    out_sizes = np.where(escaped, 3, sub_len)
    total = int(out_sizes.sum())
    seg = np.repeat(np.arange(sym.size), out_sizes)
    offs = np.concatenate(([0], np.cumsum(out_sizes)))[:-1]
    within = np.arange(total, dtype=np.int64) - offs[seg]
    esc_byte = np.select(
        [within == 0, within == 1],
        [np.zeros(total, np.int64), sym[seg].astype(np.int64)],
        default=sub_len[seg],
    )
    out = np.where(escaped[seg], esc_byte, sym[seg].astype(np.int64))
    return out.astype(np.uint8)


def rle_expand(data: bytes | np.ndarray, out_limit: int | None = None) -> np.ndarray:
    x = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) else data
    n = x.size
    if n == 0:
        return np.empty(0, np.uint8)
    # Token starts form the orbit of 0 under J(i) = i + (3 if x[i]==0 else 1):
    # a 0x00 can be payload of a previous escape, so starts are a chain.
    step = np.where(x == 0, 3, 1).astype(np.int64)
    starts = _orbit_of_zero(step, n)
    is_esc = x[starts] == 0
    sym = np.where(is_esc, x[np.minimum(starts + 1, n - 1)], x[starts])
    cnt = np.where(is_esc, x[np.minimum(starts + 2, n - 1)], 1).astype(np.int64)
    cnt = np.maximum(cnt, 1)  # zero-count escape emits one copy (d.c:179-184)
    out = np.repeat(sym, cnt).astype(np.uint8)
    return out if out_limit is None else out[:out_limit]


def _chain_positions(jump: np.ndarray, max_count: int) -> np.ndarray:
    """First `max_count` iterates of 0 under i -> jump[i], by pointer doubling.

    `jump` has size n+1 with values in [0, n]; n is absorbing (jump[n] == n).
    Returns an increasing array; entries that ran past the end equal n.
    Doubling invariant: after each round, pos holds (p_0 .. p_{m-1}) and
    stride == f^m, so concat(pos, stride[pos]) extends to (p_0 .. p_{2m-1}).
    """
    pos = np.zeros(1, dtype=np.int64)
    stride = jump
    n = jump.size - 1
    while pos.size < max_count and pos[-1] < n:
        pos = np.concatenate([pos, stride[pos]])
        stride = stride[stride]
    return pos[:max_count]


def _orbit_of_zero(step: np.ndarray, n: int) -> np.ndarray:
    """Positions visited from 0 under i -> i + step[i] while < n."""
    jump = np.append(np.minimum(np.arange(n, dtype=np.int64) + step, n), n)
    pos = _chain_positions(jump, n)
    return pos[pos < n]


def pack(data: bytes | np.ndarray, lens: np.ndarray, vals: np.ndarray) -> bytes:
    """Bit-pack `data` with a (len, left-aligned-value) code LUT; MSB-first."""
    x = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) else data
    width = vals.dtype.itemsize * 8
    ln = lens[x].astype(np.int64)
    total_bits = int(ln.sum())
    if total_bits == 0:
        return b""
    offs = np.concatenate(([0], np.cumsum(ln)))[:-1]
    seg = np.repeat(np.arange(x.size), ln)
    within = np.arange(total_bits, dtype=np.int64) - offs[seg]
    v = vals[x][seg]
    bits = ((v >> (width - 1 - within).astype(v.dtype)) & 1).astype(np.uint8)
    return np.packbits(bits).tobytes()


def decode_tables(codes: Sequence[str]):
    """Sorted decode tables exploiting lexicographic completeness (see codes.py).

    Returns (padded_vals[uint64], lens[int32], syms[int32], maxlen): entries for
    present symbols only, sorted by code value (== rank order). A window W of
    `maxlen` bits starting at a code boundary decodes as the entry with the
    largest padded_val <= W.
    """
    entries = [(len(c), int(c, 2), s) for s, c in enumerate(codes) if c]
    if not entries:
        return (np.zeros(1, np.uint64), np.zeros(1, np.int32),
                np.zeros(1, np.int32), 0)
    maxlen = max(e[0] for e in entries)
    if maxlen > 63:
        raise OverflowError("codes longer than 63 bits need the slow path")
    rows = sorted((v << (maxlen - ln), ln, s) for ln, v, s in entries)
    pv = np.array([r[0] for r in rows], dtype=np.uint64)
    ln = np.array([r[1] for r in rows], dtype=np.int32)
    sy = np.array([r[2] for r in rows], dtype=np.int32)
    return pv, ln, sy, maxlen


def unpack(payload: bytes, codes: Sequence[str], out_count: int) -> np.ndarray:
    """Vectorized prefix decode: per-bit-position rank, then pointer doubling
    along the symbol chain. Same plan as the device kernels (kernels/decode.py)."""
    if out_count == 0:
        return np.empty(0, np.uint8)
    pv, ln_tab, sy_tab, maxlen = decode_tables(codes)
    if maxlen == 0:
        # All-empty code table: only producible by the C reference on a
        # single-distinct-symbol block — an archive its own decoder crashes
        # on, and whose symbol identity is unrecoverable. Reject cleanly
        # (our encoder never emits this; see docs/DEVIATIONS.md).
        raise ValueError("all-empty .cod block is undecodable")
    bits = np.unpackbits(np.frombuffer(payload, np.uint8))
    nbits = bits.size
    # Window value (maxlen bits, zero-padded past the end) at every position.
    w = np.zeros(nbits, np.uint64)
    padded = np.concatenate([bits, np.zeros(maxlen, np.uint8)]).astype(np.uint64)
    for k in range(maxlen):
        w |= padded[k:k + nbits] << np.uint64(maxlen - 1 - k)
    rank = np.searchsorted(pv, w, side="right") - 1
    ln = ln_tab[rank].astype(np.int64)
    sym = sy_tab[rank]
    # Chain p0=0, p_{k+1} = p_k + len[p_k]; first out_count positions.
    jump = np.append(np.minimum(np.arange(nbits, dtype=np.int64) + ln, nbits), nbits)
    pos = _chain_positions(jump, out_count)
    if pos.size < out_count or pos.max(initial=0) >= nbits:
        raise ValueError("compressed stream exhausted early")
    return sym[pos].astype(np.uint8)


def host_unpack(payload, code_strings, out_count) -> np.ndarray:
    """unpack, its ValueError on a bad archive (no codes, a stream
    exhausted early) raised as FileUnrecognizableError, so that the CLI
    ends with "File not recognized" as on the kernel route."""
    try:
        return unpack(payload, code_strings, out_count)
    except ValueError as e:
        raise FileUnrecognizableError(str(e)) from e
