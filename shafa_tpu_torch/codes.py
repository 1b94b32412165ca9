"""Shannon-Fano code construction — bit-exact with the reference's module T.

Copy of shafa_tpu/codes.py:1-203.

The .cod sidecar is part of the observable format, so construction must replicate
the reference's tie-breaking exactly [SURVEY.md §2.1 "Code-assignment semantics"]:

  * frequencies sorted descending with a STABLE insertion sort — ties keep
    symbol order, i.e. order by (-freq, symbol)  (t.c:74-104);
  * the working range is [0, last_nonzero_rank]  (not_null, t.c:202-210);
  * recursive balanced split at best_division: an incremental scan that stops
    at the first non-improvement of |2*g1 - total|  (t.c:130-152);
  * '0' appended to the left part, '1' to the right  (t.c:182-194);
  * zero-frequency symbols keep empty codes  (calloc'd table, t.c:308).

A 256-symbol problem is tiny (the reference measures 0.33 ms for 2 blocks),
so this runs on host; the resulting code tables are broadcast to devices as
(len, bits) integer LUTs via `code_table_arrays`.

Useful structural facts (used by the device decoder, kernels/decode.py):
  * the split always leaves both halves non-empty, so the code tree is full —
    the code is COMPLETE: every bit-window matches exactly one code;
  * codes listed in rank order are strictly increasing lexicographically
    ('0'-part sorts before '1'-part at every level), so decoding reduces to a
    rank computation against the sorted, zero-padded code values.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from . import tracing

NUM_SYMBOLS = 256


def sort_symbols(freqs: Sequence[int]) -> np.ndarray:
    """Symbols ordered by (-freq, symbol): the reference's stable descending
    insertion sort (t.c:74-104). Returns sorted_syms[rank] = symbol."""
    f = np.asarray(freqs, dtype=np.int64)
    if f.shape != (NUM_SYMBOLS,):
        raise ValueError("need 256 frequencies")
    return np.argsort(-f, kind="stable")


def best_division(freqs: np.ndarray, first: int, last: int) -> int:
    """Greedy split index with the reference's early stop (t.c:130-152):
    advance while |2*g1 - total| strictly improves; return division-1."""
    total = int(freqs[first:last + 1].sum())
    mindif = dif = total
    g1 = 0
    division = first
    while dif == mindif:
        g1 += int(freqs[division])
        dif = abs(2 * g1 - total)
        if dif < mindif:
            division += 1
            mindif = dif
        else:
            dif = mindif + 1
    return division - 1


def shannon_fano_ranks(sorted_freqs: np.ndarray, last_nonzero: int) -> list[str]:
    """Codes per RANK for ranks [0, last_nonzero]; iterative work-list in place
    of the reference's recursion (t.c:182-195) — same order-independent result."""
    codes = [""] * NUM_SYMBOLS
    if last_nonzero <= 0:
        # Single distinct symbol. The reference assigns an EMPTY code
        # (sf_codes is a no-op when start == end, t.c:185) which yields an
        # archive its own decoder crashes on (NULL trie walk, d.c:534) — the
        # symbol identity is unrepresentable with all-empty codes. We deviate
        # minimally: one-bit code "0". See docs/DEVIATIONS.md.
        codes[0] = "0"
        return codes
    stack = [(0, last_nonzero)]
    while stack:
        start, end = stack.pop()
        if start == end:
            continue
        div = best_division(sorted_freqs, start, end)
        for r in range(start, div + 1):
            codes[r] += "0"
        for r in range(div + 1, end + 1):
            codes[r] += "1"
        stack.append((start, div))
        stack.append((div + 1, end))
    return codes


def build_codes(freqs: Sequence[int]) -> list[str]:
    """256 code strings in SYMBOL order, exactly as module T writes them
    (codes[positions[iter]] at t.c:353-361)."""
    f = np.asarray(freqs, dtype=np.int64)
    order = sort_symbols(f)
    sorted_freqs = f[order]
    nz = np.nonzero(sorted_freqs)[0]
    if nz.size == 0:
        # All-zero histogram (empty stream) — cannot happen for real blocks;
        # the reference would read out of bounds (t.c:207). Define as all-empty.
        return [""] * NUM_SYMBOLS
    last_nonzero = int(nz[-1])
    rank_codes = shannon_fano_ranks(sorted_freqs, last_nonzero)
    out = [""] * NUM_SYMBOLS
    for rank, sym in enumerate(order):
        out[int(sym)] = rank_codes[rank]
    return out


@dataclasses.dataclass
class CodeTables:
    """Batched code tables: the array-native interchange for code sets.

    lens[b, s] = bit length of symbol s's code in block b (0 = absent);
    vals[b, s] = the code bits LEFT-ALIGNED in a uint64 (MSB-first), the
    orientation the .shaf packer consumes (c.c:133-146).

    64 bits cover every producible code: each Shannon-Fano level beyond
    log2(255) requires the leading frequency to exceed the sum of the rest,
    so depth d needs a block of >= 2^(d-9) bytes — depth 64 would need an
    impossible 2^55-byte block.  Codes longer than 64 bits (hand-crafted
    .cod files only) live in `overflow` as raw strings; consumers route
    those rows to the string-based slow paths.
    """

    lens: np.ndarray  # (n, 256) uint8
    vals: np.ndarray  # (n, 256) uint64
    overflow: dict[int, list[str]] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return self.lens.shape[0]

    def row_strings(self, i: int) -> list[str]:
        """Code strings of block i (symbol order) — for slow-path fallbacks."""
        if i in self.overflow:
            return self.overflow[i]
        out = []
        for s in range(NUM_SYMBOLS):
            n = int(self.lens[i, s])
            v = int(self.vals[i, s]) >> (64 - n) if n else 0
            out.append(format(v, f"0{n}b") if n else "")
        return out

    def to_strings(self) -> list[list[str]]:
        return [self.row_strings(i) for i in range(len(self))]

    @classmethod
    def from_strings(cls, block_codes: Sequence[Sequence[str]]) -> "CodeTables":
        n = len(block_codes)
        lens = np.zeros((n, NUM_SYMBOLS), np.uint8)
        vals = np.zeros((n, NUM_SYMBOLS), np.uint64)
        overflow: dict[int, list[str]] = {}
        for i, cs in enumerate(block_codes):
            if max((len(c) for c in cs), default=0) > 64:
                overflow[i] = list(cs)
                continue
            for s, c in enumerate(cs):
                if c:
                    lens[i, s] = len(c)
                    vals[i, s] = np.uint64(int(c, 2) << (64 - len(c)))
        return cls(lens, vals, overflow)


def build_code_tables(freqs: np.ndarray) -> CodeTables:
    """Batched module T: (n, 256) histograms -> CodeTables.

    Uses the native runtime (runtime/runtime.cpp, threaded C++) when
    available; otherwise the per-block Python path above. Both are bit-exact
    with the reference (differential-tested in tests/test_torch_host.py).
    """
    f = np.ascontiguousarray(freqs, dtype=np.int64)
    if f.ndim != 2 or f.shape[1] != NUM_SYMBOLS:
        raise ValueError("need (n, 256) frequencies")
    from . import runtime
    with tracing.span("shafa.codes.build"):
        native = runtime.build_codes(f)
        if native is not None:
            lens, vals = native
            return CodeTables(lens, vals)
        return CodeTables.from_strings([build_codes(row) for row in f])


def code_table_arrays(codes: Sequence[str], width: int = 32):
    """Code strings -> integer LUTs for device kernels.

    Returns (lengths[256] int32, values[256] uint32): value = code bits
    LEFT-ALIGNED in a `width`-bit word (MSB-first, zero-padded), matching the
    .shaf packing order (c.c:133-146). Codes longer than `width` raise — the
    caller falls back to the oracle path for such blocks (typical max is ~20
    bits; >32 needs a pathological skew).
    """
    lens = np.zeros(NUM_SYMBOLS, dtype=np.int32)
    vals = np.zeros(NUM_SYMBOLS, dtype=np.uint64)
    for s, c in enumerate(codes):
        n = len(c)
        if n > width:
            raise OverflowError(f"code for symbol {s} is {n} bits > {width}")
        lens[s] = n
        if n:
            vals[s] = np.uint64(int(c, 2) << (width - n))
    return lens, vals.astype(np.uint32 if width <= 32 else np.uint64)


def max_code_len(codes: Sequence[str]) -> int:
    return max((len(c) for c in codes), default=0)
