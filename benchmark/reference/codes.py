"""Shannon-Fano codes exactly as the reference's module T builds them.

Frozen copy of ``shafa_tpu_torch/codes.py`` (``sort_symbols``,
``best_division``, ``shannon_fano_ranks``, ``build_codes``; themselves
copies of ``shafa_tpu/codes.py``), plain Python and NumPy: the stable
descending sort of the frequencies (ties in symbol order, t.c:74-104), the
split at the first non-improvement of |2*g1 - total| (t.c:130-152), '0' to
the left part and '1' to the right (t.c:182-194), empty codes for absent
symbols, and the one-bit code "0" for a block of one distinct symbol.

``tie_break="reversed"`` breaks ties by the higher symbol first, as an
unstable sort may leave them: the benchmark's control, never the reference.
"""

from __future__ import annotations

import numpy as np

NUM_SYMBOLS = 256


def sort_symbols(freqs: np.ndarray, tie_break: str = "symbol") -> np.ndarray:
    """sorted_syms[rank] = symbol, by (-freq, symbol)."""
    if tie_break == "symbol":
        return np.argsort(-freqs, kind="stable")
    if tie_break == "reversed":
        return (NUM_SYMBOLS - 1
                - np.argsort(-freqs[::-1], kind="stable"))
    raise ValueError(f"unknown tie_break {tie_break!r}")


def best_division(freqs: np.ndarray, first: int, last: int) -> int:
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


def shannon_fano_ranks(sorted_freqs: np.ndarray,
                       last_nonzero: int) -> list[str]:
    codes = [""] * NUM_SYMBOLS
    if last_nonzero <= 0:
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


def build_codes(freqs, tie_break: str = "symbol") -> list[str]:
    """256 code strings in symbol order."""
    f = np.asarray(freqs, dtype=np.int64)
    order = sort_symbols(f, tie_break)
    sorted_freqs = f[order]
    nz = np.nonzero(sorted_freqs)[0]
    if nz.size == 0:
        return [""] * NUM_SYMBOLS
    rank_codes = shannon_fano_ranks(sorted_freqs, int(nz[-1]))
    out = [""] * NUM_SYMBOLS
    for rank, sym in enumerate(order):
        out[int(sym)] = rank_codes[rank]
    return out
