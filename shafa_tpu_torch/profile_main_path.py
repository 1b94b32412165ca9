"""Seeded corpora of the port's CLI round trips.

``synthetic`` is the mix of runs, printable text and random bytes whose
codes have at most 16 bits; ``text_with_rare_bytes`` is text whose rare
bytes get codes of 17-32 bits at 8 MiB blocks. The bench scripts,
chip_smoke.py and the tests draw their inputs from them. Where the time of
a round trip goes is measured by the benchmark (``python3 benchmark/run.py
--workload mixed_m.100m --seed <n> --seconds 20 --trace 1``) and shown by
the CLI's ``--profile DIR``.
"""

from __future__ import annotations

import numpy as np


def synthetic(n: int, seed: int) -> bytes:
    """Mixed-entropy corpus: runs, printable text, random bytes in spans of
    2-60 KB (a copy of bench.py::synthetic, which imports jax)."""
    rng = np.random.default_rng(seed)
    parts = []
    total = 0
    while total < n:
        kind = rng.integers(0, 3)
        ln = int(rng.integers(2000, 60000))
        if kind == 0:
            parts.append(np.full(ln, rng.integers(0, 256), np.uint8))
        elif kind == 1:
            parts.append(rng.integers(32, 127, ln).astype(np.uint8))
        else:
            parts.append(rng.integers(0, 256, ln).astype(np.uint8))
        total += ln
    return np.concatenate(parts)[:n].tobytes()


def text_with_rare_bytes(n: int) -> bytes:
    """Text or logs that hold occasional control or UTF-8 bytes.

    The 95 printable ASCII bytes follow a Zipf law with exponent 1.1 (ranks
    in a seeded order); each of the 161 other byte values has a probability
    of 10^U(-8, -4); runs of 4-15 spaces cover about 15% of the file. At
    8 MiB blocks the rare bytes get Shannon-Fano codes of 17-24 bits, and
    RLE saves enough for R mode. The seed is fixed (11)."""
    rng = np.random.default_rng(11)
    printable = np.arange(32, 127)
    other = np.setdiff1d(np.arange(256), printable)
    prob = np.zeros(256)
    prob[other] = 10.0 ** rng.uniform(-8, -4, other.size)
    zipf = 1.0 / np.arange(1, printable.size + 1) ** 1.1
    prob[rng.permutation(printable)] = zipf / zipf.sum() * (1 - prob.sum())
    out = np.searchsorted(np.cumsum(prob), rng.random(n) * prob.sum())
    out = np.minimum(out, 255).astype(np.uint8)
    n_runs = int(0.15 * n / 9.5)
    starts = rng.integers(0, max(n - 16, 1), n_runs)
    ends = starts + rng.integers(4, 16, n_runs)
    cover = np.bincount(starts, minlength=n + 1) \
        - np.bincount(ends, minlength=n + 1)
    out[np.cumsum(cover[:n]) > 0] = ord(" ")
    return out.tobytes()
