"""Mixed-entropy binary: runs, printable text and random bytes in spans.

Seeded copy of ``shafa_tpu_torch/profile_main_path.py::synthetic`` (itself
a copy of the root ``bench.py::synthetic``): spans of a uniform length in
``span_bytes``, each equally likely a run of one random byte, random
printable ASCII (32-126) or random bytes (0-255). Drawn on the generator's
device in a few large calls instead of span by span on the host; the same
distribution, not the same bytes.
"""

from __future__ import annotations

import torch


def generate(n: int, params: dict, g: torch.Generator) -> torch.Tensor:
    dev = g.device
    lo, hi = params.get("span_bytes", [2000, 60000])
    lengths, kinds, run_vals = [], [], []
    covered = 0
    while covered < n:
        s = n // ((lo + hi) // 2) + 64
        ln = torch.randint(lo, hi, (s,), generator=g, device=dev)
        lengths.append(ln)
        kinds.append(torch.randint(0, 3, (s,), generator=g, device=dev))
        run_vals.append(torch.randint(0, 256, (s,), generator=g, device=dev,
                                      dtype=torch.uint8))
        covered += int(ln.sum())
    lengths = torch.cat(lengths)
    kinds = torch.cat(kinds)
    run_vals = torch.cat(run_vals)
    span = torch.repeat_interleave(
        torch.arange(lengths.numel(), device=dev), lengths)[:n]
    rnd = torch.randint(0, 256, (n,), generator=g, device=dev,
                        dtype=torch.uint8)
    prn = torch.randint(32, 127, (n,), generator=g, device=dev,
                        dtype=torch.uint8)
    kind = kinds[span]
    return torch.where(kind == 0, run_vals[span],
                       torch.where(kind == 1, prn, rnd))
