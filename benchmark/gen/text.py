"""Text or logs that hold occasional control or UTF-8 bytes.

Seeded copy of ``shafa_tpu_torch/profile_main_path.py::text_with_rare_bytes``
(whose seed is fixed at 11): the 95 printable ASCII bytes follow a Zipf law
of exponent ``zipf_exponent`` over ranks in a seeded order; the 161 other
byte values are rare; runs of 4-15 spaces cover about ``space_cover`` of the
file. One change: the rare bytes' probabilities are a fixed grid, 161 values
spaced evenly in log10 over ``rare_log10``, dealt to the byte values in a
seeded order (the original drew each from 10^U(-8, -4)). So every seed
draws from the same distribution up to a relabelling of bytes, and the code
lengths, which set the decode route, do not depend on the seed.
"""

from __future__ import annotations

import torch


def generate(n: int, params: dict, g: torch.Generator) -> torch.Tensor:
    dev = g.device
    f64 = torch.float64
    printable = torch.arange(32, 127, device=dev)
    is_printable = torch.zeros(256, dtype=torch.bool, device=dev)
    is_printable[printable] = True
    other = torch.arange(256, device=dev)[~is_printable]
    lo, hi = params.get("rare_log10", [-8.0, -4.0])
    grid = 10.0 ** torch.linspace(lo, hi, other.numel(), dtype=f64,
                                  device=dev)
    prob = torch.zeros(256, dtype=f64, device=dev)
    prob[other[torch.randperm(other.numel(), generator=g, device=dev)]] = grid
    s = params.get("zipf_exponent", 1.1)
    zipf = 1.0 / torch.arange(1, printable.numel() + 1, dtype=f64,
                              device=dev) ** s
    order = printable[torch.randperm(printable.numel(), generator=g,
                                     device=dev)]
    prob[order] = zipf / zipf.sum() * (1.0 - grid.sum())
    cdf = torch.cumsum(prob, 0)
    u = torch.rand(n, generator=g, dtype=f64, device=dev) * cdf[-1]
    out = torch.searchsorted(cdf, u).clamp_(max=255).to(torch.uint8)
    del u
    run_lo, run_hi = params.get("space_run_bytes", [4, 16])
    n_runs = int(params.get("space_cover", 0.15) * n / ((run_lo + run_hi - 1)
                                                         / 2))
    starts = torch.randint(0, max(n - run_hi, 1), (n_runs,), generator=g,
                           device=dev)
    ends = starts + torch.randint(run_lo, run_hi, (n_runs,), generator=g,
                                  device=dev)
    cover = (torch.bincount(starts, minlength=n + 1)
             - torch.bincount(ends, minlength=n + 1))
    out[torch.cumsum(cover[:n], 0) > 0] = ord(" ")
    return out
