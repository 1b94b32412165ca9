"""Seeded corpus generators of the benchmark.

A configuration names its generator (``"generator": {"name": ...}``); the
generator is the module ``gen/<name>.py``, whose ``generate(n, params, g)``
draws ``n`` bytes from the ``torch.Generator`` ``g`` on ``g.device`` in a few
large calls and returns them as a uint8 tensor there. One generator, seeded
once with the run's seed, draws every file of a cell's pool in turn, so the
same seed gives the same pool on the same kind of device.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    """A torch.Generator on device, seeded from any whole number."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def make_pool(config: dict, file_bytes: int, pool: int, seed: int,
              device) -> list[np.ndarray]:
    """The pool of a cell: ``pool`` files of ``file_bytes`` bytes each from
    the configuration's generator, as host arrays."""
    spec = config["generator"]
    mod = importlib.import_module(f"gen.{spec['name']}")
    g = generator(seed, device)
    files = []
    for _ in range(pool):
        data = mod.generate(file_bytes, spec.get("params", {}), g)
        files.append(data.cpu().numpy())
        del data
    return files
