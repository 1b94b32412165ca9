"""The run's environment: cache directories, visible cards, the card's
name and power limit, and the look for JAX in the process."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

#: Top-level module names that must not be loaded in a run's process.
BANNED = ("jax", "jaxlib", "flax", "shafa_tpu")

#: Cache directories of the program's toolchains, inside the checkout.
CACHE_DIR = ".bench_cache"


def prepare(checkout: Path, chips: int) -> None:
    """Fix every build and kernel cache to a directory inside the checkout,
    keep libraries from loading JAX, and show the process the cell's cards
    (the first ``chips`` of those visible)."""
    cache = checkout / CACHE_DIR
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = (visible.split(",") if visible is not None
           else [str(i) for i in range(chips)])
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:chips])


def banned_modules() -> list[str]:
    """Loaded modules whose whole top-level name is banned."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(BANNED))


def cards() -> list[str]:
    """nvidia-smi's name and power limit of each visible card."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi: {e}"]
    return [line.strip() for line in r.stdout.splitlines() if line.strip()]


def host_probe() -> str:
    """A fixed piece of host work timed, to compare runs' host speed: a
    Python loop of 2 million additions and a copy of 64 MiB (best of 3)."""
    import time

    import numpy as np
    a = np.ones(64 << 20, np.uint8)
    loop, copy = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        sum(range(2_000_000))
        t1 = time.perf_counter()
        a.copy()
        t2 = time.perf_counter()
        loop.append(t1 - t0)
        copy.append(t2 - t1)
    return (f"host probe: python loop {min(loop) * 1e3:.2f} ms, copy of "
            f"64 MiB {min(copy) * 1e3:.2f} ms")


def filesystem(path: str) -> str:
    """The mount point and type of the filesystem that holds path."""
    best = ("?", "?")
    try:
        with open("/proc/mounts") as fp:
            for line in fp:
                parts = line.split()
                if len(parts) > 2 and (path == parts[1] or path.startswith(
                        parts[1].rstrip("/") + "/")):
                    if len(parts[1]) >= len(best[0]) or best[0] == "?":
                        best = (parts[1], parts[2])
    except OSError:
        pass
    return f"{best[0]} ({best[1]})"
