"""A cell as BENCHMARK.json and the files it names define it.

``BENCHMARK.json`` (at the checkout's root) gives each cell its
configuration, traffic mix and chips, and each metric the cells it is read
in. A configuration is the file its entry names (``configs/<name>.json``);
a traffic mix is ``traffic/<name>.json``; a metric is ``metrics/<name>.py``.
A cell, a configuration, a traffic mix or a metric is added with new files
and an entry in ``BENCHMARK.json``, and no edit of the harness.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: list      # BENCHMARK.json metric entries reported here
    per_layer: list


def _reported(metrics: list, workload: str) -> list:
    return [m for m in metrics
            if "workloads" not in m or workload in m["workloads"]]


def load(workload: str, checkout: Path = CHECKOUT) -> Cell:
    bench_dir = checkout / BENCH_DIR.name
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in spec["workloads"]}.get(workload)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg = {c["name"]: c for c in spec["configs"]}[entry["config"]]
    return Cell(
        name=workload,
        config_name=entry["config"],
        config=json.loads((checkout / cfg["file"]).read_text()),
        traffic_name=entry["traffic"],
        traffic=json.loads((bench_dir / "traffic"
                            / f"{entry['traffic']}.json").read_text()),
        chips=int(entry["chips"]),
        end_to_end=_reported(spec["end_to_end"], workload),
        per_layer=_reported(spec["per_layer"], workload))


def reader(name: str, checkout: Path = CHECKOUT):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = checkout / BENCH_DIR.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
