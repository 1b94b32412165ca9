"""CPU tests of the benchmark (``python -m pytest benchmark/tests``).

The program runs on the CPU here (SHAFA_TORCH_DEVICE=cpu, the kernels'
plain versions) at tiny sizes; tests marked ``gpu`` need a CUDA card and
skip without one, deciding inside the test.
"""

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def cpu_env(monkeypatch):
    """The program on the CPU; os.environ restored after the test (a run
    sets its cache and visible-card variables)."""
    saved = dict(os.environ)
    monkeypatch.setenv("SHAFA_TORCH_DEVICE", "cpu")
    yield
    os.environ.clear()
    os.environ.update(saved)


def make_checkout(tmp: Path, cells: list[dict], configs=(), traffic=(),
                  metrics=()) -> Path:
    """A copy of BENCHMARK.json and benchmark/ under tmp with cells (and
    their configs, traffic mixes and metric readers) added as files and
    entries; every metric is reported in every added cell."""
    shutil.copytree(BENCH, tmp / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, body, entry in configs:
        path = tmp / BENCH.name / "configs" / f"{name}.json"
        path.write_text(json.dumps(body))
        spec["configs"].append(dict(entry, name=name,
                                    file=f"{BENCH.name}/configs/{name}.json"))
    for name, body in traffic:
        (tmp / BENCH.name / "traffic" / f"{name}.json").write_text(
            json.dumps(body))
    for name, source, entry in metrics:
        (tmp / BENCH.name / "metrics" / f"{name}.py").write_text(source)
        spec["per_layer"].append(dict(entry, name=name))
    spec["workloads"].extend(cells)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [c["name"] for c in cells]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp


#: A tiny traffic mix and a configuration with several blocks at -b K.
TINY = {"why": "test", "file_bytes": 1_400_000, "pool": 2,
        "write_cap_bytes": 60_000_000}
#: Processes a run here, for speed (harness.main.PROCESSES on the chip).
TEST_PROCESSES = 2


@pytest.fixture(autouse=True)
def few_processes(monkeypatch):
    from harness import main
    monkeypatch.setattr(main, "PROCESSES", TEST_PROCESSES)


@pytest.fixture
def in_process(monkeypatch):
    """Run a run's processes inside the test's own process, so that what
    the test plants in the program is there (their records still pass
    through JSON, as from a child)."""
    import time

    from harness import child, main

    def spawn(task):
        return json.loads(json.dumps(child.run(task, time.perf_counter())))
    monkeypatch.setattr(main, "spawn", spawn)
MIXED_K = {"source": "test", "block_flag": "K", "block_bytes": 655360,
           "generator": {"name": "mixed"}, "reduced": []}
