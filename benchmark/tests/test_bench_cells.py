"""A cell, a configuration, a traffic mix and a metric are added as files
and BENCHMARK.json entries only; a checkout without the program refuses."""

import json
import os
import shutil
import subprocess
import sys

from conftest import (BENCH, MIXED_K, ROOT, TEST_PROCESSES, TINY,
                      make_checkout)

NEW_METRIC = '''"""a test metric: compresses in the window"""


def read(run):
    return float(len(run.of("compress")))
'''


def _run_in(checkout, argv, env_extra=None):
    """harness.main.main of the checkout's own harness, in a new process,
    with the chip's look skipped (the program on the CPU, found through
    PYTHONPATH as the checkout holds none)."""
    code = ("import sys; from pathlib import Path; "
            f"sys.path.insert(0, {str(checkout / BENCH.name)!r}); "
            f"sys.path.insert(1, {str(ROOT)!r}); "
            "from harness import main; "
            f"main.PROCESSES = {TEST_PROCESSES}; "
            f"sys.exit(main.main({argv!r}, require_chip=False, "
            f"checkout=Path({str(checkout)!r})))")
    env = dict(os.environ, SHAFA_TORCH_DEVICE="cpu", PYTHONPATH=str(ROOT),
               **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=600)


def test_an_added_cell_runs_with_no_other_edit(tmp_path):
    cell = {"name": "mixed_K.tiny", "config": "mixed_K", "traffic": "tiny",
            "chips": 1, "why": "a cell added by files and entries alone"}
    ck = make_checkout(
        tmp_path, [cell],
        configs=[("mixed_K", MIXED_K, {"source": "test", "reduced": [],
                                       "why": "test"})],
        traffic=[("tiny", TINY)],
        metrics=[("test.compresses", NEW_METRIC,
                  {"unit": "calls", "better": "higher",
                   "source": "host_clock", "layer": "CLI (cli.py)",
                   "moves": "compress_mb_s"})])
    for trace in ("0", "1"):
        r = _run_in(ck, ["--workload", "mixed_K.tiny", "--seed", "3",
                         "--seconds", "0.5", "--trace", trace])
        assert r.returncode == 0, r.stderr[-3000:]
        res = json.loads(r.stdout.strip().splitlines()[-1])
        assert res["correct"] is True, r.stderr[-3000:]
        assert list(res)[-1] == "checks"
        names = set(res["metrics"])
        if trace == "0":
            assert {"compress_mb_s", "decompress_mb_s", "setup_s"} <= names
        else:
            assert res["metrics"]["test.compresses"]["value"] >= 1
            assert {"cli.self_ms.compress",
                    "pipeline.host_ms_per_mb.decompress",
                    "codes.module_t_ms_per_mb"} <= names
        assert "check shaf_mismatch: 0 (limit 0)" in r.stderr


def test_a_checkout_of_the_benchmark_alone_refuses(tmp_path):
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = subprocess.run(
        [sys.executable, f"{BENCH.name}/run.py", "--workload",
         "mixed_m.100m", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert r.returncode != 0
    assert not any(line.startswith("{") for line in r.stdout.splitlines())
