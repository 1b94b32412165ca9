"""The comparison that decides ``correct`` fails each fault a cell can
have, and its control; a sound run of the same cell passes, on one
device and sharded over four.

Each fault is planted in the program under a whole run (the harness's look
for a chip skipped; the program on the CPU at a tiny size):

  * unchanged:  the decompress reports success and writes nothing;
  * half:       the decode returns the first half of its blocks only;
  * exchange:   four devices (dist.ShardedBackend, as on a four-card
                host), and the join of their parts keeps the first;
  * altered:    one byte of the RLE stream flipped where it is produced.
"""

import json

import pytest
import torch

import control
from conftest import MIXED_K, ROOT, TINY, make_checkout
from harness import spec


def _plant(fault, monkeypatch):
    from shafa_tpu_torch import device, dist, formats, pipeline
    cpu = torch.device("cpu")
    if fault in ("sharded", "exchange"):
        monkeypatch.setattr(dist, "block_devices",
                            lambda devices=None: [cpu] * 4)
    if fault == "unchanged":
        def module_d_shafa(path, rle, backend):
            out = formats.rm_ext(formats.rm_ext(path) if rle else path)
            return out, pipeline.StageReport("d", 0, [], [], 0.0, [out],
                                             {"algo": "shafa_rle"})
        monkeypatch.setattr(pipeline, "module_d_shafa", module_d_shafa)
    elif fault == "half":
        orig = device.TorchBackend.fused_decode

        def fused_decode(self, *args, **kwargs):
            out = orig(self, *args, **kwargs)
            return out[:max(1, len(out) // 2)]
        monkeypatch.setattr(device.TorchBackend, "fused_decode",
                            fused_decode)
    elif fault == "exchange":
        monkeypatch.setattr(dist.ShardedBackend, "_joined",
                            staticmethod(lambda parts: list(parts[0])))
    elif fault == "altered":
        orig = device.TorchBackend.fused_rle_bytes

        def fused_rle_bytes(self, h):
            out = orig(self, h).copy()
            out[len(out) // 2] ^= 1
            return out
        monkeypatch.setattr(device.TorchBackend, "fused_rle_bytes",
                            fused_rle_bytes)


@pytest.mark.parametrize("fault", [None, "sharded", "unchanged", "half",
                                   "exchange", "altered"])
def test_a_planted_fault_makes_the_run_incorrect(tmp_path, cpu_env,
                                                 in_process, monkeypatch,
                                                 capsys, fault):
    from harness.main import main
    cell = {"name": "mixed_K.tiny", "config": "mixed_K", "traffic": "tiny",
            "chips": 1, "why": "test"}
    ck = make_checkout(tmp_path, [cell], configs=[
        ("mixed_K", MIXED_K, {"source": "t", "reduced": [], "why": "t"})],
        traffic=[("tiny", TINY)])
    if fault:
        _plant(fault, monkeypatch)
    rc = main(["--workload", "mixed_K.tiny", "--seed", "21", "--seconds",
               "0.3", "--trace", "0"], require_chip=False, checkout=ck)
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    res = json.loads(out.out.strip().splitlines()[-1])
    sound = fault in (None, "sharded")
    assert res["correct"] is sound, res["checks"]
    if not sound:
        assert any(v["value"] > v["limit"] for v in res["checks"].values())


@pytest.mark.parametrize("name", [
    w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())
    ["workloads"]])
def test_the_control_fails_every_cell_at_a_test_size(name):
    """The control (ties broken by the higher symbol) at 1 MiB files."""
    cell = spec.load(name)
    for seed in (1, 2, 3):
        numbers = control.readings(cell, seed, torch.device("cpu"),
                                   {"file_bytes": 1 << 20, "pool": 1})
        assert numbers["cod_mismatch"] > 0 and numbers["shaf_mismatch"] > 0
        assert numbers["rle_mismatch"] == 0
        assert numbers["restored_mismatch"] == 0


@pytest.mark.gpu
def test_a_cell_is_correct_on_the_card():
    """mixed_m.100m for two seconds through benchmark/run.py on the card."""
    import subprocess
    import sys
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "mixed_m.100m", "--seed", "12345", "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"] is True
