"""The port of bench_stages.py on the CPU (SHAFA_TORCH_DEVICE=cpu, the
kernels' plain versions): every stage line and its bytes bound at 1 MiB in
256 KiB blocks, its gate run on the JAX package's oracle (the RLE rows and
packed bytes equal shafa_tpu.oracle's), and a packed byte that differs
making main return 1."""

import types

import pytest

from shafa_tpu import oracle as joracle
from shafa_tpu_torch import bench_stages

STAGES = ["rle_encode", "rle_payloads (old route)",
          "emit_bits_rows (old route)", "histogram(raw)", "codes (host, C++)",
          "pack_words(production)", "compact_words"]
ROOFLINES = ["rle_encode", "rle_payloads", "emit_bits_rows", "histogram",
             "pack_words", "compact_words"]


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setenv("SHAFA_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SHAFA_BENCH_REPS", "1")


def test_bench_stages_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bench_stages, "oracle", joracle)
    assert bench_stages.main(["1048576", "262144"]) == 0
    lines = capsys.readouterr().out.splitlines()
    stages = [ln for ln in lines if " ms" in ln and "roofline" not in ln]
    assert [ln.strip().split("  ")[0] for ln in stages] == STAGES
    # the route K8 replaced is indented beneath rle_encode
    assert [ln.startswith("  ") for ln in stages] == [
        False, True, True, False, False, False, False]
    bounds = [ln for ln in lines if ln.startswith("  roofline[")]
    assert [ln[len("  roofline["):].split("]")[0] for ln in bounds] \
        == ROOFLINES
    assert all("bytes-bound" in ln and "not measured" in ln for ln in bounds)
    assert "RLE rows and packed bytes equal the oracle's: True" in lines


def test_a_wrong_packed_byte_makes_main_return_1(monkeypatch, capsys):
    def pack(data, lens, vals):
        out = bytearray(joracle.pack(data, lens, vals))
        out[-1] ^= 1
        return bytes(out)

    monkeypatch.setattr(bench_stages, "oracle", types.SimpleNamespace(
        rle_encode=joracle.rle_encode, pack=pack))
    assert bench_stages.main(["524288", "262144"]) == 1
    assert "block 0: packed bytes" in capsys.readouterr().err
