"""The benchmark's deployments through the port's CLI, file to file, against
the benchmark's plain reference (``benchmark/reference/``): ``text_K``
(``benchmark/configs/text_K.json``: text with rare bytes at -b K, 640 KiB
blocks, codes of 17-20 bits) decodes every block through the 17-32-bit
route (K5, K6, K1 bits, K4); ``mixed_m`` (-b m) through the route of at
most 16 bits (K2, K3, K4). The sidecars equal the reference's, the restore
is exact, and the decompress's ``--json`` counters name the route of every
block and, on the card, count each block's tables built there (K9).

On the CPU the kernels' plain versions run. The test marked ``gpu`` runs
both round trips on a CUDA card and skips without one (decided in the
``cuda`` fixture): ``python -m pytest tests/test_torch_text_k.py``.
"""

import contextlib
import io
import json
import sys
from pathlib import Path

import pytest
import torch

from shafa_tpu_torch import cli

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
sys.path.insert(0, str(BENCH))
import gen  # noqa: E402
import reference  # noqa: E402

#: File size: 3 blocks at -b K (640 KiB, 640 KiB, 89,280 B), 1 at -b m.
SIZE = 1_400_000
SEED = 2**31 + 11
#: The counter of the route each configuration's blocks must take.
ROUTE = {"text_K": "decode_blocks32", "mixed_m": "decode_blocks16"}
DECODE_COUNTERS = ("decode_blocks16", "decode_blocks32",
                   "host_decoded_blocks")


def _cli(argv) -> None:
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(argv) == 0


def _round_trip(tmp_path, name: str, ref_device="cpu"):
    """Compress and restore a file drawn by the configuration's generator;
    each sidecar must equal the reference's and the restore the input.
    The reference's Sidecars and the decompress's counters."""
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    data = gen.make_pool(cfg, SIZE, 1, SEED, "cpu")[0]
    path = tmp_path / "f.bin"
    path.write_bytes(data.tobytes())
    want = reference.sidecars(data, cfg["block_bytes"], ref_device)
    _cli([str(path), "-b", cfg["block_flag"]])
    for suffix, body in want.files.items():
        assert (tmp_path / f"f.bin{suffix}").read_bytes() == body, suffix
    path.unlink()
    report = tmp_path / "d.json"
    _cli([str(path) + want.archive, "--json", str(report)])
    assert path.read_bytes() == data.tobytes()
    return want, json.loads(report.read_text())["counters"]


@pytest.mark.parametrize("name", ["text_K", "mixed_m"])
def test_every_block_decodes_through_its_route(tmp_path, monkeypatch, name):
    monkeypatch.setenv("SHAFA_TORCH_DEVICE", "cpu")
    want, counters = _round_trip(tmp_path, name)
    wide = [17 <= n <= 32 for n in want.max_code_len]
    assert all(wide) if name == "text_K" else not any(wide)
    n_blocks = len(want.max_code_len)
    assert n_blocks == (3 if name == "text_K" else 1)
    for counter in DECODE_COUNTERS:
        expect = n_blocks if counter == ROUTE[name] else 0
        assert counters[counter] == expect, counter
    assert counters["decode_table_rows_on_device"] == 0  # the plain tables


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["text_K", "mixed_m"])
def test_round_trip_on_the_card(tmp_path, monkeypatch, cuda, name):
    monkeypatch.delenv("SHAFA_TORCH_DEVICE", raising=False)
    want, counters = _round_trip(tmp_path, name, cuda)
    n_blocks = len(want.max_code_len)
    for counter in DECODE_COUNTERS:
        assert counters[counter] == (n_blocks if counter == ROUTE[name]
                                     else 0), counter
    assert counters["decode_table_rows_on_device"] == n_blocks
