"""The four-card deployment (``benchmark/configs/mixed_m_x4.json``) through
the port's CLI, file to file, against the benchmark's plain reference
(``benchmark/reference/``): with four devices visible, ``cli._make_backend``
builds ``dist.ShardedBackend``, which cuts every call's blocks into
contiguous ranges, one a device, and joins their results in block order.
The sidecars must equal the reference's whatever the split, the restore
must be exact, and ``--json`` must count the ranges run
(``dist_parts``) and the bytes the host copied to join them
(``dist_join_bytes``).

Four ``cpu`` devices stand in for the cards (the kernels' plain versions
run), at -b K with its blocks cut to ``BLOCK`` bytes: the mixed generator
at 5 blocks (ranges of 1, 1, 1 and 2), at 3 blocks (the first device gets
none), and the text generator, whose codes of 17-20 bits take the wide
decode route."""

import contextlib
import io
import json
import sys
from pathlib import Path

import pytest
import torch

from shafa_tpu_torch import cli, dist, geometry, tracing

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
sys.path.insert(0, str(BENCH))
import gen  # noqa: E402
import reference  # noqa: E402

BLOCK = 100_000
DEVICES = 4
SEED = 2**31 + 23
#: (configuration, blocks in the file, non-empty ranges over DEVICES)
CASES = [("mixed_m_x4", 5, 4), ("mixed_m_x4", 3, 3), ("text_K", 6, 4)]


def _cli(argv) -> dict:
    """cli.main(argv), which must succeed; its --json counters."""
    report = Path(argv[0]).with_name("report.json")
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(argv + ["--json", str(report)]) == 0
    return json.loads(report.read_text())["counters"]


@pytest.mark.parametrize("name,n_blocks,parts", CASES)
def test_four_devices_match_the_reference(tmp_path, monkeypatch, name,
                                          n_blocks, parts):
    monkeypatch.setenv("SHAFA_TORCH_DEVICE", "cpu")
    monkeypatch.setitem(geometry.BLOCK_SIZE_BY_FLAG, "K", BLOCK)
    monkeypatch.setattr(dist, "block_devices",
                        lambda devices=None: [torch.device("cpu")] * DEVICES)
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    size = n_blocks * BLOCK - 12_345
    data = gen.make_pool(cfg, size, 1, SEED, "cpu")[0]
    path = tmp_path / "f.bin"
    path.write_bytes(data.tobytes())
    want = reference.sidecars(data, BLOCK)
    assert len(want.max_code_len) == n_blocks
    wide = [n > 16 for n in want.max_code_len]
    assert all(wide) if name == "text_K" else not any(wide)

    made, make = [], cli._make_backend

    def make_backend(opts):
        made.append(make(opts))
        return made[-1]
    monkeypatch.setattr(cli, "_make_backend", make_backend)
    compress = _cli([str(path), "-b", "K"])
    for suffix, body in want.files.items():
        assert (tmp_path / f"f.bin{suffix}").read_bytes() == body, suffix
    path.unlink()
    restore = _cli([str(path) + want.archive])
    assert path.read_bytes() == data.tobytes()

    assert [type(b) for b in made] == [dist.ShardedBackend] * 2
    for counters in (compress, restore):
        assert counters["dist_parts"] == parts
    # the .rle, kept in every case, is joined by one host copy
    assert compress["dist_join_bytes"] >= len(want.files[".rle"])
    assert restore["dist_join_bytes"] == 0  # the rows joined as a list
    assert restore["decode_blocks32" if name == "text_K"
                   else "decode_blocks16"] == n_blocks


def test_one_device_counts_nothing_of_the_split(tmp_path, monkeypatch):
    """One device: a plain TorchBackend, and no dist_* counter."""
    monkeypatch.setenv("SHAFA_TORCH_DEVICE", "cpu")
    monkeypatch.setitem(geometry.BLOCK_SIZE_BY_FLAG, "K", BLOCK)
    cfg = json.loads((BENCH / "configs" / "mixed_m_x4.json").read_text())
    data = gen.make_pool(cfg, 2 * BLOCK, 1, SEED, "cpu")[0]
    path = tmp_path / "f.bin"
    path.write_bytes(data.tobytes())
    counters = _cli([str(path), "-b", "K"])
    assert not [k for k in counters if k.startswith("dist_")]
    assert not [k for k in tracing.counters() if k.startswith("dist_")]
