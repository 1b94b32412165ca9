"""The readers of the backend over cards (``dist.*_ms_per_mb.*``): the
program's ``shafa.dist.run`` and ``shafa.dist.join`` spans summed inside
each direction's calls, per MB of their files, on a hand-made run; None
from a program without the spans (one card, or a checkout before them);
and all four in a whole traced CPU run whose program sees four devices."""

import json

import pytest
import torch

from conftest import MIXED_K, TINY, make_checkout
from harness import spec
from harness.record import Call, Run, Span

DIST = [f"dist.{kind}_ms_per_mb.{direction}"
        for kind in ("run", "join") for direction in ("compress",
                                                      "decompress")]


def _run(spans) -> Run:
    """A compress of a 2 MB file spanning [0, 100000) us on the trace's
    clock and a decompress spanning [200000, 300000)."""
    c = Call("compress", 0, 0, 2_000_000, 0.1, 0, {}, span_us=(0, 100_000))
    d = Call("decompress", 0, 0, 2_000_000, 0.1, 0, {},
             span_us=(200_000, 300_000))
    return Run("toy", {}, {}, 1.0, 4, "cpu", [c, d], 1.0, 1.0, traced=True,
               spans=[Span(*s) for s in spans])


def read(name, run):
    return spec.reader(name)(run)


def test_dist_sums_its_spans_inside_each_direction():
    run = _run([("bench.call.compress", 0, 100_000),
                ("shafa.dist.run", 1_000, 9_000),
                ("shafa.dist.run", 20_000, 21_000),
                ("shafa.dist.join", 21_000, 25_000),
                ("shafa.dist.worker.0", 1_000, 8_000),
                ("bench.between_calls", 100_000, 200_000),
                ("shafa.dist.run", 150_000, 160_000),  # between the calls
                ("shafa.dist.run", 210_000, 240_000),
                ("shafa.dist.join", 240_000, 240_500),
                ("shafa.dist.join", 350_000, 360_000)])  # after them
    # (8 + 1) ms and 4 ms in the compress, 30 and 0.5 ms in the
    # decompress, each over 2 MB
    want = {"dist.run_ms_per_mb.compress": 4.5,
            "dist.join_ms_per_mb.compress": 2.0,
            "dist.run_ms_per_mb.decompress": 15.0,
            "dist.join_ms_per_mb.decompress": 0.25}
    for name in DIST:
        assert read(name, run) == pytest.approx(want[name]), name


def test_dist_is_none_without_the_programs_spans():
    one_card = _run([("bench.call.compress", 0, 100_000),
                     ("shafa.backend.h2d", 1_000, 5_000),
                     ("shafa.dist.worker.0", 1_000, 5_000)])
    for name in DIST:
        assert read(name, one_card) is None, name
        assert read(name, Run("toy", {}, {}, 1.0, 4, "cpu", [], 1.0,
                              1.0)) is None


@pytest.mark.parametrize("devices", [4, 1])
def test_a_traced_cpu_run_reads_the_dist_spans(tmp_path, cpu_env,
                                               in_process, monkeypatch,
                                               capsys, devices):
    """Four devices: every dist metric reads above 0. One: the result
    line leaves them out, as from a program without the spans."""
    from harness.main import main
    from shafa_tpu_torch import dist
    monkeypatch.setattr(dist, "block_devices", lambda _=None: [
        torch.device("cpu")] * devices)
    cell = {"name": "mixed_K.tiny", "config": "mixed_K", "traffic": "tiny",
            "chips": 1, "why": "a tiny cell on the CPU"}
    ck = make_checkout(tmp_path, [cell], configs=[
        ("mixed_K", MIXED_K, {"source": "t", "reduced": [], "why": "t"})],
        traffic=[("tiny", TINY)])
    rc = main(["--workload", "mixed_K.tiny", "--seed", "5", "--seconds",
               "0.3", "--trace", "1"], require_chip=False, checkout=ck)
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    res = json.loads(out.out.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    for name in DIST:
        if devices > 1:
            assert res["metrics"][name]["value"] > 0, name
        else:
            assert name not in res["metrics"], name
