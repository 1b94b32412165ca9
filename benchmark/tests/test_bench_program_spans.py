"""The readers of the program's own spans: known values on a hand-made
run, nothing from a program without the spans, and both in a whole traced
CPU run of a tiny cell."""

import json

import pytest

from conftest import MIXED_K, TINY, make_checkout
from harness import spec
from harness.record import Call, Run, Span
from test_bench_cells import _run_in

IO = ("pipeline.file_io_ms_per_mb.compress",
      "pipeline.file_io_ms_per_mb.decompress")


def _run(spans) -> Run:
    """A compress of a 2 MB file spanning [0, 100000) us on the trace's
    clock and a decompress spanning [200000, 300000)."""
    c = Call("compress", 0, 0, 2_000_000, 0.1, 0, {}, span_us=(0, 100_000))
    d = Call("decompress", 0, 0, 2_000_000, 0.1, 0, {},
             span_us=(200_000, 300_000))
    return Run("toy", {}, {}, 1.0, 1, "cpu", [c, d], 1.0, 1.0, traced=True,
               spans=[Span(*s) for s in spans])


def read(name, run):
    return spec.reader(name)(run)


def test_file_io_sums_the_io_spans_inside_each_direction():
    run = _run([("bench.call.compress", 0, 100_000),
                ("shafa.pipeline.f", 1_000, 60_000),
                ("shafa.io.read.input", 1_000, 5_000),
                ("shafa.io.write.rle", 40_000, 46_000),
                ("shafa.io.write.shaf", 90_000, 91_000),
                ("pipeline._read_blocks", 1_000, 5_000),
                ("bench.between_calls", 100_000, 200_000),
                ("shafa.io.read.cod", 210_000, 210_500),
                ("shafa.io.write.restored", 250_000, 270_000),
                ("shafa.io.write.restored", 350_000, 360_000)])  # outside
    # (4 + 6 + 1) ms and (0.5 + 20) ms, each over 2 MB
    assert read(IO[0], run) == pytest.approx(5.5)
    assert read(IO[1], run) == pytest.approx(10.25)


def test_file_io_is_none_without_the_programs_spans():
    parent = _run([("bench.call.compress", 0, 100_000),
                   ("pipeline._read_blocks", 1_000, 5_000)])
    for name in IO:
        assert read(name, parent) is None
        assert read(name, Run("toy", {}, {}, 1.0, 1, "cpu", [], 1.0,
                              1.0)) is None


def test_a_traced_cpu_run_reads_the_file_io(tmp_path):
    cell = {"name": "mixed_K.tiny", "config": "mixed_K", "traffic": "tiny",
            "chips": 1, "why": "a tiny cell on the CPU"}
    ck = make_checkout(tmp_path, [cell],
                       configs=[("mixed_K", MIXED_K,
                                 {"source": "test", "reduced": [],
                                  "why": "test"})],
                       traffic=[("tiny", TINY)])
    r = _run_in(ck, ["--workload", "mixed_K.tiny", "--seed", "3",
                     "--seconds", "0.5", "--trace", "1"])
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    for name in IO:
        assert res["metrics"][name]["value"] > 0, name
