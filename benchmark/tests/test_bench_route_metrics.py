"""The readers of the code tables' spans and of the 17-32-bit decode route:
known values on a hand-made run, nothing from a program without the spans
or a call that holds a batch of the other route, and the tables in a
whole traced CPU run of a tiny text cell at -b K."""

import json

import pytest

from conftest import TINY, make_checkout
from harness import spec
from harness.record import Call, DeviceEvent, Run, Span
from test_bench_cells import _run_in

TABLES = ("backend.tables_ms_per_mb.compress",
          "backend.tables_ms_per_mb.decompress")
WIDE = "kernels.wide_decode_roofline"
ARCHIVE = 500_000


def _run(spans, events=(), kind="NVIDIA H100 80GB HBM3") -> Run:
    """Two round trips of a 2 MB file whose archive has ARCHIVE bytes; on
    the trace's clock (us) the compresses span [0, 100000) and
    [400000, 500000), the decompresses [200000, 300000) and
    [600000, 700000)."""
    calls = []
    for k, base in enumerate((0, 400_000)):
        c = Call("compress", k, 0, 2_000_000, 0.1, 0,
                 {".rle": (1_000_000, "a"), ".rle.shaf": (ARCHIVE, "b")},
                 span_us=(base, base + 100_000))
        d = Call("decompress", k, 0, 2_000_000, 0.1, 0,
                 {"restored": (2_000_000, "c")},
                 span_us=(base + 200_000, base + 300_000))
        calls += [c, d]
    return Run("toy", {}, {}, 1.0, 1, kind, calls, 1.0, 1.0, traced=True,
               device_events=[DeviceEvent(0, *e) for e in events],
               spans=[Span(*s) for s in spans])


def read(name, run):
    return spec.reader(name)(run)


#: The program's spans: tables in both compresses and both decompresses;
#: decompress 0 decodes two batches of the 17-32-bit route, decompress 1
#: one of each route.
SPANS = [("bench.call.compress", 0, 100_000),
         ("shafa.backend.tables", 10_000, 12_000),
         ("shafa.backend.tables", 50_000, 53_000),
         ("bench.call.decompress", 200_000, 300_000),
         ("shafa.backend.decode_batch32", 210_000, 250_000),
         ("shafa.backend.tables", 211_000, 215_000),
         ("shafa.backend.decode_batch32", 250_000, 280_000),
         ("bench.call.compress", 400_000, 500_000),
         ("shafa.backend.tables", 410_000, 411_000),
         ("bench.call.decompress", 600_000, 700_000),
         ("shafa.backend.decode_batch", 610_000, 640_000),
         ("shafa.backend.tables", 611_000, 613_000),
         ("shafa.backend.decode_batch32", 640_000, 660_000),
         ("shafa.backend.tables", 900_000, 950_000)]  # outside every call
#: Kernels: 10 ms and 5 ms inside decompress 0's wide batches; a copy
#: there; a kernel of decompress 0 outside its batches; kernels of
#: decompress 1 (both routes) and of a compress.
EVENTS = [("kernel", "k8", 20_000, 30_000),
          ("kernel", "k5", 216_000, 226_000),
          ("gpu_memcpy", "Memcpy HtoD", 230_000, 240_000),
          ("kernel", "k6", 255_000, 260_000),
          ("kernel", "tail", 285_000, 295_000),
          ("kernel", "k3", 620_000, 630_000),
          ("kernel", "k6", 645_000, 650_000)]


def test_tables_sum_the_tables_spans_inside_each_direction():
    run = _run(SPANS, EVENTS)
    # (2 + 3 + 1) ms over 4 MB compressed; (4 + 2) ms over 4 MB restored
    assert read(TABLES[0], run) == pytest.approx(1.5)
    assert read(TABLES[1], run) == pytest.approx(1.5)


def test_wide_roofline_reads_the_calls_of_the_wide_route_alone():
    """Decompress 0 alone: its least bytes (archive + restored) at
    3.35 TB/s over its 15 ms of kernels inside its wide batches."""
    got = read(WIDE, _run(SPANS, EVENTS))
    assert got == pytest.approx((ARCHIVE + 2_000_000) / 3.35e12 / 0.015
                                * 100.0)


def test_wide_roofline_is_none_for_a_call_that_holds_a_narrow_batch():
    narrow_call = [s for s in SPANS if not 200_000 <= s[1] < 300_000]
    assert read(WIDE, _run(narrow_call, EVENTS)) is None


def test_none_without_the_programs_spans_or_a_known_card():
    parent = [s for s in SPANS if s[0].startswith("bench.")] + [
        ("device.tables_to_device", 211_000, 215_000)]
    for name in TABLES + (WIDE,):
        assert read(name, _run(parent, EVENTS)) is None
        assert read(name, Run("toy", {}, {}, 1.0, 1, "cpu", [], 1.0,
                              1.0)) is None
    assert read(WIDE, _run(SPANS, EVENTS, kind="cpu")) is None
    assert read(WIDE, _run(SPANS)) is None  # no device events


TEXT_K = {"source": "test", "block_flag": "K", "block_bytes": 655360,
          "generator": {"name": "text"}, "reduced": []}


def test_a_traced_cpu_run_of_text_reads_the_tables(tmp_path):
    cell = {"name": "text_K.tiny", "config": "text_K_tiny",
            "traffic": "tiny", "chips": 1, "why": "a tiny cell on the CPU"}
    ck = make_checkout(tmp_path, [cell],
                       configs=[("text_K_tiny", TEXT_K,
                                 {"source": "test", "reduced": [],
                                  "why": "test"})],
                       traffic=[("tiny", TINY)])
    r = _run_in(ck, ["--workload", "text_K.tiny", "--seed", "2147483659",
                     "--seconds", "0.5", "--trace", "1"])
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    for name in TABLES:
        assert res["metrics"][name]["value"] > 0, name
    assert WIDE not in res["metrics"]  # no device events on the CPU
    assert "blocks by code length {'le16': 0, '17to32': 6, 'over32': 0}" \
        in r.stdout
