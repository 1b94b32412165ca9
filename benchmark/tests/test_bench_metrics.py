"""Every metric has its reader, and each reader reads a recorded toy run."""

import json
import math

import pytest

from conftest import BENCH, ROOT
from harness import spec, trace
from harness.record import Call, DeviceEvent, Run, Span

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    names = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    files = {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")}
    assert names == files


def _toy(chips=1, traced=True) -> Run:
    """Two round trips of a 2 MB file: compress walls 0.2 and 0.4 s,
    decompress walls 0.1 s; on the trace's clock (us) the compresses span
    [0, 200000) and [1e6, 1.4e6), the decompresses [300000, 400000) and
    [1.5e6, 1.6e6)."""
    outs = {".rle": (1_000_000, "a"), ".rle.freq": (10, "b"),
            ".rle.cod": (20, "c"), ".rle.shaf": (500_000, "d")}
    calls = []
    spans = [(0, 200_000), (300_000, 400_000), (1_000_000, 1_400_000),
             (1_500_000, 1_600_000)]
    for k, (cw, dw) in enumerate([(0.2, 0.1), (0.4, 0.1)]):
        c = Call("compress", k, 0, 2_000_000, cw, 0, dict(outs))
        d = Call("decompress", k, 0, 2_000_000, dw, 0,
                 {"restored": (2_000_000, "e")})
        if traced:
            c.pipeline_s, c.backend_s, c.module_t_ms = cw - 0.01, 0.1, 2.0
            d.pipeline_s, d.backend_s = dw - 0.005, 0.05
            c.span_us, d.span_us = spans[2 * k], spans[2 * k + 1]
        calls += [c, d]
    run = Run("toy", {}, {}, 2.0, chips, "NVIDIA H100 80GB HBM3", calls,
              5.0, 2.0, traced=traced)
    if traced:
        ev = []
        for dev in range(chips):
            ev += [DeviceEvent(dev, "gpu_memcpy", "Memcpy HtoD", 10_000,
                               30_000),
                   DeviceEvent(dev, "kernel", "k8", 20_000, 40_000),
                   DeviceEvent(dev, "kernel", "k1", 1_100_000, 1_120_000),
                   DeviceEvent(dev, "gpu_memset", "Memset", 310_000,
                               320_000),
                   DeviceEvent(dev, "kernel", "other", 700_000, 800_000)]
        run.device_events = sorted(ev, key=lambda e: e.start_us)
        run.spans = [Span("bench.call.compress", 0, 200_000),
                     Span("pipeline.compress_pipeline", 5_000, 190_000),
                     Span("bench.between_calls", 200_000, 600_000)]
    return run


def read(name, run):
    return spec.reader(name)(run)


def test_end_to_end_readers():
    run = _toy(traced=False)
    assert read("compress_mb_s", run) == pytest.approx(4.0 / 0.6)
    assert read("decompress_mb_s", run) == pytest.approx(4.0 / 0.2)
    assert read("setup_s", run) == 5.0


@pytest.mark.parametrize("chips", [1, 4])
def test_per_layer_readers_on_a_toy_trace(chips):
    run = _toy(chips)
    assert read("cli.self_ms.compress", run) == pytest.approx(10.0)
    assert read("cli.self_ms.decompress", run) == pytest.approx(5.0)
    # (0.19 - 0.1) + (0.39 - 0.1) s of host time over 4 MB
    assert read("pipeline.host_ms_per_mb.compress", run) == \
        pytest.approx(380.0 / 4)
    assert read("codes.module_t_ms_per_mb", run) == pytest.approx(1.0)
    # one 20 ms copy a card, inside the first compress
    assert read("backend.copy_ms_per_mb.compress", run) == \
        pytest.approx(20.0 * chips / 4)
    assert read("backend.copy_ms_per_mb.decompress", run) == 0.0
    # compress: (2e6 + 1e6 + 5e5) B a call; kernels 20 + 20 ms a card
    bound_s = 2 * 3.5e6 / 3.35e12
    assert read("kernels.compress_roofline", run) == \
        pytest.approx(bound_s / (0.04 * chips) * 100)
    assert read("kernels.decompress_roofline", run) is None  # no kernels
    # busy in compress spans: [10, 40) ms and [1100, 1120) ms of 600 ms
    assert read("device.idle_share.compress", run) == \
        pytest.approx((1 - 50 / 600) * 100)
    assert read("device.idle_share.decompress", run) == \
        pytest.approx((1 - 10 / 200) * 100)


def test_readers_return_nothing_without_a_trace():
    run = _toy(traced=False)
    for m in SPEC["per_layer"]:
        assert read(m["name"], run) is None, m["name"]


def test_no_roofline_for_an_unknown_card():
    run = _toy()
    run.device_kind = "some other card"
    assert read("kernels.compress_roofline", run) is None


def test_breakdown_sums_ops_and_names_gaps():
    run = _toy()
    b = trace.breakdown(run.device_events, run.spans, (0, 1_600_000))
    ops = dict(b["device_ops"])
    assert ops["other"] == pytest.approx(0.1)
    gaps = dict(b["idle_gaps"])
    # gaps [0, 10) and [40, 310) ms lie in the pipeline's span, [320, 700)
    # in the pacing's, [800, 1100) and [1120, 1600) in none
    assert gaps["pipeline.compress_pipeline"] == pytest.approx(0.28)
    assert gaps["bench.between_calls"] == pytest.approx(0.38)
    assert gaps["(no span)"] == pytest.approx(0.78)
    total = sum(gaps.values()) + trace.union_us(
        (e.start_us, e.end_us) for e in run.device_events) / 1e6
    assert math.isclose(total, 1.6)
