"""The port's own spans and counters (shafa_tpu_torch/tracing.py) on a
300 kB CLI round trip on the CPU (the kernels' plain versions): the spans
in a torch.profiler trace, the counters against the files and the staged
arrays, the no-op span without a profiler, the streaming drivers' waits.

The round trip runs at 100,000-byte blocks (-b K patched), three of them,
in one device batch (MAX_BATCH_ELEMS patched to four rows): the batch has
the three rows that exist, and no padding row. The synthetic mix's codes
have at most 16 bits; a second round trip, of text with rare bytes, has
codes of 17 bits in every block, so its decode takes the other route."""

import contextlib
import io
import json
import os

import pytest
import torch

from shafa_tpu_torch import cli, device, dist, geometry, pipeline, tracing
from shafa_tpu_torch.profile_main_path import synthetic, text_with_rare_bytes

BLOCK = 100_000
SIZE = 300_000
SIDECARS = (".rle", ".rle.freq", ".rle.cod", ".rle.shaf")
#: The compress's flags: -b K, the R mode forced.
COMPRESS = ["-b", "K", "-c", "r"]

#: Spans each direction of the round trip must give, at least once, in a
#: profiler that records the calling thread (the .rle is written on the
#: writer thread: the caller records its wait for it).
SPANS = {
    "compress": {
        "shafa.cli.main", "shafa.cli.make_backend",
        "shafa.pipeline.f", "shafa.pipeline.t", "shafa.pipeline.c",
        "shafa.io.read.input", "shafa.overlap.wait_write",
        "shafa.io.write.freq",
        "shafa.io.write.cod", "shafa.io.write.shaf", "shafa.codes.build",
        "shafa.backend.stack", "shafa.backend.h2d", "shafa.backend.d2h",
        "shafa.backend.encode_batch", "shafa.backend.pack_batch",
        "shafa.backend.tables"},
    "decompress": {
        "shafa.cli.main", "shafa.cli.make_backend", "shafa.pipeline.d",
        "shafa.io.read.cod", "shafa.io.read.shaf", "shafa.io.write.restored",
        "shafa.backend.stack", "shafa.backend.h2d", "shafa.backend.d2h",
        "shafa.backend.tables"},
}
#: Each round trip's data, and the decode batch span of the route its
#: codes take (at most 16 bits, or 17-32); the other route's must not show.
DATA = {"synthetic": (lambda: synthetic(SIZE, 3),
                      "shafa.backend.decode_batch"),
        "text": (lambda: text_with_rare_bytes(SIZE),
                 "shafa.backend.decode_batch32")}
DECODE_SPANS = {route for _, route in DATA.values()}


def _cli(argv) -> dict:
    """cli.main(argv), which must succeed; the call's counters."""
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(argv) == 0
    return tracing.counters()


@contextlib.contextmanager
def _small_blocks():
    """-b K at BLOCK bytes, and device batches of four BLOCK rows."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SHAFA_TORCH_DEVICE", "cpu")
        mp.setitem(geometry.BLOCK_SIZE_BY_FLAG, "K", BLOCK)
        mp.setattr(device, "MAX_BATCH_ELEMS", 4 * device._bucket(BLOCK))
        yield


def _user_spans(trace_path: str) -> list[dict]:
    with open(trace_path) as fp:
        events = json.load(fp)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("ph") == "X"]


def _traced_round_trip(d, data: bytes, again: bool,
                       devices: int = 1) -> dict:
    """One round trip of data, each direction under its own CPU profiler,
    then, if again, a second compress of the same input with no profiler:
    the counters of each call, the trace's spans, and the sizes of the
    files each wrote or read. With devices > 1, that many ``cpu`` devices
    stand in for the cards of a host (dist.ShardedBackend)."""
    path = str(d / "a.bin")
    with open(path, "wb") as fp:
        fp.write(data)
    out = {"spans": {}, "counters": {}, "json": {}}
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with _small_blocks(), pytest.MonkeyPatch.context() as mp:
        if devices > 1:
            mp.setattr(dist, "block_devices", lambda _=None: [
                torch.device("cpu")] * devices)
        for direction, argv in (("compress", [path] + COMPRESS),
                                ("decompress", [path + ".rle.shaf"])):
            jpath = str(d / f"{direction}.json")
            with torch.profiler.profile(activities=cpu) as prof:
                out["counters"][direction] = _cli(argv + ["--json", jpath])
            with open(jpath) as fp:
                out["json"][direction] = json.load(fp)["counters"]
            tpath = str(d / f"{direction}.trace.json")
            prof.export_chrome_trace(tpath)
            out["spans"][direction] = _user_spans(tpath)
            if direction == "compress":
                out["sidecars"] = {e: os.path.getsize(path + e)
                                   for e in SIDECARS}
                os.rename(path, path + ".orig")
        with open(path, "rb") as fp:
            assert fp.read() == data
        out["restored"] = os.path.getsize(path)
        os.replace(path + ".orig", path)
        if again:
            out["again"] = _cli([path] + COMPRESS)
    return out


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    """The synthetic mix's traced round trip, and a second compress."""
    return _traced_round_trip(tmp_path_factory.mktemp("trace"),
                              DATA["synthetic"][0](), again=True)


@pytest.fixture(scope="module")
def text_round_trip(tmp_path_factory):
    """The text's traced round trip."""
    return _traced_round_trip(tmp_path_factory.mktemp("text"),
                              DATA["text"][0](), again=False)


@pytest.fixture(scope="module")
def four_round_trip(tmp_path_factory):
    """The synthetic mix's traced round trip over four devices."""
    return _traced_round_trip(tmp_path_factory.mktemp("four"),
                              DATA["synthetic"][0](), again=False,
                              devices=4)


def _inside(outer: dict, s: dict) -> bool:
    return outer["ts"] <= s["ts"] and \
        s["ts"] + s["dur"] <= outer["ts"] + outer["dur"]


def test_span_is_the_shared_noop_without_a_profiler(tmp_path, monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", entered)
    assert not tracing.recording()
    assert tracing.span("shafa.cli.main") is tracing.span("x") \
        is tracing._NOOP
    path = str(tmp_path / "a.bin")
    with open(path, "wb") as fp:
        fp.write(synthetic(SIZE, 3))
    with _small_blocks():
        _cli([path] + COMPRESS)
        os.remove(path)
        _cli([path + ".rle.shaf"])


@pytest.mark.parametrize("data", list(DATA))
@pytest.mark.parametrize("direction", ["compress", "decompress"])
def test_main_path_spans_are_in_the_trace(round_trip, text_round_trip,
                                          direction, data):
    trip = round_trip if data == "synthetic" else text_round_trip
    spans = trip["spans"][direction]
    names = {s["name"] for s in spans}
    assert SPANS[direction] <= names
    route = DATA[data][1]
    assert names & DECODE_SPANS == ({route} if direction == "decompress"
                                    else set())
    (main,) = [s for s in spans if s["name"] == "shafa.cli.main"]
    stages = [s for s in spans if s["name"].startswith("shafa.pipeline.")]
    for s in spans:
        assert _inside(main, s), s["name"]
        if s["name"].startswith("shafa.io."):
            assert any(_inside(p, s) for p in stages), s["name"]


@pytest.mark.parametrize("direction", ["compress", "decompress"])
def test_file_bytes_are_the_files_on_disk(round_trip, direction):
    c = round_trip["json"][direction]  # as --json reports them
    assert c == round_trip["counters"][direction]
    side = round_trip["sidecars"]
    if direction == "compress":
        assert c["file_read_bytes"] == SIZE
        assert c["file_written_bytes"] == sum(side.values())
    else:
        assert c["file_read_bytes"] == side[".rle.cod"] + side[".rle.shaf"]
        assert c["file_written_bytes"] == round_trip["restored"] == SIZE


def _h2d_bytes(size: int, rows_a_batch: list[int]) -> int:
    """What a compress of size bytes in batches of these rows uploads: the
    blocks' own bytes, and for each batch its rows' lengths; for the pack,
    the stream lengths, K1's two (rows, 256) int32 tables and the rows'
    word offsets."""
    return size + sum(4 * n + 4 * n + 2 * n * 256 * 4 + 4 * n
                      for n in rows_a_batch)


def test_h2d_bytes_are_the_staged_arrays(round_trip):
    """One batch of the three real rows, each row's real bytes only, all
    staged in pageable host memory on the CPU."""
    c = round_trip["counters"]["compress"]
    assert c["h2d_bytes"] == _h2d_bytes(SIZE, [SIZE // BLOCK])
    assert c["h2d_pageable_bytes"] == c["h2d_bytes"]
    assert c["d2h_pageable_bytes"] == c["d2h_bytes"] > 0
    assert c["encode_batches"] == c["pack_batches"] == 1
    assert c["decode_batches"] == c["host_decoded_blocks"] == 0
    assert round_trip["counters"]["decompress"]["decode_batches"] >= 1


def test_a_short_last_batch_uploads_only_its_rows(tmp_path):
    """Five blocks in batches of four: the second batch is one row, not a
    bucketed four, and the last block goes up without its tail."""
    size = 5 * BLOCK - 12_345
    path = str(tmp_path / "a.bin")
    data = synthetic(size, 4)
    with open(path, "wb") as fp:
        fp.write(data)
    with _small_blocks():
        c = _cli([path] + COMPRESS)
        os.rename(path, path + ".orig")
        _cli([path + ".rle.shaf"])
    with open(path, "rb") as fp:
        assert fp.read() == data
    assert c["encode_batches"] == c["pack_batches"] == 2
    assert c["h2d_bytes"] == _h2d_bytes(size, [4, 1])


def test_two_calls_report_equal_counters(round_trip):
    assert round_trip["again"] == round_trip["counters"]["compress"]


def test_streaming_drivers_span_their_waits(tmp_path, monkeypatch):
    path = str(tmp_path / "s.bin")
    data = synthetic(SIZE, 3)
    with open(path, "wb") as fp:
        fp.write(data)
    monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 100_000)
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with _small_blocks(), torch.profiler.profile(activities=cpu) as prof:
        _cli([path] + COMPRESS)
        os.remove(path)
        counts = _cli([path + ".rle.shaf"])
    with open(path, "rb") as fp:
        assert fp.read() == data
    assert counts["file_written_bytes"] == SIZE
    tpath = str(tmp_path / "trace.json")
    prof.export_chrome_trace(tpath)
    names = {s["name"] for s in _user_spans(tpath)}
    assert {"shafa.overlap.wait_read", "shafa.overlap.wait_write"} <= names


def test_rle_write_span_is_on_the_writer_thread(tmp_path):
    """Under --profile (every thread) the resident compress's one
    ``shafa.io.write.rle`` span is on another thread than the call's: it
    starts after module F has read the input (once the writer thread gets
    to it, which under load can be after F ends) and ends before the
    caller's ``shafa.overlap.wait_write`` does, which follows module C."""
    path = str(tmp_path / "a.bin")
    with open(path, "wb") as fp:
        fp.write(synthetic(SIZE, 3))
    prof = str(tmp_path / "prof")
    with _small_blocks():
        counts = _cli([path] + COMPRESS + ["--profile", prof])
    assert counts["writes_behind"] == 1
    (trace,) = [n for n in os.listdir(prof) if n.endswith(".pt.trace.json")]
    spans = {}
    for s in _user_spans(os.path.join(prof, trace)):
        spans.setdefault(s["name"], []).append(s)
    (rle,) = spans["shafa.io.write.rle"]
    (main,), (f,), (c,), (wait,) = (spans[n] for n in (
        "shafa.cli.main", "shafa.pipeline.f", "shafa.pipeline.c",
        "shafa.overlap.wait_write"))
    assert rle["tid"] != main["tid"] == f["tid"] == wait["tid"]
    (read,) = spans["shafa.io.read.input"]
    assert f["ts"] <= read["ts"] + read["dur"] < rle["ts"]
    assert c["ts"] + c["dur"] <= wait["ts"]
    assert rle["ts"] + rle["dur"] <= wait["ts"] + wait["dur"]


@pytest.mark.parametrize("direction", ["compress", "decompress"])
def test_four_devices_span_the_wait_and_the_join(four_round_trip,
                                                 direction):
    """A profiler of the calling thread, as the benchmark's, holds the
    caller's wait on the devices (``shafa.dist.run``) and its joins of their
    results (``shafa.dist.join``), inside the call; the workers' spans, and
    the one-device backends' spans they hold, are not in it."""
    spans = four_round_trip["spans"][direction]
    names = {s["name"] for s in spans}
    assert {"shafa.dist.run", "shafa.dist.join"} <= names
    assert not {n for n in names if n.startswith(("shafa.dist.worker.",
                                                  "shafa.backend."))}
    (main,) = [s for s in spans if s["name"] == "shafa.cli.main"]
    for s in spans:
        if s["name"].startswith("shafa.dist."):
            assert _inside(main, s) and s["tid"] == main["tid"], s["name"]
    c = four_round_trip["counters"][direction]
    assert c["dist_parts"] == SIZE // BLOCK  # three blocks, one a device
    assert c == four_round_trip["json"][direction]
    if direction == "compress":  # the .rle's host copy among the joins
        assert c["dist_join_bytes"] >= four_round_trip["sidecars"][".rle"]
    else:
        assert c["dist_join_bytes"] == 0


@pytest.mark.parametrize("direction", ["compress", "decompress"])
def test_one_device_has_no_dist_span_or_counter(round_trip, direction):
    names = {s["name"] for s in round_trip["spans"][direction]}
    assert not {n for n in names if n.startswith("shafa.dist.")}
    assert not {n for n in round_trip["counters"][direction]
                if n.startswith("dist_")}
