"""How the backend stages copies (shafa_tpu_torch/device.py), on the CPU:
batches hold only their real rows, only each row's bytes go up and the
bytes past it are zeroed on the device, rows read into a read buffer go
up from where they lie with no staging copy, downloads land in one host
buffer that the results are views of, and --check compares those
views."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import corpus
from shafa_tpu_torch import cli, dist, formats
from shafa_tpu_torch import codes as codes_mod
from shafa_tpu_torch import device, oracle, pipeline, tracing

CPU = torch.device("cpu")


@pytest.fixture
def dirty_memory(monkeypatch):
    """torch.empty on the device gives 0xFF bytes, as reused memory may."""
    empty = torch.empty

    def filled(*args, **kwargs):
        t = empty(*args, **kwargs)
        if not kwargs.get("pin_memory") and t.dtype == torch.uint8:
            t.fill_(0xFF)
        return t
    monkeypatch.setattr(torch, "empty", filled)


def _rows(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, s, dtype=np.uint8) for s in sizes]


def test_rows_go_up_with_zeros_past_their_lengths(dirty_memory):
    rows = _rows([1000, 0, 1024, 17])
    tracing.reset()
    x, lens, ld = device._upload_rows(rows, 1024, CPU)
    assert x.shape == (4, 1024)
    assert lens.tolist() == ld.tolist() == [1000, 0, 1024, 17]
    for r, got in zip(rows, x.numpy()):
        assert np.array_equal(got[:r.size], r)
        assert not got[r.size:].any()
    c = tracing.counters()
    assert c["h2d_bytes"] == sum(r.size for r in rows) + 4 * 4
    # row 0 alone, none for the empty row, the full row 2 with row 3, lens
    assert c["h2d_copies"] == 2 + 1


@pytest.mark.parametrize("run_bytes,copies", [(1 << 22, 1), (2048, 2),
                                              (1024, 4)])
def test_whole_rows_go_up_in_runs(monkeypatch, dirty_memory, run_bytes,
                                  copies):
    """Three rows of 1024 bytes and one of 100: one copy, or runs cut at
    RUN_BYTES; the bytes on the device are the same."""
    monkeypatch.setattr(device, "RUN_BYTES", run_bytes)
    rows = _rows([1024, 1024, 1024, 100], 4)
    tracing.reset()
    x, _, _ = device._upload_rows(rows, 1024, CPU)
    for r, got in zip(rows, x.numpy()):
        assert np.array_equal(got[:r.size], r)
        assert not got[r.size:].any()
    c = tracing.counters()
    assert c["h2d_copies"] == copies + 1
    assert c["h2d_bytes"] == 3 * 1024 + 100 + 4 * 4


def test_row_heads_come_down_in_one_copy():
    rows = torch.arange(5 * 64, dtype=torch.int32).to(torch.uint8)
    rows = rows.view(5, 64)
    sizes = [64, 0, 10, 64]  # the last row is not asked for
    heads = device._row_heads(rows, sizes)
    assert [h.numel() for h in heads] == sizes
    tracing.reset()
    got = device._download_bytes(heads)
    want = np.concatenate([rows[i, :s].numpy() for i, s in enumerate(sizes)])
    assert np.array_equal(got, want)
    c = tracing.counters()
    assert c["d2h_copies"] == 1 and c["d2h_bytes"] == sum(sizes)


@pytest.mark.parametrize("n_blocks,batches", [(5, [4, 1]), (8, [4, 4]),
                                              (3, [3])])
def test_batches_hold_only_their_real_rows(monkeypatch, dirty_memory,
                                           n_blocks, batches):
    monkeypatch.setattr(device, "MAX_BATCH_ELEMS", 4 * 1024)
    sizes = [1000] * (n_blocks - 1) + [333]
    blocks = _rows(sizes, n_blocks)
    h = device.TorchBackend(CPU).upload_blocks(blocks)
    assert [len(b["lens"]) for b in h.batches] == batches
    assert [tuple(b["x"].shape) for b in h.batches] == \
        [(n, 1024) for n in batches]
    x = torch.cat([b["x"] for b in h.batches]).numpy()
    for blk, row in zip(blocks, x):
        assert np.array_equal(row[:blk.size], blk)
        assert not row[blk.size:].any()


def test_short_decode_batch_has_no_padding_rows(monkeypatch, dirty_memory):
    """Five payloads in decode batches of four: a batch of four and one of
    one row, each with its own table; the blocks decode as the oracle's."""
    monkeypatch.setattr(device, "MAX_BATCH_ELEMS", 8 * 4096)
    blocks = _rows([3000, 2500, 3000, 1200, 700], 7)
    hists = np.stack([oracle.histogram(b) for b in blocks])
    tables = codes_mod.build_code_tables(hists)
    payloads = [oracle.pack(b, tables.lens[i], tables.vals[i])
                for i, b in enumerate(blocks)]
    counts = [b.size for b in blocks]
    tb = device.TorchBackend(CPU)
    batches = list(tb.decode_batches(payloads, tables, counts,
                                     list(range(5)), wide=False))
    assert [len(bt.blocks) for bt in batches] == [4, 1]
    assert [bt.payload.shape[0] for bt in batches] == [4, 1]
    assert [bt.counts.tolist() for bt in batches] == [counts[:4], counts[4:]]
    out = tb.fused_decode(payloads, tables, counts, expand=False)
    for b, o in zip(blocks, out):
        assert np.array_equal(o, b)


def test_download_packed_gives_views_of_one_host_buffer():
    rng = np.random.default_rng(3)
    flat = torch.from_numpy(rng.integers(-2**31, 2**31, 1000,
                                         dtype=np.int64).astype(np.int32))
    woff, byte_lens = [0, 128, 512], [5, 0, 1001]
    tracing.reset()
    got = device.download_packed(flat, woff, byte_lens)
    # the rows' span in one copy
    assert tracing.counters()["d2h_copies"] == 1
    assert tracing.counters()["d2h_bytes"] == 4 * 512 + 1001
    raw = flat.numpy().view(np.uint8)
    assert all(isinstance(g, memoryview) for g in got)
    assert [bytes(g) for g in got] == [raw[4 * w:4 * w + n].tobytes()
                                       for w, n in zip(woff, byte_lens)]
    # one buffer, which its views keep alive
    assert got[0].obj.base is got[2].obj.base is not None


def test_check_compares_memoryview_payloads():
    checked = pipeline.CheckedBackend(device.TorchBackend(CPU))
    buf = np.arange(10, dtype=np.uint8)
    got = [memoryview(buf[:4]), memoryview(buf[4:4])]
    assert checked._cmp("pack", got, [bytes(range(4)), b""]) is got
    with pytest.raises(AssertionError, match="pack mismatch"):
        checked._cmp("pack", got, [bytes([0, 1, 2, 4]), b""])
    with pytest.raises(AssertionError, match="at block 1"):
        checked._cmp("pack", got, [bytes(range(4)), b"\0"])


def _read_rows(sizes, seed=0, alloc=None):
    """Rows of these sizes read, as the resident compress reads its input,
    into one read buffer for the CPU (or alloc's buffer): views of it."""
    data = np.concatenate(_rows(sizes, seed)).tobytes()
    return pipeline._read_blocks(
        io.BytesIO(data), sizes,
        alloc=alloc or device.TorchBackend(CPU).read_buffer)


def _spans(fn):
    """fn()'s result and the names of the spans recorded while it ran."""
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=cpu) as prof:
        out = fn()
    return out, {e.name for e in prof.events()}


#: rows at P, and a short last row; rows narrower than P, and a short last
#: row; a read buffer's rows between rows that lie elsewhere; with the
#: copies each takes (the lengths' upload aside)
READ_CASES = {
    "at_p": ([1024, 1024, 1024, 100], [True] * 4, 1),
    "narrower": ([640, 640, 640, 100], [True] * 4, 4),
    "mixed": ([1024, 1024, 1024, 100], [True, False, True, True], 3),
}


@pytest.mark.parametrize("case", list(READ_CASES))
def test_rows_in_a_read_buffer_go_up_from_where_they_lie(dirty_memory,
                                                         case):
    sizes, in_buffer, copies = READ_CASES[case]
    read = _read_rows(sizes, 5)
    rows = [r if inside else r.copy() for r, inside in zip(read, in_buffer)]
    tracing.reset()
    (x, lens, ld), names = _spans(lambda: device._upload_rows(rows, 1024,
                                                             CPU))
    assert x.shape == (4, 1024) and lens.tolist() == ld.tolist() == sizes
    for r, got in zip(rows, x.numpy()):
        assert np.array_equal(got[:r.size], r)
        assert not got[r.size:].any()
    c = tracing.counters()
    assert c["h2d_bytes"] == sum(sizes) + 4 * 4  # real bytes, the lengths
    assert c["h2d_copies"] == copies + 1
    assert c["staged_read_bytes"] == sum(
        s for s, inside in zip(sizes, in_buffer) if inside)
    assert ("shafa.backend.stack" in names) == (not all(in_buffer))


@pytest.mark.parametrize("run_bytes,copies", [(2048, 2), (1024, 4)])
def test_rows_at_p_in_a_read_buffer_go_up_in_runs(monkeypatch, dirty_memory,
                                                  run_bytes, copies):
    monkeypatch.setattr(device, "RUN_BYTES", run_bytes)
    rows = _read_rows([1024, 1024, 1024, 100], 6)
    tracing.reset()
    x, _, _ = device._upload_rows(rows, 1024, CPU)
    assert np.array_equal(x.numpy().reshape(-1)[:3 * 1024 + 100],
                          np.concatenate(rows))
    assert tracing.counters()["h2d_copies"] == copies + 1


def test_plain_host_memory_is_not_a_read_buffer():
    plain = _read_rows([100, 200], alloc=pipeline._host_buffer)
    staged = _read_rows([100, 200])
    assert [device._in_read_buffer(r) for r in plain] == [None, None]
    assert [device._in_read_buffer(r)[1] for r in staged] == [0, 100]
    # payloads parsed out of a read .shaf, through np.frombuffer: found
    buf = device.TorchBackend(CPU).read_buffer(6)
    buf[:] = np.frombuffer(b"@1@1@7", np.uint8)
    (payload,) = formats.parse_shaf_frames(buf)
    assert bytes(payload) == b"7"
    got = device._in_read_buffer(np.frombuffer(memoryview(payload),
                                               np.uint8))
    assert got[1] == 5 and got[0].data_ptr() == buf.ctypes.data


def test_two_devices_upload_their_ranges_of_one_read_buffer():
    """A ShardedBackend over two CPU entries slices one read buffer: each
    worker sends its range from it, and the results are one backend's."""
    sizes = [1000] * 4 + [333]
    sharded = dist.ShardedBackend([CPU, CPU])
    try:
        blocks = _read_rows(sizes, 8, alloc=sharded.read_buffer)
        tracing.reset()
        h = sharded.fused_encode(blocks)
        got = (sharded.fused_rle_bytes(h), sharded.fused_rle_hists(h))
        assert tracing.counters()["staged_read_bytes"] == sum(sizes)
        assert [sub.n_blocks for *_, sub in h.parts] == [2, 3]
    finally:
        sharded.close()
    one = device.TorchBackend(CPU)
    h1 = one.fused_encode([b.copy() for b in blocks])
    assert np.array_equal(got[0], one.fused_rle_bytes(h1))
    assert np.array_equal(got[1], one.fused_rle_hists(h1))


def test_oracle_routed_row_reads_its_bytes_from_the_read_buffer():
    """Row 1's codes pass 32 bits, so its payload comes from the oracle on
    host_row(1): the row's own bytes, where they lie in the read buffer."""
    blocks = _read_rows([3000, 2000])
    blocks[1][:] = np.arange(2000) % 35
    t0 = codes_mod.build_code_tables(oracle.histogram(blocks[0])[None])
    lens = np.zeros((1, 256), np.uint8)
    vals = np.zeros((1, 256), np.uint64)
    code = prev = 0
    for sym, ln in enumerate(list(range(1, 34)) + [34, 34]):
        code <<= ln - prev
        lens[0, sym], vals[0, sym] = ln, np.uint64(code) << np.uint64(64 - ln)
        code, prev = code + 1, ln
    tables = codes_mod.CodeTables(np.concatenate([t0.lens, lens]),
                                  np.concatenate([t0.vals, vals]))
    asked = []

    def host_row(i):
        asked.append(device._in_read_buffer(blocks[i]) is not None)
        return blocks[i]
    be = device.TorchBackend(CPU)
    got = be.fused_pack(be.fused_encode(blocks), tables, False, host_row)
    assert asked == [True]
    for i, b in enumerate(blocks):
        assert bytes(got[i]) == bytes(oracle.pack(b, tables.lens[i],
                                                  tables.vals[i]))


def _run_cli(argv) -> dict:
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(argv) == 0
    return tracing.counters()


@pytest.mark.parametrize("flag,size", [("K", 2 * 655_360 + 50_000),
                                       ("m", 300_000)])
def test_resident_round_trip_reads_into_the_read_buffer(tmp_path,
                                                        monkeypatch, flag,
                                                        size):
    """A CLI round trip on the CPU device: the sidecars are the NumPy
    backend's, the compress sends the whole input and the decode every
    payload from the buffer each was read into, and no row is staged."""
    monkeypatch.setenv("SHAFA_TORCH_DEVICE", "cpu")
    data = corpus.mixed(size, seed=11)
    paths = {}
    for name in ("torch", "numpy"):
        os.mkdir(tmp_path / name)
        paths[name] = str(tmp_path / name / "a.bin")
        with open(paths[name], "wb") as fp:
            fp.write(data)
    assert _run_cli([paths["numpy"], "-b", flag, "-c", "r", "--backend",
                     "numpy"])["staged_read_bytes"] == 0
    comp, names = _spans(lambda: _run_cli([paths["torch"], "-b", flag,
                                           "-c", "r"]))
    assert comp["staged_read_bytes"] == size
    assert "shafa.backend.stack" not in names
    for ext in (".rle", ".rle.freq", ".rle.cod", ".rle.shaf"):
        with open(paths["torch"] + ext, "rb") as a, \
                open(paths["numpy"] + ext, "rb") as b:
            assert a.read() == b.read(), ext
    with open(paths["torch"] + ".rle.shaf", "rb") as fp:
        payload_bytes = sum(len(p) for p in
                            formats.parse_shaf_frames(fp.read()))
    os.remove(paths["torch"])
    dec, names = _spans(lambda: _run_cli([paths["torch"] + ".rle.shaf"]))
    assert dec["staged_read_bytes"] == payload_bytes
    assert "shafa.backend.stack" not in names
    with open(paths["torch"], "rb") as fp:
        assert fp.read() == data
