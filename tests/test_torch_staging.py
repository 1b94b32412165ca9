"""How the backend stages copies (shafa_tpu_torch/device.py), on the CPU:
batches hold only their real rows, only each row's bytes go up and the
bytes past it are zeroed on the device, downloads land in one host buffer
that the results are views of, and --check compares those views."""

import numpy as np
import pytest
import torch

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
