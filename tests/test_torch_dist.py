"""shafa_tpu_torch.dist (blocks spread over several devices), the dry-run
entry points (shafa_tpu_torch.dryrun against __graft_entry__.py) and the
CLI's --profile, on the CPU: three ``cpu`` devices stand in for three
cards, and every output must be the one-device backend's bytes."""

import json
import os
import sys
import threading

import numpy as np
import pytest

import __graft_entry__ as graft
from shafa_tpu import pipeline as jpipeline
from shafa_tpu_torch import cli, codes, device, dist, dryrun, pipeline
from shafa_tpu_torch.device import TorchBackend
from shafa_tpu_torch.profile_main_path import synthetic

from corpus import mixed

CPU3 = ["cpu"] * 3


@pytest.fixture
def sharded():
    backend = dist.ShardedBackend(CPU3)
    yield backend
    backend.close()


def _blocks(n=7, bs=4096, seed=7):
    """n blocks, the last one short: 3 devices do not divide 7."""
    data = synthetic(n * bs - 1234, seed)
    return [np.frombuffer(data[i:i + bs], np.uint8)
            for i in range(0, len(data), bs)]


def _same_rows(a, b):
    return len(a) == len(b) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


def test_per_stage_methods_match_one_device(sharded):
    blocks = _blocks()
    one = TorchBackend("cpu")
    rle = one.rle_encode(blocks)
    assert _same_rows(sharded.rle_encode(blocks), rle)
    hists = one.histogram(rle)
    assert _same_rows(sharded.histogram(rle), hists)
    tables = codes.build_code_tables(np.stack(hists))
    payloads = one.pack(rle, tables)
    assert sharded.pack(rle, tables) == payloads
    counts = [b.size for b in rle]
    assert _same_rows(sharded.unpack(payloads, tables, counts),
                      one.unpack(payloads, tables, counts))
    assert _same_rows(sharded.rle_expand(rle), one.rle_expand(rle))
    assert _same_rows(sharded.rle_expand(rle), blocks)
    # two blocks over three devices: one device gets none
    assert _same_rows(sharded.rle_encode(blocks[:2]), rle[:2])


@pytest.mark.parametrize("name", ["mixed", "incompressible"])
def test_fused_tier_matches_one_device(tmp_path, monkeypatch, sharded, name):
    """compress_pipeline and module_d_shafa through the sharded backend give
    the one-device backend's sidecars and the input back, with each
    device's range cut into several batches (two 16 KiB rows a batch)."""
    monkeypatch.setattr(device, "MAX_BATCH_ELEMS", 2 * (16 << 10))
    size = 11 * (16 << 10) - 999
    data = mixed(size, seed=9) if name == "mixed" else \
        np.random.default_rng(9).integers(0, 256, size).astype(
            np.uint8).tobytes()
    paths = {}
    for tag, backend in (("sharded", sharded), ("one", TorchBackend("cpu"))):
        sub = tmp_path / tag
        sub.mkdir()
        paths[tag] = str(sub / "data.bin")
        with open(paths[tag], "wb") as fp:
            fp.write(data)
        shaf, _ = pipeline.compress_pipeline(paths[tag], False, False,
                                             16 << 10, backend)
    files = {tag: {f: (tmp_path / tag / f).read_bytes()
                   for f in os.listdir(tmp_path / tag)} for tag in paths}
    assert files["sharded"] == files["one"]
    assert (".rle.shaf" in shaf) == (name == "mixed")
    os.rename(paths["sharded"], paths["sharded"] + ".orig")
    out, _ = pipeline.module_d_shafa(
        os.path.join(tmp_path / "sharded", os.path.basename(shaf)),
        ".rle." in shaf, sharded)
    with open(out, "rb") as fp:
        assert fp.read() == data


def test_host_decoded_count_under_many_workers(monkeypatch):
    """Sixteen workers (more than this box's cores) decode blocks that go to
    the host by design (no codes at all) at once: no bump of
    TorchBackend.host_decoded_blocks is lost."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    backend = dist.ShardedBackend(["cpu"] * 16)
    try:
        n = 16 * 40
        tables = codes.CodeTables(np.zeros((n, 256), np.uint8),
                                  np.zeros((n, 256), np.uint64))
        before = TorchBackend.host_decoded_blocks
        for _ in range(3):
            out = backend.fused_decode([b""] * n, tables, [0] * n, False)
            assert len(out) == n and all(o.size == 0 for o in out)
        assert TorchBackend.host_decoded_blocks == before + 3 * n
    finally:
        backend.close()
        sys.setswitchinterval(old)
    assert not any(t.name.startswith("shafa-cpu") and t.is_alive()
                   for t in threading.enumerate())


def test_cli_builds_the_sharded_backend(tmp_path, monkeypatch, capsys):
    """Several devices: the CLI spreads the blocks over them (one with
    --no-multithread), and its sidecars are the NumPy backend's."""
    monkeypatch.setenv("SHAFA_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(dist, "block_devices", lambda devices=None: [
        device.default_device()] * 3)
    made = []
    make = dist.make_backend
    monkeypatch.setattr(dist, "make_backend",
                        lambda *a, **k: made.append(make(*a, **k))
                        or made[-1])
    data = synthetic(300_000, 5)
    port, ref = str(tmp_path / "p.bin"), str(tmp_path / "r.bin")
    for p in (port, ref):
        with open(p, "wb") as fp:
            fp.write(data)
    assert cli.main([port, "-b", "K", "--check"]) == 0
    assert cli.main([ref, "-b", "K", "--backend", "numpy"]) == 0
    for ext in (".rle", ".rle.freq", ".rle.cod", ".rle.shaf"):
        with open(port + ext, "rb") as a, open(ref + ext, "rb") as b:
            assert a.read() == b.read(), ext
    assert cli.main([port + ".rle.shaf", "-m", "d", "--no-multithread"]) == 0
    assert [type(b).__name__ for b in made] == ["ShardedBackend",
                                                "TorchBackend"]
    with open(port, "rb") as fp:
        assert fp.read() == data
    capsys.readouterr()


def test_dryrun_multichip_matches_shafa_tpu(tmp_path):
    """dryrun_multichip over three devices (7 blocks of 64 KiB, the last
    ragged) gives shafa_tpu's sidecars for the same input."""
    sidecars = dryrun.dryrun_multichip(3, devices=CPU3)
    raw, _ = graft._example(batch=1, p=7 * (64 << 10) - 321, seed=1)
    path = str(tmp_path / "data.bin")
    with open(path, "wb") as fp:
        fp.write(raw[0].tobytes())
    jpipeline.compress_pipeline(path, False, False, 64 << 10,
                                jpipeline.NumpyBackend())
    want = {f[len("data.bin"):]: (tmp_path / f).read_bytes()
            for f in os.listdir(tmp_path) if f != "data.bin"}
    assert sidecars == want
    with pytest.raises(RuntimeError, match="need 4 devices"):
        dryrun.dryrun_multichip(4, devices=CPU3)


def test_entry_matches_graft_entry(monkeypatch):
    """dryrun.entry()'s encode step against __graft_entry__.entry()'s on the
    same example rows and code tables (JAX on the CPU)."""
    monkeypatch.setenv("SHAFA_TORCH_DEVICE", "cpu")
    fwd, args = dryrun.entry()
    packed, plen, hist, enc_len = (t.numpy() for t in fwd(*args))
    jfwd, jargs = graft.entry()
    for a, j in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(j).view(
            a.numpy().dtype))
    jpacked, jplen, jhist, jenc_len = (np.asarray(t) for t in jfwd(*jargs))
    assert np.array_equal(plen, jplen) and np.array_equal(hist, jhist)
    assert np.array_equal(enc_len, jenc_len)
    for r in range(packed.shape[0]):
        assert packed[r, :plen[r]].tobytes() == \
            jpacked[r, :jplen[r]].tobytes()
        assert not packed[r, plen[r]:].any()


def test_profile_writes_a_trace_and_leaves_the_bytes(tmp_path, monkeypatch,
                                                     capsys):
    monkeypatch.setenv("SHAFA_TORCH_DEVICE", "cpu")
    data = mixed(200_000, seed=6)
    a, b = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    for p in (a, b):
        with open(p, "wb") as fp:
            fp.write(data)
    trace_dir = tmp_path / "trace"
    assert cli.main([a, "-b", "K", "--profile", str(trace_dir)]) == 0
    assert cli.main([b, "-b", "K"]) == 0
    for ext in (".rle", ".rle.freq", ".rle.cod", ".rle.shaf"):
        with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
            assert fa.read() == fb.read(), ext
    os.rename(a, a + ".orig")
    assert cli.main([a + ".rle.shaf", "--profile", str(trace_dir)]) == 0
    with open(a, "rb") as fp:
        assert fp.read() == data
    traces = [f for f in os.listdir(trace_dir)
              if f.endswith(".pt.trace.json")]
    assert len(traces) == 2
    with open(trace_dir / traces[0]) as fp:
        names = {ev.get("name", "") for ev in json.load(fp)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    capsys.readouterr()


def test_failed_join_exits_1_without_output(tmp_path, monkeypatch, capsys):
    """A coordinator nobody serves: the join times out, the CLI exits 1 and
    writes nothing (no quiet one-process run)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("SHAFA_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"127.0.0.1:{port}")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "1")
    monkeypatch.setenv("SHAFA_JOIN_TIMEOUT", "1")
    path = str(tmp_path / "f.bin")
    with open(path, "wb") as fp:
        fp.write(synthetic(50_000, 1))
    assert cli.main([path, "-b", "K"]) == 1
    assert "multi-host join failed" in capsys.readouterr().err
    monkeypatch.setenv("PROCESS_ID", "2")  # rank outside the world
    assert cli.main([path, "-b", "K"]) == 1
    assert "multi-host join failed" in capsys.readouterr().err
    assert os.listdir(tmp_path) == ["f.bin"]
