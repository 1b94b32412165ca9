"""shafa_tpu_torch's multi-host drivers (pipeline.compress_multihost and
decompress_multihost over multihost.py's process layer) against
shafa_tpu's multi-host compress and decompress and the one-process
pipelines, byte for byte, on the CPU (SHAFA_TORCH_DEVICE=cpu).

Simulated hosts run compress_multihost / decompress_multihost in threads
with a barrier-backed Comm, as tests/test_multihost.py does for the JAX
package; two real processes join over gloo through the CLI's environment
(COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID). Inputs are seeded
(profile_main_path.synthetic, numpy)."""

import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from shafa_tpu import multihost as jmultihost
from shafa_tpu import pipeline as jpipeline
from shafa_tpu_torch import cli, formats, multihost, pipeline
from shafa_tpu_torch.device import TorchBackend
from shafa_tpu_torch.profile_main_path import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 32 << 10


class ThreadComm(multihost.Comm):
    """N simulated hosts in one process; allgather = barrier + concat."""

    def __init__(self, state, index):
        self._state = state
        self._index = index

    @property
    def index(self):
        return self._index

    @property
    def count(self):
        return self._state["count"]

    def allgather(self, local):
        st = self._state
        st["slots"][self._index] = np.asarray(local)
        st["barrier"].wait(timeout=60)
        out = np.concatenate(st["slots"], axis=0)
        st["barrier"].wait(timeout=60)  # no slot reused before all read
        return out

    def barrier(self):
        self._state["barrier"].wait(timeout=60)


def _run_hosts(hosts, fn):
    state = {"count": hosts, "slots": [None] * hosts,
             "barrier": threading.Barrier(hosts)}
    errs = []

    def run(pi):
        try:
            fn(ThreadComm(state, pi))
        except BaseException as e:  # noqa: BLE001 - surface to main thread
            errs.append(e)
            state["barrier"].abort()

    threads = [threading.Thread(target=run, args=(pi,))
               for pi in range(hosts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    if errs:
        raise errs[0]


def _write(sub, data):
    sub.mkdir()
    path = str(sub / "data.bin")
    with open(path, "wb") as fp:
        fp.write(data)
    return path


def _files(sub):
    return {f: (sub / f).read_bytes() for f in sorted(os.listdir(sub))}


def _compress_refs(tmp, data):
    """The port's one-process compress and shafa_tpu's NumPy-backend one."""
    port = _write(tmp / "single", data)
    pipeline.compress_pipeline(port, False, False, BS, TorchBackend("cpu"))
    ref = _write(tmp / "jax_numpy", data)
    jpipeline.compress_pipeline(ref, False, False, BS,
                                jpipeline.NumpyBackend())
    return tmp / "single", tmp / "jax_numpy"


def _compress_multi(tmp, data, hosts):
    path = _write(tmp / f"multi{hosts}", data)
    backend = TorchBackend("cpu")
    _run_hosts(hosts, lambda comm: pipeline.compress_multihost(
        path, BS, backend, comm=comm))
    return tmp / f"multi{hosts}"


@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_multihost_compress_matches_single(tmp_path, hosts):
    data = synthetic(300_000, 21)  # 10 blocks
    single, ref = _compress_refs(tmp_path, data)
    multi = _compress_multi(tmp_path, data, hosts)
    assert ".rle.shaf" in "".join(_files(multi))
    assert _files(multi) == _files(single) == _files(ref)


@pytest.mark.parametrize("hosts", [2, 4])
def test_multihost_roundtrip(tmp_path, hosts):
    data = synthetic(250_000, 22)
    sub = _compress_multi(tmp_path, data, hosts)
    os.rename(sub / "data.bin", sub / "data.orig")
    backend = TorchBackend("cpu")
    outs = []
    _run_hosts(hosts, lambda comm: outs.append(pipeline.decompress_multihost(
        str(sub / "data.bin.rle.shaf"), backend, comm=comm)))
    assert outs == [str(sub / "data.bin")] * hosts
    assert (sub / "data.bin").read_bytes() == data


def test_multihost_incompressible_n_mode(tmp_path):
    data = np.random.default_rng(7).integers(0, 256, 150_000) \
        .astype(np.uint8).tobytes()
    single, ref = _compress_refs(tmp_path, data)
    multi = _compress_multi(tmp_path, data, 2)
    assert sorted(_files(multi)) == ["data.bin", "data.bin.cod",
                                     "data.bin.freq", "data.bin.shaf"]
    assert _files(multi) == _files(single) == _files(ref)
    os.rename(multi / "data.bin", multi / "data.orig")
    _run_hosts(2, lambda comm: pipeline.decompress_multihost(
        str(multi / "data.bin.shaf"), TorchBackend("cpu"), comm=comm))
    assert (multi / "data.bin").read_bytes() == data


@pytest.mark.parametrize("n", [0, 1, 7, 64, 1000])
def test_partition_and_frame_offsets_match_originals(n):
    for h in (1, 2, 5, 16):
        for i in range(h):
            got = multihost.partition_blocks(n, h, i)
            want = jmultihost.partition_blocks(n, h, i)
            assert (got.lo, got.hi, got.n) == (want.lo, want.hi, want.n)
    sizes = np.random.default_rng(n).integers(0, 1 << 20, n)
    got, want = multihost.shaf_offsets(sizes), jmultihost.shaf_offsets(sizes)
    assert got[1] == want[1] and np.array_equal(got[0], want[0])
    assert multihost.shaf_frame(b"abc") == jmultihost.shaf_frame(b"abc")


@pytest.mark.parametrize("sizes", [
    [0, 1, 5, 300, 7] * 40,          # many frames per chunk
    [5000, 3, 9000, 0, 4097, 12],     # frames larger than the chunk
])
def test_scan_shaf_offsets_matches_original(tmp_path, monkeypatch, sizes):
    monkeypatch.setattr(multihost, "_SCAN_CHUNK", 4096)
    monkeypatch.setattr(jmultihost, "_SCAN_CHUNK", 4096)
    rng = np.random.default_rng(len(sizes))
    payloads = [rng.integers(0, 256, s).astype(np.uint8).tobytes()
                for s in sizes]
    path = str(tmp_path / "x.shaf")
    with open(path, "wb") as fp:
        formats.write_shaf_header(fp, len(payloads))
        for p in payloads:
            formats.write_shaf_block(fp, p)
    offs, got_sizes, n = multihost.scan_shaf_offsets(path)
    w_offs, w_sizes, w_n = jmultihost.scan_shaf_offsets(path)
    assert n == w_n == len(sizes)
    assert np.array_equal(offs, w_offs) and np.array_equal(got_sizes, w_sizes)
    blob = open(path, "rb").read()
    assert [blob[o:o + s] for o, s in zip(offs, got_sizes)] == payloads


def test_stale_file_truncated(tmp_path):
    data = synthetic(200_000, 23)
    sub = _compress_multi(tmp_path, data, 2)
    good = (sub / "data.bin.rle.shaf").read_bytes()
    with open(sub / "data.bin.rle.shaf", "ab") as fp:
        fp.write(b"garbage")
    _run_hosts(2, lambda comm: pipeline.compress_multihost(
        str(sub / "data.bin"), BS, TorchBackend("cpu"), comm=comm))
    assert (sub / "data.bin.rle.shaf").read_bytes() == good
    multihost.write_at(str(sub / "w"), 3, b"xy", total_size=8)
    multihost.write_at(str(sub / "w"), 0, b"ab")
    assert (sub / "w").read_bytes() == b"ab\0xy\0\0\0"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _port_cli(args, nprocs):
    """python -m shafa_tpu_torch ARGS in nprocs processes joined over gloo;
    each gets 120 s."""
    port = _free_port()
    procs = []
    for pid in range(nprocs):
        env = dict(os.environ, SHAFA_TORCH_DEVICE="cpu",
                   COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES=str(nprocs), PROCESS_ID=str(pid),
                   SHAFA_JOIN_TIMEOUT="60")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "shafa_tpu_torch", *args], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    return [out for out, _ in outs]


def test_two_processes_over_gloo_match_one_process(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.setenv("SHAFA_TORCH_DEVICE", "cpu")
    data = synthetic(700_000, 24)  # 2 blocks at -b K, one a process
    mh = _write(tmp_path / "mh", data)
    one = _write(tmp_path / "one", data)
    outs = _port_cli([mh, "-b", "K"], 2)
    assert "Multihost compress (2 hosts)" in outs[0] and not outs[1]
    assert cli.main([one, "-b", "K"]) == 0
    capsys.readouterr()
    assert _files(tmp_path / "mh") == _files(tmp_path / "one")
    os.rename(mh, mh + ".orig")
    outs = _port_cli([mh + ".rle.shaf"], 2)
    assert "Multihost decompress (2 hosts)" in outs[0]
    with open(mh, "rb") as fp:
        assert fp.read() == data
