"""The whole CLI round trip of shafa_tpu_torch on the CPU
(SHAFA_TORCH_DEVICE=cpu): its sidecars against the JAX package's CLI with
the NumPy backend, byte for byte, and the round trip against the input.

The port runs as ``python -m shafa_tpu_torch`` in a fresh process, which
also reports whether jax was ever imported there."""

import json
import os
import subprocess
import sys

import pytest

from shafa_tpu import cli as jcli
from shafa_tpu_torch import cli

from corpus import incompressible, mixed, runs_heavy, text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: runs ``python -m shafa_tpu_torch ARGS`` once per argument list (runpy,
#: as -m does) and prints the exit codes and whether jax was imported
RUN_MODULE = r"""
import json, runpy, sys
rcs = []
for argv in json.loads(sys.argv[1]):
    sys.argv = ["shafa_tpu_torch"] + argv
    try:
        runpy.run_module("shafa_tpu_torch", run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        rcs.append(e.code)
print(json.dumps({"rcs": rcs, "jax": "jax" in sys.modules}))
"""


def _port(runs, env_extra=None):
    env = dict(os.environ, SHAFA_TORCH_DEVICE="cpu")
    env.update(env_extra or {})
    r = subprocess.run([sys.executable, "-c", RUN_MODULE, json.dumps(runs)],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=600)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def _write(path, data):
    with open(path, "wb") as fp:
        fp.write(data)
    return path


CORPORA = {
    "mixed": lambda: mixed(300_000, seed=21),
    "text": lambda: text(200_000, seed=22),
    "incompressible": lambda: incompressible(150_000, seed=23),  # N mode
    "runs_heavy": lambda: runs_heavy(400_000, seed=24),
}


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_cli_round_trip_matches_numpy_backend(tmp_path, name):
    data = CORPORA[name]()
    compress, decompress, cases = [], [], []
    for tag, flags in (("K", ["-b", "K"]), ("default", [])):
        port = _write(str(tmp_path / f"port_{tag}.bin"), data)
        ref = _write(str(tmp_path / f"ref_{tag}.bin"), data)
        assert jcli.main([ref, "--backend", "numpy", *flags]) == 0
        mode_r = os.path.exists(ref + ".rle")
        assert not (mode_r and name == "incompressible")
        exts = ([".rle", ".rle.freq", ".rle.cod", ".rle.shaf"] if mode_r
                else [".freq", ".cod", ".shaf"])
        compress.append([port, *flags])
        decompress.append([port + exts[-1]])
        cases.append((port, ref, exts))
    res = [_port(compress)]
    for port, _, _ in cases:  # decompression writes the input's path
        os.rename(port, port + ".orig")
    res.append(_port(decompress))
    assert [rc for r in res for rc in r["rcs"]] == [0, 0, 0, 0]
    assert not any(r["jax"] for r in res)
    for port, ref, exts in cases:
        for ext in exts:
            with open(port + ext, "rb") as a, open(ref + ext, "rb") as b:
                assert a.read() == b.read(), f"{ext} differs"
        with open(port, "rb") as fp:
            assert fp.read() == data


@pytest.mark.parametrize("name", ["mixed", "incompressible"])
def test_fused_tier_over_several_batches(tmp_path, monkeypatch, capsys,
                                         name):
    """Batches of two 64 KiB rows: five blocks (the last one ragged) run
    the fused encode, pack and decode loops over several batches, the last
    of them short; sidecars still equal the NumPy backend's."""
    from shafa_tpu import formats
    from shafa_tpu_torch import device
    from shafa_tpu_torch.kernels import decode as kdecode
    from shafa_tpu_torch.kernels import rle as krle
    monkeypatch.setenv("SHAFA_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(device, "MAX_BATCH_ELEMS", 2 * (64 << 10))
    calls = {"encode": 0, "decode": 0}

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(krle, "rle_encode_hist",
                        counted("encode", krle.rle_encode_hist))
    monkeypatch.setattr(kdecode, "decode_batch",
                        counted("decode", kdecode.decode_batch))
    size = 4 * (64 << 10) + 20_000
    data = (mixed(size, seed=25) if name == "mixed"
            else incompressible(size, seed=26))
    port = _write(str(tmp_path / "port.bin"), data)
    ref = _write(str(tmp_path / "ref.bin"), data)
    assert cli.main([port]) == 0
    assert cli.main([ref, "--backend", "numpy"]) == 0
    exts = ([".rle", ".rle.freq", ".rle.cod", ".rle.shaf"]
            if name == "mixed" else [".freq", ".cod", ".shaf"])
    for ext in exts:
        with open(port + ext, "rb") as a, open(ref + ext, "rb") as b:
            assert a.read() == b.read(), f"{ext} differs"
    # decode batches of two rows too: the cap is in padded payload bytes
    p = device._bucket(max(map(len, formats.read_shaf(port + exts[-1]))),
                       minimum=1024)
    monkeypatch.setattr(device, "MAX_BATCH_ELEMS", 2 * p * 2)
    os.rename(port, port + ".orig")
    assert cli.main([port + exts[-1]]) == 0
    with open(port, "rb") as fp:
        assert fp.read() == data
    assert calls == {"encode": 3, "decode": 3}  # rows 2 + 2 + 1 each
    capsys.readouterr()


def test_cli_without_cuda_exits_1(tmp_path, monkeypatch, capsys):
    import torch
    monkeypatch.delenv("SHAFA_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _write(str(tmp_path / "f.bin"), mixed(5000, seed=1))
    assert cli.main([path]) == 1
    assert "CUDA device not available" in capsys.readouterr().err
    assert not os.path.exists(path + ".rle")


def test_cli_refusals(tmp_path, monkeypatch, capsys):
    from shafa_tpu_torch import pipeline
    monkeypatch.setenv("SHAFA_TORCH_DEVICE", "cpu")
    path = _write(str(tmp_path / "f.bin"), mixed(5000, seed=2))
    assert cli.parse([path, "--backend", "jax"]) is None
    assert cli.main([path, "--backend", "jax"]) == 1
    assert "Wrong Options' syntax" in capsys.readouterr().err
    # --profile runs (tests/test_torch_dist.py holds its outputs and trace)
    prof = _write(str(tmp_path / "h.bin"), mixed(5000, seed=2))
    assert cli.main([prof, "--profile", str(tmp_path / "p")]) == 0
    assert any(n.endswith(".pt.trace.json")
               for n in os.listdir(tmp_path / "p"))
    capsys.readouterr()
    # a multi-host join that cannot happen (no NUM_PROCESSES) exits 1
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    assert cli.main([path]) == 1
    assert "multi-host join failed" in capsys.readouterr().err
    monkeypatch.delenv("COORDINATOR_ADDRESS")
    assert not os.path.exists(path + ".rle")
    # above the threshold the CLI streams, and its sidecars are the NumPy
    # backend's
    monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 4096)
    streamed = []
    stream = pipeline.compress_pipeline_streaming
    monkeypatch.setattr(pipeline, "compress_pipeline_streaming",
                        lambda p, *a: streamed.append(p) or stream(p, *a))
    ref = _write(str(tmp_path / "g.bin"), mixed(5000, seed=2))
    assert cli.main([path]) == 0
    assert cli.main([ref, "--backend", "numpy"]) == 0
    assert streamed == [path]
    for ext in (".rle", ".rle.freq", ".rle.cod", ".rle.shaf"):
        with open(path + ext, "rb") as a, open(ref + ext, "rb") as b:
            assert a.read() == b.read(), ext


def test_per_stage_modules_check_and_no_multithread(tmp_path, monkeypatch,
                                                    capsys):
    """-m f/t/c/d, --check (every stage held against the oracle) and
    --no-multithread (per-stage tier) give the fused chain's files."""
    monkeypatch.setenv("SHAFA_TORCH_DEVICE", "cpu")
    data = mixed(120_000, seed=3)
    a = _write(str(tmp_path / "a.bin"), data)
    b = _write(str(tmp_path / "b.bin"), data)
    c = _write(str(tmp_path / "c.bin"), data)
    assert cli.main([a, "--check"]) == 0
    assert cli.main([b, "--no-multithread"]) == 0
    for args in ([c, "-m", "f"], [c + ".rle.freq", "-m", "t"],
                 [c + ".rle", "-m", "c"]):
        assert cli.main(args) == 0
    for ext in (".rle", ".rle.freq", ".rle.cod", ".rle.shaf"):
        with open(a + ext, "rb") as fa:
            want = fa.read()
        for other in (b, c):
            with open(other + ext, "rb") as fo:
                assert fo.read() == want, (other, ext)
    os.rename(a, a + ".orig")
    assert cli.main([a + ".rle.shaf", "--check"]) == 0
    os.rename(c, c + ".orig")
    assert cli.main([c + ".rle.shaf", "-m", "d", "-d", "s"]) == 0
    assert cli.main([c + ".rle", "-m", "d"]) == 0
    for p in (a, c):
        with open(p, "rb") as fp:
            assert fp.read() == data
    capsys.readouterr()


BLOCK = 64 << 10
#: four full blocks and a ragged one, in batches of two rows: 3 batches
SIZE = 4 * BLOCK + 20_000


def _compress(d, data, backend_name, block_size=BLOCK):
    """compress_pipeline of data as d/a.bin with the CPU device backend
    (the resident chain, batches of two rows) or the NumPy backend (the
    per-module chain): its output path and counters, or the exception it
    raised, and the files left in d."""
    from shafa_tpu_torch import device, pipeline, tracing
    os.makedirs(d, exist_ok=True)
    path = _write(os.path.join(d, "a.bin"), data)
    backend = (pipeline.NumpyBackend() if backend_name == "numpy"
               else device.TorchBackend("cpu"))
    tracing.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(device, "MAX_BATCH_ELEMS", 2 * BLOCK)
        try:
            out = pipeline.compress_pipeline(path, False, False, block_size,
                                             backend)[0]
        except Exception as e:  # noqa: BLE001 - compared across backends
            out = e
    return out, tracing.counters(), sorted(os.listdir(d))


def _read(path):
    with open(path, "rb") as fp:
        return fp.read()


@pytest.mark.parametrize("case", ["rle_kept", "rle_skipped", "rows_whole",
                                  "rows_slices", "rows_strided"])
def test_rle_written_behind_from_its_buffer(tmp_path, monkeypatch, case):
    """The resident compress writes its .rle on a writer thread
    (``writes_behind`` 1) where the RLE gate keeps it, and its sidecars
    equal the per-module chain's, which writes in series (0), as does a
    compress whose gate drops the RLE. ``_write_rows`` writes each row from
    its own buffer: whole rows, slices of one buffer and strided views give
    the rows' bytes back to back. The .rle goes out in writes of
    WRITE_SLICE bytes (here many of them)."""
    from shafa_tpu_torch import pipeline
    monkeypatch.setattr(pipeline, "WRITE_SLICE", 4096)
    if case.startswith("rows_"):
        import numpy as np
        flat = (np.arange(3000) * 7 % 256).astype(np.uint8)
        rows = {"rows_whole": [flat.copy(), np.zeros(0, np.uint8),
                               flat[:10].copy()],
                "rows_slices": [flat[:100], flat[100:1700], flat[1700:]],
                "rows_strided": [flat[::3], flat.reshape(60, 50)[:, 7],
                                 flat[5:9]]}[case]
        assert case != "rows_strided" or not rows[0].flags.c_contiguous
        path = str(tmp_path / "rows")
        pipeline._write_file(path, "restored", pipeline._write_rows, rows)
        assert _read(path) == b"".join(r.tobytes() for r in rows)
        return
    data = (mixed(SIZE, seed=31) if case == "rle_kept"
            else incompressible(SIZE, seed=32))
    exts = ([".rle", ".rle.freq", ".rle.cod", ".rle.shaf"]
            if case == "rle_kept" else [".freq", ".cod", ".shaf"])
    res = {b: _compress(str(tmp_path / b), data, b)
           for b in ("torch", "numpy")}
    for b, (out, counts, files) in res.items():
        assert out == str(tmp_path / b / "a.bin") + exts[-1]
        assert files == sorted(["a.bin"] + ["a.bin" + e for e in exts])
        assert counts["writes_behind"] == (b == "torch"
                                           and case == "rle_kept")
        assert counts["file_written_bytes"] == sum(
            os.path.getsize(str(tmp_path / b / "a.bin") + e) for e in exts)
    assert res["torch"][1]["encode_batches"] == 3
    for e in exts:
        assert _read(str(tmp_path / "torch" / "a.bin") + e) == \
            _read(str(tmp_path / "numpy" / "a.bin") + e), e


@pytest.mark.parametrize("failure", ["rle_tmp_is_a_directory",
                                     "rle_write_fails_late",
                                     "module_c_raises_during_rle_write"])
def test_failed_compress_leaves_what_the_serial_chain_leaves(
        tmp_path, monkeypatch, failure):
    """A compress that fails while its .rle is written behind ends as the
    per-module chain ends, which writes the .rle before .freq, T and C:
    the same error, raised as module F's where the .rle write failed (even
    when only the final wait sees it, after C published the .shaf), and
    the same files left; where C fails, the whole .rle is on disk before
    the error surfaces."""
    import errno
    import threading
    import time
    from shafa_tpu_torch import device, errors, pipeline
    data = mixed(SIZE, seed=33)
    write_rows = pipeline._write_rows

    def late_failure(fp, rows):
        # on the writer thread, wait until C has published the .shaf
        if threading.current_thread() is not threading.main_thread():
            shaf = fp.name[:-len(".rle.shafa_tmp")] + ".rle.shaf"
            deadline = time.monotonic() + 30
            while not os.path.exists(shaf) and time.monotonic() < deadline:
                time.sleep(0.005)
            assert os.path.exists(shaf)
        raise OSError(errno.ENOSPC, "No space left on device")

    def slow_write(fp, rows):
        time.sleep(0.3)
        write_rows(fp, rows)

    def pack_fails(*args, **kwargs):
        raise errors.FileUnrecognizableError("pack failed")

    if failure == "rle_write_fails_late":
        monkeypatch.setattr(pipeline, "_write_rows", late_failure)
    elif failure == "module_c_raises_during_rle_write":
        monkeypatch.setattr(pipeline, "_write_rows", slow_write)
        monkeypatch.setattr(device.TorchBackend, "fused_pack", pack_fails)
        monkeypatch.setattr(pipeline.NumpyBackend, "pack", pack_fails)
    res = {}
    for b in ("torch", "numpy"):
        if failure == "rle_tmp_is_a_directory":
            os.makedirs(str(tmp_path / b / "a.bin.rle.shafa_tmp"))
        res[b] = _compress(str(tmp_path / b), data, b)
    (err, counts, files), (want_err, _, want_files) = \
        res["torch"], res["numpy"]
    assert type(err) is type(want_err) and str(err).replace(
        str(tmp_path / "torch"), "") == str(want_err).replace(
        str(tmp_path / "numpy"), "")
    assert getattr(err, "stage", None) == getattr(want_err, "stage", None)
    assert files == want_files
    assert counts["writes_behind"] == 1
    if failure == "module_c_raises_during_rle_write":
        assert err.stage == "c"
        assert files == ["a.bin", "a.bin.rle", "a.bin.rle.cod",
                         "a.bin.rle.freq"]
        for e in (".rle", ".rle.freq", ".rle.cod"):
            assert _read(str(tmp_path / "torch" / "a.bin") + e) == \
                _read(str(tmp_path / "numpy" / "a.bin") + e), e
    else:
        assert isinstance(err, OSError)
        assert files == ["a.bin"] + (["a.bin.rle.shafa_tmp"]
                                     if failure == "rle_tmp_is_a_directory"
                                     else [])


def _bad_archive(path, kind):
    """An N-mode archive of one block that decodes on the host by design:
    a .cod block with no code at all, or one with codes of up to 34 bits
    whose payload runs out before the block's count."""
    from shafa_tpu_torch import formats
    codes = [""] * 256
    payload = bytes(2000)
    if kind == "codes_over_32_bits":
        code = prev = 0
        for s, ln in enumerate(list(range(1, 34)) + [34, 34]):
            code <<= ln - prev
            codes[s] = format(code, f"0{ln}b")
            code += 1
            prev = ln
        payload = b"\xff" * 40
    with open(path + ".cod", "wb") as fp:
        formats.write_cod(fp, "N", [5000], [codes])
    with open(path + ".shaf", "wb") as fp:
        formats.write_shaf_header(fp, 1)
        formats.write_shaf_block(fp, payload)
    return path + ".shaf"


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("kind", ["all_empty_cod_block", "codes_over_32_bits"])
def test_bad_archive_on_a_host_routed_block_is_not_recognized(
        tmp_path, monkeypatch, capsys, kind, backend):
    """The host route (oracle.unpack) of both backends ends the CLI as the
    kernel route does: "File not recognized", exit 1, no output file."""
    monkeypatch.setenv("SHAFA_TORCH_DEVICE", "cpu")
    shaf = _bad_archive(str(tmp_path / kind), kind)
    assert cli.main([shaf, "--backend", backend]) == 1
    assert capsys.readouterr().err.endswith("File not recognized\n")
    assert not os.path.exists(str(tmp_path / kind))


def _probe_targets() -> dict:
    """HOST_SPANS, PIPELINE_ENTRIES and BACKEND_CLASSES of the benchmark's
    probes (benchmark/harness/probes.py), read from the file's source."""
    import ast
    path = os.path.join(REPO, "benchmark", "harness", "probes.py")
    with open(path) as fp:
        tree = ast.parse(fp.read(), path)
    return {t.id: ast.literal_eval(node.value) for node in tree.body
            if isinstance(node, ast.Assign) for t in node.targets
            if isinstance(t, ast.Name) and t.id in (
                "HOST_SPANS", "PIPELINE_ENTRIES", "BACKEND_CLASSES")}


def test_every_function_the_benchmark_probes_wrap_exists():
    """The traced benchmark wraps these functions of the port by name and
    silently skips a name that is gone or is no longer a plain function,
    which would empty the span a per-layer metric reads."""
    import importlib
    import inspect
    targets = _probe_targets()
    assert set(targets) == {"HOST_SPANS", "PIPELINE_ENTRIES",
                            "BACKEND_CLASSES"}
    wrapped = targets["HOST_SPANS"] + [
        (mod, "", attr) for mod, attr in targets["PIPELINE_ENTRIES"]]
    missing = []
    for mod, owner, attr in wrapped:
        obj = importlib.import_module(f"shafa_tpu_torch.{mod}")
        obj = getattr(obj, owner) if owner else obj
        raw = vars(obj).get(attr)
        fn = raw.__func__ if isinstance(raw, staticmethod) else raw
        if not inspect.isfunction(fn) or inspect.isgeneratorfunction(fn):
            missing.append(f"{mod}.{owner + '.' if owner else ''}{attr}")
    assert not missing
    for mod, cls in targets["BACKEND_CLASSES"]:
        assert inspect.isclass(getattr(importlib.import_module(
            f"shafa_tpu_torch.{mod}"), cls))
