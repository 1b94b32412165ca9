"""Streaming (bounded-memory) pipelines of shafa_tpu_torch on the CPU
(TorchBackend on the CPU runs the kernels' plain versions): the port's
counterparts of tests/test_streaming.py, the streamed sidecars against
shafa_tpu's streaming output byte for byte, and the SHAFA_STREAM_THRESHOLD
override. Sizes as tests/test_streaming.py: 64 KiB blocks, at most 700 KB."""

import os
import subprocess
import sys

import numpy as np
import pytest

from corpus import mixed

from shafa_tpu import pipeline as jpipeline
from shafa_tpu.device import JaxBackend
from shafa_tpu_torch import device, geometry, pipeline
from shafa_tpu_torch.device import TorchBackend
from shafa_tpu_torch.errors import FileUnrecognizableError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 64 << 10
R_EXTS = (".rle", ".rle.freq", ".rle.cod", ".rle.shaf")
N_EXTS = (".freq", ".cod", ".shaf")


def _write(tmp, name, data):
    p = str(tmp / name)
    with open(p, "wb") as fp:
        fp.write(data)
    return p


def _read(path):
    with open(path, "rb") as fp:
        return fp.read()


def _backend():
    return TorchBackend("cpu")


@pytest.mark.parametrize("seed,size,force_freq", [
    (31, 700_000, False),        # R mode, ragged tail
    (32, 512 * 1024, True),      # exact block multiple + -c f
])
def test_streaming_matches_resident(tmp_path, monkeypatch, seed, size,
                                    force_freq):
    data = mixed(size, seed=seed)
    pa = _write(tmp_path, "stream.bin", data)
    pb = _write(tmp_path, "resident.bin", data)
    backend = _backend()

    # batches of 3 blocks, the last one short
    monkeypatch.setattr(device, "MAX_BATCH_ELEMS", 3 * BLOCK)
    monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 100_000)
    shaf_a, reps = pipeline.compress_pipeline(pa, False, force_freq, BLOCK,
                                              backend)
    assert reps[0].extra.get("streaming") is True
    monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 1 << 60)
    shaf_b, reps_b = pipeline.compress_pipeline(pb, False, force_freq, BLOCK,
                                                backend)
    assert "streaming" not in reps_b[0].extra

    exts = sorted(f.split("stream.bin")[1] for f in os.listdir(tmp_path)
                  if f.startswith("stream.bin") and f != "stream.bin")
    assert exts == sorted(f.split("resident.bin")[1]
                          for f in os.listdir(tmp_path)
                          if f.startswith("resident.bin")
                          and f != "resident.bin")
    assert (".freq" in exts) == force_freq
    for ext in exts:
        assert _read(pa + ext) == _read(pb + ext), \
            f"{ext}: streaming != resident"

    # roundtrip through the normal decoder
    os.rename(pa, pa + ".orig")
    out, _ = pipeline.module_d_shafa(shaf_a,
                                     rle_decompression=".rle." in shaf_a,
                                     backend=backend)
    assert _read(out) == data


@pytest.mark.parametrize("seed,size", [
    (41, 700_000),               # R mode: decode + expand, ragged tail
    (42, 512 * 1024),            # exact block multiple
])
def test_streaming_decode_matches_resident(tmp_path, monkeypatch, seed,
                                           size):
    data = mixed(size, seed=seed)
    p = _write(tmp_path, "data.bin", data)
    backend = _backend()
    shaf, _ = pipeline.compress_pipeline(p, True, False, BLOCK, backend)
    os.rename(p, p + ".orig")

    monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 1 << 60)
    out, rep = pipeline.module_d_shafa(shaf, rle_decompression=True,
                                       backend=backend)
    assert "streaming" not in rep.extra
    assert _read(out) == data
    os.unlink(out)

    # threshold forced below the archive size; batches of two blocks (the
    # cap counts 8 lanes a byte of the longest RLE stream's bucket) so the
    # loop really iterates
    from shafa_tpu_torch import formats
    _, rle_sizes, _ = formats.parse_cod_tables(_read(p + ".rle.cod"))
    monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 1024)
    monkeypatch.setattr(device, "MAX_BATCH_ELEMS",
                        2 * 8 * device._bucket(max(rle_sizes)))
    decoded = []

    class Counting(TorchBackend):
        def fused_decode(self, payloads, tables, out_counts, expand):
            decoded.append(len(payloads))
            return super().fused_decode(payloads, tables, out_counts, expand)

    out2, rep2 = pipeline.module_d_shafa(shaf, rle_decompression=True,
                                         backend=Counting("cpu"))
    assert rep2.extra.get("streaming") is True
    assert rep2.sizes_after == rep.sizes_after
    assert rep2.sizes_before == rep.sizes_before
    n_blocks = len(rle_sizes)
    assert decoded == [2] * (n_blocks // 2) + [1] * (n_blocks % 2)
    assert _read(out2) == data


def test_streaming_rle_only_decode(tmp_path, monkeypatch):
    # RLE-only decode (-d r): the streaming path must match the resident
    # path byte for byte (reference one-block-resident d.c:322-352)
    data = mixed(700_000, seed=47)
    p = _write(tmp_path, "ronly.bin", data)
    backend = _backend()
    pipeline.module_f(p, True, False, BLOCK, backend)  # -c r: .rle+.freq
    rle_path = p + ".rle"

    monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 1 << 60)
    out, rep = pipeline.module_d_rle(rle_path, backend)
    assert "streaming" not in rep.extra
    assert _read(out) == data
    os.unlink(out)

    monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 1024)
    monkeypatch.setattr(device, "MAX_BATCH_ELEMS", BLOCK * 8 * 2)
    out2, rep2 = pipeline.module_d_rle(rle_path, backend)
    assert rep2.extra.get("streaming") is True
    assert rep2.sizes_after == rep.sizes_after
    assert _read(out2) == data


@pytest.mark.parametrize("frames", ["extra", "missing"])
def test_streaming_decode_frame_count_mismatch(tmp_path, monkeypatch,
                                               frames):
    """An archive with a frame more (the original's case) or a frame fewer
    than its .cod has blocks is not recognized, and leaves no output."""
    from shafa_tpu_torch import formats
    data = mixed(300_000, seed=43)
    p = _write(tmp_path, "data.bin", data)
    backend = _backend()
    shaf, _ = pipeline.compress_pipeline(p, True, False, BLOCK, backend)
    os.rename(p, p + ".orig")
    if frames == "extra":
        with open(shaf, "ab") as fp:
            fp.write(b"@3@xyz")
    else:
        payloads = formats.read_shaf(shaf)[:-1]
        with open(shaf, "wb") as fp:
            formats.write_shaf_header(fp, len(payloads))
            for payload in payloads:
                formats.write_shaf_block(fp, payload)
    monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 1024)
    monkeypatch.setattr(device, "MAX_BATCH_ELEMS", BLOCK * 8 * 2)
    with pytest.raises(FileUnrecognizableError):
        pipeline.module_d_shafa(shaf, rle_decompression=True,
                                backend=backend)
    assert not os.path.exists(p)
    assert not os.path.exists(p + ".shafa_tmp")


def test_streaming_resume_after_crash(tmp_path, monkeypatch):
    """Block-level restart (SURVEY §5.3): kill the run mid-stream, rerun,
    and get byte-identical outputs without re-encoding completed batches."""
    data = mixed(700_000, seed=51)
    pa = _write(tmp_path, "crash.bin", data)
    pb = _write(tmp_path, "clean.bin", data)
    monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 1024)
    monkeypatch.setattr(device, "MAX_BATCH_ELEMS", BLOCK * 2)

    class Crashing(TorchBackend):
        calls = 0

        def fused_encode(self, blocks):
            Crashing.calls += 1
            if Crashing.calls == 3:
                raise RuntimeError("injected crash")
            return super().fused_encode(blocks)

    with pytest.raises(RuntimeError, match="injected crash"):
        pipeline.compress_pipeline(pa, False, False, BLOCK, Crashing("cpu"))
    assert os.path.exists(pa + ".rle.progress")  # restart state retained
    assert os.path.exists(pa + ".rle.shafa_tmp")

    encoded = []

    class Counting(TorchBackend):
        def fused_encode(self, blocks):
            encoded.append(len(blocks))
            return super().fused_encode(blocks)

    pipeline.compress_pipeline(pa, False, False, BLOCK, Counting("cpu"))
    resumed_batches = len(encoded)
    pipeline.compress_pipeline(pb, False, False, BLOCK, _backend())
    assert not os.path.exists(pa + ".rle.progress")  # cleared on success
    for ext in R_EXTS:
        assert _read(pa + ext) == _read(pb + ext), f"{ext}: resumed != clean"
    # the resumed run skipped the 2 durably-completed batches
    n_batches = -(-geometry.geometry_for_file(pb, BLOCK).n_blocks // 2)
    assert resumed_batches == n_batches - 2


def test_streaming_incompressible_n_mode(tmp_path, monkeypatch):
    rng = np.random.default_rng(33)
    data = rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    p = _write(tmp_path, "noise.bin", data)
    backend = _backend()
    monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 100_000)
    shaf, reps = pipeline.compress_pipeline(p, False, False, BLOCK, backend)
    assert reps[0].extra == {"compress_rle": False, "size_f": len(data),
                             "streaming": True}
    assert not os.path.exists(p + ".rle")
    os.rename(p, p + ".orig")
    out, rep = pipeline.module_d_shafa(shaf, rle_decompression=False,
                                       backend=backend)
    assert rep.extra.get("streaming") is True
    assert _read(out) == data


@pytest.mark.parametrize("mode", ["R", "N"])
def test_streaming_sidecars_match_shafa_tpu(tmp_path, monkeypatch, mode):
    """The same numpy-seeded input through shafa_tpu's streaming compress
    (JaxBackend on the CPU, one batch) and the port's (batches of 2
    blocks): the sidecars are equal byte for byte."""
    if mode == "R":
        data = mixed(400_000, seed=61)
        exts = R_EXTS
    else:
        data = np.random.default_rng(62).integers(
            0, 256, 300_000, dtype=np.uint8).tobytes()
        exts = N_EXTS
    port = _write(tmp_path, "port.bin", data)
    ref = _write(tmp_path, "ref.bin", data)
    jpipeline.compress_pipeline_streaming(ref, False, False, BLOCK,
                                          JaxBackend())
    monkeypatch.setattr(device, "MAX_BATCH_ELEMS", BLOCK * 2)
    _, reps = pipeline.compress_pipeline_streaming(port, False, False, BLOCK,
                                                   _backend())
    assert reps[0].extra["compress_rle"] == (mode == "R")
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["port.bin", "ref.bin"] + [n + e for n in ("port.bin", "ref.bin")
                                   for e in exts])
    for ext in exts:
        assert _read(port + ext) == _read(ref + ext), f"{ext} differs"


def test_stream_threshold_from_the_environment():
    r = subprocess.run(
        [sys.executable, "-c",
         "import shafa_tpu_torch.pipeline as p; print(p.STREAM_THRESHOLD)"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env=dict(os.environ, SHAFA_STREAM_THRESHOLD="4096"))
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["4096"]
