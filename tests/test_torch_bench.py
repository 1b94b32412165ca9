"""The port of bench.py on the CPU (SHAFA_TORCH_DEVICE=cpu: the kernels'
plain versions run): the module run as a command at a small size, its
encode section's payloads against the JAX package's oracle and code build,
its decode section's output against its input on a corpus of each code
width, and a flipped byte of the decoded output making it exit 1."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from shafa_tpu import codes as jcodes, geometry as jgeometry, oracle as joracle
from shafa_tpu_torch import bench, device
from shafa_tpu_torch.profile_main_path import synthetic, text_with_rare_bytes

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
BLOCK = 256 << 10

#: the original's keys that a whole run's last line carries
ROOT_KEYS = ("metric", "value", "unit", "vs_baseline", "decode_mb_s",
             "decode_vs_c_ref", "roundtrip_bit_exact", "streaming_e2e_mb_s",
             "streaming_vs_device")


def _env(**kw) -> dict:
    return dict(os.environ, SHAFA_TORCH_DEVICE="cpu", SHAFA_BENCH_REPS="1",
                SHAFA_BENCH_BLOCK=str(BLOCK), **kw)


def _imported(stderr: str) -> list[str]:
    """Module names of ``python -X importtime``'s report."""
    return [ln.rsplit("|", 1)[1].strip() for ln in stderr.splitlines()
            if ln.startswith("import time:") and "|" in ln]


def test_bench_runs_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "shafa_tpu_torch.bench"],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env=_env(SHAFA_BENCH_SIZE="2000000",
                 SHAFA_BENCH_DECODE_SIZE="1000000"))
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(ROOT_KEYS) <= set(line)
    assert line["metric"] == "encode_throughput_device"
    assert line["unit"] == "MB/s" and line["roundtrip_bit_exact"] is True
    assert "scaling_recorded" not in line and "streaming_note" not in line
    assert line["kernel_build_s"] is None
    assert len(line["encode_reps_s"]) == len(line["decode_reps_s"]) == 1
    assert "round trip bit-exact" in r.stderr
    loaded = _imported(r.stderr)
    assert "shafa_tpu_torch.device" in loaded
    assert not [m for m in loaded if m.split(".")[0] in ("shafa_tpu", "jax",
                                                         "jaxlib")]


def _blocks(data: bytes) -> list[np.ndarray]:
    raw = np.frombuffer(data, np.uint8)
    geo = jgeometry.geometry_for_size(len(data), BLOCK)
    return [raw[geo.offset(i):geo.offset(i) + s]
            for i, s in enumerate(geo.sizes())]


def test_encode_payloads_match_the_jax_package(monkeypatch):
    """Five blocks in batches of two rows (the last one padded): each
    payload equals shafa_tpu.oracle.pack of the block's RLE stream under
    shafa_tpu.codes.build_code_tables."""
    monkeypatch.setattr(device, "MAX_BATCH_ELEMS", 2 * BLOCK)
    data = synthetic(4 * BLOCK + 70_001, 5)
    backend = device.TorchBackend(CPU)
    uploaded = backend.upload_blocks(_blocks(data))
    assert [len(b["lens"]) for b in uploaded.batches] == [2, 2, 1]
    _h, packs = bench.encode_once(backend, uploaded)
    got = bench.encode_payloads(packs)
    enc = [joracle.rle_encode(b) for b in _blocks(data)]
    tables = jcodes.build_code_tables(
        np.stack([joracle.histogram(e) for e in enc]))
    assert got == [joracle.pack(e, tables.lens[i], tables.vals[i])
                   for i, e in enumerate(enc)]


@pytest.mark.parametrize("corpus", ["mixed", "text"])
def test_decode_section_gives_back_its_input(corpus, monkeypatch):
    """Three blocks of 256 KiB: the mixed corpus's codes have at most 16
    bits (K2, K3), the text's 17-32 (K5, K6, K1); then K4. Batches of two
    rows at most."""
    data = (synthetic(3 * BLOCK - 1000, 1) if corpus == "mixed"
            else text_with_rare_bytes(3 * BLOCK - 1000))
    monkeypatch.setattr(device, "MAX_BATCH_ELEMS", 4 * BLOCK)
    backend = device.TorchBackend(CPU)
    batches = bench.decode_batches(data, BLOCK, backend)
    assert len(batches) == 2 and [len(b.blocks) for b in batches] == [2, 1]
    states = {b.s_states for b in batches}
    assert states <= ({8, 16} if corpus == "mixed" else {32})
    outs = bench.decode_once(backend, batches)
    assert bench.decoded_bytes(outs) == data


#: flips one byte of K4's output, then runs the bench's main
FLIPPED = r"""
import sys
from shafa_tpu_torch import bench
from shafa_tpu_torch.kernels import expand
real = expand.rle_expand
def flipped(sizes, total):
    out = real(sizes, total).clone()
    out[total // 2] ^= 1
    return out
expand.rle_expand = flipped
sys.exit(bench.main())
"""


def test_a_flipped_byte_makes_the_bench_exit_1():
    r = subprocess.run(
        [sys.executable, "-c", FLIPPED], capture_output=True, text=True,
        cwd=REPO, timeout=600,
        env=_env(SHAFA_BENCH_SIZE="600000", SHAFA_BENCH_DECODE_SIZE="600000",
                 SHAFA_BENCH_STREAM="0"))
    assert r.returncode == 1, r.stderr[-3000:]
    assert "decode: the expanded bytes differ from the input" in r.stderr
    assert "roundtrip_bit_exact" not in r.stdout


#: changes one byte of the encode section's RLE streams or K1's packed
#: words, then runs the bench's main
ENCODE_FAULT = r"""
import sys
from shafa_tpu_torch import bench
from shafa_tpu_torch.kernels import pack, rle
if sys.argv[1] == "rle":
    real = rle.rle_encode_hist
    def faulty(x, lengths):
        enc, enc_len, hist = real(x, lengths)
        enc = enc.clone()
        enc[0, 5] ^= 1
        return enc, enc_len, hist
    rle.rle_encode_hist = faulty
else:
    real = pack.pack_batch
    def faulty(*args):
        out = real(*args).clone()
        out[3] ^= 1 << 9
        return out
    pack.pack_batch = faulty
sys.exit(bench.main())
"""


@pytest.mark.parametrize("fault", ["rle", "pack"])
def test_a_wrong_encoded_byte_makes_the_bench_exit_1(fault):
    r = subprocess.run(
        [sys.executable, "-c", ENCODE_FAULT, fault], capture_output=True,
        text=True, cwd=REPO, timeout=600,
        env=_env(SHAFA_BENCH_SIZE="600000", SHAFA_BENCH_DECODE="0",
                 SHAFA_BENCH_STREAM="0"))
    assert r.returncode == 1, r.stderr[-3000:]
    want = "RLE streams" if fault == "rle" else "payloads"
    assert f"encode: the {want} differ from the oracle's" in r.stderr
    assert "encode_throughput_device" not in r.stdout
