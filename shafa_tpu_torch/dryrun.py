"""The port's entry points for a compile check and a dry run: the fused
encode step and the multi-device round trip, counterparts of
__graft_entry__.py:29 ``entry`` and :54 ``dryrun_multichip`` (that file
stays as it is and imports jax).

The encode step (RLE, histogram of the RLE stream, Shannon-Fano bit-pack)
is the codec's forward pass, the per-block code tables its weights; the
dry run drives the production round trip over several devices, blocks
spread as on a multi-GPU host (dist.ShardedBackend, which cli._make_backend
builds there), and checks it byte for byte.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from . import dist, pipeline
from .device import default_device
from .kernels import emit as kemit
from .kernels import pack as kpack
from .kernels import rle as krle


def _example(batch=8, p=2048, seed=0):
    """Compressible mix of runs and text-like bytes, the last row short.
    Copy of __graft_entry__.py:18."""
    rng = np.random.default_rng(seed)
    raw = np.where(rng.random((batch, p)) < 0.5,
                   rng.integers(97, 123, (batch, p)),
                   rng.integers(0, 4, (batch, p))).astype(np.uint8)
    lens = np.full((batch,), p, np.int32)
    lens[-1] = p - 123  # exercise masking
    return raw, lens


def forward(x, lengths, lut_len, lut_val):
    """The fused encode step: the RLE streams and their histograms (K8),
    K1 LUT pack of the streams with the (B, 256) code tables (lut_len code
    lengths, lut_val the u32 bits of the left-aligned codes, both int32).

    Returns (packed (B, W) uint8 rows, zero past each row's packed length;
    the (B,) int64 packed byte lengths; (B, 256) int64 histograms; (B,)
    int64 RLE lengths)."""
    enc, enc_len, hist = krle.rle_encode_hist(x, lengths)
    byte_lens = kpack.pack_byte_lens(hist.cpu().numpy(),
                                     lut_len.cpu().numpy())
    woff, need = kemit.aligned_offsets(byte_lens)
    flat = kpack.pack_batch(enc, enc_len.to(torch.int32), lut_len, lut_val,
                            torch.from_numpy(woff).to(x.device), need)
    packed_len = torch.from_numpy(byte_lens).to(x.device)
    width = max(int(byte_lens.max()), 1)
    col = torch.arange(width, device=x.device)
    idx = torch.from_numpy(4 * woff.astype(np.int64)).to(x.device)[:, None] \
        + col
    flat8 = flat.view(torch.uint8)
    packed = torch.where(col < packed_len[:, None],
                         flat8[idx.clamp(max=flat8.numel() - 1)], 0)
    return packed.to(torch.uint8), packed_len, hist, enc_len


def entry():
    """(forward, example arguments on the default device): eight 2 KiB rows,
    the last 123 bytes short, and a flat 8-bit code for every byte."""
    x, lens = _example()
    code_lens = np.full((x.shape[0], 256), 8, np.int32)
    code_vals = (np.arange(256, dtype=np.uint32) << 24)[None].repeat(
        x.shape[0], 0).view(np.int32)
    dev = default_device()
    return forward, tuple(torch.from_numpy(a).to(dev)
                          for a in (x, lens, code_lens, code_vals))


def dryrun_multichip(n_devices: int, devices=None) -> dict[str, bytes]:
    """The production round trip over n_devices devices (the first
    n_devices of dist.block_devices(), or the devices given, which may
    repeat one): the fused compress of 2 blocks per device and a ragged
    tail at 64 KiB blocks, then the fused decompress, which must give the
    input back. Returns the sidecars, {extension: bytes}."""
    devs = dist.block_devices(devices)
    if devices is None:
        devs = devs[:n_devices]
    if len(devs) != n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devs)}")
    backend = dist.make_backend(devs)
    if not backend.supports_fused:
        raise RuntimeError("the multi-device backend has no fused tier")
    bs = 64 << 10
    raw, _ = _example(batch=1, p=(2 * n_devices + 1) * bs - 321, seed=1)
    data = raw[0].tobytes()
    work = tempfile.mkdtemp(prefix="shafa_dryrun_")
    try:
        path = os.path.join(work, "data.bin")
        with open(path, "wb") as fp:
            fp.write(data)
        shaf, reps = pipeline.compress_pipeline(path, False, False, bs,
                                                backend)
        if [r.module for r in reps] != ["f", "t", "c"]:
            raise RuntimeError("the compress did not run F, T and C")
        sidecars = {}
        for name in sorted(os.listdir(work)):
            if name != "data.bin":
                with open(os.path.join(work, name), "rb") as fp:
                    sidecars[name[len("data.bin"):]] = fp.read()
        os.rename(path, path + ".orig")
        out, _ = pipeline.module_d_shafa(
            shaf, rle_decompression=".rle." in shaf, backend=backend)
        with open(out, "rb") as fp:
            if fp.read() != data:
                raise RuntimeError("multi-device round trip mismatch")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if isinstance(backend, dist.ShardedBackend):
            backend.close()
    return sidecars
