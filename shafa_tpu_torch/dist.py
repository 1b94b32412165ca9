"""Block parallelism over several devices: the port of shafa_tpu/dist.py.

shafa_tpu shards the block axis of every kernel over a 1-D ``blocks`` mesh
(dist.py:39 ``block_mesh``, :61 ``ShardedKernels``, with shard_map) and the
host joins the shards in block order. PyTorch has no shard_map, so here:

  * every call's blocks are cut into D contiguous ranges, one per device
    (the original pads B to a multiple of D and gives each device one
    contiguous shard, dist.py:45-55; the split differs, the bytes do not);
  * each device runs the port's one-device backend (device.TorchBackend)
    on its range: the fused encode (RLE analysis, K1 bits, histograms), K1
    LUT in ``pack`` and ``fused_pack``, the fused decode (K2 -> K3 or
    K5 -> K6 -> K1, then K4) and each per-stage method;
  * the host concatenates the ranges' results in block order. Each device's
    downloads are its own exact-size ones, as the original's per-shard
    compaction (device.py:507-530) makes them; its fused decode stays the
    fused decode (the original's mesh route drops to per-stage unpack and
    rle_expand, device.py:564-568).

On the calling thread, ``shafa.dist.run`` spans the wait on the devices'
parts of one backend call and ``shafa.dist.join`` each join of their
results; the counter ``dist_parts`` adds the non-empty block ranges each
call's blocks are cut into, and ``dist_join_bytes`` the bytes the host
copies to join the results (a list of rows is joined with no copy).

TorchBackend syncs with the host inside its calls (size downloads, host
routing), so each device has one worker thread for the life of the backend,
and all of that device's calls, tensors and handles stay on it. Kernel
launches and torch ops release the interpreter lock, so the devices run at
once; every kernel launches under its device as the current one
(kernels/_build.launch).
"""

from __future__ import annotations

import concurrent.futures as cf

import numpy as np
import torch

from . import codes as codes_mod
from . import tracing
from .device import TorchBackend, default_device


def block_devices(devices=None) -> list[torch.device]:
    """The counterpart of ``block_mesh``: the given devices, or else every
    visible CUDA device when the default device (device.default_device) is
    CUDA without an index, or else the default device alone."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    dev = default_device()
    if dev.type != "cuda" or dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_backend(devices, sequential: bool = False):
    """One TorchBackend for one device (no worker thread, no extra copy), a
    ShardedBackend for several."""
    devices = list(devices)
    if len(devices) == 1:
        return TorchBackend(devices[0], sequential=sequential)
    return ShardedBackend(devices, sequential=sequential)


class _ShardedHandle:
    """A fused encode over several devices: (device index, lo, hi, the
    device's own handle) per non-empty block range, in block order."""

    def __init__(self, parts):
        self.parts = parts

    @property
    def n_blocks(self):
        return sum(hi - lo for _, lo, hi, _ in self.parts)


class ShardedBackend:
    """The pipeline Backend protocol and its fused tier over D >= 2 devices
    (a device may repeat: two entries of ``cuda:0`` run two workers on one
    card). Outputs are byte-identical to one TorchBackend's."""

    def __init__(self, devices, sequential: bool = False):
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) < 2:
            raise ValueError("ShardedBackend needs two devices or more")
        self.sequential = bool(sequential)
        self.backends = [TorchBackend(d, sequential=sequential)
                         for d in self.devices]
        self._workers = [cf.ThreadPoolExecutor(
            1, thread_name_prefix=f"shafa-{d}-{k}")
            for k, d in enumerate(self.devices)]

    def close(self) -> None:
        for w in self._workers:
            w.shutdown()

    @property
    def supports_fused(self) -> bool:
        return not self.sequential

    def _ranges(self, n: int):
        """Each device's non-empty contiguous range (k, lo, hi) of n
        blocks, counted in ``dist_parts``."""
        d = len(self.devices)
        ranges = [(k, n * k // d, n * (k + 1) // d) for k in range(d)]
        ranges = [(k, lo, hi) for k, lo, hi in ranges if hi > lo]
        tracing.count("dist_parts", len(ranges))
        return ranges

    def _run(self, calls):
        """[(device index, fn, args)] -> fn(backend, *args) of each on its
        device's worker, results in the order given. Every call finishes
        before the first error, if any, is raised."""
        with tracing.span("shafa.dist.run"):
            futs = [self._workers[k].submit(self._on_worker, k, fn, args)
                    for k, fn, args in calls]
            cf.wait(futs)
            return [f.result() for f in futs]

    def _on_worker(self, k: int, fn, args):
        with tracing.span(f"shafa.dist.worker.{k}"):
            return fn(self.backends[k], *args)

    def _split(self, n: int, fn):
        """fn(backend, lo, hi) over each device's non-empty block range."""
        return self._run([(k, fn, (lo, hi)) for k, lo, hi in self._ranges(n)])

    @staticmethod
    @tracing.spanned("shafa.dist.join")
    def _joined(parts):
        tracing.count("dist_join_bytes", 0)  # the rows themselves, no copy
        return [row for part in parts for row in part]

    @staticmethod
    @tracing.spanned("shafa.dist.join")
    def _concatenated(parts, empty: np.ndarray) -> np.ndarray:
        """The parts' arrays joined in block order, a fresh host copy."""
        out = np.concatenate(parts) if parts else empty
        tracing.count("dist_join_bytes", out.nbytes)
        return out

    # -- Backend protocol ----------------------------------------------------

    def rle_encode(self, blocks):
        return self._joined(self._split(
            len(blocks), lambda be, lo, hi: be.rle_encode(blocks[lo:hi])))

    def histogram(self, blocks):
        return self._joined(self._split(
            len(blocks), lambda be, lo, hi: be.histogram(blocks[lo:hi])))

    def pack(self, blocks, tables, hists=None):
        return self._joined(self._split(len(blocks), lambda be, lo, hi: (
            be.pack(blocks[lo:hi], codes_mod.take_rows(tables, lo, hi),
                    None if hists is None else hists[lo:hi]))))

    def unpack(self, payloads, tables, out_counts):
        return self._joined(self._split(len(payloads), lambda be, lo, hi: (
            be.unpack(payloads[lo:hi], codes_mod.take_rows(tables, lo, hi),
                      out_counts[lo:hi]))))

    def rle_expand(self, blocks):
        return self._joined(self._split(
            len(blocks), lambda be, lo, hi: be.rle_expand(blocks[lo:hi])))

    # -- fused tier ----------------------------------------------------------

    def fused_encode(self, blocks) -> _ShardedHandle:
        calls = self._ranges(len(blocks))
        subs = self._run([(k, lambda be, lo, hi: be.fused_encode(
            blocks[lo:hi]), (lo, hi)) for k, lo, hi in calls])
        return _ShardedHandle([(k, lo, hi, sub) for (k, lo, hi), sub
                               in zip(calls, subs)])

    def _per_part(self, h: _ShardedHandle, fn):
        """fn(backend, lo, hi, sub-handle) of each part on its worker."""
        return self._run([(k, fn, (lo, hi, sub))
                          for k, lo, hi, sub in h.parts])

    def fused_rle_sizes(self, h) -> np.ndarray:
        parts = self._per_part(h, lambda be, lo, hi, sub:
                               be.fused_rle_sizes(sub))
        return self._concatenated(parts, np.zeros(0, np.int64))

    def fused_rle_hists(self, h) -> np.ndarray:
        parts = self._per_part(h, lambda be, lo, hi, sub:
                               be.fused_rle_hists(sub))
        return self._concatenated(parts, np.zeros((0, 256), np.int64))

    def fused_raw_hists(self, h) -> np.ndarray:
        parts = self._per_part(h, lambda be, lo, hi, sub:
                               be.fused_raw_hists(sub))
        return self._concatenated(parts, np.zeros((0, 256), np.int64))

    def fused_rle_bytes(self, h) -> np.ndarray:
        parts = self._per_part(h, lambda be, lo, hi, sub:
                               be.fused_rle_bytes(sub))
        return self._concatenated(parts, np.zeros(0, np.uint8))

    def fused_pack(self, h, tables, use_rle: bool,
                   host_row) -> list[bytes | memoryview]:
        return self._joined(self._per_part(h, lambda be, lo, hi, sub: (
            be.fused_pack(sub, codes_mod.take_rows(tables, lo, hi),
                          use_rle, lambda j: host_row(lo + j)))))

    def fused_decode(self, payloads, tables, out_counts,
                     expand: bool) -> list[np.ndarray]:
        return self._joined(self._split(len(payloads), lambda be, lo, hi: (
            be.fused_decode(payloads[lo:hi],
                            codes_mod.take_rows(tables, lo, hi),
                            out_counts[lo:hi], expand))))
