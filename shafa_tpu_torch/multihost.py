"""Multi-host runs: the process layer of the port of shafa_tpu/multihost.py,
over torch.distributed.

As in the original (multihost.py:1-24): every process runs the same code
on a contiguous range of the blocks (``partition_blocks``), reads only its
byte range of the input, encodes it on its own devices (the backend that
cli._make_backend built: one device, or dist.ShardedBackend over the
visible ones), and pwrites its shard of .rle/.shaf at an offset computed
from all-gathered sizes into a file on a shared file system; process 0
writes the ASCII sidecars (.freq/.cod) and the .shaf header. The drivers
are pipeline.compress_multihost and pipeline.decompress_multihost, which
run the pipeline's own steps; this module gives them the process group,
the exchanges and the positional IO. The only exchanges between processes
are KB-scale host metadata (per-block sizes and 256-bin histograms),
gathered over gloo with CPU tensors: ranks that share one GPU cannot use
NCCL, and the data never needs the device.

The processes join through ``init_from_env`` (torch.distributed instead of
jax.distributed). A join that fails raises: a run asked to be multi-host
never goes on as a single process that writes the whole file.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re

import numpy as np
import torch
import torch.distributed as tdist

from .errors import FileUnrecognizableError

#: Seconds a process waits for the others to join (SHAFA_JOIN_TIMEOUT);
#: jax.distributed.initialize's default initialization_timeout.
JOIN_TIMEOUT_S = 300


def _env_int(name: str) -> int:
    value = os.environ.get(name)
    if value is None or not value.strip().isdigit():
        raise ValueError(f"multi-host: {name} must be a non-negative integer,"
                         f" got {value!r}")
    return int(value)


def init_from_env() -> bool:
    """Join the processes of a multi-host run (shafa_tpu/multihost.py:39).

    With COORDINATOR_ADDRESS (host:port), NUM_PROCESSES and PROCESS_ID, the
    environment the original reads; with SHAFA_MULTIHOST=1, the MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE and RANK that torchrun sets (the counterpart of
    the original's pod autodetection). Process 0 serves the rendezvous
    store. Joins a gloo process group and returns True, or returns False
    at once if a process group exists. Raises ValueError on a malformed
    environment and RuntimeError (torch.distributed's errors) on a join
    that fails or times out (SHAFA_JOIN_TIMEOUT seconds, default 300)."""
    if tdist.is_initialized():
        return False
    if os.environ.get("COORDINATOR_ADDRESS"):
        host, sep, port = os.environ["COORDINATOR_ADDRESS"].rpartition(":")
        if not sep or not port.isdigit():
            raise ValueError("multi-host: COORDINATOR_ADDRESS must be "
                             "host:port")
        world, rank = _env_int("NUM_PROCESSES"), _env_int("PROCESS_ID")
    else:
        host = os.environ.get("MASTER_ADDR", "")
        port = str(_env_int("MASTER_PORT"))
        world, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
    if not host or not 0 <= rank < world:
        raise ValueError(f"multi-host: rank {rank} of {world} processes at "
                         f"{host!r}")
    timeout = datetime.timedelta(seconds=float(os.environ.get(
        "SHAFA_JOIN_TIMEOUT", JOIN_TIMEOUT_S)))
    store = tdist.TCPStore(host, int(port), world, rank == 0,
                           timeout=timeout, wait_for_workers=True)
    tdist.init_process_group("gloo", store=store, rank=rank,
                             world_size=world)
    return True


def leave() -> None:
    """End the process group that init_from_env joined. Callers wait at a
    barrier first where the others' writes must be complete: unlike
    jax.distributed's shutdown, this one does not wait for every process."""
    tdist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class BlockRange:
    """Contiguous block range [lo, hi) owned by one host. Copy of
    shafa_tpu/multihost.py:66."""
    lo: int
    hi: int

    @property
    def n(self) -> int:
        return self.hi - self.lo


def partition_blocks(n_blocks: int, process_count: int,
                     process_index: int) -> BlockRange:
    """Contiguous, balanced split: host h owns blocks [h*n//H, (h+1)*n//H).
    Copy of shafa_tpu/multihost.py:76."""
    lo = n_blocks * process_index // process_count
    hi = n_blocks * (process_index + 1) // process_count
    return BlockRange(lo, hi)


class Comm:
    """Process identity and the small-array all-gather
    (shafa_tpu/multihost.py:87) over torch.distributed; one process when
    no process group exists. Tests substitute a thread-barrier Comm."""

    @property
    def index(self) -> int:
        return tdist.get_rank() if tdist.is_initialized() else 0

    @property
    def count(self) -> int:
        return tdist.get_world_size() if tdist.is_initialized() else 1

    def allgather(self, local: np.ndarray) -> np.ndarray:
        """Each host's array concatenated along axis 0, in process order.

        Ragged row counts as in the original (:105-123): a gather of the
        counts, then a gather padded to the largest, then per-host slices.
        CPU tensors over gloo."""
        local = np.ascontiguousarray(local)
        if self.count <= 1:
            return local
        ns = [torch.zeros(1, dtype=torch.int64) for _ in range(self.count)]
        tdist.all_gather(ns, torch.tensor([local.shape[0]]))
        ns = [int(n) for n in ns]
        pad = np.zeros((max(ns),) + local.shape[1:], local.dtype)
        pad[: local.shape[0]] = local
        mine = torch.from_numpy(pad)
        parts = [torch.empty_like(mine) for _ in range(self.count)]
        tdist.all_gather(parts, mine)
        return np.concatenate([p.numpy()[:n] for p, n in zip(parts, ns)],
                              axis=0)

    def barrier(self) -> None:
        if self.count > 1:
            tdist.barrier()


def write_at(path: str, offset: int, data: bytes,
             total_size: int | None = None) -> None:
    """Positional write into a (shared-FS) file, creating/extending it;
    total_size truncates stale bytes of an earlier run. Copy of
    shafa_tpu/multihost.py:126."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        if total_size is not None:
            os.ftruncate(fd, total_size)
        if data:
            os.pwrite(fd, data, offset)
    finally:
        os.close(fd)


def shaf_frame(payload: bytes) -> bytes:
    return f"@{len(payload)}@".encode("ascii") + payload


def shaf_offsets(payload_sizes: np.ndarray) -> tuple[np.ndarray, int]:
    """Byte offset of every block's frame within the .shaf file, and its
    size. Copy of shafa_tpu/multihost.py:147."""
    n = len(payload_sizes)
    header = len(f"@{n}")
    frame_sizes = np.array(
        [len(f"@{int(s)}@") + int(s) for s in payload_sizes], np.int64)
    offs = header + np.concatenate(([0], np.cumsum(frame_sizes)[:-1]))
    return offs, int(header + frame_sizes.sum())


def splice_spool(spool, dst_path: str, dst_off: int, total: int) -> None:
    """Copy a local spool file into the shared output at dst_off in bounded
    chunks (shafa_tpu/multihost.py:160)."""
    spool.seek(0)
    fd = os.open(dst_path, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        os.ftruncate(fd, total)
        while True:
            chunk = spool.read(64 << 20)
            if not chunk:
                break
            os.pwrite(fd, chunk, dst_off)
            dst_off += len(chunk)
    finally:
        os.close(fd)


#: chunk size for the buffered .shaf header scan
_SCAN_CHUNK = 1 << 20


def scan_shaf_offsets(path: str) -> tuple[np.ndarray, np.ndarray, int]:
    """(payload_offsets, payload_sizes, n_blocks) from the ASCII frame
    headers alone, read in 1 MiB chunks; a frame larger than a chunk
    refills with a header-sized read. Copy of
    shafa_tpu/multihost.py:322."""
    hdr = re.compile(rb"@(\d+)@")
    with open(path, "rb") as fp:
        buf = fp.read(_SCAN_CHUNK)
        m = re.match(rb"@(\d+)", buf)
        if not m:
            raise FileUnrecognizableError(".shaf header")
        n_blocks = int(m.group(1))
        base = 0            # file offset of buf[0]
        pos = m.end()       # absolute offset of the next frame header
        offs = np.zeros(n_blocks, np.int64)
        sizes = np.zeros(n_blocks, np.int64)
        for i in range(n_blocks):
            if pos - base + 32 > len(buf):
                want = _SCAN_CHUNK if i == 0 or sizes[i - 1] < _SCAN_CHUNK \
                    else 32
                fp.seek(pos)
                buf = fp.read(want)
                base = pos
            m = hdr.match(buf, pos - base)
            if not m:
                raise FileUnrecognizableError(".shaf frame header")
            sizes[i] = int(m.group(1))
            offs[i] = base + m.end()
            pos = int(offs[i] + sizes[i])
    return offs, sizes, n_blocks
