"""RLE escape coding and per-block histograms, on whole files at once.

Frozen copy of the arithmetic of ``shafa_tpu_torch/oracle.py``
(``rle_segments`` and ``rle_encode``, themselves copies of
``shafa_tpu/oracle.py``), in plain torch over a whole file: runs never
cross a block, so a block's first byte always starts a run. The format
(the C reference's f.c:29-55): a run of 4 or more equal bytes, or any run
of the byte 0x00, becomes the escape ``00 sym count`` with count in
[1, 255]; longer runs split every 255 bytes; other bytes stay as they are.
"""

from __future__ import annotations

import torch

RLE_MAX_RUN = 255
RLE_MIN_RUN = 4


def encode(x: torch.Tensor, block_size: int):
    """RLE of every block of the uint8 file ``x``.

    Returns (out, out_block, sizes): the concatenated RLE stream (uint8),
    the block of each of its bytes (int64), and each block's RLE size."""
    n = x.numel()
    dev = x.device
    n_blocks = -(-n // block_size)
    idx = torch.arange(n, device=dev)
    change = idx % block_size == 0
    change[1:] |= x[1:] != x[:-1]
    run_start = torch.nonzero(change).squeeze(1)
    run_id = torch.cumsum(change, 0) - 1
    offset = idx - run_start[run_id]
    del run_id, run_start
    sub_start = change | (offset % RLE_MAX_RUN == 0)
    del change, offset
    sub_idx = torch.nonzero(sub_start).squeeze(1)
    del sub_start, idx
    sub_len = torch.diff(sub_idx, append=torch.tensor([n], device=dev))
    sym = x[sub_idx]
    escaped = (sub_len >= RLE_MIN_RUN) | (sym == 0)
    out_sizes = torch.where(escaped, 3, sub_len)
    sub_block = sub_idx // block_size
    sizes = torch.zeros(n_blocks, dtype=torch.int64, device=dev)
    sizes.index_add_(0, sub_block, out_sizes)
    seg = torch.repeat_interleave(
        torch.arange(sub_idx.numel(), device=dev), out_sizes)
    first = torch.cumsum(out_sizes, 0) - out_sizes
    within = torch.arange(seg.numel(), device=dev) - first[seg]
    esc = torch.where(within == 0, 0,
                      torch.where(within == 1, sym[seg].long(), sub_len[seg]))
    out = torch.where(escaped[seg], esc, sym[seg].long()).to(torch.uint8)
    return out, sub_block[seg], sizes.tolist()


def histograms(stream: torch.Tensor, block: torch.Tensor,
               n_blocks: int) -> torch.Tensor:
    """(n_blocks, 256) int64 byte counts of each block of a stream."""
    flat = block * 256 + stream.long()
    return torch.bincount(flat, minlength=n_blocks * 256).view(n_blocks, 256)
