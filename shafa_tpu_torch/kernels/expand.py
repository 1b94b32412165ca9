"""K4: RLE run expansion (csrc/expand.cu).

Port of shafa_tpu/kernels/expand_pallas.py: rle_expand_pages with its token
scan (rle_expand_prep) taken into the kernel. rle_expand_sizes gives each
row's expanded size from the RLE rows; once the host has downloaded them,
rle_expand writes all rows back to back into the exact compacted buffer
that the host writes to disk. On the CPU both run the plain version:
rle_expand_prep's token scan, then expand_tokens_plain.
"""

from __future__ import annotations

import torch

from . import _build
from .rle import token_fields


def rle_expand_prep(x: torch.Tensor, lengths: torch.Tensor) -> dict:
    """Token scan + sums of a (B, P) batch of RLE streams
    (expand_pallas.py:200-230), the plain version's first step.

    Returns {sym (B, P) uint8 token symbols, cum (B, P) int64 inclusive
    per-row sum of the tokens' repeat counts, out_len (B,) int64 expanded
    row sizes, out_base (B,) int64 row starts when rows lie back to back}.
    The TPU's sentinel offsets and symbol deltas (expand_pallas.py:57-61)
    served its page masking only and have no counterpart here.
    """
    _, sym, cnt = token_fields(x, lengths)
    cum = torch.cumsum(cnt, dim=1, dtype=torch.int64)
    out_len = cum[:, -1].clone()
    out_base = torch.cumsum(out_len, dim=0) - out_len
    return dict(sym=sym.to(torch.uint8), cum=cum, out_len=out_len,
                out_base=out_base)


def expand_tokens_plain(cum, sym, row_base, out_size: int) -> torch.Tensor:
    """The plain version's second step: out[row_base[r] + cum[r, j] - cnt :
    +cnt] = sym[r, j], cnt = cum[r, j] - cum[r, j - 1]. Returns (out_size,)
    uint8; bytes no token covers are zero, bytes past out_size are
    dropped."""
    dev = cum.device
    cnt = torch.diff(cum, dim=1, prepend=torch.zeros_like(cum[:, :1]))
    tok = cnt > 0
    starts = (row_base.to(dev)[:, None] + cum - cnt)[tok]
    c = cnt[tok]
    first = torch.cumsum(c, dim=0) - c  # each token's first run byte
    within = torch.arange(int(c.sum()), device=dev) \
        - torch.repeat_interleave(first, c)
    idx = torch.repeat_interleave(starts, c) + within
    keep = idx < out_size
    out = torch.zeros(out_size, dtype=torch.uint8, device=dev)
    out[idx[keep]] = torch.repeat_interleave(sym[tok], c)[keep]
    return out


def rle_expand_sizes(x: torch.Tensor, lengths: torch.Tensor) -> dict:
    """K4's passes A and B (and the rows' starts): (B, P) uint8 RLE rows and
    their (B,) int32 lengths -> a dict whose "out_len" holds the (B,) int64
    expanded row sizes, on x's device; rle_expand takes the whole dict.

    Token semantics of rle.token_fields: escape fields past a row's length
    read as 0. On the card P must be a multiple of 16 (the batches' widths
    are powers of two >= 256). On the CPU the dict is rle_expand_prep's.
    """
    if x.device.type == "cpu":
        return rle_expand_prep(x, lengths)
    b, p = x.shape
    if p % 16:
        raise ValueError(f"rle_expand_sizes: row width {p} is not a multiple "
                         "of 16")
    dev = x.device
    args = [_build.ptr(x, torch.uint8, (b, p), dev),
            _build.ptr(lengths, torch.int32, (b,), dev)]
    lib = _build.library()
    n_tiles = -(-p // lib.shafa_expand_tile_bytes())
    sums = torch.empty((b, n_tiles, 4), dtype=torch.int32, device=dev)
    sizes = dict(x=x, lengths=lengths,
                 tile_entry=torch.empty((b, n_tiles), dtype=torch.uint8,
                                        device=dev),
                 tile_base=torch.empty((b, n_tiles), dtype=torch.int64,
                                       device=dev),
                 out_len=torch.empty(b, dtype=torch.int64, device=dev),
                 out_base=torch.empty(b, dtype=torch.int64, device=dev))
    _build.launch("expand_sizes", dev, "shafa_expand_sizes", *args, b, p,
                  sums.data_ptr(),
                  *[sizes[k].data_ptr() for k in ("tile_entry", "tile_base",
                                                  "out_len", "out_base")])
    return sizes


def rle_expand(sizes: dict, total: int) -> torch.Tensor:
    """K4's pass C: all rows' expanded bytes back to back, (total,) uint8,
    where total is the sum of the sizes the host took from
    sizes["out_len"] (a batch's first rows: the rows after them are cut at
    total)."""
    if sizes["out_len"].device.type == "cpu":
        return expand_tokens_plain(sizes["cum"], sizes["sym"],
                                   sizes["out_base"], total)
    x = sizes["x"]
    b, p = x.shape
    dev = x.device
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    if out.data_ptr() % 16:
        raise ValueError("rle_expand: output needs 16-byte alignment")
    _build.launch("expand", dev, "shafa_expand", x.data_ptr(),
                  sizes["lengths"].data_ptr(), b, p,
                  *[sizes[k].data_ptr() for k in ("tile_entry", "tile_base",
                                                  "out_base")],
                  out.data_ptr(), total)
    return out
