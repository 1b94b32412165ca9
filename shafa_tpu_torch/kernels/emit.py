"""K1: variable-rate bit emission (csrc/emit.cu).

Port of shafa_tpu/kernels/emit_pallas.py. Every lane of a (B, P) input
carries a left-aligned payload of 0-32 bits; row r's payloads are
concatenated MSB-first into the flat int32 output starting at word woff[r].
The little-endian byte view of the words is the file's byte stream. Words
outside the rows' payloads are zero; bytes past a row's length are
unspecified by the contract (callers slice by length).

u32 payloads travel as int32 tensors holding the same bits: torch has no
shifts or compares for uint32 on the CPU, so the plain versions widen them
to int64 and mask with 0xFFFFFFFF.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

#: 8 KiB in u32 words: the JAX kernel's flush unit. aligned_offsets keeps
#: its 2 * PAGE words of slack so that both packages lay rows out alike.
PAGE = 2048

_U32 = 0xFFFFFFFF


def aligned_offsets(byte_lens, align: int = 512):
    """512 B-aligned row start offsets for a back-to-back layout.

    Copy of shafa_tpu/kernels/emit_pallas.py:466. Returns (woff_words (B,)
    int32, total_words incl. 2*PAGE slack). Row i's bytes are
    [4*woff[i], 4*woff[i] + byte_lens[i]).
    """
    starts = np.zeros(len(byte_lens), np.int64)
    pos = 0
    for i, n in enumerate(byte_lens):
        starts[i] = pos
        pos += (int(n) + align - 1) // align * align
    return (starts // 4).astype(np.int32), pos // 4 + 2 * PAGE


def to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def bswap32(v: torch.Tensor) -> torch.Tensor:
    """Byte-reverse int64 values in [0, 2^32)."""
    return (((v >> 24) & 0xFF) | ((v >> 8) & 0xFF00)
            | ((v << 8) & 0xFF0000) | ((v << 24) & 0xFF000000))


def _emit_plain(val: torch.Tensor, bitlen: torch.Tensor,
                row_lens: torch.Tensor, woff: torch.Tensor,
                out_words: int) -> torch.Tensor:
    """Plain version of both K1 variants: val (B, P) int64 in [0, 2^32)."""
    b, p = bitlen.shape
    dev = bitlen.device
    pos = torch.arange(p, device=dev)
    ln = torch.where(pos < row_lens.to(dev)[:, None],
                     bitlen.to(torch.int64).clamp(0, 32), 0)
    mask = (_U32 << (32 - ln.clamp(min=1))) & _U32
    v = torch.where(ln > 0, val & mask, 0)
    off = torch.cumsum(ln, dim=1) - ln              # row-relative bit offsets
    r = off & 31
    word = woff.to(dev, torch.int64)[:, None] + (off >> 5)
    spill = r + ln > 32                              # payload reaches word + 1
    hi = v >> r
    lo = torch.where(spill, (v << (32 - r).clamp(max=31)) & _U32, 0)
    dump = out_words                                 # index of a dropped slot
    acc = torch.zeros(out_words + 1, dtype=torch.int64, device=dev)
    # bits of different lanes never overlap, so summing is OR-ing
    # words past the buffer are dropped, as the kernel drops them
    acc.index_add_(0, torch.where((ln > 0) & (word < out_words), word,
                                  dump).reshape(-1), hi.reshape(-1))
    acc.index_add_(0, torch.where(spill & (word + 1 < out_words), word + 1,
                                  dump).reshape(-1), lo.reshape(-1))
    return to_i32(bswap32(acc[:out_words]))


def emit_bits_plain(val, bitlen, row_lens, woff, out_words: int):
    """Plain version of emit_bits."""
    return _emit_plain(val.to(torch.int64) & _U32, bitlen, row_lens, woff,
                       out_words)


def emit_coded_plain(x, row_lens, lut_len, lut_val, woff, out_words: int):
    """Plain version of emit_coded."""
    xi = x.to(torch.int64)
    ln = torch.gather(lut_len.to(torch.int64), 1, xi)
    val = torch.gather(lut_val.to(torch.int64) & _U32, 1, xi)
    return _emit_plain(val, ln, row_lens, woff, out_words)


def _emit_cuda(b: int, p: int, row_lens, woff, out_words: int, *,
               val=None, bitlen=None, x=None, lut_len=None, lut_val=None):
    dev = row_lens.device
    lut = x is not None
    ptrs = (
        [None, None, _build.ptr(x, torch.uint8, (b, p), dev),
         _build.ptr(lut_len, torch.int32, (b, 256), dev),
         _build.ptr(lut_val, torch.int32, (b, 256), dev)] if lut else
        [_build.ptr(val, torch.int32, (b, p), dev),
         _build.ptr(bitlen, torch.int32, (b, p), dev), None, None, None])
    rows = [_build.ptr(row_lens, torch.int32, (b,), dev),
            _build.ptr(woff, torch.int32, (b,), dev)]
    lib = _build.library()
    n_tiles = -(-p // lib.shafa_emit_tile_lanes())
    # look-back words of the (B, n_tiles) tiles, then the ticket
    status = torch.empty(b * n_tiles + 1, dtype=torch.int64, device=dev)
    out = torch.zeros(out_words, dtype=torch.int32, device=dev)
    _build.launch("emit_coded" if lut else "emit_bits", dev, "shafa_emit",
                  *ptrs, int(lut), *rows, b, p, status.data_ptr(),
                  out.data_ptr(), out_words)
    return out


def emit_bits(val, bitlen, row_lens, woff, out_words: int) -> torch.Tensor:
    """Concatenate per-lane payloads into rows of one flat buffer.

    val (B, P) int32 (u32 bits, left-aligned); bitlen (B, P) int32 in
    [0, 32]; row_lens (B,) int32 valid lanes per row; woff (B,) int32 first
    output word per row. Returns (out_words,) int32.
    """
    if val.device.type == "cpu":
        return emit_bits_plain(val, bitlen, row_lens, woff, out_words)
    b, p = val.shape
    return _emit_cuda(b, p, row_lens, woff, out_words, val=val,
                      bitlen=bitlen)


def emit_coded(x, row_lens, lut_len, lut_val, woff,
               out_words: int) -> torch.Tensor:
    """The LUT variant (module C): lane payload = row's code for byte x.

    x (B, P) uint8; lut_len (B, 256) int32 code lengths in [0, 32]; lut_val
    (B, 256) int32 (u32 bits of the left-aligned codes). Other arguments and
    the result as emit_bits.
    """
    if x.device.type == "cpu":
        return emit_coded_plain(x, row_lens, lut_len, lut_val, woff,
                                out_words)
    b, p = x.shape
    return _emit_cuda(b, p, row_lens, woff, out_words, x=x, lut_len=lut_len,
                      lut_val=lut_val)


def _row_layout(b: int, stride_words: int, device) -> torch.Tensor:
    if stride_words % 128:
        raise ValueError("stride_words must be a multiple of 128")
    return torch.arange(b, dtype=torch.int32, device=device) * stride_words


def emit_bits_rows(val, bitlen, row_lens, stride_words: int) -> torch.Tensor:
    """emit_bits into a strided (B, 4*stride_words) uint8 row layout: row
    r's stream is out[r, :ceil(bits_r / 8)]."""
    b = val.shape[0]
    woff = _row_layout(b, stride_words, val.device)
    flat = emit_bits(val, bitlen, row_lens, woff, b * stride_words)
    return flat.view(b, stride_words).view(torch.uint8)


def emit_bits_rows_plain(val, bitlen, row_lens,
                         stride_words: int) -> torch.Tensor:
    """Plain version of emit_bits_rows."""
    b = val.shape[0]
    woff = _row_layout(b, stride_words, val.device)
    flat = emit_bits_plain(val, bitlen, row_lens, woff, b * stride_words)
    return flat.view(b, stride_words).view(torch.uint8)
