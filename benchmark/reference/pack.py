"""Bit packing of module C: each symbol's code, most significant bit first,
concatenated over a block and zero-padded to a whole byte (c.c:52-83).

The arithmetic of ``shafa_tpu_torch/oracle.py::pack`` (one bit an element)
recast for whole files in plain torch: each code is cut into pieces of at
most 32 bits, each piece lands in at most two 32-bit words, and adding the
pieces into the words equals OR-ing them, since no two pieces share a bit.
Every block starts at a word of its own and keeps its first
ceil(bits / 8) bytes.
"""

from __future__ import annotations

import torch


def _place(words: torch.Tensor, value: torch.Tensor, length: torch.Tensor,
           pos: torch.Tensor) -> None:
    """Add value (length <= 32 bits, right-aligned) at bit pos of words."""
    keep = length > 0
    value, length, pos = value[keep], length[keep], pos[keep]
    w = pos >> 5
    s = pos & 31
    aligned = value << (32 - length)
    words.index_add_(0, w, aligned >> s)
    words.index_add_(0, w + 1, (aligned & ((1 << s) - 1)) << (32 - s))


def pack(stream: torch.Tensor, block: torch.Tensor, n_blocks: int,
         lens: torch.Tensor, vals_hi: torch.Tensor, vals_lo: torch.Tensor
         ) -> list[bytes]:
    """Payloads of every block of ``stream`` (uint8) whose bytes lie in
    ``block`` (int64, non-decreasing), with (n_blocks, 256) code lengths
    ``lens`` and values split as ``vals_hi`` (the first min(len, 32) bits)
    and ``vals_lo`` (the len - 32 bits after them, if any)."""
    dev = stream.device
    key = block * 256 + stream.long()
    ln = lens.view(-1)[key]
    bits = torch.zeros(n_blocks, dtype=torch.int64, device=dev)
    bits.index_add_(0, block, ln)
    words_per = (bits + 31) // 32
    word_base = torch.cumsum(words_per, 0) - words_per
    bit_base = torch.cumsum(bits, 0) - bits
    pos = torch.cumsum(ln, 0) - ln - bit_base[block] + word_base[block] * 32
    words = torch.zeros(int(words_per.sum()) + 1, dtype=torch.int64,
                        device=dev)
    hi_len = ln.clamp(max=32)
    _place(words, vals_hi.view(-1)[key], hi_len, pos)
    if int(lens.max()) > 32:
        _place(words, vals_lo.view(-1)[key], ln - hi_len, pos + 32)
    del key, ln, pos
    raw = torch.stack([(words >> sh) & 255 for sh in (24, 16, 8, 0)], 1)
    raw = raw.to(torch.uint8).view(-1).cpu().numpy().tobytes()
    out = []
    for b, base in zip(bits.tolist(), word_base.tolist()):
        out.append(raw[4 * base:4 * base + (b + 7) // 8])
    return out
