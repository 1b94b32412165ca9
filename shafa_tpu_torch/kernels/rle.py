"""The RLE encode (K8, csrc/rle_encode.cu) and the RLE token fields (module
F's block_compression, f.c:29-55; module D's rle_block_decompressor,
d.c:116-197).

Port of shafa_tpu/kernels/rle.py. On the card the encode is K8, one launch
(one pass with decoupled look-backs) for the run analysis, the byte emission
and the histogram of the RLE rows.
Its plain version, the CPU's route, is the JAX package's composition in
plain torch: the per-lane run analysis (_rle_analyze, rle_payloads), K1's
plain emission and the histogram. The decoder's token starts are the orbit
of byte 0 under i -> i + (3 if x[i] == 0 else 1); they are found here by a
plain torch composition scan of the 3-state machine that rle.py:156-191
runs through lax.associative_scan.
"""

from __future__ import annotations

import torch

from . import _build
from . import histogram as khist
from .emit import emit_bits_rows_plain

MAX_RUN = 255
MIN_ESCAPE_RUN = 4


def rle_out_bound(p: int) -> int:
    """Worst-case RLE output for a p-byte block, rounded to 512 bytes
    (rle.py:43)."""
    return (2 * p + 8 + 511) & ~511


def _rle_analyze(x: torch.Tensor, lengths: torch.Tensor):
    """Per-lane run analysis (rle.py:52-81).

    Returns (xi, valid, sub_start, sub_len, escaped, contrib): each lane's
    sub-segment geometry (runs split at 255) and its output contribution in
    bytes (3 at an escape start, 1 for a literal, 0 inside an escaped run or
    past the row's length). All int32 / bool (B, P).
    """
    b, p = x.shape
    dev = x.device
    xi = x.to(torch.int32)
    lens = lengths.to(dev, torch.int32)[:, None]
    pos = torch.arange(p, dtype=torch.int32, device=dev).expand(b, p)
    valid = pos < lens
    change = torch.ones_like(valid)
    change[:, 1:] = xi[:, 1:] != xi[:, :-1]
    run_start = torch.cummax(torch.where(change, pos, 0), dim=1).values
    sub_start = (change | ((pos - run_start) % MAX_RUN == 0)) & valid
    # next sub start strictly after each lane = the end of the lane's sub
    start_pos = torch.where(sub_start, pos, p)
    nxt = torch.cummin(start_pos.flip(1), dim=1).values.flip(1)
    nxt_after = torch.full_like(nxt, p)
    nxt_after[:, :-1] = nxt[:, 1:]
    sub_end = torch.minimum(nxt_after, lens)
    sstart = torch.cummax(torch.where(sub_start, pos, 0), dim=1).values
    sub_len = sub_end - sstart
    escaped = (sub_len >= MIN_ESCAPE_RUN) | (xi == 0)
    contrib = torch.where(valid, torch.where(
        escaped, torch.where(sub_start, 3, 0), 1), 0).to(torch.int32)
    return xi, valid, sub_start, sub_len, escaped, contrib


def rle_payloads(x: torch.Tensor, lengths: torch.Tensor):
    """K1's input for the RLE encode (rle.py:84-104): (val (B, P) int32 u32
    bits, bitlen (B, P) int32, out_len (B,) int64 RLE lengths).

    An escape start emits the 24-bit triple (0x00, symbol, count), a literal
    its 8-bit byte, a lane inside an escaped run nothing.
    """
    xi, valid, sub_start, sub_len, escaped, contrib = _rle_analyze(x,
                                                                   lengths)
    out_len = contrib.sum(dim=1, dtype=torch.int64)
    is_trip = escaped & sub_start
    bitlen = torch.where(valid, torch.where(
        escaped, torch.where(sub_start, 24, 0), 8), 0).to(torch.int32)
    # the literal's byte in the top 8 bits; products keep int32 exact
    lit = torch.where(xi >= 128, xi - 256, xi) * (1 << 24)
    val = torch.where(is_trip, xi * (1 << 16) + sub_len * (1 << 8), lit)
    return val.to(torch.int32), bitlen, out_len


def rle_encode_hist_plain(x: torch.Tensor, lengths: torch.Tensor):
    """K8's plain version: rle_payloads, K1's plain emission, then the
    histogram of the RLE rows."""
    val, bitlen, out_len = rle_payloads(x, lengths)
    enc = emit_bits_rows_plain(val, bitlen, lengths.to(x.device, torch.int32),
                               rle_out_bound(x.shape[1]) // 4)
    return enc, out_len, khist.histogram_batch(enc, out_len)


def rle_encode_hist(x: torch.Tensor, lengths: torch.Tensor):
    """(B, P) uint8 + (B,) lengths -> (enc (B, rle_out_bound(P)) uint8 RLE
    rows, out_len (B,) int64 RLE lengths, hist (B, 256) int64 counts of each
    row's enc[:out_len]); bytes past a row's length are unspecified.

    On the card this is K8, and P must be a multiple of 16 (the batches'
    widths are powers of two >= 256); on the CPU it is the plain version.
    """
    if x.device.type == "cpu":
        return rle_encode_hist_plain(x, lengths)
    b, p = x.shape
    if p % 16:
        raise ValueError(f"rle_encode_hist: row width {p} is not a multiple "
                         "of 16")
    dev = x.device
    lengths = lengths.to(dev, torch.int32).contiguous()
    args = [_build.ptr(x, torch.uint8, (b, p), dev),
            _build.ptr(lengths, torch.int32, (b,), dev)]
    n_tiles = -(-p // _build.library().shafa_rle_encode_tile_bytes())
    stride = rle_out_bound(p)
    # the look-back's words of the two carries per tile, then the ticket
    status = torch.empty(2 * b * n_tiles + 1, dtype=torch.int64, device=dev)
    enc = torch.empty((b, stride), dtype=torch.uint8, device=dev)
    out_len = torch.empty(b, dtype=torch.int64, device=dev)
    hist = torch.empty((b, 256), dtype=torch.int64, device=dev)
    _build.launch("rle_encode", dev, "shafa_rle_encode", *args, b, p,
                  status.data_ptr(), enc.data_ptr(), stride,
                  out_len.data_ptr(), hist.data_ptr())
    return enc, out_len, hist


def rle_encode_batch(x: torch.Tensor, lengths: torch.Tensor):
    """rle_encode_hist's (enc, out_len)."""
    enc, out_len, _ = rle_encode_hist(x, lengths)
    return enc, out_len


def _compose3(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a then c, for 3-state functions packed as f(0) | f(1) << 2 | f(2) << 4
    in uint8."""
    out = torch.zeros_like(a)
    for s in range(3):
        a_s = (a >> (2 * s)) & 3
        out |= ((c >> (2 * a_s)) & 3) << (2 * s)
    return out


def token_starts(xi: torch.Tensor) -> torch.Tensor:
    """(B, P) bytes -> bool mask of RLE token starts (rle.py:156-191).

    The state before byte i is the number of escape-payload bytes still
    pending, in {0, 1, 2}; a byte seen in state 0 starts a token, and a
    0x00 start leaves 2 pending. Each byte's transition function is composed
    along the row by a Hillis-Steele scan in log2(P) rounds.
    """
    b, p = xi.shape
    # f = (f(0), f(1), f(2)) = (2 if escape else 0, 0, 1)
    f = (torch.where(xi == 0, 2, 0) | (1 << 4)).to(torch.uint8)
    k = 1
    while k < p:
        f = torch.cat([f[:, :k], _compose3(f[:, :-k], f[:, k:])], dim=1)
        k *= 2
    state_before = torch.zeros_like(f)
    state_before[:, 1:] = f[:, :-1] & 3  # composed prefix applied to state 0
    return state_before == 0


def token_fields(x: torch.Tensor, lengths: torch.Tensor):
    """Per-lane RLE tokens of (B, P) streams (rle.py:194-206).

    Returns (is_start, sym, cnt): cnt is the token's repeat count at its
    start lane (a zero-count escape emits one copy, d.c:179-184) and 0
    elsewhere. Escape fields past a row's length read as 0.
    """
    b, p = x.shape
    dev = x.device
    xi = x.to(torch.int32)
    lens = lengths.to(dev, torch.int64)[:, None]
    pos = torch.arange(p, device=dev)
    valid = pos < lens
    is_start = token_starts(xi) & valid
    x1 = torch.zeros_like(xi)
    x2 = torch.zeros_like(xi)
    x1[:, :-1] = torch.where(pos[1:] < lens, xi[:, 1:], 0)
    x2[:, :-2] = torch.where(pos[2:] < lens, xi[:, 2:], 0)
    esc = is_start & (xi == 0)
    sym = torch.where(esc, x1, xi)
    cnt = torch.where(is_start,
                      torch.where(esc, torch.clamp(x2, min=1), 1), 0)
    return is_start, sym, cnt
