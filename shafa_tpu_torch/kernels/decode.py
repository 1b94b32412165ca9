"""Shannon-Fano prefix decode on the device.

Port of the all-kernel routes of shafa_tpu/kernels/decode.py. The code set is
complete and its codes in rank order are lexicographically increasing, so
the code at a bit position is the one with the largest left-aligned value
<= the window there (codes.py).

Codes of at most 16 bits (_decode_fused_tpu, decode.py:1466): the payload
bytes -> the code at every bit position, found with one lookup in a table
indexed by the window's top 12 bits (K2, csrc/rank.cu) -> the boundary
state machine, which writes the decoded bytes into each row and flags
underrun (K3, csrc/fsm_decode.cu).

Codes of 17-32 bits (_decode_fused32_tpu, decode.py:580): the payload
bytes -> the code at every bit position on full 32-bit windows, found with
one lookup in a table indexed by the window's top 12 bits and, where those
leave it open, a short search (K5, csrc/rank32.cu) -> the 32-state
boundary machine, which replays each
byte's symbols into two packs clipped at the row's count, interleaved as
(B, 2P) lanes (K6, csrc/fsm32.cu) -> K1's bits emission concatenates them
into the decoded rows.

Both routes take their tables from the batch's code tables on the card:
the codes in rank order, their sym | len << 8 and the 12-bit table (K9,
csrc/decode_tables.cu, decode_tables_on_device); decode_tables_batch,
rank_tables(32) and rank_lut12(_32) are its plain version.

The v4 chain, codes of at most 16 bits, which only the decode-stage
benchmark runs (bench_decode_stages.py:141-183): K2 -> the 8- or 16-state
machine writing its packs interleaved as K6 does (K7, csrc/fsm_decode.cu,
decode.py:1389) -> K1 (emit_packs, decode_batch_packs).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from . import _build
from .emit import emit_bits_rows, to_i32

#: rank_tables' prefix past the row's codes: above every 16-bit window
NO_CODE = 0x10000

#: rank_lut12's flag of an entry that holds a rank range
LUT_RANGE = 0x8000


def decode_tables_batch(lens: np.ndarray, vals: np.ndarray) -> dict:
    """Sorted decode tables of a batch of code tables.

    Copy of shafa_tpu/kernels/decode.py:95, raising ValueError where that
    asserts (decode.py:107). lens (n, 256) uint8, vals (n, 256) uint64
    left-aligned (codes.CodeTables layout). Every row needs codes of at most
    32 bits and at least one code.
    """
    n = lens.shape[0]
    present = lens > 0
    n_codes = present.sum(1).astype(np.int32)
    if n and (int(lens.max()) > 32 or int(n_codes.min()) < 1):
        raise ValueError("decode tables need 1-32-bit codes and at least one "
                         "code per row")
    # Sort present codes ascending by left-aligned value (rank order);
    # absent symbols to the back (their vals are 0, so force the key up).
    key = np.where(present, vals, np.uint64(0xFFFFFFFFFFFFFFFF))
    order = np.argsort(key, axis=1, kind="stable")
    rank_in = (np.arange(256)[None, :] < n_codes[:, None])
    lens_s = np.where(rank_in, np.take_along_axis(lens, order, 1), 0) \
        .astype(np.int64)
    syms_s = np.where(rank_in, order, 0).astype(np.int64)
    vals_s = np.take_along_axis(vals, order, 1)
    pc = np.where(rank_in, (vals_s >> np.uint64(32)).astype(np.uint32),
                  np.uint32(0))

    def deltas_prefix(x):
        d = np.diff(x, axis=1, prepend=0)
        d = np.where(rank_in, d, 0)
        d2 = d.reshape(n, 16, 16).astype(np.int32)
        gs = d2.sum(2)
        pref = np.concatenate(
            [np.zeros((n, 1), np.int64), np.cumsum(gs, axis=1,
                                                   dtype=np.int64)],
            axis=1)[:, :16].astype(np.int32)
        return d2, pref

    dlen2d, plen = deltas_prefix(lens_s)
    dsym2d, psym = deltas_prefix(syms_s)
    return {
        "pc": pc,
        "pivots": np.ascontiguousarray(pc[:, ::16]),
        "dlen2d": dlen2d,
        "plen": plen,
        "dsym2d": dsym2d,
        "psym": psym,
        "n_codes": n_codes,
    }


def _rank_ls(tab: dict):
    """(rank_in (n, 256) bool, ls (n, 256) int32 sym | len << 8 in rank
    order, 0 past the row's codes) of a decode_tables_batch dict."""
    n = np.asarray(tab["pc"]).shape[0]
    rank_in = np.arange(256)[None, :] < np.asarray(tab["n_codes"])[:, None]
    lens = np.cumsum(np.asarray(tab["dlen2d"]).reshape(n, 256), axis=1)
    syms = np.cumsum(np.asarray(tab["dsym2d"]).reshape(n, 256), axis=1)
    return rank_in, np.where(rank_in, syms | (lens << 8), 0).astype(np.int32)


def rank_tables(tab: dict):
    """decode_tables_batch dict -> K2's tables (pc16, ls), each (n, 256)
    int32 in rank order.

    pc16 holds the codes' left-aligned 16-bit prefixes, NO_CODE past the
    row's codes; ls holds sym | len << 8. The counterpart of
    shafa_tpu/kernels/decode.py:330, whose MXU fetch layout K2 does not need;
    like it, codes must be <= 16 bits, and longer ones raise ValueError
    (decode.py:339 asserts) instead of decoding garbage.
    """
    pc = np.asarray(tab["pc"])
    if (pc & np.uint32(0xFFFF)).max(initial=0) != 0:
        raise ValueError("rank_tables requires all codes <= 16 bits")
    rank_in, ls = _rank_ls(tab)
    pc16 = np.where(rank_in, pc >> np.uint32(16), NO_CODE).astype(np.int32)
    return pc16, ls


def rank_tables32(tab: dict):
    """decode_tables_batch dict -> K5's tables (pc32, ls, ncodes).

    pc32 (n, 256) int32 holds the u32 bits of the sorted left-aligned codes
    (zero past the row's codes), ls (n, 256) int32 sym | len << 8 (a length
    of 32 takes 6 bits), ncodes (n,) int32. No 32-bit value lies above every
    window, so K5's search is bounded by ncodes, not by a sentinel. The
    counterpart of shafa_tpu/kernels/decode.py:466, whose biased compares
    and byte-quarter fetch layout K5 does not need.
    """
    pc = np.asarray(tab["pc"]).astype(np.uint32)
    _, ls = _rank_ls(tab)
    return (np.ascontiguousarray(pc).view(np.int32), ls,
            np.asarray(tab["n_codes"]).astype(np.int32))


def rank_lut12(pc16: np.ndarray, ls: np.ndarray) -> np.ndarray:
    """K2's tables (rank_tables) -> (n, 4096) int16: the code of each
    12-bit window prefix.

    Entry t covers the 16-bit windows 16t..16t+15. Where one rank r (the
    largest with pc16[r] <= the window) holds for all 16, the entry is
    ls[r] (0 where no code lies below: an incomplete table); every code of
    at most 12 bits resolves so. Otherwise it is LUT_RANGE | depth << 8 |
    lo: the rank lies in lo..hi (lo = the rank at 16t, or 0 if there is
    none, hi the rank at 16t + 15), hi - lo < 2^depth, and K2 finds it by a
    depth-step binary search over pc16 from lo (csrc/rank.cu::search).
    Nothing is assumed of the code set, so a prefix shared by a short code
    and longer ones is a range too.
    """
    pc = np.asarray(pc16).astype(np.int64)
    return _lut12(pc, pc < NO_CODE, ls, 4)


def rank_lut12_32(pc32: np.ndarray, ls: np.ndarray,
                  ncodes: np.ndarray) -> np.ndarray:
    """K5's tables (rank_tables32) -> (n, 4096) int16: rank_lut12 for
    32-bit windows. Entry t covers the windows t << 20 .. (t << 20) +
    2^20 - 1; a range entry's search runs over pc32 as unsigned values,
    bounded by the row's ncodes (csrc/rank32.cu::search)."""
    pc = np.asarray(pc32).astype(np.int64) & 0xFFFFFFFF
    valid = np.arange(256)[None, :] < np.asarray(ncodes)[:, None]
    return _lut12(pc, valid, ls, 20)


def _lut12(pc: np.ndarray, valid: np.ndarray, ls, low_bits: int):
    """rank_lut12 over windows of 12 + low_bits bits: pc (n, 256) int64
    sorted codes, valid the ranks that hold one."""
    n = pc.shape[0]
    slot = (np.arange(n)[:, None] * 4096 + (pc >> low_bits))[valid]
    hist = np.bincount(slot, minlength=n * 4096).reshape(n, 4096)
    at_lo = np.bincount(slot[(pc[valid] & ((1 << low_bits) - 1)) == 0],
                        minlength=n * 4096).reshape(n, 4096)
    le_hi = np.cumsum(hist, axis=1)     # codes <= the prefix's last window
    le_lo = le_hi - hist + at_lo        # codes <= its first window
    r_lo, r_hi = le_lo - 1, le_hi - 1
    code = np.take_along_axis(np.asarray(ls).astype(np.int64),
                              np.maximum(r_hi, 0), axis=1)
    lo = np.maximum(r_lo, 0)
    depth = sum(((r_hi - lo) >> k) > 0 for k in range(8))  # bit length
    ent = np.where(r_lo == r_hi, np.where(r_hi >= 0, code, 0),
                   LUT_RANGE | (depth << 8) | lo)
    return ent.astype(np.uint16).view(np.int16)


def decode_tables_plain(lens: torch.Tensor, hi32: torch.Tensor,
                        wide: bool) -> tuple:
    """Plain version of decode_tables_on_device: decode_tables_batch, then
    rank_tables32 and rank_lut12_32 if wide, else rank_tables and
    rank_lut12, on the host."""
    vals = hi32.cpu().numpy().view(np.uint32).astype(np.uint64) \
        << np.uint64(32)
    tab = decode_tables_batch(lens.cpu().numpy(), vals)
    if wide:
        pc32, ls, ncodes = rank_tables32(tab)
        tabs = (pc32, ls, ncodes, rank_lut12_32(pc32, ls, ncodes))
    else:
        pc16, ls = rank_tables(tab)
        tabs = (pc16, ls, rank_lut12(pc16, ls))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in tabs)


def decode_tables_on_device(lens: torch.Tensor, hi32: torch.Tensor,
                            wide: bool) -> tuple:
    """A decode batch's code tables -> the tables of its rank kernel: (pc16,
    ls, lut12) for K2 (codes of at most 16 bits), or (pc32, ls, ncodes,
    lut) for K5 if wide (17-32 bits), as rank_tables(32) and
    rank_lut12(_32) build them.

    lens: (n, 256) uint8 code lengths (0 where a symbol is absent); hi32:
    (n, 256) int32, the high 32 bits of the left-aligned codes
    (codes.CodeTables.vals >> 32). Every row needs at least one code and
    codes of at most 32 bits, or of at most 16 where not wide. On the card
    K9 (csrc/decode_tables.cu) builds them, one launch a batch, and the
    counter decode_table_rows_on_device counts its rows."""
    if lens.device.type == "cpu":
        return decode_tables_plain(lens, hi32, wide)
    n = lens.shape[0]
    dev = lens.device
    lib = _build.library()
    args = [_build.ptr(lens, torch.uint8, (n, 256), dev),
            _build.ptr(hi32, torch.int32, (n, 256), dev)]
    pc = torch.empty((n, 256), dtype=torch.int32, device=dev)
    ls = torch.empty((n, 256), dtype=torch.int32, device=dev)
    ncodes = torch.empty(n, dtype=torch.int32, device=dev) if wide else None
    lut = torch.empty((n, lib.shafa_rank_lut_entries()), dtype=torch.int16,
                      device=dev)
    _build.launch("decode_tables", dev, "shafa_decode_tables", *args, n,
                  int(wide), pc.data_ptr(), ls.data_ptr(),
                  None if ncodes is None else ncodes.data_ptr(),
                  lut.data_ptr())
    tracing.count("decode_table_rows_on_device", n)
    return (pc, ls, ncodes, lut) if wide else (pc, ls, lut)


def windows32_bytes(payload: torch.Tensor) -> torch.Tensor:
    """(B, P) uint8 -> (B, P) int32: bytes j..j+3 big-endian, zero past the
    row. Copy of decode.py:354, which builds the JAX rank kernels' input;
    no route of the port calls it, since K2 and K5 read the payload bytes
    themselves."""
    b, p = payload.shape
    by = torch.zeros((b, p + 3), dtype=torch.int64, device=payload.device)
    by[:, :p] = payload
    w = ((by[:, :p] << 24) | (by[:, 1:p + 1] << 16) | (by[:, 2:p + 2] << 8)
         | by[:, 3:p + 3])
    return to_i32(w)


def rank_planes_plain(payload, pc16, ls):
    """Plain version of rank_planes: the windows from the bytes, then
    searchsorted per bit offset (no 12-bit table)."""
    b, p = payload.shape
    by = torch.zeros((b, p + 2), dtype=torch.int64, device=payload.device)
    by[:, :p] = payload
    v24 = (by[:, :p] << 16) | (by[:, 1:p + 1] << 8) | by[:, 2:p + 2]
    pc = pc16.to(torch.int64).contiguous()
    table = ls.to(torch.int64)
    planes = []
    for s in range(8):
        w16 = (v24 >> (8 - s)) & 0xFFFF
        r = torch.searchsorted(pc, w16, right=True) - 1
        v = torch.gather(table, 1, r.clamp(min=0))
        planes.append(torch.where(r >= 0, v, 0))
    return torch.stack(planes).reshape(8, b * p).to(torch.int32)


def rank_planes(payload: torch.Tensor, pc16: torch.Tensor, ls: torch.Tensor,
                lut12: torch.Tensor) -> torch.Tensor:
    """(B, P) uint8 payloads + K2 tables (rank_tables, rank_lut12) ->
    (8, B*P) int32 planes: plane s, lane r*P + j = sym | len << 8 of the
    code at bit 8j+s of row r, bytes past P read as zero (0 where no code
    fits, which a complete table never gives). On the card P must be a
    multiple of 16 (the decode batches' widths are powers of two >= 1024).
    """
    if payload.device.type == "cpu":
        return rank_planes_plain(payload, pc16, ls)
    b, p = payload.shape
    if p % 16:
        raise ValueError(f"rank_planes: payload width {p} is not a multiple "
                         "of 16")
    dev = payload.device
    lib = _build.library()
    args = [_build.ptr(payload, torch.uint8, (b, p), dev),
            _build.ptr(lut12, torch.int16,
                       (b, lib.shafa_rank_lut_entries()), dev),
            _build.ptr(pc16, torch.int32, (b, 256), dev),
            _build.ptr(ls, torch.int32, (b, 256), dev)]
    if args[0] % 16 or args[1] % 16:
        raise ValueError("rank_planes: payload and table need 16-byte "
                         "alignment")
    out = torch.empty((8, b * p), dtype=torch.int32, device=dev)
    _build.launch("rank", dev, "shafa_rank_planes", *args, b, p,
                  out.data_ptr())
    return out


#: Lanes of a row that entry_states composes at once: a chunk's (C, 32)
#: int64 functions take 256 MiB a copy, whatever the row's length.
COMPOSE_CHUNK = 1 << 20


def byte_functions(ln: torch.Tensor, s_states: int) -> torch.Tensor:
    """(8, ..., n) code lengths (1 to s_states) of each byte's 8 bit
    positions -> (..., n, s_states) int64 transition functions: f[j][state]
    is the state after byte j entered in state. States below 8 are a
    boundary at that bit; state s >= 8 is a code that ends s - 8 bits into
    the next byte. The E-table (shafa_tpu/kernels/decode.py:666, :1175),
    the state at the byte's end for a boundary at each bit, gives the first
    8 entries."""
    e_tab = [None] * 8
    for bit in range(7, -1, -1):
        nb = bit + ln[bit]
        e = nb - 8
        for c in range(bit + 1, 8):
            e = torch.where(nb == c, e_tab[c], e)
        e_tab[bit] = e.clamp(0, s_states - 1)
    consts = [torch.full_like(e_tab[0], s - 8) for s in range(8, s_states)]
    return torch.stack(e_tab + consts, dim=-1)


def entry_states(functions, p: int) -> torch.Tensor:
    """The state in which each byte of a row is entered, the row's first
    byte in state 0: (..., p) int64.

    functions(lo, hi) gives bytes lo..hi-1's transition functions, (...,
    hi - lo, S) int64 (byte_functions). They are taken COMPOSE_CHUNK lanes
    at a time: within a chunk a Hillis-Steele scan of gathers composes
    them (f[j] becomes byte lo, then ..., then byte j), each lane's state
    is its prefix function read at the chunk's entry state, and the
    chunk's last state enters the next chunk."""
    f = functions(0, min(COMPOSE_CHUNK, p))
    out = torch.empty(f.shape[:-2] + (p,), dtype=torch.int64,
                      device=f.device)
    carry = torch.zeros(f.shape[:-2] + (1, 1), dtype=torch.int64,
                        device=f.device)
    for lo in range(0, p, COMPOSE_CHUNK):
        hi = min(lo + COMPOSE_CHUNK, p)
        if lo:
            f = functions(lo, hi)
        k = 1
        while k < hi - lo:
            f = torch.cat([f[..., :k, :],
                           torch.gather(f[..., k:, :], -1, f[..., :-k, :])],
                          dim=-2)
            k *= 2
        after = torch.gather(f, -1, carry.expand(f.shape[:-1] + (1,)))[..., 0]
        del f
        out[..., lo] = carry[..., 0, 0]
        out[..., lo + 1:hi] = after[..., :-1]
        carry = after[..., -1:, None]
    return out


def decode_rows_plain(ls8, payload_lens, out_counts, s_states: int,
                      out_p: int):
    """Plain version of decode_rows: the same state machine, its functions
    composed by entry_states."""
    b = payload_lens.shape[0]
    p = ls8.shape[1] // b
    dev = ls8.device
    planes = ls8.to(torch.int64).reshape(8, b, p)
    ln = ((planes >> 8) & 31).clamp(1, s_states)
    sym = planes & 255
    q = entry_states(
        lambda lo, hi: byte_functions(ln[..., lo:hi], s_states), p)
    nb = torch.zeros_like(q)
    syms = []
    for _ in range(8):  # replay: the byte's ordered boundary symbols
        is_b = q < 8
        qc = q.clamp(max=7)[None]
        syms.append(torch.gather(sym, 0, qc)[0])
        nb += is_b
        q = torch.where(is_b, q + torch.gather(ln, 0, qc)[0], q)
    valid = torch.arange(p, device=dev) < payload_lens.to(dev)[:, None]
    nb = torch.where(valid, nb, 0)
    before = torch.cumsum(nb, dim=1) - nb
    counts = out_counts.to(dev, torch.int64)[:, None]
    under = before[:, -1] + nb[:, -1] < counts[:, 0]
    out = torch.zeros(b * out_p, dtype=torch.uint8, device=dev)
    row0 = torch.arange(b, device=dev)[:, None] * out_p
    for i, s in enumerate(syms):
        keep = (i < nb) & (before + i < counts.clamp(max=out_p))
        out[(row0 + before + i)[keep]] = s[keep].to(torch.uint8)
    return out.view(b, out_p), under


def _fsm16_args(ls8, payload_lens, out_counts, what: str) -> list:
    """K3's and K7's inputs and scratch: the planes, the row lengths and
    counts, then per tile the functions, the entry states and the
    look-back's words (with the ticket after them)."""
    b = payload_lens.shape[0]
    p = ls8.shape[1] // b
    if p % 8:
        raise ValueError(f"{what}: payload width {p} is not a multiple of 8")
    dev = ls8.device
    n_tiles = -(-p // _build.library().shafa_fsm_decode_tile_bytes())
    scratch = [torch.empty((b, n_tiles), dtype=torch.int64, device=dev),
               torch.empty((b, n_tiles), dtype=torch.int32, device=dev),
               torch.empty(b * n_tiles + 1, dtype=torch.int64, device=dev)]
    return [_build.ptr(ls8, torch.int32, (8, b * p), dev),
            _build.ptr(payload_lens, torch.int32, (b,), dev),
            _build.ptr(out_counts, torch.int32, (b,), dev),
            scratch]


def decode_rows(ls8: torch.Tensor, payload_lens: torch.Tensor,
                out_counts: torch.Tensor, s_states: int, out_p: int):
    """K2 planes -> ((B, out_p) uint8 decoded rows, (B,) bool underrun).

    payload_lens, out_counts: (B,) int32. s_states (8 or 16) >= the batch's
    longest code. Row r's symbols are out[r, :out_counts[r]] (out_p >= every
    count; symbols past out_p are dropped); bytes past them are zero.
    Underrun: the payload holds fewer symbols than the count. On the card
    P must be a multiple of 8 and out_p of 4.
    """
    if s_states not in (8, 16):
        raise ValueError("s_states must be 8 or 16")
    if ls8.device.type == "cpu":
        return decode_rows_plain(ls8, payload_lens, out_counts, s_states,
                                 out_p)
    if out_p % 4:
        raise ValueError(f"decode_rows: row width {out_p} is not a multiple "
                         "of 4")
    *args, scratch = _fsm16_args(ls8, payload_lens, out_counts, "decode_rows")
    b = payload_lens.shape[0]
    dev = ls8.device
    out = torch.zeros((b, out_p), dtype=torch.uint8, device=dev)
    under = torch.empty(b, dtype=torch.int32, device=dev)
    _build.launch("fsm_decode", dev, "shafa_fsm_decode", *args, s_states,
                  b, ls8.shape[1] // b, *[t.data_ptr() for t in scratch],
                  out.data_ptr(), out_p, under.data_ptr())
    return out, under.bool()


def decode_batch(payload, payload_lens, pc16, ls, lut12, out_counts,
                 out_p: int, s_states: int):
    """(B, P) packed payloads -> ((B, out_p) uint8 decoded rows, underrun):
    K2, K3. Tables from rank_tables and rank_lut12 (codes <= 16 bits)."""
    ls8 = rank_planes(payload, pc16, ls, lut12)
    return decode_rows(ls8, payload_lens, out_counts, s_states, out_p)


# -- codes of 17-32 bits: K5, K6 --------------------------------------------

def rank_planes32_plain(payload, pc32, ls, ncodes):
    """Plain version of rank_planes32: the windows from the bytes, then
    searchsorted per bit offset, bounded by the row's code count (no
    12-bit table). Every lane of the batch is computed."""
    b, p = payload.shape
    dev = payload.device
    by = torch.zeros((b, p + 4), dtype=torch.int64, device=dev)
    by[:, :p] = payload
    w40 = by[:, :p] << 32  # bytes j..j+4, big-endian
    for i in range(1, 5):
        w40 |= by[:, i:p + i] << (32 - 8 * i)
    del by
    nc = ncodes.to(dev, torch.int64)[:, None]
    pc = pc32.to(torch.int64) & 0xFFFFFFFF
    # past the row's codes, repeat its last code: sorted, and min(., nc)
    # below keeps the search among the codes
    last = torch.gather(pc, 1, (nc - 1).clamp(min=0))
    pc = torch.where(torch.arange(256, device=dev) < nc, pc, last)
    pc = pc.contiguous()
    table = ls.to(torch.int64)
    planes = []
    for s in range(8):
        ws = (w40 >> (8 - s)) & 0xFFFFFFFF
        r = torch.minimum(torch.searchsorted(pc, ws, right=True), nc) - 1
        v = torch.gather(table, 1, r.clamp(min=0))
        planes.append(torch.where(r >= 0, v, 0))
    return torch.stack(planes).reshape(8, b * p).to(torch.int32)


def rank_planes32(payload: torch.Tensor, payload_lens: torch.Tensor,
                  pc32: torch.Tensor, ls: torch.Tensor, ncodes: torch.Tensor,
                  lut: torch.Tensor) -> torch.Tensor:
    """(B, P) uint8 payloads + K5 tables (rank_tables32, rank_lut12_32) ->
    (8, B*P) int32 planes, K2's layout: plane s, lane r*P + j = sym | len
    << 8 of the code at bit 8j+s of row r (0 where no code fits, which a
    complete table never gives). The window there spans bytes j..j+4, bytes
    past P read as zero. Entries at or past a row's payload length
    (payload_lens, (B,) int32) are unspecified: the kernel writes the lanes
    below it, rounded up to a multiple of 4, and K6 reads no others. On the
    card P must be a multiple of 16 (the decode batches' widths are powers
    of two >= 1024)."""
    if payload.device.type == "cpu":
        return rank_planes32_plain(payload, pc32, ls, ncodes)
    b, p = payload.shape
    if p % 16:
        raise ValueError(f"rank_planes32: payload width {p} is not a "
                         "multiple of 16")
    dev = payload.device
    lib = _build.library()
    args = [_build.ptr(payload, torch.uint8, (b, p), dev),
            _build.ptr(payload_lens, torch.int32, (b,), dev),
            _build.ptr(lut, torch.int16, (b, lib.shafa_rank_lut_entries()),
                       dev),
            _build.ptr(pc32, torch.int32, (b, 256), dev),
            _build.ptr(ls, torch.int32, (b, 256), dev),
            _build.ptr(ncodes, torch.int32, (b,), dev)]
    if args[0] % 16 or args[2] % 16:
        raise ValueError("rank_planes32: payload and table need 16-byte "
                         "alignment")
    out = torch.empty((8, b * p), dtype=torch.int32, device=dev)
    _build.launch("rank32", dev, "shafa_rank_planes32", *args, b, p,
                  out.data_ptr())
    return out


def _mask_top(nbytes: torch.Tensor) -> torch.Tensor:
    """int64 masks of the top 8 * nbytes bits of a u32 (nbytes in 0-4)."""
    return torch.where(nbytes > 0,
                       (0xFFFFFFFF << (32 - 8 * nbytes).clamp(max=31))
                       & 0xFFFFFFFF, 0)


def fsm_packs_plain(planes, payload_lens, out_counts, s_states: int):
    """Plain version of fsm_packs (s_states 8 or 16) and fsm32_packs
    (s_states 32): the E-table and replay of decode_rows_plain, one row at a
    time (a row's (P, s_states) functions are composed by entry_states),
    its four pack arrays interleaved by interleave_packs.
    Code lengths are `& 31` below 32 states and `& 63` at 32 (a length of
    32 takes 6 bits), clipped to [1, s_states]."""
    b = payload_lens.shape[0]
    p = planes.shape[1] // b
    dev = planes.device
    len_mask = 63 if s_states == 32 else 31
    lanes = planes.to(torch.int64).reshape(8, b, p)
    plens = payload_lens.to(dev, torch.int64)
    counts = out_counts.to(dev, torch.int64)
    packs = torch.zeros((4, b, p), dtype=torch.int64, device=dev)
    under = torch.zeros(b, dtype=torch.bool, device=dev)
    for r in range(b):
        ln = ((lanes[:, r] >> 8) & len_mask).clamp(1, s_states)  # (8, P)
        sym = lanes[:, r] & 255
        q = entry_states(
            lambda lo, hi: byte_functions(ln[:, lo:hi], s_states), p)
        nb = torch.zeros_like(q)
        vals = [torch.zeros_like(q), torch.zeros_like(q)]  # MSB first
        for i in range(8):  # replay
            is_b = q < 8
            qc = q.clamp(max=7)[None]
            s_at = torch.gather(sym, 0, qc)[0]
            vals[i // 4] |= torch.where(is_b, s_at, 0) << (24 - 8 * (i % 4))
            nb += is_b
            q = torch.where(is_b, q + torch.gather(ln, 0, qc)[0], q)
        nb = torch.where(torch.arange(p, device=dev) < plens[r], nb, 0)
        before = torch.cumsum(nb, 0) - nb
        under[r] = int(nb.sum()) < int(counts[r])
        allowed = torch.minimum((counts[r] - before).clamp(min=0), nb)
        n1 = allowed.clamp(max=4)
        n2 = (allowed - 4).clamp(min=0)
        packs[0, r] = vals[0] & _mask_top(n1)
        packs[1, r] = vals[1] & _mask_top(n2)
        packs[2, r] = 8 * n1
        packs[3, r] = 8 * n2
    packs = to_i32(packs)
    return (*interleave_packs(*packs), under)


def interleave_packs(val1, val2, len1, len2):
    """Four (B, P) pack arrays -> (vals, lens) each (B, 2P): lane 2j holds
    byte j's first pack, lane 2j + 1 its second, the layout K1's bits
    variant concatenates (shafa_tpu/kernels/decode.py:1444)."""
    b, p = val1.shape
    return (torch.stack([val1, val2], dim=2).reshape(b, 2 * p),
            torch.stack([len1, len2], dim=2).reshape(b, 2 * p))


def fsm32_packs_plain(planes, payload_lens, out_counts):
    """Plain version of fsm32_packs."""
    return fsm_packs_plain(planes, payload_lens, out_counts, 32)


def fsm32_packs(planes: torch.Tensor, payload_lens: torch.Tensor,
                out_counts: torch.Tensor):
    """K5 planes -> (vals, lens) each (B, 2P) int32, and the (B,) bool
    underrun flag: what shafa_tpu/kernels/decode.py::_stage2_chain_planes
    returns at s_states=32, interleaved as K1's bits variant reads it.

    Byte j of row r, entered in the boundary state of the 32-state machine,
    replays its up to 8 symbols; those below the row's count (out_counts)
    go MSB first into lane 2j (the first four) and lane 2j + 1 (the rest)
    of vals, with their bit counts in the same lanes of lens. Lanes past
    the row's payload length (payload_lens) are zero. Underrun: the payload
    holds fewer symbols than the count. On the card P must be a multiple of
    8 (the batches of the decode route are powers of two >= 1024).
    """
    if planes.device.type == "cpu":
        return fsm32_packs_plain(planes, payload_lens, out_counts)
    b = payload_lens.shape[0]
    p = planes.shape[1] // b
    if p % 8:
        raise ValueError(f"fsm32_packs: payload width {p} is not a multiple "
                         "of 8")
    dev = planes.device
    args = [_build.ptr(planes, torch.int32, (8, b * p), dev),
            _build.ptr(payload_lens, torch.int32, (b,), dev),
            _build.ptr(out_counts, torch.int32, (b,), dev)]
    lib = _build.library()
    n_tiles = -(-p // lib.shafa_fsm32_tile_bytes())
    scratch = [torch.empty((b, n_tiles, 4), dtype=torch.int64,
                           device=dev),                       # functions
               torch.empty((b, n_tiles), dtype=torch.int32,
                           device=dev),                       # entry states
               torch.empty(b * n_tiles + 1, dtype=torch.int64,
                           device=dev)]       # look-back words, the ticket
    vals = torch.empty((b, 2 * p), dtype=torch.int32, device=dev)
    lens = torch.empty((b, 2 * p), dtype=torch.int32, device=dev)
    under = torch.empty(b, dtype=torch.int32, device=dev)
    _build.launch("fsm32", dev, "shafa_fsm32", *args, b, p,
                  *[t.data_ptr() for t in scratch], vals.data_ptr(),
                  lens.data_ptr(), under.data_ptr())
    return vals, lens, under.bool()


def emit_packs(vals, lens, payload_lens, stride_words: int):
    """K7's or K6's interleaved packs -> (B, 4 * stride_words) uint8
    decoded rows: K1's bits variant over each row's 2 * payload_lens
    lanes."""
    return emit_bits_rows(vals, lens, 2 * payload_lens, stride_words)


def _rows_of_packs(vals, lens, under, payload_lens, out_p: int):
    """Interleaved packs -> ((B, out_p) uint8 decoded rows, underrun)."""
    rows = emit_packs(vals, lens, payload_lens, max(out_p, 512) // 4)
    return rows[:, :out_p].contiguous(), under


def decode_batch32(payload, payload_lens, pc32, ls, ncodes, lut, out_counts,
                   out_p: int):
    """(B, P) packed payloads -> ((B, out_p) uint8 decoded rows, underrun)
    for codes of 17-32 bits: K5, K6, K1 (K6's packs go to K1 as K6 lays
    them out). Tables from rank_tables32 and rank_lut12_32. Row r's symbols
    are out[r, :out_counts[r]]; the bytes after them are zero."""
    planes = rank_planes32(payload, payload_lens, pc32, ls, ncodes, lut)
    vals, lens, under = fsm32_packs(planes, payload_lens, out_counts)
    del planes
    return _rows_of_packs(vals, lens, under, payload_lens, out_p)


# -- the v4 chain: K7 ---------------------------------------------------------

def fsm_packs(planes: torch.Tensor, payload_lens: torch.Tensor,
              out_counts: torch.Tensor, s_states: int):
    """K2 planes -> (vals, lens) each (B, 2P) int32, and the (B,) bool
    underrun flag: what shafa_tpu/kernels/decode.py::_stage2_chain_ls
    returns, interleaved as K1's bits variant reads it (fsm32_packs'
    layout).

    fsm32_packs' contract on the 8- or 16-state machine (s_states >= the
    batch's longest code; code lengths `& 31`): byte j of row r replays its
    symbols; those below the row's count go MSB first into lane 2j (the
    first four) and lane 2j + 1 (the rest) of vals, with their bit counts in
    the same lanes of lens. Lanes past the row's payload are zero, where the
    TPU kernel leaves its tiles there unwritten. Underrun: the payload holds
    fewer symbols than the count. On the card P must be a multiple of 8.
    """
    if s_states not in (8, 16):
        raise ValueError("s_states must be 8 or 16")
    if planes.device.type == "cpu":
        return fsm_packs_plain(planes, payload_lens, out_counts, s_states)
    *args, scratch = _fsm16_args(planes, payload_lens, out_counts,
                                 "fsm_packs")
    b = payload_lens.shape[0]
    p = planes.shape[1] // b
    dev = planes.device
    vals = torch.empty((b, 2 * p), dtype=torch.int32, device=dev)
    lens = torch.empty((b, 2 * p), dtype=torch.int32, device=dev)
    under = torch.empty(b, dtype=torch.int32, device=dev)
    _build.launch("fsm_packs", dev, "shafa_fsm_packs", *args, s_states, b,
                  p, *[t.data_ptr() for t in scratch], vals.data_ptr(),
                  lens.data_ptr(), under.data_ptr())
    return vals, lens, under.bool()


def decode_batch_packs(payload, payload_lens, pc16, ls, lut12, out_counts,
                       out_p: int, s_states: int):
    """decode_batch through the v4 chain: K2, K7, K1 (_stage2_chain_ls then
    _emit_packs, decode.py:1389, :1444). Tables from rank_tables and
    rank_lut12 (codes <= 16 bits); returns what decode_batch returns."""
    planes = rank_planes(payload, pc16, ls, lut12)
    vals, lens, under = fsm_packs(planes, payload_lens, out_counts, s_states)
    del planes
    return _rows_of_packs(vals, lens, under, payload_lens, out_p)
