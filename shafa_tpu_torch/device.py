"""PyTorch device backend: block batching, padding, kernel dispatch, routing.

Port of shafa_tpu/device.py. Blocks of a file share one size (except the
last), so a file's blocks stack into a (B, P) tensor whose true lengths mask
all padding. The backend implements the pipeline's Backend protocol
(shafa_tpu/pipeline.py:36-52) and its fused tier, which keeps the raw and
RLE streams on the card across F -> C and downloads only exact-size byte
streams.

Routing as in the JAX backend: blocks whose codes exceed 32 bits, or whose
packed size could overflow int32 bit offsets, go to the NumPy oracle;
all-empty tables go to the oracle; tables that are not Kraft-complete go to
the trie-semantics slow decode. Decode splits at 16 bits of code width:
codes of at most 16 bits take K2 -> K3, codes of 17-32 bits K5 -> K6 -> K1.
The counter ``host_decoded_blocks`` (tracing.py) counts the blocks that
decode on the host by design.

Every copy between the host and the card goes through ``_upload`` or
``_download``, which count its bytes, whether the host side was pinned
(``h2d_*`` / ``d2h_*`` counters) and give it a span.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from . import codes as codes_mod
from . import oracle, tracing
from .errors import FileUnrecognizableError
from .kernels import decode as kdecode
from .kernels import emit as kemit
from .kernels import expand as kexpand
from .kernels import histogram as khist
from .kernels import ops as kops
from .kernels import pack as kpack
from .kernels import rle as krle
from .pipeline import host_unpack

#: Max elements per (B, P) batch (shafa_tpu/device.py:48).
MAX_BATCH_ELEMS = 1 << 26


class DeviceUnavailableError(RuntimeError):
    """The CUDA device the backend needs is missing."""


def default_device() -> torch.device:
    """CUDA, unless SHAFA_TORCH_DEVICE names another device (``cpu`` runs
    the plain versions of the kernels, as JAX_PLATFORMS=cpu does for the
    JAX package). Never drops to the CPU by itself."""
    name = os.environ.get("SHAFA_TORCH_DEVICE", "cuda")
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError("CUDA device not available")
    return dev


def _bucket(n: int, minimum: int = 256) -> int:
    """Next power-of-two bucket. Copy of shafa_tpu/device.py:55."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _row_bucket(n: int, cap: int) -> int:
    """Pad a row count to a power of two, capped. Copy of
    shafa_tpu/device.py:63."""
    return min(_bucket(max(n, 1), minimum=1), max(cap, 1))


def _kraft_complete(lens: np.ndarray) -> np.ndarray:
    """(n, 256) code bit lengths -> (n,) bool: Kraft sum exactly 1.

    Copy of shafa_tpu/device.py:73. The rank decoder assumes a complete
    code set; a hand-edited .cod with gaps goes to the trie-semantics
    decode, which fails loudly like the reference (d.c:534)."""
    ln = lens.astype(np.int64)
    present = ln > 0
    terms = np.where(present & (ln <= 32),
                     np.int64(1) << (32 - np.clip(ln, 1, 32)), 0)
    return (terms.sum(axis=1) == (np.int64(1) << 32)) \
        & (ln.max(axis=1, initial=0) <= 32)


def _slow_decode(payload, code_strings, out_count, expand: bool):
    """Trie-semantics decode for incomplete tables (shafa_tpu/device.py:90):
    fails loudly on a code gap or underrun like the reference."""
    try:
        dec = np.frombuffer(oracle.slow_unpack(payload, code_strings,
                                               out_count), np.uint8)
    except ValueError as e:
        raise FileUnrecognizableError(str(e)) from e
    return oracle.rle_expand(dec) if expand else dec


def _stack_blocks(blocks, b_rows: int | None = None, minimum: int = 256):
    """list of 1-D uint8 -> (B, P) padded + (B,) int32 lengths (host side).

    Copy of shafa_tpu/device.py:102: P is a power-of-two bucket; extra rows
    (b_rows) have length 0."""
    with tracing.span("shafa.backend.stack"):
        lens_l = [b.size for b in blocks]
        p = _bucket(max(lens_l) if blocks else 1, minimum=minimum)
        rows = b_rows if b_rows is not None else len(blocks)
        out = np.zeros((rows, p), dtype=np.uint8)
        lens = np.zeros(rows, dtype=np.int32)
        for i, b in enumerate(blocks):
            out[i, : b.size] = b
            lens[i] = b.size
        return out, lens


def _count_copy(way: str, host: torch.Tensor) -> None:
    """Count one copy (way "h2d" or "d2h") of the host tensor's bytes."""
    tracing.count(f"{way}_copies")
    tracing.count(f"{way}_bytes", host.nbytes)
    if not host.is_pinned():
        tracing.count(f"{way}_pageable_bytes", host.nbytes)


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on the device: the port's one host-to-device copy."""
    host = torch.from_numpy(np.ascontiguousarray(a))
    with tracing.span("shafa.backend.h2d"):
        out = host.to(device)
    _count_copy("h2d", host)
    return out


def _download(t: torch.Tensor) -> np.ndarray:
    """A device tensor on the host: the port's one device-to-host copy,
    which waits for the card's work on it."""
    with tracing.span("shafa.backend.d2h"):
        host = t.cpu()
    _count_copy("d2h", host)
    return host.numpy()


def _split_rows(flat: np.ndarray, sizes) -> list[np.ndarray]:
    """Split a compacted flat buffer into per-row views (no copies)."""
    out = []
    pos = 0
    for s in sizes:
        out.append(flat[pos:pos + int(s)])
        pos += int(s)
    return out


def download_packed(flat: torch.Tensor, woff, byte_lens) -> list[bytes]:
    """The rows of a packed word buffer (TorchBackend.pack_on_device), each
    row's exact bytes, after one download."""
    buf = _download(flat).view(np.uint8)
    return [buf[4 * int(w):4 * int(w) + int(n)].tobytes()
            for w, n in zip(woff, byte_lens)]


def _pad_rows(a: np.ndarray, rows: int, fill_row: int = -1) -> np.ndarray:
    """a with rows appended up to `rows`: zeros, or copies of a[fill_row]."""
    with tracing.span("shafa.backend.stack"):
        out = np.zeros((rows,) + a.shape[1:], a.dtype)
        out[: a.shape[0]] = a
        if fill_row >= 0 and rows > a.shape[0]:
            out[a.shape[0]:] = a[fill_row]
        return out


@dataclasses.dataclass
class DeviceTables:
    """Code tables on the device, rows = blocks of one batch.

    lut_len / lut_val feed K1's LUT variant: code lengths clipped to 32 and
    the u32 bits of the left-aligned codes, (n, 256) int32 each. pc16 / ls
    and lut12 feed K2 (kernels/decode.rank_tables, rank_lut12) and are
    built only on request."""
    lut_len: torch.Tensor
    lut_val: torch.Tensor
    pc16: torch.Tensor | None = None
    ls: torch.Tensor | None = None
    lut12: torch.Tensor | None = None


def tables_to_device(tables: codes_mod.CodeTables, device,
                     decode: bool = False) -> DeviceTables:
    """Host codes.CodeTables -> the port's device tensors: K1's LUTs and,
    with decode=True, K2/K3's tables (every row needs codes of 1-16 bits)."""
    cl = np.clip(tables.lens.astype(np.int32), 0, 32)
    cv = (tables.vals >> np.uint64(32)).astype(np.uint32).view(np.int32)
    out = DeviceTables(_upload(cl, device), _upload(cv, device))
    if decode:
        pc16, ls = kdecode.rank_tables(
            kdecode.decode_tables_batch(tables.lens, tables.vals))
        out.pc16 = _upload(pc16, device)
        out.ls = _upload(ls, device)
        out.lut12 = _upload(kdecode.rank_lut12(pc16, ls), device)
    return out


@dataclasses.dataclass
class DecodeBatch:
    """One decode batch on the card: its blocks' indices (its true rows),
    their payloads stacked (P a multiple of 1024), the payloads' lengths,
    the output counts (on the host too, padding rows 0), and the tables of
    its kernels: K2, K3 at s_states 8 or 16, K5, K6, K1 at 32."""
    blocks: list
    payload: torch.Tensor
    payload_lens: torch.Tensor
    counts: np.ndarray
    counts_dev: torch.Tensor
    out_p: int
    s_states: int
    tables: tuple


class _EncodeHandle:
    """Device-resident state of a fused encode: per-batch tensors."""

    def __init__(self):
        #: dicts: x, lens (host), lens_dev, enc, enc_len, hist, n (true rows)
        self.batches = []

    @property
    def n_blocks(self):
        return sum(b["n"] for b in self.batches)


class TorchBackend:
    """Device implementation of the pipeline Backend protocol.

    ``sequential`` (--no-multithread) runs one block per batch and turns the
    fused tier off, like shafa_tpu/device.py:207-215.
    """

    def __init__(self, device=None, sequential: bool = False):
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.sequential = bool(sequential)

    def _bsz(self, p: int) -> int:
        return 1 if self.sequential else max(1, MAX_BATCH_ELEMS // max(p, 1))

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return _upload(a, self.device)

    def _download_rows(self, rows: torch.Tensor, sizes) -> list[np.ndarray]:
        return _split_rows(_download(kops.compact_rows(rows, sizes)), sizes)

    # -- Backend protocol (per stage; one transfer each way per batch) ------

    def rle_encode(self, blocks):
        out = []
        h = self.fused_encode(blocks)
        for b in h.batches:
            out.extend(self._download_rows(b["enc"],
                                           self._enc_sizes(b)[: b["n"]]))
        return out

    def histogram(self, blocks):
        if not blocks:
            return []
        stacked, lens = _stack_blocks(blocks)
        bsz = self._bsz(stacked.shape[1])
        out = []
        for lo in range(0, len(blocks), bsz):
            h = khist.histogram_batch(self._upload(stacked[lo:lo + bsz]),
                                      self._upload(lens[lo:lo + bsz]))
            out.extend(_download(h))
        return out

    def pack(self, blocks, tables, hists=None):
        """blocks + codes.CodeTables (row i = block i's table) -> payloads;
        the payloads' sizes come from hists (row i = block i's histogram)
        where given, else from the blocks' histograms on the card."""
        results: list[bytes | None] = [None] * len(blocks)
        fast = []
        for i, blk in enumerate(blocks):
            if not self._pack_fallback(i, tables, lambda blk=blk: blk,
                                       blk.size, results):
                fast.append(i)
        if not fast:
            return results
        stacked, lens = _stack_blocks([blocks[i] for i in fast])
        bsz = self._bsz(stacked.shape[1])
        for lo in range(0, len(fast), bsz):
            with tracing.span("shafa.backend.pack_batch"):
                tracing.count("pack_batches")
                idx = fast[lo:lo + bsz]
                x = self._upload(stacked[lo:lo + len(idx)])
                ld = self._upload(lens[lo:lo + len(idx)])
                hist = (_download(khist.histogram_batch(x, ld))
                        if hists is None else np.asarray(hists)[idx])
                sub = codes_mod.CodeTables(tables.lens[idx],
                                           tables.vals[idx])
                for i, payload in zip(idx, self._pack_rows(x, ld, hist,
                                                           sub)):
                    results[i] = payload
        return results

    def unpack(self, payloads, tables, out_counts):
        return self._decode(payloads, tables, out_counts, expand=False)

    def rle_expand(self, blocks):
        if not blocks:
            return []
        stacked, lens = _stack_blocks(blocks)
        out = []
        bsz = self._bsz(stacked.shape[1])
        for lo in range(0, len(blocks), bsz):
            hi = min(lo + bsz, len(blocks))
            out.extend(self._expand_rows(self._upload(stacked[lo:hi]),
                                         self._upload(lens[lo:hi]), hi - lo))
        return out

    # -- shared pieces --------------------------------------------------------

    def _pack_fallback(self, i, tables, row, n_symbols, results) -> bool:
        """Route row i to the oracle (shafa_tpu/device.py:283-291) and
        return True, or return False for the kernel. row() gives the row's
        bytes."""
        maxlen = int(tables.lens[i].max())
        if i in tables.overflow:
            results[i] = oracle.slow_pack(row().tobytes(),
                                          tables.row_strings(i))
        elif maxlen > 32 or maxlen * int(n_symbols) >= (1 << 31) - 64:
            results[i] = oracle.pack(row(), tables.lens[i], tables.vals[i])
        else:
            return False
        return True

    def _pack_rows(self, x, lengths, hist, tables) -> list[bytes]:
        """K1 LUT pack of a batch; exact sizes from the stream histograms."""
        return download_packed(*self.pack_on_device(x, lengths, hist,
                                                    tables))

    def pack_on_device(self, x, lengths, hist, tables):
        """K1 LUT pack of a batch, left on the card: (the flat int32 word
        buffer, each row's word offset, each row's exact byte length)."""
        byte_lens = kpack.pack_byte_lens(
            hist, np.clip(tables.lens.astype(np.int32), 0, 32))
        dt = tables_to_device(tables, self.device)
        woff, need = kemit.aligned_offsets(byte_lens)
        flat = kpack.pack_batch(x, lengths, dt.lut_len, dt.lut_val,
                                self._upload(woff), need)
        return flat, woff, byte_lens

    def _expand_rows(self, x, lengths, n: int) -> list[np.ndarray]:
        """RLE-expand the first n rows of a device batch to host arrays:
        K4's sizes, their download, then K4's expansion of those n rows."""
        flat, sizes = self.expand_on_device(x, lengths, n)
        return _split_rows(_download(flat), sizes)

    @staticmethod
    def expand_on_device(x, lengths, n: int):
        """K4 on the first n rows of a device batch, left on the card: (their
        expansions back to back, each row's size on the host)."""
        dev_sizes = kexpand.rle_expand_sizes(x, lengths)
        sizes = _download(dev_sizes["out_len"])[:n]
        return kexpand.rle_expand(dev_sizes, int(sizes.sum())), sizes

    # -- fused device-resident tier (pipeline fast path) ---------------------

    @property
    def supports_fused(self) -> bool:
        return not self.sequential

    def fused_encode(self, blocks) -> _EncodeHandle:
        """Upload blocks once; the RLE streams and their histograms (K8) stay
        on the card."""
        return self.encode_on_device(self.upload_blocks(blocks))

    def upload_blocks(self, blocks) -> _EncodeHandle:
        """Blocks stacked into (B, P) batches on the card, no kernel run yet.
        Batches follow shafa_tpu/device.py:388-416."""
        h = _EncodeHandle()
        if not blocks:
            return h
        p = _bucket(max(b.size for b in blocks))
        bsz = self._bsz(p)
        for lo in range(0, len(blocks), bsz):
            rows = blocks[lo:lo + bsz]
            stacked, lens = _stack_blocks(rows,
                                          _row_bucket(len(rows), bsz))
            h.batches.append(dict(x=self._upload(stacked), lens=lens,
                                  lens_dev=self._upload(lens), n=len(rows)))
        return h

    @staticmethod
    def encode_on_device(uploaded: _EncodeHandle) -> _EncodeHandle:
        """The RLE streams of upload_blocks' batches and their histograms
        (K8), in a new handle (uploaded can be encoded again)."""
        h = _EncodeHandle()
        for b in uploaded.batches:
            with tracing.span("shafa.backend.encode_batch"):
                tracing.count("encode_batches")
                enc, enc_len, hist = krle.rle_encode_hist(b["x"],
                                                          b["lens_dev"])
            h.batches.append(dict(b, enc=enc, enc_len=enc_len, hist=hist))
        return h

    @staticmethod
    def _enc_sizes(b) -> np.ndarray:
        if "enc_sizes" not in b:
            b["enc_sizes"] = _download(b["enc_len"])
        return b["enc_sizes"]

    def fused_rle_hists(self, h: _EncodeHandle):
        """(n_blocks, 256) int64 histograms of the RLE streams."""
        return np.concatenate(
            [_download(b["hist"][: b["n"]]) for b in h.batches]
        ) if h.batches else np.zeros((0, 256), np.int64)

    def fused_raw_hists(self, h: _EncodeHandle):
        """Histograms of the raw blocks (N mode / -c f), cached per batch:
        the pack reuses them for exact packed sizes."""
        for b in h.batches:
            if "raw_hist" not in b:
                b["raw_hist"] = _download(khist.histogram_batch(
                    b["x"], b["lens_dev"]))
        return np.concatenate(
            [b["raw_hist"][: b["n"]] for b in h.batches]
        ) if h.batches else np.zeros((0, 256), np.int64)

    def fused_rle_sizes(self, h: _EncodeHandle) -> np.ndarray:
        return np.concatenate(
            [self._enc_sizes(b)[: b["n"]] for b in h.batches]
        ).astype(np.int64) if h.batches else np.zeros(0, np.int64)

    def fused_rle_bytes(self, h: _EncodeHandle) -> np.ndarray:
        """All RLE streams concatenated in block order (exact bytes)."""
        parts = [_download(kops.compact_rows(b["enc"],
                                             self._enc_sizes(b)[: b["n"]]))
                 for b in h.batches]
        return np.concatenate(parts) if parts else np.zeros(0, np.uint8)

    def fused_pack(self, h: _EncodeHandle, tables, use_rle: bool,
                   host_row) -> list[bytes]:
        """Bit-pack the device-resident streams (RLE or raw) with per-block
        code tables (K1 LUT variant); one download per batch.

        host_row(i) -> np.uint8 row i's stream bytes, used only for the rare
        oracle-routed rows (>32-bit codes / offset overflow)."""
        results: list[bytes | None] = [None] * h.n_blocks
        for base, n, args in self.fused_pack_batches(h, tables, use_rle,
                                                     host_row, results):
            for j, payload in enumerate(self._pack_rows(*args)[:n]):
                if results[base + j] is None:  # not routed to the oracle
                    results[base + j] = payload
        return results

    def fused_pack_batches(self, h: _EncodeHandle, tables, use_rle: bool,
                           host_row, results: list):
        """fused_pack's batches, one at a time: the rows routed to the
        oracle get their payloads in results; yields (first block, true
        rows, args) for each batch, where pack_on_device(*args) packs the
        other rows on the card. A batch's span stays open while the caller
        packs it."""
        base = 0
        if not use_rle:
            self.fused_raw_hists(h)  # ensure cached
        for b in h.batches:
            with tracing.span("shafa.backend.pack_batch"):
                tracing.count("pack_batches")
                n = b["n"]
                src = b["enc"] if use_rle else b["x"]
                src_len = (self._enc_sizes(b) if use_rle
                           else b["lens"]).copy()
                src_len[n:] = 0
                for j in range(n):
                    i = base + j
                    if self._pack_fallback(i, tables,
                                           lambda i=i: host_row(i),
                                           src_len[j], results):
                        src_len[j] = 0  # mask out of the kernel pass
                rows = src_len.shape[0]
                sel = list(range(base, base + n))
                sub = codes_mod.CodeTables(_pad_rows(tables.lens[sel], rows),
                                           _pad_rows(tables.vals[sel], rows))
                hist = (_download(b["hist"]) if use_rle
                        else b["raw_hist"]).copy()
                hist[src_len == 0] = 0  # padding and oracle-routed rows
                yield base, n, (src, self._upload(src_len.astype(np.int32)),
                                hist, sub)
            base += n

    def fused_decode(self, payloads, tables, out_counts,
                     expand: bool) -> list[np.ndarray]:
        """Device-resident D chain: decode (K2, K3 or K5, K6, K1) + optional
        RLE expand (K4), one exact-size download per batch."""
        return self._decode(payloads, tables, out_counts, expand)

    def _decode(self, payloads, tables, out_counts, expand):
        n_total = len(payloads)
        results: list[np.ndarray | None] = [None] * n_total
        maxlen = tables.lens.max(axis=1)
        n_codes = (tables.lens > 0).sum(axis=1)
        complete = _kraft_complete(tables.lens)
        fast16, fast32 = [], []
        on_host = 0
        for i in range(n_total):
            if i in tables.overflow or maxlen[i] > 32 or n_codes[i] == 0:
                on_host += 1
                dec = host_unpack(payloads[i], tables.row_strings(i),
                                  out_counts[i])
                results[i] = oracle.rle_expand(dec) if expand else dec
            elif not complete[i]:  # foreign .cod with gaps: trie semantics
                on_host += 1
                results[i] = _slow_decode(payloads[i], tables.row_strings(i),
                                          out_counts[i], expand)
            elif maxlen[i] <= 16:
                fast16.append(i)
            else:
                fast32.append(i)
        if on_host:
            tracing.count("host_decoded_blocks", on_host)
        if fast16:
            self._decode_group(payloads, tables, out_counts, expand, fast16,
                               results, wide=False)
        if fast32:
            self._decode_group(payloads, tables, out_counts, expand, fast32,
                               results, wide=True)
        return results

    def decode_batches(self, payloads, tables, out_counts, group,
                       wide: bool):
        """The blocks of group, whose codes have 17-32 bits if wide and at
        most 16 if not, in decode batches on the card with their tables, one
        batch at a time (shafa_tpu/device.py:602-672). A batch's span stays
        open while the caller decodes it."""
        blocks = [np.frombuffer(payloads[i], np.uint8) for i in group]
        p = _bucket(max(b.size for b in blocks), minimum=1024)
        bsz = self._bsz(p * 2)
        counts_all = np.array([out_counts[i] for i in group], np.int32)
        out_p = _bucket(int(counts_all.max()))
        for lo in range(0, len(group), bsz):
            with tracing.span("shafa.backend.decode_batch"):
                tracing.count("decode_batches")
                rows = blocks[lo:lo + bsz]
                nb = len(rows)
                b_rows = _row_bucket(nb, bsz)
                stacked, plens = _stack_blocks(rows, b_rows, minimum=1024)
                counts = _pad_rows(counts_all[lo:lo + nb], b_rows)
                sel = group[lo:lo + nb]
                # padding rows need a decodable table: copy the first row's
                sub = codes_mod.CodeTables(
                    _pad_rows(tables.lens[sel], b_rows, 0),
                    _pad_rows(tables.vals[sel], b_rows, 0))
                if wide:
                    pc32, ls, ncodes = kdecode.rank_tables32(
                        kdecode.decode_tables_batch(sub.lens, sub.vals))
                    lut = kdecode.rank_lut12_32(pc32, ls, ncodes)
                    tabs = tuple(map(self._upload, (pc32, ls, ncodes, lut)))
                    s_states = 32
                else:
                    dt = tables_to_device(sub, self.device, decode=True)
                    tabs = (dt.pc16, dt.ls, dt.lut12)
                    s_states = 8 if int(sub.lens.max()) <= 8 else 16
                yield DecodeBatch(sel, self._upload(stacked),
                                  self._upload(plens), counts,
                                  self._upload(counts), out_p, s_states, tabs)

    @staticmethod
    def decode_on_device(bt: DecodeBatch):
        """One decode batch on the card -> (rows, underrun): K2, K3 at 8 or
        16 states, K5, K6, K1 at 32."""
        if bt.s_states == 32:
            return kdecode.decode_batch32(bt.payload, bt.payload_lens,
                                          *bt.tables, bt.counts_dev, bt.out_p)
        return kdecode.decode_batch(bt.payload, bt.payload_lens, *bt.tables,
                                    bt.counts_dev, bt.out_p, bt.s_states)

    def _decode_group(self, payloads, tables, out_counts, expand, group,
                      results, wide: bool) -> None:
        """Decode blocks of one code width in batches, then K4 or a
        compaction."""
        for bt in self.decode_batches(payloads, tables, out_counts, group,
                                      wide):
            nb = len(bt.blocks)
            dec, under = self.decode_on_device(bt)
            if bool(_download(under[:nb].any())):
                raise FileUnrecognizableError(
                    "compressed stream exhausted early")
            if expand:
                out_rows = self._expand_rows(dec, bt.counts_dev, nb)
            else:
                out_rows = self._download_rows(dec, bt.counts[:nb])
            for j, row in enumerate(out_rows):
                results[bt.blocks[j]] = row
