"""PyTorch device backend: block batching, staging, kernel dispatch, routing.

Port of shafa_tpu/device.py. Blocks of a file share one size (except the
last), so a batch of a file's blocks is a (B, P) tensor on the card, B its
real rows and P a power of two (a multiple of 16, as the kernels need),
whose true lengths mask the bytes past each row. The backend implements the
pipeline's Backend protocol (shafa_tpu/pipeline.py:36-52) and its fused
tier, which keeps the raw and RLE streams on the card across F -> C and
downloads only exact-size byte streams.

Routing as in the JAX backend: blocks whose codes exceed 32 bits, or whose
packed size could overflow int32 bit offsets, go to the NumPy oracle;
all-empty tables go to the oracle; tables that are not Kraft-complete go to
the trie-semantics slow decode. Decode splits at 16 bits of code width:
codes of at most 16 bits take K2 -> K3, codes of 17-32 bits K5 -> K6 -> K1;
either route's tables are built on the card from the batch's code lengths
and codes (K9).
The counters ``decode_blocks16`` and ``decode_blocks32`` (tracing.py)
count the blocks each route decodes on the card, ``host_decoded_blocks``
those that decode on the host by design.

How copies are staged. Every copy between the host and the card goes
through ``_upload`` / ``_upload_rows`` or ``_download`` /
``_download_bytes``, which count its bytes, whether the host side was
pinned (``h2d_*`` / ``d2h_*`` counters) and give it a span. Each goes
through a host staging tensor (``_staging``), never zero-filled: on a
CUDA device it is pinned memory from PyTorch's caching host allocator, so
calls of one shape reuse the same resident pages and every copy is a
direct DMA. Only real bytes move: a batch's rows go up as runs of their
bytes (the bytes past each length are zeros on the card), and rows come
down joined on the card, in one copy a call.

Buffer lifetime: what a download returns (NumPy arrays, and memoryviews of
them from ``download_packed``) are views of the staging tensor, whose
storage they keep alive through the array's base. The allocator takes a
buffer back only when its last view is gone and the copies recorded on it
have completed, so no buffer is reused while a view of it lives.
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
from .kernels import pack as kpack
from .kernels import rle as krle

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


def batch_rows(width: int, factor: int = 1, minimum: int = 256) -> int:
    """Rows of a device batch whose widest row has width bytes:
    MAX_BATCH_ELEMS, read at call time, over the width's power-of-two
    bucket (at least minimum) times factor: 1 for blocks, 2 for a decode
    batch's payloads, 8 for a streaming decode's blocks (their decoded
    rows bound its width)."""
    return max(1, MAX_BATCH_ELEMS // (_bucket(width, minimum) * factor))


def batch_ranges(n: int, rows: int, lo: int = 0) -> list[tuple[int, int]]:
    """Items [lo, n) cut into ranges [a, b) of rows items, the last one
    shorter where they do not divide."""
    return [(a, min(a + rows, n)) for a in range(lo, n, rows)]


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


def _stack_blocks(blocks, minimum: int = 256):
    """list of 1-D uint8 -> (B, P) zero-padded host array + (B,) int32
    lengths, for callers that upload a batch themselves (the bench scripts,
    chip_smoke.py, tests). Copy of shafa_tpu/device.py:102: P is a
    power-of-two bucket."""
    lens = np.array([b.size for b in blocks], np.int32)
    p = _bucket(int(lens.max()) if blocks else 1, minimum=minimum)
    out = np.zeros((len(blocks), p), dtype=np.uint8)
    for i, b in enumerate(blocks):
        out[i, : b.size] = b
    return out, lens


def _staging(shape, dtype, device) -> torch.Tensor:
    """A host tensor, not initialised, that stages a copy to or from
    ``device``: pinned, from PyTorch's caching host allocator, where the
    device is CUDA."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=torch.device(device).type == "cuda")


def _wait(device) -> None:
    """Wait for the work queued on the device's current stream."""
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _count_copy(way: str, host: torch.Tensor, nbytes: int | None = None,
                copies: int = 1) -> None:
    """Count copies (way "h2d" or "d2h") of nbytes of the host tensor (all
    its bytes by default)."""
    nbytes = host.nbytes if nbytes is None else nbytes
    tracing.count(f"{way}_copies", copies)
    tracing.count(f"{way}_bytes", nbytes)
    if not host.is_pinned():
        tracing.count(f"{way}_pageable_bytes", nbytes)


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A small host array (lengths, tables, offsets) on the device, through
    a staging tensor: one copy, which returns when it is done."""
    src = torch.from_numpy(np.ascontiguousarray(a))
    host = _staging(src.shape, src.dtype, device)
    host.copy_(src)
    with tracing.span("shafa.backend.h2d"):
        out = host.to(device)
    _count_copy("h2d", host)
    return out


#: a run of whole rows goes up once it holds this many bytes, so the card
#: copies it while the host stages the next rows
RUN_BYTES = 1 << 22


def _upload_rows(rows, p: int, device):
    """1-D uint8 rows (each at most p bytes) -> their (len(rows), p) batch
    on the device, their int32 lengths on the host and on the device.

    Each row is copied into its row of one staging tensor. Only real bytes
    go up: rows that fill their width go up together as one copy (up to
    RUN_BYTES, or up to and with the next row that does not), so the card
    copies while the host stages the next rows. Where a row is shorter
    than p, the batch is zeroed on the card first, by one memset, so the
    bytes past each length are zeros: the card writes a memset far faster
    than the copies bring the rows, and faster than a mask of the pads
    alone (arange, compare, masked_fill) is built and applied. It returns
    when the copies are done, so the staging tensor is free again for the
    next batch."""
    lens = np.array([r.size for r in rows], np.int32)
    host = _staging((len(rows), p), torch.uint8, device)
    staged, src = host.numpy(), host.view(-1)
    x = (torch.zeros if (lens < p).any() else torch.empty)(
        (len(rows), p), dtype=torch.uint8, device=device)
    dst = x.view(-1)
    lo = copies = 0  # lo: the first byte not yet sent
    for i, r in enumerate(rows):
        with tracing.span("shafa.backend.stack"):
            staged[i, :r.size] = r
        hi = i * p + r.size
        if r.size < p or hi - lo >= RUN_BYTES or i == len(rows) - 1:
            if hi > lo:
                with tracing.span("shafa.backend.h2d"):
                    dst[lo:hi].copy_(src[lo:hi], non_blocking=True)
                copies += 1
            lo = (i + 1) * p
    _count_copy("h2d", host, int(lens.sum()), copies)
    with tracing.span("shafa.backend.h2d"):
        _wait(x.device)
    return x, lens, _upload(lens, device)


def _download(t: torch.Tensor) -> np.ndarray:
    """A device tensor on the host, through a staging tensor: one copy,
    which waits for the card's work on it."""
    host = _staging(t.shape, t.dtype, t.device)
    with tracing.span("shafa.backend.d2h"):
        host.copy_(t)
    _count_copy("d2h", host)
    return host.numpy()


def _row_heads(rows: torch.Tensor, sizes) -> list[torch.Tensor]:
    """Row i's first sizes[i] bytes, for each row of a (B, W) uint8 device
    tensor, as views that one call makes."""
    w = rows.shape[1]
    cuts = [c for s in sizes for c in (int(s), w - int(s))]
    return list(rows[:len(sizes)].reshape(-1).split(cuts)[::2])


def _download_bytes(parts) -> np.ndarray:
    """1-D uint8 tensors of one device -> their bytes back to back in one
    host array: joined on the device (one torch.cat), then one copy. A
    copy a part would cost some microseconds of the host each, which
    thousands of rows add up to."""
    if not parts:
        return np.zeros(0, np.uint8)
    return _download(torch.cat(parts) if len(parts) > 1 else parts[0])


def _split_rows(flat: np.ndarray, sizes) -> list[np.ndarray]:
    """Split a flat buffer of rows back to back into per-row views (no
    copies)."""
    out = []
    pos = 0
    for s in sizes:
        out.append(flat[pos:pos + int(s)])
        pos += int(s)
    return out


def download_packed(flat: torch.Tensor, woff, byte_lens) -> list[memoryview]:
    """The rows of a packed word buffer (TorchBackend.pack_on_device), each
    row's exact bytes as a memoryview of one host buffer: the rows' span
    comes down in one copy (the gaps between rows are under 512 bytes
    each), and no row is copied again on the host."""
    if not len(woff):
        return []
    end = 4 * int(woff[-1]) + int(byte_lens[-1])
    buf = _download(flat.view(torch.uint8)[:end])
    return [memoryview(buf[4 * int(w):4 * int(w) + int(n)])
            for w, n in zip(woff, byte_lens)]


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


def _code_hi32(tables: codes_mod.CodeTables) -> np.ndarray:
    """The high 32 bits of the left-aligned codes, (n, 256) int32: the
    whole code where it has at most 32 bits."""
    return (tables.vals >> np.uint64(32)).astype(np.uint32).view(np.int32)


def decode_tables_to_device(tables: codes_mod.CodeTables, device,
                            wide: bool) -> tuple:
    """A decode batch's code tables -> its rank kernel's tables on the
    device (kernels/decode.decode_tables_on_device): the code lengths and
    codes go up, and K9 builds the tables there (on the CPU, their plain
    version). Every row needs codes of 1-32 bits, of 1-16 if not wide."""
    return kdecode.decode_tables_on_device(
        _upload(tables.lens, device), _upload(_code_hi32(tables), device),
        wide)


def tables_to_device(tables: codes_mod.CodeTables, device,
                     decode: bool = False) -> DeviceTables:
    """Host codes.CodeTables -> the port's device tensors: K1's LUTs and,
    with decode=True, K2/K3's tables (every row needs codes of 1-16 bits)."""
    cl = np.clip(tables.lens.astype(np.int32), 0, 32)
    out = DeviceTables(_upload(cl, device),
                       _upload(_code_hi32(tables), device))
    if decode:
        out.pc16, out.ls, out.lut12 = decode_tables_to_device(
            tables, device, wide=False)
    return out


@dataclasses.dataclass
class DecodeBatch:
    """One decode batch on the card: its blocks' indices (one row each),
    their payloads stacked (P a power of two of at least 1024), the
    payloads' lengths, the output counts (on the host too), and the tables
    of its kernels: K2, K3 at s_states 8 or 16, K5, K6, K1 at 32."""
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
        #: dicts: x, lens (host), lens_dev, enc, enc_len, hist
        self.batches = []

    @property
    def n_blocks(self):
        return sum(len(b["lens"]) for b in self.batches)


class TorchBackend:
    """Device implementation of the pipeline Backend protocol.

    ``sequential`` (--no-multithread) runs one block per batch and turns the
    fused tier off, like shafa_tpu/device.py:207-215.
    """

    def __init__(self, device=None, sequential: bool = False):
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.sequential = bool(sequential)

    def _batches(self, widths, factor: int = 1, minimum: int = 256):
        """Rows of these widths in device batches: the batches' width P
        (the widest row's bucket) and their [lo, hi) ranges, of batch_rows
        rows each (one if sequential)."""
        p = _bucket(max(widths), minimum)
        rows = 1 if self.sequential else batch_rows(p, factor, minimum)
        return p, batch_ranges(len(widths), rows)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return _upload(a, self.device)

    def _download_rows(self, rows: torch.Tensor, sizes) -> list[np.ndarray]:
        """Row i's first sizes[i] bytes, for each row, as host arrays."""
        return _split_rows(_download_bytes(_row_heads(rows, sizes)), sizes)

    # -- Backend protocol (per stage; one transfer each way per batch) ------

    def rle_encode(self, blocks):
        out = []
        h = self.fused_encode(blocks)
        for b in h.batches:
            out.extend(self._download_rows(b["enc"], self._enc_sizes(b)))
        return out

    def histogram(self, blocks):
        if not blocks:
            return []
        p, batches = self._batches([b.size for b in blocks])
        out = []
        for lo, hi in batches:
            x, _, ld = _upload_rows(blocks[lo:hi], p, self.device)
            out.extend(_download(khist.histogram_batch(x, ld)))
        return out

    def pack(self, blocks, tables, hists=None):
        """blocks + codes.CodeTables (row i = block i's table) -> payloads;
        the payloads' sizes come from hists (row i = block i's histogram)
        where given, else from the blocks' histograms on the card."""
        results: list[bytes | memoryview | None] = [None] * len(blocks)
        fast = []
        for i, blk in enumerate(blocks):
            if not self._pack_fallback(i, tables, lambda blk=blk: blk,
                                       blk.size, results):
                fast.append(i)
        if not fast:
            return results
        p, batches = self._batches([blocks[i].size for i in fast])
        for lo, hi in batches:
            with tracing.span("shafa.backend.pack_batch"):
                tracing.count("pack_batches")
                idx = fast[lo:hi]
                x, _, ld = _upload_rows([blocks[i] for i in idx], p,
                                        self.device)
                hist = (_download(khist.histogram_batch(x, ld))
                        if hists is None else np.asarray(hists)[idx])
                for i, payload in zip(idx, self._pack_rows(
                        x, ld, hist, codes_mod.take_rows(tables, idx))):
                    results[i] = payload
        return results

    def unpack(self, payloads, tables, out_counts):
        return self._decode(payloads, tables, out_counts, expand=False)

    def rle_expand(self, blocks):
        if not blocks:
            return []
        p, batches = self._batches([b.size for b in blocks])
        out = []
        for lo, hi in batches:
            x, _, ld = _upload_rows(blocks[lo:hi], p, self.device)
            out.extend(self._expand_rows(x, ld, hi - lo))
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

    def _pack_rows(self, x, lengths, hist, tables) -> list[memoryview]:
        """K1 LUT pack of a batch; exact sizes from the stream histograms."""
        return download_packed(*self.pack_on_device(x, lengths, hist,
                                                    tables))

    def pack_on_device(self, x, lengths, hist, tables):
        """K1 LUT pack of a batch, left on the card: (the flat int32 word
        buffer, each row's word offset, each row's exact byte length)."""
        with tracing.span("shafa.backend.tables"):
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
        p, batches = self._batches([b.size for b in blocks])
        for lo, hi in batches:
            x, lens, ld = _upload_rows(blocks[lo:hi], p, self.device)
            h.batches.append(dict(x=x, lens=lens, lens_dev=ld))
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
            [_download(b["hist"]) for b in h.batches]
        ) if h.batches else np.zeros((0, 256), np.int64)

    def fused_raw_hists(self, h: _EncodeHandle):
        """Histograms of the raw blocks (N mode / -c f), cached per batch:
        the pack reuses them for exact packed sizes."""
        for b in h.batches:
            if "raw_hist" not in b:
                b["raw_hist"] = _download(khist.histogram_batch(
                    b["x"], b["lens_dev"]))
        return np.concatenate(
            [b["raw_hist"] for b in h.batches]
        ) if h.batches else np.zeros((0, 256), np.int64)

    def fused_rle_sizes(self, h: _EncodeHandle) -> np.ndarray:
        return np.concatenate(
            [self._enc_sizes(b) for b in h.batches]
        ).astype(np.int64) if h.batches else np.zeros(0, np.int64)

    def fused_rle_bytes(self, h: _EncodeHandle) -> np.ndarray:
        """All RLE streams concatenated in block order (exact bytes), in one
        host buffer."""
        return _download_bytes([t for b in h.batches for t in
                                _row_heads(b["enc"], self._enc_sizes(b))])

    def fused_pack(self, h: _EncodeHandle, tables, use_rle: bool,
                   host_row) -> list[bytes | memoryview]:
        """Bit-pack the device-resident streams (RLE or raw) with per-block
        code tables (K1 LUT variant); one download per batch.

        host_row(i) -> np.uint8 row i's stream bytes, used only for the rare
        oracle-routed rows (>32-bit codes / offset overflow)."""
        results: list[bytes | memoryview | None] = [None] * h.n_blocks
        for base, args in self.fused_pack_batches(h, tables, use_rle,
                                                  host_row, results):
            for j, payload in enumerate(self._pack_rows(*args)):
                if results[base + j] is None:  # not routed to the oracle
                    results[base + j] = payload
        return results

    def fused_pack_batches(self, h: _EncodeHandle, tables, use_rle: bool,
                           host_row, results: list):
        """fused_pack's batches, one at a time: the rows routed to the
        oracle get their payloads in results; yields (first block, args)
        for each batch, where pack_on_device(*args) packs the other rows
        on the card. A batch's span stays open while the caller
        packs it."""
        base = 0
        if not use_rle:
            self.fused_raw_hists(h)  # ensure cached
        for b in h.batches:
            with tracing.span("shafa.backend.pack_batch"):
                tracing.count("pack_batches")
                n = len(b["lens"])
                src = b["enc"] if use_rle else b["x"]
                src_len = (self._enc_sizes(b) if use_rle
                           else b["lens"]).astype(np.int32)
                for j in range(n):
                    i = base + j
                    if self._pack_fallback(i, tables,
                                           lambda i=i: host_row(i),
                                           src_len[j], results):
                        src_len[j] = 0  # mask out of the kernel pass
                hist = (_download(b["hist"]) if use_rle
                        else b["raw_hist"]).copy()
                hist[src_len == 0] = 0  # oracle-routed rows
                yield base, (src, self._upload(src_len), hist,
                             codes_mod.take_rows(tables, base, base + n))
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
                dec = oracle.host_unpack(payloads[i],
                                         tables.row_strings(i), out_counts[i])
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
        batch at a time (shafa_tpu/device.py:602-672). A batch's span
        (``shafa.backend.decode_batch``, ``.decode_batch32`` if wide) stays
        open while the caller decodes it; ``shafa.backend.tables`` covers
        the upload of its code tables and the launch that builds its
        kernels' tables from them on the card (K9)."""
        blocks = [np.frombuffer(payloads[i], np.uint8) for i in group]
        p, batches = self._batches([b.size for b in blocks], 2, 1024)
        counts_all = np.array([out_counts[i] for i in group], np.int32)
        out_p = _bucket(int(counts_all.max()))
        span = ("shafa.backend.decode_batch32" if wide
                else "shafa.backend.decode_batch")
        routed = "decode_blocks32" if wide else "decode_blocks16"
        for lo, hi in batches:
            with tracing.span(span):
                tracing.count("decode_batches")
                sel = group[lo:hi]
                tracing.count(routed, len(sel))
                payload, _, plens = _upload_rows(blocks[lo:hi], p,
                                                 self.device)
                counts = counts_all[lo:hi]
                sub = codes_mod.take_rows(tables, sel)
                with tracing.span("shafa.backend.tables"):
                    tabs = decode_tables_to_device(sub, self.device, wide)
                s_states = (32 if wide else
                            8 if int(sub.lens.max()) <= 8 else 16)
                yield DecodeBatch(sel, payload, plens, counts,
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
        """Decode blocks of one code width in batches, then K4 or each
        row's exact bytes downloaded."""
        for bt in self.decode_batches(payloads, tables, out_counts, group,
                                      wide):
            dec, under = self.decode_on_device(bt)
            if bool(_download(under.any())):
                raise FileUnrecognizableError(
                    "compressed stream exhausted early")
            if expand:
                out_rows = self._expand_rows(dec, bt.counts_dev,
                                             len(bt.blocks))
            else:
                out_rows = self._download_rows(dec, bt.counts)
            for j, row in enumerate(out_rows):
                results[bt.blocks[j]] = row
