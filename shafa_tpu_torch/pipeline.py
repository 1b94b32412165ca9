"""Stage drivers: modules F, T, C, D — behavior-compatible with the reference.

Copy of the resident parts of shafa_tpu/pipeline.py (:33-320, :648-855,
:938-960). Each module reads/writes the sidecar formats of formats.py and
hands the "current path" forward exactly like the reference's path hand-off
protocol (shafa.c:135-142): F: file -> file.rle, C: x -> x.shaf, D: strips
extensions.

Compute is delegated to a backend (the NumPy oracle, or TorchBackend in
device.py) that operates on LISTS of blocks, so the device backend can batch
blocks into padded device tensors.

The streaming drivers of the original (inputs above STREAM_THRESHOLD) are
not ported yet: where the original branches to them, this module raises a
ShafaError that says so. The CLI refuses such inputs before that.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Protocol, Sequence

import numpy as np

from . import codes as codes_mod
from . import formats, geometry, oracle
from .errors import (FileInaccessibleError, FileTooSmallError,
                     FileUnrecognizableError, ShafaError)

#: RLE keep/skip gate: applied to block 0 only (f.c:250-257).
RLE_GATE_RATIO = 0.05

#: Streaming threshold of the original (shafa_tpu/pipeline.py:320): above
#: this input size it runs its bounded-memory drivers, which the port lacks.
STREAM_THRESHOLD = 256 << 20

STREAMING_NOT_PORTED = "streaming (> 256 MiB) is not yet ported"


class Backend(Protocol):
    """Per-stage block-batch compute. Code sets travel as codes.CodeTables
    (array-native; row i = block i) — never as per-block Python strings."""

    def rle_encode(self, blocks: Sequence[np.ndarray]) -> list[np.ndarray]: ...

    def histogram(self, blocks: Sequence[np.ndarray]) -> list[np.ndarray]: ...

    def pack(self, blocks: Sequence[np.ndarray],
             tables: "codes_mod.CodeTables") -> list[bytes]: ...

    def unpack(self, payloads: Sequence[bytes],
               tables: "codes_mod.CodeTables",
               out_counts: Sequence[int]) -> list[np.ndarray]: ...

    def rle_expand(self, blocks: Sequence[np.ndarray]) -> list[np.ndarray]: ...


class _AtomicFile:
    """Write-to-temp + rename: a failed run never leaves a partial output.

    The reference leaves partially-written files on any error (SURVEY.md
    §5.3: drivers close but never unlink, e.g. c.c:430-436); per-block
    independence makes clean restart cheap, so we improve on it — a
    documented deviation (docs/DEVIATIONS.md). The original's resume
    options serve its streaming drivers only and are left out."""

    def __init__(self, path: str):
        self.path = path
        self.tmp = path + ".shafa_tmp"
        self.fp = None

    def __enter__(self):
        self.fp = open(self.tmp, "wb")
        return self.fp

    def __exit__(self, et, ev, tb):
        self.fp.close()
        if et is None:
            os.replace(self.tmp, self.path)
        else:
            try:
                os.unlink(self.tmp)
            except OSError:
                pass
        return False


class CheckedBackend:
    """--check mode: every device stage cross-verified against the numpy
    oracle (SURVEY.md §5.2): guards against kernel/fallback divergence.

    Covers BOTH dispatch tiers: the per-stage methods and the fused
    device-resident chain (the path every real compress/decompress takes) —
    fused_* calls delegate to the inner backend and compare each accessor's
    results against the oracle run on the same blocks."""

    def __init__(self, inner: "Backend"):
        self.inner = inner
        self.oracle = NumpyBackend()
        self._fused_blocks: dict[int, list[np.ndarray]] = {}

    @property
    def supports_fused(self) -> bool:
        return getattr(self.inner, "supports_fused", False)

    def _cmp(self, stage, got, want):
        for i, (g, w) in enumerate(zip(got, want)):
            ga = g if isinstance(g, bytes) else np.asarray(g)
            wa = w if isinstance(w, bytes) else np.asarray(w)
            same = (ga == wa) if isinstance(ga, bytes) else \
                (ga.shape == wa.shape and bool((ga == wa).all()))
            if not same:
                raise AssertionError(
                    f"--check: {stage} mismatch vs oracle at block {i}")
        return got

    def rle_encode(self, blocks):
        return self._cmp("rle_encode", self.inner.rle_encode(blocks),
                         self.oracle.rle_encode(blocks))

    def histogram(self, blocks):
        return self._cmp("histogram", self.inner.histogram(blocks),
                         self.oracle.histogram(blocks))

    def pack(self, blocks, tables):
        return self._cmp("pack", self.inner.pack(blocks, tables),
                         self.oracle.pack(blocks, tables))

    def unpack(self, payloads, tables, out_counts):
        return self._cmp("unpack",
                         self.inner.unpack(payloads, tables, out_counts),
                         self.oracle.unpack(payloads, tables, out_counts))

    def rle_expand(self, blocks):
        return self._cmp("rle_expand", self.inner.rle_expand(blocks),
                         self.oracle.rle_expand(blocks))

    # -- fused tier (device.py TorchBackend protocol) ------------------------

    def fused_encode(self, blocks):
        h = self.inner.fused_encode(blocks)
        self._fused_blocks[id(h)] = list(blocks)
        return h

    def _oracle_rle(self, h):
        return self.oracle.rle_encode(self._fused_blocks[id(h)])

    def fused_rle_sizes(self, h):
        want = [b.size for b in self._oracle_rle(h)]
        got = self.inner.fused_rle_sizes(h)
        self._cmp("fused_rle_sizes", [np.asarray(list(got))],
                  [np.asarray(want)])
        return got

    def fused_rle_bytes(self, h):
        want = np.concatenate(self._oracle_rle(h)) \
            if self._fused_blocks[id(h)] else np.zeros(0, np.uint8)
        got = self.inner.fused_rle_bytes(h)
        self._cmp("fused_rle_bytes", [got], [want])
        return got

    def fused_rle_hists(self, h):
        want = np.stack(self.oracle.histogram(self._oracle_rle(h)))
        got = self.inner.fused_rle_hists(h)
        self._cmp("fused_rle_hists", [np.asarray(got)], [want])
        return got

    def fused_raw_hists(self, h):
        want = np.stack(self.oracle.histogram(self._fused_blocks[id(h)]))
        got = self.inner.fused_raw_hists(h)
        self._cmp("fused_raw_hists", [np.asarray(got)], [want])
        return got

    def fused_pack(self, h, tables, use_rle, host_row):
        streams = self._oracle_rle(h) if use_rle else \
            self._fused_blocks[id(h)]
        want = self.oracle.pack(streams, tables)
        return self._cmp("fused_pack",
                         self.inner.fused_pack(h, tables, use_rle, host_row),
                         want)

    def fused_decode(self, payloads, tables, out_counts, expand):
        dec = self.oracle.unpack(payloads, tables, out_counts)
        want = self.oracle.rle_expand(dec) if expand else dec
        return self._cmp(
            "fused_decode",
            self.inner.fused_decode(payloads, tables, out_counts, expand),
            want)


def host_unpack(payload, code_strings, out_count) -> np.ndarray:
    """oracle.unpack, its ValueError on a bad archive (no codes, a stream
    exhausted early) raised as FileUnrecognizableError, so that the CLI
    ends with "File not recognized" as on the kernel route."""
    try:
        return oracle.unpack(payload, code_strings, out_count)
    except ValueError as e:
        raise FileUnrecognizableError(str(e)) from e


class NumpyBackend:
    """Host backend / differential baseline; exact per oracle.py."""

    def rle_encode(self, blocks):
        return [oracle.rle_encode(b) for b in blocks]

    def histogram(self, blocks):
        return [oracle.histogram(b) for b in blocks]

    def pack(self, blocks, tables):
        out = []
        for i, b in enumerate(blocks):
            if i in tables.overflow:
                out.append(oracle.slow_pack(b.tobytes(),
                                            tables.row_strings(i)))
            else:
                out.append(oracle.pack(b, tables.lens[i], tables.vals[i]))
        return out

    def unpack(self, payloads, tables, out_counts):
        return [host_unpack(p, tables.row_strings(i), n)
                for i, (p, n) in enumerate(zip(payloads, out_counts))]

    def rle_expand(self, blocks):
        return [oracle.rle_expand(b) for b in blocks]


@dataclasses.dataclass
class StageReport:
    module: str
    n_blocks: int
    sizes_before: list[int]
    sizes_after: list[int]
    runtime_ms: float
    generated: list[str]
    extra: dict = dataclasses.field(default_factory=dict)


def _read_blocks(path: str, sizes: Sequence[int]) -> list[np.ndarray]:
    out = []
    with open(path, "rb") as fp:
        for s in sizes:
            buf = fp.read(s)
            if len(buf) != s:
                raise FileUnrecognizableError(f"{path}: truncated block")
            out.append(np.frombuffer(buf, np.uint8))
    return out


def _open_read(path: str) -> bytes:
    try:
        with open(path, "rb") as fp:
            return fp.read()
    except OSError as e:
        raise FileInaccessibleError(str(e)) from e


def _over_stream_threshold(path: str) -> bool:
    return os.path.isfile(path) and os.path.getsize(path) > STREAM_THRESHOLD


# ---------------------------------------------------------------------------
# Module F: RLE compression + frequency histograms (f.c:180-412)
# ---------------------------------------------------------------------------

def module_f(path: str, force_rle: bool, force_freq: bool, block_size: int,
             backend: Backend) -> tuple[str, StageReport]:
    t0 = time.perf_counter()
    if not os.path.isfile(path):
        raise FileInaccessibleError(path)
    geo = geometry.geometry_for_file(path, block_size)
    if geo.total < geometry.MIN_FILE_SIZE:
        raise FileTooSmallError(path)
    sizes = geo.sizes()
    blocks = _read_blocks(path, sizes)

    # Gate decision from block 0 only (f.c:250-257).
    rle0 = backend.rle_encode(blocks[:1])[0]
    ratio = (sizes[0] - rle0.size) / sizes[0]
    compress_rle = force_rle or ratio >= RLE_GATE_RATIO

    generated: list[str] = []
    rle_sizes: list[int] = []
    path_rle = formats.add_ext(path, formats.RLE_EXT)
    if compress_rle:
        rle_blocks = [rle0] + backend.rle_encode(blocks[1:])
        rle_sizes = [b.size for b in rle_blocks]
        freqs = backend.histogram(rle_blocks)
        with _AtomicFile(path_rle) as fp:
            for b in rle_blocks:
                fp.write(b.tobytes())
        path_rle_freq = formats.add_ext(path_rle, formats.FREQ_EXT)
        with _AtomicFile(path_rle_freq) as fp:
            formats.write_freq_arrays(fp, "R", rle_sizes, np.stack(freqs))
        generated += [path_rle, path_rle_freq]
    if force_freq or not compress_rle:
        freqs = backend.histogram(blocks)
        path_freq = formats.add_ext(path, formats.FREQ_EXT)
        with _AtomicFile(path_freq) as fp:
            formats.write_freq_arrays(fp, "N", sizes, np.stack(freqs))
        generated.append(path_freq)

    new_path = path_rle if compress_rle else path
    report = StageReport(
        module="f", n_blocks=geo.n_blocks, sizes_before=sizes,
        sizes_after=rle_sizes or sizes,
        runtime_ms=(time.perf_counter() - t0) * 1e3,
        generated=generated,
        extra={"compress_rle": compress_rle, "size_f": geo.total},
    )
    return new_path, report


# ---------------------------------------------------------------------------
# Fused F+T+C (device-resident; byte-identical to the sequential modules)
# ---------------------------------------------------------------------------

def compress_pipeline(path: str, force_rle: bool, force_freq: bool,
                      block_size: int, backend: Backend
                      ) -> tuple[str, list[StageReport]]:
    """Run modules F, T, C as one chain.

    With a fused-capable backend (TorchBackend) the raw and RLE streams stay
    device-resident across the whole chain: one upload of the input,
    compacted exact-size downloads of the .rle and .shaf payloads — the
    sidecar files written are byte-identical to running module_f, module_t,
    module_c in sequence (differential-tested). Other backends run exactly
    that sequence.

    Raised ShafaErrors carry a ``stage`` attribute ('f'|'t'|'c') so the CLI
    can print the reference's per-module diagnostics (shafa.c:159-199).
    """
    if not getattr(backend, "supports_fused", False):
        p, rf = module_f(path, force_rle, force_freq, block_size, backend)
        try:
            p, rt = module_t(p)
        except ShafaError as e:
            e.stage = "t"
            raise
        try:
            p, rc = module_c(p, backend)
        except ShafaError as e:
            e.stage = "c"
            raise
        return p, [rf, rt, rc]

    if _over_stream_threshold(path):
        raise ShafaError(STREAMING_NOT_PORTED)

    t0 = time.perf_counter()
    if not os.path.isfile(path):
        raise FileInaccessibleError(path)
    geo = geometry.geometry_for_file(path, block_size)
    if geo.total < geometry.MIN_FILE_SIZE:
        raise FileTooSmallError(path)
    sizes = geo.sizes()
    blocks = _read_blocks(path, sizes)

    handle = backend.fused_encode(blocks)
    rle_sizes = backend.fused_rle_sizes(handle)
    ratio = (sizes[0] - int(rle_sizes[0])) / sizes[0]
    compress_rle = force_rle or ratio >= RLE_GATE_RATIO

    generated: list[str] = []
    path_rle = formats.add_ext(path, formats.RLE_EXT)
    rle_flat = None
    rle_offs = None
    if compress_rle:
        rle_flat = backend.fused_rle_bytes(handle)
        rle_offs = np.concatenate(([0], np.cumsum(rle_sizes)))
        with _AtomicFile(path_rle) as fp:
            fp.write(rle_flat.tobytes())
        freqs = backend.fused_rle_hists(handle)
        path_rle_freq = formats.add_ext(path_rle, formats.FREQ_EXT)
        with _AtomicFile(path_rle_freq) as fp:
            formats.write_freq_arrays(fp, "R", rle_sizes, freqs)
        generated += [path_rle, path_rle_freq]
        mode, stream_sizes = "R", [int(s) for s in rle_sizes]
    if force_freq or not compress_rle:
        nfreqs = backend.fused_raw_hists(handle)
        path_freq = formats.add_ext(path, formats.FREQ_EXT)
        with _AtomicFile(path_freq) as fp:
            formats.write_freq_arrays(fp, "N", sizes, nfreqs)
        generated.append(path_freq)
        if not compress_rle:
            mode, stream_sizes, freqs = "N", list(sizes), nfreqs
    data_path = path_rle if compress_rle else path
    rep_f = StageReport(
        module="f", n_blocks=geo.n_blocks, sizes_before=sizes,
        sizes_after=stream_sizes,
        runtime_ms=(time.perf_counter() - t0) * 1e3, generated=generated,
        extra={"compress_rle": compress_rle, "size_f": geo.total})

    t1 = time.perf_counter()
    try:
        tables = codes_mod.build_code_tables(freqs)
        path_cod = formats.add_ext(data_path, formats.CODES_EXT)
        with _AtomicFile(path_cod) as fp:
            formats.write_cod_tables(fp, mode, stream_sizes, tables)
    except ShafaError as e:
        e.stage = "t"
        raise
    rep_t = StageReport(
        module="t", n_blocks=geo.n_blocks, sizes_before=stream_sizes,
        sizes_after=stream_sizes,
        runtime_ms=(time.perf_counter() - t1) * 1e3, generated=[path_cod])

    t2 = time.perf_counter()

    def host_row(i: int) -> np.ndarray:
        if compress_rle:
            return rle_flat[rle_offs[i]:rle_offs[i + 1]]
        return blocks[i]

    try:
        payloads = backend.fused_pack(handle, tables, compress_rle, host_row)
        path_shafa = formats.add_ext(data_path, formats.SHAFA_EXT)
        with _AtomicFile(path_shafa) as fp:
            formats.write_shaf_header(fp, geo.n_blocks)
            for p in payloads:
                formats.write_shaf_block(fp, p)
    except ShafaError as e:
        e.stage = "c"
        raise
    rep_c = StageReport(
        module="c", n_blocks=geo.n_blocks, sizes_before=stream_sizes,
        sizes_after=[len(p) for p in payloads],
        runtime_ms=(time.perf_counter() - t2) * 1e3, generated=[path_shafa])
    return path_shafa, [rep_f, rep_t, rep_c]


# ---------------------------------------------------------------------------
# Module T: Shannon-Fano code construction (t.c:246-445)
# ---------------------------------------------------------------------------

def module_t(path: str) -> tuple[str, StageReport]:
    t0 = time.perf_counter()
    mode, block_sizes, freqs = formats.parse_freq_arrays(
        _open_read(formats.add_ext(path, formats.FREQ_EXT)))
    tables = codes_mod.build_code_tables(freqs)
    path_cod = formats.add_ext(path, formats.CODES_EXT)
    with _AtomicFile(path_cod) as fp:
        formats.write_cod_tables(fp, mode, block_sizes, tables)
    report = StageReport(
        module="t", n_blocks=len(block_sizes), sizes_before=block_sizes,
        sizes_after=block_sizes,
        runtime_ms=(time.perf_counter() - t0) * 1e3,
        generated=[path_cod],
    )
    return path, report


# ---------------------------------------------------------------------------
# Module C: bit-pack encode (c.c:306-472)
# ---------------------------------------------------------------------------

def module_c(path: str, backend: Backend) -> tuple[str, StageReport]:
    t0 = time.perf_counter()
    _, block_sizes, tables = formats.parse_cod_tables(
        _open_read(formats.add_ext(path, formats.CODES_EXT)))
    if not os.path.isfile(path):
        raise FileInaccessibleError(path)
    blocks = _read_blocks(path, block_sizes)
    payloads = backend.pack(blocks, tables)
    path_shafa = formats.add_ext(path, formats.SHAFA_EXT)
    with _AtomicFile(path_shafa) as fp:
        formats.write_shaf_header(fp, len(block_sizes))
        for p in payloads:
            formats.write_shaf_block(fp, p)
    report = StageReport(
        module="c", n_blocks=len(block_sizes), sizes_before=block_sizes,
        sizes_after=[len(p) for p in payloads],
        runtime_ms=(time.perf_counter() - t0) * 1e3,
        generated=[path_shafa],
    )
    return path_shafa, report


# ---------------------------------------------------------------------------
# Module D: decode (d.c:628-834) and RLE-only decode (d.c:232-388)
# ---------------------------------------------------------------------------

def module_d_shafa(path: str, rle_decompression: bool,
                   backend: Backend) -> tuple[str, StageReport]:
    t0 = time.perf_counter()
    path_tmp = formats.rm_ext(path)  # strip .shaf
    path_wrt = formats.rm_ext(path_tmp) if rle_decompression else path_tmp
    mode, block_sizes, tables = formats.parse_cod_tables(
        _open_read(formats.add_ext(path_tmp, formats.CODES_EXT)))
    # Mode legality (d.c:678): N forbids the RLE path; R allows both.
    if not ((mode == "N" and not rle_decompression) or mode == "R"):
        raise FileUnrecognizableError(".cod mode vs decompression type")
    if (getattr(backend, "supports_fused", False)
            and _over_stream_threshold(path)):
        raise ShafaError(STREAMING_NOT_PORTED)
    payloads = formats.parse_shaf_frames(_open_read(path))
    if len(payloads) != len(block_sizes):
        raise FileUnrecognizableError("block count mismatch .shaf vs .cod")
    if getattr(backend, "supports_fused", False):
        out_blocks = backend.fused_decode(payloads, tables, block_sizes,
                                          expand=rle_decompression)
    else:
        decoded = backend.unpack(payloads, tables, block_sizes)
        if rle_decompression:
            out_blocks = backend.rle_expand(decoded)
        else:
            out_blocks = decoded
    with _AtomicFile(path_wrt) as fp:
        for b in out_blocks:
            fp.write(b.tobytes())
    report = StageReport(
        module="d", n_blocks=len(block_sizes),
        sizes_before=[len(p) for p in payloads],
        sizes_after=[b.size for b in out_blocks],
        runtime_ms=(time.perf_counter() - t0) * 1e3,
        generated=[path_wrt],
        extra={"algo": "shafa_rle" if rle_decompression else "shafa"},
    )
    return path_wrt, report


def module_d_rle(path: str, backend: Backend) -> tuple[str, StageReport]:
    t0 = time.perf_counter()
    freq = formats.parse_freq(_open_read(formats.add_ext(path, formats.FREQ_EXT)))
    if freq.mode != "R":
        raise FileUnrecognizableError(".freq mode must be R for RLE decode")
    path_wrt = formats.rm_ext(path)
    if _over_stream_threshold(path):
        raise ShafaError(STREAMING_NOT_PORTED)
    blocks = _read_blocks(path, freq.block_sizes)
    out_blocks = backend.rle_expand(blocks)
    with _AtomicFile(path_wrt) as fp:
        for b in out_blocks:
            fp.write(b.tobytes())
    report = StageReport(
        module="d", n_blocks=freq.n_blocks, sizes_before=freq.block_sizes,
        sizes_after=[b.size for b in out_blocks],
        runtime_ms=(time.perf_counter() - t0) * 1e3,
        generated=[path_wrt],
        extra={"algo": "rle"},
    )
    return path_wrt, report
