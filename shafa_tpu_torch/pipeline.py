"""Stage drivers: modules F, T, C, D — behavior-compatible with the reference.

Copy of shafa_tpu/pipeline.py without its get_backend (the CLI builds the
backend). Each module reads/writes the sidecar formats of formats.py and
hands the "current path" forward exactly like the reference's path hand-off
protocol (shafa.c:135-142): F: file -> file.rle, C: x -> x.shaf, D: strips
extensions.

Compute is delegated to a backend (the NumPy oracle, or TorchBackend in
device.py) that operates on LISTS of blocks, so the device backend can batch
blocks into padded device tensors.

The drivers differ only in where the streams live: on the card for the
whole file (``compress_pipeline``, ``module_d_shafa``), one device batch at
a time (inputs above STREAM_THRESHOLD, as in the original), module by
module (``module_f`` -> ``module_t`` -> ``module_c``), or one block range
per process (``compress_multihost``, ``decompress_multihost``, over
multihost.py's process group). Each step they share is written once here:
the RLE gate (``_rle_gate``), the .freq sidecars (``_freq_step``), module T
(``_t_step``), the block reader (``_read_blocks``), the writers
(``_write_file``, ``_write_rows``, ``_write_shaf``), the writer thread
(``_WriteBehind``), the stage's span and error tag (``_stage``), and the
streaming loop (``_stream``): a read-ahead and a write-behind thread that
do file IO only (every backend call stays on the calling thread), around
a compress that resumes after the last batch written durably. The
resident compress writes its ``.rle`` behind modules T and C on the same
kind of writer thread. Device batches are cut by device.batch_rows.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import dataclasses
import os
import tempfile
import time
import zipfile
from typing import Protocol, Sequence

import numpy as np

from . import codes as codes_mod
from . import formats, geometry, oracle, tracing
from .errors import (FileInaccessibleError, FileTooSmallError,
                     FileUnrecognizableError, ShafaError)

#: RLE keep/skip gate: applied to block 0 only (f.c:250-257).
RLE_GATE_RATIO = 0.05

#: The resident compress hands its .rle to the OS in writes of at most
#: this many bytes. On the H100 machine of PERF.md §6 (a 9p root file
#: system) a write holds up the process's other threads while it copies
#: its buffer, so one write of the whole .rle stalls module T, which runs
#: beside it: T took 4.7 ms alone, 33 ms beside a 90 MB write and 8 ms
#: beside the same bytes in writes of 512 KiB.
WRITE_SLICE = 1 << 19

#: Streaming threshold (shafa_tpu/pipeline.py:320): above this input size
#: the fused pipeline and the decoders process the file one device batch at
#: a time with bounded host and device memory (two data passes) instead of
#: keeping every stream device-resident. Read through the module at call
#: time, so that tests can lower it.
STREAM_THRESHOLD = int(os.environ.get("SHAFA_STREAM_THRESHOLD", 256 << 20))


class Backend(Protocol):
    """Per-stage block-batch compute. Code sets travel as codes.CodeTables
    (array-native; row i = block i) — never as per-block Python strings."""

    def rle_encode(self, blocks: Sequence[np.ndarray]) -> list[np.ndarray]: ...

    def histogram(self, blocks: Sequence[np.ndarray]) -> list[np.ndarray]: ...

    def pack(self, blocks: Sequence[np.ndarray],
             tables: "codes_mod.CodeTables",
             hists: np.ndarray | None = None) -> list[bytes | memoryview]:
        """hists: the blocks' (n, 256) histograms where the caller has
        them (the streaming drivers' .freq rows), so that a backend need
        not count the blocks again for the payloads' sizes. A payload is
        bytes, or a memoryview of the host buffer it was downloaded to."""

    def unpack(self, payloads: Sequence[bytes],
               tables: "codes_mod.CodeTables",
               out_counts: Sequence[int]) -> list[np.ndarray]: ...

    def rle_expand(self, blocks: Sequence[np.ndarray]) -> list[np.ndarray]: ...


class _AtomicFile:
    """Write-to-temp + rename: a failed run never leaves a partial output.

    The reference leaves partially-written files on any error (SURVEY.md
    §5.3: drivers close but never unlink, e.g. c.c:430-436); per-block
    independence makes clean restart cheap, so we improve on it — a
    documented deviation (docs/DEVIATIONS.md). Copy of
    shafa_tpu/pipeline.py:54-92.

    ``keep_on_error`` (the streaming pipelines' restart mode) retains the
    temp file on failure so a later run can resume it; ``resume_at`` opens
    the existing temp and truncates to the last durable offset. What a
    successful opening wrote counts in ``file_written_bytes``."""

    def __init__(self, path: str, keep_on_error: bool = False,
                 resume_at: int | None = None):
        self.path = path
        self.tmp = path + ".shafa_tmp"
        self.keep_on_error = keep_on_error
        self.resume_at = resume_at
        self.fp = None
        self._start = 0

    def __enter__(self):
        if self.resume_at is not None and os.path.isfile(self.tmp):
            self.fp = open(self.tmp, "r+b")
            self.fp.truncate(self.resume_at)
            self.fp.seek(self.resume_at)
        else:
            self.fp = open(self.tmp, "wb")
        self._start = self.fp.tell()
        return self.fp

    def __exit__(self, et, ev, tb):
        if et is None:
            tracing.count("file_written_bytes", self.fp.tell() - self._start)
        self.fp.close()
        if et is None:
            os.replace(self.tmp, self.path)
        elif not self.keep_on_error:
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

    @staticmethod
    def _as_array(x) -> np.ndarray:
        """A result as an array: a payload (bytes, or a memoryview of a
        host buffer) as its bytes."""
        if isinstance(x, (bytes, bytearray, memoryview)):
            return np.frombuffer(x, np.uint8)
        return np.asarray(x)

    def _cmp(self, stage, got, want):
        for i, (g, w) in enumerate(zip(got, want)):
            ga, wa = self._as_array(g), self._as_array(w)
            if not (ga.shape == wa.shape and bool((ga == wa).all())):
                raise AssertionError(
                    f"--check: {stage} mismatch vs oracle at block {i}")
        return got

    def rle_encode(self, blocks):
        return self._cmp("rle_encode", self.inner.rle_encode(blocks),
                         self.oracle.rle_encode(blocks))

    def histogram(self, blocks):
        return self._cmp("histogram", self.inner.histogram(blocks),
                         self.oracle.histogram(blocks))

    def pack(self, blocks, tables, hists=None):
        return self._cmp("pack", self.inner.pack(blocks, tables, hists),
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


class NumpyBackend:
    """Host backend / differential baseline; exact per oracle.py."""

    def rle_encode(self, blocks):
        return [oracle.rle_encode(b) for b in blocks]

    def histogram(self, blocks):
        return [oracle.histogram(b) for b in blocks]

    def pack(self, blocks, tables, hists=None):
        out = []
        for i, b in enumerate(blocks):
            if i in tables.overflow:
                out.append(oracle.slow_pack(b.tobytes(),
                                            tables.row_strings(i)))
            else:
                out.append(oracle.pack(b, tables.lens[i], tables.vals[i]))
        return out

    def unpack(self, payloads, tables, out_counts):
        return [oracle.host_unpack(p, tables.row_strings(i), n)
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


def _report(module: str, t0: float, sizes_before, sizes_after,
            generated: list[str], **extra) -> StageReport:
    """A stage's report, one size a block, its runtime from t0 to now."""
    return StageReport(module, len(sizes_before), sizes_before, sizes_after,
                       (time.perf_counter() - t0) * 1e3, generated, extra)


@contextlib.contextmanager
def _stage(name: str):
    """Module name's span (``shafa.pipeline.<name>``); a ShafaError raised
    in it carries ``stage`` = name, from which the CLI prints the
    reference's per-module diagnostic (shafa.c:159-199). Also a decorator."""
    with tracing.span(f"shafa.pipeline.{name}"):
        try:
            yield
        except ShafaError as e:
            e.stage = name
            raise


def _read_blocks(fp, sizes: Sequence[int], lo: int = 0,
                 hi: int | None = None) -> list[np.ndarray]:
    """Blocks [lo, hi) (all by default) of an open data stream whose blocks
    have these sizes, one read a block; a short read raises
    FileUnrecognizableError. The caller's ``shafa.io.read.<kind>`` span
    covers it (in the streaming loop, its reader's)."""
    fp.seek(sum(sizes[:lo]))
    out = []
    for s in sizes[lo:hi]:
        buf = fp.read(s)
        if len(buf) != s:
            raise FileUnrecognizableError(f"{fp.name}: truncated block")
        out.append(np.frombuffer(buf, np.uint8))
    tracing.count("file_read_bytes", sum(sizes[lo:hi]))
    return out


def _open_read(path: str, kind: str) -> bytes:
    """A whole sidecar (kind: freq, cod or shaf)."""
    try:
        with tracing.span(f"shafa.io.read.{kind}"), open(path, "rb") as fp:
            data = fp.read()
    except OSError as e:
        raise FileInaccessibleError(str(e)) from e
    tracing.count("file_read_bytes", len(data))
    return data


def _write_atomic(path: str, write, *args) -> None:
    """write(fp, *args) into path, whole or not at all (_AtomicFile)."""
    with _AtomicFile(path) as fp:
        write(fp, *args)


def _write_file(path: str, kind: str, write, *args) -> None:
    """_write_atomic in the span ``shafa.io.write.<kind>``."""
    with tracing.span(f"shafa.io.write.{kind}"):
        _write_atomic(path, write, *args)


def _write_rows(fp, rows) -> None:
    """uint8 rows back to back: a .rle, a restored file. Each row is
    written from its own buffer, with no copy (a large write releases the
    GIL for its syscall); only a row that is not C-contiguous is made
    into one first."""
    for r in rows:
        fp.write(np.ascontiguousarray(r))


def _write_shaf(fp, payloads, n_blocks: int | None = None) -> None:
    """.shaf frames, after the archive's header where n_blocks is given."""
    if n_blocks is not None:
        formats.write_shaf_header(fp, n_blocks)
    for p in payloads:
        formats.write_shaf_block(fp, p)


def _data_kind(path: str) -> str:
    """The io span kind of a data stream: rle or input."""
    return "rle" if formats.check_ext(path, formats.RLE_EXT) else "input"


def _over_stream_threshold(path: str) -> bool:
    return os.path.isfile(path) and os.path.getsize(path) > STREAM_THRESHOLD


def _input_geometry(path: str, block_size: int) -> geometry.BlockGeometry:
    """Module F's input, checked as f.c:205-221 does, as blocks."""
    if not os.path.isfile(path):
        raise FileInaccessibleError(path)
    geo = geometry.geometry_for_file(path, block_size)
    if geo.total < geometry.MIN_FILE_SIZE:
        raise FileTooSmallError(path)
    return geo


def _batches(n: int, width: int, factor: int = 1, lo: int = 0):
    """Blocks [lo, n) in device batches (device.batch_rows) of rows of at
    most width bytes: factor 1 to encode, 8 for a streaming decode, whose
    decoded rows bound the batch's width."""
    from . import device  # torch only where a device backend runs
    return device.batch_ranges(n, device.batch_rows(width, factor), lo)


# ---------------------------------------------------------------------------
# The steps of modules F and T (f.c:180-412, t.c:246-445)
# ---------------------------------------------------------------------------

def _rle_gate(size0: int, rle_size0: int, force_rle: bool) -> bool:
    """Whether module F keeps the RLE stream (f.c:250-257): -c r, or block
    0's RLE stream at least RLE_GATE_RATIO smaller than block 0. Every block
    follows block 0's decision."""
    return force_rle or (size0 - rle_size0) / size0 >= RLE_GATE_RATIO


@dataclasses.dataclass
class _DataStream:
    """The data stream modules T and C take, as module F leaves it: its
    path (the .rle, or the input), mode (R or N), block sizes and their
    (n, 256) histograms."""
    path: str
    mode: str
    sizes: list[int]
    freqs: np.ndarray


def _freq_step(path: str, compress_rle: bool, force_freq: bool, sizes,
               rle_sizes, rle_hists, raw_hists, write: bool = True
               ) -> tuple[_DataStream, list[str]]:
    """Module F's .freq sidecars: R, of the RLE streams, where the gate kept
    them, and N, of the input's blocks, where -c f asks or the gate did not.
    rle_hists() and raw_hists() give their histograms, each called only for
    its file, R first. With write=False nothing is written (the multi-host
    processes but 0). Returns the stream for T and C, and the files
    generated, the .rle among them."""
    path_rle = formats.add_ext(path, formats.RLE_EXT)
    sidecars = []
    if compress_rle:
        sidecars.append(("R", path_rle, rle_sizes, rle_hists))
    if force_freq or not compress_rle:
        sidecars.append(("N", path, sizes, raw_hists))
    stream, generated = None, []
    for mode, data_path, stream_sizes, hists in sidecars:
        freqs = hists()
        path_freq = formats.add_ext(data_path, formats.FREQ_EXT)
        if write:
            _write_file(path_freq, "freq", formats.write_freq_arrays, mode,
                        stream_sizes, freqs)
        generated += [path_rle, path_freq] if mode == "R" else [path_freq]
        stream = stream or _DataStream(
            data_path, mode, [int(s) for s in stream_sizes], freqs)
    return stream, generated


def _t_step(stream: _DataStream, t0: float, write: bool = True
            ) -> tuple[codes_mod.CodeTables, StageReport]:
    """Module T on the stream's histograms: its code tables, its .cod
    (where write) and the stage's report, timed from t0. The caller opens
    the stage."""
    tables = codes_mod.build_code_tables(stream.freqs)
    path_cod = formats.add_ext(stream.path, formats.CODES_EXT)
    if write:
        _write_file(path_cod, "cod", formats.write_cod_tables, stream.mode,
                    stream.sizes, tables)
    return tables, _report("t", t0, stream.sizes, stream.sizes, [path_cod])


# ---------------------------------------------------------------------------
# Module F: RLE compression + frequency histograms (f.c:180-412)
# ---------------------------------------------------------------------------

@_stage("f")
def module_f(path: str, force_rle: bool, force_freq: bool, block_size: int,
             backend: Backend) -> tuple[str, StageReport]:
    t0 = time.perf_counter()
    geo = _input_geometry(path, block_size)
    sizes = geo.sizes()
    with tracing.span("shafa.io.read.input"), open(path, "rb") as fp:
        blocks = _read_blocks(fp, sizes)

    rle0 = backend.rle_encode(blocks[:1])[0]
    compress_rle = _rle_gate(sizes[0], rle0.size, force_rle)
    rle_blocks = rle_freqs = None
    if compress_rle:
        rle_blocks = [rle0] + backend.rle_encode(blocks[1:])
        rle_freqs = np.stack(backend.histogram(rle_blocks))
        _write_file(formats.add_ext(path, formats.RLE_EXT), "rle",
                    _write_rows, rle_blocks)
    stream, generated = _freq_step(
        path, compress_rle, force_freq, sizes,
        [b.size for b in rle_blocks or ()], lambda: rle_freqs,
        lambda: np.stack(backend.histogram(blocks)))
    return stream.path, _report("f", t0, sizes, stream.sizes, generated,
                                compress_rle=compress_rle, size_f=geo.total)


# ---------------------------------------------------------------------------
# Streaming F+T+C and D (inputs above STREAM_THRESHOLD)
# ---------------------------------------------------------------------------

class _Progress:
    """Batch-granular restart state for the streaming compress (copy of
    shafa_tpu/pipeline.py:323-363; SURVEY.md §5.3: per-block independence
    makes a partial encode restartable). A small .npz beside the temp output
    records how many batches are durably written plus the per-block
    metadata accumulated so far (numpy arrays only); a rerun with the same
    input resumes after the last recorded batch instead of re-encoding from
    byte 0. Disable with SHAFA_RESUME=0."""

    def __init__(self, path: str, key: dict):
        self.path = path
        self.key = {k: int(v) for k, v in key.items()}
        self.enabled = os.environ.get("SHAFA_RESUME", "1") != "0"

    def load(self) -> dict | None:
        if not self.enabled or not os.path.isfile(self.path):
            return None
        try:
            with np.load(self.path, allow_pickle=False) as z:
                state = {k: z[k] for k in z.files}
        except (OSError, ValueError, EOFError, zipfile.BadZipFile):
            return None  # unreadable state: start afresh
        for k, v in self.key.items():
            if int(state.get("key_" + k, -1)) != v:
                return None  # different input/config: stale state
        return state

    def save(self, **state) -> None:
        if not self.enabled:
            return
        for k, v in self.key.items():
            state["key_" + k] = v
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as fp:
            np.savez(fp, **state)
        os.replace(tmp, self.path)

    def clear(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


def _input_key(path: str, block_size: int) -> dict:
    """What a resume must find unchanged (shafa_tpu/pipeline.py:366)."""
    st = os.stat(path)
    return dict(total=st.st_size, block=block_size,
                mtime_ns=st.st_mtime_ns)


def _in_span(name: str, fn, *args):
    with tracing.span(name):
        return fn(*args)


class _WriteBehind:
    """Ordered write-behind on one writer thread (the reference's runtime
    layer overlaps block N's compute with block N-1's write,
    multithread.c:70-111). write(fn, *args) runs fn(*args) there, in the
    span ``shafa.io.write.<kind>``, and counts ``writes_behind``; writes
    keep their submission order. At most ``depth`` writes stay in flight
    (None: no bound). The thread runs file IO only: every backend call,
    and so every tensor and CUDA call, stays on the caller's thread.
    Errors surface at the next write past the depth or at drain; the
    caller's waits are ``shafa.overlap.wait_write``."""

    def __init__(self, kind: str, depth: int | None = None):
        self._wr = cf.ThreadPoolExecutor(1, "shafa-write")
        self._write_span = f"shafa.io.write.{kind}"
        self._depth = depth
        self._writes: list = []

    def write(self, fn, *args):
        tracing.count("writes_behind")
        self._writes.append(self._wr.submit(_in_span, self._write_span, fn,
                                            *args))
        if self._depth is not None and len(self._writes) > self._depth:
            with tracing.span("shafa.overlap.wait_write"):
                while len(self._writes) > self._depth:
                    self._writes.pop(0).result()

    def drain(self):
        with tracing.span("shafa.overlap.wait_write"):
            for w in self._writes:
                w.result()
        self._writes.clear()

    def close(self):
        self._wr.shutdown(wait=True)


class _Overlap(_WriteBehind):
    """Read-ahead + ordered write-behind around a streaming compute loop
    (copy of shafa_tpu/pipeline.py:372-409).

    A one-deep read prefetch plus the writer thread of _WriteBehind, at
    most 2 batches of output in flight (bounds RSS), so disk IO of batches
    k-1 and k+1 overlaps the device work of batch k. Each read runs in a
    ``shafa.io.read.<read_kind>`` span on the reader thread; the caller's
    wait for it is ``shafa.overlap.wait_read``."""

    def __init__(self, read_kind: str, write_kind: str):
        super().__init__(write_kind, depth=2)
        self._rd = cf.ThreadPoolExecutor(1, "shafa-read")
        self._read_span = f"shafa.io.read.{read_kind}"
        self._next = None

    def prefetch(self, fn, *args):
        self._next = self._rd.submit(_in_span, self._read_span, fn, *args)

    def take(self):
        fut, self._next = self._next, None
        with tracing.span("shafa.overlap.wait_read"):
            return fut.result()

    def close(self):
        self._rd.shutdown(wait=False, cancel_futures=True)
        super().close()


def _stream(batches, read, step, kinds: tuple[str, str],
            after=None) -> None:
    """The streaming loop (shafa_tpu/pipeline.py:372-409's overlap): batch
    k+1 is read ahead, read(lo, hi), while step(lo, hi, data, write)
    computes batch k and hands its output to write(fn, *args), which
    writes it behind; after(k), where given, runs once batch k's writes
    are done (the compress passes record their progress there). kinds:
    the (read, write) span kinds of _Overlap."""
    ov = _Overlap(*kinds)
    try:
        if batches:
            ov.prefetch(read, *batches[0])
        for k, (lo, hi) in enumerate(batches):
            data = ov.take()
            if k + 1 < len(batches):
                ov.prefetch(read, *batches[k + 1])
            step(lo, hi, data, ov.write)
            if after is not None:
                ov.drain()
                after(k)
        ov.drain()
    finally:
        ov.close()


def _stacked(hists: list) -> np.ndarray:
    return np.concatenate(hists) if hists else np.zeros((0, 256), np.int64)


def compress_pipeline_streaming(path: str, force_rle: bool, force_freq: bool,
                                block_size: int, backend: Backend
                                ) -> tuple[str, list[StageReport]]:
    """Bounded-memory fused pipeline: two passes, one device batch at a
    time. Copy of shafa_tpu/pipeline.py:435-641.

    Pass F streams batches through RLE+histogram, appending exact `.rle`
    bytes as they compact off the device and keeping only KB-scale
    histograms/sizes on host; module T runs on the gathered histograms;
    pass C re-reads the stream (`.rle` or the original) batch-wise and
    appends `.shaf` frames. Peak host and device memory are one device
    batch (device.batch_rows) plus outputs, whatever the file's size.
    Output files are byte-identical to compress_pipeline's at any batch
    size (tests/test_torch_streaming.py).
    """
    t0 = time.perf_counter()
    with _stage("f"):
        geo = _input_geometry(path, block_size)
        sizes = geo.sizes()
        batches = _batches(geo.n_blocks, block_size)

        # --- pass F --------------------------------------------------------
        rle_sizes: list[int] = []
        rle_hists: list[np.ndarray] = []
        raw_hists: list[np.ndarray] = []
        compress_rle: bool | None = None
        path_rle = formats.add_ext(path, formats.RLE_EXT)
        prog = _Progress(path_rle + ".progress", _input_key(path, block_size))
        start = 0
        resume_at = None
        st = prog.load()
        if st is not None and (not bool(st["compress_rle"])
                              or os.path.isfile(path_rle + ".shafa_tmp")):
            start = int(st["done_batches"])
            compress_rle = bool(st["compress_rle"])
            resume_at = int(st["rle_written"])
            if compress_rle:
                rle_sizes = [int(s) for s in st["rle_sizes"]]
                rle_hists = [st["rle_hists"]]
            if st["raw_hists"].size:
                raw_hists = [st["raw_hists"]]
        rle_tmp = _AtomicFile(path_rle, keep_on_error=prog.enabled,
                              resume_at=resume_at)
        rle_fp = None
        if resume_at is not None and compress_rle:
            rle_fp = rle_tmp.__enter__()

        def encode(lo, hi, blocks, write):
            nonlocal compress_rle, rle_fp
            h = backend.fused_encode(blocks)
            batch_sizes = backend.fused_rle_sizes(h)
            if compress_rle is None:
                compress_rle = _rle_gate(sizes[0], int(batch_sizes[0]),
                                         force_rle)
                if compress_rle:
                    rle_fp = rle_tmp.__enter__()
            if compress_rle:
                rle_sizes.extend(int(s) for s in batch_sizes)
                rle_hists.append(backend.fused_rle_hists(h))
                write(rle_fp.write, backend.fused_rle_bytes(h).tobytes())
            if force_freq or not compress_rle:
                raw_hists.append(backend.fused_raw_hists(h))

        def progress_f(k):
            rle_hists[:] = [_stacked(rle_hists)] if rle_hists else []
            raw_hists[:] = [_stacked(raw_hists)] if raw_hists else []
            prog.save(done_batches=start + k + 1,
                      compress_rle=bool(compress_rle),
                      rle_written=rle_fp.tell() if rle_fp else 0,
                      rle_sizes=np.asarray(rle_sizes, np.int64),
                      rle_hists=_stacked(rle_hists),
                      raw_hists=_stacked(raw_hists))

        try:
            with open(path, "rb") as fp:
                _stream(batches[start:],
                        lambda lo, hi: _read_blocks(fp, sizes, lo, hi),
                        encode, ("input", "rle"),
                        progress_f if prog.enabled else None)
        except BaseException:
            if rle_fp is not None:
                rle_tmp.__exit__(RuntimeError, None, None)
            raise
        if rle_fp is not None:
            rle_tmp.__exit__(None, None, None)
        prog.clear()
        stream, generated = _freq_step(
            path, compress_rle, force_freq, sizes, rle_sizes,
            lambda: _stacked(rle_hists), lambda: _stacked(raw_hists))
    rep_f = _report("f", t0, sizes, stream.sizes, generated,
                    compress_rle=compress_rle, size_f=geo.total,
                    streaming=True)

    t1 = time.perf_counter()
    with _stage("t"):
        tables, rep_t = _t_step(stream, t1)

    # --- pass C ------------------------------------------------------------
    t2 = time.perf_counter()
    payload_sizes: list[int] = []
    with _stage("c"):
        path_shafa = formats.add_ext(stream.path, formats.SHAFA_EXT)
        progc = _Progress(path_shafa + ".progress",
                          _input_key(path, block_size))
        startc = 0
        resume_c = None
        stc = progc.load()
        if stc is not None and os.path.isfile(path_shafa + ".shafa_tmp"):
            startc = int(stc["done_batches"])
            payload_sizes.extend(int(s) for s in stc["payload_sizes"])
            resume_c = int(stc["written"])

        def pack(lo, hi, blocks, write):
            payloads = backend.pack(
                blocks, codes_mod.take_rows(tables, lo, hi),
                stream.freqs[lo:hi])
            payload_sizes.extend(len(p) for p in payloads)
            write(_write_shaf, out_fp, payloads)

        def progress_c(k):
            progc.save(done_batches=startc + k + 1, written=out_fp.tell(),
                       payload_sizes=np.asarray(payload_sizes, np.int64))

        with _AtomicFile(path_shafa, keep_on_error=progc.enabled,
                         resume_at=resume_c) as out_fp, \
                open(stream.path, "rb") as fp:
            if resume_c is None:
                _write_shaf(out_fp, (), geo.n_blocks)
            _stream(batches[startc:],
                    lambda lo, hi: _read_blocks(fp, stream.sizes, lo, hi),
                    pack, (_data_kind(stream.path), "shaf"),
                    progress_c if progc.enabled else None)
        progc.clear()
    rep_c = _report("c", t2, stream.sizes, payload_sizes, [path_shafa])
    return path_shafa, [rep_f, rep_t, rep_c]


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

    On the device-resident path the .rle is written on a writer thread,
    straight from its download buffer, while modules T and C run; the
    chain waits for it before it returns or raises (``_drain_f``).
    """
    if not getattr(backend, "supports_fused", False):
        p, rf = module_f(path, force_rle, force_freq, block_size, backend)
        p, rt = module_t(p)
        p, rc = module_c(p, backend)
        return p, [rf, rt, rc]

    if _over_stream_threshold(path):
        return compress_pipeline_streaming(path, force_rle, force_freq,
                                           block_size, backend)

    t0 = time.perf_counter()
    behind = _WriteBehind("rle")
    published: list[str] = []  # the sidecars renamed into place behind it
    try:
        with _stage("f"):
            geo = _input_geometry(path, block_size)
            sizes = geo.sizes()
            with tracing.span("shafa.io.read.input"), open(path, "rb") as fp:
                blocks = _read_blocks(fp, sizes)

            handle = backend.fused_encode(blocks)
            rle_sizes = backend.fused_rle_sizes(handle)
            compress_rle = _rle_gate(sizes[0], int(rle_sizes[0]), force_rle)
            path_rle = formats.add_ext(path, formats.RLE_EXT)
            if compress_rle:
                # written behind T and C, straight from its download
                # buffer; nothing after it reads the file
                rle_flat = backend.fused_rle_bytes(handle)
                rle_offs = np.concatenate(([0], np.cumsum(rle_sizes)))
                behind.write(_write_atomic, path_rle, _write_rows, [
                    rle_flat[i:i + WRITE_SLICE]
                    for i in range(0, rle_flat.size, WRITE_SLICE)])
            stream, generated = _freq_step(
                path, compress_rle, force_freq, sizes, rle_sizes,
                lambda: backend.fused_rle_hists(handle),
                lambda: backend.fused_raw_hists(handle))
            published += [g for g in generated if g != path_rle]
        rep_f = _report("f", t0, sizes, stream.sizes, generated,
                        compress_rle=compress_rle, size_f=geo.total)

        t1 = time.perf_counter()
        with _stage("t"):
            tables, rep_t = _t_step(stream, t1)
            published += rep_t.generated

        t2 = time.perf_counter()

        def host_row(i: int) -> np.ndarray:
            if compress_rle:
                return rle_flat[rle_offs[i]:rle_offs[i + 1]]
            return blocks[i]

        with _stage("c"):
            payloads = backend.fused_pack(handle, tables, compress_rle,
                                          host_row)
            path_shafa = formats.add_ext(stream.path, formats.SHAFA_EXT)
            _write_file(path_shafa, "shaf", _write_shaf, payloads,
                        geo.n_blocks)
            published.append(path_shafa)
        rep_c = _report("c", t2, stream.sizes, [len(p) for p in payloads],
                        [path_shafa])
    finally:
        _drain_f(behind, published)
    return path_shafa, [rep_f, rep_t, rep_c]


def _drain_f(behind: _WriteBehind, published: list[str]) -> None:
    """Wait for module F's write behind the chain, before the chain
    returns or raises. Where it failed, the chain ends as the serial chain
    would have at that write: the sidecars published after it are taken
    back, and its error is raised as module F's, ahead of any later
    stage's."""
    try:
        behind.drain()
    except BaseException as e:
        for p in published:
            with contextlib.suppress(OSError):
                os.unlink(p)
        if isinstance(e, ShafaError):
            e.stage = "f"
        raise
    finally:
        behind.close()


# ---------------------------------------------------------------------------
# Module T: Shannon-Fano code construction (t.c:246-445)
# ---------------------------------------------------------------------------

@_stage("t")
def module_t(path: str) -> tuple[str, StageReport]:
    t0 = time.perf_counter()
    stream = _DataStream(path, *formats.parse_freq_arrays(
        _open_read(formats.add_ext(path, formats.FREQ_EXT), "freq")))
    return path, _t_step(stream, t0)[1]


# ---------------------------------------------------------------------------
# Module C: bit-pack encode (c.c:306-472)
# ---------------------------------------------------------------------------

@_stage("c")
def module_c(path: str, backend: Backend) -> tuple[str, StageReport]:
    t0 = time.perf_counter()
    _, block_sizes, tables = formats.parse_cod_tables(
        _open_read(formats.add_ext(path, formats.CODES_EXT), "cod"))
    if not os.path.isfile(path):
        raise FileInaccessibleError(path)
    with tracing.span(f"shafa.io.read.{_data_kind(path)}"), \
            open(path, "rb") as fp:
        blocks = _read_blocks(fp, block_sizes)
    payloads = backend.pack(blocks, tables)
    path_shafa = formats.add_ext(path, formats.SHAFA_EXT)
    _write_file(path_shafa, "shaf", _write_shaf, payloads, len(block_sizes))
    return path_shafa, _report("c", t0, block_sizes,
                               [len(p) for p in payloads], [path_shafa])


# ---------------------------------------------------------------------------
# Module D: decode (d.c:628-834) and RLE-only decode (d.c:232-388)
# ---------------------------------------------------------------------------

@_stage("d")
def module_d_shafa(path: str, rle_decompression: bool,
                   backend: Backend) -> tuple[str, StageReport]:
    t0 = time.perf_counter()
    path_tmp = formats.rm_ext(path)  # strip .shaf
    path_wrt = formats.rm_ext(path_tmp) if rle_decompression else path_tmp
    mode, block_sizes, tables = formats.parse_cod_tables(
        _open_read(formats.add_ext(path_tmp, formats.CODES_EXT), "cod"))
    # Mode legality (d.c:678): N forbids the RLE path; R allows both.
    if not ((mode == "N" and not rle_decompression) or mode == "R"):
        raise FileUnrecognizableError(".cod mode vs decompression type")
    algo = "shafa_rle" if rle_decompression else "shafa"
    fused = getattr(backend, "supports_fused", False)
    if fused and _over_stream_threshold(path):
        return _module_d_streaming(
            path, path_wrt, block_sizes, "shaf", t0, algo,
            lambda lo, hi, payloads: backend.fused_decode(
                payloads, codes_mod.take_rows(tables, lo, hi),
                block_sizes[lo:hi], expand=rle_decompression))
    payloads = formats.parse_shaf_frames(_open_read(path, "shaf"))
    if len(payloads) != len(block_sizes):
        raise FileUnrecognizableError("block count mismatch .shaf vs .cod")
    if fused:
        out_blocks = backend.fused_decode(payloads, tables, block_sizes,
                                          expand=rle_decompression)
    else:
        out_blocks = backend.unpack(payloads, tables, block_sizes)
        if rle_decompression:
            out_blocks = backend.rle_expand(out_blocks)
    _write_file(path_wrt, "restored", _write_rows, out_blocks)
    return path_wrt, _report("d", t0, [len(p) for p in payloads],
                             [b.size for b in out_blocks], [path_wrt],
                             algo=algo)


@_stage("d")
def module_d_rle(path: str, backend: Backend) -> tuple[str, StageReport]:
    t0 = time.perf_counter()
    freq = formats.parse_freq(_open_read(formats.add_ext(path,
                                                         formats.FREQ_EXT),
                                         "freq"))
    if freq.mode != "R":
        raise FileUnrecognizableError(".freq mode must be R for RLE decode")
    path_wrt = formats.rm_ext(path)
    if _over_stream_threshold(path):
        return _module_d_streaming(
            path, path_wrt, freq.block_sizes, "rle", t0, "rle",
            lambda lo, hi, blocks: backend.rle_expand(blocks))
    with tracing.span("shafa.io.read.rle"), open(path, "rb") as fp:
        blocks = _read_blocks(fp, freq.block_sizes)
    out_blocks = backend.rle_expand(blocks)
    _write_file(path_wrt, "restored", _write_rows, out_blocks)
    return path_wrt, _report("d", t0, freq.block_sizes,
                             [b.size for b in out_blocks], [path_wrt],
                             algo="rle")


def _module_d_streaming(path, path_wrt, block_sizes, kind: str, t0, algo,
                        decode) -> tuple[str, StageReport]:
    """Bounded-memory module D of a .shaf (kind shaf; copy of
    shafa_tpu/pipeline.py:856-935) or an .rle (kind rle; :961-1020): one
    device batch of its frames or blocks resident at a time (the reference
    keeps one block, d.c:694-763 and d.c:322-352), read ahead, decoded by
    decode(lo, hi, data) and written behind. Output bytes are identical to
    the resident path's (tests/test_torch_streaming.py)."""
    n_blocks = len(block_sizes)
    sizes_before: list[int] = []
    sizes_after: list[int] = []

    def read_frames(lo, hi):
        payloads = []
        start = in_fp.tell()
        for _ in range(hi - lo):
            try:
                payloads.append(next(frames))
            except StopIteration:
                raise FileUnrecognizableError(
                    "block count mismatch .shaf vs .cod") from None
        tracing.count("file_read_bytes", in_fp.tell() - start)
        return payloads

    def step(lo, hi, data, write):
        out_blocks = decode(lo, hi, data)
        sizes_before.extend(len(d) for d in data)
        sizes_after.extend(b.size for b in out_blocks)
        write(_write_rows, out_fp, out_blocks)

    try:
        with open(path, "rb") as in_fp, _AtomicFile(path_wrt) as out_fp:
            frames = formats.iter_shaf_frames_file(in_fp)
            read = read_frames if kind == "shaf" else \
                lambda lo, hi: _read_blocks(in_fp, block_sizes, lo, hi)
            _stream(_batches(n_blocks, max(block_sizes, default=1), 8), read,
                    step, (kind, "restored"))
            # the archive must not have extra frames (the iterator raises
            # on trailing bytes only when driven to exhaustion)
            if kind == "shaf" and next(frames, None) is not None:
                raise FileUnrecognizableError(
                    "block count mismatch .shaf vs .cod")
    except OSError as e:
        raise FileInaccessibleError(str(e)) from e
    return path_wrt, _report("d", t0, sizes_before, sizes_after, [path_wrt],
                             algo=algo, streaming=True)


# ---------------------------------------------------------------------------
# Multi-host F+T+C and D (shafa_tpu/multihost.py:185-414)
# ---------------------------------------------------------------------------

def compress_multihost(path: str, block_size: int, backend, comm=None,
                       force_rle: bool = False,
                       force_freq: bool = False) -> str:
    """Modules F+T+C across processes (shafa_tpu/multihost.py:185): output
    files byte-identical to the one-process pipeline's. Each process
    streams its block range (multihost.partition_blocks) one device batch
    at a time into local spool files and splices them into the shared
    outputs at the offsets the gathered sizes give; process 0 writes the
    .freq and .cod. comm: a multihost.Comm (by default, the process group's).

    The per-process RLE histograms are kept as int32 (a 64 MiB block's
    counts fit) and widened after the gather, so .freq and .cod are
    unchanged."""
    from . import multihost
    comm = comm or multihost.Comm()
    first = comm.index == 0
    geo = _input_geometry(path, block_size)
    sizes = geo.sizes()
    rng = multihost.partition_blocks(geo.n_blocks, comm.count, comm.index)
    batches = _batches(rng.hi, block_size, 1, rng.lo)
    spool_dir = os.path.dirname(path) or "."

    # --- pass F: stream batches; spool RLE bytes, keep KB-scale metadata ---
    my_rle_sizes = np.zeros(rng.n, np.int64)
    my_rle_hists = np.zeros((rng.n, 256), np.int32)
    with tempfile.TemporaryFile(dir=spool_dir) as rle_spool:
        with open(path, "rb") as fp:
            for lo, hi in batches:
                h = backend.fused_encode(_read_blocks(fp, sizes, lo, hi))
                my_rle_sizes[lo - rng.lo: hi - rng.lo] = \
                    backend.fused_rle_sizes(h)
                my_rle_hists[lo - rng.lo: hi - rng.lo] = \
                    backend.fused_rle_hists(h)
                rle_spool.write(backend.fused_rle_bytes(h).tobytes())
                del h  # free the batch's device tensors (bounded memory)
        rle_sizes = comm.allgather(my_rle_sizes)
        compress_rle = _rle_gate(sizes[0], int(rle_sizes[0]), force_rle)
        if compress_rle:
            rle_offs = np.concatenate(([0], np.cumsum(rle_sizes)))
            multihost.splice_spool(rle_spool,
                                   formats.add_ext(path, formats.RLE_EXT),
                                   int(rle_offs[rng.lo]), int(rle_offs[-1]))

    def raw_hists():  # a second streaming pass (f.c:278-334)
        my_nfreqs = np.zeros((rng.n, 256), np.int64)
        with open(path, "rb") as fp:
            for lo, hi in batches:
                my_nfreqs[lo - rng.lo: hi - rng.lo] = np.stack(
                    backend.histogram(_read_blocks(fp, sizes, lo, hi)))
        return comm.allgather(my_nfreqs)

    stream, _ = _freq_step(
        path, compress_rle, force_freq, sizes, rle_sizes,
        lambda: comm.allgather(my_rle_hists).astype(np.int64), raw_hists,
        write=first)
    # module T: the same tables on every process
    tables, _ = _t_step(stream, time.perf_counter(), write=first)

    # --- pass C: stream the data stream batch-wise, pack, spool frames ----
    my_psizes = np.zeros(rng.n, np.int64)
    with tempfile.TemporaryFile(dir=spool_dir) as shaf_spool:
        with open(stream.path, "rb") as fp:
            for lo, hi in batches:
                payloads = backend.pack(
                    _read_blocks(fp, stream.sizes, lo, hi),
                    codes_mod.take_rows(tables, lo, hi), stream.freqs[lo:hi])
                my_psizes[lo - rng.lo: hi - rng.lo] = [len(p)
                                                       for p in payloads]
                _write_shaf(shaf_spool, payloads)
        offs, total = multihost.shaf_offsets(comm.allgather(my_psizes))
        path_shafa = formats.add_ext(stream.path, formats.SHAFA_EXT)
        if first:
            multihost.write_at(path_shafa, 0,
                               f"@{geo.n_blocks}".encode("ascii"),
                               total_size=total)
        if rng.n:
            multihost.splice_spool(shaf_spool, path_shafa,
                                   int(offs[rng.lo]), total)
    return path_shafa


def decompress_multihost(path: str, backend, comm=None) -> str:
    """Module D across processes (shafa_tpu/multihost.py:363): each process
    scans the frame headers, reads only its contiguous payload range,
    decodes it batch-wise into a local spool file and splices the spool
    into the shared output at the offset the gathered decoded sizes give."""
    from . import multihost
    comm = comm or multihost.Comm()
    path_tmp = formats.rm_ext(path)  # strip .shaf
    rle = formats.check_ext(path_tmp, formats.RLE_EXT)
    path_wrt = formats.rm_ext(path_tmp) if rle else path_tmp
    mode, block_sizes, tables = formats.parse_cod_tables(
        _open_read(formats.add_ext(path_tmp, formats.CODES_EXT), "cod"))
    frame_offs, frame_sizes, n_blocks = multihost.scan_shaf_offsets(path)
    if n_blocks != len(block_sizes):
        raise FileUnrecognizableError("block count mismatch .shaf vs .cod")

    rng = multihost.partition_blocks(n_blocks, comm.count, comm.index)
    expand = rle and mode == "R"
    my_sizes = np.zeros(rng.n, np.int64)
    with tempfile.TemporaryFile(dir=os.path.dirname(path) or ".") as spool:
        with open(path, "rb") as fp:
            for lo, hi in _batches(rng.hi, max(block_sizes, default=1), 8,
                                   rng.lo):
                fp.seek(frame_offs[lo])
                buf = fp.read(int(frame_offs[hi - 1] + frame_sizes[hi - 1]
                                  - frame_offs[lo]))
                base = frame_offs[lo]
                payloads = [
                    buf[int(frame_offs[i] - base):
                        int(frame_offs[i] - base + frame_sizes[i])]
                    for i in range(lo, hi)]
                out_blocks = backend.fused_decode(
                    payloads, codes_mod.take_rows(tables, lo, hi),
                    block_sizes[lo:hi], expand=expand)
                my_sizes[lo - rng.lo: hi - rng.lo] = [b.size
                                                      for b in out_blocks]
                _write_rows(spool, out_blocks)
        offs = np.concatenate(([0], np.cumsum(comm.allgather(my_sizes))))
        multihost.splice_spool(spool, path_wrt, int(offs[rng.lo]),
                               int(offs[-1]))
    return path_wrt
