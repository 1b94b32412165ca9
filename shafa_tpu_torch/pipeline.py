"""Stage drivers: modules F, T, C, D — behavior-compatible with the reference.

Copy of shafa_tpu/pipeline.py without its get_backend (the CLI builds the
backend). Each module reads/writes the sidecar formats of formats.py and
hands the "current path" forward exactly like the reference's path hand-off
protocol (shafa.c:135-142): F: file -> file.rle, C: x -> x.shaf, D: strips
extensions.

Compute is delegated to a backend (the NumPy oracle, or TorchBackend in
device.py) that operates on LISTS of blocks, so the device backend can batch
blocks into padded device tensors.

Inputs above STREAM_THRESHOLD take the streaming pipelines, as in the
original: one device batch at a time, disk reads and writes overlapped with
the device work by a read-ahead and a write-behind thread that do file IO
only (every backend call stays on the calling thread), and a compress that
resumes after the last batch written durably.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
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


def _read_blocks(path: str, sizes: Sequence[int],
                 kind: str) -> list[np.ndarray]:
    """The blocks of a data stream (kind: input or rle), one read each."""
    out = []
    with tracing.span(f"shafa.io.read.{kind}"), open(path, "rb") as fp:
        for s in sizes:
            buf = fp.read(s)
            if len(buf) != s:
                raise FileUnrecognizableError(f"{path}: truncated block")
            out.append(np.frombuffer(buf, np.uint8))
    tracing.count("file_read_bytes", sum(sizes))
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


def _data_kind(path: str) -> str:
    """The io span kind of a data stream: rle or input."""
    return "rle" if formats.check_ext(path, formats.RLE_EXT) else "input"


def _over_stream_threshold(path: str) -> bool:
    return os.path.isfile(path) and os.path.getsize(path) > STREAM_THRESHOLD


# ---------------------------------------------------------------------------
# Module F: RLE compression + frequency histograms (f.c:180-412)
# ---------------------------------------------------------------------------

@tracing.spanned("shafa.pipeline.f")
def module_f(path: str, force_rle: bool, force_freq: bool, block_size: int,
             backend: Backend) -> tuple[str, StageReport]:
    t0 = time.perf_counter()
    if not os.path.isfile(path):
        raise FileInaccessibleError(path)
    geo = geometry.geometry_for_file(path, block_size)
    if geo.total < geometry.MIN_FILE_SIZE:
        raise FileTooSmallError(path)
    sizes = geo.sizes()
    blocks = _read_blocks(path, sizes, "input")

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
        with tracing.span("shafa.io.write.rle"), \
                _AtomicFile(path_rle) as fp:
            for b in rle_blocks:
                fp.write(b.tobytes())
        path_rle_freq = formats.add_ext(path_rle, formats.FREQ_EXT)
        with tracing.span("shafa.io.write.freq"), \
                _AtomicFile(path_rle_freq) as fp:
            formats.write_freq_arrays(fp, "R", rle_sizes, np.stack(freqs))
        generated += [path_rle, path_rle_freq]
    if force_freq or not compress_rle:
        freqs = backend.histogram(blocks)
        path_freq = formats.add_ext(path, formats.FREQ_EXT)
        with tracing.span("shafa.io.write.freq"), \
                _AtomicFile(path_freq) as fp:
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


class _Overlap:
    """Read-ahead + ordered write-behind around a streaming compute loop
    (copy of shafa_tpu/pipeline.py:372-409).

    A one-deep read prefetch plus a single-thread write executor, so disk
    IO of batches k-1 and k+1 overlaps the device work of batch k (the
    reference's runtime layer overlaps block N's compute with block N-1's
    write, multithread.c:70-111). The threads run file IO only: every
    backend call, and so every tensor and CUDA call, stays on the caller's
    thread. Single writer thread => writes retain submission order. Errors
    surface at the next submit/drain.

    Each read runs in a ``shafa.io.read.<read_kind>`` span on the reader
    thread, each write in ``shafa.io.write.<write_kind>`` on the writer;
    the caller's waits for them are ``shafa.overlap.wait_read`` and
    ``shafa.overlap.wait_write``."""

    def __init__(self, read_kind: str, write_kind: str):
        self._rd = cf.ThreadPoolExecutor(1, "shafa-read")
        self._wr = cf.ThreadPoolExecutor(1, "shafa-write")
        self._read_span = f"shafa.io.read.{read_kind}"
        self._write_span = f"shafa.io.write.{write_kind}"
        self._next = None
        self._writes: list = []

    @staticmethod
    def _in_span(name, fn, *args):
        with tracing.span(name):
            return fn(*args)

    def prefetch(self, fn, *args):
        self._next = self._rd.submit(self._in_span, self._read_span, fn,
                                     *args)

    def take(self):
        fut, self._next = self._next, None
        with tracing.span("shafa.overlap.wait_read"):
            return fut.result()

    def write(self, fn, *args):
        self._writes.append(self._wr.submit(self._in_span, self._write_span,
                                            fn, *args))
        # keep at most 2 batches of output in flight (bounds RSS)
        if len(self._writes) > 2:
            with tracing.span("shafa.overlap.wait_write"):
                while len(self._writes) > 2:
                    self._writes.pop(0).result()

    def drain(self):
        with tracing.span("shafa.overlap.wait_write"):
            for w in self._writes:
                w.result()
        self._writes.clear()

    def close(self):
        self._rd.shutdown(wait=False, cancel_futures=True)
        self._wr.shutdown(wait=True)


def _read_block_range(fp, geo, lo: int, hi: int) -> list[np.ndarray]:
    """Blocks [lo, hi) of an open file (one contiguous read). Copy of
    shafa_tpu/pipeline.py:412."""
    sizes = geo.sizes()
    fp.seek(geo.offset(lo))
    buf = fp.read(sum(sizes[lo:hi]))
    tracing.count("file_read_bytes", len(buf))
    out, pos = [], 0
    for s in sizes[lo:hi]:
        if pos + s > len(buf):
            raise FileUnrecognizableError("truncated block")
        out.append(np.frombuffer(buf, np.uint8, count=s, offset=pos))
        pos += s
    return out


def _stream_batches(geo, block_size: int):
    """Block index ranges sized like the device backend's batches (copy of
    shafa_tpu/pipeline.py:426). device.MAX_BATCH_ELEMS is read at call
    time."""
    from . import device
    p = device._bucket(block_size)
    bsz = max(1, device.MAX_BATCH_ELEMS // p)
    for lo in range(0, geo.n_blocks, bsz):
        yield lo, min(lo + bsz, geo.n_blocks)


def _decode_batch_blocks(block_sizes) -> int:
    """Blocks per streaming decode batch (shafa_tpu/pipeline.py:870-873):
    the decompressed counts bound the padded decode width, since payloads
    are never larger than their decoded streams."""
    from . import device
    p = device._bucket(max(block_sizes) if block_sizes else 1)
    return max(1, device.MAX_BATCH_ELEMS // (p * 8))


def _sub_tables(tables, lo: int, hi: int) -> codes_mod.CodeTables:
    """Rows [lo, hi) of a CodeTables, overflow rows renumbered."""
    return codes_mod.CodeTables(
        tables.lens[lo:hi], tables.vals[lo:hi],
        {i - lo: v for i, v in tables.overflow.items() if lo <= i < hi})


def compress_pipeline_streaming(path: str, force_rle: bool, force_freq: bool,
                                block_size: int, backend: Backend
                                ) -> tuple[str, list[StageReport]]:
    """Bounded-memory fused pipeline: two passes, one device batch at a
    time. Copy of shafa_tpu/pipeline.py:435-641.

    Pass F streams batches through RLE+histogram, appending exact `.rle`
    bytes as they compact off the device and keeping only KB-scale
    histograms/sizes on host; module T runs on the gathered histograms;
    pass C re-reads the stream (`.rle` or the original) batch-wise and
    appends `.shaf` frames. Peak host and device memory are one batch
    (~MAX_BATCH_ELEMS plus outputs) regardless of file size. Output files
    are byte-identical to compress_pipeline's at any batch size
    (tests/test_torch_streaming.py).
    """
    t0 = time.perf_counter()
    with tracing.span("shafa.pipeline.f"):
        if not os.path.isfile(path):
            raise FileInaccessibleError(path)
        geo = geometry.geometry_for_file(path, block_size)
        if geo.total < geometry.MIN_FILE_SIZE:
            raise FileTooSmallError(path)
        sizes = geo.sizes()

        # --- pass F --------------------------------------------------------
        rle_sizes: list[int] = []
        rle_hists: list[np.ndarray] = []
        raw_hists: list[np.ndarray] = []
        compress_rle: bool | None = None
        generated: list[str] = []
        path_rle = formats.add_ext(path, formats.RLE_EXT)
        prog = _Progress(path_rle + ".progress", _input_key(path, block_size))
        start_bi = 0
        resume_at = None
        st = prog.load()
        if st is not None and (not bool(st["compress_rle"])
                              or os.path.isfile(path_rle + ".shafa_tmp")):
            start_bi = int(st["done_batches"])
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
        batches = list(_stream_batches(geo, block_size))
        # read batch k+1 / write batch k-1 while k computes
        ov = _Overlap("input", "rle")
        try:
            with open(path, "rb") as fp:
                if start_bi < len(batches):
                    ov.prefetch(_read_block_range, fp, geo, *batches[start_bi])
                for bi in range(start_bi, len(batches)):
                    blocks = ov.take()
                    if bi + 1 < len(batches):
                        ov.prefetch(_read_block_range, fp, geo,
                                    *batches[bi + 1])
                    h = backend.fused_encode(blocks)
                    batch_sizes = backend.fused_rle_sizes(h)
                    if compress_rle is None:  # gate from block 0 (f.c:250-257)
                        ratio = (sizes[0] - int(batch_sizes[0])) / sizes[0]
                        compress_rle = force_rle or ratio >= RLE_GATE_RATIO
                        if compress_rle:
                            rle_fp = rle_tmp.__enter__()
                    if compress_rle:
                        rle_sizes.extend(int(s) for s in batch_sizes)
                        rle_hists.append(backend.fused_rle_hists(h))
                        ov.write(rle_fp.write,
                                 backend.fused_rle_bytes(h).tobytes())
                    if force_freq or not compress_rle:
                        raw_hists.append(backend.fused_raw_hists(h))
                    del h  # free the batch's device tensors
                    if prog.enabled:
                        ov.drain()  # writes durable before recording progress
                        prog.save(
                            done_batches=bi + 1,
                            compress_rle=bool(compress_rle),
                            rle_written=rle_fp.tell() if rle_fp else 0,
                            rle_sizes=np.asarray(rle_sizes, np.int64),
                            rle_hists=(np.concatenate(rle_hists) if rle_hists
                                       else np.zeros((0, 256), np.int64)),
                            raw_hists=(np.concatenate(raw_hists) if raw_hists
                                       else np.zeros((0, 256), np.int64)))
                        if rle_hists:
                            rle_hists = [np.concatenate(rle_hists)]
                        if raw_hists:
                            raw_hists = [np.concatenate(raw_hists)]
                ov.drain()
        except BaseException:
            if rle_fp is not None:
                rle_tmp.__exit__(RuntimeError, None, None)
            raise
        finally:
            ov.close()
        if rle_fp is not None:
            rle_tmp.__exit__(None, None, None)
        prog.clear()

        if compress_rle:
            freqs = np.concatenate(rle_hists)
            path_rle_freq = formats.add_ext(path_rle, formats.FREQ_EXT)
            with tracing.span("shafa.io.write.freq"), \
                    _AtomicFile(path_rle_freq) as fp:
                formats.write_freq_arrays(fp, "R", rle_sizes, freqs)
            generated += [path_rle, path_rle_freq]
            mode, stream_sizes = "R", rle_sizes
        if force_freq or not compress_rle:
            nfreqs = np.concatenate(raw_hists)
            path_freq = formats.add_ext(path, formats.FREQ_EXT)
            with tracing.span("shafa.io.write.freq"), \
                    _AtomicFile(path_freq) as fp:
                formats.write_freq_arrays(fp, "N", sizes, nfreqs)
            generated.append(path_freq)
            if not compress_rle:
                mode, stream_sizes, freqs = "N", list(sizes), nfreqs
        data_path = path_rle if compress_rle else path
    rep_f = StageReport(
        module="f", n_blocks=geo.n_blocks, sizes_before=sizes,
        sizes_after=stream_sizes,
        runtime_ms=(time.perf_counter() - t0) * 1e3, generated=generated,
        extra={"compress_rle": compress_rle, "size_f": geo.total,
               "streaming": True})

    # --- module T ------------------------------------------------------------
    t1 = time.perf_counter()
    try:
        with tracing.span("shafa.pipeline.t"):
            tables = codes_mod.build_code_tables(freqs)
            path_cod = formats.add_ext(data_path, formats.CODES_EXT)
            with tracing.span("shafa.io.write.cod"), \
                    _AtomicFile(path_cod) as fp:
                formats.write_cod_tables(fp, mode, stream_sizes, tables)
    except ShafaError as e:
        e.stage = "t"
        raise
    rep_t = StageReport(
        module="t", n_blocks=geo.n_blocks, sizes_before=stream_sizes,
        sizes_after=stream_sizes,
        runtime_ms=(time.perf_counter() - t1) * 1e3, generated=[path_cod])

    # --- pass C ------------------------------------------------------------
    t2 = time.perf_counter()
    payload_sizes: list[int] = []
    try:
        with tracing.span("shafa.pipeline.c"):
            path_shafa = formats.add_ext(data_path, formats.SHAFA_EXT)
            offs = np.concatenate(([0], np.cumsum(stream_sizes)))

            def read_streams(fp, lo, hi):
                fp.seek(offs[lo])
                buf = fp.read(int(offs[hi] - offs[lo]))
                tracing.count("file_read_bytes", len(buf))
                blocks, pos = [], 0
                for s in stream_sizes[lo:hi]:
                    blocks.append(np.frombuffer(buf, np.uint8, count=s,
                                                offset=pos))
                    pos += s
                return blocks

            def write_payloads(out_fp, payloads):
                for p in payloads:
                    formats.write_shaf_block(out_fp, p)

            progc = _Progress(path_shafa + ".progress",
                              _input_key(path, block_size))
            startc = 0
            resume_c = None
            stc = progc.load()
            if stc is not None and os.path.isfile(path_shafa + ".shafa_tmp"):
                startc = int(stc["done_batches"])
                payload_sizes.extend(int(s) for s in stc["payload_sizes"])
                resume_c = int(stc["written"])
            ov = _Overlap(_data_kind(data_path), "shaf")
            try:
                with _AtomicFile(path_shafa, keep_on_error=progc.enabled,
                                 resume_at=resume_c) as out_fp, \
                        open(data_path, "rb") as fp:
                    if resume_c is None:
                        formats.write_shaf_header(out_fp, geo.n_blocks)
                    if startc < len(batches):
                        ov.prefetch(read_streams, fp, *batches[startc])
                    for bi in range(startc, len(batches)):
                        lo, hi = batches[bi]
                        blocks = ov.take()
                        if bi + 1 < len(batches):
                            ov.prefetch(read_streams, fp, *batches[bi + 1])
                        payloads = backend.pack(blocks, _sub_tables(tables, lo,
                                                                    hi),
                                                freqs[lo:hi])
                        payload_sizes.extend(len(p) for p in payloads)
                        ov.write(write_payloads, out_fp, payloads)
                        if progc.enabled:
                            ov.drain()
                            progc.save(done_batches=bi + 1,
                                       written=out_fp.tell(),
                                       payload_sizes=np.asarray(payload_sizes,
                                                                np.int64))
                    ov.drain()
            finally:
                ov.close()
            progc.clear()
    except ShafaError as e:
        e.stage = "c"
        raise
    rep_c = StageReport(
        module="c", n_blocks=geo.n_blocks, sizes_before=stream_sizes,
        sizes_after=payload_sizes,
        runtime_ms=(time.perf_counter() - t2) * 1e3, generated=[path_shafa])
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
        return compress_pipeline_streaming(path, force_rle, force_freq,
                                           block_size, backend)

    t0 = time.perf_counter()
    with tracing.span("shafa.pipeline.f"):
        if not os.path.isfile(path):
            raise FileInaccessibleError(path)
        geo = geometry.geometry_for_file(path, block_size)
        if geo.total < geometry.MIN_FILE_SIZE:
            raise FileTooSmallError(path)
        sizes = geo.sizes()
        blocks = _read_blocks(path, sizes, "input")

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
            with tracing.span("shafa.io.write.rle"), \
                    _AtomicFile(path_rle) as fp:
                fp.write(rle_flat.tobytes())
            freqs = backend.fused_rle_hists(handle)
            path_rle_freq = formats.add_ext(path_rle, formats.FREQ_EXT)
            with tracing.span("shafa.io.write.freq"), \
                    _AtomicFile(path_rle_freq) as fp:
                formats.write_freq_arrays(fp, "R", rle_sizes, freqs)
            generated += [path_rle, path_rle_freq]
            mode, stream_sizes = "R", [int(s) for s in rle_sizes]
        if force_freq or not compress_rle:
            nfreqs = backend.fused_raw_hists(handle)
            path_freq = formats.add_ext(path, formats.FREQ_EXT)
            with tracing.span("shafa.io.write.freq"), \
                    _AtomicFile(path_freq) as fp:
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
        with tracing.span("shafa.pipeline.t"):
            tables = codes_mod.build_code_tables(freqs)
            path_cod = formats.add_ext(data_path, formats.CODES_EXT)
            with tracing.span("shafa.io.write.cod"), \
                    _AtomicFile(path_cod) as fp:
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
        with tracing.span("shafa.pipeline.c"):
            payloads = backend.fused_pack(handle, tables, compress_rle,
                                          host_row)
            path_shafa = formats.add_ext(data_path, formats.SHAFA_EXT)
            with tracing.span("shafa.io.write.shaf"), \
                    _AtomicFile(path_shafa) as fp:
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

@tracing.spanned("shafa.pipeline.t")
def module_t(path: str) -> tuple[str, StageReport]:
    t0 = time.perf_counter()
    mode, block_sizes, freqs = formats.parse_freq_arrays(
        _open_read(formats.add_ext(path, formats.FREQ_EXT), "freq"))
    tables = codes_mod.build_code_tables(freqs)
    path_cod = formats.add_ext(path, formats.CODES_EXT)
    with tracing.span("shafa.io.write.cod"), _AtomicFile(path_cod) as fp:
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

@tracing.spanned("shafa.pipeline.c")
def module_c(path: str, backend: Backend) -> tuple[str, StageReport]:
    t0 = time.perf_counter()
    _, block_sizes, tables = formats.parse_cod_tables(
        _open_read(formats.add_ext(path, formats.CODES_EXT), "cod"))
    if not os.path.isfile(path):
        raise FileInaccessibleError(path)
    blocks = _read_blocks(path, block_sizes, _data_kind(path))
    payloads = backend.pack(blocks, tables)
    path_shafa = formats.add_ext(path, formats.SHAFA_EXT)
    with tracing.span("shafa.io.write.shaf"), \
            _AtomicFile(path_shafa) as fp:
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

@tracing.spanned("shafa.pipeline.d")
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
    if (getattr(backend, "supports_fused", False)
            and _over_stream_threshold(path)):
        return _module_d_shafa_streaming(path, path_wrt, block_sizes,
                                         tables, rle_decompression,
                                         backend, t0)
    payloads = formats.parse_shaf_frames(_open_read(path, "shaf"))
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
    with tracing.span("shafa.io.write.restored"), \
            _AtomicFile(path_wrt) as fp:
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


def _module_d_shafa_streaming(path, path_wrt, block_sizes, tables,
                              rle_decompression, backend, t0
                              ) -> tuple[str, StageReport]:
    """Bounded-memory decode: one device batch of frames resident at a
    time. Copy of shafa_tpu/pipeline.py:856-935.

    Mirrors compress_pipeline_streaming for module D (the reference keeps
    exactly one block resident, d.c:694-763): frames are read incrementally
    (formats.iter_shaf_frames_file), decoded+expanded batch-wise, and
    appended to the output file. Peak host memory is one batch of payloads
    plus its decoded output regardless of archive size. Output bytes are
    identical to the resident path's (tests/test_torch_streaming.py)."""
    n_blocks = len(block_sizes)
    bsz = _decode_batch_blocks(block_sizes)
    sizes_before: list[int] = []
    sizes_after: list[int] = []

    def read_frames(frames, n):
        payloads = []
        start = in_fp.tell()
        for _ in range(n):
            try:
                payloads.append(next(frames))
            except StopIteration:
                raise FileUnrecognizableError(
                    "block count mismatch .shaf vs .cod") from None
        tracing.count("file_read_bytes", in_fp.tell() - start)
        return payloads

    try:
        # frame read-ahead / output write-behind
        ov = _Overlap("shaf", "restored")
        try:
            with open(path, "rb") as in_fp:
                frames = formats.iter_shaf_frames_file(in_fp)
                with _AtomicFile(path_wrt) as out_fp:
                    done = 0
                    ov.prefetch(read_frames, frames, min(bsz, n_blocks))
                    while done < n_blocks:
                        hi = min(done + bsz, n_blocks)
                        payloads = ov.take()
                        if hi < n_blocks:
                            ov.prefetch(read_frames, frames,
                                        min(hi + bsz, n_blocks) - hi)
                        out_blocks = backend.fused_decode(
                            payloads, _sub_tables(tables, done, hi),
                            block_sizes[done:hi], expand=rle_decompression)

                        def write_batch(out_blocks=out_blocks):
                            for b in out_blocks:
                                out_fp.write(b.tobytes())
                        sizes_after.extend(b.size for b in out_blocks)
                        sizes_before.extend(len(pay) for pay in payloads)
                        ov.write(write_batch)
                        done = hi
                    ov.drain()
                    # archive must not have extra frames (iter raises on
                    # trailing bytes only when driven to exhaustion)
                    if next(frames, None) is not None:
                        raise FileUnrecognizableError(
                            "block count mismatch .shaf vs .cod")
        finally:
            ov.close()
    except OSError as e:
        raise FileInaccessibleError(str(e)) from e
    report = StageReport(
        module="d", n_blocks=n_blocks,
        sizes_before=sizes_before, sizes_after=sizes_after,
        runtime_ms=(time.perf_counter() - t0) * 1e3,
        generated=[path_wrt],
        extra={"algo": "shafa_rle" if rle_decompression else "shafa",
               "streaming": True},
    )
    return path_wrt, report


@tracing.spanned("shafa.pipeline.d")
def module_d_rle(path: str, backend: Backend) -> tuple[str, StageReport]:
    t0 = time.perf_counter()
    freq = formats.parse_freq(_open_read(formats.add_ext(path,
                                                         formats.FREQ_EXT),
                                         "freq"))
    if freq.mode != "R":
        raise FileUnrecognizableError(".freq mode must be R for RLE decode")
    path_wrt = formats.rm_ext(path)
    if _over_stream_threshold(path):
        return _module_d_rle_streaming(path, path_wrt, freq, backend, t0)
    blocks = _read_blocks(path, freq.block_sizes, "rle")
    out_blocks = backend.rle_expand(blocks)
    with tracing.span("shafa.io.write.restored"), \
            _AtomicFile(path_wrt) as fp:
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


def _module_d_rle_streaming(path, path_wrt, freq, backend, t0
                            ) -> tuple[str, StageReport]:
    """Bounded-memory RLE-only decode: one batch of .rle blocks resident at
    a time (the reference keeps one block, d.c:322-352), with read-ahead /
    write-behind overlap like the .shaf streaming decode. Copy of
    shafa_tpu/pipeline.py:961-1020."""
    block_sizes = freq.block_sizes
    n_blocks = len(block_sizes)
    bsz = _decode_batch_blocks(block_sizes)
    offs = [0]
    for s in block_sizes:
        offs.append(offs[-1] + s)
    sizes_after: list[int] = []

    def read_batch(fp, lo, hi):
        fp.seek(offs[lo])
        buf = fp.read(offs[hi] - offs[lo])
        tracing.count("file_read_bytes", len(buf))
        if len(buf) < offs[hi] - offs[lo]:
            raise FileUnrecognizableError("truncated .rle")
        out, pos = [], 0
        for s in block_sizes[lo:hi]:
            out.append(np.frombuffer(buf, np.uint8, count=s, offset=pos))
            pos += s
        return out

    try:
        ov = _Overlap("rle", "restored")
        try:
            with open(path, "rb") as in_fp, _AtomicFile(path_wrt) as out_fp:
                done = 0
                if n_blocks:
                    ov.prefetch(read_batch, in_fp, 0, min(bsz, n_blocks))
                while done < n_blocks:
                    hi = min(done + bsz, n_blocks)
                    blocks = ov.take()
                    if hi < n_blocks:
                        ov.prefetch(read_batch, in_fp, hi,
                                    min(hi + bsz, n_blocks))
                    out_blocks = backend.rle_expand(blocks)

                    def write_batch(out_blocks=out_blocks):
                        for b in out_blocks:
                            out_fp.write(b.tobytes())
                    sizes_after.extend(b.size for b in out_blocks)
                    ov.write(write_batch)
                    done = hi
                ov.drain()
        finally:
            ov.close()
    except OSError as e:
        raise FileInaccessibleError(str(e)) from e
    report = StageReport(
        module="d", n_blocks=n_blocks, sizes_before=block_sizes,
        sizes_after=sizes_after,
        runtime_ms=(time.perf_counter() - t0) * 1e3,
        generated=[path_wrt],
        extra={"algo": "rle", "streaming": True},
    )
    return path_wrt, report
