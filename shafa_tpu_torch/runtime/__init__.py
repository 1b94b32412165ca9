"""Native host runtime: ctypes bindings for runtime.cpp, with auto-build.

Copy of shafa_tpu/runtime/__init__.py:1-227. `lib()` returns the loaded
library, building it with g++ on first use into ``shafa_tpu_torch/_build/``
(git-ignored) under a name keyed on a hash of the source and flags, never
next to the source. All callers must be prepared for `lib()` -> None (no
compiler, or SHAFA_NO_NATIVE set): every consumer falls back to the
pure-Python implementations in codes.py / formats.py, which remain the spec.
This is host format code; the device path does not depend on it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().with_name("runtime.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

_c8 = ctypes.c_char
_i64 = ctypes.c_int64
_p_i64 = ctypes.POINTER(ctypes.c_int64)
_p_u8 = ctypes.POINTER(ctypes.c_uint8)
_p_u64 = ctypes.POINTER(ctypes.c_uint64)
_p_char = ctypes.c_char_p
_pp_char = ctypes.POINTER(ctypes.c_char_p)


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libshafa_rt_{h.hexdigest()[:16]}.so"


def build() -> str | None:
    """Compile runtime.cpp unless a library of the same source exists;
    returns its path, or None when g++ is missing or fails."""
    so = _library_path()
    if so.exists():
        return str(so)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if r.returncode != 0:
        print(f"shafa_tpu_torch.runtime: native build failed:\n{r.stderr}",
              file=sys.stderr)
        return None
    os.replace(tmp, so)
    return str(so)


def lib() -> ctypes.CDLL | None:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("SHAFA_NO_NATIVE"):
            return None
        so = build()
        if so is None:
            return None
        L = ctypes.CDLL(so)
        L.sf_buf_free.argtypes = [ctypes.c_void_p]
        L.sf_build_codes.argtypes = [_i64, _p_i64, _p_u8, _p_u64]
        L.sf_build_codes.restype = ctypes.c_int
        L.sf_write_freq.argtypes = [_c8, _i64, _p_i64, _p_i64, _pp_char,
                                    _p_i64]
        L.sf_write_freq.restype = ctypes.c_int
        L.sf_parse_freq_header.argtypes = [_p_char, _i64,
                                           ctypes.POINTER(_c8), _p_i64]
        L.sf_parse_freq_header.restype = ctypes.c_int
        L.sf_parse_freq.argtypes = [_p_char, _i64, _i64, _p_i64, _p_i64]
        L.sf_parse_freq.restype = ctypes.c_int
        L.sf_write_cod.argtypes = [_c8, _i64, _p_i64, _p_u8, _p_u64,
                                   _pp_char, _p_i64]
        L.sf_write_cod.restype = ctypes.c_int
        L.sf_parse_cod_header.argtypes = [_p_char, _i64,
                                          ctypes.POINTER(_c8), _p_i64]
        L.sf_parse_cod_header.restype = ctypes.c_int
        L.sf_parse_cod.argtypes = [_p_char, _i64, _i64, _p_i64, _p_u8,
                                   _p_u64]
        L.sf_parse_cod.restype = ctypes.c_int
        L.sf_parse_shaf_header.argtypes = [_p_char, _i64, _p_i64]
        L.sf_parse_shaf_header.restype = ctypes.c_int
        L.sf_parse_shaf_frames.argtypes = [_p_char, _i64, _i64, _p_i64,
                                           _p_i64]
        L.sf_parse_shaf_frames.restype = ctypes.c_int
        _lib = L
        return _lib


def available() -> bool:
    return lib() is not None


def _as_i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _take_buf(L, out: ctypes.c_char_p, n: int) -> bytes:
    data = ctypes.string_at(out, n)
    L.sf_buf_free(out)
    return data


# ---------------------------------------------------------------------------
# High-level wrappers (numpy in / numpy or bytes out)
# ---------------------------------------------------------------------------

def build_codes(freqs: np.ndarray):
    """(n, 256) int64 freqs -> (lens (n,256) uint8, vals (n,256) uint64).

    Returns None if the native library is unavailable or a code would exceed
    64 bits (callers fall back to codes.build_codes).
    """
    L = lib()
    if L is None:
        return None
    f = _as_i64(freqs)
    n = f.shape[0]
    lens = np.empty((n, 256), np.uint8)
    vals = np.empty((n, 256), np.uint64)
    r = L.sf_build_codes(n, f.ctypes.data_as(_p_i64),
                         lens.ctypes.data_as(_p_u8),
                         vals.ctypes.data_as(_p_u64))
    if r != 0:
        return None
    return lens, vals


def write_freq(mode: str, sizes, freqs) -> bytes | None:
    L = lib()
    if L is None:
        return None
    s = _as_i64(sizes)
    f = _as_i64(freqs)
    out = ctypes.c_char_p()
    out_len = _i64()
    r = L.sf_write_freq(mode.encode()[0], s.size,
                        s.ctypes.data_as(_p_i64), f.ctypes.data_as(_p_i64),
                        ctypes.byref(out), ctypes.byref(out_len))
    if r != 0:
        return None
    return _take_buf(L, out, out_len.value)


def parse_freq(data: bytes):
    """bytes -> (mode, sizes (n,) i64, freqs (n,256) i64) or None on any
    failure (caller falls back to formats.parse_freq for exact diagnostics)."""
    L = lib()
    if L is None:
        return None
    mode = _c8()
    n = _i64()
    if L.sf_parse_freq_header(data, len(data), ctypes.byref(mode),
                              ctypes.byref(n)) != 0:
        return None
    sizes = np.empty(n.value, np.int64)
    freqs = np.empty((n.value, 256), np.int64)
    if L.sf_parse_freq(data, len(data), n.value,
                       sizes.ctypes.data_as(_p_i64),
                       freqs.ctypes.data_as(_p_i64)) != 0:
        return None
    return mode.value.decode(), sizes, freqs


def write_cod(mode: str, sizes, lens: np.ndarray,
              vals: np.ndarray) -> bytes | None:
    L = lib()
    if L is None:
        return None
    s = _as_i64(sizes)
    ln = np.ascontiguousarray(lens, np.uint8)
    vl = np.ascontiguousarray(vals, np.uint64)
    out = ctypes.c_char_p()
    out_len = _i64()
    r = L.sf_write_cod(mode.encode()[0], s.size,
                       s.ctypes.data_as(_p_i64), ln.ctypes.data_as(_p_u8),
                       vl.ctypes.data_as(_p_u64),
                       ctypes.byref(out), ctypes.byref(out_len))
    if r != 0:
        return None
    return _take_buf(L, out, out_len.value)


def parse_cod(data: bytes):
    """bytes -> (mode, sizes, lens (n,256) u8, vals (n,256) u64) or None."""
    L = lib()
    if L is None:
        return None
    mode = _c8()
    n = _i64()
    if L.sf_parse_cod_header(data, len(data), ctypes.byref(mode),
                             ctypes.byref(n)) != 0:
        return None
    sizes = np.empty(n.value, np.int64)
    lens = np.empty((n.value, 256), np.uint8)
    vals = np.empty((n.value, 256), np.uint64)
    if L.sf_parse_cod(data, len(data), n.value,
                      sizes.ctypes.data_as(_p_i64),
                      lens.ctypes.data_as(_p_u8),
                      vals.ctypes.data_as(_p_u64)) != 0:
        return None
    return mode.value.decode(), sizes, lens, vals


def parse_shaf(data: bytes):
    """bytes -> (offsets (n,) i64, sizes (n,) i64) into `data`, or None."""
    L = lib()
    if L is None:
        return None
    n = _i64()
    if L.sf_parse_shaf_header(data, len(data), ctypes.byref(n)) != 0:
        return None
    offs = np.empty(n.value, np.int64)
    sizes = np.empty(n.value, np.int64)
    if L.sf_parse_shaf_frames(data, len(data), n.value,
                              offs.ctypes.data_as(_p_i64),
                              sizes.ctypes.data_as(_p_i64)) != 0:
        return None
    return offs, sizes
