"""Build and bind the CUDA kernels (K1-K8).

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects into one shared library
with a plain C interface, loaded through ``ctypes``. The build runs at first
use, never at import, and lands in ``shafa_tpu_torch/_build/`` (git-ignored)
under a name keyed on a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once; what ``-Xptxas -v`` reports of
each kernel's registers and spills is kept beside the library
(``resources``). Every kernel launches through ``launch``, under its
tensors' device as the current one and on torch's current stream there,
so a backend may drive several cards from several threads. A failed build
or a launch that returns a CUDA error raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: Launches per kernel: ``launch`` adds one to its kernel's count.
launches = {"emit_bits": 0, "emit_coded": 0, "rank": 0, "fsm_decode": 0,
            "expand_sizes": 0, "expand": 0, "rank32": 0, "fsm32": 0,
            "fsm_packs": 0, "rle_encode": 0}

#: Seconds the last build took (0.0 when the library was already built).
build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "shafa_emit_tile_lanes": [],
    "shafa_emit": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _L, _P, _P, _L, _P],
    "shafa_rank_lut_entries": [],
    "shafa_rank_planes": [_P, _P, _P, _P, _I, _L, _P, _P],
    "shafa_fsm_decode_tile_bytes": [],
    "shafa_fsm_decode": [_P, _P, _P, _I, _I, _L, _P, _P, _P, _P, _L, _P, _P],
    "shafa_fsm_packs": [_P, _P, _P, _I, _I, _L, _P, _P, _P, _P, _P, _P, _P],
    "shafa_expand_tile_bytes": [],
    "shafa_expand_sizes": [_P, _P, _I, _L, _P, _P, _P, _P, _P, _P],
    "shafa_expand": [_P, _P, _I, _L, _P, _P, _P, _P, _L, _P],
    "shafa_rank32_tile_bytes": [],
    "shafa_rank_planes32": [_P, _P, _P, _P, _P, _P, _I, _L, _P, _P],
    "shafa_fsm32_tile_bytes": [],
    "shafa_fsm32": [_P, _P, _P, _I, _L, _P, _P, _P, _P, _P, _P, _P],
    "shafa_rle_encode_tile_bytes": [],
    "shafa_rle_encode": [_P, _P, _I, _L, _P, _P, _P, _L, _P, _P, _P],
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"libshafa_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    global build_seconds
    so = _library_path()
    if so.exists():
        build_seconds = 0.0
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    sources = sorted(_CSRC.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    t0 = time.perf_counter()
    nvcc = _nvcc()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src, obj in zip(sources, objs)]
    errors, report = [], []
    for proc in procs:
        out, err = proc.communicate()
        report.append(out + err)
        if proc.returncode != 0:
            errors.append(f"nvcc {proc.args[-1]} failed ({proc.returncode}):"
                          f"\n{err}")
    try:
        if errors:
            raise RuntimeError("\n".join(errors))
        r = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                            *map(str, objs)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    so.with_suffix(".ptxas.txt").write_text("".join(report))
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    return so


_LENGTH = re.compile(r"\d+")
_TEMPLATE = re.compile(r"I((?:L[a-z]+\d+E)+)E")


def _kernel_name(mangled: str) -> str:
    """A kernel's name from its mangled one: the last length-prefixed name
    of a nested name (_ZN ... E, after any namespaces, anonymous ones
    included), or the name after _Z; a template's literal arguments follow
    it as <1,0>."""
    m = re.match(r"_ZN?", mangled)
    pos = m.end() if m else 0
    name = mangled
    while m := _LENGTH.match(mangled, pos):
        pos = m.end() + int(m.group())
        name = mangled[m.end():pos]
        if not mangled.startswith("_ZN"):
            break
    if m := _TEMPLATE.match(mangled, pos):
        name += "<" + ",".join(_LENGTH.findall(m.group(1))) + ">"
    return name


def resources(prefix: str) -> dict[str, tuple[int, int, int]]:
    """{kernel: (registers, spill store bytes, spill load bytes)} of the
    built kernels whose names start with prefix, as ``nvcc -Xptxas -v``
    reported them when the library was built."""
    text = build().with_suffix(".ptxas.txt").read_text()
    found, name, spills = {}, None, (0, 0)
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = _kernel_name(m.group(1))
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            if name.startswith(prefix):
                found[name] = (int(m.group(1)), *spills)
            name, spills = None, (0, 0)
    return found


def loaded() -> bool:
    """Whether library() has loaded the kernels in this process."""
    return _lib is not None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def stream(device) -> int:
    """Handle of torch's current stream on device: kernels launch there."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def launch(kernel: str, device, entry: str, *args) -> None:
    """Call the C entry point ``entry`` with args and the handle of torch's
    current stream on device, with device made the current one first (CUDA
    launches on the calling thread's current device), and add one to
    launches[kernel]. A returned CUDA error raises."""
    import torch
    fn = getattr(library(), entry)
    with torch.cuda.device(device):
        with _count_lock:
            launches[kernel] += 1
        check(fn(*args, stream(device)), kernel)


def ptr(t, dtype, shape, device) -> int:
    """Data pointer of a kernel argument, once it is what the kernel takes."""
    if (t.device != device or t.dtype != dtype
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(
            f"kernel argument: need a contiguous {dtype} {tuple(shape)} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if device.type != "cuda":
        raise ValueError(f"kernel argument on {device}: CUDA tensors only")
    return t.data_ptr()


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0
