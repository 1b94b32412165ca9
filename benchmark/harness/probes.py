"""Spans and timers that the traced run puts around the program's
functions from outside (by setattr, removed after the window).

Copy of the idea of ``shafa_tpu_torch/profile_main_path.py::stage_timers``
without its synchronisations: each wrapped function becomes a
``record_function`` span in the profiler's trace, and three kinds of
wrapper also time:

  * the pipeline entries the CLI calls (``compress_pipeline``,
    ``module_d_shafa``): their wall, and which thread runs them;
  * the public methods of the backend classes: the time the pipeline's
    thread spends inside them, outermost calls only (a method that calls
    another counts once; the sharded backend's workers do not count).

Nothing here runs in an untraced run.
"""

from __future__ import annotations

import functools
import inspect
import threading
import time

from torch.profiler import record_function

#: (module, owner inside it or "", function) of the host spans.
HOST_SPANS = [
    ("cli", "", "_make_backend"),
    ("pipeline", "", "_read_blocks"), ("pipeline", "", "_open_read"),
    ("formats", "", "write_freq_arrays"), ("formats", "", "write_cod_tables"),
    ("formats", "", "write_shaf_header"), ("formats", "", "write_shaf_block"),
    ("formats", "", "parse_cod_tables"), ("formats", "", "parse_shaf_frames"),
    ("codes", "", "build_code_tables"),
    ("device", "", "_stack_blocks"), ("device", "", "tables_to_device"),
    ("device", "", "download_packed"),
    ("device", "TorchBackend", "_upload"),
    ("device", "TorchBackend", "_download_rows"),
    ("device", "TorchBackend", "_pack_rows"),
    ("device", "TorchBackend", "_expand_rows"),
    ("device", "TorchBackend", "_decode_group"),
]
PIPELINE_ENTRIES = [("pipeline", "compress_pipeline"),
                    ("pipeline", "module_d_shafa")]
BACKEND_CLASSES = [("device", "TorchBackend"), ("dist", "ShardedBackend")]


class Probes:
    def __init__(self, modules: dict):
        """modules: the program's modules by short name (cli, pipeline,
        formats, codes, device, dist)."""
        self.modules = modules
        self.pipeline_s = 0.0
        self.backend_s = 0.0
        self._thread = None
        self._local = threading.local()
        self._saved = []

    def reset(self) -> None:
        self.pipeline_s = 0.0
        self.backend_s = 0.0

    def _wrap(self, owner, attr: str, make) -> None:
        raw = owner.__dict__.get(attr)
        fn = raw.__func__ if isinstance(raw, staticmethod) else raw
        if not inspect.isfunction(fn) or inspect.isgeneratorfunction(fn):
            return
        wrapped = functools.wraps(fn)(make(fn))
        setattr(owner, attr, staticmethod(wrapped)
                if isinstance(raw, staticmethod) else wrapped)
        self._saved.append((owner, attr, raw))

    @staticmethod
    def _span(name: str):
        def make(fn):
            def w(*args, **kwargs):
                with record_function(name):
                    return fn(*args, **kwargs)
            return w
        return make

    def _entry(self, name: str):
        def make(fn):
            def w(*args, **kwargs):
                self._thread = threading.get_ident()
                t0 = time.perf_counter()
                try:
                    with record_function(name):
                        return fn(*args, **kwargs)
                finally:
                    self.pipeline_s += time.perf_counter() - t0
                    self._thread = None
            return w
        return make

    def _method(self, name: str):
        def make(fn):
            def w(*args, **kwargs):
                depth = getattr(self._local, "depth", 0)
                timed = depth == 0 and threading.get_ident() == self._thread
                self._local.depth = depth + 1
                t0 = time.perf_counter()
                try:
                    with record_function(name):
                        return fn(*args, **kwargs)
                finally:
                    self._local.depth = depth
                    if timed:
                        self.backend_s += time.perf_counter() - t0
            return w
        return make

    def install(self) -> None:
        m = self.modules
        for mod, owner, attr in HOST_SPANS:
            obj = getattr(m[mod], owner) if owner else m[mod]
            self._wrap(obj, attr, self._span(f"{owner or mod}.{attr}"))
        for mod, attr in PIPELINE_ENTRIES:
            self._wrap(m[mod], attr, self._entry(f"pipeline.{attr}"))
        for mod, cls_name in BACKEND_CLASSES:
            cls = getattr(m[mod], cls_name)
            for attr in list(cls.__dict__):
                if not attr.startswith("_"):
                    self._wrap(cls, attr, self._method(
                        f"{cls_name}.{attr}"))

    def remove(self) -> None:
        for owner, attr, raw in reversed(self._saved):
            setattr(owner, attr, raw)
        self._saved.clear()
