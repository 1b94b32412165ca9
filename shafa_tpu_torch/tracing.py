"""The port's own spans and counters.

Spans. ``span(name)`` is ``torch.profiler.record_function(name)`` while a
torch profiler records, and one shared no-op context otherwise, so the
spans land in the profiler's trace beside the card's kernels and copies,
on the trace's clock, and cost next to nothing when no profiler runs (a
dict lookup and an attribute read; ``record_function`` itself costs about
20 times that even with no profiler). A span never synchronises and never
allocates on the card. The names are ``shafa.<layer>.<step>``:

  * ``shafa.cli.main``, ``shafa.cli.make_backend``;
  * ``shafa.pipeline.f`` / ``.t`` / ``.c`` / ``.d``: the intervals that
    each module's ``runtime_ms`` covers;
  * ``shafa.io.read.<kind>`` / ``shafa.io.write.<kind>`` (kind: input,
    freq, cod, shaf, rle, restored): one file's open, reads or writes,
    close and rename;
  * ``shafa.overlap.wait_read`` / ``.wait_write``: the streaming drivers'
    waits on their read-ahead and write-behind threads, and the resident
    compress's wait, at its end, for the ``.rle`` written behind modules
    T and C;
  * ``shafa.codes.build``;
  * ``shafa.backend.stack``, ``.h2d``, ``.d2h`` (the host's wait for the
    card and the copy), ``.encode_batch``, ``.pack_batch``,
    ``.decode_batch`` (a batch of codes of at most 16 bits),
    ``.decode_batch32`` (17-32 bits);
  * ``shafa.backend.tables``: one batch's tables made ready on the card
    (the pack's packed sizes and K1's tables, built on the host and
    uploaded; a decode batch's code lengths and codes uploaded and K9's
    launch, which builds its K2 or K5 tables there);
  * ``shafa.dist.run``: on the calling thread, one call of
    ``dist.ShardedBackend`` from handing its parts to the devices' workers
    to the last result; ``shafa.dist.join``: each join of the parts'
    results in block order;
  * ``shafa.dist.worker.<k>``: one call on a worker thread of
    ``dist.ShardedBackend``.

torch.profiler records only the thread that started it, unless it was
started with ``profile_all_threads``, as ``--profile`` starts it: the
spans of worker threads are then in the trace too. A profiler of the
calling thread alone (the benchmark's) holds ``shafa.dist.run`` and
``.join`` but no ``shafa.dist.worker.<k>``, and none of the spans the
one-device backends give on the workers.

Counters. ``count(name, n)`` adds n to a counter under a lock, always on.
``decode_blocks16`` and ``decode_blocks32`` count the blocks that decode
on the card through each route, ``host_decoded_blocks`` those decoded on
the host; the three add up to the blocks a call decodes.
``decode_table_rows_on_device`` counts the rows whose decode tables K9
built on the card: there it equals ``decode_blocks16 + decode_blocks32``,
and on the CPU, where the tables' plain version runs, it stays 0.
``writes_behind`` counts the writes handed to a writer thread
(``pipeline._WriteBehind``): one a batch in the streaming drivers, and 1
in a resident compress whose RLE gate keeps the ``.rle``.
``dist_parts`` and ``dist_join_bytes`` appear only when a call runs on
``dist.ShardedBackend``: the non-empty block ranges its calls' blocks are
cut into (a fused encode's later calls reuse its ranges and add none),
and the bytes the host copies to join the devices' arrays.
``cli.main`` calls ``reset()`` at its start, so ``counters()`` gives the
last call's (``--json`` reports them under ``"counters"``).
"""

from __future__ import annotations

import contextlib
import functools
import sys
import threading

#: The counters that ``reset`` sets to 0.
COUNTERS = (
    "h2d_bytes", "h2d_pageable_bytes", "h2d_copies",
    "d2h_bytes", "d2h_pageable_bytes", "d2h_copies",
    "encode_batches", "pack_batches", "decode_batches",
    "file_read_bytes", "file_written_bytes",
    "decode_blocks16", "decode_blocks32", "host_decoded_blocks",
    "decode_table_rows_on_device", "writes_behind",
)

_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
_counts = dict.fromkeys(COUNTERS, 0)


def recording() -> bool:
    """True while a torch profiler records (set on every thread at its
    start; False where torch was never imported)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    shared no-op context."""
    if recording():
        from torch.profiler import record_function
        return record_function(name)
    return _NOOP


def spanned(name: str):
    """Decorator: every call of the function in ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def reset() -> None:
    with _lock:
        _counts.clear()
        _counts.update(dict.fromkeys(COUNTERS, 0))


def counters() -> dict[str, int]:
    """The counters since the last ``reset``."""
    with _lock:
        return dict(_counts)
