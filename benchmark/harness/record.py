"""What a run records, and what the metric readers read.

A metric is the module ``metrics/<name>.py``; its ``read(run)`` takes the
``Run`` below and returns a number, or None where the run holds nothing to
read it from (the harness then leaves the metric out of the result).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Call:
    """One timed ``cli.main`` call of the window."""
    direction: str            # "compress" or "decompress"
    index: int                # round trip number in the window
    pool_index: int           # which pool file
    file_bytes: int           # size of the pool file (input, or restored)
    wall_s: float             # host clock around cli.main, closed after a sync
    rc: int                   # cli.main's return, or -1 if it raised
    outputs: dict             # suffix -> (bytes, blake2b hex) written
    start_s: float = 0.0      # perf_counter at the call's start
    # traced runs only
    pipeline_s: float | None = None   # wall of the pipeline entry
    backend_s: float | None = None    # its thread's time in backend methods
    module_t_ms: float | None = None  # module T's runtime_ms (--json)
    span_us: tuple | None = None      # (start, end) on the trace's clock


@dataclasses.dataclass
class DeviceEvent:
    device: int
    cat: str                  # kernel, gpu_memcpy or gpu_memset
    name: str
    start_us: float
    end_us: float


@dataclasses.dataclass
class Span:
    name: str
    start_us: float
    end_us: float


@dataclasses.dataclass
class Run:
    workload: str
    config: dict
    traffic: dict
    seconds: float
    chips: int
    device_kind: str
    calls: list
    setup_s: float
    window_s: float
    traced: bool = False
    device_events: list = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)

    def of(self, direction: str) -> list:
        return [c for c in self.calls if c.direction == direction]
