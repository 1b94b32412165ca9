"""CLI of the port: ``python -m shafa_tpu_torch``, flag-compatible with
``python -m shafa_tpu`` (shafa_tpu/cli.py) and the reference.

Flags: <file>  -m f|t|c|d (repeatable)  -b K|m|M  -c r|f  -d s|r
       --no-multithread (one block per device batch, the fused tier off)
Extra (not in the reference): --backend numpy|torch (default torch),
--check (cross-verify every device stage against the numpy oracle),
--json PATH|- (structured per-module metrics, and the call's counters of
tracing.py), --profile DIR (a torch.profiler trace of the run, host
activity, with the port's spans (tracing.py) on every thread, and, on a
CUDA device, the card's, written into DIR as TensorBoard's
``*.pt.trace.json``, which Perfetto opens too).

Differences from the JAX package's CLI:
  * ``--backend jax`` is a syntax error;
  * the device is CUDA unless SHAFA_TORCH_DEVICE names another (``cpu`` in
    the tests); without CUDA and without that variable the CLI exits 1 with
    "CUDA device not available".

Several devices and several processes (shafa_tpu/cli.py:203-209, 215-284):
  * with more than one visible CUDA device (SHAFA_TORCH_DEVICE unset or
    ``cuda``) and without --no-multithread, the blocks of every call are
    spread over all of them (dist.ShardedBackend);
  * with COORDINATOR_ADDRESS (host:port), NUM_PROCESSES and PROCESS_ID set,
    or SHAFA_MULTIHOST=1 under torchrun, the process joins a gloo process
    group (multihost.init_from_env) and the full compress chain and the
    .shaf decompress run through pipeline.compress_multihost and
    pipeline.decompress_multihost, each process on a contiguous
    range of the blocks and on its own visible devices. A join that fails
    exits 1; nothing goes on as a single process.

Inputs above pipeline.STREAM_THRESHOLD (256 MiB, or SHAFA_STREAM_THRESHOLD)
take the streaming pipelines, as in the JAX package: the pipeline branches to
them, with no check here.

Defaulting (shafa.c:293-305): with no -m, a .shaf input runs D only, anything
else runs F+T+C; with no -b the block size is 64 KiB. Module-chain legality,
messages and exit codes are those of shafa_tpu/cli.py:226-397, which follows
the reference's execute_modules. Exit status: 0 on success, 1 on any error
(shafa.c:310-316).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

from . import formats, geometry, pipeline, tracing
from .errors import Code, ShafaError, error_msg
from .pipeline import StageReport

BANNER = [
    "shafa_tpu_torch: Shafa-format lossless codec",
    "PyTorch/CUDA implementation (reference: Fytex/Shafa-CD)",
]

BACKENDS = ("numpy", "torch")


@dataclasses.dataclass
class Options:
    """Parsed flags. Copy of shafa_tpu/cli.py:34-49."""
    block_size: int = 0
    module_f: bool = False
    module_t: bool = False
    module_c: bool = False
    module_d: bool = False
    f_force_rle: bool = False
    f_force_freq: bool = False
    d_shaf: bool = False
    d_rle: bool = False
    no_multithread: bool = False
    backend: str = "torch"
    check: bool = False
    json_path: str = ""
    profile_dir: str = ""


def parse(argv: list[str]) -> tuple[Options, str | None] | None:
    """Reference parse() semantics (shafa.c:47-132), copy of
    shafa_tpu/cli.py:52-122 with the port's --backend values: returns None
    on syntax error; value flags must be separate argv entries of length 1."""
    opts = Options()
    file: str | None = None
    i = 0
    while i < len(argv):
        key = argv[i]
        if key == "--no-multithread":
            opts.no_multithread = True
        elif key == "--check":  # extension flag, not in the reference
            opts.check = True
        elif key == "--backend":  # extension flag, not in the reference
            i += 1
            if i >= len(argv) or argv[i] not in BACKENDS:
                return None
            opts.backend = argv[i]
        elif key == "--json":  # extension flag, not in the reference
            i += 1
            if i >= len(argv):
                return None
            opts.json_path = argv[i]
        elif key == "--profile":  # extension flag, not in the reference
            i += 1
            if i >= len(argv):
                return None
            opts.profile_dir = argv[i]
        elif not key.startswith("-"):
            if file is not None:
                return None
            file = key
        else:
            i += 1
            if i >= len(argv):
                return None
            value = argv[i]
            if len(key) != 2 or len(value) != 1:
                return None
            if key[1] == "m":
                if value == "f":
                    opts.module_f = True
                elif value == "t":
                    opts.module_t = True
                elif value == "c":
                    opts.module_c = True
                elif value == "d":
                    opts.module_d = True
                else:
                    return None
            elif key[1] == "b":
                if value not in geometry.BLOCK_SIZE_BY_FLAG:
                    return None
                opts.block_size = geometry.BLOCK_SIZE_BY_FLAG[value]
            elif key[1] == "c":
                if value == "r":
                    opts.f_force_rle = True
                elif value == "f":
                    opts.f_force_freq = True
                else:
                    return None
            elif key[1] == "d":
                if value == "s":
                    opts.d_shaf = True
                elif value == "r":
                    opts.d_rle = True
                else:
                    return None
            else:
                return None
        i += 1
    return opts, file


# Summaries: copies of shafa_tpu/cli.py:125-173 (the reference's stdout).

def _print_summary_f(r: StageReport) -> None:
    print("\n".join(BANNER))
    print("Module: f (calculation of symbol frequencies)")
    print(f"Number of blocks: {r.n_blocks}")
    print("Size of blocks analyzed in the original file: "
          + "/".join(map(str, r.sizes_before)))
    if r.extra.get("compress_rle"):
        size_f = r.extra["size_f"]
        size_rle = sum(r.sizes_after)
        ratio = (size_f - size_rle) / size_f * 100.0
        rle_path = r.generated[0]
        print(f"RLE Compression: {rle_path} ({ratio:f}% compression)")
        print("Size of blocks analyzed in the RLE file: "
              + "/".join(map(str, r.sizes_after)) + " bytes")
    print(f"Module runtime (milliseconds): {r.runtime_ms:f}")
    print("Generated files: " + ", ".join(r.generated))


def _print_summary_t(r: StageReport) -> None:
    print("\n".join(BANNER))
    print("Module: T (Calculation of symbol codes)")
    print(f"Number of blocks: {r.n_blocks}")
    print("Size of blocks analyzed in the symbol file: "
          + "/".join(map(str, r.sizes_before)) + " bytes")
    print(f"Module runtime (milliseconds): {r.runtime_ms:f}")
    print(f"Generated file {r.generated[0]}")


def _print_summary_c(r: StageReport) -> None:
    print("\n".join(BANNER))
    print("Module: C (Symbol codes' codification)")
    print(f"Number of blocks: {r.n_blocks}")
    for i, (a, b) in enumerate(zip(r.sizes_before, r.sizes_after)):
        pct = int(b / a * 100) if a else 0
        print(f"Size before/after & compression rate (Block {i}): {a}/{b} -> {pct}%")
    print(f"Module runtime (milliseconds): {r.runtime_ms:f}")
    print(f"Generated file {r.generated[0]}")


def _print_summary_d(r: StageReport) -> None:
    print("\n".join(BANNER))
    algo = r.extra.get("algo", "shafa")
    name = {"rle": "RLE decoding", "shafa": "SHAFA decoding",
            "shafa_rle": "SHAFA & RLE decoding"}[algo]
    print(f"Module: D ({name})")
    for i, (a, b) in enumerate(zip(r.sizes_before, r.sizes_after)):
        print(f"Size before/after generating file (block {i + 1}): {a}/{b}")
    print(f"Module runtime (in milliseconds): {r.runtime_ms:f}")
    print(f"Generated file {r.generated[0]}")


def _emit_json(path: str, reports: list[StageReport], error: int) -> None:
    """Structured metrics (copy of shafa_tpu/cli.py:447-471): per-module
    sizes, ratio, runtime and throughput; and the call's counters
    (tracing.counters: bytes copied each way and how many were pageable,
    batches, file bytes, blocks decoded on the host)."""
    out = {"error": int(error), "modules": [],
           "counters": tracing.counters()}
    for r in reports:
        before, after = sum(r.sizes_before), sum(r.sizes_after)
        out["modules"].append({
            "module": r.module,
            "n_blocks": r.n_blocks,
            "bytes_in": before,
            "bytes_out": after,
            "ratio": round(after / before, 6) if before else None,
            "runtime_ms": round(r.runtime_ms, 3),
            "throughput_mb_s": round(before / 1e3 / r.runtime_ms, 3)
            if r.runtime_ms else None,
            "generated": r.generated,
        })
    data = json.dumps(out, indent=2)
    if path == "-":
        print(data)
    else:
        with open(path, "w") as fp:
            fp.write(data)


@tracing.spanned("shafa.cli.make_backend")
def _make_backend(opts):
    """The NumPy backend, or the device backend over the blocks' devices
    (dist.block_devices: every visible CUDA card, or the one named), one
    of them with --no-multithread; --check wraps whichever was built."""
    if opts.backend == "numpy":
        backend = pipeline.NumpyBackend()
    else:
        from . import dist
        devices = dist.block_devices()
        if opts.no_multithread:
            devices = devices[:1]
        backend = dist.make_backend(devices, sequential=opts.no_multithread)
    if opts.check:
        backend = pipeline.CheckedBackend(backend)
    return backend


def _process_count() -> int:
    """Processes of the torch.distributed run (1 when none was joined)."""
    tdist = sys.modules.get("torch.distributed")
    return tdist.get_world_size() if tdist and tdist.is_initialized() else 1


def profiler(device_type: str, **kwargs):
    """torch.profiler.profile over the host's activity on every thread
    (so that the spans of dist.ShardedBackend's workers and of the
    streaming drivers' reader and writer are in it) and, for a CUDA
    device, the card's (kwargs go to it). --profile traces through it."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    return torch.profiler.profile(activities=acts,
                                  experimental_config=every_thread, **kwargs)


def _execute_multihost(opts, path: str, backend) -> int | None:
    """The multi-host branch of shafa_tpu/cli.py:215-284: the full
    compress chain and the .shaf decompress across the processes. Every
    process waits at a barrier for the others' writes before process 0
    reports. None for other module combinations, which run the one-process
    path on every process (the same files, written by each)."""
    from . import multihost
    comm = multihost.Comm()
    t0 = time.perf_counter()
    if opts.module_f and opts.module_t and opts.module_c \
            and not opts.module_d:
        try:
            out = pipeline.compress_multihost(
                path, opts.block_size, backend, comm,
                force_rle=opts.f_force_rle, force_freq=opts.f_force_freq)
        except ShafaError as e:
            print("Module f: Something went wrong while compressing with"
                  " RLE or creating frequencies' table...", file=sys.stderr)
            return e.code
        what = "compress"
    elif opts.module_d and not (opts.module_f or opts.module_t
                                or opts.module_c) \
            and formats.check_ext(path, formats.SHAFA_EXT) \
            and not opts.d_rle:
        try:
            out = pipeline.decompress_multihost(path, backend, comm)
        except ShafaError as e:
            print("Module d: Something went wrong while decompressing...",
                  file=sys.stderr)
            return e.code
        what = "decompress"
    else:
        return None
    comm.barrier()
    if comm.index == 0:
        print(f"Multihost {what} ({comm.count} hosts): {out} in "
              f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    return Code.SUCCESS


def execute_modules(opts, path: str,
                    reports: list[StageReport] | None = None) -> int:
    """Mirror of shafa_tpu/cli.py:226-397 (the reference's execute_modules,
    shafa.c:150-259)."""
    backend = _make_backend(opts)
    reports = reports if reports is not None else []
    decompressed = False

    if _process_count() > 1 and opts.backend != "numpy" and not opts.check:
        error = _execute_multihost(opts, path, backend)
        if error is not None:
            return error

    if opts.module_f and opts.module_t and opts.module_c:
        try:
            path, reps = pipeline.compress_pipeline(
                path, opts.f_force_rle, opts.f_force_freq, opts.block_size,
                backend)
        except ShafaError as e:
            stage = getattr(e, "stage", "f")
            if stage == "f":
                print("Module f: Something went wrong while compressing with"
                      " RLE or creating frequencies' table...",
                      file=sys.stderr)
            elif stage == "t":
                print("Module t: Something went wrong...", file=sys.stderr)
            else:
                print("Module c: Something went wrong...", file=sys.stderr)
            return e.code
        reports.extend(reps)
        _print_summary_f(reps[0])
        _print_summary_t(reps[1])
        _print_summary_c(reps[2])
        if not opts.module_d:
            return Code.SUCCESS
        opts = dataclasses.replace(opts, module_f=False, module_t=False,
                                   module_c=False)

    if opts.module_f:
        try:
            path, rep = pipeline.module_f(
                path, opts.f_force_rle, opts.f_force_freq, opts.block_size,
                backend)
        except ShafaError as e:
            print("Module f: Something went wrong while compressing with RLE"
                  " or creating frequencies' table...", file=sys.stderr)
            return e.code
        reports.append(rep)
        _print_summary_f(rep)

    if opts.module_t:
        if not opts.module_f:
            if formats.check_ext(path, formats.FREQ_EXT):
                path = formats.rm_ext(path)
            else:
                print(f"Module t: Wrong extension... Should end in "
                      f"{formats.FREQ_EXT}", file=sys.stderr)
                return Code.OUTSIDE_MODULE
        try:
            path, rep = pipeline.module_t(path)
        except ShafaError as e:
            print("Module t: Something went wrong...", file=sys.stderr)
            return e.code
        reports.append(rep)
        _print_summary_t(rep)

    if opts.module_c:
        if opts.module_f and not opts.module_t:
            print("Module c: Can't execute module 'c' after 'f' without"
                  " 't'...", file=sys.stderr)
            return Code.OUTSIDE_MODULE
        try:
            path, rep = pipeline.module_c(path, backend)
        except ShafaError as e:
            print("Module c: Something went wrong...", file=sys.stderr)
            return e.code
        reports.append(rep)
        _print_summary_c(rep)

    if opts.module_d:
        if ((opts.module_f and (not opts.module_t or not opts.module_c)
             and not formats.check_ext(path, formats.RLE_EXT))
                or (opts.module_t and not opts.module_c)):
            print("Module d: Can't execute module 'd' after 'f' without 't'"
                  " or 'c', nor execute it after 't'  without 'c'...",
                  file=sys.stderr)
            return Code.OUTSIDE_MODULE

        file_rle_shaf = False
        if opts.d_shaf or not opts.d_rle:
            if not formats.check_ext(path, formats.SHAFA_EXT):
                if opts.d_shaf:
                    print(f"Module d: Wrong extension... Should end in "
                          f"{formats.SHAFA_EXT}", file=sys.stderr)
                    return Code.OUTSIDE_MODULE
            else:
                if opts.d_rle:
                    if formats.check_ext(path,
                                         formats.RLE_EXT + formats.SHAFA_EXT):
                        file_rle_shaf = True
                    else:
                        print(f"Module d: Wrong extension... Should end in "
                              f"{formats.RLE_EXT + formats.SHAFA_EXT}",
                              file=sys.stderr)
                        return Code.OUTSIDE_MODULE
                rle = ((opts.d_rle or not opts.d_shaf)
                       and (file_rle_shaf
                            or formats.check_ext(
                                path, formats.RLE_EXT + formats.SHAFA_EXT)))
                try:
                    path, rep = pipeline.module_d_shafa(path, rle, backend)
                except ShafaError as e:
                    print("Module d: Something went wrong while"
                          " decompressing...", file=sys.stderr)
                    return e.code
                reports.append(rep)
                _print_summary_d(rep)
                decompressed = True

        if not decompressed and (opts.d_rle or not opts.d_shaf):
            if not formats.check_ext(path, formats.RLE_EXT):
                print(f"Module d: Wrong extension... Should end in "
                      f"{formats.RLE_EXT}", file=sys.stderr)
                return Code.OUTSIDE_MODULE
            try:
                path, rep = pipeline.module_d_rle(path, backend)
            except ShafaError as e:
                print("Module d: Something went wrong while decompressing...",
                      file=sys.stderr)
                return e.code
            reports.append(rep)
            _print_summary_d(rep)

    return Code.SUCCESS


def main(argv: list[str] | None = None) -> int:
    """The CLI; its counters (tracing.counters) are this call's."""
    tracing.reset()
    with tracing.span("shafa.cli.main"):
        return _main(argv)


def _main(argv: list[str] | None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("No file input", file=sys.stderr)
        return 1
    parsed = parse(argv)
    if parsed is None:
        print("Wrong Options' syntax", file=sys.stderr)
        return 1
    opts, file = parsed
    if file is None:
        print("No file input", file=sys.stderr)
        return 1
    device_type = "cpu"
    if opts.backend == "torch":
        from .device import DeviceUnavailableError, default_device
        try:
            device_type = default_device().type
        except DeviceUnavailableError as e:
            print(e, file=sys.stderr)
            return 1
    # Defaulting (shafa.c:293-305).
    if not (opts.module_f or opts.module_t or opts.module_c or opts.module_d):
        if formats.check_ext(file, formats.SHAFA_EXT):
            opts.module_d = True
        else:
            opts.module_f = opts.module_t = opts.module_c = True
    if not opts.block_size:
        opts.block_size = geometry.CLI_DEFAULT_BLOCK_SIZE

    # Multi-host (shafa_tpu/cli.py:417-420): join when the environment asks.
    joined = False
    if opts.backend != "numpy" and (os.environ.get("COORDINATOR_ADDRESS")
                                    or os.environ.get("SHAFA_MULTIHOST")):
        from . import multihost
        try:
            joined = multihost.init_from_env()
        except (RuntimeError, ValueError) as e:
            print(f"multi-host join failed: {e}", file=sys.stderr)
            return 1
    reports: list[StageReport] = []
    try:
        if opts.profile_dir:
            import torch
            with profiler(device_type, on_trace_ready=torch.profiler
                          .tensorboard_trace_handler(opts.profile_dir)), \
                    tracing.span("shafa.cli.main"):
                error = execute_modules(opts, file, reports)
        else:
            error = execute_modules(opts, file, reports)
    finally:
        if joined:
            multihost.leave()
    if opts.json_path:
        _emit_json(opts.json_path, reports, error)
    if error:
        if error != Code.OUTSIDE_MODULE:
            print(error_msg(error), end="", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
