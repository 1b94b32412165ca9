"""K8, the RLE encode with its histogram, timed on the card at the shapes
the main paths give it.

    python -m shafa_tpu_torch.bench_rle_encode
    python shafa_tpu_torch/bench_rle_encode.py [--tree DIR]

The shapes: the first (8, 8 MiB) batch of the 200 MB mixed corpus
(profile_main_path.synthetic, seed 0), that of the 200 MB text corpus
(text_with_rare_bytes), and the first (1, 64 MiB) row of the 1 GiB
streaming path (the mixed corpus's first 64 MiB). On each, K8
(kernels.rle.rle_encode_hist) is held against its plain version (out_len,
the bytes below it and hist, exact), then timed with CUDA events: the mean
of REPS calls after a warm-up call. Beside each time, the
least time the card could take: the rows' valid bytes read once, the RLE
bytes written once, the lengths and the histograms, over the H100's
3.35 TB/s.

In the file form, --tree DIR times the K8 of another checkout of this
repository (its shafa_tpu_torch, built from its own kernel sources), so
that two designs run in turns in one call on one card, each in its own
process. The first line is the card's name and power limit (nvidia-smi);
the last line is JSON. Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: HBM bytes per second of one H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
CORPUS_BYTES = 200_000_000
BLOCK = 8 << 20
BATCH_ROWS = 8
REPS = 20


def batches(mixed: bytes, text: bytes, device, block: int = BLOCK,
            rows: int = BATCH_ROWS) -> dict:
    """{shape name: (x, lengths)} on device: the first `rows` blocks of
    each corpus as the main path stacks them, and the mixed corpus's first
    rows * block bytes as one row."""
    import numpy as np
    import torch
    from shafa_tpu_torch.device import _stack_blocks

    out = {}
    for name, data in (("mixed", mixed), ("text", text)):
        x, lens = _stack_blocks([np.frombuffer(data, np.uint8, block,
                                               i * block)
                                 for i in range(rows)])
        out[name] = (torch.from_numpy(x).to(device),
                     torch.from_numpy(lens).to(device))
    x = out["mixed"][0].reshape(1, -1).contiguous()
    out["row"] = (x, torch.tensor([x.shape[1]], dtype=torch.int32,
                                  device=device))
    return out


def bound_bytes(lengths, out_len, hist) -> int:
    """Bytes K8 must move: the valid input bytes and the RLE bytes once,
    the lengths (int32), out_len and the histograms."""
    return (int(lengths.sum()) + 4 * lengths.numel() + int(out_len.sum())
            + 8 * out_len.numel() + 8 * hist.numel())


def exact(got, want) -> bool:
    import torch
    enc, n, h = got
    return (torch.equal(n.cpu(), want[1].cpu())
            and torch.equal(h.cpu(), want[2].cpu())
            and all(torch.equal(enc[i, :k], want[0][i, :k])
                    for i, k in enumerate(want[1].tolist())))


def timed_ms(fn, reps: int) -> float:
    """Mean milliseconds a call on the card, CUDA events, after a warm-up
    call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv: list[str] | None = None, file_form: bool = False) -> int:
    ap = argparse.ArgumentParser(prog="bench_rle_encode",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="the checkout whose K8 to time (file form only)")
    args = ap.parse_args(argv)
    if args.tree and not file_form:
        print("--tree needs the file form: python "
              "shafa_tpu_torch/bench_rle_encode.py --tree DIR",
              file=sys.stderr)
        return 2
    if file_form:
        # this checkout's root, or the one --tree names
        sys.path.insert(0, os.path.abspath(args.tree or os.path.join(
            os.path.dirname(os.path.abspath(__file__)), os.pardir)))
    import torch
    if not torch.cuda.is_available():
        print("CUDA device not available", file=sys.stderr)
        return 1
    from shafa_tpu_torch.kernels import _build, rle
    from shafa_tpu_torch.profile_main_path import (synthetic,
                                                   text_with_rare_bytes)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=False).stdout.strip()
    print(card, flush=True)
    src = os.path.dirname(os.path.abspath(rle.__file__))
    _build.library()
    result = {"card": card, "tree": os.path.dirname(os.path.dirname(src)),
              "reps": REPS,
              "registers_spills": _build.resources("rle_enc_")}
    device = torch.device("cuda", 0)
    shapes = batches(synthetic(CORPUS_BYTES, 0),
                     text_with_rare_bytes(CORPUS_BYTES), device)
    ok = True
    for name, (x, lengths) in shapes.items():
        want = rle.rle_encode_hist_plain(x, lengths)
        same = exact(rle.rle_encode_hist(x, lengths), want)
        ok &= same
        moved = bound_bytes(lengths, want[1], want[2])
        del want
        torch.cuda.empty_cache()
        ms = timed_ms(lambda: rle.rle_encode_hist(x, lengths), REPS)
        bound = moved / HBM_BYTES_PER_S * 1e3
        result[name] = dict(shape=list(x.shape), exact=same, ms=ms,
                            bound_ms=bound, share_of_bound=bound / ms)
        print(f"{name} {list(x.shape)}: K8 {ms:.4f} ms, bound {bound:.4f} "
              f"ms ({bound / ms:.1%}), exact {same}", flush=True)
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(file_form=not __package__))
