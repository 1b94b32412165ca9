"""The control of the comparison that decides ``correct``.

    python benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

The control is the plain reference put in the program's place with one of
the configuration's guarantees broken: module T's frequency sort breaks
ties by the higher symbol first, as an unstable sort (a sort on the card,
say) may leave them, so its .cod and .shaf are no longer the C
reference's. For each seed it makes the cell's pool as a run does, judges
the control's files with ``verify.judge`` as it judges the program's, and
prints the numbers compared; the control has to come out not correct on
every seed. It runs on the first CUDA card, or on the CPU where there is
none.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

import gen  # noqa: E402
from harness import spec, verify  # noqa: E402
from harness.record import Call  # noqa: E402


def readings(cell, seed: int, device, traffic=None) -> dict:
    """The numbers compared for the control's files on one seed's pool."""
    traffic = traffic or cell.traffic
    pool = gen.make_pool(cell.config, traffic["file_bytes"],
                         traffic["pool"], seed, device)
    block = cell.config["block_bytes"]
    want, _ = verify.expected(pool, block, device)
    got, _ = verify.expected(pool, block, device, tie_break="reversed")
    calls = []
    for i, g in enumerate(got):
        outs = {k: v for k, v in g.items() if k != "restored"}
        calls.append(Call("compress", i, i, int(pool[i].size), 0.0, 0,
                          outs))
        calls.append(Call("decompress", i, i, int(pool[i].size), 0.0, 0,
                          {"restored": g["restored"]}))
    return verify.judge(calls, want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    failed_all = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = readings(cell, seed, device)
        ok = verify.passed(numbers)
        failed_all &= not ok
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "device": str(device), "control_correct": ok,
                          "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
