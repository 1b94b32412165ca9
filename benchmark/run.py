"""Run one cell of the benchmark once; see harness/main.py.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

(``run.py --child <task.json>`` is one process of a run; see
harness/child.py.)
"""

import time

START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        from harness.child import main as child
        sys.exit(child(sys.argv[2], START))
    from harness.main import main
    sys.exit(main(sys.argv[1:], start=START))
