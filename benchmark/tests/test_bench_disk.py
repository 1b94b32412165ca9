"""The writes of every cell stay under its cap, which stays under the
contract's few GiB; the window never starts a round trip past the cap."""

import json
import os

import pytest

import gen
import reference
from conftest import ROOT
from harness import calls, child, spec
from harness.main import PROCESSES

HARD_CAP = 4 << 30
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_reckoned_writes_fit_the_cap(name):
    """A round trip writes the sidecars and the restored file: reckoned
    from a 2 MiB sample of the cell's generator through the reference,
    with 10% of margin, the pool, each process's warm-up round trip and
    at least one round trip a process fit under the cap."""
    cell = spec.load(name)
    t = cell.traffic
    assert t["write_cap_bytes"] <= HARD_CAP
    n = min(t["file_bytes"], 2 << 20)
    data = gen.make_pool(cell.config, n, 1, 11, "cpu")[0]
    sc = reference.sidecars(data, cell.config["block_bytes"])
    per_rt = (sum(map(len, sc.files.values())) + n) / n \
        * t["file_bytes"] * 1.1
    k = PROCESSES
    setup = t["pool"] * t["file_bytes"] + k * per_rt
    max_files = int((t["write_cap_bytes"] - setup) // per_rt)
    assert max_files >= k
    assert setup + max_files * per_rt <= t["write_cap_bytes"]
    assert child.plan(t["write_cap_bytes"], t["pool"] * t["file_bytes"],
                      int(per_rt / 1.1), k) >= max_files


class _FakeCli:
    """cli.main stand-in: a compress writes 4 sidecars of 100 bytes, a
    decompress the restored file."""

    def main(self, argv):
        if argv[0].endswith(".shaf"):
            path = argv[0][:-len(".rle.shaf")]
            with open(path, "wb") as fp:
                fp.write(b"x" * 100)
        else:
            for ext in (".rle", ".rle.freq", ".rle.cod", ".rle.shaf"):
                with open(argv[0] + ext, "wb") as fp:
                    fp.write(b"y" * 100)
        return 0


def test_window_stops_at_the_cap(tmp_path):
    pool = []
    for i in range(3):
        pool.append(str(tmp_path / f"f{i}.bin"))
        with open(pool[-1], "wb") as fp:
            fp.write(b"z" * 100)
    work = tmp_path / "work"
    os.mkdir(work)
    d = calls.RoundTrips(_FakeCli(), "K", str(work), lambda: None)
    got, written = d.round_trip(pool[0], -1, 0)
    assert written == 500 and [c.rc for c in got] == [0, 0]
    c, written, _, _ = d.window(pool, 9, 1.0, 2600)
    assert written <= 2600 and len(c) == 2 * (written // 500)
    assert written == 2500  # the sixth would pass the cap
    c, written, _, _ = d.window(pool, 3, 1.0, 2600, first=7)
    assert [x.pool_index for x in c[::2]] == [1, 2, 0]
    assert not os.listdir(work)  # every round trip's files removed
