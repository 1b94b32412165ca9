"""The plain reference writes what the port writes, byte for byte."""

import contextlib
import io

import numpy as np
import pytest
import torch

import gen
import reference
from reference import pack as rpack


@pytest.mark.parametrize("name,flag,block,n", [
    ("mixed", "K", 655360, 1_500_000),
    ("text", "K", 655360, 1_400_000),
    ("mixed", "m", 8 << 20, 900_000),
    ("random", "K", 655360, 700_000),   # incompressible: N mode
])
def test_reference_sidecars_equal_the_ports(tmp_path, cpu_env, name, flag,
                                            block, n):
    from shafa_tpu_torch import cli
    if name == "random":
        data = np.random.default_rng(3).integers(0, 256, n, dtype=np.uint8)
    else:
        data = gen.make_pool({"generator": {"name": name}}, n, 1, 77,
                             "cpu")[0]
    path = tmp_path / "f.bin"
    path.write_bytes(data.tobytes())
    sc = reference.sidecars(data, block)
    assert sc.mode == ("N" if name == "random" else "R")
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main([str(path), "-b", flag]) == 0
    written = sorted(p.name[len("f.bin"):] for p in tmp_path.iterdir()
                     if p.name != "f.bin")
    assert written == sorted(sc.files)
    for suffix, want in sc.files.items():
        assert (tmp_path / f"f.bin{suffix}").read_bytes() == want, suffix


def _slow_pack(data, codes):
    bits = "".join(codes[b] for b in data)
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


def test_pack_places_codes_longer_than_32_bits():
    rng = np.random.default_rng(0)
    blocks = [rng.integers(0, 4, 50, dtype=np.uint8),
              rng.integers(0, 4, 33, dtype=np.uint8)]
    tables = [["0", "10", "110" + "1" * 37, "111" + "0" * 36 + "1"],
              ["1", "01", "001", "000" + "10" * 20]]
    tables = [t + [""] * 252 for t in tables]
    stream = torch.from_numpy(np.concatenate(blocks))
    block = torch.repeat_interleave(torch.arange(2), torch.tensor([50, 33]))
    lens, hi, lo = reference._code_arrays(tables, "cpu")
    got = rpack.pack(stream, block, 2, lens, hi, lo)
    assert got == [_slow_pack(b, t) for b, t in zip(blocks, tables)]
