"""The generators are seeded, and the seed only reorders the work."""

import numpy as np
import pytest

import gen
import reference


@pytest.mark.parametrize("name", ["mixed", "text"])
def test_same_seed_same_bytes_other_seed_other_bytes(name):
    cfg = {"generator": {"name": name}}
    a = gen.make_pool(cfg, 300_001, 2, 2**31 + 7, "cpu")
    b = gen.make_pool(cfg, 300_001, 2, 2**31 + 7, "cpu")
    c = gen.make_pool(cfg, 300_001, 2, 2**40 + 3, "cpu")
    assert all(x.size == 300_001 and x.dtype == np.uint8 for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[0], a[1])  # pool files differ


def test_text_codes_take_the_wide_route_on_every_seed():
    """At 640 KiB blocks the text's codes have 17-32 bits (K5/K6)."""
    cfg = {"generator": {"name": "text"}}
    for seed in (1, 2, 3):
        data = gen.make_pool(cfg, 655360, 1, seed, "cpu")[0]
        sc = reference.sidecars(data, 655360)
        assert sc.mode == "R"
        assert 17 <= max(sc.max_code_len) <= 32


def test_mixed_codes_take_the_short_route():
    cfg = {"generator": {"name": "mixed"}}
    data = gen.make_pool(cfg, 2_000_000, 1, 5, "cpu")[0]
    sc = reference.sidecars(data, 8 << 20)
    assert sc.mode == "R" and max(sc.max_code_len) <= 16
