"""The kernel build's bookkeeping, on the CPU: what ``nvcc -Xptxas -v``
reported of each kernel, read back from the report kept beside the
library (the build itself runs only where nvcc is)."""

import pytest

from shafa_tpu_torch.kernels import _build


def _mangled(name: str, anonymous: str) -> str:
    """A kernel in an anonymous namespace as nvcc mangles it."""
    return f"_ZN{len(anonymous)}{anonymous}{len(name)}{name}E4ArgsPi"


@pytest.mark.parametrize("anonymous", ["_GLOBAL__N__2f1a6a1b_8_fsm32_cu_6e3b",
                                       "_GLOBAL__N_1"])
def test_resources_reads_the_ptxas_report(tmp_path, monkeypatch, anonymous):
    lines = []
    for name, regs, spills in (("fsm32_tile_fn", 78, (0, 0)),
                               ("fsm32_tile_packs", 76, (8, 12)),
                               ("fsm_tile_fn", 40, (0, 0))):
        m = _mangled(name, anonymous)
        lines += [f"ptxas info    : Compiling entry function '{m}' for "
                  "'sm_90a'",
                  f"ptxas info    : Function properties for {m}",
                  f"    0 bytes stack frame, {spills[0]} bytes spill stores, "
                  f"{spills[1]} bytes spill loads",
                  f"ptxas info    : Used {regs} registers, used 1 barriers, "
                  "400 bytes cmem[0]"]
    so = tmp_path / "libshafa_kernels_0.so"
    so.with_suffix(".ptxas.txt").write_text("\n".join(lines) + "\n")
    monkeypatch.setattr(_build, "build", lambda: so)
    assert _build.resources("fsm32_") == {"fsm32_tile_fn": (78, 0, 0),
                                          "fsm32_tile_packs": (76, 8, 12)}
    assert set(_build.resources("fsm")) == {"fsm32_tile_fn",
                                            "fsm32_tile_packs", "fsm_tile_fn"}


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_15fsm1613fsm16_tile_fnENS0_4ArgsEPy", "fsm16_tile_fn"),
    ("_ZN12_GLOBAL__N_15fsm1615fsm16_tile_emitILb1EEEvNS0_4ArgsEPKiPyPiNS0_"
     "3OutES5_", "fsm16_tile_emit<1>"),
    ("_ZN12_GLOBAL__N_115rank_lut_planesEPKhPKsPKiS5_xxPi",
     "rank_lut_planes"),
    ("_Z12plain_kerneli", "plain_kernel"),
    ("_ZN12_GLOBAL__N_110emit_tilesILb1ELb0EEEvNS_4ArgsE",
     "emit_tiles<1,0>"),
])
def test_kernel_name_of_a_nested_or_plain_mangled_name(mangled, name):
    """A kernel inside a namespace nested in the anonymous one (K3's and
    K7's in fsm_decode.cu) keeps its own name, the last of the nested
    name; a template instance (K1's, K3's and K7's last pass) names its
    literal arguments."""
    assert _build._kernel_name(mangled) == name
