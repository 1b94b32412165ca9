"""shafa_tpu_torch stands alone: no file of the port imports shafa_tpu or
jax, a round trip through it loads neither, and each host module it keeps a
copy of (codes, formats, oracle, runtime, geometry, errors) gives what the
shafa_tpu original gives, with its native runtime and without."""

import ast
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from shafa_tpu import codes as jcodes
from shafa_tpu import errors as jerrors
from shafa_tpu import formats as jformats
from shafa_tpu import geometry as jgeometry
from shafa_tpu import oracle as joracle
from shafa_tpu import runtime as jruntime
from shafa_tpu_torch import codes, errors, formats, geometry, oracle, runtime

from corpus import edge_cases, mixed, runs_heavy, text

REPO = pathlib.Path(__file__).resolve().parent.parent


def _imports_of(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_no_file_of_the_port_imports_shafa_tpu_or_jax():
    files = sorted((REPO / "shafa_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _imports_of(f)
           if name.split(".")[0] in ("shafa_tpu", "jax")]
    assert len(files) > 20 and not bad


def _port_modules_imported_by(path: pathlib.Path) -> set[str]:
    """The shafa_tpu_torch modules a file of the port imports, its relative
    imports (``from . import x``, ``from ..x import y``) resolved, a name
    imported from a package counted as a module of it."""
    package = ".".join(path.relative_to(REPO).parent.parts)
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package.split(".")[:len(package.split(".")) + 1
                                      - node.level] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            out.add(mod)
            out.update(f"{mod}.{a.name}" for a in node.names)
    return {m for m in out if m.split(".")[0] == "shafa_tpu_torch"}


def test_the_layers_below_the_pipeline_do_not_import_it():
    """The backend (device, dist), the multi-host process layer, the host
    modules and the kernels sit below pipeline.py: none of them imports it,
    relative imports and imports inside functions included."""
    port = REPO / "shafa_tpu_torch"
    files = [port / f"{m}.py" for m in ("device", "dist", "multihost",
                                        "codes", "formats", "oracle")]
    files += sorted((port / "kernels").glob("*.py"))
    bad = {str(f.relative_to(REPO)): m for f in files
           for m in _port_modules_imported_by(f)
           if m == "shafa_tpu_torch.pipeline"
           or m.startswith("shafa_tpu_torch.pipeline.")}
    assert len(files) > 10 and not bad
    # the resolver sees the imports the test looks for
    assert "shafa_tpu_torch.pipeline" in _port_modules_imported_by(
        port / "cli.py")
    assert "shafa_tpu_torch.tracing" in _port_modules_imported_by(
        port / "kernels" / "decode.py")


#: imports the port's entry points, runs a small round trip on the CPU and
#: prints the names of any shafa_tpu or jax module that got loaded
ROUND_TRIP = r"""
import json, os, sys
import shafa_tpu_torch.cli, shafa_tpu_torch.device
import shafa_tpu_torch.pipeline, shafa_tpu_torch.profile_main_path
from shafa_tpu_torch.profile_main_path import synthetic
path = os.path.join(sys.argv[1], "a.bin")
data = synthetic(300_000, 3)
with open(path, "wb") as fp:
    fp.write(data)
assert shafa_tpu_torch.cli.main([path, "-b", "K"]) == 0
os.rename(path, path + ".orig")
assert shafa_tpu_torch.cli.main([path + ".rle.shaf"]) == 0
with open(path, "rb") as fp:
    assert fp.read() == data
print(json.dumps(sorted(m for m in sys.modules if m == "jax"
                        or m.startswith(("jax.", "jaxlib"))
                        or m.split(".")[0] == "shafa_tpu")))
"""


def test_round_trip_loads_no_shafa_tpu_or_jax(tmp_path):
    env = dict(os.environ, SHAFA_TORCH_DEVICE="cpu")
    r = subprocess.run([sys.executable, "-c", ROUND_TRIP, str(tmp_path)],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=600)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


@pytest.fixture(params=["native", "python"])
def native(request, monkeypatch):
    """The port's runtime loaded (native) or off (SHAFA_NO_NATIVE); the
    shafa_tpu original as it is."""
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "_tried", False)
    if request.param == "python":
        monkeypatch.setenv("SHAFA_NO_NATIVE", "1")
        assert not runtime.available()
    else:
        monkeypatch.delenv("SHAFA_NO_NATIVE", raising=False)
        if not runtime.available():
            pytest.skip("g++ unavailable: no native runtime")
    return request.param == "native"


def _random_freqs(rng, n):
    """Histograms with the cases the formats care about: zero runs
    (elision), equal-frequency runs, a single symbol, deep codes."""
    rows = []
    for i in range(n):
        f = np.zeros(256, np.int64)
        kind = i % 5
        if kind == 0:
            f[:] = rng.integers(0, 10_000, 256)
        elif kind == 1:
            idx = rng.choice(256, rng.integers(1, 10), replace=False)
            f[idx] = rng.integers(1, 1000, idx.size)
        elif kind == 2:
            f[:] = rng.integers(0, 4, 256) * 7
            f[0] = max(int(f[0]), 1)
        elif kind == 3:
            f[rng.integers(0, 256)] = rng.integers(1, 65536)
        else:
            k = int(rng.integers(2, 40))
            f[:k] = (1 << np.arange(k, dtype=np.int64))[::-1]
        rows.append(f)
    return np.stack(rows)


def test_build_code_tables_matches_shafa_tpu(native):
    freqs = _random_freqs(np.random.default_rng(0), 60)
    got = codes.build_code_tables(freqs)
    want = jcodes.build_code_tables(freqs)
    np.testing.assert_array_equal(got.lens, want.lens)
    np.testing.assert_array_equal(got.vals, want.vals)
    assert got.to_strings() == want.to_strings()
    for i in range(0, 60, 7):
        assert codes.build_codes(freqs[i]) == jcodes.build_codes(freqs[i])
    back = codes.CodeTables.from_strings(want.to_strings())
    np.testing.assert_array_equal(back.lens, want.lens)


def _written(mod, fn, *args) -> bytes:
    buf = io.BytesIO()
    getattr(mod, fn)(buf, *args)
    return buf.getvalue()


def test_formats_writers_and_parsers_match_shafa_tpu(native):
    rng = np.random.default_rng(1)
    freqs = _random_freqs(rng, 25)
    sizes = rng.integers(1, 1 << 20, 25).tolist()
    tables = jcodes.build_code_tables(freqs)
    for mode in "RN":
        freq = _written(formats, "write_freq_arrays", mode, sizes, freqs)
        assert freq == _written(jformats, "write_freq_arrays", mode, sizes,
                                freqs)
        m, s, f = formats.parse_freq_arrays(freq)
        assert (m, s) == (mode, sizes) and (f == freqs).all()
        assert vars(formats.parse_freq(freq)) == \
            vars(jformats.parse_freq(freq))
        cod = _written(formats, "write_cod_tables", mode, sizes, tables)
        assert cod == _written(jformats, "write_cod_tables", mode, sizes,
                               tables)
        m, s, t = formats.parse_cod_tables(cod)
        assert (m, s) == (mode, sizes)
        np.testing.assert_array_equal(t.vals, tables.vals)
        assert vars(formats.parse_cod(cod)) == vars(jformats.parse_cod(cod))
    payloads = [b"\x00\x01@@\xff", b"", b"@7@", bytes(range(256))]
    shaf = _written(formats, "write_shaf_header", len(payloads))
    for p in payloads:
        shaf += _written(formats, "write_shaf_block", p)
    assert formats.parse_shaf_frames(shaf) == payloads
    assert jformats.parse_shaf_frames(shaf) == payloads
    with pytest.raises(errors.FileUnrecognizableError):
        formats.parse_cod(b"@R@1@5")
    with pytest.raises(errors.FileUnrecognizableError):
        list(formats.iter_shaf_blocks(shaf[:-1]))
    assert formats.rm_ext("a.b.shaf") == jformats.rm_ext("a.b.shaf")


@pytest.mark.parametrize("name", ["edge_cases", "mixed", "runs_heavy", "text"])
def test_oracle_matches_shafa_tpu(name):
    blocks = (list(edge_cases().values()) if name == "edge_cases" else
              [{"mixed": mixed, "runs_heavy": runs_heavy,
                "text": text}[name](20_000, seed=5)])
    for data in blocks:
        x = np.frombuffer(data, np.uint8)
        enc = oracle.rle_encode(x)
        np.testing.assert_array_equal(enc, joracle.rle_encode(x))
        np.testing.assert_array_equal(oracle.rle_expand(enc),
                                      joracle.rle_expand(enc))
        if not x.size:
            continue
        tables = jcodes.build_code_tables(joracle.histogram(enc)[None])
        packed = oracle.pack(enc, tables.lens[0], tables.vals[0])
        assert packed == joracle.pack(enc, tables.lens[0], tables.vals[0])
        strings = tables.row_strings(0)
        np.testing.assert_array_equal(
            oracle.unpack(packed, strings, enc.size),
            joracle.unpack(packed, strings, enc.size))
        assert oracle.slow_unpack(packed, strings, enc.size) == \
            joracle.slow_unpack(packed, strings, enc.size)


def test_runtime_bindings_match_shafa_tpu(native):
    """The port's bindings give the original's results with the library
    built into shafa_tpu_torch/_build/, and None with SHAFA_NO_NATIVE."""
    rng = np.random.default_rng(2)
    freqs = _random_freqs(rng, 20)
    sizes = rng.integers(1, 1 << 20, 20)
    tables = jcodes.build_code_tables(freqs)
    shaf = b"@2@3@abc@0@"
    calls = [("build_codes", (freqs,)), ("write_freq", ("R", sizes, freqs)),
             ("write_cod", ("N", sizes, tables.lens, tables.vals)),
             ("parse_shaf", (shaf,))]
    calls += [("parse_freq", (jruntime.write_freq("R", sizes, freqs),)),
              ("parse_cod", (jruntime.write_cod("N", sizes, tables.lens,
                                                tables.vals),))]
    for fn, args in calls:
        got = getattr(runtime, fn)(*args)
        if not native:
            assert got is None, fn
            continue
        want = getattr(jruntime, fn)(*args)
        assert want is not None, fn
        if isinstance(want, bytes):
            assert got == want, fn
        else:
            assert len(got) == len(want), fn
            for g, w in zip(got, want):
                assert np.array_equal(np.asarray(g), np.asarray(w)), fn
    if native:
        so = pathlib.Path(runtime.lib()._name)
        assert so.parent == runtime.BUILD_DIR
        assert so.parent != pathlib.Path(runtime.__file__).parent


def test_errors_and_geometry_match_shafa_tpu():
    for code in list(jerrors.Code) + [99]:
        assert errors.error_msg(code) == jerrors.error_msg(code)
    for cls in ("FileInaccessibleError", "FileUnrecognizableError",
                "FileStreamError", "FileTooSmallError",
                "OutsideModuleError"):
        assert getattr(errors, cls).code == getattr(jerrors, cls).code
        assert str(getattr(errors, cls)()) == str(getattr(jerrors, cls)())
    for total in (0, 1, 511, 65536, 65537, 10 << 20):
        for bs in (0, 100, 65536, 1 << 23):
            assert geometry.geometry_for_size(total, bs).sizes() == \
                jgeometry.geometry_for_size(total, bs).sizes()
    with pytest.raises(geometry.BlockSizeError):
        geometry.clamp_block_size(geometry.MAX_BLOCK_SIZE + 1)
    assert geometry.BLOCK_SIZE_BY_FLAG == jgeometry.BLOCK_SIZE_BY_FLAG
