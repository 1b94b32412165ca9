"""Nothing the benchmark runs imports JAX or the JAX package; the
reference imports nothing of the program; a run that finds JAX loaded
after its window refuses."""

import ast
import sys
import types


from conftest import BENCH, MIXED_K, TINY, make_checkout

BANNED = {"jax", "jaxlib", "flax", "shafa_tpu"}
ROOT_SCRIPTS = {"bench", "bench_stages", "bench_scaling",
                "bench_decode_stages", "chip_smoke"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = set(_imports(path))
        assert not tops & BANNED, path
        assert not tops & ROOT_SCRIPTS, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = set(_imports(path))
        assert tops <= {"__future__", "dataclasses", "numpy", "torch"}, path


def test_a_run_with_jax_loaded_refuses(tmp_path, cpu_env, monkeypatch,
                                       capsys):
    from harness.main import main
    cell = {"name": "mixed_K.tiny", "config": "mixed_K", "traffic": "tiny",
            "chips": 1, "why": "test"}
    ck = make_checkout(tmp_path, [cell], configs=[
        ("mixed_K", MIXED_K, {"source": "t", "reduced": [], "why": "t"})],
        traffic=[("tiny", TINY)])
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = main(["--workload", "mixed_K.tiny", "--seed", "1", "--seconds",
               "0.2", "--trace", "0"], require_chip=False, checkout=ck)
    out = capsys.readouterr()
    assert rc != 0
    assert "jax" in out.err
    assert not any(line.startswith("{") for line in out.out.splitlines())
