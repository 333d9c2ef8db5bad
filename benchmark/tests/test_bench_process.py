"""The benchmark as a process: what it refuses, and what it may not load."""

import ast
import shutil
import subprocess
import sys

from benchmark import harness

ARGS = ["--workload", "r2r.serve", "--seed", str(2 ** 31 + 7), "--seconds",
        "1", "--trace", "0"]


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                       cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_a_directory_with_only_the_benchmark_gives_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "out",
                                                  "__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def imports_of(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_references_import_nothing_of_the_program_or_jax():
    for path in (harness.HERE / "reference").glob("*.py"):
        for name in imports_of(path):
            top = name.split(".")[0]
            assert top in ("torch", "benchmark", "math", "contextlib",
                           "types", "typing", "__future__"), (path, name)


def test_no_module_of_the_harness_names_jax_or_the_jax_package():
    for path in harness.HERE.rglob("*.py"):
        for name in imports_of(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_a_run_loads_no_jax_module():
    code = (
        "import sys\n"
        "from benchmark.tests.conftest import tiny_cell\n"
        "from benchmark import run, harness\n"
        "for w in ('r2r.serve', 'r2r.train'):\n"
        "    run.run_cell(tiny_cell(w), 5, 0.2, 1, 'cpu')\n"
        "print(harness.forbidden_loaded())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gridmm_tpu_torch_like", sys)
    assert "gridmm_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "gridmm_tpu.config", sys)
    assert "gridmm_tpu" in harness.forbidden_loaded()
