"""The port's runs load neither JAX nor the JAX package, the reference
imports nothing of the program, the harness reads nothing of the JAX
package's benchmarks, and a run without a card or without the port
prints no result."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

from gstbench import harness as H
from gstbench import testing as T

DRIVE = """
import json, sys
from gstbench import harness as H, testing as T
r = T.execute(sys.argv[1])
print(json.dumps({"correct": r["correct"], "loaded": H.forbidden_modules()}))
"""


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(H.ROOT)
    return env


def test_a_run_loads_no_jax_nor_the_jax_package():
    for cell in (T.cells_of("train_efd")[0], T.cells_of("predict")[-1]):
        out = subprocess.run([sys.executable, "-c", DRIVE, cell],
                             capture_output=True, text=True, env=_env(),
                             cwd=H.ROOT, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        got = json.loads(out.stdout.strip().splitlines()[-1])
        assert got == {"correct": True, "loaded": []}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "jaxlib", raising=False)
    monkeypatch.delitem(sys.modules, "flax", raising=False)
    for name in [m for m in sys.modules if m.split(".")[0] in H.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    assert H.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert H.forbidden_modules() == ["repro"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((H.HERE / "reference").glob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("repro_torch", "repro", "jax", "jaxlib",
                               "flax"), (path.name, name)
            assert not name.startswith("gstbench.") or name.startswith(
                ("gstbench.reference", "gstbench.weights")), (path, name)


def test_the_harness_reads_nothing_of_the_jax_benchmarks():
    for path in H.HERE.rglob("*"):
        if path.suffix in (".py", ".json", ".md") and path.name != \
                "test_gstbench_isolation.py":
            text = path.read_text()
            assert "benchmarks/" not in text, path
            assert "BENCH_gst" not in text, path


def test_no_card_no_result():
    # the card is hidden from the run, so a machine that has one tests
    # the same refusal
    out = subprocess.run([sys.executable, "-m", "gstbench.run", "--workload",
                          T.CELLS[0], "--seed", "4294967311",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True,
                         env={**_env(), "CUDA_VISIBLE_DEVICES": ""},
                         cwd=H.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(H.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(H.HERE, tmp_path / "gstbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "gstbench.run", "--workload",
                          T.CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
