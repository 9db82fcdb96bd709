"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's), and
nothing it runs reads the JAX side's benchmark pieces where they stand."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import types

from portbench import harness


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "rectdetect_tpu_torch_x",
                        types.ModuleType("rectdetect_tpu_torch_x"))
    assert "rectdetect_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rectdetect_tpu.core",
                        types.ModuleType("rectdetect_tpu.core"))
    monkeypatch.setitem(sys.modules, "jaxlib",
                        types.ModuleType("jaxlib"))
    bad = harness.forbidden_modules()
    assert "rectdetect_tpu.core" in bad and "jaxlib" in bad


def test_a_run_loads_no_jax():
    """A whole CPU run of each entry path in a fresh process, then the check
    the CLI makes once the window has closed."""
    code = (
        "import sys, time, json\n"
        "from portbench import harness\n"
        "from portbench.tests.conftest import tiny_cell, cpu_run\n"
        "for n in ('vidrect.uhd1', 'vidpoly.uhd1'):\n"
        "    cpu_run(tiny_cell(n), seconds=0.5)\n"
        "from portbench import control\n"
        "print(json.dumps([m for m in sys.modules\n"
        "                  if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                         'rectdetect_tpu')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.CHECKOUT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys\nimport portbench.reference.frame\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.CHECKOUT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = eval(out.stdout.strip().splitlines()[-1])
    assert not {"rectdetect_tpu_torch", "rectdetect_tpu", "jax"} & set(tops)


def test_no_jax_side_piece_is_read_in_place():
    """No module of the benchmark imports bench.py, golden/, chip_smoke.py or
    the JAX package, or names a BENCH_*.json file."""
    for path in harness.ROOT.rglob("*.py"):
        if "tests" in path.relative_to(harness.ROOT).parts:
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in (
                    "bench", "golden", "chip_smoke", "jax", "jaxlib", "flax",
                    "rectdetect_tpu"), (path, n)
        assert "BENCH_r" not in path.read_text(), path
    if (harness.ROOT / "reference").exists():
        for path in (harness.ROOT / "reference").rglob("*.py"):
            assert "rectdetect_tpu_torch" not in "".join(
                line for line in path.read_text().splitlines(True)
                if line.lstrip().startswith(("import", "from"))), path
