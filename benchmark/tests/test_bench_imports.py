"""No file of the benchmark imports JAX or the JAX package; the reference
imports nothing of the program either; without a card the command fails."""

import ast
import os
import subprocess
import sys

from benchmark.core import spec

JAX = {"jax", "jaxlib", "flax", "thor_slam_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            if isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def test_no_jax_anywhere_and_a_standalone_reference():
    for path in spec.BENCH_DIR.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & JAX, (path, tops & JAX)
        if "reference" in path.relative_to(spec.BENCH_DIR).parts:
            mods = set(_imports(path))
            assert "thor_slam_tpu_torch" not in tops, path
            assert {m for m in mods if m.split(".")[0] == "benchmark"} <= {"benchmark.reference"}, (path, mods)
            assert tops <= {"__future__", "math", "numpy", "torch", "benchmark"}, (path, tops)


def test_launcher_targets_are_the_programs_own():
    for m in spec.load_benchmark()["per_layer"]:
        for target in getattr(spec.reader(m["name"]), "LAUNCHERS", {}):
            assert target.split(".")[0] == "thor_slam_tpu_torch"


def test_a_run_without_a_card_fails_and_prints_nothing(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "oak4-1280x720-flagship.replay-vo", "--seed",
         "3000000017", "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
