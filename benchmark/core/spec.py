"""Find a cell's pieces by name: ``BENCHMARK.json`` and the files beside it.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell sits in a file of its own, named after it, so that a later change
adds a cell by adding files and entries and edits none:

* ``benchmark/configs/<config>.json``: the deployment as it is run; its
  ``rig.builder`` names the module ``benchmark/rigs/<builder>.py`` whose
  ``build(cfg, mix, seed, device)`` makes the cell's inputs and their truth;
* ``benchmark/traffic/<traffic>.json``: the mix's parameters
  (:mod:`benchmark.core.traffic`); its ``generator`` names the module
  ``benchmark/traffic/<generator>.py`` whose ``Clock`` paces the ticks;
* ``benchmark/metrics/<metric>.py``: the metric's reader, ``read(run)``;
* ``benchmark/limits/<cell>.json``: the limit of each number the cell's
  correctness check compares.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def cell(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {[w['name'] for w in bench['workloads']]})")


def config(name: str, bench: dict, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "traffic" / f"{name}.json")


def limits(cell_name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "limits" / f"{cell_name}.json")


def metrics_for(cell_name: str, bench: dict, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def module(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """The module ``benchmark/<kind>/<name>.py``, loaded by its path."""
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name: str, bench_dir: Path = BENCH_DIR):
    """A per-layer or end-to-end metric's reader."""
    return module("metrics", metric_name, bench_dir)


def generator(name: str, bench_dir: Path = BENCH_DIR):
    """A mix's clock: ``benchmark/traffic/<name>.py``."""
    return module("traffic", name, bench_dir)


def rig_builder(name: str, bench_dir: Path = BENCH_DIR):
    """A configuration's rig: ``benchmark/rigs/<name>.py``."""
    return module("rigs", name, bench_dir)
