"""A configuration with a rig of its own, a traffic mix with a clock of its
own, a per-layer metric and a cell, added as new files and entries in a
copy of the benchmark, are found and run, with no file that was there
edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark.core import spec

RUN = """
import json, sys, torch
from benchmark.core import spec
from benchmark.run import run_cell
from benchmark.tests.conftest import shrink
bench = spec.load_benchmark()
cell = spec.cell("oak4-640x400-probe.cadence30-late", bench)
cfg, mix = shrink(spec.config(cell["config"], bench), spec.traffic(cell["traffic"]))
mix["generator"] = spec.traffic(cell["traffic"])["generator"]  # the mix's own clock, not the tests' closed loop
for trace in (False, True):
    out = run_cell(cell, cfg, mix, spec.limits(cell["name"]), bench, 3000000029, 2.0, trace, torch.device("cpu"),
                   log=lambda m: None)
    print(json.dumps(out))
"""


#: A clock no mix had: PoE delivery makes every third frame arrive 50 ms
#: late; the newest frame that has arrived wins.
LATE_FRAMES = """
import time


class Clock:
    paced = True

    def __init__(self, mix, origin=None):
        self.fps, self.late_s, self.every = float(mix["fps"]), float(mix["late_s"]), int(mix["late_every"])
        self.origin = time.perf_counter() if origin is None else origin
        self.next_k = 0
        self.passed_over = 0  # frames captured but not yet arrived when a newer one was taken

    def capture_time(self, k):
        return self.origin + k / self.fps

    def arrival(self, k):
        return self.capture_time(k) + (self.late_s if k % self.every == 0 else 0.0)

    def next_tick(self):
        now = time.perf_counter()
        k = int((now - self.origin) * self.fps)
        while k >= self.next_k and self.arrival(k) > now:
            k -= 1
            self.passed_over += 1
        if k < self.next_k:
            k = self.next_k
            time.sleep(max(0.0, self.arrival(k) - now))
        self.next_k = k + 1
        return k

    def hold(self, seconds):
        self.origin += seconds
"""

#: A rig no configuration had: the synthetic orbit seen through sensor
#: noise of two grey levels, drawn from the seed.
NOISY = """
import numpy as np

from benchmark.core import spec


def build(cfg, mix, seed, device):
    rig = spec.rig_builder("synthetic_orbit").build(cfg, mix, seed, device)
    noise = np.random.default_rng([int(seed), 9]).integers(-2, 3, rig.frames.shape)
    rig.frames = np.clip(rig.frames.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    return rig
"""


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_from_new_files_only(tmp_path):
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path / "benchmark")
    bench_dir = tmp_path / "benchmark"

    # A configuration: the deployed rig under another name, with a rig of its own.
    cfg = json.loads((bench_dir / "configs" / "oak4-640x400-deployed.json").read_text())
    cfg["rig"]["builder"] = "noisy"
    (bench_dir / "configs" / "oak4-640x400-probe.json").write_text(json.dumps(cfg))
    (bench_dir / "rigs" / "noisy.py").write_text(NOISY)
    # A mix: the camera clock with late frames, without the RGB-D product or the map.
    mix = json.loads((bench_dir / "traffic" / "cadence30-map.json").read_text())
    mix.update(generator="late_frames", late_s=0.05, late_every=3, rgbd_every=0, map=False, depth_sample=0)
    (bench_dir / "traffic" / "cadence30-late.json").write_text(json.dumps(mix))
    (bench_dir / "traffic" / "late_frames.py").write_text(LATE_FRAMES)
    # Per-layer metrics and the cell's limits.
    (bench_dir / "metrics" / "probe_ticks.py").write_text("def read(run):\n    return float(len(run.calls))\n")
    (bench_dir / "metrics" / "probe_clock.py").write_text(
        "def read(run):\n    return float(type(run.clock).__module__.endswith('late_frames') and run.clock.paced)\n")
    (bench_dir / "limits" / "oak4-640x400-probe.cadence30-late.json").write_text(
        json.dumps({"pose_err_mm": 1e3, "pose_err_mrad": 1e3}))

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="oak4-640x400-probe",
                                 file="benchmark/configs/oak4-640x400-probe.json"))
    bench["workloads"].append({"name": "oak4-640x400-probe.cadence30-late", "config": "oak4-640x400-probe",
                               "traffic": "cadence30-late", "chips": 1, "why": "a probe"})
    bench["per_layer"].append({"name": "probe_ticks", "unit": "ticks", "better": "higher", "source": "host_clock",
                               "layer": "engine: a probe", "moves": "tick_rate",
                               "workloads": ["oak4-640x400-probe.cadence30-late"]})
    bench["per_layer"].append(dict(bench["per_layer"][-1], name="probe_clock", unit="1"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(bench_dir)
    assert {k: after[k] for k in before} == before  # nothing that was there changed

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(spec.ROOT)]))
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    untraced, traced = (json.loads(line) for line in proc.stdout.strip().splitlines()[-2:])
    assert untraced["correct"] and set(untraced["metrics"]) == {"tick_rate", "setup_s"}
    assert untraced["metrics"]["tick_rate"]["value"] > 0
    assert traced["metrics"]["probe_ticks"]["value"] == traced["attempted"]
    assert traced["metrics"]["probe_clock"]["value"] == 1.0
