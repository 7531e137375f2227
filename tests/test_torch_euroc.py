"""The port's EuRoC runner, ``run_euroc``, on the CPU, against the JAX
package's on the same synthetic sequence.

The sequence is the port's ``make_euroc_synthetic`` output (its IMU in
cam0's axes, which both packages' replay assumes). Both runners track
every frame; the port's trajectory file has the reference's format and
rows, its poses lie within the 0.02 m of ``tests/test_torch_engine.py``
of the reference's, and it prints the reference's result lines (with a
closure count that is nonzero wherever the reference's is). The JAX runner
runs in a process of its own, so that its persistent compilation cache
goes to a temporary directory; it inherits ``THOR_SLAM_TPU_ADAPTIVE_HALF=0``
from the suite's conftest, and the port's engine is built with
``adaptive_half_res=False`` to match (a CPU tick falls in the controller's
band, which would degrade one run and not the next). ``--devices`` > 1 and
a missing sequence return 2.
"""

from __future__ import annotations

import contextlib
import functools
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from thor_slam_tpu_torch.engine import torch_engine
from thor_slam_tpu_torch.scripts import make_euroc_synthetic, run_euroc

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
MAX_POSE_DIFF_M = 0.02  # tests/test_torch_engine.py's bar


def _sequence(root: Path, *args: str) -> Path:
    with contextlib.redirect_stdout(io.StringIO()):
        assert make_euroc_synthetic.main(["--out", str(root), *args]) == 0
    return root


def _reference(tmp: Path, seq: Path, *args: str) -> str:
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_CACHE_DIR": str(tmp / "jax_cache")}
    res = subprocess.run(
        [sys.executable, "-m", "scripts.run_euroc", "--sequence", str(seq), "--cpu", "--out", str(tmp / "ref.csv"), *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


@pytest.fixture(autouse=True)
def _no_adaptive_half_res(monkeypatch):
    monkeypatch.setattr(torch_engine, "TorchSlamEngine",
                        functools.partial(torch_engine.TorchSlamEngine, adaptive_half_res=False))


def _port(tmp: Path, seq: Path, *args: str) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run_euroc.main(["--sequence", str(seq), "--cpu", "--out", str(tmp / "port.csv"), *args])
    assert rc == 0
    return out.getvalue()


def _results(text: str) -> dict:
    tracked = re.search(r"^Tracked (\d+) frames in [\d.]+s \([\d.]+ fps\)$", text, re.M)
    ate = re.search(r"^ATE-RMSE: ([\d.]+) cm over (\d+) poses \(([\d.]+) m path, (\d+) loop closures, "
                    r"ba=on loop=on imu=on\)$", text, re.M)
    kf = re.search(r"^map-trajectory ATE-RMSE: ([\d.]+) cm over (\d+) keyframes$", text, re.M)
    assert tracked and ate and kf, text
    return dict(tracked=int(tracked.group(1)), ate_cm=float(ate.group(1)), poses=int(ate.group(2)),
                path_m=ate.group(3), loops=int(ate.group(4)), kf_ate_cm=float(kf.group(1)),
                world=re.search(r"^world-frame live ATE-RMSE: [\d.]+ cm \(odometry composed with map->odom\)$",
                                text, re.M) is not None)


def _compare(tmp: Path, ref: str, port: str, frames: int, max_ate_cm: float) -> None:
    want, got = _results(ref), _results(port)
    print(f"reference {want}\nport      {got}")
    assert got["tracked"] == want["tracked"] == got["poses"] == frames
    assert got["path_m"] == want["path_m"]
    assert (got["loops"] > 0) >= (want["loops"] > 0)
    assert got["world"] == (got["loops"] > 0) and want["world"] == (want["loops"] > 0)
    assert got["ate_cm"] <= max_ate_cm and want["ate_cm"] <= max_ate_cm
    a, b = ((tmp / name).read_text().splitlines() for name in ("ref.csv", "port.csv"))
    assert a[0] == b[0] == "#timestamp_s,x,y,z"
    assert all(re.fullmatch(r"\d+\.\d{9}(,-?\d+\.\d{6}){3}", row) for row in b[1:])
    ra, rb = (np.loadtxt(tmp / name, delimiter=",", skiprows=1) for name in ("ref.csv", "port.csv"))
    np.testing.assert_array_equal(rb[:, 0], ra[:, 0])
    diff = np.abs(rb[:, 1:] - ra[:, 1:]).max()
    print(f"max pose difference {diff:.4f} m")
    assert diff <= MAX_POSE_DIFF_M


def test_run_euroc_matches_reference(tmp_path):
    seq = _sequence(tmp_path / "seq", "--frames", "30", "--width", "160", "--height", "100")
    _compare(tmp_path, _reference(tmp_path, seq), _port(tmp_path, seq), frames=30, max_ate_cm=5.0)


@pytest.mark.slow
def test_run_euroc_matches_reference_at_euroc_width(tmp_path):
    """EuRoC's own 752x480 at 20 fps on the orbit of the card's phase (0.7
    rad/s), its first 60 frames."""
    seq = _sequence(tmp_path / "seq", "--frames", "60", "--width", "752", "--height", "480",
                    "--trajectory-rate", "0.7")
    _compare(tmp_path, _reference(tmp_path, seq), _port(tmp_path, seq), frames=60, max_ate_cm=5.0)


def test_run_euroc_refusals(tmp_path):
    seq = _sequence(tmp_path / "seq", "--frames", "2", "--width", "64", "--height", "48")
    # Two devices are no refusal now: two virtual CPU shards of the slots.
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run_euroc.main(["--sequence", str(seq), "--cpu", "--devices", "2"]) == 0
    assert re.search(r"^Tracked 2 frames", out.getvalue(), re.M)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert run_euroc.main(["--sequence", str(tmp_path / "nothing"), "--cpu"]) == 2
    assert "run_euroc: Not a EuRoC sequence (no mav0/)" in err.getvalue()


def test_run_euroc_without_groundtruth_or_imu(tmp_path):
    """No ground truth: the trajectory is written and ATE is not computed;
    ``--no-imu`` replays no IMU (the ``imu=off`` flag of the ATE line)."""
    seq = _sequence(tmp_path / "seq", "--frames", "6", "--width", "96", "--height", "64")
    text = _port(tmp_path, seq, "--no-imu", "--no-ba", "--no-loop", "--no-light")
    assert re.search(r"imu=off", text) and "ba=off loop=off" in text
    (seq / "mav0" / "state_groundtruth_estimate0" / "data.csv").unlink()
    text = _port(tmp_path, seq)
    assert text.rstrip().endswith("No ground truth in sequence; ATE not computed.")
    assert len((tmp_path / "port.csv").read_text().splitlines()) == 7
