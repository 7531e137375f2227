"""The port's demos (``thor_slam_tpu_torch/examples/``) against the JAX
package's (``examples/``), on the same synthetic inputs, on the CPU.

Bars, each demo run in this process with the same flags:

* ``pull_extrinsics``: the same 4x4 mounts, exactly, and the same lines;
* ``test_camera_rig``: the same sync statistics (set count, delta mean /
  percentiles / extremes, queue depths, each source's offset mean and
  sigma); the wall-clock rates differ from run to run and are not held;
* ``test_imu`` (plain and ``--rig``): the same lines (sample count,
  spacing, per-axis statistics, the rig mode's batches), and the
  preintegrated rotations within 1e-6 deg of each other, which bounds the
  difference of the two gyro rotation errors;
* ``test_stream_resolutions``: the same stream shapes, intrinsics and
  color-mode lines;
* ``rgbd_stream`` (grayscale and ``--color``, one frame): the depth valid
  share within 1 % of the pixels and the median depth within 1 mm of the
  reference's EXACT SGM path (the ``exact_jax_sgm`` fixture), never its
  CPU halo scan;
* ``test_camera_driver`` (synthetic): the same frame count, timestamps,
  shapes and stream-clock rate.
"""

from __future__ import annotations

import contextlib
import io
import re
import sys

import numpy as np
import pytest
import torch
from test_torch_stereo import exact_jax_sgm  # noqa: F401  (fixture)

import examples.pull_extrinsics as j_pull
import examples.rgbd_stream as j_rgbd
import examples.test_camera_driver as j_driver
import examples.test_camera_rig as j_rig
import examples.test_imu as j_imu
import examples.test_stream_resolutions as j_res
import thor_slam_tpu.camera.utils as j_cam_utils
import thor_slam_tpu.engine.imu as j_imu_mod
import thor_slam_tpu.pipeline.rgbd as j_rgbd_mod
import thor_slam_tpu_torch.camera.utils as t_cam_utils
import thor_slam_tpu_torch.engine.imu as t_imu_mod
import thor_slam_tpu_torch.pipeline.rgbd as t_rgbd_mod
from thor_slam_tpu_torch.examples import pull_extrinsics as t_pull
from thor_slam_tpu_torch.examples import rgbd_stream as t_rgbd
from thor_slam_tpu_torch.examples import test_camera_driver as t_driver
from thor_slam_tpu_torch.examples import test_camera_rig as t_rig
from thor_slam_tpu_torch.examples import test_imu as t_imu
from thor_slam_tpu_torch.examples import test_stream_resolutions as t_res

torch.set_num_threads(2)


def _run(module, argv, reference: bool, monkeypatch) -> list[str]:
    """Run a demo's ``main`` with ``argv``; its output lines. The
    reference's demos read ``sys.argv``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if reference:
            monkeypatch.setattr(sys, "argv", ["demo", *argv])
            rc = module.main()
        else:
            rc = module.main(argv)
    assert rc == 0
    return buf.getvalue().splitlines()


def _record(monkeypatch, module, attr) -> list:
    """Wrap ``module.attr`` so that each call's result is kept."""
    results = []
    fn = getattr(module, attr)

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        results.append(out)
        return out

    monkeypatch.setattr(module, attr, wrapper)
    return results


def test_pull_extrinsics(monkeypatch):
    got_ext = _record(monkeypatch, t_cam_utils, "load_rig_extrinsics_from_urdf")
    want_ext = _record(monkeypatch, j_cam_utils, "load_rig_extrinsics_from_urdf")
    got = _run(t_pull, [], False, monkeypatch)
    want = _run(j_pull, [], True, monkeypatch)
    assert got == want and len(got) == 4
    (g,), (w,) = got_ext, want_ext
    assert sorted(g) == sorted(w)
    for name in w:
        np.testing.assert_array_equal(g[name].to_4x4_matrix(), w[name].to_4x4_matrix())


def _sync_stats(lines):
    keep = []
    for ln in lines:
        if ln.startswith(("Sync delta", "Final queue depths")):
            keep.append(ln)
        elif ln.startswith("Synchronized sets"):
            keep.append(ln.split(" in ")[0])
        elif "injected clock offset" in ln:
            keep.append(re.sub(r"fps=\s*[\d.]+", "", ln))
    return keep


def test_camera_rig_sync_statistics(monkeypatch):
    argv = ["--cameras", "2", "--frames", "12"]
    got = _sync_stats(_run(t_rig, argv, False, monkeypatch))
    want = _sync_stats(_run(j_rig, argv, True, monkeypatch))
    assert len(want) == 5 and got == want


def _angle_deg(a, b) -> float:
    """The angle of a^T b, well conditioned near 0 (arccos of the trace
    alone reads ~1e-6 deg of rounding between equal matrices)."""
    r = np.asarray(a, np.float64).T @ np.asarray(b, np.float64)
    sin = np.linalg.norm([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]]) / 2.0
    return float(np.degrees(np.arctan2(sin, (np.trace(r) - 1.0) / 2.0)))


@pytest.mark.parametrize("argv", [[], ["--rig"]], ids=["plain", "rig"])
def test_imu_diagnostics(argv, monkeypatch):
    got_pre = _record(monkeypatch, t_imu_mod, "preintegrate_np")
    want_pre = _record(monkeypatch, j_imu_mod, "preintegrate_np")
    got = _run(t_imu, ["--seconds", "1.0", *argv], False, monkeypatch)
    want = _run(j_imu, ["--seconds", "1.0", *argv], True, monkeypatch)
    assert got == want
    assert re.match(r"\d+ IMU samples in 1.0s", got[0]) and int(got[0].split()[0]) > 300
    assert any(ln.startswith("gyro-integrated rotation error") for ln in got)
    if argv:
        assert any(ln.startswith("rig mode:") for ln in got)
    (g,), (w,) = got_pre, want_pre
    assert _angle_deg(g.delta_r, w.delta_r) <= 1e-6


def test_stream_resolutions(monkeypatch):
    got = _run(t_res, ["--device", "cpu"], False, monkeypatch)
    want = _run(j_res, [], True, monkeypatch)

    def same(lines):  # the depth statistic is the SGM's, held by test_rgbd_stream
        return [ln for ln in lines if not ln.startswith("depth valid")]

    assert same(got) == same(want)
    assert any(ln.startswith("RGB-D stream: (160, 100)  fx=") for ln in got)
    assert sum(ln.startswith("OK:") for ln in got) == 2


@pytest.mark.parametrize("mode", ["gray", "color"])
def test_rgbd_stream(mode, exact_jax_sgm, monkeypatch, tmp_path):  # noqa: F811
    got_frames = _record(monkeypatch, t_rgbd_mod.RGBDProcessor, "process")
    want_frames = _record(monkeypatch, j_rgbd_mod.RGBDProcessor, "process")
    flags = ["--frames", "1"] + (["--color"] if mode == "color" else [])
    got = _run(t_rgbd, [*flags, "--out", str(tmp_path / "port"), "--device", "cpu"], False, monkeypatch)
    _run(j_rgbd, [*flags, "--out", str(tmp_path / "ref")], True, monkeypatch)
    (g,), (w,) = got_frames, want_frames
    assert g.depth_mm.shape == w.depth_mm.shape and g.rgb.shape == w.rgb.shape
    gv, wv = g.depth_mm > 0, w.depth_mm > 0
    assert abs(gv.mean() - wv.mean()) <= 0.01 and wv.mean() > 0.5
    assert abs(float(np.median(g.depth_mm[gv])) - float(np.median(w.depth_mm[wv]))) <= 1.0
    assert any(ln.startswith("frame 0: depth valid") for ln in got)
    assert len(list((tmp_path / "port").iterdir())) == 1


def test_camera_driver_synthetic(monkeypatch):
    def same(lines):  # the wall-clock rate varies from run to run
        return [ln.split(" | wall")[0] for ln in lines]

    got = _run(t_driver, ["--frames", "12"], False, monkeypatch)
    want = _run(j_driver, ["--frames", "12"], True, monkeypatch)
    assert same(got) == same(want)
    assert same(got)[-1] == "12 frames | stream clock 30.0 fps"
