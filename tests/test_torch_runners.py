"""The port's entry points, ``scripts/run_pipeline.py`` and ``run_slam.py``,
on the CPU, against the JAX package's runners.

A tiny synthetic config: 2 stereo sources at 160x100 with a 320x200 colour
imager each, in a small room, mapping on at (32, 32, 32) x 0.1 m, and the
deployed YAML's ``backend`` values but ``adaptive_half_res`` (a CPU tick
falls in the controller's band and would degrade one run and not the
next). The port's ``run_pipeline.run`` must return 0, print its ``Done:``
and ``Dense map:`` lines, and save a grid the JAX package's ``load_grid``
reads and a PLY that parses. Against the reference's ``run_pipeline.run``
on the same config: the same frame and integrated-frame counts, and
observed-voxel sets (weight > 0) with IoU >= 0.95 (the two engines' poses
differ at the level of their RANSAC draws, so the grids are not compared
voxel by voxel).
"""

from __future__ import annotations

import contextlib
import io
import logging
import re

import numpy as np
import pytest
import torch
import yaml

from thor_slam_tpu.mapping import load_grid as jax_load_grid
from thor_slam_tpu.utils.config import RunConfig as JaxRunConfig
from thor_slam_tpu_torch.scripts import run_pipeline, run_slam
from thor_slam_tpu_torch.slam.interface import SlamConfig
from thor_slam_tpu_torch.utils.config import RunConfig

torch.set_num_threads(2)

FRAMES = 10
RGBD_EVERY = 5
MIN_OBSERVED_IOU = 0.95
CFG = {
    "fps": 30,
    "imu_report_rate": 400,
    "queue_size": 8,
    "rig_queue_size": 10,
    "watchdog_timeout_s": 1.0,
    "backend": {
        "max_keypoints": 512, "enable_ba": True, "enable_loop_closure": True, "use_imu": True,
        "use_accel": True, "pipelined": True, "pipeline_depth": 1, "devices": 1, "light_half_res": False,
        "adaptive_half_res": False, "tracker": {},
    },
    "synthetic": {
        "enabled": True, "num_cameras": 2, "resolution": [160, 100], "baseline_m": 0.075,
        "trajectory_radius": 0.6, "room_half_extents": [1.5, 1.5, 1.0], "color_camera": True,
        "color_resolution": [320, 200],
    },
    "mapping": {"enabled": True, "voxel_size_m": 0.1, "dims": [32, 32, 32]},
}


def _run(module, cfg, tmp, **kw) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.run(cfg, max_frames=FRAMES, rgbd_every=RGBD_EVERY, save_dense_map=str(tmp / "grid.npz"),
                        save_ply=str(tmp / "mesh.ply"), **kw)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port")
    rc, text = _run(run_pipeline, RunConfig.from_dict(CFG), tmp, device="cpu")
    return rc, text, tmp


def _counts(text: str) -> tuple[int, int]:
    """(frames, integrated frames) from the ``Done:`` and ``Dense map:`` lines."""
    frames = int(re.search(r"^Done: (\d+) frames", text, re.M).group(1))
    integrated = int(re.search(r"^Dense map: (\d+) frames integrated", text, re.M).group(1))
    return frames, integrated


def _read_ply(path) -> tuple[int, int]:
    data = path.read_bytes()
    head, body = data.split(b"end_header\n", 1)
    nv = int(re.search(rb"element vertex (\d+)", head).group(1))
    nt = int(re.search(rb"element face (\d+)", head).group(1))
    assert len(body) == nv * 15 + nt * 13
    faces = np.frombuffer(body[nv * 15:], np.dtype([("n", np.uint8), ("idx", "<i4", 3)]))
    assert (faces["n"] == 3).all() and (faces["idx"] >= 0).all() and (faces["idx"] < nv).all()
    return nv, nt


def test_port_runner_maps_and_saves(port_run):
    rc, text, tmp = port_run
    assert rc == 0
    assert _counts(text) == (FRAMES, FRAMES // RGBD_EVERY)
    assert re.search(r"^Dense map: .* mesh \d+v/\d+t \| costmap \d+ occupied / \d+ observed cells$", text, re.M)
    grid, spec = jax_load_grid(tmp / "grid.npz")
    assert spec.dims == (32, 32, 32) and spec.voxel_size_m == 0.1
    weight = np.asarray(grid.weight)
    assert (weight > 0).sum() > 500 and (np.asarray(grid.tsdf)[weight > 0] < 0).any()
    nv, nt = _read_ply(tmp / "mesh.ply")
    assert nv > 0 and nt > 0


def test_port_runner_against_reference(port_run, tmp_path):
    from scripts import run_pipeline as jax_run_pipeline

    rc, text, tmp = port_run
    jrc, jtext = _run(jax_run_pipeline, JaxRunConfig.from_dict(CFG), tmp_path)
    assert rc == jrc == 0
    assert _counts(text) == _counts(jtext)
    got, _ = jax_load_grid(tmp / "grid.npz")
    want, _ = jax_load_grid(tmp_path / "grid.npz")
    np.testing.assert_array_equal(np.asarray(got.origin), np.asarray(want.origin))
    a, b = np.asarray(got.weight) > 0, np.asarray(want.weight) > 0
    iou = (a & b).sum() / (a | b).sum()
    print(f"observed voxels: port {a.sum()}, reference {b.sum()}, IoU {iou:.4f}")
    assert iou >= MIN_OBSERVED_IOU


def test_run_slam_saves_a_map_the_engine_loads(tmp_path):
    cfg = RunConfig.from_dict(CFG)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run_slam.run(cfg, max_frames=FRAMES, save_map_path=str(tmp_path / "map.npz"), device="cpu")
    assert rc == 0
    done = re.search(r"^Done: (\d+) frames \| map: (\d+) points, (\d+) keyframes", out.getvalue(), re.M)
    assert done and int(done.group(1)) == FRAMES and int(done.group(2)) > 0
    sources, rig_ext = run_slam.build_synthetic_sources(cfg)
    engine = run_slam.build_engine(cfg, "cpu")
    with run_slam.build_rig(cfg, sources, rig_ext) as rig:
        engine.initialize(rig.calibration, SlamConfig(num_cameras=cfg.num_cameras, expected_fps=cfg.fps))
        assert engine.load_map(str(tmp_path / "map.npz"))
    loaded = engine.get_map()
    assert (len(loaded.points), len(loaded.keyframe_poses)) == (int(done.group(2)), int(done.group(3)))
    engine.shutdown()


def test_main_reads_a_yaml_config(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump({**CFG, "synthetic": {**CFG["synthetic"], "enabled": False},
                                    "mapping": {**CFG["mapping"], "enabled": False}}))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run_pipeline.main(["--config", str(path), "--synthetic", "--map", "--frames", "5", "--device", "cpu"])
    assert rc == 0
    assert _counts(out.getvalue()) == (5, 1)


def test_engine_takes_the_reference_runners_arguments():
    """``build_engine`` passes the ``backend`` section as the reference's
    runners do: ``enable_loop_closure`` is not among them (the engine's
    default holds, the YAML key has no effect there either)."""
    cfg = RunConfig.from_dict({**CFG, "backend": {**CFG["backend"], "enable_loop_closure": False,
                                                  "tracker": {"fast_threshold": 0.07}}})
    engine = run_slam.build_engine(cfg, "cpu")
    assert engine._pipelined and engine._pipeline_depth == 1 and not engine._light_ctl.adaptive_requested
    assert engine._param_overrides == {"max_keypoints": 512, "fast_threshold": 0.07}
    assert engine._config is None or engine._config.enable_loop_closure
    engine.shutdown()


@pytest.mark.parametrize("name", ["run_slam", "run_pipeline"])
def test_unported_branches_return_2(name, caplog):
    """A config that lists cameras without ``synthetic.enabled`` needs depthai
    and ``--ros`` needs rclpy: without them, both packages' runners log the
    same errors (the ``ImportError`` of ``LuxonisCameraSource``, "--ros
    requested but rclpy is not installed") and return 2. ``main`` checks
    ``--ros`` before reading the config."""
    import importlib

    from thor_slam_tpu.camera.sources.luxonis import HAVE_DEPTHAI
    from thor_slam_tpu.slam.adapters.ros_bridge import HAVE_ROS

    if HAVE_DEPTHAI or HAVE_ROS:
        pytest.skip("depthai or rclpy present")
    hardware = {"cameras": [{"ip": "192.168.2.21"}]}
    logs = []
    for module, config in ((importlib.import_module(f"scripts.{name}"), JaxRunConfig),
                           (importlib.import_module(f"thor_slam_tpu_torch.scripts.{name}"), RunConfig)):
        kw = {} if module.__name__.startswith("scripts.") else {"device": "cpu"}
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            assert module.run(config.from_dict(hardware), max_frames=1, **kw) == 2
            assert module.run(config.from_dict(CFG), max_frames=1, use_ros=True, **kw) == 2
        logs.append([(r.name, r.getMessage()) for r in caplog.records if r.levelno >= logging.ERROR])
    assert logs[0] == logs[1]
    assert "depthai is not installed" in logs[1][0][1]
    assert logs[1][1] == (name, "--ros requested but rclpy is not installed")
    module = importlib.import_module(f"thor_slam_tpu_torch.scripts.{name}")
    caplog.clear()
    with caplog.at_level(logging.ERROR):
        assert module.main(["--ros", "--config", "no/such/file.yaml"]) == 2
    assert [r.getMessage() for r in caplog.records] == ["--ros requested but rclpy is not installed"]


def test_save_flags_need_the_mapper():
    assert run_pipeline.main(["--synthetic", "--save-ply", "x.ply", "--device", "cpu"]) == 2
