"""The runners' hardware and ROS branches, through fakes, against the JAX
package's runners.

There is no camera and no ROS here. ``LuxonisCameraSource`` is replaced in
both packages by a fake that records its configuration and reports the
IMU's extrinsics, so ``build_hardware_sources`` of either package can be
held to the other: the same camera configurations, the same URDF rig
extrinsics and the same IMU extrinsics (DRB -> RDF, composed into the rig
frame). For ``--ros``, ``HAVE_ROS`` is forced on and ``RosBridge`` replaced
by a recorder in both packages, and each runner's clock by one that
advances a second a call (a status line every second tick): both packages'
``run_slam`` and ``run_pipeline`` make the same publish calls, tick for
tick, with host arrays for the RGB-D frames.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import types

import numpy as np
import pytest
import torch

from thor_slam_tpu.utils.config import RunConfig as JaxRunConfig
from thor_slam_tpu_torch.utils.config import RunConfig

torch.set_num_threads(2)

PACKAGES = {"reference": "thor_slam_tpu", "port": "thor_slam_tpu_torch"}
#: tests/test_torch_runners.py's config: 2 stereo sources at 160x100 with a
#: 320x200 colour imager each, mapping on at (32, 32, 32) x 0.1 m.
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
URDF = """<?xml version="1.0"?>
<robot name="rig">
  <link name="base_link"/>
  <joint name="j1" type="fixed"><parent link="base_link"/><child link="link_Camera_1"/>
    <origin xyz="0.2 -0.1 0.05" rpy="0.05 -0.2 0.7"/></joint>
  <joint name="j2" type="fixed"><parent link="base_link"/><child link="link_Camera_2"/>
    <origin xyz="-0.2 0.1 0.0" rpy="0 0 3.1"/></joint>
</robot>
"""
HARDWARE = {
    "fps": 25,
    "queue_size": 6,
    "imu_report_rate": 200,
    "cameras": [
        {"ip": "192.168.2.21", "enable_rgbd": True, "rgb_sensor_resolution": [1280, 800],
         "rgb_output_resolution": [640, 400]},
        {"ip": "192.168.2.22", "stereo": False, "sensor_type": "COLOR", "resolution": [1280, 800],
         "output_resolution": [640, 400]},
        {"ip": "192.168.2.25", "resolution": [1280, 800]},
    ],
    "nvblox_cameras": ["192.168.2.25"],
}
#: The fake IMU's pose in its camera, centimetres as DepthAI's EEPROM holds
#: them are already converted by the source: a rotation and a lever arm.
SENSOR_T = np.array([[0.0, -1.0, 0.0, 0.012], [1.0, 0.0, 0.0, -0.03], [0.0, 0.0, 1.0, 0.004], [0, 0, 0, 1]])


def _fake_luxonis(pkg: str, made: list):
    ctypes_mod = importlib.import_module(f"{PACKAGES[pkg]}.camera.types")

    class FakeLuxonis:
        def __init__(self, config) -> None:
            made.append(config)
            self._config = config

        @property
        def name(self) -> str:
            return str(self._config.ip)

        @property
        def has_sensor_data(self) -> bool:
            return self._config.read_imu

        def get_sensor_extrinsics(self):
            return ctypes_mod.Extrinsics.from_4x4_matrix(SENSOR_T) if self._config.read_imu else None

    return FakeLuxonis


def _config_fields(cfg) -> dict:
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["ip"] = str(out["ip"])
    out["rgbd"] = None if cfg.rgbd is None else dataclasses.asdict(cfg.rgbd)
    return out


@pytest.mark.parametrize("urdf", [True, False], ids=["urdf", "no-urdf"])
def test_hardware_sources_match_reference(monkeypatch, tmp_path, urdf):
    path = tmp_path / "rig.urdf"
    path.write_text(URDF)
    data = {**HARDWARE, "urdf_path": str(path) if urdf else ""}
    out = {}
    for pkg, config in (("reference", JaxRunConfig), ("port", RunConfig)):
        made: list = []
        monkeypatch.setattr(importlib.import_module(f"{PACKAGES[pkg]}.camera.sources.luxonis"), "LuxonisCameraSource",
                            _fake_luxonis(pkg, made))
        runner = importlib.import_module("scripts.run_slam" if pkg == "reference" else "thor_slam_tpu_torch.scripts.run_slam")
        sources, rig_ext, imu_ext = runner.build_hardware_sources(config.from_dict(data))
        out[pkg] = (
            [_config_fields(c) for c in made], [s.name for s in sources],
            {name: e.to_4x4_matrix() for name, e in rig_ext.items()},
            imu_ext.source_name, imu_ext.extrinsics.to_4x4_matrix(),
        )
    (jc, jn, jr, ji, jm), (tc, tn, tr, ti, tm) = out["reference"], out["port"]
    assert tc == jc and tn == jn and ti == ji
    assert [c["read_imu"] for c in tc] == [True, False, False]
    assert sorted(tr) == sorted(jr) == (["192.168.2.21", "192.168.2.22"] if urdf else [])
    for name in jr:
        np.testing.assert_array_equal(tr[name], jr[name])
    np.testing.assert_array_equal(tm, jm)


class _Recorder:
    """Stands in for ``RosBridge``: logs each publish call of a run."""

    def __init__(self, log: list) -> None:
        self.log = log

    def publish_pose(self, pose):
        self.log.append(("pose", pose.timestamp, pose.position.copy()))

    def publish_map_tf(self, map_t_odom, timestamp=0.0):
        assert np.asarray(map_t_odom).shape == (4, 4)
        self.log.append(("map_tf", timestamp))

    def publish_observations(self, points, timestamp):
        assert np.asarray(points).reshape(-1, 3).dtype.kind == "f"
        self.log.append(("observations", timestamp))

    def publish_landmarks(self, points, timestamp):
        assert np.asarray(points).reshape(-1, 3).dtype.kind == "f"
        self.log.append(("landmarks", timestamp))

    def publish_rgbd(self, index, frame):
        # The bridge packs host bytes: rgb, 16UC1 millimetres.
        assert isinstance(frame.rgb, np.ndarray) and isinstance(frame.depth_mm, np.ndarray)
        assert frame.depth_mm.dtype == np.uint16
        self.log.append(("rgbd", index, frame.timestamp, frame.rgb.shape, frame.depth_mm.shape))

    def publish_surface_cloud(self, points, colors, timestamp):
        assert len(points) == len(colors) > 0
        self.log.append(("surface", timestamp))

    def publish_mesh_marker(self, mesh, timestamp):
        assert len(mesh.triangles) > 0
        self.log.append(("mesh",))

    def shutdown(self):
        self.log.append(("shutdown",))


def _fake_time():
    clock = iter(range(10**6))
    return types.SimpleNamespace(monotonic=lambda: float(next(clock)), time=lambda: 0.0, sleep=lambda s: None)


def _ros_run(monkeypatch, pkg: str, name: str) -> tuple[int, list]:
    base = PACKAGES[pkg]
    bridge = importlib.import_module(f"{base}.slam.adapters.ros_bridge")
    log: list = []
    monkeypatch.setattr(bridge, "HAVE_ROS", True)
    monkeypatch.setattr(bridge, "RosBridge", lambda *a, **k: _Recorder(log))
    module = importlib.import_module(f"scripts.{name}" if pkg == "reference" else f"{base}.scripts.{name}")
    monkeypatch.setattr(module, "time", _fake_time())
    data = CFG if name == "run_pipeline" else {**CFG, "mapping": {**CFG["mapping"], "enabled": False}}
    cfg = (JaxRunConfig if pkg == "reference" else RunConfig).from_dict(data)
    kw = dict(rgbd_every=5) if name == "run_pipeline" else {}
    if pkg == "port":
        kw["device"] = "cpu"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = module.run(cfg, max_frames=10, use_ros=True, **kw)
    return rc, log


@pytest.mark.parametrize("name", ["run_slam", "run_pipeline"])
def test_ros_publish_calls_match_reference(monkeypatch, name):
    """The same publish calls in the same order, with the same stamps; the
    published poses within the 0.02 m of the engine parity tests."""
    (jrc, jlog), (trc, tlog) = (_ros_run(monkeypatch, pkg, name) for pkg in ("reference", "port"))
    assert jrc == trc == 0
    strip = [tuple(e for e in entry if not isinstance(e, np.ndarray)) for entry in tlog]
    assert strip == [tuple(e for e in entry if not isinstance(e, np.ndarray)) for entry in jlog]
    kinds = {entry[0] for entry in tlog}
    want = {"pose", "map_tf", "shutdown"} | (
        {"rgbd", "surface", "mesh"} if name == "run_pipeline" else {"observations", "landmarks"})
    assert want <= kinds, kinds
    for a, b in zip(tlog, jlog):
        if a[0] == "pose":
            np.testing.assert_allclose(a[2], b[2], atol=0.02)
