"""The port's SLAM adapters and ROS helpers against the JAX package's.

``thor_slam_tpu_torch.slam.adapters`` (``NullSlamEngine``, the wire
helpers of ``external_ros``, the cloud packers of ``ros_bridge``) and the
scripts ``publish_odom_tf``, ``find_cameras`` and ``set_ip`` are copies of the
reference's numpy code: each is held to the original on the same inputs,
byte for byte where it packs bytes. The ROS shells themselves need rclpy
(absent here, as on the card's machine) and are driven through fakes in
``tests/test_torch_runners.py``. The port's ROS launch file
(``thor_slam_tpu_torch/launch/``) is read with ``ast`` (``launch_ros`` is
absent): it starts the port's modules with the reference launch file's
arguments and names its topics.
"""

from __future__ import annotations

import ast
import contextlib
import importlib.util
import io
import re
from pathlib import Path

import numpy as np
import pytest

from thor_slam_tpu import geometry as jgeom
from thor_slam_tpu.camera import types as jtypes
from thor_slam_tpu.camera.rig import CameraRig as JaxCameraRig
from thor_slam_tpu.camera.sources import synthetic as jsyn
from thor_slam_tpu.slam import interface as jiface
from thor_slam_tpu.slam.adapters import external_ros as jext
from thor_slam_tpu.slam.adapters import null_engine as jnull
from thor_slam_tpu.slam.adapters import ros_bridge as jros
from thor_slam_tpu_torch.camera import types as ttypes
from thor_slam_tpu_torch.camera.rig import CameraRig as PortCameraRig
from thor_slam_tpu_torch.camera.sources import synthetic as tsyn
from thor_slam_tpu_torch.slam import interface as tiface
from thor_slam_tpu_torch.slam.adapters import external_ros as text
from thor_slam_tpu_torch.slam.adapters import null_engine as tnull
from thor_slam_tpu_torch.slam.adapters import ros_bridge as tros

PACKAGES = {
    "reference": (jsyn, JaxCameraRig, jext, jtypes),
    "port": (tsyn, PortCameraRig, text, ttypes),
}


def _calibration(pkg: str, num_sources: int, mono: bool = False):
    syn, rig_cls, _, _ = PACKAGES[pkg]
    spec = syn.SyntheticRigSpec(num_sources=num_sources, stereo=not mono, width=64, height=48)
    sources, rig_ext, _, _ = syn.make_synthetic_rig(spec)
    with rig_cls(sources, rig_extrinsics=rig_ext, imu_source=sources[0].name) as rig:
        return rig.calibration


def _cam_fields(cams) -> list:
    return [(c.source_name, c.cam_idx, c.intrinsics.width, c.intrinsics.height, c.intrinsics.matrix.tolist(),
             np.asarray(c.intrinsics.coeffs).tolist(), c.extrinsics.to_4x4_matrix().tolist()) for c in cams]


@pytest.mark.parametrize("num_sources,num_cameras,mono", [(2, 3, False), (2, 4, False), (3, 8, False), (2, 2, True)])
def test_extract_cameras_matches_reference(num_sources, num_cameras, mono):
    got = [PACKAGES[p][2].extract_cameras(_calibration(p, num_sources, mono), num_cameras) for p in PACKAGES]
    assert _cam_fields(got[0]) == _cam_fields(got[1])


@pytest.mark.parametrize("num_sources", [1, 2])
def test_projection_and_tf_match_reference(num_sources):
    out = []
    for p, (_, _, ext, _) in PACKAGES.items():
        cams = ext.extract_cameras(_calibration(p, num_sources), 2 * num_sources)
        tfs = ext.camera_tf_list(cams)
        out.append(([ext.projection_matrix(cams, i).tolist() for i in range(len(cams))],
                    [(t["parent"], t["child"], t["translation"].tolist(), t["quat_xyzw"].tolist()) for t in tfs]))
    assert out[0] == out[1]
    np.testing.assert_array_equal(text.OPTICAL_FROM_CAMERA_QUAT, jext.OPTICAL_FROM_CAMERA_QUAT)


def test_projection_of_a_rotated_stereo_pair_matches_reference():
    """The baseline measured in the left camera's frame (the reference's
    test case, and seeded rotations)."""
    rng = np.random.default_rng(0)
    for rot in [jgeom.euler_xyz_extrinsic_to_matrix(0.0, 0.0, np.pi / 2)] + [
        jgeom.quat_to_matrix(q / np.linalg.norm(q)) for q in rng.normal(size=(3, 4))
    ]:
        got = []
        for _, _, ext, types in PACKAGES.values():
            intr = types.Intrinsics(width=64, height=48, matrix=np.array([[400.0, 0, 32], [0, 400, 24], [0, 0, 1]]),
                                    coeffs=np.zeros(5))
            cams = [ext.CameraConfig(intr, types.Extrinsics(rot, np.zeros(3)), "cam", 0),
                    ext.CameraConfig(intr, types.Extrinsics(rot, rot @ np.array([0.12, 0, 0])), "cam", 1)]
            got.append([ext.projection_matrix(cams, i) for i in range(2)])
        for a, b in zip(*got):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ts", [0.0, 1.5, 5.9999999999, 1e9 + 0.123456789, 123.000000000499, 7.9999999995])
def test_split_stamp_matches_reference(ts):
    assert text.split_stamp(ts) == jext.split_stamp(ts)


def _images():
    rng = np.random.default_rng(1)
    return {
        "mono8": rng.integers(0, 256, (3, 4), dtype=np.uint8),
        "bgr": rng.integers(0, 256, (2, 5, 3), dtype=np.uint8),
        "float": rng.uniform(-0.2, 1.2, (4, 3)).astype(np.float32),
        "float64_color": rng.uniform(0, 1, (2, 2, 3)),
        "int16": rng.integers(-50, 400, (3, 3)).astype(np.int16),
        "strided": rng.integers(0, 256, (6, 8), dtype=np.uint8)[::2, 1::2],
        "rgba": np.zeros((2, 2, 4), np.uint8),
        "3d_1ch": np.zeros((2, 2, 1), np.uint8),
    }


@pytest.mark.parametrize("name", sorted(_images()))
def test_image_wire_matches_reference(name):
    img = _images()[name]
    results = []
    for ext in (jext, text):
        try:
            results.append(ext.image_wire(img.copy()))
        except ValueError as e:
            results.append(str(e))
    assert results[0] == results[1]


@pytest.mark.parametrize("n", range(10))
def test_distortion_wire_matches_reference(n):
    coeffs = np.random.default_rng(n).normal(size=n)
    assert text.distortion_wire(coeffs) == jext.distortion_wire(coeffs)


IMU_CASES = {
    "batched": {"accelerometer": np.arange(9.0).reshape(3, 3), "gyroscope": np.arange(9.0, 18).reshape(3, 3)},
    "single": {"accelerometer": [1.0, 2, 3], "gyroscope": [4.0, 5, 6]},
    "no_gyro": {"accelerometer": [1.0, 2, 3]},
    "empty": {"accelerometer": np.zeros((0, 3)), "gyroscope": np.zeros((0, 3))},
    "short": {"accelerometer": [1.0, 2], "gyroscope": [4.0, 5]},
    "wide": {"accelerometer": np.arange(8.0).reshape(2, 4), "gyroscope": np.arange(8.0).reshape(2, 4)},
}


@pytest.mark.parametrize("name", sorted(IMU_CASES))
def test_latest_imu_sample_matches_reference(name):
    got, want = text.latest_imu_sample(IMU_CASES[name]), jext.latest_imu_sample(IMU_CASES[name])
    assert (got is None) == (want is None)
    if want is not None:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [0, 1, 17])
def test_cloud_packers_match_reference(n):
    rng = np.random.default_rng(n)
    points = rng.normal(scale=3.0, size=(n, 3))
    colors = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    assert tros.pack_xyz_cloud(points) == jros.pack_xyz_cloud(points)
    assert tros.pack_xyz_cloud(points.tolist()) == jros.pack_xyz_cloud(points.tolist())
    assert tros.pack_xyzrgb_cloud(points, colors) == jros.pack_xyzrgb_cloud(points, colors)


def test_adapter_modules_import_without_ros():
    """The modules import with rclpy absent; ``HAVE_ROS`` gates the shells;
    ``ExternalRosEngine`` is resolved lazily, as in the reference."""
    import thor_slam_tpu.slam.adapters as jpkg
    import thor_slam_tpu_torch.slam.adapters as tpkg

    assert text.HAVE_ROS == jext.HAVE_ROS and tros.HAVE_ROS == jros.HAVE_ROS
    assert tpkg.__all__ == jpkg.__all__
    assert tpkg.ExternalRosEngine is text.ExternalRosEngine
    with pytest.raises(AttributeError):
        tpkg.NoSuchEngine  # noqa: B018
    if not jros.HAVE_ROS:
        for cls in (jros.RosBridge, tros.RosBridge, jext.ExternalRosEngine, text.ExternalRosEngine):
            with pytest.raises(ImportError, match="rclpy"):
                cls()


def _null_trace(pkg: str, num_cameras: int) -> list:
    """One script of calls on a NullSlamEngine: states, poses, cameras."""
    null, iface = (jnull, jiface) if pkg == "reference" else (tnull, tiface)
    syn, rig_cls, _, _ = PACKAGES[pkg]
    sources, rig_ext, _, _ = syn.make_synthetic_rig(syn.SyntheticRigSpec(num_sources=2, stereo=True, width=64, height=48))
    eng = null.NullSlamEngine()
    trace = [eng.get_tracking_state().name]
    with rig_cls(sources, rig_extrinsics=rig_ext, imu_source=sources[0].name) as rig:
        sync = rig.get_synchronized_frames()
        with pytest.raises(RuntimeError, match="initialize"):
            eng.process_frames(sync)
        eng.initialize(rig.calibration, iface.SlamConfig(num_cameras=num_cameras))
        trace.append(_cam_fields(eng.cameras))
        for i in range(4):
            if i == 2:
                eng.reset()
                trace.append(("reset", eng.get_tracking_state().name))
            pose = eng.process_frames(rig.get_synchronized_frames())
            trace.append((eng.get_tracking_state().name, pose.timestamp, pose.to_4x4_matrix().tolist()))
    m = eng.get_map()
    trace.append((len(m.points), len(m.keyframe_poses)))
    eng.shutdown()
    eng.reset()
    trace.append(eng.get_tracking_state().name)
    return trace


@pytest.mark.parametrize("num_cameras", [2, 3, 8])
def test_null_engine_behaves_as_the_reference(num_cameras):
    assert _null_trace("port", num_cameras) == _null_trace("reference", num_cameras)


@pytest.mark.parametrize("seed", range(3))
def test_map_t_odom_from_pose_matches_reference(seed):
    from scripts import publish_odom_tf as jtf
    from thor_slam_tpu_torch.scripts import publish_odom_tf as ttf

    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    pose = jgeom.se3_from_pose(rng.normal(size=3), q / np.linalg.norm(q))
    np.testing.assert_array_equal(ttf.map_t_odom_from_pose(pose), jtf.map_t_odom_from_pose(pose))


@pytest.mark.parametrize("script", ["publish_odom_tf", "find_cameras", "set_ip"])
def test_hardware_scripts_without_their_sdk_match_reference(script, monkeypatch):
    """Without rclpy / depthai both packages' scripts say so and return 1."""
    import importlib
    import sys

    if script == "set_ip":  # its main parses sys.argv
        monkeypatch.setattr(sys, "argv", ["set_ip", "192.168.2.21", "--dynamic"])
    out = []
    for name in (f"scripts.{script}", f"thor_slam_tpu_torch.scripts.{script}"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = importlib.import_module(name).main()
        out.append((rc, buf.getvalue()))
    assert out[0] == out[1]
    assert out[0][0] == 1


LAUNCH_FILES = {
    "reference": Path(__file__).resolve().parents[1] / "launch" / "thor_slam_tpu.launch.py",
    "port": Path(__file__).resolve().parents[1] / "thor_slam_tpu_torch" / "launch" / "thor_slam_tpu_torch.launch.py",
}


def _launch_processes(path: Path) -> list[list[str]]:
    """The ``cmd`` of every ``ExecuteProcess`` in a launch file, a name
    bound at run time as ``<name>``."""
    cmds = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "ExecuteProcess":
            cmd = next(k.value for k in node.keywords if k.arg == "cmd")
            cmds.append([e.value if isinstance(e, ast.Constant) else f"<{e.id}>" for e in cmd.elts])
    return cmds


def test_launch_file_starts_the_ports_modules_with_the_reference_arguments():
    ref, port = (_launch_processes(LAUNCH_FILES[k]) for k in ("reference", "port"))
    assert len(port) == len(ref) == 2
    for got, want in zip(port, ref):
        at = got.index("-m")
        module = got[at + 1]
        assert module == "thor_slam_tpu_torch." + want[at + 1]
        assert importlib.util.find_spec(module) is not None, module
        assert got[:at + 1] + got[at + 2:] == want[:at + 1] + want[at + 2:]


def test_launch_file_topics_match_the_reference():
    def topics(path):
        return set(re.findall(r"``(/[\w/]+)``", path.read_text()))

    want = topics(LAUNCH_FILES["reference"])
    assert want and topics(LAUNCH_FILES["port"]) == want
    # The processes it starts use them: the bridge publishes, the TF node subscribes.
    for module in ("slam.adapters.ros_bridge", "scripts.publish_odom_tf"):
        source = importlib.util.find_spec(f"thor_slam_tpu_torch.{module}").origin
        assert all(f'"{t}"' in Path(source).read_text() for t in want), module
