"""The port's camera utilities and sources against the JAX package's.

``thor_slam_tpu_torch.camera.utils`` (URDF extrinsics, the resolution
menu), ``camera.sources.luxonis`` (its pure helpers; the hardware shell
without depthai), ``camera.sources.dataset`` (EuRoC replay, recordings)
and ``scripts.make_euroc_synthetic`` are copies of the reference's numpy
code: each is held to the original on the same inputs, exactly. Both
packages' recordings replay in the other. The synthetic EuRoC sequence is
the reference's file for file but ``imu0/data.csv``, whose samples the
port writes in cam0's axes (the module's docstring says why).
"""

from __future__ import annotations

import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import pytest

from thor_slam_tpu.camera import types as jtypes
from thor_slam_tpu.camera import utils as jutils
from thor_slam_tpu.camera.sources import dataset as jdata
from thor_slam_tpu.camera.sources import luxonis as jlux
from thor_slam_tpu.camera.sources import synthetic as jsyn
from thor_slam_tpu_torch.camera import types as ttypes
from thor_slam_tpu_torch.camera import utils as tutils
from thor_slam_tpu_torch.camera.sources import dataset as tdata
from thor_slam_tpu_torch.camera.sources import luxonis as tlux
from thor_slam_tpu_torch.camera.sources import synthetic as tsyn

REPO = Path(__file__).resolve().parents[1]

# The fixture of tests/test_urdf.py: a star, a rotated camera, and a joint
# whose parent is not base_link.
RIG_URDF = """<?xml version="1.0"?>
<robot name="test_rig">
  <link name="base_link"/>
  <link name="link_Camera_1"/>
  <link name="link_Camera_2"/>
  <link name="link_orphan"/>
  <joint name="j1" type="fixed">
    <parent link="base_link"/>
    <child link="link_Camera_1"/>
    <origin xyz="1.0 0.5 0.25" rpy="0 0 0"/>
  </joint>
  <joint name="j2" type="fixed">
    <parent link="base_link"/>
    <child link="link_Camera_2"/>
    <origin xyz="0.1 -0.2 0.3" rpy="0.1 -0.4 1.2"/>
  </joint>
  <joint name="j_orphan" type="fixed">
    <parent link="link_Camera_1"/>
    <child link="link_orphan"/>
    <origin xyz="9 9 9" rpy="0 0 0"/>
  </joint>
</robot>
"""


def _seeded_joint(seed: int) -> str:
    rng = np.random.default_rng(seed)
    xyz = " ".join(repr(float(v)) for v in rng.normal(size=3))
    rpy = " ".join(repr(float(v)) for v in rng.uniform(-np.pi, np.pi, 3))
    return f'<joint name="j{seed}"><origin xyz="{xyz}" rpy="{rpy}"/></joint>'


JOINTS = [
    '<joint name="j"><origin xyz="1.0 0.5 0.25" rpy="0 0 0"/></joint>',
    '<joint name="j"><origin xyz="0 0 0" rpy="0.3 -0.7 2.1"/></joint>',
    '<joint name="j"></joint>',
    '<joint name="j"><origin xyz="1 2 3"/></joint>',
    f'<joint name="j"><origin xyz="0 0 0" rpy="0 0 {np.pi / 2}"/></joint>',
] + [_seeded_joint(s) for s in range(5)]


@pytest.mark.parametrize("joint", JOINTS, ids=range(len(JOINTS)))
def test_urdf_transform_matches_reference(joint):
    elem = ET.fromstring(joint)
    np.testing.assert_array_equal(tutils.parse_urdf_transform(elem), jutils.parse_urdf_transform(elem))


@pytest.mark.parametrize("camera_map", [
    {"192.168.2.21": "link_Camera_1", "192.168.2.22": "link_Camera_2"},
    {"x": "link_orphan"},
    {"x": "no_such_link", "y": "link_Camera_2"},
    {},
])
def test_urdf_rig_extrinsics_match_reference(tmp_path, camera_map):
    path = tmp_path / "rig.urdf"
    path.write_text(RIG_URDF)
    want = jutils.load_rig_extrinsics_from_urdf(path, camera_map)
    got = tutils.load_rig_extrinsics_from_urdf(str(path), camera_map)
    assert sorted(got) == sorted(want)
    for name in want:
        assert isinstance(got[name], ttypes.Extrinsics)
        np.testing.assert_array_equal(got[name].to_4x4_matrix(), want[name].to_4x4_matrix())
    for mod in (jutils, tutils):
        with pytest.raises(FileNotFoundError):
            mod.load_rig_extrinsics_from_urdf(tmp_path / "nope.urdf", camera_map)


CHOICES = [(640, 400), (1280, 720), (1920, 1080)]


@pytest.mark.parametrize("answers,choices", [
    (["1"], CHOICES),
    (["abc", "99", "-1", " 0 "], CHOICES),
    (["q"], CHOICES),
    (["QUIT"], CHOICES),
    ([""], CHOICES),
    ([], CHOICES),  # EOF
    (["0"], []),
])
def test_prompt_for_resolution_matches_reference(capsys, answers, choices):
    """The same choice and the same printed menu and complaints."""
    out = []
    for mod in (jutils, tutils):
        it = iter(answers)
        prompts = []

        def answer(prompt):
            prompts.append(prompt)
            try:
                return next(it)
            except StopIteration:
                raise EOFError from None

        got = mod.prompt_for_resolution(choices, prompt="Pick", input_fn=answer)
        out.append((got, prompts, capsys.readouterr().out))
    assert out[0] == out[1]


def test_depthai_helpers_need_depthai():
    for mod in (jutils, tutils):
        with pytest.raises(ImportError, match="depthai"):
            mod.get_luxonis_devices_info()


# ------------------------------------------------------------------ luxonis


def test_luxonis_tables_match_reference():
    assert tlux.SUPPORTED_RESOLUTIONS == jlux.SUPPORTED_RESOLUTIONS
    assert tlux.HAVE_DEPTHAI == jlux.HAVE_DEPTHAI
    for mod in (jlux, tlux):
        assert mod.LuxonisRGBDCameraConfig() == mod.LuxonisRGBDCameraConfig(None, None, True)


@pytest.mark.parametrize("wh", [(640, 400), (1280, 720), (1920, 1200), (123, 456), (400, 640)])
def test_luxonis_resolution_matches_reference(wh):
    results = []
    for mod in (jlux, tlux):
        try:
            r = mod.LuxonisResolution.from_tuple(wh)
            results.append((r.width, r.height))
        except ValueError as e:
            results.append(str(e))
    assert results[0] == results[1]


@pytest.mark.parametrize("seed", range(4))
def test_luxonis_calibration_helpers_match_reference(seed):
    rng = np.random.default_rng(seed)
    k = np.array([[rng.uniform(300, 900), 0, rng.uniform(300, 700)], [0, rng.uniform(300, 900), rng.uniform(200, 500)],
                  [0, 0, 1.0]])
    sensor, out = (1280, 800), tuple(int(v) for v in rng.integers(100, 1300, 2))
    np.testing.assert_array_equal(tlux.scale_intrinsics_to_output(k, sensor, out),
                                  jlux.scale_intrinsics_to_output(k, sensor, out))
    m = np.eye(4)
    m[:3, :3] = jsyn.OrbitTrajectory().pose(float(seed))[:3, :3]
    m[:3, 3] = rng.normal(scale=10.0, size=3)
    np.testing.assert_array_equal(tlux.extrinsics_cm_to_m(m), jlux.extrinsics_cm_to_m(m))


VALID = [(640, 400), (1280, 800), (1920, 1200), (4056, 3040)]


@pytest.mark.parametrize("valid,output,mono", [
    (VALID, (1280, 720), (640, 400)),
    ([(640, 400), (320, 200)], (1280, 800), (640, 400)),
    (VALID, None, (1280, 800)),
    (VALID, None, (640, 480)),
    ([], None, (640, 400)),
])
def test_select_rgb_sensor_resolution_matches_reference(valid, output, mono):
    results = []
    for mod in (jlux, tlux):
        try:
            results.append(mod.select_rgb_sensor_resolution(valid, output, mono))
        except ValueError as e:
            results.append(str(e))
    assert results[0] == results[1]


def _caps(color_on_a=True):
    res = {"CAM_A": [(1280, 800), (1920, 1200)], "CAM_B": [(640, 400), (1280, 800)],
           "CAM_C": [(640, 400), (1280, 800)]}
    modes = {"CAM_A": ["COLOR"] if color_on_a else ["MONO"], "CAM_B": ["MONO"], "CAM_C": ["MONO"]}
    return res, modes


# The cases of tests/test_sources.py::TestLuxonisNegotiation, as config
# keyword arguments (``rgbd`` the RGB-D config's) and the capability tables.
VALIDATE_CASES = [
    (dict(resolution=(640, 400)), True),
    (dict(resolution=(1920, 1200)), True),
    (dict(stereo=False, resolution=(1280, 800), sensor_type="COLOR", rgbd={}), True),
    (dict(resolution=(640, 400), rgbd={}), False),
    (dict(resolution=(640, 400), rgbd=dict(rgb_sensor_resolution=(1280, 800), rgb_output_resolution=(1920, 1200))), True),
    (dict(resolution=(640, 400), rgbd=dict(rgb_sensor_resolution=(4056, 3040))), True),
    (dict(resolution=(1920, 1200), sensor_type="COLOR"), True),
]


@pytest.mark.parametrize("kwargs,color_on_a", VALIDATE_CASES)
def test_validate_camera_config_matches_reference(kwargs, color_on_a):
    """The same errors, collected (not first-raised), in the same words."""
    results = []
    for mod, types in ((jlux, jtypes), (tlux, ttypes)):
        kw = dict(kwargs)
        if "rgbd" in kw:
            kw["rgbd"] = mod.LuxonisRGBDCameraConfig(**kw["rgbd"])
        cfg = mod.LuxonisCameraConfig(ip=types.IPv4("192.168.2.21"), **kw)
        results.append([str(e) for e in mod.validate_camera_config(cfg, *_caps(color_on_a))])
    assert results[0] == results[1]


@pytest.mark.skipif(jlux.HAVE_DEPTHAI, reason="hardware SDK present")
def test_luxonis_source_requires_depthai():
    messages = []
    for mod, types in ((jlux, jtypes), (tlux, ttypes)):
        with pytest.raises(ImportError, match="depthai") as e:
            mod.LuxonisCameraSource(mod.LuxonisCameraConfig(ip=types.IPv4("192.168.2.21")))
        messages.append(str(e.value))
    assert messages[0] == messages[1]


# ------------------------------------------------------------------ dataset


def _euroc_dir(root: Path, calibration: bool) -> Path:
    """A tiny sequence in EuRoC layout (the fixture of tests/test_sources.py),
    with or without the generator's calibration.npz."""
    rng = np.random.default_rng(0)
    mav = root / "seq" / "mav0"
    for cam in ("cam0", "cam1"):
        (mav / cam / "data").mkdir(parents=True)
        rows = []
        for i in range(5):
            ts_ns = int(1.4e18) + i * 50_000_000
            np.save(mav / cam / "data" / f"{ts_ns}.npy", rng.integers(0, 255, (48, 64), dtype=np.uint8))
            rows.append(f"{ts_ns},{ts_ns}.npy")
        (mav / cam / "data.csv").write_text("#ts,file\n" + "\n".join(rows))
    imu_rows = ["#ts,gx,gy,gz,ax,ay,az"]
    for i in range(50):
        ts_ns = int(1.4e18) + i * 5_000_000
        g, a = rng.normal(scale=0.1, size=3), rng.normal(size=3) + [0, 0, 9.81]
        imu_rows.append(f"{ts_ns}," + ",".join(f"{v:.9f}" for v in (*g, *a)))
    (mav / "imu0").mkdir()
    (mav / "imu0" / "data.csv").write_text("\n".join(imu_rows))
    if calibration:
        np.savez(mav / "calibration.npz", width=np.int64(64), height=np.int64(48),
                 k0=np.array([[50.0, 0, 32], [0, 50, 24], [0, 0, 1]]), d0=np.zeros(5),
                 k1=np.array([[51.0, 0, 31], [0, 51, 23], [0, 0, 1]]), d1=np.full(5, 0.01),
                 c0_t_c1=jsyn.OrbitTrajectory().pose(0.3))
    return root / "seq"


def _same_calibration(a, b):
    for ia, ib in zip(a.get_intrinsics(), b.get_intrinsics(), strict=True):
        assert (ia.width, ia.height) == (ib.width, ib.height)
        np.testing.assert_array_equal(ia.matrix, ib.matrix)
        np.testing.assert_array_equal(ia.coeffs, ib.coeffs)
    for ea, eb in zip(a.get_extrinsics(), b.get_extrinsics(), strict=True):
        np.testing.assert_array_equal(ea.to_4x4_matrix(), eb.to_4x4_matrix())
    sa, sb = a.get_sensor_extrinsics(), b.get_sensor_extrinsics()
    assert (sa is None) == (sb is None)
    if sa is not None:
        np.testing.assert_array_equal(sa.to_4x4_matrix(), sb.to_4x4_matrix())


def _same_stream(a, b, ticks: int):
    """Frames, timestamps, names and IMU packets alike, tick by tick, as the
    rig polls a source (IMU first, then frames), past exhaustion."""
    a.start()
    b.start()
    assert a.name == b.name and a.has_sensor_data == b.has_sensor_data
    for _ in range(ticks):
        (da, ta), (db, tb) = a.get_timestamped_sensor_data(), b.get_timestamped_sensor_data()
        assert ta == tb and (da is None) == (db is None)
        if da is not None:
            assert sorted(da) == sorted(db)
            for key in da:
                np.testing.assert_array_equal(da[key], db[key])
        fa, fb = a.try_get_latest_frames(), b.try_get_latest_frames()
        assert (fa is None) == (fb is None)
        for x, y in zip(fa or [], fb or [], strict=True):
            assert (x.timestamp, x.sequence_num, x.camera_name) == (y.timestamp, y.sequence_num, y.camera_name)
            assert x.image.dtype == y.image.dtype and x.image.tobytes() == y.image.tobytes()
    assert a.exhausted and b.exhausted


@pytest.mark.parametrize("calibration", [False, True], ids=["standard", "calibration.npz"])
@pytest.mark.parametrize("kwargs", [{}, dict(read_imu=False), dict(max_frames=3, name="seq0")], ids=["default", "no-imu", "capped"])
def test_euroc_source_matches_reference(tmp_path, calibration, kwargs):
    root = _euroc_dir(tmp_path, calibration)
    j, t = jdata.EurocCameraSource(root, **kwargs), tdata.EurocCameraSource(str(root), **kwargs)
    assert len(j) == len(t)
    _same_calibration(j, t)
    _same_stream(j, t, ticks=len(j) + 1)


def test_euroc_intrinsics_override_beats_calibration_npz(tmp_path):
    root = _euroc_dir(tmp_path, calibration=True)
    override = []
    for types in (jtypes, ttypes):
        k = np.array([[70.0, 0, 30], [0, 70, 20], [0, 0, 1]])
        override.append([types.Intrinsics(width=64, height=48, matrix=k, coeffs=np.zeros(4))] * 2)
    j, t = jdata.EurocCameraSource(root, intrinsics=override[0]), tdata.EurocCameraSource(root, intrinsics=override[1])
    _same_calibration(j, t)
    assert t.get_intrinsics()[0].matrix[0, 0] == 70.0
    # With an override the file is not read: the baseline is the standard
    # VI-sensor's, as in the reference.
    np.testing.assert_array_equal(t.get_extrinsics()[1].to_4x4_matrix(), tdata.EurocCameraSource._EUROC_C0_T_C1)


def test_euroc_missing_directory_raises(tmp_path):
    for mod in (jdata, tdata):
        with pytest.raises(FileNotFoundError, match="mav0"):
            mod.EurocCameraSource(tmp_path)


def _recorded_source(pkg):
    spec = pkg.SyntheticRigSpec(num_sources=1, stereo=True, width=64, height=48, fps=20.0, imu_rate_hz=200.0)
    sources, *_ = pkg.make_synthetic_rig(spec)
    return sources[0]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_recordings_replay_in_either_package(tmp_path, writer):
    """A recording (frames, IMU batches, calibration, IMU extrinsics) made
    by one package's ``record_frames`` replays identically through both
    packages' ``RecordedCameraSource``; both writers record the same."""
    counts = {}
    for name, pkg, data in (("reference", jsyn, jdata), ("port", tsyn, tdata)):
        src = _recorded_source(pkg)
        src.start()
        counts[name] = data.record_frames(src, tmp_path / name, 6)
        src.stop()
    assert counts["reference"] == counts["port"] == 6
    root = tmp_path / writer
    j, t = jdata.RecordedCameraSource(root), tdata.RecordedCameraSource(root)
    assert len(j) == len(t) == 6
    _same_calibration(j, t)
    _same_stream(j, t, ticks=7)
    # The other package's recording holds the same frames and IMU.
    other = tmp_path / ("port" if writer == "reference" else "reference")
    _same_stream(tdata.RecordedCameraSource(other), tdata.RecordedCameraSource(root), ticks=7)


def test_sources_package_exports_the_reference_names():
    import thor_slam_tpu.camera.sources as jsources
    import thor_slam_tpu_torch.camera.sources as tsources

    assert sorted(tsources.__all__) == sorted(jsources.__all__)
    assert tsources.EurocCameraSource is tdata.EurocCameraSource


# ----------------------------------------------------- make_euroc_synthetic


def _generate(module: str, out: Path, *args: str) -> None:
    res = subprocess.run([sys.executable, "-m", module, "--out", str(out), *args],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("args", [
    ("--frames", "4", "--width", "64", "--height", "48"),
    ("--frames", "3", "--width", "96", "--height", "64", "--trajectory-rate", "0.7", "--noise-std", "4",
     "--salt-prob", "0.01", "--motion-blur", "2", "--exposure-drift", "0.3", "--gyro-bias", "0.02"),
])
def test_make_euroc_synthetic_matches_reference(tmp_path, args):
    """Every file byte for byte but the IMU's, ``calibration.npz`` array for
    array; the IMU samples are the reference's in cam0's axes."""
    _generate("scripts.make_euroc_synthetic", tmp_path / "ref", *args)
    _generate("thor_slam_tpu_torch.scripts.make_euroc_synthetic", tmp_path / "port", *args)
    files = sorted(p.relative_to(tmp_path / "ref") for p in (tmp_path / "ref").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*") if p.is_file())
    imu = Path("mav0/imu0/data.csv")
    for rel in files:
        a, b = tmp_path / "ref" / rel, tmp_path / "port" / rel
        if rel.suffix == ".npz":
            za, zb = np.load(a), np.load(b)
            assert za.files == zb.files
            for key in za.files:
                np.testing.assert_array_equal(za[key], zb[key])
        elif rel != imu:
            assert a.read_bytes() == b.read_bytes(), rel
    ref, port = (np.loadtxt(tmp_path / side / imu, delimiter=",", skiprows=1) for side in ("ref", "port"))
    np.testing.assert_array_equal(port[:, 0], ref[:, 0])
    c0_r_body = tsyn.BODY_T_OPTICAL[:3, :3].T  # cam0 sits at the body's origin, axes RDF
    for cols in (slice(1, 4), slice(4, 7)):  # gyro, accel: a signed permutation, exact
        np.testing.assert_array_equal(port[:, cols], ref[:, cols] @ c0_r_body.T)
    # The replay reads either sequence's frames and calibration alike.
    j, t = jdata.EurocCameraSource(tmp_path / "ref"), tdata.EurocCameraSource(tmp_path / "port")
    _same_calibration(j, t)
