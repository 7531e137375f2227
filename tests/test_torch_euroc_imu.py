"""The EuRoC sensor head's calibration on the port's normal path, on the CPU.

``camera/sources/euroc_sensor`` reads the three ``sensor.yaml`` files of
an ASL sequence without pyyaml and gives cam0's and cam1's intrinsics,
cam1's pose in cam0 and the IMU's pose in cam0, by its precedence
(override, ``calibration.npz``, ``sensor.yaml``, the published values);
``run_euroc`` hands the IMU's pose to ``CameraRig``. The reference's replay
(``EurocCameraSource``, copied unchanged) declares the IMU at cam0 in cam0's
axes: on a sequence whose IMU is in its own body frame, as EuRoC's is,
that turns the gyro about the wrong axes.

``make_euroc_synthetic --imu-frame vi-sensor`` writes such a sequence: the
IMU placed against cam0 by the VI-sensor's published ``T_BS``, with the
three ``sensor.yaml`` files. Its default output is unchanged
(``tests/test_torch_sources.py`` holds it to the reference's byte for byte).
"""

from __future__ import annotations

import contextlib
import functools
import io
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from thor_slam_tpu_torch.camera.sources import euroc_sensor
from thor_slam_tpu_torch.camera.sources.dataset import EurocCameraSource
from thor_slam_tpu_torch.camera.types import Intrinsics
from thor_slam_tpu_torch.engine import torch_engine
from thor_slam_tpu_torch.scripts import make_euroc_synthetic, run_euroc

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

#: MH_01_easy's ``mav0/cam0/sensor.yaml``, ``cam1`` and ``imu0``, as the dataset ships them.
CAM0_YAML = """%YAML:1.0
# General sensor definitions.
sensor_type: camera
comment: VI-Sensor cam0 (MT9M034)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]

# Camera specific definitions.
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [458.654, 457.296, 367.215, 248.375] #fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""
CAM1_YAML = """%YAML:1.0
# General sensor definitions.
sensor_type: camera
comment: VI-Sensor cam1 (MT9M034)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [0.0125552670891, -0.999755099723, 0.0182237714554, -0.0198435579556,
         0.999598781151, 0.0130119051815, 0.0251588363115, 0.0453689425024,
        -0.0253898008918, 0.0179005838253, 0.999517347078, 0.00786212447038,
         0.0, 0.0, 0.0, 1.0]

# Camera specific definitions.
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [457.587, 456.134, 379.999, 255.238] #fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05]
"""
IMU_YAML = """#Default imu sensor yaml file
sensor_type: imu
comment: VI-Sensor IMU (ADIS16448)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [1.0, 0.0, 0.0, 0.0,
         0.0, 1.0, 0.0, 0.0,
         0.0, 0.0, 1.0, 0.0,
         0.0, 0.0, 0.0, 1.0]
rate_hz: 200

# inertial sensor noise model parameters (static)
gyroscope_noise_density: 1.6968e-04     # [ rad / s / sqrt(Hz) ]   ( gyro "white noise" )
gyroscope_random_walk: 1.9393e-05       # [ rad / s^2 / sqrt(Hz) ] ( gyro bias diffusion )
accelerometer_noise_density: 2.0000e-3  # [ m / s^2 / sqrt(Hz) ]   ( accel "white noise" )
accelerometer_random_walk: 3.0000e-3    # [ m / s^3 / sqrt(Hz) ]   ( accel bias diffusion )
"""
T_BS_CAM0 = np.array([0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
                      0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
                      -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
                      0.0, 0.0, 0.0, 1.0]).reshape(4, 4)
T_BS_CAM1 = np.array([0.0125552670891, -0.999755099723, 0.0182237714554, -0.0198435579556,
                      0.999598781151, 0.0130119051815, 0.0251588363115, 0.0453689425024,
                      -0.0253898008918, 0.0179005838253, 0.999517347078, 0.00786212447038,
                      0.0, 0.0, 0.0, 1.0]).reshape(4, 4)


def _asl(root: Path, yaml: bool = True, frames: int = 2, size=(752, 480)) -> Path:
    """An ASL skeleton: frames as .npy, a few IMU rows, and (``yaml``) the
    dataset's three sensor.yaml files."""
    mav = root / "mav0"
    for cam, text in (("cam0", CAM0_YAML), ("cam1", CAM1_YAML)):
        (mav / cam / "data").mkdir(parents=True)
        rows = []
        for i in range(frames):
            np.save(mav / cam / "data" / f"{i}.npy", np.zeros(size[::-1], np.uint8))
            rows.append(f"{i * 50_000_000},{i}.npy")
        (mav / cam / "data.csv").write_text("#timestamp [ns],filename\n" + "\n".join(rows) + "\n")
        if yaml:
            (mav / cam / "sensor.yaml").write_text(text)
    (mav / "imu0").mkdir()
    (mav / "imu0" / "data.csv").write_text("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n"
                                           + "\n".join(f"{j * 5_000_000},0,0,0,0,0,9.81" for j in range(12)) + "\n")
    if yaml:
        (mav / "imu0" / "sensor.yaml").write_text(IMU_YAML)
    return root


def test_reader_gives_the_published_numbers(tmp_path):
    calib = euroc_sensor.read_calibration(_asl(tmp_path / "seq"))
    assert calib.origin == "sensor.yaml"
    k0, k1 = calib.intrinsics
    assert (k0.width, k0.height, k1.width, k1.height) == (752, 480, 752, 480)
    np.testing.assert_array_equal(k0.matrix, [[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1]])
    np.testing.assert_array_equal(k1.matrix, [[457.587, 0, 379.999], [0, 456.134, 255.238], [0, 0, 1]])
    np.testing.assert_array_equal(k0.coeffs, [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0])
    np.testing.assert_array_equal(k1.coeffs, [-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05, 0.0])
    np.testing.assert_allclose(calib.cam0_t_cam1, np.linalg.inv(T_BS_CAM0) @ T_BS_CAM1, atol=1e-15)
    np.testing.assert_allclose(calib.cam0_t_imu, np.linalg.inv(T_BS_CAM0), atol=1e-15)
    # The pair: 11.0 cm apart, turned 0.82 degrees; the IMU 6.9 cm from cam0, its axes about 90 degrees off.
    assert abs(np.linalg.norm(calib.cam0_t_cam1[:3, 3]) - 0.1101) < 1e-4
    assert abs(np.linalg.norm(calib.cam0_t_imu[:3, 3]) - 0.0689) < 1e-4
    angle = np.degrees(np.arccos((np.trace(calib.cam0_t_imu[:3, :3]) - 1.0) / 2.0))
    assert 85.0 < angle < 95.0
    # The parser: every key of the files, numbers as numbers.
    imu = euroc_sensor.read_sensor_yaml(tmp_path / "seq" / "mav0" / "imu0" / "sensor.yaml")
    assert imu["rate_hz"] == 200 and imu["accelerometer_noise_density"] == 2.0e-3
    np.testing.assert_array_equal(imu["T_BS"], np.eye(4))
    cam = euroc_sensor.parse_sensor_yaml(CAM0_YAML)
    assert cam["resolution"] == [752, 480] and cam["distortion_model"] == "radial-tangential"
    assert cam["T_BS"]["rows"] == 4 and len(cam["T_BS"]["data"]) == 16


def test_source_and_rig_carry_the_imu_pose(tmp_path):
    from thor_slam_tpu_torch.camera.rig import CameraRig

    src = euroc_sensor.EurocSensorSource(_asl(tmp_path / "seq"))
    calib = euroc_sensor.read_calibration(tmp_path / "seq")
    np.testing.assert_allclose(src.get_sensor_extrinsics().to_4x4_matrix(), calib.cam0_t_imu, atol=1e-15)
    np.testing.assert_allclose(src.get_extrinsics()[1].to_4x4_matrix(), calib.cam0_t_cam1, atol=1e-15)
    np.testing.assert_array_equal(src.get_extrinsics()[0].to_4x4_matrix(), np.eye(4))
    rig = CameraRig([src], imu_extrinsics=euroc_sensor.imu_extrinsics(src), imu_source=src.name)
    ext = rig.calibration.imu_extrinsics
    assert ext.source_name == src.name
    np.testing.assert_allclose(ext.to_4x4_matrix(), calib.cam0_t_imu, atol=1e-15)
    # The reference's replay, copied unchanged, declares the IMU at cam0.
    reference = EurocCameraSource(tmp_path / "seq").get_sensor_extrinsics()
    np.testing.assert_array_equal(reference.to_4x4_matrix(), np.eye(4))


def test_precedence(tmp_path):
    seq = _asl(tmp_path / "seq", size=(160, 100))
    mav = seq / "mav0"
    # 4. No file: the published values (the intrinsics are the source's, at the images' size).
    bare = _asl(tmp_path / "bare", yaml=False, size=(160, 100))
    calib = euroc_sensor.read_calibration(bare)
    assert calib.origin == "vi-sensor" and calib.intrinsics is None
    np.testing.assert_allclose(calib.cam0_t_imu, np.linalg.inv(T_BS_CAM0), atol=1e-15)
    np.testing.assert_allclose(calib.cam0_t_cam1, np.linalg.inv(T_BS_CAM0) @ T_BS_CAM1, atol=1e-15)
    intr = euroc_sensor.EurocSensorSource(bare).get_intrinsics()
    assert (intr[0].width, intr[0].height) == (160, 100)
    np.testing.assert_array_equal(intr[0].matrix, EurocCameraSource._EUROC_K)
    # A camera's file missing: the published values.
    (mav / "cam1" / "sensor.yaml").rename(mav / "cam1" / "away.yaml")
    assert euroc_sensor.read_calibration(seq).origin == "vi-sensor"
    (mav / "cam1" / "away.yaml").rename(mav / "cam1" / "sensor.yaml")
    # 3. The sensor.yaml files; without imu0's, the IMU is the body frame itself.
    assert euroc_sensor.read_calibration(seq).origin == "sensor.yaml"
    (mav / "imu0" / "sensor.yaml").unlink()
    np.testing.assert_allclose(euroc_sensor.read_calibration(seq).cam0_t_imu, np.linalg.inv(T_BS_CAM0), atol=1e-15)
    # 2. calibration.npz, whose IMU is the identity unless it carries c0_t_imu.
    k = np.array([[100.0, 0, 80], [0, 100.0, 50], [0, 0, 1]])
    arrays = dict(width=np.int64(160), height=np.int64(100), k0=k, d0=np.zeros(5), k1=k, d1=np.zeros(5),
                  c0_t_c1=np.eye(4))
    np.savez(mav / "calibration.npz", **arrays)
    calib = euroc_sensor.read_calibration(seq)
    assert calib.origin == "calibration.npz"
    np.testing.assert_array_equal(calib.cam0_t_imu, np.eye(4))
    np.testing.assert_array_equal(calib.intrinsics[0].matrix, k)
    lever = np.eye(4)
    lever[:3, 3] = [0.01, 0.02, 0.03]
    np.savez(mav / "calibration.npz", c0_t_imu=lever, **arrays)
    np.testing.assert_array_equal(euroc_sensor.read_calibration(seq).cam0_t_imu, lever)
    # 1. An explicit override.
    override = euroc_sensor.EurocCalibration([Intrinsics(160, 100, k, np.zeros(5))] * 2, np.eye(4), lever, "mine")
    assert euroc_sensor.read_calibration(seq, override) is override
    src = euroc_sensor.EurocSensorSource(seq, calibration=override)
    assert src.calibration is override and src.get_intrinsics()[0] is override.intrinsics[0]


def test_no_pyyaml():
    code = ("import sys\n"
            "from thor_slam_tpu_torch.camera.sources import euroc_sensor\n"
            "from thor_slam_tpu_torch.scripts import run_euroc, make_euroc_synthetic\n"
            f"euroc_sensor.parse_sensor_yaml({CAM0_YAML!r})\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('yaml', 'cv2', 'jax', 'thor_slam_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------- make_euroc_synthetic and run_euroc

#: The motion of the runs below: 40 frames at 160x100 and 20 fps on an
#: orbit turning at 1.2 rad/s, fast enough that gyro samples read about the
#: wrong axes throw the tracker off (on a CPU: 47.6 cm ATE, 27 of 40 poses).
MOTION = ("--frames", "40", "--width", "160", "--height", "100", "--trajectory-rate", "1.2")
#: How far the ATE of the sequence with its IMU in the VI-sensor's body frame
#: may lie from that of the same motion with the IMU in cam0's axes. The
#: gyro reads the same rotation in other axes, which the engine turns back;
#: what differs is the accelerometer's lever-arm terms (omega^2 r = 0.1 m/s^2
#: at 1.2 rad/s and 6.9 cm), which the accel path leaves uncompensated, over
#: 2 s: a millimetre, not a centimetre (both read 5.56 cm on a CPU).
ATE_BAR_CM = 1.0
#: The same sequence with the IMU's pose ignored loses track: its ATE lies
#: this far beyond the cam0 sequence's, or it delivers fewer poses.
IGNORED_CM = 10.0


@pytest.fixture(autouse=True)
def _no_adaptive_half_res(monkeypatch):
    monkeypatch.setattr(torch_engine, "TorchSlamEngine",
                        functools.partial(torch_engine.TorchSlamEngine, adaptive_half_res=False))


def _sequence(root: Path, *args: str) -> Path:
    with contextlib.redirect_stdout(io.StringIO()):
        assert make_euroc_synthetic.main(["--out", str(root), *args]) == 0
    return root


def _ate(seq: Path) -> tuple[float, int]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run_euroc.main(["--sequence", str(seq), "--cpu"]) == 0
    m = re.search(r"^ATE-RMSE: ([\d.]+) cm over (\d+) poses", out.getvalue(), re.M)
    assert m, out.getvalue()
    return float(m.group(1)), int(m.group(2))


def test_vi_sensor_option_writes_the_head(tmp_path):
    args = ("--frames", "3", "--width", "64", "--height", "48", "--trajectory-rate", "0.7", "--gyro-bias", "0.02")
    cam0 = _sequence(tmp_path / "cam0", *args)
    vi = _sequence(tmp_path / "vi", *args, "--imu-frame", "vi-sensor")
    # The default writes no sensor.yaml and no IMU pose: its IMU is cam0's.
    assert not list((cam0 / "mav0").rglob("sensor.yaml"))
    assert "c0_t_imu" not in np.load(cam0 / "mav0" / "calibration.npz").files
    assert euroc_sensor.read_calibration(cam0).cam0_t_imu.tolist() == np.eye(4).tolist()
    # The option's files and its npz describe the same head.
    from_npz = euroc_sensor.read_calibration(vi)
    (vi / "mav0" / "calibration.npz").rename(tmp_path / "calibration.npz")
    from_yaml = euroc_sensor.read_calibration(vi)
    assert (from_npz.origin, from_yaml.origin) == ("calibration.npz", "sensor.yaml")
    np.testing.assert_allclose(from_yaml.cam0_t_imu, np.linalg.inv(T_BS_CAM0), atol=1e-12)
    np.testing.assert_allclose(from_npz.cam0_t_imu, from_yaml.cam0_t_imu, atol=1e-12)
    np.testing.assert_allclose(from_npz.cam0_t_cam1, from_yaml.cam0_t_cam1, atol=1e-12)
    for a, b in zip(from_npz.intrinsics, from_yaml.intrinsics):
        np.testing.assert_array_equal(a.matrix, b.matrix)
        np.testing.assert_array_equal(a.coeffs, b.coeffs)
    # Frames, ground truth and timestamps are the default's; the IMU reads the
    # same rotation rate in its own axes, and the specific force at its own
    # place: the cam0 sequence's turned into the IMU's axes, plus the lever
    # arm's terms (under 0.05 m/s^2 at 0.7 rad/s and 6.9 cm).
    for rel in ("cam0/data.csv", "state_groundtruth_estimate0/data.csv"):
        assert (vi / "mav0" / rel).read_bytes() == (cam0 / "mav0" / rel).read_bytes()
    a, b = (np.loadtxt(s / "mav0" / "imu0" / "data.csv", delimiter=",", skiprows=1) for s in (cam0, vi))
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    imu_r_c0 = np.linalg.inv(from_yaml.cam0_t_imu)[:3, :3]
    # The injected gyro bias lies on each sequence's own z: the body's up, cam0's -y; the IMU's z.
    np.testing.assert_allclose(b[:, 1:4] - [0.0, 0.0, 0.02], (a[:, 1:4] - [0.0, -0.02, 0.0]) @ imu_r_c0.T, atol=1e-6)
    assert np.abs(b[:, 4:7] - a[:, 4:7] @ imu_r_c0.T).max() < 0.05


def test_run_euroc_tracks_with_the_imu_in_its_own_frame(tmp_path):
    base_cm, base_n = _ate(_sequence(tmp_path / "cam0", *MOTION))
    vi = _sequence(tmp_path / "vi", *MOTION, "--imu-frame", "vi-sensor")
    vi_cm, vi_n = _ate(vi)
    assert vi_n == base_n and abs(vi_cm - base_cm) <= ATE_BAR_CM, (vi_cm, base_cm)
    # The IMU's pose ignored, as the replay had it: no IMU pose in the npz, no sensor.yaml.
    ignored = tmp_path / "ignored"
    shutil.copytree(vi, ignored)
    arrays = dict(np.load(ignored / "mav0" / "calibration.npz"))
    del arrays["c0_t_imu"]
    np.savez(ignored / "mav0" / "calibration.npz", **arrays)
    for p in (ignored / "mav0").rglob("sensor.yaml"):
        p.unlink()
    ign_cm, ign_n = _ate(ignored)
    assert ign_cm > base_cm + IGNORED_CM or ign_n < base_n, (ign_cm, ign_n, base_cm, base_n)
