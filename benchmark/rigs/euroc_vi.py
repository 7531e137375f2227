"""The rig ``euroc_vi``: the EuRoC MAV's VI-sensor head on the repository's orbit.

One stereo pair and its IMU, as EuRoC's MH_01_easy describes them
(:mod:`benchmark.reference.euroc`): the head rides the orbit's body
(:mod:`benchmark.reference.orbit`) with cam0 looking forward, cam1 and the
IMU placed by the published ``T_BS``. The frames are the frozen room ray
cast through each eye's radial-tangential lens, distorted and unrectified
as the VI-sensor delivers them; the IMU reads its own rate and specific
force at its own place, with white noise at the published densities drawn
from the seed (biases zero). Truth and IMU come from the reference's copy
of the numbers.

The program gets its calibration as ``scripts/run_euroc.py`` builds it:
the rig writes the ASL skeleton the normal path reads (the three
``sensor.yaml`` files in EuRoC's format, ``cam0``/``cam1`` ``data.csv``,
frame 0 as ``.npy`` and a few IMU rows) into a temporary directory, and
``EurocSensorSource``, ``imu_extrinsics`` and ``CameraRig`` make the
calibration from those files. The program reports cam0's pose (the rig
frame of a one-source rig), so the truth is cam0's pose relative to tick 0.

The replay sweeps the head back and forth over one arc of the orbit,
``cycle_frames`` frames a cycle (:func:`benchmark.reference.orbit.
sweep_time`); the seed draws the frame the stream starts at.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

from benchmark.core import spec
from benchmark.reference import euroc, orbit

#: Orbit time where the swept arc starts: the same arc for every seed.
ARC_START_S = 0.0
#: Poses ray cast in one batch.
RENDER_BATCH = 8
#: IMU rows the skeleton's ``imu0/data.csv`` holds (the source then has an IMU).
SKELETON_IMU_ROWS = 4


def _uint8(img: torch.Tensor) -> np.ndarray:
    return (img * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()


def body_t_eyes() -> np.ndarray:
    """(2, 4, 4) body_T_optical of cam0 (forward, at the body's origin) and cam1."""
    c0 = orbit.BODY_T_OPTICAL
    return np.stack([c0, c0 @ euroc.cam0_t_cam1()])


def body_t_imu() -> np.ndarray:
    return orbit.BODY_T_OPTICAL @ euroc.cam0_t_imu()


class Rig:
    """The inputs of a cell, and the truth they were made from: ``frames``
    (n, 1, 2, H, W) uint8 on the host, ``calibration`` the program's."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        # The program's reader first: a program without it fails here, at once.
        from thor_slam_tpu_torch.camera.sources import euroc_sensor  # noqa: F401

        r = self.rig = cfg["rig"]
        self.fps, self.n = float(mix["fps"]), int(mix["cycle_frames"])
        self.cycle_s = self.n / self.fps
        self.seed = int(seed)
        self.start = spec.rig_builder("synthetic_orbit").start_frame(seed, self.n)
        self.imu_hz = float(r["imu_hz"])
        w, h = r["width"], r["height"]
        body = orbit.body_poses(r["orbit"], self.frame_times()).numpy()  # (n, 4, 4)
        eyes = body[:, None] @ body_t_eyes()  # (n, 2, 4, 4)
        frames = np.empty((self.n, 1, 2, h, w), np.uint8)
        with torch.no_grad():
            for e in range(2):
                cam_rays = euroc.rays(e, w, h, device)
                for lo in range(0, self.n, RENDER_BATCH):
                    frames[lo : lo + RENDER_BATCH, 0, e] = _uint8(
                        euroc.render(r, cam_rays, eyes[lo : lo + RENDER_BATCH, e], device))
        self.frames, self.colors = frames, None
        self.source_names, self.calibration = calibration(r, frames[0, 0], self.imu(np.arange(SKELETON_IMU_ROWS)
                                                                                    / self.imu_hz))
        self.num_cameras = 2

    def frame_times(self) -> np.ndarray:
        """The orbit time each frame of the cycle shows."""
        return orbit.sweep_time(np.arange(self.n) / self.fps, ARC_START_S, self.cycle_s)

    def frame(self, k: int) -> int:
        """The frame of the cycle that tick k shows."""
        return (k + self.start) % self.n

    def imu(self, times) -> tuple[np.ndarray, np.ndarray]:
        """(gyro, accel) of the IMU at camera ``times`` (tick k at k / fps),
        white noise included, drawn from the seed and the first sample's index."""
        t = np.asarray(times, np.float64)
        gyro, accel = euroc.imu_samples(self.rig["orbit"], t + self.start / self.fps, body_t_imu(), ARC_START_S,
                                        self.cycle_s)
        j0 = int(round(float(t[0]) * self.imu_hz)) if len(t) else 0
        ng, na = euroc.imu_noise(len(t), self.imu_hz, np.random.default_rng([self.seed, 3, j0 % 2**32]))
        return gyro + ng, accel + na

    def gt_poses(self, ks, dtype=torch.float64) -> torch.Tensor:
        """Ground-truth poses of cam0 at ticks ``ks`` in ``dtype``:
        inv(C(0)) @ C(k), the odometry frame being cam0 at tick 0."""
        s = torch.tensor([self.frame(k) / self.fps for k in [0, *ks]], dtype=torch.float64).to(dtype)
        g = orbit.body_poses(self.rig["orbit"], orbit.sweep_time(s, torch.tensor(ARC_START_S, dtype=dtype),
                                                                   self.cycle_s), dtype)
        g = g @ torch.as_tensor(orbit.BODY_T_OPTICAL).to(dtype)
        inv0 = torch.zeros_like(g[:1])
        inv0[:, :3, :3] = g[:1, :3, :3].transpose(1, 2)
        inv0[:, :3, 3:] = -inv0[:, :3, :3] @ g[:1, :3, 3:]
        inv0[:, 3, 3] = 1.0
        return inv0 @ g[1:]

    def rgbd_source(self, i: int) -> dict:
        raise ValueError("the EuRoC VI-sensor has no RGB-D product")

    def rgbd_reference(self, rgbd: dict, device, dtype):
        raise ValueError("the EuRoC VI-sensor has no RGB-D product")


def _yaml(kind: str, t_bs: np.ndarray, rate_hz: float, eye: int | None = None, size=None) -> str:
    """A ``sensor.yaml`` as EuRoC writes it."""
    rows = ",\n         ".join(", ".join(repr(float(v)) for v in row) for row in t_bs)
    text = (f"# General sensor definitions.\nsensor_type: {kind}\ncomment: VI-Sensor {kind}\n\n"
            f"# Sensor extrinsics wrt. the body-frame.\nT_BS:\n  cols: 4\n  rows: 4\n  data: [{rows}]\n\n")
    if eye is None:
        return text + (f"rate_hz: {rate_hz:g}\n\n# inertial sensor noise model parameters (static)\n"
                       f"gyroscope_noise_density: {euroc.GYRO_NOISE_DENSITY!r}     # [ rad / s / sqrt(Hz) ]\n"
                       f"accelerometer_noise_density: {euroc.ACCEL_NOISE_DENSITY!r}  # [ m / s^2 / sqrt(Hz) ]\n")
    w, h = size
    intr = ", ".join(repr(v) for v in euroc.intrinsics(eye, w, h))
    dist = ", ".join(repr(v) for v in euroc.DISTORTION[eye])
    return text + (f"# Camera specific definitions.\nrate_hz: {rate_hz:g}\nresolution: [{w}, {h}]\n"
                   f"camera_model: pinhole\nintrinsics: [{intr}] #fu, fv, cu, cv\n"
                   f"distortion_model: radial-tangential\ndistortion_coefficients: [{dist}]\n")


def write_skeleton(root: Path, r: dict, frame0: np.ndarray, imu: tuple[np.ndarray, np.ndarray]) -> None:
    """The ASL layout of one frame: ``mav0/{cam0,cam1,imu0}/sensor.yaml``,
    ``cam{0,1}/data.csv`` with frame 0 as ``.npy``, and ``imu0/data.csv``."""
    mav = root / "mav0"
    size = (r["width"], r["height"])
    for e, (cam, t_bs) in enumerate((("cam0", euroc.T_BS_CAM0), ("cam1", euroc.T_BS_CAM1))):
        (mav / cam / "data").mkdir(parents=True)
        (mav / cam / "sensor.yaml").write_text(_yaml("camera", t_bs, r["fps"], e, size))
        np.save(mav / cam / "data" / "0.npy", frame0[e])
        (mav / cam / "data.csv").write_text("#timestamp [ns],filename\n0,0.npy\n")
    (mav / "imu0").mkdir()
    (mav / "imu0" / "sensor.yaml").write_text(_yaml("imu", euroc.T_BS_IMU, r["imu_hz"]))
    gyro, accel = imu
    rows = [f"{round(j * 1e9 / r['imu_hz'])}," + ",".join(repr(float(v)) for v in (*g, *a))
            for j, (g, a) in enumerate(zip(gyro, accel))]
    (mav / "imu0" / "data.csv").write_text("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n" + "\n".join(rows) + "\n")


def calibration(r: dict, frame0: np.ndarray, imu: tuple[np.ndarray, np.ndarray]):
    """(source names, the program's ``RigCalibration``), made by the program
    from the files of :func:`write_skeleton`, as ``run_euroc`` makes it."""
    from thor_slam_tpu_torch.camera.rig import CameraRig
    from thor_slam_tpu_torch.camera.sources.euroc_sensor import EurocSensorSource, imu_extrinsics

    with tempfile.TemporaryDirectory(prefix="euroc_vi_") as tmp:
        root = Path(tmp) / "euroc_vi"
        write_skeleton(root, r, frame0, imu)
        src = EurocSensorSource(root)
        rig = CameraRig([src], imu_extrinsics=imu_extrinsics(src), imu_source=src.name)
        return [src.name], rig.calibration


def build(cfg: dict, mix: dict, seed: int, device) -> Rig:
    return Rig(cfg, mix, seed, device)
