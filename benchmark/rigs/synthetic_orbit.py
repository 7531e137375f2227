"""The rig ``synthetic_orbit``: four-source stereo rig orbiting a textured room.

Built wholly from the configuration's ``rig`` block: the frames come from
the frozen scene (:mod:`benchmark.reference.scene`), the ground truth and
the IMU from the orbit (:mod:`benchmark.reference.orbit`), and the
program is handed a calibration made from the same numbers, in its own
types. Nothing the program computes goes into either side's inputs.

The replay sweeps the rig back and forth over one arc of the orbit,
``cycle_frames`` camera frames a cycle at the mix's ``fps``
(:func:`benchmark.reference.orbit.sweep_time`), each frame rendered once;
the seed draws the cycle's frame the stream starts at, so that every seed
replays the same frames (the same work) in another order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import orbit, scene
from benchmark.reference.stereo import RgbdReference

#: Orbit time where the swept arc starts: the same arc for every seed.
ARC_START_S = 0.0
#: Poses ray cast in one batch.
RENDER_BATCH = 16


def start_frame(seed: int, n: int) -> int:
    """The frame of the cycle the seed's stream starts at (a uniform draw)."""
    return int(np.random.default_rng([int(seed), 1]).integers(n))


def _offset(v) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = v
    return m


def _render(rig: dict, k: np.ndarray, size, poses: np.ndarray, device) -> np.ndarray:
    """uint8 images (as a camera delivers them) of (..., 4, 4) camera poses."""
    flat = poses.reshape(-1, 4, 4)
    out = [
        (scene.render(rig, k, size[0], size[1], flat[lo : lo + RENDER_BATCH], device) * 255.0)
        .clamp(0, 255).to(torch.uint8).cpu().numpy()
        for lo in range(0, len(flat), RENDER_BATCH)
    ]
    return np.concatenate(out).reshape(*poses.shape[:-2], size[1], size[0])


class Rig:
    """The inputs of a cell, and the truth they were made from.

    ``frames`` (n, N, 2, H, W) uint8 and ``colors`` (n, Hc, Wc, 3) uint8 (of
    the RGB-D source's color imager, where the configuration has one) are
    on the host; ``calibration`` is the program's ``RigCalibration``.
    """

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        r = self.rig = cfg["rig"]
        self.fps, self.n = float(mix["fps"]), int(mix["cycle_frames"])
        self.cycle_s = self.n / self.fps
        self.start = start_frame(seed, self.n)
        w, h = r["width"], r["height"]
        k = orbit.pinhole(w, h, r["focal_scale"])
        eyes = scene.body_t_eyes(r)  # (N, 2, 4, 4)
        body = orbit.body_poses(r["orbit"], self.frame_times()).numpy()  # (n, 4, 4)
        with torch.no_grad():
            self.frames = _render(r, k, (w, h), body[:, None, None] @ eyes, device)
            self.colors = None
            rgbd = cfg.get("rgbd")
            if rgbd and mix.get("rgbd_every"):
                cw, ch = r["color_resolution"]
                gray = _render(r, orbit.pinhole(cw, ch, r["focal_scale"]), (cw, ch),
                               body @ scene.body_t_color(r, rgbd["source"]), device)
                self.colors = np.repeat(gray[..., None], 3, axis=-1)

        self.source_names, self.calibration = calibration(r)
        self.num_cameras = 2 * len(self.source_names)

    def frame_times(self) -> np.ndarray:
        """The orbit time each frame of the cycle shows."""
        return orbit.sweep_time(np.arange(self.n) / self.fps, ARC_START_S, self.cycle_s)

    def frame(self, k: int) -> int:
        """The frame of the cycle that tick k shows."""
        return (k + self.start) % self.n

    def imu(self, times) -> tuple[np.ndarray, np.ndarray]:
        """(gyro, accel) of the swept motion at camera ``times`` (tick k at k / fps)."""
        return orbit.imu_samples(self.rig["orbit"], np.asarray(times) + self.start / self.fps, offset=ARC_START_S,
                                 cycle_s=self.cycle_s)

    def gt_poses(self, ks, dtype=torch.float64) -> torch.Tensor:
        """Ground-truth odometry poses of ticks ``ks`` in ``dtype``:
        inv(G(0)) @ G(k), the odometry frame being the body at tick 0."""
        s = torch.tensor([self.frame(k) / self.fps for k in [0, *ks]], dtype=torch.float64).to(dtype)
        g = orbit.body_poses(self.rig["orbit"], orbit.sweep_time(s, torch.tensor(ARC_START_S, dtype=dtype),
                                                                   self.cycle_s), dtype)
        inv0 = torch.zeros_like(g[:1])
        inv0[:, :3, :3] = g[:1, :3, :3].transpose(1, 2)
        inv0[:, :3, 3:] = -inv0[:, :3, :3] @ g[:1, :3, 3:]
        inv0[:, 3, 3] = 1.0
        return inv0 @ g[1:]

    def rgbd_source(self, i: int) -> dict:
        return rgbd_source(self.rig, self.calibration, i)

    def rgbd_reference(self, rgbd: dict, device, dtype) -> RgbdReference:
        return rgbd_reference(self.rig, rgbd, device, dtype)


def calibration(r: dict):
    """(source names, the program's ``RigCalibration``) of the ``rig`` block:
    pinhole eyes with no distortion, the right eye ``baseline_m`` along the
    left's optical +x, the mounts of :func:`benchmark.reference.scene.
    body_t_eyes`, the IMU in source 0's frame."""
    from thor_slam_tpu_torch.camera.rig import RigCalibration
    from thor_slam_tpu_torch.camera.types import Extrinsics, IMUExtrinsics, Intrinsics

    names = [f"192.168.2.2{i + 1}" for i in range(r["num_sources"])]
    k = orbit.pinhole(r["width"], r["height"], r["focal_scale"])
    intr = Intrinsics(width=r["width"], height=r["height"], matrix=k, coeffs=np.zeros(5))
    eyes = [Extrinsics.from_4x4_matrix(orbit.BODY_T_OPTICAL @ _offset([r["baseline_m"] * e, 0.0, 0.0])) for e in range(2)]
    calib = RigCalibration(
        intrinsics={s: [intr, intr] for s in names},
        extrinsics={s: list(eyes) for s in names},
        rig_extrinsics={s: Extrinsics.from_4x4_matrix(orbit.mount(2.0 * math.pi * i / len(names), r["mount_offset_m"]))
                        for i, s in enumerate(names)},
        imu_extrinsics=IMUExtrinsics(source_name=names[0], extrinsics=Extrinsics.identity()),
        source_names=list(names),
    )
    return names, calib


def rgbd_source(r: dict, calib, i: int) -> dict:
    """The RGB-D product's source ``i``: its name, the program's intrinsics
    and extrinsics of its eyes (from ``calib``) and of its color imager."""
    from thor_slam_tpu_torch.camera.types import Intrinsics

    cw, ch = r["color_resolution"]
    name = calib.source_names[i]
    return dict(name=name, intrinsics=calib.intrinsics[name], extrinsics=calib.extrinsics[name],
                color_intrinsics=Intrinsics(width=cw, height=ch, matrix=orbit.pinhole(cw, ch, r["focal_scale"]),
                                            coeffs=np.zeros(5)),
                left_t_color=_offset(r["color_offset_m"]))


def rgbd_reference(r: dict, rgbd: dict, device, dtype) -> RgbdReference:
    """The reference RGB-D product of a source of the ``rig`` block."""
    w, h = r["width"], r["height"]
    cw, ch = r["color_resolution"]
    k = orbit.pinhole(w, h, r["focal_scale"])
    return RgbdReference(k, k, _offset([r["baseline_m"], 0.0, 0.0]), (w, h), orbit.pinhole(cw, ch, r["focal_scale"]),
                         (cw, ch), _offset(r["color_offset_m"]), num_disp=rgbd["num_disparities"], device=device,
                         dtype=dtype)


def build(cfg: dict, mix: dict, seed: int, device) -> Rig:
    return Rig(cfg, mix, seed, device)
