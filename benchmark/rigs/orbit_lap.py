"""The rig ``orbit_lap``: the four-source stereo rig patrolling a closed lap.

The rig of :mod:`benchmark.rigs.synthetic_orbit` (the same frozen scene,
mounts, calibration and orbit), driven round the orbit instead of swept
back and forth over an arc: camera frame p of the lap shows orbit time
p / fps. The lap has ``lap_frames`` frames, and every rate of the
configuration's ``orbit`` block is a whole multiple of the lap's, so that
the orbit closes on itself after one lap: the lap is rendered once and
replayed round and round, and the stream revisits every place once a lap.

The mix's ``blackout_s`` ([start, end) seconds of camera time, tick k at
k / fps) is a lights-out: its ticks show an all-zero frame on every
camera, while the IMU (the continuous orbit's) runs on and the truth is
that of the lap frame the tick would have shown. The seed draws the lap
frame the stream starts at, as :func:`benchmark.rigs.synthetic_orbit.
start_frame` does.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark.core import spec
from benchmark.reference import orbit, scene

synthetic_orbit = spec.rig_builder("synthetic_orbit")

#: Poses ray cast in one batch.
RENDER_BATCH = 32


class Rig:
    """The inputs of a cell, and the truth they were made from.

    ``frames`` (lap_frames + 1, N, 2, H, W) uint8 on the host: the lap's
    frames, then the black frame (index ``lap_frames``); ``colors`` is None
    (the configuration has no RGB-D product); ``calibration`` is the
    program's ``RigCalibration``. ``render_s`` and ``host_bytes`` say what
    rendering the lap cost.
    """

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        r = self.rig = cfg["rig"]
        self.fps, self.n = float(mix["fps"]), int(r["lap_frames"])
        if int(mix["cycle_frames"]) != self.n:
            raise ValueError(f"the mix's cycle ({mix['cycle_frames']} frames) is not the lap ({self.n} frames)")
        self.lap_s = self.n / self.fps
        self.blackout = tuple(float(x) for x in mix.get("blackout_s") or (0.0, 0.0))
        self.start = synthetic_orbit.start_frame(seed, self.n)
        w, h = r["width"], r["height"]
        k = orbit.pinhole(w, h, r["focal_scale"])
        eyes = scene.body_t_eyes(r)  # (N, 2, 4, 4)
        cams = (orbit.body_poses(r["orbit"], np.arange(self.n) / self.fps).numpy()[:, None, None] @ eyes).reshape(-1, 4, 4)
        t0 = time.perf_counter()
        flat = np.zeros(((self.n + 1) * eyes.shape[0] * 2, h, w), dtype=np.uint8)
        with torch.no_grad():
            for lo in range(0, len(cams), RENDER_BATCH):
                img = scene.render(r, k, w, h, cams[lo : lo + RENDER_BATCH], device)
                flat[lo : lo + len(img)] = (img * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
        self.frames = flat.reshape(self.n + 1, *eyes.shape[:2], h, w)
        self.render_s = time.perf_counter() - t0
        self.host_bytes = self.frames.nbytes
        self.colors = None
        self.source_names, self.calibration = synthetic_orbit.calibration(r)
        self.num_cameras = 2 * len(self.source_names)
        print(f"benchmark: orbit_lap rendered {self.n} lap frames x {self.num_cameras} eyes in {self.render_s:.3f} s, "
              f"{self.host_bytes} B on the host", file=sys.stderr, flush=True)

    def lap_frame(self, k: int) -> int:
        """The lap frame tick k would show with the lights on."""
        return (k + self.start) % self.n

    def dark(self, k: int) -> bool:
        """Whether tick k falls in the lights-out."""
        return self.blackout[0] <= k / self.fps < self.blackout[1]

    def frame(self, k: int) -> int:
        """The index into ``frames`` that tick k shows: its lap frame, or
        the black frame in the lights-out."""
        return self.n if self.dark(k) else self.lap_frame(k)

    def imu(self, times) -> tuple[np.ndarray, np.ndarray]:
        """(gyro, accel) of the continuous orbit at camera ``times`` (tick k
        at k / fps), the lights-out included."""
        return orbit.imu_samples(self.rig["orbit"], np.asarray(times, np.float64) + self.start / self.fps)

    def gt_poses(self, ks, dtype=torch.float64) -> torch.Tensor:
        """Ground-truth odometry poses of ticks ``ks`` in ``dtype``:
        inv(G(0)) @ G(k) at the lap frame each tick would show, the odometry
        frame being the body at tick 0."""
        s = torch.tensor([self.lap_frame(k) / self.fps for k in [0, *ks]], dtype=torch.float64).to(dtype)
        g = orbit.body_poses(self.rig["orbit"], s, dtype)
        inv0 = torch.zeros_like(g[:1])
        inv0[:, :3, :3] = g[:1, :3, :3].transpose(1, 2)
        inv0[:, :3, 3:] = -inv0[:, :3, :3] @ g[:1, :3, 3:]
        inv0[:, 3, 3] = 1.0
        return inv0 @ g[1:]

    def rgbd_source(self, i: int) -> dict:
        return synthetic_orbit.rgbd_source(self.rig, self.calibration, i)

    def rgbd_reference(self, rgbd: dict, device, dtype):
        return synthetic_orbit.rgbd_reference(self.rig, rgbd, device, dtype)


def build(cfg: dict, mix: dict, seed: int, device) -> Rig:
    return Rig(cfg, mix, seed, device)
