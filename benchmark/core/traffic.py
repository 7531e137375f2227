"""Rig ticks from a mix's parameters.

A mix (``benchmark/traffic/<name>.json``) says how the rig's frames reach
the engine:

* ``generator``: the module ``benchmark/traffic/<generator>.py`` whose
  ``Clock`` decides which tick comes next and when its frames were
  captured (``newest_wins``: the 30 fps camera clock, open loop;
  ``closed_loop``: a replay fed as fast as the engine returns). A mix
  with a new clock (jitter, late frames) brings its module beside it;
* ``fps``: the camera clock; ``cycle_frames``: the frames of the replayed
  cycle (what a cycle shows is the rig's: ``benchmark/rigs/``);
* ``imu_hz``: IMU samples per second since the previous delivered tick,
  true to the rig's motion (0: no IMU);
* ``rgbd_every``: the RGB-D product every Nth processed tick (0: none),
  ``map``: and its integration into the dense map;
* ``warmup_s`` or ``warmup_ticks``: untimed ticks of the same stream
  before the window;
* ``trace_ticks``: processed ticks the traced run profiles;
* ``depth_sample``: RGB-D frames of the window whose depth the correctness
  check compares (a sample drawn from the seed).

``payload_stats`` and the IMU-batched frame-set factory are copies of the
pieces of ``thor_slam_tpu_torch/bench.py`` (``_payload_stats``,
``_make_sync_factory``); the factory's IMU follows the replayed motion
instead of holding constant readings.
"""

from __future__ import annotations

import math

import numpy as np


def payload_stats(after: dict, before: dict) -> dict:
    """Per-tick payload mix of a window: the difference of two
    ``TorchSlamEngine.upload_stats`` (copy of ``bench._payload_stats``)."""
    d = {k: after[k] - before[k] for k in after}
    ticks = d["full"] + d["light"] + d["light_half"]
    d["ticks"] = ticks
    d["mean_bytes_per_tick"] = d["bytes"] / ticks if ticks else 0.0
    return d


class FrameSetFactory:
    """Builds the ``SynchronizedFrameSet`` of rig tick k (copy of
    ``bench._make_sync_factory``, on the port's frame types).

    Tick k is stamped ``k / fps`` on the camera clock and shows the rig's
    frame ``rig.frame(k)`` (host uint8 ``rig.frames``, (n, N, 2, H, W)). Its
    IMU batch holds every ``imu_hz`` sample since the previous tick built
    (as the rig batches them between polls), read off ``rig.imu``.
    """

    def __init__(self, rig, fps: float, imu_hz: float):
        from thor_slam_tpu_torch.camera.types import CameraFrame, FrameSet, SynchronizedFrameSet

        self._types = (CameraFrame, FrameSet, SynchronizedFrameSet)
        self.rig = rig
        self.fps, self.imu_hz = float(fps), float(imu_hz)
        self._last_s: float | None = None
        self._imu_cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def _imu_block(self, b: int) -> tuple[np.ndarray, np.ndarray]:
        """IMU samples j in [b * 4096, (b + 1) * 4096), computed once."""
        if b not in self._imu_cache:
            self._imu_cache[b] = self.rig.imu(np.arange(b * 4096, (b + 1) * 4096) / self.imu_hz)
        return self._imu_cache[b]

    def _imu(self, s: float) -> dict:
        start = s - 1.0 / self.fps if self._last_s is None else self._last_s
        j = np.arange(math.floor(start * self.imu_hz) + 1, math.floor(s * self.imu_hz) + 1)
        gyro = np.empty((len(j), 3))
        accel = np.empty((len(j), 3))
        for b in np.unique(j // 4096):
            sel = j // 4096 == b
            g, a = self._imu_block(int(b))
            gyro[sel], accel[sel] = g[j[sel] % 4096], a[j[sel] % 4096]
        return {"accelerometer": accel, "gyroscope": gyro, "timestamps": j / self.imu_hz}

    def __call__(self, k: int):
        camera_frame, frame_set, synchronized = self._types
        s = k / self.fps
        p = self.rig.frame(k)
        fsets = {}
        for c, name in enumerate(self.rig.source_names):
            frames = [
                camera_frame(image=self.rig.frames[p, c, e], timestamp=s, sequence_num=k, camera_name=f"{name}_cam{e}")
                for e in range(2)
            ]
            fsets[name] = frame_set(timestamp=s, frames=frames, source_name=name)
        imu = self._imu(s) if self.imu_hz > 0 else None
        self._last_s = s
        return synchronized(
            timestamp=s, frame_sets=fsets, max_time_delta=0.0, sensor_data=imu,
            sensor_timestamp=s if imu is not None else None,
        )
