"""TorchSlamEngine: the SlamEngine backed by the PyTorch/CUDA tracker.

Synchronous stereo visual odometry: each :meth:`process_frames` stages the
rig tick, copies it to the device, runs one :func:`tracker.track_step` and
runs the host tracking-state machine of the reference's
``TpuSlamEngine._finalize_values`` on the fetched (57,) output vector.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): bundle adjustment, IMU fusion, pipelined mode, multi-device
tracking, light ticks and mono sources. Loop closure, when the config asks
for it, is skipped with one warning. Map save/load and relocalization keep
the ``SlamEngine`` base class's ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from thor_slam_tpu.camera.rig import RigCalibration
from thor_slam_tpu.camera.types import SynchronizedFrameSet
from thor_slam_tpu.slam.interface import (
    MapPoint,
    SlamConfig,
    SlamEngine,
    SlamMap,
    SlamPose,
    TrackingState,
)
from thor_slam_tpu_torch.engine import convert, imu_noise, staging
from thor_slam_tpu_torch.engine import tracker as trk
from thor_slam_tpu_torch.engine.setup import build_camera_setup
from thor_slam_tpu_torch.utils import cuda_lib
from thor_slam_tpu_torch.utils.platform import pin_precision, select_device

logger = logging.getLogger(__name__)

_UNPORTED = {
    "enable_ba": "bundle adjustment (ROADMAP Queue 1 #9)",
    "use_imu": "IMU fusion (ROADMAP Queue 1 #8)",
    "pipelined": "pipelined mode (ROADMAP Queue 1 #12)",
    "light_ticks": "light ticks (ROADMAP Queue 1 #12)",
}


class TorchSlamEngine(SlamEngine):
    """Multi-camera stereo visual odometry on a CUDA device.

    Args:
        params: Tracker parameter overrides (fields of
            :class:`~thor_slam_tpu_torch.engine.tracker.TrackerParams`;
            num_cams/height/width come from the calibration).
        lost_after: Consecutive low-inlier ticks before LOST.
        device: Compute device; None means the current CUDA device (and
            raises without one). ``"cpu"`` runs the plain PyTorch versions
            of the kernels.
        seed: Seed of the RANSAC ``torch.Generator``.
        enable_ba, use_imu, pipelined, light_ticks: Reference options not
            ported yet; True raises ``NotImplementedError``.
        devices: Devices to shard over; only 1 is supported.
    """

    def __init__(
        self,
        params: dict | None = None,
        lost_after: int = 5,
        device: str | torch.device | None = None,
        seed: int = 0,
        enable_ba: bool = False,
        use_imu: bool = False,
        pipelined: bool = False,
        light_ticks: bool = False,
        devices: int | None = None,
    ) -> None:
        flags = dict(enable_ba=enable_ba, use_imu=use_imu, pipelined=pipelined, light_ticks=light_ticks)
        for name, value in flags.items():
            if value:
                raise NotImplementedError(f"{name}: {_UNPORTED[name]} is not ported yet")
        if devices not in (None, 1):
            raise NotImplementedError("devices > 1: multi-GPU tracking (ROADMAP Queue 1 #15)")
        self._param_overrides = dict(params or {})
        self._lost_after = lost_after
        self._device_arg = device
        self._seed = seed
        self._config = SlamConfig()
        self._state_enum = TrackingState.NOT_INITIALIZED
        self._device: torch.device | None = None
        self._params: trk.TrackerParams | None = None
        self._setup: trk.CameraSetup | None = None
        self._tracker_state: trk.TrackerState | None = None
        self._generator: torch.Generator | None = None
        self._source_order: list[str] = []
        self._zero_img: np.ndarray | None = None
        #: Per-tick diagnostics of the last processed tick.
        self.last_diagnostics: dict = {}
        self._clear_host_state()

    def _clear_host_state(self) -> None:
        self._keyframe_poses: list[SlamPose] = []
        self._low_inlier_streak = 0
        self._held_cov: np.ndarray | None = None
        self._last_timestamp: float | None = None
        self._frame_count = 0

    # ------------------------------------------------------------- setup

    def initialize(self, calibration: RigCalibration, config: SlamConfig | None = None) -> None:
        if config is not None:
            self._config = config
        if self._config.enable_loop_closure:
            logger.warning("loop closure is not ported yet (ROADMAP Queue 1 #10); running without it")
            self._config = dataclasses.replace(self._config, enable_loop_closure=False)
        setup_np, self._source_order, height, width = build_camera_setup(calibration)
        self._params = trk.TrackerParams(
            num_cams=len(self._source_order), height=height, width=width, **self._param_overrides
        )
        self._device = select_device(self._device_arg)
        pin_precision()
        if self._device.type == "cuda":
            cuda_lib.load()  # build the kernels now, not on the first tick
        self._setup = convert.setup_to_torch(setup_np, self._device)
        self._zero_img = np.zeros((height, width), np.uint8)
        self.reset()
        self._state_enum = TrackingState.INITIALIZING
        logger.info(
            "TorchSlamEngine initialized: %d cams @ %dx%d on %s",
            self._params.num_cams, width, height, self._device,
        )

    # ------------------------------------------------------------ tracking

    def process_frames(self, frame_set: SynchronizedFrameSet) -> SlamPose | None:
        if self._tracker_state is None:
            raise RuntimeError("initialize() must be called before process_frames()")
        host = staging.stage_images(frame_set, self._source_order, self._zero_img)
        images = torch.from_numpy(host).to(self._device)
        cam_active = None
        if frame_set.stale_sources:
            cam_active = torch.tensor(
                [name not in frame_set.stale_sources for name in self._source_order],
                device=self._device,
            )
        self._tracker_state, out = trk.track_step(
            self._params, self._setup, self._tracker_state, images,
            generator=self._generator, cam_active=cam_active,
        )
        vals = trk.unpack_output(trk.pack_output(out))
        return self._finalize(vals, frame_set.timestamp, frame_set.stale_sources)

    def _finalize(self, vals: dict, ts: float, stale_sources) -> SlamPose | None:
        """Host state machine for one tick, given the fetched outputs."""
        world_t_body = vals["world_t_body"]
        num_inliers = vals["num_inliers"]
        refreshed = vals["refreshed"]
        covariance = vals["covariance"]
        min_inl = self._params.min_track_inliers

        # A HELD pose (solve lacked support) grows the last trusted
        # covariance by the prediction's noise instead of quoting the
        # meaningless low-inlier solve covariance.
        if num_inliers < min_inl and self._frame_count >= 1 and self._held_cov is not None:
            dt = ts - self._last_timestamp if self._last_timestamp is not None else 1.0 / 30.0
            covariance = self._held_cov + imu_noise.window_covariance(dt)
        self._held_cov = np.asarray(covariance, np.float64)

        self.last_diagnostics = {
            "num_inliers": num_inliers,
            "num_landmarks": vals["num_landmarks"],
            "rms_error": vals["rms_error"],
            "refreshed": refreshed,
            "stale_sources": sorted(stale_sources),
        }
        self._last_timestamp = ts
        self._frame_count += 1

        if self._frame_count <= 1:
            self._state_enum = TrackingState.INITIALIZING
        elif num_inliers >= min_inl:
            self._state_enum = TrackingState.TRACKING
            self._low_inlier_streak = 0
        else:
            self._low_inlier_streak += 1
            if self._state_enum == TrackingState.LOST:
                self._state_enum = TrackingState.RELOCALIZING
            elif self._low_inlier_streak >= self._lost_after:
                self._state_enum = TrackingState.LOST

        if refreshed and self._state_enum == TrackingState.TRACKING:
            self._keyframe_poses.append(SlamPose.from_4x4_matrix(world_t_body, timestamp=ts))
            if len(self._keyframe_poses) > 10000:
                self._keyframe_poses = self._keyframe_poses[-10000:]

        # Confidence is the reference's 1 / (1 + trace) of the covariance.
        pose = SlamPose.from_4x4_matrix(
            world_t_body,
            timestamp=ts,
            tracking_state=self._state_enum,
            confidence=float(1.0 / (1.0 + np.trace(covariance))),
        )
        pose.covariance = covariance
        if self._state_enum == TrackingState.LOST and num_inliers < min_inl // 2:
            return None
        return pose

    def get_tracking_state(self) -> TrackingState:
        return self._state_enum

    # ------------------------------------------------------------ mapping

    def get_map(self) -> SlamMap:
        """Keyframe poses plus the live landmark bank."""
        if self._tracker_state is None:
            return SlamMap()
        pos = self._tracker_state.lm_pos_w.detach().cpu().numpy().astype(np.float64).reshape(-1, 3)
        valid = self._tracker_state.lm_valid.detach().cpu().numpy().reshape(-1)
        points = [MapPoint(position=p) for p in pos[valid]]
        if self._config.max_map_size and len(points) > self._config.max_map_size:
            points = points[: self._config.max_map_size]
        return SlamMap(
            points=points,
            keyframe_poses=list(self._keyframe_poses),
            timestamp=self._last_timestamp or 0.0,
        )

    # ------------------------------------------------------------ lifecycle

    def reset(self) -> None:
        if self._params is not None:
            self._tracker_state = trk.init_state(self._params, self._device)
            self._generator = torch.Generator(device=self._device).manual_seed(self._seed)
        self._clear_host_state()
        if self._state_enum != TrackingState.NOT_INITIALIZED:
            self._state_enum = TrackingState.INITIALIZING

    def shutdown(self) -> None:
        self._tracker_state = None
        self._state_enum = TrackingState.NOT_INITIALIZED
