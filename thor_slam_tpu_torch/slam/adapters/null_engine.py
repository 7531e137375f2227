"""A no-op SLAM engine: validates plumbing, returns identity poses.

Plays the role the reference's Isaac ROS adapter plays in bring-up
(reference: thor_slam/slam/adapters/isaac_ros.py) but with no external
process: useful for rig/pipeline integration tests and as the minimal
worked example of the :class:`SlamEngine` contract — including the
INITIALIZING -> TRACKING state transition the reference exhibits.

Copy of :mod:`thor_slam_tpu.slam.adapters.null_engine`, kept in the port
so that the port imports nothing of the JAX package; keep the two in step.
"""

from __future__ import annotations

import logging

from thor_slam_tpu_torch.camera.rig import RigCalibration
from thor_slam_tpu_torch.camera.types import SynchronizedFrameSet
from thor_slam_tpu_torch.slam.interface import (
    CameraConfig,
    SlamConfig,
    SlamEngine,
    SlamMap,
    SlamPose,
    TrackingState,
)

logger = logging.getLogger(__name__)


class NullSlamEngine(SlamEngine):
    """Accepts frames, returns identity poses, tracks state transitions."""

    def __init__(self) -> None:
        self._state = TrackingState.NOT_INITIALIZED
        self._cameras: list[CameraConfig] = []
        self._config = SlamConfig()
        self._frame_count = 0

    def initialize(self, calibration: RigCalibration, config: SlamConfig | None = None) -> None:
        if config is not None:
            self._config = config
        self._cameras = []
        for name in sorted(calibration.source_names):
            world_exts = calibration.get_world_extrinsics(name) or []
            intrs = calibration.intrinsics.get(name, [])
            for idx, (intr, ext) in enumerate(zip(intrs, world_exts)):
                self._cameras.append(
                    CameraConfig(intrinsics=intr, extrinsics=ext, source_name=name, cam_idx=idx)
                )
        if self._config.num_cameras and len(self._cameras) > self._config.num_cameras:
            self._cameras = self._cameras[: self._config.num_cameras]
        self._state = TrackingState.INITIALIZING
        logger.info("NullSlamEngine initialized with %d cameras", len(self._cameras))

    def process_frames(self, frame_set: SynchronizedFrameSet) -> SlamPose | None:
        if self._state == TrackingState.NOT_INITIALIZED:
            raise RuntimeError("initialize() must be called before process_frames()")
        self._frame_count += 1
        if self._frame_count >= 2:
            self._state = TrackingState.TRACKING
        return SlamPose.identity(timestamp=frame_set.timestamp)

    def get_tracking_state(self) -> TrackingState:
        return self._state

    def get_map(self) -> SlamMap:
        return SlamMap()

    def reset(self) -> None:
        self._frame_count = 0
        if self._state != TrackingState.NOT_INITIALIZED:
            self._state = TrackingState.INITIALIZING

    def shutdown(self) -> None:
        self._state = TrackingState.NOT_INITIALIZED

    @property
    def cameras(self) -> list[CameraConfig]:
        """Flattened per-imager configs extracted at initialize()."""
        return list(self._cameras)
