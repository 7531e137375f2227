"""Host-side engine backends around the tracker.

Each consumes only finalized-tick data and pushes corrections to the live
tracker state as explicit updates:

* :class:`ImuFusion`: sample buffering, online gravity and gyro-bias
  estimation, the per-tick preintegrated pose prediction.
* :class:`TrackBA`: the sliding-window track-level bundle adjustment.
* :class:`LoopBackend`: place database, async loop detection and
  verification, pose-graph application, relocalization.
* :class:`LightController`: light/full tick scheduling and the adaptive
  half-resolution controller (a host policy; no device work).
"""

from thor_slam_tpu_torch.engine.backends.imu_fusion import ImuFusion
from thor_slam_tpu_torch.engine.backends.light import LightController
from thor_slam_tpu_torch.engine.backends.loop_closure import LoopBackend
from thor_slam_tpu_torch.engine.backends.track_ba import TrackBA

__all__ = ["ImuFusion", "LightController", "LoopBackend", "TrackBA"]
