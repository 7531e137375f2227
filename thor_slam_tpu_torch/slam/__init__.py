"""SLAM contract of the port (a copy of ``thor_slam_tpu.slam.interface``)."""

from thor_slam_tpu_torch.slam.interface import (
    MapPoint,
    SlamConfig,
    SlamEngine,
    SlamMap,
    SlamPose,
    TrackingState,
)

__all__ = ["MapPoint", "SlamConfig", "SlamEngine", "SlamMap", "SlamPose", "TrackingState"]
