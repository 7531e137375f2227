"""Camera layer of the port: types and rig synchronization.

Copies of the JAX package's framework-free ``thor_slam_tpu.camera``
modules; only what the port uses is exported.
"""

from thor_slam_tpu_torch.camera.rig import CameraRig, RigCalibration
from thor_slam_tpu_torch.camera.types import (
    CameraFrame,
    CameraSource,
    Extrinsics,
    IMUData,
    IMUExtrinsics,
    Intrinsics,
    SynchronizedFrameSet,
)

__all__ = [
    "CameraFrame",
    "CameraRig",
    "CameraSource",
    "Extrinsics",
    "IMUData",
    "IMUExtrinsics",
    "Intrinsics",
    "RigCalibration",
    "SynchronizedFrameSet",
]
