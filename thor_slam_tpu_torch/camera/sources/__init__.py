"""Camera sources of the port: the synthetic rig and dataset replay (the
hardware source, :mod:`.luxonis`, is imported where it is used)."""

from thor_slam_tpu_torch.camera.sources.dataset import (
    EurocCameraSource,
    RecordedCameraSource,
    record_frames,
)
from thor_slam_tpu_torch.camera.sources.synthetic import (
    OrbitTrajectory,
    SyntheticCameraSource,
    SyntheticRigSpec,
    SyntheticWorld,
    make_synthetic_rig,
)

__all__ = [
    "EurocCameraSource",
    "OrbitTrajectory",
    "RecordedCameraSource",
    "SyntheticCameraSource",
    "SyntheticRigSpec",
    "SyntheticWorld",
    "make_synthetic_rig",
    "record_frames",
]
