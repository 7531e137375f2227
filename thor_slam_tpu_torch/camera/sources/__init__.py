"""Camera sources of the port: the deterministic synthetic rig."""

from thor_slam_tpu_torch.camera.sources.synthetic import (
    OrbitTrajectory,
    SyntheticCameraSource,
    SyntheticRigSpec,
    SyntheticWorld,
    make_synthetic_rig,
)

__all__ = [
    "OrbitTrajectory",
    "SyntheticCameraSource",
    "SyntheticRigSpec",
    "SyntheticWorld",
    "make_synthetic_rig",
]
