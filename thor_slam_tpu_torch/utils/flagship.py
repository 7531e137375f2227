"""The flagship configuration: a synthetic 4x stereo rig.

Port of :func:`thor_slam_tpu.utils.flagship.flagship_rig`, built from the
port's own camera setup. The reference's deployed size is 640x400 with
512 keypoints per camera (reference ``config/slam_config.yaml``).
"""

from __future__ import annotations

from thor_slam_tpu_torch.camera.rig import RigCalibration
from thor_slam_tpu_torch.camera.sources.synthetic import (
    OrbitTrajectory,
    SyntheticRigSpec,
    SyntheticWorld,
    make_synthetic_rig,
)
from thor_slam_tpu_torch.camera.types import Extrinsics, IMUExtrinsics
from thor_slam_tpu_torch.engine import tracker as trk
from thor_slam_tpu_torch.engine.setup import build_camera_setup


def flagship_rig(
    num_cams: int = 4,
    width: int = 640,
    height: int = 400,
    max_keypoints: int = 512,
    color_resolution: tuple[int, int] | None = None,
    angular_rate: float = 0.15,
    clock_offsets: tuple[float, ...] | None = None,
):
    """Build (params, setup, calibration, sources, world, trajectory).

    OAK-D-class 0.075 m baselines at 30 fps, orbiting r = 1.8 m at
    ``angular_rate`` rad/s inside a 10 x 10 x 5 m textured room; source 0
    carries the IMU. ``clock_offsets`` (seconds, one per source) start the
    sources' clocks later on the same trajectory. ``setup`` holds numpy
    arrays (see :func:`thor_slam_tpu_torch.engine.convert.setup_to_torch`).
    ``color_resolution`` (width, height) gives every source a color imager,
    the RGB-D product's camera (1280x800 on the deployed rig,
    ``config/slam_config.yaml``); its frames are rendered only on request.
    """
    spec = SyntheticRigSpec(
        num_sources=num_cams,
        stereo=True,
        width=width,
        height=height,
        baseline_m=0.075,
        fps=30.0,
        color_camera=color_resolution is not None,
        color_resolution=color_resolution,
    )
    world = SyntheticWorld(half_extents=(5.0, 5.0, 2.5))
    traj = OrbitTrajectory(radius=1.8, angular_rate=angular_rate)
    sources, rig_ext, _, _ = make_synthetic_rig(spec, world=world, trajectory=traj, clock_offsets=clock_offsets)
    calibration = RigCalibration(
        intrinsics={s.name: s.get_intrinsics() for s in sources},
        extrinsics={s.name: s.get_extrinsics() for s in sources},
        rig_extrinsics=rig_ext,
        imu_extrinsics=IMUExtrinsics(source_name=sources[0].name, extrinsics=Extrinsics.identity()),
        source_names=[s.name for s in sources],
    )
    setup, _, h, w = build_camera_setup(calibration)
    params = trk.TrackerParams(num_cams=num_cams, height=h, width=w, max_keypoints=max_keypoints)
    return params, setup, calibration, sources, world, traj
