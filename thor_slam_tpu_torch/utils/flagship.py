"""The flagship configuration: a synthetic 4x stereo rig.

Port of :func:`thor_slam_tpu.utils.flagship.flagship_rig`, built from the
port's own camera setup. The reference's deployed size is 640x400 with
512 keypoints per camera (reference ``config/slam_config.yaml``).
``mono_yaws`` adds mono cameras to it (a mixed rig); :func:`mono_rig` is
the all-mono rig of the reference's tests at any resolution.
:func:`render_sequence` renders a rig's frames on the host or on a device.
"""

from __future__ import annotations

import numpy as np
import torch

from thor_slam_tpu_torch import geometry
from thor_slam_tpu_torch.camera.rig import RigCalibration
from thor_slam_tpu_torch.camera.sources import synthetic_torch
from thor_slam_tpu_torch.camera.sources.synthetic import (
    OrbitTrajectory,
    SyntheticCameraSource,
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
    mono_yaws: tuple[float, ...] = (),
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
    ``mono_yaws`` (radians) mounts one mono camera of the same imager at
    each yaw, after the stereo sources in name order; ``params`` then has
    ``has_mono`` set.
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
    for j, yaw in enumerate(mono_yaws):
        source, mount = _mono_source(f"192.168.2.2{num_cams + 1 + j}", yaw, world, traj, width, height)
        sources.append(source)
        rig_ext[source.name] = mount
    calibration = RigCalibration(
        intrinsics={s.name: s.get_intrinsics() for s in sources},
        extrinsics={s.name: s.get_extrinsics() for s in sources},
        rig_extrinsics=rig_ext,
        imu_extrinsics=IMUExtrinsics(source_name=sources[0].name, extrinsics=Extrinsics.identity()),
        source_names=[s.name for s in sources],
    )
    setup, _, h, w = build_camera_setup(calibration)
    params = trk.TrackerParams(
        num_cams=len(sources), height=h, width=w, max_keypoints=max_keypoints, has_mono=bool(mono_yaws)
    )
    return params, setup, calibration, sources, world, traj


def _mono_source(name, yaw, world, traj, width, height, emit_imu=False):
    """A mono source 12 cm off the body's axis at ``yaw``, and its mount."""
    mount = geometry.se3_matrix(
        geometry.euler_xyz_extrinsic_to_matrix(0.0, 0.0, yaw),
        np.array([0.12 * np.cos(yaw), 0.12 * np.sin(yaw), 0.0]),
    )
    spec = SyntheticRigSpec(num_sources=1, stereo=False, width=width, height=height, fps=30.0)
    source = SyntheticCameraSource(
        name=name, world=world, trajectory=traj, rig_t_source=mount, spec=spec, emit_imu=emit_imu
    )
    return source, Extrinsics.from_4x4_matrix(mount)


def mono_rig(num_cams: int = 2, width: int = 640, height: int = 400):
    """An all-mono rig: (calibration, sources, trajectory).

    The rig of the reference's ``tests/test_engine_mono_only.py``:
    ``num_cams`` mono cameras at yaws 0, 0.5, ... rad orbiting r = 1.5 m at
    0.5 rad/s inside an 8 x 8 x 4 m room (seed 9) at 30 fps; source 0
    carries the IMU.
    """
    world = SyntheticWorld(half_extents=(4.0, 4.0, 2.0), seed=9)
    traj = OrbitTrajectory(radius=1.5, angular_rate=0.5)
    sources, rig_ext = [], {}
    for i in range(num_cams):
        source, mount = _mono_source(f"192.168.2.{21 + i}", 0.5 * i, world, traj, width, height, emit_imu=i == 0)
        sources.append(source)
        rig_ext[source.name] = mount
    calibration = RigCalibration(
        intrinsics={s.name: s.get_intrinsics() for s in sources},
        extrinsics={s.name: s.get_extrinsics() for s in sources},
        rig_extrinsics=rig_ext,
        imu_extrinsics=IMUExtrinsics(source_name=sources[0].name, extrinsics=Extrinsics.identity()),
        source_names=[s.name for s in sources],
    )
    return calibration, sources, traj


def render_sequence(sources, num_frames: int, device=None):
    """Render a (T, C, 2, H, W) float32 image sequence on host or device.

    Port of :func:`thor_slam_tpu.utils.flagship.render_sequence`. With
    ``device=None`` every image is the sources' numpy ``render`` (the
    reference's host path, byte for byte) and the result a numpy array;
    with a torch device (the reference's ``xp=jnp``) the ray casting runs
    there, both eyes of a source in one batch
    (:mod:`~thor_slam_tpu_torch.camera.sources.synthetic_torch`), and the
    result is a tensor on it.
    """
    frames = []
    for t_idx in range(num_frames):
        cams = []
        for src in sources:
            t = src.frame_time(t_idx)
            poses = [src.world_t_optical(t, ci) for ci in range(2)]
            intrinsics = src.get_intrinsics()[0]
            if device is None:
                cams.append(np.stack([src._world.render(intrinsics, pose) for pose in poses]))
            else:
                cams.append(synthetic_torch.render(src._world, intrinsics, np.stack(poses), device))
        frames.append(np.stack(cams) if device is None else torch.stack(cams))
    return np.stack(frames) if device is None else torch.stack(frames)
