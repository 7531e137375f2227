"""TorchSlamEngine end to end, against TpuSlamEngine on the same frames.

Both engines run pure synchronous stereo VO (BA, IMU and loop closure
switched off, no pipelining or light ticks) over the same 20 rendered
frame sets of a 2-camera rig at 160x120, 128 landmark slots per camera. Each must stay under the
reference's 5 cm ATE bar (tests/test_engine_e2e.py), and the two ATEs may
differ by at most 1 cm: RANSAC draws differ (a ``torch.Generator`` against
the reference's JAX key chain), everything else is the same algorithm.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from thor_slam_tpu.camera.rig import CameraRig
from thor_slam_tpu.camera.sources.synthetic import (
    OrbitTrajectory,
    SyntheticRigSpec,
    SyntheticWorld,
    make_synthetic_rig,
)
from thor_slam_tpu.engine.tpu_engine import TpuSlamEngine
from thor_slam_tpu.slam.interface import SlamConfig, TrackingState
from thor_slam_tpu.utils.evaluation import ate_rmse
from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
from thor_slam_tpu_torch.ops import fast_cuda, patches_cuda

torch.set_num_threads(2)

FRAMES = 20
PARAMS = dict(max_keypoints=128, keyframe_min_inliers=40)


def _run(engine, frames, calibration, traj):
    engine.initialize(calibration, SlamConfig(num_cameras=4, enable_loop_closure=False))
    est, gt, states, confs, covs = [], [], [], [], []
    gt0 = traj.pose(frames[0].timestamp)
    for fs in frames:
        pose = engine.process_frames(fs)
        states.append(engine.get_tracking_state())
        if pose is not None:
            est.append(pose.position.copy())
            gt.append((np.linalg.inv(gt0) @ traj.pose(fs.timestamp))[:3, 3])
            confs.append(pose.confidence)
            covs.append(pose.covariance)
    return dict(
        ate=ate_rmse(np.asarray(est), np.asarray(gt)), est=np.asarray(est), gt=np.asarray(gt),
        states=states, confs=confs, covs=covs, map=engine.get_map(),
    )


@pytest.fixture(scope="module")
def runs():
    spec = SyntheticRigSpec(num_sources=2, stereo=True, width=160, height=120, fps=30.0, baseline_m=0.12)
    sources, rig_ext, _, traj = make_synthetic_rig(
        spec, world=SyntheticWorld(half_extents=(4.0, 4.0, 2.0)),
        trajectory=OrbitTrajectory(radius=1.5, angular_rate=0.5),
    )
    with CameraRig(sources, rig_extrinsics=rig_ext) as rig:
        calibration = rig.calibration
        frames = [rig.get_synchronized_frames() for _ in range(FRAMES)]
    ref = TpuSlamEngine(
        params=PARAMS, enable_ba=False, use_imu=False, pipelined=False,
        light_ticks=False, adaptive_half_res=False,
    )
    patches_cuda.reset_counts()
    fast_cuda.reset_counts()
    port = TorchSlamEngine(params=PARAMS, device="cpu", enable_ba=False, use_imu=False)
    out = dict(ref=_run(ref, frames, calibration, traj), port=_run(port, frames, calibration, traj))
    out["counts"] = (dict(patches_cuda.counts), dict(fast_cuda.counts))
    out["engine"] = port
    out["frames"] = frames
    out["calibration"] = calibration
    return out


def test_ate_under_bar_and_close_to_reference(runs):
    ate_ref, ate_port = runs["ref"]["ate"], runs["port"]["ate"]
    path = np.linalg.norm(np.diff(runs["port"]["gt"], axis=0), axis=1).sum()
    assert path > 0.3  # the rig moved
    assert ate_port < 0.05 and ate_ref < 0.05
    assert abs(ate_port - ate_ref) <= 0.01


def test_tracks_like_reference(runs):
    for key in ("ref", "port"):
        states = runs[key]["states"]
        first = states.index(TrackingState.TRACKING)
        assert first <= 3
        assert np.mean([s == TrackingState.TRACKING for s in states[first:]]) >= 0.9
    # Per-tick trajectories agree to the same centimetre scale.
    np.testing.assert_allclose(runs["port"]["est"], runs["ref"]["est"], atol=0.02)


def test_covariance_and_confidence(runs):
    for cov, conf in zip(runs["port"]["covs"][1:], runs["port"]["confs"][1:]):
        assert cov.shape == (6, 6)
        np.testing.assert_allclose(cov, cov.T, atol=1e-9)
        assert conf == pytest.approx(1.0 / (1.0 + np.trace(cov)), abs=1e-9)


def test_map_has_keyframes_and_landmarks(runs):
    m = runs["port"]["map"]
    assert len(m.keyframe_poses) >= 2
    assert len(m.points) > 50
    assert len(runs["ref"]["map"].keyframe_poses) >= 1


def test_cpu_engine_uses_plain_versions(runs):
    patches, fast = runs["counts"]
    assert patches["kernel"] == 0 and fast["kernel"] == 0
    assert patches["plain"] >= 4 * FRAMES and fast["plain"] >= 2


def test_reset_and_shutdown(runs):
    engine = runs["engine"]
    engine.reset()
    assert engine.get_tracking_state() == TrackingState.INITIALIZING
    assert len(engine.get_map().points) == 0
    pose = engine.process_frames(runs["frames"][0])
    assert pose is not None and engine.last_diagnostics["refreshed"]
    engine.shutdown()
    assert engine.get_tracking_state() == TrackingState.NOT_INITIALIZED
    with pytest.raises(RuntimeError):
        engine.process_frames(runs["frames"][0])


@pytest.mark.parametrize("kwargs", [dict(pipelined=True), dict(light_ticks=True), dict(devices=2)])
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError):
        TorchSlamEngine(device="cpu", **kwargs)


@pytest.mark.parametrize("option", ["enable_ba", "use_imu"])
def test_backend_options_run(runs, option):
    """BA and IMU fusion are ported: each runs alone on the VO frames."""
    flags = dict(enable_ba=False, use_imu=False)
    flags[option] = True
    engine = TorchSlamEngine(params=PARAMS, device="cpu", **flags)
    engine.initialize(runs["calibration"], SlamConfig(num_cameras=4, enable_loop_closure=False))
    for fs in runs["frames"][:8]:
        assert engine.process_frames(fs) is not None
    diag = engine.last_diagnostics
    if option == "enable_ba":
        assert len(engine._ba) >= 3  # the window collects finalized ticks
        assert "gyro_bias_rad_s" not in diag
    else:
        assert len(engine._ba) == 0
        assert "gyro_bias_rad_s" in diag and "accel_pred" in diag


def test_imu_noise_keys_checked():
    with pytest.raises(ValueError, match="imu_noise"):
        TorchSlamEngine(device="cpu", imu_noise=dict(gyro_density=1.0))
    engine = TorchSlamEngine(device="cpu", imu_noise=dict(gyro_noise_density=2e-4))
    assert engine._imu.gyro_nd == 2e-4


def test_mono_source_raises():
    spec = SyntheticRigSpec(num_sources=1, stereo=False, width=64, height=48)
    sources, rig_ext, _, _ = make_synthetic_rig(spec, render=False)
    engine = TorchSlamEngine(device="cpu")
    with pytest.raises(NotImplementedError, match="mono"):
        engine.initialize(CameraRig(sources, rig_extrinsics=rig_ext).calibration)


def test_loop_closure_runs(runs):
    """Loop closure is on by default: keyframes enter the place DB."""
    engine = TorchSlamEngine(params=PARAMS, device="cpu", enable_ba=False, use_imu=False)
    engine.initialize(runs["calibration"], SlamConfig())
    assert engine._config.enable_loop_closure
    for fs in runs["frames"]:
        assert engine.process_frames(fs) is not None
    kfs = len(engine.get_map().keyframe_poses)
    assert kfs >= 2 and len(engine._loop.db) == kfs
    assert engine._loop._dev_desc is not None and bool(engine._loop._dev_valid.any())
    engine.flush()
    np.testing.assert_array_equal(engine.map_t_odom, np.eye(4))  # nothing to close yet


def test_requires_device_choice(monkeypatch):
    """No CUDA device and no explicit device: initialize refuses, it does
    not quietly run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = SyntheticRigSpec(num_sources=1, stereo=True, width=64, height=48)
    sources, rig_ext, _, _ = make_synthetic_rig(spec, render=False)
    engine = TorchSlamEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.initialize(CameraRig(sources, rig_extrinsics=rig_ext).calibration)


@pytest.mark.parametrize("dt", [1.0 / 30.0, 0.25, 1e-6])
def test_held_covariance_growth_matches_reference(dt):
    from thor_slam_tpu.engine.backends.imu_fusion import ImuFusion
    from thor_slam_tpu_torch.engine.backends import ImuFusion as TorchImuFusion

    np.testing.assert_allclose(TorchImuFusion().window_covariance(dt), ImuFusion().window_covariance(dt), rtol=1e-12)


def test_staging_orders_sources_and_zero_fills_missing(runs):
    import dataclasses

    from thor_slam_tpu_torch.engine import staging

    fs = runs["frames"][2]
    order = sorted(fs.frame_sets)
    gone = order[1]
    partial = dataclasses.replace(
        fs, frame_sets={k: v for k, v in fs.frame_sets.items() if k != gone}, stale_sources=frozenset({gone})
    )
    h, w = fs.frame_sets[order[0]].frames[0].image.shape
    out = staging.stage_images(partial, order, np.zeros((h, w), np.uint8))
    assert out.shape == (2, 2, h, w) and out.dtype == np.uint8
    np.testing.assert_array_equal(out[0, 0], fs.frame_sets[order[0]].frames[0].image)
    np.testing.assert_array_equal(out[0, 1], fs.frame_sets[order[0]].frames[1].image)
    assert not out[1].any()
