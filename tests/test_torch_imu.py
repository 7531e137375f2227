"""The port's IMU preintegration and ImuFusion against the JAX package's.

Inputs come from one numpy seed: IMU samples of an orbit trajectory with
noise and a gyro bias, and noisy solved poses at 30 fps. Tolerances: the
numpy twins and ``ImuFusion`` run the same float64 host math as the
reference, rtol 1e-12; the tensor ``preintegrate``/``predict_pose`` run
float32 against the reference's jitted float32, 1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thor_slam_tpu.camera.sources.synthetic import OrbitTrajectory
from thor_slam_tpu.engine import imu as jimu
from thor_slam_tpu.engine.backends.imu_fusion import ImuFusion as JaxImuFusion
from thor_slam_tpu_torch.engine import imu as timu
from thor_slam_tpu_torch.engine.backends.imu_fusion import ImuFusion

torch.set_num_threads(2)

RATE = 200.0
FPS = 30.0
BIAS = np.array([0.004, -0.003, 0.006])


def _stream(seed: int = 0, ticks: int = 70):
    """(sample ts, gyro, accel) at RATE and (tick ts, odom poses) at FPS."""
    rng = np.random.default_rng(seed)
    traj = OrbitTrajectory(radius=1.5, angular_rate=0.8)
    t_end = 1.0 + ticks / FPS
    ts = np.arange(1.0, t_end + 1e-9, 1.0 / RATE)
    gyro, accel = [], []
    for t in ts:
        g, a = traj.imu_sample(float(t))
        gyro.append(g + BIAS + rng.normal(0, 2e-3, 3))
        accel.append(a + rng.normal(0, 2e-2, 3))
    tick_ts = 1.0 + np.arange(1, ticks + 1) / FPS
    pose0_inv = np.linalg.inv(traj.pose(tick_ts[0]))
    poses = []
    for t in tick_ts:
        p = pose0_inv @ traj.pose(float(t))
        p[:3, 3] += rng.normal(0, 1e-3, 3)  # solve noise
        poses.append(p)
    return ts, np.asarray(gyro), np.asarray(accel), tick_ts, poses


@pytest.fixture(scope="module")
def stream():
    return _stream()


def _window(stream, t0, t1, capacity=64):
    ts, gyro, accel, _, _ = stream
    return jimu.pack_imu_window(ts, gyro, accel, t0, t1, capacity), timu.pack_imu_window(
        ts, gyro, accel, t0, t1, capacity
    )


@pytest.mark.parametrize("capacity", [64, 4])
def test_pack_imu_window_identical(stream, capacity):
    ref, port = _window(stream, 1.1, 1.1 + 2.0 / FPS, capacity)
    for a, b in zip(ref, port):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bias", [None, BIAS])
def test_numpy_twins_match(stream, bias):
    (g, a, d, m), _ = _window(stream, 1.2, 1.2 + 3.0 / FPS)
    for name in ("preintegrate_np", "preintegrate_fast_np"):
        ref = getattr(jimu, name)(g, a, d, m, gyro_bias=bias)
        port = getattr(timu, name)(g, a, d, m, gyro_bias=bias)
        for x, y in zip(ref, port):
            np.testing.assert_allclose(np.asarray(y), np.asarray(x), rtol=1e-12, atol=0)
    np.testing.assert_allclose(
        timu.gyro_delta_r_np(g, d, m, gyro_bias=bias), jimu.gyro_delta_r_np(g, d, m, gyro_bias=bias),
        rtol=1e-12, atol=0,
    )


def test_gyro_delta_r_empty_window_is_identity():
    z = np.zeros((4, 3))
    np.testing.assert_array_equal(timu.gyro_delta_r_np(z, np.zeros(4), np.zeros(4)), np.eye(3))


def test_torch_preintegrate_and_predict_match(stream):
    (g, a, d, m), _ = _window(stream, 1.3, 1.3 + 2.0 / FPS, capacity=32)
    m = m.copy()
    m[-3:] = 0.0  # padding slots contribute nothing
    bg = BIAS.astype(np.float32)
    ba = np.array([0.05, -0.02, 0.01], np.float32)
    ref = jimu.preintegrate(*(jnp.asarray(x) for x in (g, a, d, m, bg, ba)))
    port = timu.preintegrate(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (g, a, d, m, bg, ba)))
    for x, y in zip(ref, port):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-5)
    assert int(port.count) == int(m.sum())

    pose = np.asarray(stream[4][5], np.float32)
    vel = np.array([0.3, -1.1, 0.05], np.float32)
    ref_pose, ref_vel = jimu.predict_pose(jnp.asarray(pose), jnp.asarray(vel), ref)
    port_pose, port_vel = timu.predict_pose(torch.from_numpy(pose), torch.from_numpy(vel), port)
    np.testing.assert_allclose(port_pose.numpy(), np.asarray(ref_pose), atol=1e-5)
    np.testing.assert_allclose(port_vel.numpy(), np.asarray(ref_vel), atol=1e-5)


def _feed(fusion_cls, stream, body_r_imu, **kwargs):
    """Drive one fusion object over the stream the way the engine does."""
    ts, gyro, accel, tick_ts, poses = stream
    f = fusion_cls(gravity_min_ticks=20, **kwargs)
    f.body_r_imu = body_r_imu
    epoch = np.eye(4)
    preds, covs = [], []
    last = 1.0
    for i, (t, pose) in enumerate(zip(tick_ts, poses)):
        sel = (ts > last) & (ts <= t)
        f.ingest({"accelerometer": accel[sel], "gyroscope": gyro[sel], "timestamps": ts[sel]}, t)
        last = t
        preds.append(f.predict(t))
        f.on_finalized(pose, t, tracked=i != 40, epoch=epoch)
        if i == 50:  # a BA correction moves the live state
            t_corr = np.eye(4)
            t_corr[:3, 3] = (0.01, -0.005, 0.002)
            epoch = t_corr @ epoch
            f.on_correction(t_corr @ pose, t_corr, epoch)
        covs.append(f.window_covariance(1.0 / FPS))
    return f, preds, covs


@pytest.mark.parametrize("accel", [True, False])
def test_imu_fusion_matches_reference(stream, accel):
    body_r_imu = np.eye(3)
    ref, ref_preds, ref_covs = _feed(JaxImuFusion, stream, body_r_imu, use_accel=accel)
    port, port_preds, port_covs = _feed(ImuFusion, stream, body_r_imu, use_accel=accel)
    assert len(ref_preds) == len(port_preds)
    assert sum(p is not None for p in port_preds) >= 60
    for a, b in zip(ref_preds, port_preds):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
    for a, b in zip(ref_covs, port_covs):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
    np.testing.assert_allclose(port.gyro_bias, ref.gyro_bias, rtol=1e-12, atol=0)
    assert np.linalg.norm(port.gyro_bias - BIAS) < np.linalg.norm(BIAS)  # it learned the bias
    assert port.gravity_n == ref.gravity_n
    if accel:
        assert port.gravity_n >= 20 and port.accel_pred_active() and ref.accel_pred_active()
        np.testing.assert_allclose(port.gravity_w, ref.gravity_w, rtol=1e-12, atol=0)
        np.testing.assert_allclose(port.fin_vel, ref.fin_vel, rtol=1e-12, atol=0)
    else:
        assert port.gravity_w is None and ref.gravity_w is None


@pytest.mark.parametrize("dt", [1.0 / 30.0, 0.25, 1e-6])
def test_window_covariance_of_a_fresh_filter(dt):
    np.testing.assert_allclose(ImuFusion().window_covariance(dt), JaxImuFusion().window_covariance(dt), rtol=1e-12)


def test_ingest_guards_match_reference():
    for f in (ImuFusion(), JaxImuFusion()):
        f.ingest({"accelerometer": None, "gyroscope": [0, 0, 1]}, 1.0)
        f.ingest({"accelerometer": np.zeros((3, 3)), "gyroscope": np.zeros((3, 3)), "timestamps": [1.0]}, 1.0)
        f.ingest({"accelerometer": [0, 0, 9.8], "gyroscope": [0, 0, 1], "timestamp": 2.0}, None)
        f.ingest({"accelerometer": [0, 0, 9.8], "gyroscope": [0, 0, 1], "timestamp": 1.5}, None)  # out of order
        assert f.num_samples == 1
        assert f.predict(2.1) is None  # no finalized pose yet


def test_track_step_prediction_branch_matches_reference():
    """An external pose prediction seeds KLT and PnP in both trackers alike
    (6 ticks in lockstep, the prediction the truth perturbed by 1 cm /
    5 mrad; the reference's RANSAC draws injected)."""
    import jax

    from thor_slam_tpu.camera.rig import CameraRig
    from thor_slam_tpu.camera.sources.synthetic import SyntheticRigSpec, SyntheticWorld, make_synthetic_rig
    from thor_slam_tpu.engine import setup as jsetup
    from thor_slam_tpu.engine import tracker as jtrk
    from thor_slam_tpu_torch.engine import convert
    from thor_slam_tpu_torch.engine import setup as tsetup
    from thor_slam_tpu_torch.engine import tracker as ttrk
    from thor_slam_tpu_torch.ops import lie

    n = 96
    traj = OrbitTrajectory(radius=1.5, angular_rate=0.5)
    spec = SyntheticRigSpec(num_sources=2, stereo=True, width=160, height=120, fps=30.0, baseline_m=0.12)
    sources, rig_ext, _, _ = make_synthetic_rig(spec, world=SyntheticWorld(half_extents=(4.0, 4.0, 2.0)), trajectory=traj)
    with CameraRig(sources, rig_extrinsics=rig_ext) as rig:
        cal = rig.calibration
        order = sorted(cal.source_names)
        syncs = [rig.get_synchronized_frames() for _ in range(6)]
    setup_j, _, h, w = jsetup.build_camera_setup(cal)
    params_j = jtrk.TrackerParams(num_cams=2, height=h, width=w, max_keypoints=n)
    params_t = ttrk.TrackerParams(num_cams=2, height=h, width=w, max_keypoints=n)
    step_j = jtrk.make_track_step(params_j, setup_j)
    setup_t = convert.setup_to_torch(tsetup.build_camera_setup(cal)[0], "cpu")
    state_j = jtrk.init_state(params_j)
    state_t = convert.state_to_torch({f: np.asarray(v) for f, v in state_j._asdict().items()}, "cpu")
    rng = np.random.default_rng(0)
    gt0_inv = np.linalg.inv(traj.pose(syncs[0].timestamp))
    for i, sync in enumerate(syncs):
        images = np.stack([[f.image for f in sync.frame_sets[name].frames[:2]] for name in order])
        noise = rng.normal(0, [0.01] * 3 + [0.005] * 3).astype(np.float32)
        pred = (lie.se3_exp(torch.from_numpy(noise)).numpy() @ (gt0_inv @ traj.pose(sync.timestamp))).astype(np.float32)
        _, subkey = jax.random.split(state_j.key)
        uniforms = np.array(jax.random.uniform(subkey, (params_j.ransac_hypotheses, 2 * n)))
        state_j, out_j = step_j(state_j, jnp.asarray(images), jnp.asarray(pred), None)
        state_t, out_t = ttrk.track_step(
            params_t, setup_t, state_t, torch.from_numpy(images.copy()),
            uniforms=torch.from_numpy(uniforms), pose_prediction=torch.from_numpy(pred),
        )
        pose_j, pose_t = np.asarray(out_j.world_t_body), out_t.world_t_body.numpy()
        assert np.linalg.norm(pose_j[:3, 3] - pose_t[:3, 3]) <= 5e-3, i
        rel = pose_j[:3, :3].T @ pose_t[:3, :3]
        assert np.arccos(np.clip(0.5 * (np.trace(rel) - 1.0), -1, 1)) <= 5e-3, i
        assert abs(int(out_j.num_inliers) - int(out_t.num_inliers)) <= max(3, 0.05 * int(out_j.num_inliers)), i
        assert bool(out_j.refreshed) == bool(out_t.refreshed), i
    assert int(out_t.num_inliers) >= 50
