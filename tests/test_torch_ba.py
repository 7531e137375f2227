"""The port's bundle adjustment and TrackBA against the JAX package's.

* ``pack_ba_obs`` / ``pack_kf_sig``: bit-exact, ids past 2^24 and
  all-ones descriptor words included (the id and word channels are
  bit-casts, not numeric casts).
* ``bundle_adjust`` on one seeded window (K=10 poses, 2C=4 cameras, L=384
  landmarks, 10 % outlier observations): poses within 1e-4, landmarks
  within 1e-3, rms within rtol 1e-3, the same accept decisions.
* ``TrackBA.run`` replayed over the same recorded ticks (the port engine's
  finalized BA observations): the same skip reason, or the applied
  correction within 1e-4 and the same landmark write-back.
"""

from __future__ import annotations

import jax.numpy as jnp
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
from thor_slam_tpu.engine import ba as jba
from thor_slam_tpu.engine import setup as jsetup
from thor_slam_tpu.engine import tracker as jtrk
from thor_slam_tpu.engine.backends.track_ba import TrackBA as JaxTrackBA
from thor_slam_tpu.slam.interface import SlamConfig
from thor_slam_tpu_torch.engine import ba as tba
from thor_slam_tpu_torch.engine import convert
from thor_slam_tpu_torch.engine import tracker as ttrk
from thor_slam_tpu_torch.engine.backends.track_ba import TrackBA, apply_correction
from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
from thor_slam_tpu_torch.ops import lie

torch.set_num_threads(2)

C, N = 2, 16


# ------------------------------------------------------------- packing


def _bank(seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 2**31 - 1, (C, N)).astype(np.int32)
    ids[0, :4] = [16777217, 16777219, 2000000001, -1]  # past 2^24, and the empty id
    desc = rng.integers(0, 2**32, (C, N, 8), dtype=np.uint64).astype(np.uint32)
    desc[1, 3] = 0xFFFFFFFF  # an all-ones word: a NaN pattern when viewed as float32
    desc[1, 4, 0] = 0
    return dict(
        ids=ids,
        desc=desc,
        valid=rng.random((C, N)) > 0.3,
        rvalid=rng.random((C, N)) > 0.5,
        pending=rng.random((C, N)) > 0.8,
        obs=rng.normal(0, 0.3, (C, N, 2)).astype(np.float32),
        robs=rng.normal(0, 0.3, (C, N, 2)).astype(np.float32),
        pos=rng.normal(0, 3.0, (C, N, 3)).astype(np.float32),
        px=rng.uniform(0, 160, (C, N, 2)).astype(np.float32),
    )


def _outputs(b):
    common = dict(
        num_inliers=1, num_matches=1, num_landmarks=1, rms_error=0.0, refreshed=False,
    )
    ref = jtrk.TrackOutput(
        world_t_body=jnp.eye(4), covariance=jnp.eye(6),
        **{k: jnp.asarray(v) for k, v in common.items()},
        obs_norm=jnp.asarray(b["obs"]), robs_norm=jnp.asarray(b["robs"]), lm_id=jnp.asarray(b["ids"]),
        lm_valid=jnp.asarray(b["valid"]), robs_valid=jnp.asarray(b["rvalid"]),
    )
    port = ttrk.TrackOutput(
        world_t_body=torch.eye(4), covariance=torch.eye(6),
        **{k: torch.tensor(v) for k, v in common.items()},
        obs_norm=torch.from_numpy(b["obs"]), robs_norm=torch.from_numpy(b["robs"]),
        lm_id=torch.from_numpy(b["ids"]), lm_valid=torch.from_numpy(b["valid"]),
        robs_valid=torch.from_numpy(b["rvalid"]),
    )
    return ref, port


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def test_pack_ba_obs_bit_exact():
    b = _bank()
    ref_out, port_out = _outputs(b)
    ref = jtrk.pack_ba_obs(ref_out, jnp.asarray(b["pos"]))
    port = ttrk.pack_ba_obs(port_out, torch.from_numpy(b["pos"]))
    assert port.shape == (C, N, 10) and port.dtype == torch.float32
    np.testing.assert_array_equal(_bits(port), _bits(ref))
    rec = ttrk.unpack_ba_obs(port)
    ref_rec = jtrk.unpack_ba_obs(ref)
    assert rec["ids"][0, :4].tolist() == [16777217, 16777219, 2000000001, -1]
    for k in ref_rec:
        np.testing.assert_array_equal(rec[k], ref_rec[k])


def test_pack_kf_sig_bit_exact():
    b = _bank(1)
    params = jtrk.TrackerParams(num_cams=C, height=32, width=32, max_keypoints=N)
    state_j = jtrk.init_state(params)._replace(
        lm_desc=jnp.asarray(b["desc"]), lm_obs_px=jnp.asarray(b["px"]), lm_valid=jnp.asarray(b["valid"]),
        lm_pending=jnp.asarray(b["pending"]), lm_pos_w=jnp.asarray(b["pos"]),
    )
    state_t = convert.state_to_torch({f: np.asarray(v) for f, v in state_j._asdict().items()}, "cpu")
    ref = jtrk.pack_kf_sig(state_j)
    port = ttrk.pack_kf_sig(state_t)
    assert port.shape == (C, N, 14)
    np.testing.assert_array_equal(_bits(port), _bits(ref))
    sig, ref_sig = ttrk.unpack_kf_sig(port), jtrk.unpack_kf_sig(ref)
    np.testing.assert_array_equal(sig["desc"], b["desc"])
    assert sig["desc"].dtype == np.uint32
    for k in ref_sig:
        np.testing.assert_array_equal(sig[k], ref_sig[k])
    np.testing.assert_array_equal(sig["valid"], b["valid"] & ~b["pending"])
    single = ttrk.unpack_kf_sig(port[0])  # one camera's signature
    assert single["desc"].shape == (1, N, 8)


# ------------------------------------------------------ bundle adjust


def _rig_setup():
    spec = SyntheticRigSpec(num_sources=2, stereo=True, width=160, height=120, fps=30.0, baseline_m=0.12)
    sources, rig_ext, _, _ = make_synthetic_rig(
        spec, world=SyntheticWorld(half_extents=(4.0, 4.0, 2.0)),
        trajectory=OrbitTrajectory(radius=1.5, angular_rate=0.8),
    )
    return sources, rig_ext


def _window(seed: int = 0, k: int = 10, l_cap: int = 384):
    """A seeded BA window over the 2-camera stereo rig's 4 imagers."""
    rng = np.random.default_rng(seed)
    sources, rig_ext = _rig_setup()
    setup, _, _, _ = jsetup.build_camera_setup(CameraRig(sources, rig_extrinsics=rig_ext).calibration)
    cam_rot = np.concatenate([np.asarray(setup.cam_r_body), np.asarray(setup.cam_r_body_right)]).astype(np.float32)
    cam_trans = np.concatenate([np.asarray(setup.cam_t_body), np.asarray(setup.cam_t_body_right)]).astype(np.float32)
    # Landmarks 2-6 m in front of one of the two left cameras (body frame = world at pose 0).
    cam_of = rng.integers(0, 2, l_cap)
    rays = np.stack([rng.uniform(-0.5, 0.5, l_cap), rng.uniform(-0.4, 0.4, l_cap), np.ones(l_cap)], -1)
    p_cam = rays * rng.uniform(2.0, 6.0, l_cap)[:, None]
    r_cb, t_cb = cam_rot[cam_of], cam_trans[cam_of]
    lms = np.einsum("lji,lj->li", r_cb, p_cam - t_cb)  # body = R^T (p_c - t)
    true = []
    for i in range(k):
        xi = np.array([0.04 * i, 0.01 * i, 0.0, 0.0, 0.015 * i, 0.0], np.float32)
        true.append(np.asarray(lie.se3_exp(torch.from_numpy(xi)).numpy(), np.float64))  # body_t_world
    true = np.stack(true)
    p_b = np.einsum("kij,lj->kli", true[:, :3, :3], lms) + true[:, None, :3, 3]
    p_c = np.einsum("cij,klj->kcli", cam_rot, p_b) + cam_trans[None, :, None, :]
    uv = p_c[..., :2] / p_c[..., 2:3]
    mask = ((p_c[..., 2] > 0.3) & (np.abs(uv) < 0.6).all(-1)).astype(np.float32)
    mask *= rng.random(mask.shape) > 0.3
    obs = uv + rng.normal(0, 1e-3, uv.shape)
    outlier = rng.random(mask.shape) < 0.1
    obs[outlier] = rng.uniform(-0.5, 0.5, (int(outlier.sum()), 2))
    init = true.copy()
    for i in range(1, k):
        noise = torch.from_numpy(rng.normal(0, [0.01] * 3 + [0.005] * 3).astype(np.float32))
        init[i] = lie.se3_exp(noise).double().numpy() @ init[i]
    pose_mask = np.ones(k, np.float32)
    pose_mask[-1] = 0.0  # a partial window
    lm_mask = (rng.random(l_cap) > 0.1).astype(np.float32)
    return dict(
        body_t_world=init.astype(np.float32),
        landmarks_w=(lms + rng.normal(0, 0.02, lms.shape)).astype(np.float32),
        obs=obs.astype(np.float32), obs_mask=mask, cam_rot=cam_rot, cam_trans=cam_trans,
        pose_mask=pose_mask, lm_mask=lm_mask,
    )


def test_bundle_adjust_matches_reference():
    w = _window()
    ref = jba.bundle_adjust(jba.BAProblem(**{k: jnp.asarray(v) for k, v in w.items()}), huber_delta=0.004)
    port = tba.bundle_adjust(tba.BAProblem(**{k: torch.from_numpy(v) for k, v in w.items()}), huber_delta=0.004)
    r0, r1 = float(ref.initial_rms), float(ref.final_rms)
    p0, p1 = float(port.initial_rms), float(port.final_rms)
    assert r1 < r0  # the window has something to fix
    assert (p1 < p0) == (r1 < r0) and (p1 < 0.9 * p0) == (r1 < 0.9 * r0)
    np.testing.assert_allclose([p0, p1], [r0, r1], rtol=1e-3)
    np.testing.assert_allclose(port.body_t_world.numpy(), np.asarray(ref.body_t_world), atol=1e-4)
    np.testing.assert_allclose(port.landmarks_w.numpy(), np.asarray(ref.landmarks_w), atol=1e-3)
    # Masked pose and frozen landmarks do not move.
    np.testing.assert_array_equal(port.body_t_world[-1].numpy(), w["body_t_world"][-1])
    frozen = w["lm_mask"] == 0
    np.testing.assert_array_equal(port.landmarks_w.numpy()[frozen], w["landmarks_w"][frozen])


def test_bundle_adjust_rejects_divergence():
    """A solve that raises the rms returns its input unchanged (the
    reference's ``final_rms <= initial_rms`` reject)."""
    w = _window(seed=1)
    w["obs_mask"][:] = 0.0
    w["obs_mask"][0, 0, 0] = 1.0  # one observation: nothing to lower
    port = tba.bundle_adjust(tba.BAProblem(**{k: torch.from_numpy(v) for k, v in w.items()}), iters=2)
    assert float(port.final_rms) <= float(port.initial_rms)
    np.testing.assert_allclose(port.body_t_world.numpy(), w["body_t_world"], atol=1e-6)


def test_inv3x3_matches_linalg():
    m = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 3, 3))) + 3 * torch.eye(3)
    torch.testing.assert_close(tba.inv3x3(m), torch.linalg.inv(m))


# ------------------------------------------------------------ TrackBA


@pytest.fixture(scope="module")
def recorded():
    """The port engine's BA calls over 40 ticks: pushes, clears and runs
    (each run with a snapshot of the tracker state it wrote into)."""
    sources, rig_ext = _rig_setup()
    with CameraRig(sources, rig_extrinsics=rig_ext) as rig:
        cal = rig.calibration
        frames = [rig.get_synchronized_frames() for _ in range(40)]
    engine = TorchSlamEngine(
        params=dict(max_keypoints=128, keyframe_min_inliers=40), use_imu=False, light_ticks=False, device="cpu"
    )
    engine.initialize(cal, SlamConfig(num_cameras=4, enable_loop_closure=False))
    events = []
    ba_obj = engine._ba
    push, clear, run = ba_obj.push_tick, ba_obj.clear, ba_obj.run

    def rec_push(ba_obs, world_t_body, ts, refreshed):
        events.append(("push", np.array(ba_obs), world_t_body.copy(), ts, refreshed))
        return push(ba_obs, world_t_body, ts, refreshed)

    def rec_clear():
        events.append(("clear",))
        return clear()

    def rec_run(world_t_body, covariance, state, diag):
        events.append(("run", world_t_body.copy(), covariance.copy(), convert.state_to_numpy(state)))
        return run(world_t_body, covariance, state, diag)

    ba_obj.push_tick, ba_obj.clear, ba_obj.run = rec_push, rec_clear, rec_run
    for fs in frames:
        engine.process_frames(fs)
    setup_j, _, _, _ = jsetup.build_camera_setup(cal)
    return events, setup_j, engine._setup, engine._params


def test_track_ba_replay_matches_reference(recorded):
    events, setup_j, setup_t, params_t = recorded
    ref = JaxTrackBA()
    ref.bind(setup_j, C)
    port = TrackBA()
    port.bind(setup_t, C)
    params_j = jtrk.TrackerParams(num_cams=C, height=params_t.height, width=params_t.width, max_keypoints=128)
    outcomes = []
    for ev in events:
        if ev[0] == "push":
            _, obs, pose, ts, refreshed = ev
            ref.push_tick({"ba_obs": obs}, pose, ts, refreshed)
            port.push_tick(torch.from_numpy(obs), pose, ts, refreshed)
        elif ev[0] == "clear":
            ref.clear()
            port.clear()
        else:
            _, pose, cov, snap = ev
            state_j = jtrk.init_state(params_j)._replace(
                **{f: jnp.asarray(v) for f, v in snap.items() if f != "lm_desc"}
            )
            diag_j, diag_t = {}, {}
            state_j, pose_j, corr_j = ref.run(pose, cov, state_j, diag_j)
            state_t, pose_t, corr_t = port.run(pose, cov, convert.state_to_torch(snap, "cpu"), diag_t)
            assert (corr_j is None) == (corr_t is None), (diag_j, diag_t)
            if corr_j is None:
                assert diag_t["ba_skip"].split()[0] == diag_j["ba_skip"].split()[0], (diag_j, diag_t)
                outcomes.append(diag_t["ba_skip"].split()[0])
            else:
                np.testing.assert_allclose(corr_t, corr_j, atol=1e-4)
                np.testing.assert_allclose(pose_t, pose_j, atol=1e-4)
                np.testing.assert_allclose(state_t.lm_pos_w.numpy(), np.asarray(state_j.lm_pos_w), atol=1e-4)
                np.testing.assert_allclose(
                    state_t.world_t_body.numpy(), np.asarray(state_j.world_t_body), atol=1e-4
                )
                assert diag_t["ba_landmarks"] == diag_j["ba_landmarks"]
                outcomes.append("applied")
    assert outcomes.count("applied") >= 2, outcomes
    assert len(set(outcomes)) >= 2, outcomes  # skips are exercised too


def test_apply_correction_matches_reference():
    """The by-id write-back: sorted ids padded with int32 max."""
    rng = np.random.default_rng(3)
    params_j = jtrk.TrackerParams(num_cams=C, height=32, width=32, max_keypoints=N)
    ids = rng.permutation(1000)[: C * N].reshape(C, N).astype(np.int32)
    snap = {f: np.asarray(v) for f, v in jtrk.init_state(params_j)._asdict().items()}
    snap.update(
        lm_id=ids, lm_valid=rng.random((C, N)) > 0.2,
        lm_pos_w=rng.normal(size=(C, N, 3)).astype(np.float32),
        velocity_w=np.array([0.1, 0.2, 0.3], np.float32),
    )
    l_cap = 12
    upd = np.full(l_cap, np.iinfo(np.int32).max, np.int32)
    upd[:8] = np.sort(rng.choice(ids.ravel(), 8, replace=False))
    pos = rng.normal(size=(l_cap, 3)).astype(np.float32)
    ok = rng.random(l_cap) > 0.3
    t_corr = lie.se3_exp(torch.tensor([0.01, 0.02, -0.01, 0.0, 0.01, 0.02])).numpy()
    sources, rig_ext = _rig_setup()
    setup_j = jsetup.build_camera_setup(CameraRig(sources, rig_extrinsics=rig_ext).calibration)[0]
    ref = JaxTrackBA(landmarks=l_cap)
    ref.bind(setup_j, C)
    state_j = jtrk.init_state(params_j)._replace(**{f: jnp.asarray(v) for f, v in snap.items() if f != "lm_desc"})
    out_j = ref._apply(state_j, jnp.asarray(t_corr), jnp.asarray(upd), jnp.asarray(pos), jnp.asarray(ok))
    out_t = apply_correction(
        convert.state_to_torch(snap, "cpu"), torch.from_numpy(t_corr), torch.from_numpy(upd),
        torch.from_numpy(pos), torch.from_numpy(ok),
    )
    for f in ("world_t_body", "prev_world_t_body", "kf_world_t_body", "velocity_w", "lm_pos_w"):
        np.testing.assert_allclose(getattr(out_t, f).numpy(), np.asarray(getattr(out_j, f)), atol=1e-6, err_msg=f)
    assert not np.array_equal(out_t.lm_pos_w.numpy(), snap["lm_pos_w"])  # something was written
