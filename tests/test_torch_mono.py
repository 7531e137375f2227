"""Mono rigs in the port against the JAX reference, on the CPU.

Two rigs at 160x120 (``tests/test_engine_mono.py`` and
``test_engine_mono_only.py`` are the models):

* **mixed**: two stereo cameras at yaws 0 / 0.7 rad and one mono camera
  between them, 128 slots, 30 ticks. The mono camera never triangulates:
  its detections are seeded from the stereo cameras' landmarks and carry
  their own PnP weight.
* **all-mono**: one mono camera, 256 slots, 45 ticks. The first map comes
  from the two-view bootstrap, later landmarks from motion triangulation
  of pending tracks; the trajectory is up to scale.

Engine level: both engines on the same frame sets (IMU off in both, so the
reference compiles one step variant; window BA on for the mixed rig).
Tracker level: one ``track_step`` and one ``mint_bank`` from the
reference engine's own final state, carried over by ``engine/convert.py``:
it holds seeded mono slots with non-unit weights (mixed) and pending and
promoted slots (all-mono). The reference side of a step is the engine's
compiled step; RANSAC draws are the reference's (``jax.random`` on the
state's key) and are injected into the port.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thor_slam_tpu import geometry
from thor_slam_tpu.camera.rig import CameraRig
from thor_slam_tpu.camera.sources.synthetic import (
    OrbitTrajectory,
    SyntheticCameraSource,
    SyntheticRigSpec,
    SyntheticWorld,
)
from thor_slam_tpu.camera.types import Extrinsics
from thor_slam_tpu.engine import setup as jsetup
from thor_slam_tpu.engine import tracker as jtrk
from thor_slam_tpu.engine.tpu_engine import TpuSlamEngine
from thor_slam_tpu.slam.interface import SlamConfig
from thor_slam_tpu.utils.evaluation import ate_rmse
from thor_slam_tpu_torch.engine import convert
from thor_slam_tpu_torch.engine import setup as tsetup
from thor_slam_tpu_torch.engine import tracker as ttrk
from thor_slam_tpu_torch.engine.backends import TrackBA
from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine

torch.set_num_threads(2)

W, H = 160, 120
MIXED_TICKS, MONO_TICKS = 30, 45
MIXED_PARAMS = dict(max_keypoints=128, keyframe_min_inliers=40)
MONO_PARAMS = dict(max_keypoints=256, keyframe_min_inliers=40)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rig(layout, seed, w=W, h=H):
    """Sources at (name, yaw, stereo) mounts on the standard orbit."""
    world = SyntheticWorld(half_extents=(4.0, 4.0, 2.0), seed=seed)
    traj = OrbitTrajectory(radius=1.5, angular_rate=0.5)
    sources, rig_ext = [], {}
    for i, (name, yaw, stereo) in enumerate(layout):
        spec = SyntheticRigSpec(num_sources=1, stereo=stereo, width=w, height=h, fps=30.0, baseline_m=0.12)
        mount = geometry.se3_matrix(
            geometry.euler_xyz_extrinsic_to_matrix(0.0, 0.0, yaw),
            np.array([0.12 * np.cos(yaw), 0.12 * np.sin(yaw), 0.0]),
        )
        sources.append(
            SyntheticCameraSource(name=name, world=world, trajectory=traj, rig_t_source=mount, spec=spec, emit_imu=(i == 0))
        )
        rig_ext[name] = Extrinsics.from_4x4_matrix(mount)
    return sources, rig_ext, traj


MIXED_LAYOUT = [("192.168.2.21", 0.0, True), ("192.168.2.22", 0.35, False), ("192.168.2.23", 0.7, True)]
MONO_LAYOUT = [("192.168.2.21", 0.0, False)]


def _frames(layout, seed, ticks, w=W, h=H):
    sources, rig_ext, traj = _rig(layout, seed, w, h)
    with CameraRig(sources, rig_extrinsics=rig_ext) as rig:
        return rig.calibration, [rig.get_synchronized_frames() for _ in range(ticks)], traj


def _stack(fs, order, h=H, w=W):
    """(C, 2, H, W) uint8 images of a frame set; a mono source's right image is zero."""
    out = np.zeros((len(order), 2, h, w), np.uint8)
    for ci, name in enumerate(order):
        for ei, f in enumerate(fs.frame_sets[name].frames[:2]):
            out[ci, ei] = f.image
    return out


def _copy(state_j):
    return jax.tree.map(lambda x: jnp.array(x, copy=True), state_j)


def _state_np(state_j):
    return {f: np.asarray(v) for f, v in state_j._asdict().items() if f != "key"}


def _run(engine, frames, calibration, traj, num_cameras):
    engine.initialize(calibration, SlamConfig(num_cameras=num_cameras, enable_loop_closure=False))
    est, gt, states, promoted, attempts, boot_at = [], [], [], [], [], None
    gt0 = traj.pose(frames[0].timestamp)
    for i, fs in enumerate(frames):
        pose = engine.process_frames(fs)
        states.append(engine.get_tracking_state().name)
        if "mono_bootstrap" in engine.last_diagnostics:  # the port reports each attempt
            attempts.append(engine.last_diagnostics["mono_bootstrap"])
        st = engine._tracker_state
        promoted.append((np.asarray(st.lm_valid) & ~np.asarray(st.lm_pending)).sum(1).tolist())
        if boot_at is None and engine._mono_boot_done:
            boot_at = i
        if pose is not None:
            est.append(pose.position.copy())
            gt.append((np.linalg.inv(gt0) @ traj.pose(fs.timestamp))[:3, 3])
    engine.flush()
    # The final state, copied: tests that drive the engines further (or
    # the reference's donating step) leave it alone.
    state = engine._tracker_state
    state = state._replace(**{f: v.clone() for f, v in state._asdict().items()}) if isinstance(engine, TorchSlamEngine) else _copy(state)
    return dict(est=np.asarray(est), gt=np.asarray(gt), states=states, boot_at=boot_at, engine=engine, state=state,
                promoted=np.asarray(promoted), attempts=attempts)


def _pair(layout, seed, ticks, params, num_cameras, w=W, h=H, **flags):
    cal, frames, traj = _frames(layout, seed, ticks + 1, w, h)
    ref = TpuSlamEngine(params=params, use_imu=False, pipelined=False, light_ticks=False, adaptive_half_res=False, **flags)
    port = TorchSlamEngine(params=params, device="cpu", use_imu=False, light_ticks=False, **flags)
    out = dict(
        ref=_run(ref, frames[:ticks], cal, traj, num_cameras),
        port=_run(port, frames[:ticks], cal, traj, num_cameras),
        cal=cal, next_frames=frames[ticks], order=sorted(cal.source_names),
    )
    return out, (ref, port)


@pytest.fixture(scope="module")
def mixed():
    out, engines = _pair(MIXED_LAYOUT, 7, MIXED_TICKS, MIXED_PARAMS, 5)
    yield out
    for e in engines:
        e.shutdown()


@pytest.fixture(scope="module")
def mono():
    out, engines = _pair(MONO_LAYOUT, 9, MONO_TICKS, MONO_PARAMS, 1)
    yield out
    for e in engines:
        e.shutdown()


# ---------------------------------------------------------------- setup


@pytest.mark.parametrize("layout", [MIXED_LAYOUT, MONO_LAYOUT, MONO_LAYOUT + [("192.168.2.22", 0.5, False)]])
def test_build_camera_setup_accepts_mono_and_equals_reference(layout):
    sources, rig_ext, _ = _rig(layout, 7)
    cal = CameraRig(sources, rig_extrinsics=rig_ext).calibration
    want, order_j, h_j, w_j = jsetup.build_camera_setup(cal)
    got, order_t, h_t, w_t = tsetup.build_camera_setup(cal)
    assert (order_t, h_t, w_t) == (order_j, h_j, w_j) == (sorted(n for n, _, _ in layout), H, W)
    for f in jtrk.CameraSetup._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_array_equal(got.stereo_mask, [s for _, _, s in sorted(layout)])
    mono_cams = ~got.stereo_mask
    np.testing.assert_array_equal(got.k_right[mono_cams], got.k_left[mono_cams])
    np.testing.assert_array_equal(got.baseline[mono_cams], 1.0)
    np.testing.assert_array_equal(got.rect_left[mono_cams], np.broadcast_to(np.eye(3, dtype=np.float32), (mono_cams.sum(), 3, 3)))


def test_mixed_resolutions_still_raise():
    sources, rig_ext, _ = _rig(MIXED_LAYOUT, 7)
    cal = CameraRig(sources, rig_extrinsics=rig_ext).calibration
    intr = cal.intrinsics["192.168.2.22"][0]
    cal.intrinsics["192.168.2.22"] = [type(intr)(**{**intr.__dict__, "width": W // 2, "height": H // 2})]
    with pytest.raises(RuntimeError, match="resolution"):
        tsetup.build_camera_setup(cal)


# --------------------------------------------------------------- engines


def test_mixed_rig_tracks_like_reference(mixed):
    ref, port = mixed["ref"], mixed["port"]
    ate_ref, ate_port = ate_rmse(ref["est"], ref["gt"]), ate_rmse(port["est"], port["gt"])
    assert ate_ref < 0.05 and ate_port < 0.05
    assert abs(ate_ref - ate_port) <= 0.01
    np.testing.assert_allclose(port["est"], ref["est"], atol=0.02)
    for run in (ref, port):
        first = run["states"].index("TRACKING")
        assert first <= 3 and np.mean([s == "TRACKING" for s in run["states"][first:]]) >= 0.9
        assert run["boot_at"] is None  # no bootstrap on a rig with a stereo source


def test_mixed_rig_seeds_the_mono_bank_with_weights(mixed):
    p = mixed["port"]["engine"]
    assert p._params.has_mono and not p._params.mono_bootstrap and p._enable_ba
    st_j, st_t = mixed["ref"]["state"], mixed["port"]["state"]
    valid_j, valid_t = np.asarray(st_j.lm_valid), st_t.lm_valid.numpy()
    assert valid_t[1].sum() > 20 and valid_j[1].sum() > 20  # the mono camera is index 1
    assert abs(int(valid_t[1].sum()) - int(valid_j[1].sum())) <= 8
    assert not st_t.lm_pending.any()
    w_t = st_t.lm_weight.numpy()
    prior = p._params.mono_obs_weight
    assert (w_t[[0, 2]][valid_t[[0, 2]]] == 1.0).all()  # stereo slots
    seeded = w_t[1][valid_t[1]]
    assert ((seeded > 0.5 * prior) & (seeded <= prior)).all()
    w_j = np.asarray(st_j.lm_weight)[1][valid_j[1]]
    np.testing.assert_allclose(np.median(seeded), np.median(w_j), rtol=0.02)
    # A seeded slot shares its landmark's id with a stereo camera's slot.
    ids = st_t.lm_id.numpy()
    shared = np.isin(ids[1][valid_t[1]], ids[[0, 2]][valid_t[[0, 2]]])
    assert shared.mean() > 0.5


def test_ba_window_weights_mono_cameras(mixed):
    ba = mixed["port"]["engine"]._ba
    np.testing.assert_array_equal(ba._cam_weight, np.float32([1.0, 0.25, 1.0]))
    built = ba.build_problem({})
    assert built is not None
    mask = built[0].obs_mask.numpy()  # (K, 2C, L)
    assert set(np.unique(mask[:, 1])) <= {0.0, 0.25} and (mask[:, 1] == 0.25).any()
    assert set(np.unique(mask[:, [0, 2]])) <= {0.0, 1.0}
    assert not mask[:, 4].any()  # the mono camera has no right imager
    other = TrackBA()
    other.bind(mixed["port"]["engine"]._setup, 3, mono_obs_weight=0.5)
    np.testing.assert_array_equal(other._cam_weight, np.float32([1.0, 0.5, 1.0]))


def test_all_mono_rig_bootstraps_and_tracks_like_reference(mono):
    ref, port = mono["ref"], mono["port"]
    for run in (ref, port):
        assert run["boot_at"] is not None and run["boot_at"] < 35
        assert run["states"][-1] == "TRACKING"
        st = run["state"]
        real = int((np.asarray(st.lm_valid) & ~np.asarray(st.lm_pending)).sum())
        assert real > 20, f"{real} promoted landmarks"
        # Up to scale: Sim(3)-aligned ATE over the second half, the
        # reference's bar (15 % of the path).
        n = len(run["est"])
        ate = ate_rmse(run["est"][n // 2 :], run["gt"][n // 2 :], with_scale=True)
        path = np.linalg.norm(np.diff(run["gt"][n // 2 :], axis=0), axis=1).sum()
        assert ate < 0.15 * max(path, 0.1), f"scale-aligned ATE {ate:.3f} m over {path:.2f} m"
    # Both attempt on the same ticks (every other one from the third): the
    # same draws are not available to both, so allow one attempt between.
    assert abs(ref["boot_at"] - port["boot_at"]) <= 2
    # The port's diagnostics carry every attempt: the first after tick 2,
    # then every other tick, the last one accepted.
    attempts = port["attempts"]
    assert len(attempts) == (port["boot_at"] - 2) // 2 + 1
    assert [a["success"] for a in attempts] == [False] * (len(attempts) - 1) + [True]
    assert attempts[-1]["inliers"] > 0 and attempts[-1]["landmarks"] > 0 and attempts[-1]["ms"] > 0


@pytest.mark.slow
def test_promoted_landmarks_cycle_alike_at_full_width():
    """Two mono cameras at 640x400 with 512 slots each, 70 ticks (the rig
    and size of ``chip_smoke.py``'s all-mono phase; minutes on the CPU).

    At this size the bank of promoted landmarks decays and recovers in
    cycles in BOTH engines: a keyframe resets the anchor of every pending
    track still under the parallax floor, so between two waves of promotions
    the count only falls. (Found here, camera 0 / camera 1: the reference
    falls to 8 / 3 and recovers to 155 / 229 at tick 25; the port falls to
    8 / 18 and recovers to 70 / 110 at tick 42.) A count at one tick is
    therefore no bar; the median over the last 20 ticks is, and both
    engines pass the reference test's 40 / 20 there. The draws differ, so
    the tick of a recovery does: the series are held together by their
    shape, not tick by tick."""
    layout = MONO_LAYOUT + [("192.168.2.22", 0.5, False)]
    out, engines = _pair(layout, 9, 70, dict(max_keypoints=512, keyframe_min_inliers=40), 2, w=640, h=400)
    try:
        for name in ("ref", "port"):
            run = out[name]
            assert run["boot_at"] is not None and run["boot_at"] < 35, name
            since = run["promoted"][run["boot_at"] + 1 :]
            after = run["states"][run["boot_at"] + 1 :]
            assert np.mean([s == "TRACKING" for s in after]) >= 0.9, name
            # The decay: each camera falls under the bar at some tick after its peak ...
            assert (since.min(0) < (40, 20)).all() and (since.max(0) > (40, 20)).all(), (name, since.tolist())
            # ... and never to nothing once both cameras hold landmarks.
            assert (since[2:].min(0) > 0).all(), (name, since.tolist())
            tail = np.median(run["promoted"][-20:], axis=0)
            assert (tail > (40, 20)).all(), (name, tail)
    finally:
        for e in engines:
            e.shutdown()


def test_all_mono_rig_switches_metric_subsystems_off(mono, caplog):
    engine = TorchSlamEngine(params=MONO_PARAMS, device="cpu")  # defaults: BA, IMU with accel
    with caplog.at_level(logging.WARNING, logger="thor_slam_tpu_torch.engine.torch_engine"):
        engine.initialize(mono["cal"], SlamConfig(num_cameras=1, enable_loop_closure=False))
    assert "window BA disabled" in caplog.text and "accel translation prediction disabled" in caplog.text
    assert not engine._enable_ba and not engine._use_accel and not engine._imu.use_accel and engine._use_imu
    assert engine._params.has_mono and engine._params.mono_bootstrap and engine._all_mono
    assert engine._mono_boot_countdown == 2 and not engine._mono_boot_done
    engine.shutdown()


def test_all_mono_bootstrap_rearms_when_the_landmarks_are_lost(mono):
    """Black frames after the bootstrap: the restart empties the landmark
    set and the attempt loop starts again, in both engines."""
    cal, frames, traj = _frames(MONO_LAYOUT, 9, 24)
    for fs in frames[12:22]:
        for source_frames in fs.frame_sets.values():
            for f in source_frames.frames:
                f.image = np.zeros_like(f.image)
    port = TorchSlamEngine(params=MONO_PARAMS, device="cpu", use_imu=False, light_ticks=False)
    port.initialize(cal, SlamConfig(num_cameras=1, enable_loop_closure=False))
    done = []
    for fs in frames:
        port.process_frames(fs)
        done.append(port._mono_boot_done)
    assert done[10] and not done[21]  # bootstrapped, then re-armed in the dark
    ref = mono["ref"]["engine"]
    ref.reset()
    done_ref = []
    for fs in frames:
        ref.process_frames(fs)
        done_ref.append(ref._mono_boot_done)
    first_lost = lambda d: next(i for i in range(11, len(d)) if not d[i])  # noqa: E731
    assert abs(first_lost(done) - first_lost(done_ref)) <= 1
    port.shutdown()


# ---------------------------------------------------- tracker: one step


def _one_step(run, order, next_frames, prediction=False):
    """One tick from the reference engine's final state, in both trackers."""
    ref, port = run["ref"]["engine"], run["port"]["engine"]
    state_j = _copy(run["ref"]["state"])
    state_t = convert.state_to_torch(_state_np(state_j), "cpu")
    images = _stack(next_frames, order)
    _, subkey = jax.random.split(state_j.key)
    c, n = state_t.lm_valid.shape
    uniforms = np.asarray(jax.random.uniform(subkey, (ref._params.ransac_hypotheses, c * n)))
    outs = ref._step(state_j, jnp.asarray(images), None, None)
    new_t, out_t = ttrk.track_step(port._params, port._setup, state_t, _t(images), uniforms=_t(uniforms))
    return state_t, outs[0], outs[1], new_t, out_t


def test_converted_state_carries_pending_and_weights(mixed, mono):
    for run, want_pending, want_weights in ((mixed, False, True), (mono, True, False)):
        state_j = run["ref"]["state"]
        state_t = convert.state_to_torch(_state_np(state_j), "cpu")
        back = convert.state_to_numpy(state_t)
        for f in ttrk.TrackerState._fields:
            np.testing.assert_array_equal(back[f], np.asarray(getattr(state_j, f)), err_msg=f)
        assert state_t.lm_pending.dtype == torch.bool and state_t.lm_weight.dtype == torch.float32
        assert bool(state_t.lm_pending.any()) == want_pending
        assert bool(((state_t.lm_weight != 1.0) & state_t.lm_valid).any()) == want_weights


def test_track_step_from_a_state_with_seeded_mono_slots(mixed):
    state_t, new_j, out_j, new_t, out_t = _one_step(mixed, mixed["order"], mixed["next_frames"])
    assert bool(((state_t.lm_weight != 1.0) & state_t.lm_valid)[1].any())  # the weights are in play
    np.testing.assert_allclose(out_t.world_t_body.numpy(), np.asarray(out_j.world_t_body), atol=1e-4)
    assert int(out_t.num_matches) == int(out_j.num_matches)
    assert abs(int(out_t.num_inliers) - int(out_j.num_inliers)) <= 2
    assert bool(out_t.refreshed) == bool(out_j.refreshed)
    cov_j = np.asarray(out_j.covariance)
    np.testing.assert_allclose(out_t.covariance.numpy(), cov_j, rtol=1e-2, atol=1e-2 * np.abs(cov_j).max())
    # With the weights ignored the solve is another one.
    plain = ttrk.track_step(
        ttrk.TrackerParams(**{**mixed["port"]["engine"]._params.__dict__, "has_mono": False}),
        mixed["port"]["engine"]._setup, state_t, _t(_stack(mixed["next_frames"], mixed["order"])),
        generator=torch.Generator().manual_seed(0),
    )[1]
    assert not np.allclose(plain.covariance.numpy(), out_t.covariance.numpy(), rtol=1e-3)


def test_track_step_from_a_state_with_pending_slots(mono):
    state_t, new_j, out_j, new_t, out_t = _one_step(mono, mono["order"], mono["next_frames"])
    pending = state_t.lm_pending & state_t.lm_valid
    assert int(pending.sum()) > 10 and int((state_t.lm_valid & ~state_t.lm_pending).sum()) > 20
    np.testing.assert_allclose(out_t.world_t_body.numpy(), np.asarray(out_j.world_t_body), atol=1e-4)
    assert abs(int(out_t.num_inliers) - int(out_j.num_inliers)) <= 2
    assert int(out_t.num_matches) == int(out_j.num_matches)
    assert int(out_t.num_landmarks) == int(out_j.num_landmarks)
    assert bool(out_t.refreshed) == bool(out_j.refreshed)
    # Pending slots: tracked in 2D from their last pixel, kept out of the
    # solve, the landmark count and the reported valid mask.
    np.testing.assert_array_equal(out_t.lm_valid.numpy(), np.asarray(out_j.lm_valid))
    np.testing.assert_array_equal(new_t.lm_pending.numpy(), np.asarray(new_j.lm_pending))
    assert not (out_t.lm_valid & new_t.lm_pending).any()
    if not bool(out_t.refreshed):
        still = (new_t.lm_valid & new_t.lm_pending).numpy()
        assert still.sum() > 0.7 * int(pending.sum())  # they went on being tracked
        np.testing.assert_allclose(new_t.lm_px.numpy()[still], np.asarray(new_j.lm_px)[still], atol=2e-2)
    assert int(out_t.num_landmarks) == int((new_t.lm_valid & ~new_t.lm_pending).sum())


# --------------------------------------------------- tracker: mint_bank


def _kf_to_jax(kf):
    vals = {f: getattr(kf, f).numpy() for f in kf._fields}
    vals["desc_bits"] = vals["desc_bits"].view(np.uint32)
    return jtrk.KeyframeProducts(**{f: jnp.asarray(v) for f, v in vals.items()})


def _mint_both(run, order, next_frames, all_mono):
    """Both ``mint_bank`` functions on the port's keyframe products of the
    next frame set, with the reference's final state as the candidates."""
    ref, port = run["ref"]["engine"], run["port"]["engine"]
    state_j = run["ref"]["state"]
    state_t = convert.state_to_torch(_state_np(state_j), "cpu")
    p, setup = port._params, port._setup
    images = _t(_stack(next_frames, order)).float() * (1.0 / 255.0)
    hot = ttrk.run_hot_frontend(p, setup, state_t, images, torch.linalg.inv(state_t.world_t_body))
    kf = ttrk.run_keyframe_frontend(p, setup, images)
    c, n = state_t.lm_valid.shape
    fresh = 100000 + torch.arange(c * n, dtype=torch.int32).reshape(c, n)
    pose = state_t.world_t_body
    anchor_ok = hot.corr_valid & ~state_t.lm_pending
    got = ttrk.mint_bank(
        p, setup, pose, kf, anchor_ok=anchor_ok, cand_tracks_xy=hot.tracks_xy, cand_pos_w=state_t.lm_pos_w,
        cand_id=state_t.lm_id, fresh_ids=fresh, cam_active=None, cand_weight=state_t.lm_weight,
        cand_pending=state_t.lm_pending if all_mono else None,
        cand_anchor_px=state_t.lm_anchor_px if all_mono else None, prev_kf_pose=state_t.kf_world_t_body,
    )
    setup_j = jsetup.build_camera_setup(run["cal"])[0]
    with jax.default_matmul_precision("float32"):
        want = jtrk.mint_bank(
            ref._params, setup_j, jnp.asarray(pose.numpy()), _kf_to_jax(kf),
            anchor_ok=jnp.asarray(anchor_ok.numpy()), cand_tracks_xy=jnp.asarray(hot.tracks_xy.numpy()),
            cand_pos_w=state_j.lm_pos_w, cand_id=state_j.lm_id, fresh_ids=jnp.asarray(fresh.numpy()), cam_active=None,
            cand_pending=state_j.lm_pending if all_mono else None,
            cand_anchor_px=state_j.lm_anchor_px if all_mono else None,
            prev_kf_pose=state_j.kf_world_t_body, cand_weight=state_j.lm_weight,
        )
    names = ("lm_pos", "lm_desc", "lm_valid", "lm_px", "lm_obs", "lm_robs", "lm_robs_valid", "lm_id", "lm_pending", "lm_anchor_px", "lm_weight")
    return dict(zip(names, got)), dict(zip(names, map(np.asarray, want))), kf


def _assert_banks_equal(got, want):
    for f in ("lm_valid", "lm_robs_valid", "lm_pending", "lm_id"):
        np.testing.assert_array_equal(got[f].numpy(), want[f], err_msg=f)
    np.testing.assert_array_equal(got["lm_desc"].numpy().view(np.uint32), want["lm_desc"])
    valid = want["lm_valid"]
    for f in ("lm_px", "lm_obs", "lm_anchor_px"):
        np.testing.assert_allclose(got[f].numpy(), want[f], atol=1e-4, err_msg=f)
    np.testing.assert_allclose(got["lm_weight"].numpy(), want["lm_weight"], rtol=1e-4, err_msg="lm_weight")
    real = valid & ~want["lm_pending"]
    np.testing.assert_allclose(got["lm_pos"].numpy()[real], want["lm_pos"][real], rtol=1e-3, atol=2e-3)
    return valid


def test_mint_bank_seeds_mono_cameras_like_reference(mixed):
    got, want, kf = _mint_both(mixed, mixed["order"], mixed["next_frames"], all_mono=False)
    valid = _assert_banks_equal(got, want)
    assert not kf.tri_valid[1].any()  # the mono camera triangulated nothing
    assert valid[1].sum() > 20 and valid[0].sum() > 40
    w = got["lm_weight"].numpy()
    fresh_seed = valid[1] & (got["lm_id"].numpy()[1] >= 100000) & (w[1] < 1.0)
    assert fresh_seed.sum() > 5  # seeded this keyframe, not inherited
    assert not want["lm_pending"].any()


def test_mint_bank_promotes_pending_tracks_like_reference(mono):
    got, want, kf = _mint_both(mono, mono["order"], mono["next_frames"], all_mono=True)
    valid = _assert_banks_equal(got, want)
    pending = got["lm_pending"].numpy()
    assert (valid & pending).sum() > 10 and (valid & ~pending).sum() > 20
    assert not kf.tri_valid.any() and not got["lm_robs_valid"].any()
    assert (got["lm_weight"].numpy() == 1.0).all()


def test_pending_candidate_without_parallax_is_not_inherited():
    """A rule of the reference (``tracker.py``, the pending flags of
    ``mint_bank``), kept and pinned: only promoted candidates are trusted.
    A detection landing on a candidate that is still pending (too little
    parallax yet) starts a new track with a new id and a new anchor, so
    the parallax of a far landmark starts again at every keyframe and it
    is never promoted."""
    kw = dict(num_cams=1, height=H, width=W, max_keypoints=4, has_mono=True, mono_bootstrap=True)
    pj, pt = jtrk.TrackerParams(**kw), ttrk.TrackerParams(**kw)
    sources, rig_ext, _ = _rig(MONO_LAYOUT, 9)
    cal = CameraRig(sources, rig_extrinsics=rig_ext).calibration
    setup_j = jsetup.build_camera_setup(cal)[0]
    setup_t = convert.setup_to_torch(tsetup.build_camera_setup(cal)[0], "cpu")
    k = np.asarray(setup_j.k_left[0])
    body_t_cam = np.asarray(setup_j.body_t_cam[0], np.float64)
    prev_pose = np.eye(4)
    pose = np.eye(4)
    pose[:3, 3] = body_t_cam[:3, :3] @ np.array([0.25, 0.0, 0.0])  # the camera moved 25 cm sideways

    def project(p_w, world_t_body):
        p_c = np.linalg.inv(world_t_body @ body_t_cam) @ np.append(p_w, 1.0)
        return np.array([k[0] * p_c[0] / p_c[2] + k[2], k[1] * p_c[1] / p_c[2] + k[3]], np.float32)

    near = (prev_pose @ body_t_cam @ np.array([0.1, 0.05, 2.0, 1.0]))[:3]  # 2 m: 7 deg of parallax
    far = (prev_pose @ body_t_cam @ np.array([-0.3, 0.1, 60.0, 1.0]))[:3]  # 60 m: 0.24 deg, under the floor
    anchors = np.stack([project(near, prev_pose), project(far, prev_pose), [30.0, 30.0], [0.0, 0.0]]).astype(np.float32)
    tracks = np.stack([project(near, pose), project(far, pose), [30.0, 30.0], [0.0, 0.0]]).astype(np.float32)
    kp_xy = tracks.copy()
    kp_xy[2] = [100.0, 90.0]  # a detection with no candidate near it
    kp_valid = np.array([True, True, True, False])
    cand_pending = np.array([True, True, True, False])
    zeros3 = np.zeros((1, 4, 3), np.float32)
    common = dict(
        anchor_ok=np.zeros((1, 4), bool), cand_tracks_xy=tracks[None], cand_pos_w=zeros3,
        cand_id=np.arange(10, 14, dtype=np.int32)[None], fresh_ids=np.arange(500, 504, dtype=np.int32)[None],
        cand_pending=cand_pending[None], cand_anchor_px=anchors[None], prev_kf_pose=prev_pose.astype(np.float32),
        cand_weight=np.ones((1, 4), np.float32),
    )
    kf_np = dict(
        kp_xy=kp_xy[None], kp_valid=kp_valid[None], desc_bits=np.zeros((1, 4, 8), np.int32), pts_cam=zeros3,
        tri_valid=np.zeros((1, 4), bool), right_obs_px=np.zeros((1, 4, 2), np.float32),
    )
    got = ttrk.mint_bank(
        pt, setup_t, _t(pose.astype(np.float32)), ttrk.KeyframeProducts(**{f: _t(v) for f, v in kf_np.items()}),
        cam_active=None, **{f: _t(v) for f, v in common.items()},
    )
    kf_j = jtrk.KeyframeProducts(**{f: jnp.asarray(v.view(np.uint32) if f == "desc_bits" else v) for f, v in kf_np.items()})
    with jax.default_matmul_precision("float32"):
        want = jtrk.mint_bank(
            pj, setup_j, jnp.asarray(pose, jnp.float32), kf_j, cam_active=None,
            **{f: jnp.asarray(v) for f, v in common.items()},
        )
    for bank in (got, tuple(map(np.asarray, want))):
        lm_pos, _, lm_valid, _, lm_obs, _, _, lm_id, lm_pending, lm_anchor, _ = (np.asarray(x) for x in bank)
        np.testing.assert_array_equal(lm_valid[0], [True, True, True, False])
        np.testing.assert_array_equal(lm_pending[0], [False, True, True, False])
        # Slot 0: promoted by motion triangulation, inherited with its id.
        assert lm_id[0, 0] == 10
        np.testing.assert_allclose(lm_pos[0, 0], near, atol=0.02)
        # Slot 1: the pending candidate under it is NOT inherited: a fresh
        # id, and the anchor is this keyframe's detection.
        assert lm_id[0, 1] == 501
        np.testing.assert_array_equal(lm_anchor[0, 1], kp_xy[1])
        assert lm_id[0, 2] == 502  # and a plain fresh detection is pending too


# ------------------------------------------------ tracker: the bootstrap


@pytest.mark.parametrize("ticks", [2, 12])
def test_mono_init_like_reference(mono, ticks):
    """The bootstrap attempt from one state in both packages: too early
    (2 ticks: under the trigger parallax, the state passes unchanged) and
    with parallax to spare (12 ticks: accepted). In between the translation
    direction is weakly determined (the camera moves mostly along its
    axis) and follows the last bits of the winning hypothesis: at 5 and 9
    ticks the two packages accept with the same inliers and directions
    20 degrees apart, each a valid gauge.)"""
    ref, port = mono["ref"]["engine"], mono["port"]["engine"]
    p, setup = port._params, port._setup
    cal, frames, _ = _frames(MONO_LAYOUT, 9, ticks)
    state_t = ttrk.init_state(p, "cpu")
    gen = torch.Generator().manual_seed(1)
    for fs in frames:
        state_t, _ = ttrk.track_step(p, setup, state_t, _t(_stack(fs, mono["order"])), generator=gen)
    assert int((state_t.lm_valid & state_t.lm_pending).sum()) > 100
    key = jax.random.PRNGKey(ticks)
    fields = {f: jnp.asarray(v) for f, v in convert.state_to_numpy(state_t).items()}
    state_j = jtrk.TrackerState(key=key, **fields)
    _, subkey = jax.random.split(key)
    uniforms = np.asarray(jax.random.uniform(subkey, (64, p.max_keypoints)))
    new_j, flag_j = ref._mono_init(state_j)
    new_t, flag_t = ttrk.mono_init(p, setup, state_t, uniforms=_t(uniforms))
    flag_j, flag_t = np.asarray(flag_j), flag_t.numpy()
    assert flag_t.shape == (ttrk.MONO_INIT_PACKED_LEN,) and flag_t[0] == flag_j[0] == float(ticks == 12)
    np.testing.assert_allclose(flag_t[2], flag_j[2], rtol=1e-4)  # mean parallax
    assert abs(flag_t[1] - flag_j[1]) <= 3 and abs(flag_t[3] - flag_j[3]) <= 4
    # The new pose is one unit step away: 0.03 is 3 % of the gauge, 1.7 deg
    # of translation direction.
    np.testing.assert_allclose(new_t.world_t_body.numpy(), np.asarray(new_j.world_t_body), atol=0.03)
    np.testing.assert_allclose(new_t.prev_world_t_body.numpy(), np.asarray(new_j.prev_world_t_body), atol=1e-6)
    same = new_t.lm_pending.numpy() == np.asarray(new_j.lm_pending)
    assert same.mean() >= 0.98
    if ticks == 2:
        assert torch.equal(new_t.lm_pending, state_t.lm_pending) and torch.equal(new_t.lm_pos_w, state_t.lm_pos_w)
        assert torch.equal(new_t.world_t_body, state_t.world_t_body)
    else:
        real = (new_t.lm_valid & ~new_t.lm_pending).numpy()[0] & (np.asarray(new_j.lm_valid) & ~np.asarray(new_j.lm_pending))[0]
        assert real.sum() >= 20 and int(new_t.untracked_streak) == 0
        # Unit translation between the two views: the gauge of the map.
        step = np.linalg.norm(new_t.world_t_body.numpy()[:3, 3] - state_t.kf_world_t_body.numpy()[:3, 3])
        assert 0.9 < step < 1.1
        np.testing.assert_allclose(new_t.lm_pos_w.numpy()[0][real], np.asarray(new_j.lm_pos_w)[0][real], rtol=0.05, atol=0.15)
