"""The port's tracker in lockstep with the JAX tracker.

Both start from one state (the reference's ``init_state`` carried over by
``engine/convert.py``) and consume the same rendered ticks of a 2-camera
stereo rig at 160x120 with 128 landmark slots per camera. Each tick's
RANSAC draws come from the reference's own key chain
(``jax.random.split(state.key)`` then ``uniform(subkey, (H, C*N))``) and
are injected into the port. The two states then evolve independently.

Tolerances: per tick 5 mm / 5 mrad on the pose, identical keyframe
decisions on >= 90 % of ticks, inliers within max(3, 5 %). Both trackers
run the same f32 algorithm; the margin absorbs summation-order ulps that
could flip a near-threshold inlier or keyframe decision and let the two
banks drift apart.
"""

from __future__ import annotations

import jax
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
from thor_slam_tpu.engine import setup as jsetup
from thor_slam_tpu.engine import tracker as jtrk
from thor_slam_tpu_torch.engine import convert
from thor_slam_tpu_torch.engine import setup as tsetup
from thor_slam_tpu_torch.engine import tracker as ttrk

torch.set_num_threads(2)

TICKS = 12
N = 128


def _rot_err(a, b):
    rel = a[:3, :3].T @ b[:3, :3]
    return float(np.arccos(np.clip(0.5 * (np.trace(rel) - 1.0), -1.0, 1.0)))


@pytest.fixture(scope="module")
def lockstep():
    spec = SyntheticRigSpec(num_sources=2, stereo=True, width=160, height=120, fps=30.0, baseline_m=0.12)
    sources, rig_ext, _, _ = make_synthetic_rig(
        spec, world=SyntheticWorld(half_extents=(4.0, 4.0, 2.0)),
        trajectory=OrbitTrajectory(radius=1.5, angular_rate=0.5),
    )
    with CameraRig(sources, rig_extrinsics=rig_ext) as rig:
        cal = rig.calibration
        order = sorted(cal.source_names)
        ticks = []
        for _ in range(TICKS):
            sync = rig.get_synchronized_frames()
            ticks.append(
                np.stack([[f.image for f in sync.frame_sets[name].frames[:2]] for name in order])
            )
    setup_j, _, h, w = jsetup.build_camera_setup(cal)
    setup_np, _, _, _ = tsetup.build_camera_setup(cal)
    params_j = jtrk.TrackerParams(num_cams=2, height=h, width=w, max_keypoints=N)
    params_t = ttrk.TrackerParams(num_cams=2, height=h, width=w, max_keypoints=N)
    step_j = jtrk.make_track_step(params_j, setup_j)
    setup_t = convert.setup_to_torch(setup_np, "cpu")

    state_j = jtrk.init_state(params_j)
    state_t = convert.state_to_torch({f: np.asarray(v) for f, v in state_j._asdict().items()}, "cpu")
    rows = []
    for images in ticks:
        _, subkey = jax.random.split(state_j.key)
        uniforms = np.asarray(jax.random.uniform(subkey, (params_j.ransac_hypotheses, 2 * N)))
        state_j, out_j = step_j(state_j, jnp.asarray(images))
        state_t, out_t = ttrk.track_step(
            params_t, setup_t, state_t, torch.from_numpy(images.copy()), uniforms=torch.from_numpy(uniforms.copy())
        )
        rows.append(
            dict(
                pose_j=np.asarray(out_j.world_t_body), pose_t=out_t.world_t_body.numpy(),
                inl_j=int(out_j.num_inliers), inl_t=int(out_t.num_inliers),
                ref_j=bool(out_j.refreshed), ref_t=bool(out_t.refreshed),
                packed_t=ttrk.pack_output(out_t),
            )
        )
    return rows, state_j, state_t


def test_poses_agree_every_tick(lockstep):
    rows, _, _ = lockstep
    for i, r in enumerate(rows):
        dt = np.linalg.norm(r["pose_j"][:3, 3] - r["pose_t"][:3, 3])
        assert dt <= 5e-3, f"tick {i}: translation differs by {dt:.4f} m"
        assert _rot_err(r["pose_j"], r["pose_t"]) <= 5e-3, f"tick {i}: rotation"


def test_keyframe_decisions_agree(lockstep):
    rows, _, _ = lockstep
    same = np.mean([r["ref_j"] == r["ref_t"] for r in rows])
    assert same >= 0.9
    assert rows[0]["ref_t"] and sum(r["ref_t"] for r in rows) >= 2


def test_inlier_counts_agree(lockstep):
    rows, _, _ = lockstep
    assert all(r["inl_t"] >= 50 for r in rows[1:])  # actually tracking
    for i, r in enumerate(rows):
        assert abs(r["inl_j"] - r["inl_t"]) <= max(3, 0.05 * r["inl_j"]), f"tick {i}: {r}"


def test_final_state_landmarks_agree(lockstep):
    _, state_j, state_t = lockstep
    back = convert.state_to_numpy(state_t)
    assert set(back) == set(jtrk.TrackerState._fields) - {"key"}
    for f in ("frame_idx", "lm_id_counter", "last_kf_frame"):
        assert int(back[f]) == int(np.asarray(getattr(state_j, f))), f
    vj = np.asarray(state_j.lm_valid)
    vt = back["lm_valid"]
    assert np.mean(vj == vt) >= 0.95
    both = vj & vt
    np.testing.assert_allclose(back["lm_pos_w"][both], np.asarray(state_j.lm_pos_w)[both], atol=0.05)


def test_packed_output_layout(lockstep):
    rows, _, _ = lockstep
    vec = rows[-1]["packed_t"]
    assert vec.shape == (ttrk.PACKED_LEN,) and vec.dtype == torch.float32
    vals = ttrk.unpack_output(vec)
    np.testing.assert_allclose(vals["world_t_body"], rows[-1]["pose_t"], atol=1e-7)
    assert vals["num_inliers"] == rows[-1]["inl_t"]
    assert vals["refreshed"] == rows[-1]["ref_t"]
    np.testing.assert_allclose(vals["covariance"], vals["covariance"].T, atol=1e-9)


def test_dead_camera_masked_like_reference():
    """``cam_active`` masks a dead camera out of the solve and the bank, in
    both trackers alike (3 ticks; camera 1 dies at the second)."""
    spec = SyntheticRigSpec(num_sources=2, stereo=True, width=160, height=120, fps=30.0, baseline_m=0.12)
    sources, rig_ext, _, _ = make_synthetic_rig(
        spec, world=SyntheticWorld(half_extents=(4.0, 4.0, 2.0)),
        trajectory=OrbitTrajectory(radius=1.5, angular_rate=0.5),
    )
    with CameraRig(sources, rig_extrinsics=rig_ext) as rig:
        cal = rig.calibration
        order = sorted(cal.source_names)
        ticks = [
            np.stack([[f.image for f in fs.frame_sets[name].frames[:2]] for name in order])
            for fs in (rig.get_synchronized_frames() for _ in range(3))
        ]
    setup_j, _, h, w = jsetup.build_camera_setup(cal)
    params_j = jtrk.TrackerParams(num_cams=2, height=h, width=w, max_keypoints=64)
    params_t = ttrk.TrackerParams(num_cams=2, height=h, width=w, max_keypoints=64)
    step_j = jtrk.make_track_step(params_j, setup_j)
    setup_t = convert.setup_to_torch(tsetup.build_camera_setup(cal)[0], "cpu")
    state_j = jtrk.init_state(params_j)
    state_t = convert.state_to_torch({f: np.asarray(v) for f, v in state_j._asdict().items()}, "cpu")
    active = np.array([True, False])
    for i, images in enumerate(ticks):
        _, subkey = jax.random.split(state_j.key)
        uniforms = np.asarray(jax.random.uniform(subkey, (params_j.ransac_hypotheses, 2 * 64)))
        mask = None if i == 0 else active
        state_j, out_j = step_j(state_j, jnp.asarray(images), None, None if mask is None else jnp.asarray(mask))
        state_t, out_t = ttrk.track_step(
            params_t, setup_t, state_t, torch.from_numpy(images.copy()),
            uniforms=torch.from_numpy(uniforms.copy()), cam_active=None if mask is None else torch.from_numpy(mask),
        )
        assert int(out_t.num_matches) == int(out_j.num_matches)
        assert int(out_t.num_inliers) == int(out_j.num_inliers)
        np.testing.assert_allclose(out_t.world_t_body.numpy(), np.asarray(out_j.world_t_body), atol=1e-5)
    assert int(out_t.num_matches) > 0
    assert not out_t.lm_valid.numpy()[1].any()  # the dead camera keeps no landmarks
