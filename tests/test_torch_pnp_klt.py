"""Parity of the port's KLT tracker and RANSAC PnP with the JAX reference."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thor_slam_tpu.engine import pnp as jpnp
from thor_slam_tpu.ops import fast as jfast
from thor_slam_tpu.ops import image as jimage
from thor_slam_tpu.ops import klt as jklt
from thor_slam_tpu.ops import lie as jlie
from thor_slam_tpu_torch.engine import pnp as tpnp
from thor_slam_tpu_torch.ops import klt as tklt

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- KLT


@pytest.fixture(scope="module")
def klt_case():
    """Two consecutive rendered frames of a 2-camera rig, corners to track."""
    from thor_slam_tpu.camera.sources.synthetic import (
        OrbitTrajectory,
        SyntheticRigSpec,
        SyntheticWorld,
        make_synthetic_rig,
    )

    spec = SyntheticRigSpec(num_sources=2, stereo=True, width=160, height=120)
    sources, _, _, _ = make_synthetic_rig(
        spec, world=SyntheticWorld(half_extents=(4.0, 4.0, 2.0)), trajectory=OrbitTrajectory(1.5, 0.5)
    )
    prev = np.stack([s.render_frame(4, 0) for s in sources]).astype(np.float32) / 255.0
    cur = np.stack([s.render_frame(6, 0) for s in sources]).astype(np.float32) / 255.0
    kp = jfast.detect_keypoints_batched(jnp.asarray(prev), threshold=0.05, max_keypoints=96, border_margin=12)
    rng = np.random.default_rng(31)
    pts_prev = np.asarray(kp.xy)
    # Initial guesses a few pixels off, as a pose prediction would leave them.
    pts_init = (pts_prev + rng.normal(0.0, 2.0, pts_prev.shape)).astype(np.float32)
    return prev, cur, pts_prev, pts_init, np.asarray(kp.valid)


def _pyr(imgs, levels=3):
    out = [imgs]
    for _ in range(levels - 1):
        out.append(np.stack([np.asarray(jimage.downsample2(jnp.asarray(im))) for im in out[-1]]))
    return out


@pytest.mark.parametrize("levels,iters", [(2, 3), (3, 8)])
def test_track_points_rig(klt_case, levels, iters):
    prev, cur, pts_prev, pts_init, valid = klt_case
    pp, cp = _pyr(prev), _pyr(cur)
    kw = dict(num_levels=levels, radius=4, iters=iters, max_residual=0.08)
    want = jklt.track_points_rig(
        tuple(map(jnp.asarray, pp)), tuple(map(jnp.asarray, cp)),
        jnp.asarray(pts_prev), jnp.asarray(pts_init), jnp.asarray(valid), **kw,
    )
    got = tklt.track_points_rig(
        tuple(map(_t, pp)), tuple(map(_t, cp)), _t(pts_prev), _t(pts_init), _t(valid), **kw
    )
    vj, vt = np.asarray(want.valid), got.valid.numpy()
    assert vj.sum() > 0.5 * valid.sum()
    assert np.mean(vj == vt) >= 0.99
    both = vj & vt
    # f32 contractions in another order, compounded over iterations.
    np.testing.assert_allclose(got.xy.numpy()[both], np.asarray(want.xy)[both], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.residual.numpy()[both], np.asarray(want.residual)[both], atol=1e-4)


def test_shifted_views_match_reference():
    rng = np.random.default_rng(32)
    win = rng.uniform(size=(6, 19, 19)).astype(np.float32)
    want = np.asarray(jklt._shifted_views(jnp.asarray(win), 4, 4))
    np.testing.assert_array_equal(tklt._shifted_views(_t(win), 4, 4).numpy(), want)  # a copy
    d = rng.uniform(-4, 4, size=(6, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tklt._interp_weights(_t(d), 4).numpy(), np.asarray(jklt._interp_weights(jnp.asarray(d), 4)), atol=1e-7
    )


# ---------------------------------------------------------------- PnP


def _pnp_case(seed=33, n=300, outlier_frac=0.2):
    """Two cameras on a body, world points in front, noisy + outlier obs."""
    rng = np.random.default_rng(seed)
    cam_t_body = []
    for yaw in (0.0, np.pi):
        r = np.asarray(jlie.so3_exp(jnp.asarray([0.0, yaw, 0.0], jnp.float32)))
        cam_t_body.append((r, np.array([0.05, 0.0, 0.02], np.float32)))
    cam = rng.integers(0, 2, size=n)
    rot = np.stack([cam_t_body[c][0] for c in cam]).astype(np.float32)
    trans = np.stack([cam_t_body[c][1] for c in cam]).astype(np.float32)
    body_t_world = np.asarray(jlie.se3_exp(jnp.asarray([0.1, -0.05, 0.2, 0.02, -0.03, 0.05], jnp.float32)))
    # Points: random camera-frame points lifted to world.
    p_c = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(2, 6, (n, 1))], -1)
    p_b = np.einsum("nji,nj->ni", rot, p_c - trans)
    w_t_b = np.linalg.inv(body_t_world)
    pts_w = (p_b @ w_t_b[:3, :3].T + w_t_b[:3, 3]).astype(np.float32)
    obs = (p_c[:, :2] / p_c[:, 2:] + rng.normal(0, 1e-3, (n, 2))).astype(np.float32)
    out = rng.uniform(size=n) < outlier_frac
    obs[out] += rng.uniform(-0.2, 0.2, (out.sum(), 2)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    init = np.asarray(jlie.se3_exp(jnp.asarray([0.12, -0.03, 0.17, 0.0, -0.02, 0.06], jnp.float32)))
    return pts_w, obs, valid, rot, trans, init


@pytest.mark.parametrize("seed", [33, 34, 35])
def test_ransac_pnp_with_injected_draws(seed):
    pts_w, obs, valid, rot, trans, init = _pnp_case(seed)
    key = jax.random.PRNGKey(seed)
    h, s = 16, 6
    want = jpnp.ransac_pnp(
        key, *map(jnp.asarray, (pts_w, obs, valid, rot, trans, init)),
        num_hypotheses=h, sample_size=s, inlier_threshold=0.006,
    )
    uniforms = np.asarray(jax.random.uniform(key, (h, pts_w.shape[0])))
    got = tpnp.ransac_pnp(
        *map(_t, (pts_w, obs, valid, rot, trans, init)),
        num_hypotheses=h, sample_size=s, inlier_threshold=0.006, uniforms=_t(uniforms),
    )
    # Same draws, same subsets: only f32 summation order differs in the GN
    # normal equations, so poses agree to ~1e-4 and the inlier sets exactly.
    np.testing.assert_allclose(got.body_t_world.numpy(), np.asarray(want.body_t_world), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers) > 100
    np.testing.assert_allclose(float(got.rms_error), float(want.rms_error), rtol=1e-3)
    # The covariance inverts a Hessian whose conditioning amplifies ulps.
    cov_j = np.asarray(want.covariance)
    np.testing.assert_allclose(got.covariance.numpy(), cov_j, rtol=1e-3, atol=1e-3 * np.abs(cov_j).max())


def test_generator_draws_are_reproducible():
    pts_w, obs, valid, rot, trans, init = _pnp_case(36)
    args = tuple(map(_t, (pts_w, obs, valid, rot, trans, init)))
    runs = [
        tpnp.ransac_pnp(*args, num_hypotheses=8, sample_size=6, inlier_threshold=0.006,
                        generator=torch.Generator().manual_seed(3))
        for _ in range(2)
    ]
    assert torch.equal(runs[0].body_t_world, runs[1].body_t_world)
    assert int(runs[0].num_inliers) > 100


def test_gauss_newton_and_covariance():
    pts_w, obs, valid, rot, trans, init = _pnp_case(37, outlier_frac=0.0)
    w = valid.astype(np.float32)
    x_j, r_j = jpnp.gauss_newton_pnp(*map(jnp.asarray, (pts_w, obs, w, rot, trans, init)), iters=6)
    x_t, r_t = tpnp.gauss_newton_pnp(*map(_t, (pts_w, obs, w, rot, trans, init)), iters=6)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-6, rtol=1e-4)
    cov_j = np.asarray(jpnp.pose_covariance(x_j, *map(jnp.asarray, (pts_w, obs, w, rot, trans))))
    cov_t = tpnp.pose_covariance(_t(np.asarray(x_j)), *map(_t, (pts_w, obs, w, rot, trans))).numpy()
    np.testing.assert_allclose(cov_t, cov_j, rtol=1e-3, atol=1e-3 * np.abs(cov_j).max())


def test_hypothesis_batch_matches_vmapped_reference():
    """The batched GN over (H, S) subsets equals the reference's vmap."""
    pts_w, obs, valid, rot, trans, init = _pnp_case(38)
    rng = np.random.default_rng(38)
    idx = rng.integers(0, pts_w.shape[0], size=(5, 6))
    sub = [a[idx] for a in (pts_w, obs, valid.astype(np.float32), rot, trans)]
    want = jax.vmap(lambda p, o, w, r, t: jpnp.gauss_newton_pnp(p, o, w, r, t, jnp.asarray(init), iters=5)[0])(
        *map(jnp.asarray, sub)
    )
    got, _ = tpnp.gauss_newton_pnp(*map(_t, sub), _t(init), iters=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
