"""Parity of the PyTorch port's math and image ops with the JAX reference.

Inputs come from ``np.random.default_rng`` and go through both
implementations on the CPU. Tolerances are stated per test; where none is
given the port performs the same float32 operations in the same order and
is held to a few ulps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thor_slam_tpu.camera.rig import RigCalibration
from thor_slam_tpu.camera.sources.synthetic import SyntheticRigSpec, make_synthetic_rig
from thor_slam_tpu.camera.types import Extrinsics, IMUExtrinsics
from thor_slam_tpu.engine import setup as jsetup
from thor_slam_tpu.engine import triangulate as jtri
from thor_slam_tpu.ops import brief as jbrief
from thor_slam_tpu.ops import calib as jcalib
from thor_slam_tpu.ops import image as jimage
from thor_slam_tpu.ops import lie as jlie
from thor_slam_tpu.ops import linalg as jlinalg
from thor_slam_tpu.ops import match as jmatch
from thor_slam_tpu.ops import stereo as jstereo
from thor_slam_tpu_torch.engine import convert
from thor_slam_tpu_torch.engine import setup as tsetup
from thor_slam_tpu_torch.engine import triangulate as ttri
from thor_slam_tpu_torch.ops import brief as tbrief
from thor_slam_tpu_torch.ops import calib as tcalib
from thor_slam_tpu_torch.ops import image as timage
from thor_slam_tpu_torch.ops import lie as tlie
from thor_slam_tpu_torch.ops import linalg as tlinalg
from thor_slam_tpu_torch.ops import match as tmatch
from thor_slam_tpu_torch.ops import stereo as tstereo

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-5, atol=1e-6)  # same f32 ops; libm/reduction-order ulps


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ lie


class TestLie:
    @pytest.mark.parametrize("scale", [1e-6, 0.3, 2.5])
    def test_so3_se3_exp_log(self, scale):
        rng = np.random.default_rng(1)
        xi = (rng.normal(size=(16, 6)) * scale).astype(np.float32)
        want = np.stack([np.asarray(jlie.se3_exp(jnp.asarray(x))) for x in xi])
        got = _np(tlie.se3_exp(_t(xi)))
        np.testing.assert_allclose(got, want, **F32_TOL)
        want_log = np.stack([np.asarray(jlie.se3_log(jnp.asarray(m))) for m in want])
        np.testing.assert_allclose(_np(tlie.se3_log(_t(want))), want_log, rtol=1e-4, atol=2e-5)

    def test_quaternions_and_inverse(self):
        rng = np.random.default_rng(2)
        q = rng.normal(size=(16, 4)).astype(np.float32)
        r = np.stack([np.asarray(jlie.quat_to_matrix(jnp.asarray(x))) for x in q])
        np.testing.assert_allclose(_np(tlie.quat_to_matrix(_t(q))), r, **F32_TOL)
        want_q = np.stack([np.asarray(jlie.matrix_to_quat(jnp.asarray(m))) for m in r])
        np.testing.assert_allclose(_np(tlie.matrix_to_quat(_t(r))), want_q, rtol=1e-5, atol=2e-6)
        want_mul = np.stack([np.asarray(jlie.quat_multiply(jnp.asarray(a), jnp.asarray(b))) for a, b in zip(q, q[::-1])])
        np.testing.assert_allclose(_np(tlie.quat_multiply(_t(q), _t(q[::-1].copy()))), want_mul, **F32_TOL)
        m = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(size=6).astype(np.float32))))
        np.testing.assert_allclose(_np(tlie.se3_inverse(_t(m))), np.asarray(jlie.se3_inverse(jnp.asarray(m))), **F32_TOL)
        v = rng.normal(size=3).astype(np.float32)
        np.testing.assert_array_equal(_np(tlie.vee(tlie.hat(_t(v)))), v)
        pts = rng.normal(size=(7, 3)).astype(np.float32)
        np.testing.assert_allclose(
            _np(tlie.transform_points(_t(m), _t(pts))),
            np.asarray(jlie.transform_points(jnp.asarray(m), jnp.asarray(pts))), **F32_TOL,
        )


# --------------------------------------------------------------- linalg


class TestLinalg:
    @pytest.mark.parametrize("batch", [(), (5,), (3, 4)])
    def test_spd_solve_and_inverse(self, batch):
        rng = np.random.default_rng(3)
        a = rng.normal(size=batch + (6, 6)).astype(np.float32)
        spd = a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(6, dtype=np.float32)
        b = rng.normal(size=batch + (6,)).astype(np.float32)
        # Same unrolled factor, same op order: agreement to a few ulps of
        # the solution (condition numbers here are ~1e2).
        np.testing.assert_allclose(
            _np(tlinalg.spd_solve(_t(spd), _t(b))),
            np.asarray(jlinalg.spd_solve(jnp.asarray(spd), jnp.asarray(b))), rtol=1e-4, atol=1e-5,
        )
        np.testing.assert_allclose(
            _np(tlinalg.spd_inverse(_t(spd))),
            np.asarray(jlinalg.spd_inverse(jnp.asarray(spd))), rtol=1e-4, atol=1e-5,
        )


# ---------------------------------------------------------------- calib


def _calib_inputs(rng, c=3, n=40):
    k = np.stack([[400 + 30 * i, 410 + 20 * i, 80 + i, 60 - i] for i in range(c)]).astype(np.float32)
    dist = (rng.normal(size=(c, 5)) * [0.05, 0.01, 0.001, 0.001, 0.002]).astype(np.float32)
    xy = rng.uniform(0, [160, 120], size=(c, n, 2)).astype(np.float32)
    rot = np.stack([np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.02))) for _ in range(c)])
    k_rect = np.stack([[405.0, 80.0, 60.0]] * c).astype(np.float32)
    pts = np.concatenate(
        [rng.uniform(-1, 1, size=(c, n, 2)), rng.uniform(-0.5, 4, size=(c, n, 1))], -1
    ).astype(np.float32)
    return k, dist, xy, rot.astype(np.float32), k_rect, pts


class TestCalib:
    def test_raw_to_rect_and_normalized(self):
        k, dist, xy, rot, k_rect, _ = _calib_inputs(np.random.default_rng(4))
        want = np.asarray(jax.vmap(jcalib.raw_pixels_to_rect)(*map(jnp.asarray, (xy, k, dist, rot, k_rect))))
        got = _np(tcalib.raw_pixels_to_rect(*map(_t, (xy, k, dist, rot, k_rect))))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-4)  # pixels ~1e2: f32 ulps
        want_n = np.asarray(jax.vmap(jcalib.raw_pixels_to_normalized)(*map(jnp.asarray, (xy, k, dist))))
        np.testing.assert_allclose(_np(tcalib.raw_pixels_to_normalized(*map(_t, (xy, k, dist)))), want_n, **F32_TOL)

    def test_cam_points_to_raw_pixels(self):
        k, dist, _, _, _, pts = _calib_inputs(np.random.default_rng(5))
        uv_j, front_j = jax.vmap(jcalib.cam_points_to_raw_pixels)(*map(jnp.asarray, (pts, k, dist)))
        uv_t, front_t = tcalib.cam_points_to_raw_pixels(*map(_t, (pts, k, dist)))
        np.testing.assert_array_equal(_np(front_t), np.asarray(front_j))
        f = np.asarray(front_j)
        np.testing.assert_allclose(_np(uv_t)[f], np.asarray(uv_j)[f], rtol=1e-5, atol=1e-3)

    def test_distort_roundtrip_single_camera(self):
        rng = np.random.default_rng(6)
        pts = rng.uniform(-0.4, 0.4, size=(50, 2)).astype(np.float32)
        coeffs = np.array([0.03, -0.01, 0.001, -0.001, 0.002], np.float32)
        d_j = np.asarray(jcalib.distort_normalized(jnp.asarray(pts), jnp.asarray(coeffs)))
        np.testing.assert_allclose(_np(tcalib.distort_normalized(_t(pts), _t(coeffs))), d_j, **F32_TOL)
        u_j = np.asarray(jcalib.undistort_normalized(jnp.asarray(d_j), jnp.asarray(coeffs)))
        np.testing.assert_allclose(_np(tcalib.undistort_normalized(_t(d_j), _t(coeffs))), u_j, **F32_TOL)


# ---------------------------------------------------------------- image


class TestImage:
    @pytest.mark.parametrize("sigma,radius", [(1.0, 2), (2.0, 4)])
    def test_gaussian_blur(self, sigma, radius):
        imgs = np.random.default_rng(7).uniform(size=(2, 40, 56)).astype(np.float32)
        want = np.stack([np.asarray(jimage.gaussian_blur(jnp.asarray(im), sigma, radius)) for im in imgs])
        # Same taps, same order; XLA may fuse multiply-adds: f32 ulps.
        np.testing.assert_allclose(_np(timage.gaussian_blur(_t(imgs), sigma, radius)), want, atol=2e-6)

    def test_downsample2(self):
        imgs = np.random.default_rng(8).uniform(size=(2, 41, 58)).astype(np.float32)
        want = np.stack([np.asarray(jimage.downsample2(jnp.asarray(im))) for im in imgs])
        got = _np(timage.downsample2(_t(imgs)))
        assert got.shape == want.shape == (2, 20, 29)
        np.testing.assert_allclose(got, want, atol=2e-6)

    @pytest.mark.parametrize("size", [7, 19, 37])
    def test_extract_patches_matches_mxu(self, size):
        rng = np.random.default_rng(9)
        c, h, w, n = 3, 60, 90, 24
        imgs = rng.uniform(size=(c, h, w)).astype(np.float32)
        centers = rng.integers(-10, [w + 10, h + 10], size=(c, n, 2)).astype(np.int32)
        want = np.asarray(
            jax.vmap(lambda im, ct: jimage.extract_patches_mxu(im, ct, size))(jnp.asarray(imgs), jnp.asarray(centers))
        )
        # A copy: exact.
        np.testing.assert_array_equal(_np(timage.extract_patches(_t(imgs), _t(centers), size)), want)


# ----------------------------------------------- stereo / triangulation


class TestStereoGeometry:
    def test_refine_disparity_photometric(self):
        rng = np.random.default_rng(10)
        c, h, w, n = 2, 48, 80, 30
        base = rng.uniform(size=(c, h, w + 8)).astype(np.float32)
        left = np.ascontiguousarray(base[:, :, 4:-4])
        right = np.ascontiguousarray(base[:, :, 7:-1])  # true disparity 3 px
        xy = rng.uniform([10, 5], [w - 10, h - 5], size=(c, n, 2)).astype(np.float32)
        disp = (3.0 + rng.uniform(-0.6, 0.6, size=(c, n))).astype(np.float32)
        valid = rng.uniform(size=(c, n)) < 0.8
        want = np.asarray(
            jax.vmap(jstereo.refine_disparity_photometric)(*map(jnp.asarray, (left, right, xy, disp, valid)))
        )
        got = _np(tstereo.refine_disparity_photometric(*map(_t, (left, right, xy, disp, valid))))
        np.testing.assert_allclose(got, want, atol=1e-5)  # f32 SAD sums, 49 terms

    def test_match_disparities_and_triangulate(self):
        rng = np.random.default_rng(11)
        c, n, m = 2, 20, 25
        xl = rng.uniform(0, 100, size=(c, n, 2)).astype(np.float32)
        xr = rng.uniform(0, 100, size=(c, m, 2)).astype(np.float32)
        idx = rng.integers(0, m, size=(c, n)).astype(np.int32)
        mv = rng.uniform(size=(c, n)) < 0.7
        d_j, v_j = jax.vmap(lambda a, b, i, v: jtri.match_disparities(a, b, i, v, max_dy=40.0))(
            *map(jnp.asarray, (xl, xr, idx, mv))
        )
        d_t, v_t = ttri.match_disparities(_t(xl), _t(xr), _t(idx).long(), _t(mv), max_dy=40.0)
        np.testing.assert_array_equal(_np(v_t), np.asarray(v_j))
        np.testing.assert_allclose(_np(d_t), np.asarray(d_j), **F32_TOL)

        k_rect = np.array([[400.0, 80.0, 60.0], [380.0, 82.0, 58.0]], np.float32)
        base = np.array([0.075, 0.12], np.float32)
        disp = rng.uniform(-1, 30, size=(c, n)).astype(np.float32)
        p_j, ok_j = jax.vmap(lambda a, d, k, b: jtri.stereo_triangulate(a, d, k[0], k[1], k[2], b))(
            *map(jnp.asarray, (xl, disp, k_rect, base))
        )
        p_t, ok_t = ttri.stereo_triangulate(_t(xl), _t(disp), _t(k_rect), _t(base))
        np.testing.assert_array_equal(_np(ok_t), np.asarray(ok_j))
        ok = np.asarray(ok_j)
        np.testing.assert_allclose(_np(p_t)[ok], np.asarray(p_j)[ok], **F32_TOL)


# ------------------------------------------------------ BRIEF / match


class TestDescriptors:
    def test_pattern_tables_identical(self):
        np.testing.assert_array_equal(tbrief.TEST_PAIRS, jbrief.TEST_PAIRS)
        np.testing.assert_array_equal(tbrief.UPRIGHT_SAMPLING, jbrief.UPRIGHT_SAMPLING)

    def test_upright_brief_words(self):
        rng = np.random.default_rng(12)
        c, h, w, n = 2, 80, 120, 64
        imgs = np.stack(
            [np.asarray(jimage.gaussian_blur(jnp.asarray(im), 2.0, 4)) for im in rng.uniform(size=(c, h, w)).astype(np.float32)]
        )
        xy = rng.uniform(-5, [w + 5, h + 5], size=(c, n, 2)).astype(np.float32)
        valid = rng.uniform(size=(c, n)) < 0.9
        want = jbrief.compute_descriptors_batched(jnp.asarray(imgs), jnp.asarray(xy), jnp.asarray(valid), oriented=False)
        got = tbrief.compute_descriptors_batched(_t(imgs), _t(xy), _t(valid))
        want_bits = np.unpackbits(np.asarray(want.bits).view(np.uint8))
        got_bits = np.unpackbits(_np(got.bits).view(np.uint32).view(np.uint8))
        # f32 sums of the 4-tap samples can flip a comparison at a near-tie.
        assert np.mean(want_bits != got_bits) <= 1e-3
        np.testing.assert_array_equal(_np(got.valid), valid)

    def test_match_descriptors_same_words(self):
        rng = np.random.default_rng(13)
        c, n, m = 2, 48, 40
        a = rng.integers(0, 2**32, size=(c, n, 8), dtype=np.uint32)
        b = a[:, rng.permutation(n)[:m]].copy()
        flip = rng.integers(0, 2**32, size=b.shape, dtype=np.uint32) & rng.integers(0, 2**32, size=b.shape, dtype=np.uint32) & rng.integers(0, 2**32, size=b.shape, dtype=np.uint32)
        b ^= flip  # ~1/8 of bits flipped: near-duplicates
        va = rng.uniform(size=(c, n)) < 0.9
        vb = rng.uniform(size=(c, m)) < 0.9
        allowed = rng.uniform(size=(c, n, m)) < 0.8
        for gate in (None, allowed):
            want = jax.vmap(
                lambda da, xa, db, xb, g: jmatch.match_descriptors(da, xa, db, xb, max_distance=80.0, ratio=0.95, allowed=g)
            )(*map(jnp.asarray, (a, va, b, vb, allowed if gate is not None else np.ones((c, n, m), bool))))
            got = tmatch.match_descriptors(
                _t(a.view(np.int32)), _t(va), _t(b.view(np.int32)), _t(vb), max_distance=80.0, ratio=0.95,
                allowed=None if gate is None else _t(gate),
            )
            np.testing.assert_array_equal(_np(got.valid), np.asarray(want.valid))
            np.testing.assert_array_equal(_np(got.idx), np.asarray(want.idx))
            np.testing.assert_array_equal(_np(got.distance), np.asarray(want.distance))

    def test_popcount_exact(self):
        rng = np.random.default_rng(14)
        v = rng.integers(0, 2**32, size=1000, dtype=np.uint32)
        want = np.array([bin(int(x)).count("1") for x in v])
        np.testing.assert_array_equal(_np(tmatch.popcount32(_t(v.view(np.int32)).long())), want)


# ------------------------------------------------------ setup / convert


def _calibration(num=2, w=160, h=120):
    spec = SyntheticRigSpec(num_sources=num, stereo=True, width=w, height=h, baseline_m=0.12)
    sources, rig_ext, _, _ = make_synthetic_rig(spec, render=False)
    return RigCalibration(
        intrinsics={s.name: s.get_intrinsics() for s in sources},
        extrinsics={s.name: s.get_extrinsics() for s in sources},
        rig_extrinsics=rig_ext,
        imu_extrinsics=IMUExtrinsics(source_name=sources[0].name, extrinsics=Extrinsics.identity()),
        source_names=[s.name for s in sources],
    )


class TestSetup:
    def test_build_camera_setup_matches(self):
        cal = _calibration()
        s_j, order_j, h_j, w_j = jsetup.build_camera_setup(cal)
        s_t, order_t, h_t, w_t = tsetup.build_camera_setup(cal)
        assert (order_t, h_t, w_t) == (order_j, h_j, w_j)
        for f in s_j._fields:
            a, b = np.asarray(getattr(s_j, f)), np.asarray(getattr(s_t, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)

    def test_state_roundtrip_bitcasts_descriptors(self):
        from thor_slam_tpu.engine import tracker as jtrk

        params = jtrk.TrackerParams(num_cams=2, height=24, width=32, max_keypoints=8)
        st = jtrk.init_state(params)
        desc = np.random.default_rng(15).integers(0, 2**32, size=(2, 8, 8), dtype=np.uint32)
        st = st._replace(lm_desc=jnp.asarray(desc))
        port = convert.state_to_torch({f: np.asarray(v) for f, v in st._asdict().items()}, "cpu")
        assert port.lm_desc.dtype == torch.int32
        back = convert.state_to_numpy(port)
        np.testing.assert_array_equal(back["lm_desc"], desc)
        for f in back:
            a = np.asarray(getattr(st, f))
            assert back[f].dtype == a.dtype, f
            np.testing.assert_array_equal(back[f], a, err_msg=f)
        assert "key" not in back
