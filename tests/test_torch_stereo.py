"""Parity of the port's dense stereo path with the JAX reference, on the CPU.

Rectification maps, bilinear remap/resize, census, cost volume, the SGM
path scan, the 4-direction sum, winner/LR and the whole ``sgm_disparity``.
Inputs come from ``np.random.default_rng``. The SGM pieces are held against
the interpret-mode Pallas kernels of ``thor_slam_tpu.ops.sgm_pallas`` (the
exact recurrence), never against the reference's CPU ``sgm_disparity`` as
called: that runs the approximate blocked-halo scan (see
:func:`test_halo_fallback_is_not_what_the_port_matches`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sgm_pallas import exact_reference

from thor_slam_tpu.camera.types import Extrinsics, Intrinsics
from thor_slam_tpu.ops import image as jimage
from thor_slam_tpu.ops import rectify as jrectify
from thor_slam_tpu.ops import sgm_pallas
from thor_slam_tpu.ops import stereo as jstereo
from thor_slam_tpu_torch.ops import image as timage
from thor_slam_tpu_torch.ops import rectify as trectify
from thor_slam_tpu_torch.ops import sgm_cuda
from thor_slam_tpu_torch.ops import stereo as tstereo

torch.set_num_threads(2)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _stereo_pair(h: int, w: int, shift: int, seed: int):
    """A smooth random-texture pair with disparity ``shift`` (float32 in [0, 1])."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (h // 2 + 1, (w + shift) // 2 + 1)).astype(np.float32)
    base = np.kron(base, np.ones((2, 2), np.float32))[:h, : w + shift]
    base = 0.5 * base + 0.25 * np.roll(base, 1, 0) + 0.25 * np.roll(base, 1, 1)
    return base[:, :w].copy(), base[:, shift : shift + w].copy()


@pytest.fixture
def exact_jax_sgm(monkeypatch):
    """Make the reference's ``sgm_disparity`` trace its exact path on the CPU:
    the Pallas scan and winner kernels in interpret mode. Undone (and the
    JAX caches cleared) after the test; nothing in the package changes."""
    monkeypatch.setattr(jstereo, "pallas_backend", lambda: True)
    monkeypatch.setattr(
        sgm_pallas, "sgm_aggregate_4dir", functools.partial(sgm_pallas.sgm_aggregate_4dir, interpret=True)
    )
    monkeypatch.setattr(sgm_pallas, "winner_lr", functools.partial(sgm_pallas.winner_lr, interpret=True))
    jax.clear_caches()
    yield
    jax.clear_caches()


# ------------------------------------------------------------- rectify


def _distorted_pair():
    k = np.array([[400.0, 0.0, 161.0], [0.0, 402.0, 118.0], [0.0, 0.0, 1.0]])
    left = Intrinsics(width=320, height=240, matrix=k, coeffs=np.array([-0.12, 0.03, 1e-3, -5e-4, 0.0]))
    right = Intrinsics(width=320, height=240, matrix=k * [[1.01], [1.0], [1.0]], coeffs=np.array([-0.1, 0.02]))
    rot = Extrinsics.from_4x4_matrix(np.eye(4))
    t = np.eye(4)
    t[:3, 3] = [0.075, 0.002, -0.001]
    c, s = np.cos(0.02), np.sin(0.02)
    t[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    return left, right, rot, Extrinsics.from_4x4_matrix(t)


def test_rect_maps_equal_reference():
    """Geometry and both sampling maps equal the reference's exactly."""
    left, right, ext_l, ext_r = _distorted_pair()
    want = jrectify.rectification_from_extrinsics(left, right, ext_l, ext_r)
    got = trectify.rectification_from_extrinsics(left, right, ext_l, ext_r, compute_maps=True)
    for name in ("rect_rotation_left", "rect_rotation_right", "new_matrix"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.baseline_m == want.baseline_m
    for g, w in zip((*got.map_left, *got.map_right), (*want.map_left, *want.map_right)):
        assert g.dtype == np.float32 and g.shape == (240, 320)
        np.testing.assert_array_equal(g, w)
    bare = trectify.rectification_from_extrinsics(left, right, ext_l, ext_r)
    assert bare.map_left[0].size == 0 and bare.baseline_m == want.baseline_m


def test_rect_map_behind_camera_sentinel():
    """A rectifying rotation past 90 degrees puts rays behind the camera:
    those pixels carry -1e6 in both packages."""
    left, _, _, _ = _distorted_pair()
    c, s = np.cos(np.deg2rad(100.0)), np.sin(np.deg2rad(100.0))
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    k_new = np.array([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1.0]])
    got = trectify.init_undistort_rectify_map(left, rot, k_new, 320, 240)
    want = jrectify.init_undistort_rectify_map(left, rot, k_new, 320, 240)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0] == -1e6).any() and (got[0] != -1e6).any()


# ----------------------------------------------------------- image ops


def _maps_with_edges(h, w, ho, wo, seed):
    rng = np.random.default_rng(seed)
    mx = rng.uniform(-3.0, w + 2.0, (ho, wo)).astype(np.float32)
    my = rng.uniform(-3.0, h + 2.0, (ho, wo)).astype(np.float32)
    # Exactly on the last column / row, on 0, on integers, just past the edge.
    mx[0, :] = w - 1
    my[1, :] = h - 1
    mx[2, :] = 0.0
    my[3, :] = np.arange(wo) % h
    mx[4, :] = np.nextafter(np.float32(w - 1), np.float32(w))
    my[5, :] = -1e6
    return mx, my


def test_remap_bilinear_matches_reference():
    """Per-sample agreement within 1e-6 abs (same f32 ops in the same order)."""
    rng = np.random.default_rng(10)
    imgs = rng.uniform(0, 1, (3, 30, 41)).astype(np.float32)
    mx, my = _maps_with_edges(30, 41, 24, 37, 11)
    got = _np(timage.remap_bilinear(torch.from_numpy(imgs), torch.from_numpy(mx), torch.from_numpy(my)))
    assert got.shape == (3, 24, 37)
    for c in range(3):
        want = np.asarray(jimage.remap_bilinear(jnp.asarray(imgs[c]), jnp.asarray(mx), jnp.asarray(my)))
        np.testing.assert_allclose(got[c], want, rtol=0, atol=1e-6)
    assert (got[:, 5] == 0).all()  # outside: the whole sample is zero


@pytest.mark.parametrize("out_hw", [(64, 96), (17, 23), (30, 41)])
def test_resize_bilinear_matches_reference(out_hw):
    """Within 1e-6 abs, downsizing, upsizing and at the same size."""
    rng = np.random.default_rng(12)
    imgs = rng.uniform(0, 255, (2, 30, 41)).astype(np.float32) / 255.0
    got = _np(timage.resize_bilinear(torch.from_numpy(imgs), *out_hw))
    for c in range(2):
        want = np.asarray(jimage.resize_bilinear(jnp.asarray(imgs[c]), *out_hw))
        np.testing.assert_allclose(got[c], want, rtol=0, atol=1e-6)


# ------------------------------------------------------ census / costs


def test_census_transform_exact():
    left, right = _stereo_pair(40, 72, 5, 13)
    got = _np(tstereo.census_transform(torch.from_numpy(np.stack([left, right]))))
    for img, g in zip((left, right), got):
        want = np.asarray(jstereo.census_transform(jnp.asarray(img)))
        np.testing.assert_array_equal(g, want.astype(np.int64))
    assert got.max() < 2**24


@pytest.mark.parametrize("num_disparities", [16, 48])
def test_census_cost_volume_exact(num_disparities):
    left, right = _stereo_pair(24, 64, 7, 14)
    cl, cr = (jstereo.census_transform(jnp.asarray(x)) for x in (left, right))
    want = np.asarray(jstereo.census_cost_volume(cl, cr, num_disparities))
    got = tstereo.census_cost_volume(
        torch.from_numpy(np.asarray(cl).astype(np.int64)), torch.from_numpy(np.asarray(cr).astype(np.int64)),
        num_disparities,
    )
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(_np(got), want)


# --------------------------------------------------------------- scan


@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("geometry", [(64, 32, 256, 16), (32, 16, 200, 8)])
def test_scan_matches_pallas_exactly(geometry, reverse, with_add):
    """Plain scan == interpret-mode ``_scan_kernel`` / ``_scan_add_kernel``,
    bit for bit after casting both to float32 (integral costs <= 24, P1 6,
    P2 96: every value is an integer the bfloat16 carry holds exactly)."""
    s, d, x, block = geometry
    rng = np.random.default_rng(20 + s)
    cost = rng.integers(0, 25, (s, d, x)).astype(np.float32)
    add = rng.integers(0, 129, (s, d, x)).astype(np.float32) if with_add else None
    want = sgm_pallas.sgm_aggregate_dir(
        jnp.asarray(cost, jnp.bfloat16), 6.0, 96.0, reverse, step_block=block, interpret=True,
        add_to=None if add is None else jnp.asarray(add, jnp.bfloat16),
    )
    got = sgm_cuda.sgm_aggregate_dir(
        torch.from_numpy(cost), 6.0, 96.0, reverse, None if add is None else torch.from_numpy(add)
    )
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def test_scan_takes_permuted_views():
    """A permuted view of a contiguous volume (the 4-direction layout)
    scans like its contiguous copy, and the output keeps its strides."""
    rng = np.random.default_rng(21)
    vol = torch.from_numpy(rng.integers(0, 25, (12, 20, 16)).astype(np.float32))  # (H, W, D)
    view = vol.permute(1, 2, 0)  # (W, D, H)
    got = sgm_cuda.sgm_aggregate_dir(view, 6.0, 96.0, True)
    assert got.stride() == view.stride()
    want = sgm_cuda.sgm_aggregate_dir(view.contiguous(), 6.0, 96.0, True)
    assert torch.equal(got, want)


def test_4dir_matches_pallas_exactly():
    rng = np.random.default_rng(2)
    d, h, w = 16, 40, 64
    cost = rng.integers(0, 25, (d, h, w)).astype(np.float32)
    want = sgm_pallas.sgm_aggregate_4dir(jnp.asarray(cost, jnp.bfloat16), 6.0, 96.0, interpret=True)
    got = sgm_cuda.sgm_aggregate_4dir(torch.from_numpy(cost), 6.0, 96.0)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_2dir_is_the_horizontal_pair():
    rng = np.random.default_rng(22)
    cost = rng.integers(0, 25, (16, 8, 24)).astype(np.float32)
    want = exact_reference(cost.transpose(2, 0, 1), 6.0, 96.0, False) + exact_reference(
        cost.transpose(2, 0, 1), 6.0, 96.0, True
    )
    got = sgm_cuda.sgm_aggregate_4dir(torch.from_numpy(cost), 6.0, 96.0, num_paths=2)
    np.testing.assert_array_equal(_np(got), want.transpose(1, 2, 0))


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_non_integral_penalties_follow_the_recurrence(reverse):
    """With non-integral costs and penalties the port still runs the exact
    recurrence in float32 (the reference would take its approximate halo
    scan). The textbook adds ``(c + best) - minL`` where the kernel adds
    ``c + (best - minL)``: values <= ~130 differ by float32 rounding only,
    so 1e-4 abs."""
    rng = np.random.default_rng(23)
    cost = rng.uniform(0, 24, (48, 20, 33)).astype(np.float32)
    got = sgm_cuda.sgm_aggregate_dir(torch.from_numpy(cost), 6.5, 97.25, reverse)
    np.testing.assert_allclose(_np(got), exact_reference(cost, 6.5, 97.25, reverse), rtol=0, atol=1e-4)


# ---------------------------------------------------------- winner / LR


@pytest.mark.parametrize("shape", [(16, 32, 256), (16, 16, 200)])
def test_winner_lr_matches_pallas_exactly(shape):
    """Tie-heavy integer volume: argmin first on ties, clipped neighbours,
    second-best outside +-1, right-view winners with x - d < 0 -> 0."""
    rng = np.random.default_rng(3)
    d, h, w = shape
    agg = rng.integers(0, 400, (d, h, w)).astype(np.float32)
    want = sgm_pallas.winner_lr(jnp.asarray(agg), d, interpret=True)
    got = sgm_cuda.winner_lr(torch.from_numpy(agg), d)
    for name, g, wnt in zip(("d_best", "c0", "cm", "cp", "second", "d_r_at"), got, want):
        assert tuple(g.shape) == (h, w), name
        np.testing.assert_array_equal(_np(g), np.asarray(wnt), err_msg=name)
    assert got[0].dtype == torch.int32 and got[5].dtype == torch.int32


# ------------------------------------------------------ whole SGM


@pytest.mark.parametrize("hw,num_disparities,shift", [((32, 128), 16, 5), ((48, 96), 32, 11)])
def test_sgm_disparity_matches_exact_jax_path(exact_jax_sgm, hw, num_disparities, shift):
    """The port's ``sgm_disparity`` == the reference's exact path (Pallas
    scan + winner in interpret mode): identical ``valid``, disparity
    within 1e-6."""
    assert sgm_pallas.supported_for(num_disparities, *hw)
    left, right = _stereo_pair(*hw, shift, 30 + shift)
    args = dict(num_disparities=num_disparities, p1=6.0, p2=96.0, num_paths=4, lr_threshold=1.25, uniqueness=0.95)
    want_d, want_v = jstereo.sgm_disparity.__wrapped__(jnp.asarray(left), jnp.asarray(right), **args)
    got_d, got_v = tstereo.sgm_disparity(torch.from_numpy(left), torch.from_numpy(right), **args)
    np.testing.assert_array_equal(_np(got_v), np.asarray(want_v))
    np.testing.assert_allclose(_np(got_d), np.asarray(want_d), rtol=0, atol=1e-6)
    assert _np(got_v).mean() > 0.5
    assert np.median(np.abs(_np(got_d)[_np(got_v)] - shift)) < 0.5


def test_halo_fallback_is_not_what_the_port_matches():
    """The reference's CPU ``sgm_disparity`` as called runs the blocked-halo
    scan, which approximates the recurrence: on this pair its disparity
    differs from the exact path's on 13 % of pixels, by up to 1.6 px (when
    this test was written). The port matches the exact path (test above),
    so it must not be compared with this one."""
    left, right = _stereo_pair(32, 128, 5, 35)
    halo_d, _ = jstereo.sgm_disparity(jnp.asarray(left), jnp.asarray(right), num_disparities=16)
    got_d, _ = tstereo.sgm_disparity(torch.from_numpy(left), torch.from_numpy(right), num_disparities=16)
    differs = np.abs(np.asarray(halo_d) - _np(got_d)) > 1e-3
    assert differs.mean() > 0.01


def test_depth_and_u16_encode_match_reference():
    """Depth within 1 f32 ulp-level tolerance; the millimetre encode rounds
    half to even and clamps, as the reference (exact on shared depth)."""
    rng = np.random.default_rng(40)
    disp = rng.uniform(0, 64, (20, 30)).astype(np.float32)
    disp[0, :4] = [0.0, 1e-7, 0.5, 64.0]
    valid = rng.uniform(size=(20, 30)) > 0.2
    want = np.asarray(jstereo.disparity_to_depth(jnp.asarray(disp), jnp.asarray(valid), 512.3, 0.075))
    got = _np(tstereo.disparity_to_depth(torch.from_numpy(disp), torch.from_numpy(valid), 512.3, 0.075))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    depth = np.concatenate([want.reshape(-1), [0.0005, 0.0015, 0.0025, -1.0, 70.0]]).astype(np.float32)
    mm = tstereo.depth_to_millimeters_u16(torch.from_numpy(depth))
    assert mm.dtype == torch.uint16
    np.testing.assert_array_equal(_np(mm), np.asarray(jstereo.depth_to_millimeters_u16(jnp.asarray(depth))))
