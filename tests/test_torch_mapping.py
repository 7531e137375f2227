"""Parity of the port's dense-mapping modules with ``thor_slam_tpu.mapping``, on the CPU.

The same seeded inputs go through the JAX functions and the port's
(``device="cpu"``): TSDF integration (with and without colour, over three
frames of a plane, a sphere and random depth at seeded rotated poses), the
bulk integrator, in-place updates, decay, recentering, the ``.npz`` files
of both packages, the exact ESDF and the 2D costmap slice, the surface
cloud and the Surface-Nets mesh. Grids are (32, 32, 32) and a ragged
(40, 24, 32) at 0.05 m, depth images 48x64.

Tolerances. Integration: the weights are equal on >= 99.99 % of voxels, and
where they are, tsdf agrees to 1e-5 m and colour to 1e-3. A voxel may
differ only where its projection rounds to another pixel: XLA's CPU code
may contract a multiply-add of the voxel-centre chain into an FMA (as it
does the bilinear blend, tests/test_torch_rgbd.py); the tests count and
print such voxels. With
axis-aligned poses every product of that chain is exact, and the grids
agree bit for bit. ESDF within 1e-6 m; surface points in the same order
within 1e-6 m; mesh vertices within 1e-5 m, colours within 1 (a mean of 8
f32 values truncated to uint8), triangles index for index; PLY bytes equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from thor_slam_tpu.mapping import esdf as jesdf
from thor_slam_tpu.mapping import mesh as jmesh
from thor_slam_tpu.mapping import tsdf as jtsdf
from thor_slam_tpu_torch.engine.convert import grid_to_numpy, grid_to_torch
from thor_slam_tpu_torch.mapping import esdf as tesdf
from thor_slam_tpu_torch.mapping import mesh as tmesh
from thor_slam_tpu_torch.mapping import tsdf as ttsdf

torch.set_num_threads(2)

VS = 0.05
DIMS = [(32, 32, 32), (40, 24, 32)]
H, W = 48, 64
INTR = np.array([50.0, 50.0, 32.0, 24.0], np.float32)
MIN_EQUAL_WEIGHT_SHARE = 0.9999
TSDF_ATOL = 1e-5
COLOR_ATOL = 1e-3
ORIGIN = np.array([-0.8, -0.6, 0.3], np.float32)


def _specs(dims, color=True):
    kw = dict(dims=dims, voxel_size_m=VS, integrate_color=color)
    return jtsdf.GridSpec(**kw), ttsdf.GridSpec(**kw)


def _rotation(rng, scale):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    angle = rng.normal() * scale
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def _rays():
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    return np.stack([(u - INTR[2]) / INTR[0], (v - INTR[3]) / INTR[1], np.ones_like(u)], -1)


def _to_mm(z):
    z = np.where(np.isfinite(z) & (z > 0), z, 0.0)
    return np.round(z * 1000.0).astype(np.uint16)


def _depth(scene, world_t_cam, rng):
    """(H, W) uint16 mm projective depth of ``scene`` seen from ``world_t_cam``."""
    r, c = world_t_cam[:3, :3], world_t_cam[:3, 3]
    d = _rays() @ r.T  # world-frame rays with unit camera z
    if scene == "plane":  # a wall tilted about x, z = 1.1 + 0.3 y
        n = np.array([0.0, -0.3, 1.0])
        with np.errstate(divide="ignore", invalid="ignore"):
            return _to_mm((1.1 - n @ c) / (d @ n))
    if scene == "sphere":  # radius 0.45 around (0.05, 0.1, 1.0)
        oc = c - np.array([0.05, 0.1, 1.0])
        a = np.einsum("hwi,hwi->hw", d, d)
        b = 2 * d @ oc
        disc = b * b - 4 * a * (oc @ oc - 0.45**2)
        with np.errstate(invalid="ignore"):
            return _to_mm(np.where(disc > 0, (-b - np.sqrt(disc)) / (2 * a), 0.0))
    return _to_mm(rng.uniform(0.3, 2.2, (H, W)))


def _frames(scene, seed, n=3, rot_scale=0.25):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        world_t_cam = np.eye(4)
        world_t_cam[:3, :3] = _rotation(rng, rot_scale)
        world_t_cam[:3, 3] = rng.normal(size=3) * 0.08
        depth = _depth(scene, world_t_cam, rng)
        color = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        out.append((depth, color, np.linalg.inv(world_t_cam).astype(np.float32)))
    return out


def _ref_arrays(grid) -> dict:
    return {k: np.asarray(v) for k, v in grid._asdict().items()}


def _integrate_both(dims, color, frames, origin=ORIGIN):
    jspec, tspec = _specs(dims, color)
    jgrid = jtsdf.make_grid(jspec, origin)
    tgrid = ttsdf.make_grid(tspec, origin, device="cpu")
    jint, tint = jtsdf.make_integrator(jspec), ttsdf.make_integrator(tspec)
    for depth, col, cam_t_world in frames:
        jcol = col if color else np.zeros((0,), np.uint8)
        jgrid = jint(jgrid, depth, jcol, cam_t_world, INTR)
        tgrid = tint(tgrid, depth, jcol, cam_t_world, INTR)
    return _ref_arrays(jgrid), grid_to_numpy(tgrid)


def _assert_grids_agree(want, got, label=""):
    equal = got["weight"] == want["weight"]
    print(f"{label}: {int((~equal).sum())} of {equal.size} voxels with another weight")
    assert equal.mean() >= MIN_EQUAL_WEIGHT_SHARE
    np.testing.assert_allclose(got["tsdf"][equal], want["tsdf"][equal], rtol=0, atol=TSDF_ATOL)
    if want["color"].size:
        np.testing.assert_allclose(got["color"][equal], want["color"][equal], rtol=0, atol=COLOR_ATOL)
    np.testing.assert_array_equal(got["origin"], want["origin"])


# ------------------------------------------------------------- integrate


@pytest.mark.parametrize("color", [True, False], ids=["color", "no_color"])
@pytest.mark.parametrize("scene", ["plane", "sphere", "random"])
@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_integrate_matches_reference(dims, scene, color):
    want, got = _integrate_both(dims, color, _frames(scene, seed=len(scene) + dims[0]))
    assert (want["weight"] > 0).mean() > 0.02  # the frames see the grid
    _assert_grids_agree(want, got, f"{dims} {scene} color={color}")


@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_axis_aligned_integrate_is_bit_exact(dims):
    """Identity rotations and a grid corner at the world origin: every
    product of the voxel-centre chain is exact, so no contraction can move
    a voxel to another pixel and the grids agree bit for bit."""
    rng = np.random.default_rng(3)
    frames = []
    for scene, t in (("sphere", [0.8, 0.6, -0.3]), ("random", [0.75, 0.55, -0.4]), ("plane", [0.85, 0.6, -0.25])):
        world_t_cam = np.eye(4)
        world_t_cam[:3, 3] = t
        frames.append((_depth(scene, world_t_cam, rng), rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                       np.linalg.inv(world_t_cam).astype(np.float32)))
    want, got = _integrate_both(dims, True, frames, origin=np.zeros(3, np.float32))
    assert (want["weight"] > 0).mean() > 0.05
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("color", [True, False], ids=["color", "no_color"])
def test_scan_integrator_equals_sequential_calls(color):
    _, spec = _specs((40, 24, 32), color)
    frames = _frames("sphere", seed=5)
    depths = np.stack([f[0] for f in frames])
    colors = np.stack([f[1] for f in frames]) if color else np.zeros((3, 0), np.uint8)
    poses = np.stack([f[2] for f in frames])
    seq = ttsdf.make_grid(spec, ORIGIN, device="cpu")
    integ = ttsdf.make_integrator(spec)
    for i in range(3):
        seq = integ(seq, depths[i], colors[i], poses[i], INTR)
    scan = ttsdf.make_scan_integrator(spec)(ttsdf.make_grid(spec, ORIGIN, device="cpu"), depths, colors, poses, INTR)
    for k, v in grid_to_numpy(seq).items():
        np.testing.assert_array_equal(grid_to_numpy(scan)[k], v, err_msg=k)


@pytest.mark.parametrize("maker", ["integrator", "scan"])
def test_donate_writes_in_place(maker):
    """``donate=True`` updates the grid's own storage and gives the values
    of ``donate=False``, which leaves its input untouched."""
    _, spec = _specs((32, 32, 32))
    depth, col, pose = _frames("plane", seed=9, n=1)[0]
    if maker == "scan":
        args = (depth[None], col[None], pose[None], INTR)
        make = ttsdf.make_scan_integrator
    else:
        args = (depth, col, pose, INTR)
        make = ttsdf.make_integrator
    kept = ttsdf.make_grid(spec, ORIGIN, device="cpu")
    before = grid_to_numpy(kept)
    new = make(spec, donate=False)(kept, *args)
    for k, v in before.items():
        np.testing.assert_array_equal(grid_to_numpy(kept)[k], v)
    donated = ttsdf.make_grid(spec, ORIGIN, device="cpu")
    ptrs = [t.data_ptr() for t in donated]
    out = make(spec, donate=True)(donated, *args)
    assert [t.data_ptr() for t in out] == ptrs
    for k, v in grid_to_numpy(new).items():
        np.testing.assert_array_equal(grid_to_numpy(out)[k], v, err_msg=k)


def test_device_frame_tensors_integrate_like_host_arrays():
    _, spec = _specs((32, 32, 32))
    frames = _frames("sphere", seed=2, n=2)
    host = ttsdf.make_grid(spec, ORIGIN, device="cpu")
    dev = ttsdf.make_grid(spec, ORIGIN, device="cpu")
    integ = ttsdf.make_integrator(spec, donate=True)
    for depth, col, pose in frames:
        integ(host, depth, col, pose, INTR)
        integ(dev, torch.from_numpy(depth), torch.from_numpy(col), pose, INTR)
    for k, v in grid_to_numpy(host).items():
        np.testing.assert_array_equal(grid_to_numpy(dev)[k], v)


# ------------------------------------------------------- grid maintenance


def _integrated(dims=(40, 24, 32), color=True, seed=4):
    """One grid integrated by the reference, as numpy arrays."""
    want, _ = _integrate_both(dims, color, _frames("sphere", seed=seed))
    return want


@pytest.mark.parametrize("color", [True, False], ids=["color", "no_color"])
def test_make_grid_and_centered_origin_match_reference(color):
    jspec, tspec = _specs((40, 24, 32), color)
    for center in ([0.3, -1.27, 0.5], [2.0, 2.0, -3.1]):
        want = jtsdf.centered_origin(jspec, np.asarray(center))
        got = ttsdf.centered_origin(tspec, np.asarray(center))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        jg, tg = _ref_arrays(jtsdf.make_grid(jspec, want)), grid_to_numpy(ttsdf.make_grid(tspec, got, device="cpu"))
        for k in jg:
            np.testing.assert_array_equal(tg[k], jg[k])
            assert tg[k].dtype == jg[k].dtype and tg[k].shape == jg[k].shape


@pytest.mark.parametrize("color", [True, False], ids=["color", "no_color"])
def test_decay_matches_reference_exactly(color):
    jspec, tspec = _specs((40, 24, 32), color)
    arrays = _integrated(color=color)
    jgrid = jtsdf.TsdfGrid(**arrays)
    tgrid = grid_to_torch(arrays, "cpu")
    for factor in (0.95, np.float32(0.3), 0.004):
        jgrid = jtsdf.make_decay(jspec)(jgrid, np.float32(factor))
        tgrid = ttsdf.make_decay(tspec, donate=True)(tgrid, factor)
        for k, v in _ref_arrays(jgrid).items():
            np.testing.assert_array_equal(grid_to_numpy(tgrid)[k], v, err_msg=f"{k} at {factor}")


RECENTER_SHIFTS = [(3, 0, 0), (-5, 0, 0), (0, 7, 0), (0, -2, 0), (0, 0, 4), (0, 0, -9), (6, -3, 2), (45, 0, -1)]


@pytest.mark.parametrize("with_origin", [False, True], ids=["shift_origin", "given_origin"])
@pytest.mark.parametrize("shift", RECENTER_SHIFTS, ids=str)
def test_recenter_matches_reference_exactly(shift, with_origin):
    jspec, tspec = _specs((40, 24, 32))
    arrays = _integrated()
    new_origin = (arrays["origin"] + np.asarray(shift, np.float32) * np.float32(VS) + np.float32(1e-4)
                  if with_origin else None)
    want = jtsdf.make_recenter(jspec)(jtsdf.TsdfGrid(**arrays), np.asarray(shift, np.int32), new_origin)
    for donate in (False, True):
        got = ttsdf.make_recenter(tspec, donate=donate)(grid_to_torch(arrays, "cpu"), shift, new_origin)
        for k, v in _ref_arrays(want).items():
            np.testing.assert_array_equal(grid_to_numpy(got)[k], v, err_msg=f"{k}, donate={donate}")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_grid_files_load_across_packages(tmp_path, writer):
    """A file written by either package's ``save_grid`` loads in the other's
    ``load_grid``: the same keys, dtypes, arrays and spec."""
    jspec, tspec = _specs((40, 24, 32))
    jspec = jtsdf.GridSpec(**{**jspec.__dict__, "max_weight": 37.0, "truncation_vox": 3.0})
    tspec = ttsdf.GridSpec(**{**tspec.__dict__, "max_weight": 37.0, "truncation_vox": 3.0})
    arrays = _integrated()
    ref_path, port_path = tmp_path / "ref.npz", tmp_path / "port.npz"
    jtsdf.save_grid(ref_path, jtsdf.TsdfGrid(**arrays), jspec)
    ttsdf.save_grid(port_path, grid_to_torch(arrays, "cpu"), tspec)
    ref_file, port_file = dict(np.load(ref_path)), dict(np.load(port_path))
    assert {k: (v.dtype, v.shape) for k, v in port_file.items()} == {k: (v.dtype, v.shape) for k, v in ref_file.items()}
    if writer == "reference":
        grid, spec = ttsdf.load_grid(ref_path, device="cpu")
        got, want_spec = grid_to_numpy(grid), tspec
    else:
        grid, spec = jtsdf.load_grid(port_path)
        got, want_spec = _ref_arrays(grid), jspec
    assert spec == want_spec
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].dtype == v.dtype


# ------------------------------------------------------------------ ESDF


def _analytic_grid(shape, dims, color=True, seed=0):
    """A TSDF of a sphere or a box sampled at the voxel centres, observed
    everywhere but a random 10 %, with random colours (numpy arrays)."""
    rng = np.random.default_rng(seed)
    trunc = 4 * VS
    origin = np.array([-1.0, -0.6, -0.8], np.float32)
    idx = np.stack(np.meshgrid(*[np.arange(n) for n in dims], indexing="ij"), -1)
    p = origin + (idx + 0.5) * VS
    if shape == "sphere":
        sd = np.linalg.norm(p - np.array([-0.02, 0.03, -0.01]), axis=-1) - 0.47
    else:
        q = np.abs(p - np.array([0.0, 0.01, 0.0])) - np.array([0.55, 0.35, 0.4])
        sd = np.linalg.norm(np.maximum(q, 0.0), axis=-1) + np.minimum(q.max(-1), 0.0)
    weight = (rng.random(dims) > 0.1).astype(np.float32) * rng.integers(1, 5, dims)
    return dict(
        tsdf=np.clip(sd, -trunc, trunc).astype(np.float32),
        weight=weight.astype(np.float32),
        color=(rng.random((*dims, 3)) * 255).astype(np.float32) if color else np.zeros((0,), np.float32),
        origin=origin,
    )


@pytest.mark.parametrize("chunk", [8, 16, 7])
def test_esdf_matches_reference(chunk):
    g = _analytic_grid("box", (40, 24, 32))
    want = np.asarray(jesdf.esdf_from_tsdf(g["tsdf"], g["weight"], VS, max_distance_m=0.6, chunk=chunk))
    t = grid_to_torch(g, "cpu")
    got = tesdf.esdf_from_tsdf(t.tsdf, t.weight, VS, max_distance_m=0.6, chunk=chunk).numpy()
    assert 0 < (want == 0).mean() < 1 and (want == np.float32(0.6)).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if chunk != 8:  # chunk changes the transient memory only
        np.testing.assert_array_equal(got, tesdf.esdf_from_tsdf(t.tsdf, t.weight, VS, max_distance_m=0.6).numpy())


@pytest.mark.parametrize("chunk", [8, 16, 7])
def test_esdf_slice_2d_matches_reference(chunk):
    g = _analytic_grid("sphere", (40, 24, 32), seed=1)
    want = jesdf.esdf_slice_2d(g["tsdf"], g["weight"], VS, z_lo_vox=12, z_hi_vox=21, max_distance_m=1.0, chunk=chunk)
    t = grid_to_torch(g, "cpu")
    got = tesdf.esdf_slice_2d(t.tsdf, t.weight, VS, z_lo_vox=12, z_hi_vox=21, max_distance_m=1.0, chunk=chunk)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    for g_, w_ in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    assert np.asarray(want[1]).any() and not np.asarray(want[1]).all()


# ----------------------------------------------------------- surface/mesh


@pytest.mark.parametrize("max_points", [131072, 100])
@pytest.mark.parametrize("color", [True, False], ids=["color", "no_color"])
def test_surface_points_match_reference(color, max_points):
    jspec, tspec = _specs((40, 24, 32), color)
    g = _analytic_grid("sphere", (40, 24, 32), color=color)
    wp, wc = jmesh.extract_surface_points(jtsdf.TsdfGrid(**g), jspec, max_points=max_points)
    gp, gc = tmesh.extract_surface_points(grid_to_torch(g, "cpu"), tspec, max_points=max_points)
    assert len(gp) == len(wp) == min(max_points, len(wp)) > 50
    assert max_points > 1000 or len(wp) == max_points  # the first max_points of more hits
    np.testing.assert_allclose(gp, wp, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gc, wc)
    assert gp.dtype == np.float32 and gc.dtype == np.uint8


MESH_CASES = [
    ("sphere", True, 65536, 65536),
    ("box", True, 65536, 65536),
    ("box", False, 65536, 65536),
    ("sphere", True, 300, 65536),  # vertex budget hit: the rest of the cells drop
    ("box", True, 65536, 300),  # quad budget per axis hit
]


@pytest.mark.parametrize("shape,color,max_vertices,max_quads", MESH_CASES)
def test_mesh_matches_reference(tmp_path, shape, color, max_vertices, max_quads):
    jspec, tspec = _specs((40, 24, 32), color)
    g = _analytic_grid(shape, (40, 24, 32), color=color, seed=2)
    want = jmesh.extract_mesh(jtsdf.TsdfGrid(**g), jspec, max_vertices=max_vertices, max_quads=max_quads)
    got = tmesh.extract_mesh(grid_to_torch(g, "cpu"), tspec, max_vertices=max_vertices, max_quads=max_quads)
    assert len(want.triangles) > 100
    assert got.vertex_budget_hit == want.vertex_budget_hit == (max_vertices < 65536)
    assert got.vertices.shape == want.vertices.shape and got.vertices.dtype == np.float32
    np.testing.assert_allclose(got.vertices, want.vertices, rtol=0, atol=1e-5)
    assert got.colors.dtype == np.uint8
    assert np.abs(got.colors.astype(np.int64) - want.colors).max(initial=0) <= 1
    assert got.triangles.dtype == np.int32
    np.testing.assert_array_equal(got.triangles, want.triangles)
    # The PLY writer: the same bytes from the same mesh.
    got_mesh = tmesh.SurfaceMesh(want.vertices, want.colors, want.triangles, want.vertex_budget_hit)
    got_mesh.save_ply(tmp_path / "port.ply")
    want.save_ply(tmp_path / "ref.ply")
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "ref.ply").read_bytes()
