"""Parity of the port's ``DenseMapper`` with the JAX package's, on the CPU.

Modelled on ``tests/test_mapper.py``. Both mappers take the same frames at
the same poses: a sequence that crosses the recenter margin, then decay,
a grayscale frame, the surface cloud, the mesh and the costmap slice on
every axis. Their stats and host origin shadows must be equal, their grids
agree at the bars of ``tests/test_torch_mapping.py``. Also: empty outputs
before the first frame, ``save``/``load`` across the packages, the port's
copy of ``utils/config.py`` on the mapping section, and the slice as a
whole: the synthetic rig's RGB-D products (the reference through its exact
SGM path) integrated by both mappers at the renderer's true poses.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_mapping import _assert_grids_agree
from test_torch_stereo import exact_jax_sgm  # noqa: F401  (fixture)

from thor_slam_tpu.camera.rig import CameraRig
from thor_slam_tpu.camera.sources.synthetic import (
    OrbitTrajectory,
    SyntheticCameraSource,
    SyntheticRigSpec,
    SyntheticWorld,
)
from thor_slam_tpu.camera.types import Intrinsics
from thor_slam_tpu.pipeline.mapper import DenseMapper as JaxDenseMapper
from thor_slam_tpu.pipeline.mapper import MapperConfig as JaxMapperConfig
from thor_slam_tpu.pipeline.rgbd import RGBDFrame as JaxRGBDFrame
from thor_slam_tpu.pipeline.rgbd import RGBDProcessor as JaxRGBDProcessor
from thor_slam_tpu_torch.camera.types import Intrinsics as PortIntrinsics
from thor_slam_tpu_torch.engine.convert import grid_to_numpy
from thor_slam_tpu_torch.pipeline import RGBDFrame, RGBDProcessor
from thor_slam_tpu_torch.pipeline.mapper import DenseMapper, MapperConfig
from thor_slam_tpu_torch.utils.config import ConfigError, RunConfig

torch.set_num_threads(2)

SMALL = dict(
    voxel_size_m=0.05,
    dims=(32, 32, 32),
    recenter_margin_m=0.3,
    slice_axis=2,
    slice_band_m=(0.3, 0.7),
    esdf_max_distance_m=1.0,
)
H, W = 48, 64


def _mappers(**overrides):
    kw = {**SMALL, **overrides}
    return JaxDenseMapper(JaxMapperConfig(**kw)), DenseMapper(MapperConfig(**kw), device="cpu")


def _frame_pair(depth, rgb, ts):
    """The same payloads as the reference's and the port's RGBDFrame."""
    k = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1.0]])
    out = []
    for frame_cls, intr_cls in ((JaxRGBDFrame, Intrinsics), (RGBDFrame, PortIntrinsics)):
        intr = intr_cls(width=W, height=H, matrix=k, coeffs=np.zeros(5))
        out.append(frame_cls(rgb=rgb, depth_mm=depth, intrinsics=intr, timestamp=ts, camera_name="cam0"))
    return out


def _wall(rng, depth_m, gray=False):
    """A noisy wall ``depth_m`` ahead with random colours (or gray levels)."""
    depth = np.round((depth_m + rng.normal(0, 0.01, (H, W))) * 1000).astype(np.uint16)
    depth[rng.random((H, W)) < 0.05] = 0  # holes
    rgb = rng.integers(0, 256, (H, W) if gray else (H, W, 3), dtype=np.uint8)
    return depth, rgb


def _pose(rng, x, yaw_scale=0.1):
    c, s = np.cos(rng.normal() * yaw_scale), np.sin(rng.normal() * yaw_scale)
    pose = np.eye(4)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    pose[:3, 3] = [x, rng.normal() * 0.03, rng.normal() * 0.03]
    return pose


def _assert_same_state(ref, port):
    assert port.stats.integrated_frames == ref.stats.integrated_frames
    assert port.stats.recenters == ref.stats.recenters
    assert port.stats.last_observed_voxels == ref.stats.last_observed_voxels
    assert port.stats.shapes_compiled == ref.stats.shapes_compiled
    np.testing.assert_array_equal(port._origin_host, ref._origin_host)
    assert port._origin_host.dtype == ref._origin_host.dtype
    want = {k: np.asarray(v) for k, v in ref.grid._asdict().items()}
    _assert_grids_agree(want, grid_to_numpy(port.grid), "mapper")


def _drive(ref, port, rng):
    """A walk along +x that crosses the 0.3 m recenter margin twice, then
    decay and a grayscale frame."""
    for i, x in enumerate((0.0, 0.25, 0.55, 0.9, 1.3)):
        depth, rgb = _wall(rng, 0.5 + 0.03 * i)
        pose = _pose(rng, x)
        for mapper, frame in zip((ref, port), _frame_pair(depth, rgb, 0.1 * i)):
            mapper.integrate(frame, pose)
    for mapper in (ref, port):
        mapper.decay(0.9)
    depth, gray = _wall(rng, 0.6, gray=True)
    pose = _pose(rng, 1.35)
    for mapper, frame in zip((ref, port), _frame_pair(depth, gray, 0.6)):
        mapper.integrate(frame, pose)


@pytest.mark.parametrize("slice_axis", [0, 1, 2])
def test_mapper_matches_reference(slice_axis):
    ref, port = _mappers(slice_axis=slice_axis, slice_band_m=(-0.3, 0.4))
    _drive(ref, port, np.random.default_rng(slice_axis))
    assert ref.stats.recenters >= 1
    want_cloud, got_cloud = ref.surface_cloud(), port.surface_cloud()
    assert len(want_cloud[0]) > 100
    np.testing.assert_allclose(got_cloud[0], want_cloud[0], rtol=0, atol=1e-6)
    # Colours: the grids' agree to 1e-3, and truncation to uint8 can move a
    # value across an integer by 1.
    assert np.abs(got_cloud[1].astype(np.int64) - want_cloud[1]).max() <= 1
    want_mesh, got_mesh = ref.mesh(), port.mesh()
    assert len(want_mesh.triangles) > 0
    np.testing.assert_array_equal(got_mesh.triangles, want_mesh.triangles)
    np.testing.assert_allclose(got_mesh.vertices, want_mesh.vertices, rtol=0, atol=1e-5)
    assert np.abs(got_mesh.colors.astype(np.int64) - want_mesh.colors).max() <= 1
    want, got = ref.esdf_slice(), port.esdf_slice()
    assert got[0].shape == want[0].shape
    assert want[2].any()
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    _assert_same_state(ref, port)


def test_empty_mapper_outputs_and_save_raises(tmp_path):
    ref, port = _mappers()
    assert port.grid is None
    pts, cols = port.surface_cloud()
    assert pts.shape == (0, 3) and cols.shape == (0, 3)
    mesh = port.mesh()
    assert len(mesh.vertices) == 0 and len(mesh.triangles) == 0
    for got, want in zip(port.esdf_slice(), ref.esdf_slice()):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    with pytest.raises(RuntimeError, match="nothing integrated"):
        port.save(tmp_path / "map.npz")
    port.decay()  # no grid: nothing to do


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_save_load_across_packages(tmp_path, writer):
    ref, port = _mappers()
    _drive(ref, port, np.random.default_rng(7))
    path = tmp_path / "map.npz"
    (ref if writer == "reference" else port).save(path)
    ref2, port2 = _mappers(dims=(16, 16, 16), voxel_size_m=0.2)  # the file's spec replaces these
    (port2 if writer == "reference" else ref2).load(path)
    loaded, saver = (port2, ref) if writer == "reference" else (ref2, port)
    assert loaded.spec.dims == (32, 32, 32) and loaded.spec.voxel_size_m == 0.05
    np.testing.assert_array_equal(loaded._origin_host, saver._origin_host)
    grid = loaded.grid
    for k in ("tsdf", "weight", "color", "origin"):
        np.testing.assert_array_equal(np.asarray(getattr(grid, k)), np.asarray(getattr(saver.grid, k)))
    # Both go on integrating from the loaded map alike.
    ref3, port3 = _mappers()
    for m in (ref3, port3):
        m.load(path)
    rng = np.random.default_rng(8)
    depth, rgb = _wall(rng, 0.55)
    pose = _pose(rng, 1.3)
    for mapper, frame in zip((ref3, port3), _frame_pair(depth, rgb, 1.0)):
        mapper.integrate(frame, pose)
    _assert_same_state(ref3, port3)


def test_device_tensor_frame_and_shapes():
    """A frame with tensor payloads (``fetch=False``'s form), grayscale too,
    integrates like its host arrays; one integrator per depth shape."""
    rng = np.random.default_rng(11)
    _, host = _mappers()
    _, dev = _mappers()
    for gray in (False, True):
        depth, rgb = _wall(rng, 0.52, gray=gray)
        _, frame = _frame_pair(depth, rgb, 0.0)
        host.integrate(frame, np.eye(4))
        tensors = RGBDFrame(rgb=torch.from_numpy(rgb), depth_mm=torch.from_numpy(depth),
                            intrinsics=frame.intrinsics, timestamp=0.0, camera_name="cam0")
        dev.integrate(tensors, np.eye(4))
    for k, v in grid_to_numpy(host.grid).items():
        np.testing.assert_array_equal(grid_to_numpy(dev.grid)[k], v)
    small = RGBDFrame(rgb=np.zeros((24, 32, 3), np.uint8), depth_mm=np.full((24, 32), 520, np.uint16),
                      intrinsics=PortIntrinsics(width=32, height=24, matrix=np.diag([25.0, 25.0, 1.0]),
                                                coeffs=np.zeros(5)),
                      timestamp=0.2, camera_name="cam0")
    dev.integrate(small, np.eye(4))
    assert dev.stats.shapes_compiled == {(H, W), (24, 32)}


def test_mapper_needs_an_explicit_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseMapper(MapperConfig(**SMALL))


# ------------------------------------------------------------------ config


MAPPING_SECTION = {
    "enabled": True,
    "voxel_size_m": 0.1,
    "dims": [64, 64, 32],
    "slice_axis": 1,
    "slice_band_m": [-0.5, 0.5],
    "integrate_every": 3,
}


def test_config_mapping_round_trip():
    from thor_slam_tpu.utils.config import RunConfig as JaxRunConfig

    cfg = RunConfig.from_dict({"mapping": MAPPING_SECTION})
    m = cfg.mapping
    assert m.enabled and m.voxel_size_m == 0.1 and m.dims == (64, 64, 32)
    assert m.slice_axis == 1 and m.slice_band_m == (-0.5, 0.5)
    assert m.integrate_every == 3
    assert m.truncation_vox == 4.0 and m.max_integration_distance_m == 10.0
    assert m.__dict__ == JaxRunConfig.from_dict({"mapping": MAPPING_SECTION}).mapping.__dict__
    assert not RunConfig.from_dict({}).mapping.enabled


@pytest.mark.parametrize("section,match", [
    ({"dims": [64, 64]}, "mapping.dims"),
    ({"dims": [64, 64, 4]}, "mapping.dims"),
    ({"slice_band_m": [1.0, 0.0]}, "slice_band_m"),
    ({"slice_axis": 3}, "slice_axis"),
])
def test_config_mapping_errors(section, match):
    with pytest.raises(ConfigError, match=match):
        RunConfig.from_dict({"mapping": section})


# --------------------------------------------------------- the whole slice

SLICE_FRAMES = 4
SLICE_DISPARITIES = 32
# The products' depths differ by 1 mm on ~0.02 % of pixels (XLA contracts the
# bilinear blend into an FMA; tests/test_torch_rgbd.py): a voxel that reads
# such a pixel may differ by 1 mm / its weight.
SLICE_MIN_EQUAL_WEIGHT_SHARE = 0.999
SLICE_TSDF_ATOL = 1.5e-3


def test_rgbd_products_map_alike(exact_jax_sgm):  # noqa: F811
    """The synthetic rig's RGB-D products (160x100 stereo, 320x200 colour)
    through both processors, integrated by both mappers at the renderer's
    true poses of the colour imager."""
    spec = SyntheticRigSpec(num_sources=1, stereo=True, width=160, height=100, color_camera=True,
                            color_resolution=(320, 200))
    src = SyntheticCameraSource("cam0", SyntheticWorld(half_extents=(2.5, 2.5, 1.5)), OrbitTrajectory(radius=1.0),
                                np.eye(4), spec)
    args = (src.name, src.get_intrinsics(), src.get_extrinsics())
    color_kw = dict(color_intrinsics=src.get_rgb_intrinsics(), left_t_color=src.get_rgb_extrinsics().to_4x4_matrix(),
                    num_disparities=SLICE_DISPARITIES)
    jproc = JaxRGBDProcessor(*args, **color_kw)
    tproc = RGBDProcessor(*args, device="cpu", **color_kw)
    cfg = dict(voxel_size_m=0.1, dims=(64, 64, 32), recenter_margin_m=1.0, slice_band_m=(-0.5, 0.5))
    ref, port = _mappers(**cfg)
    with CameraRig([src]) as rig:
        for _ in range(SLICE_FRAMES):
            sync = rig.get_synchronized_frames()
            color = src.try_get_latest_rgb_frame()
            pose = src.world_t_color(color.timestamp)
            ref.integrate(jproc.process(sync, color_frame=color), pose)
            port.integrate(tproc.process(sync, color_frame=color, fetch=False), pose)
    want = {k: np.asarray(v) for k, v in ref.grid._asdict().items()}
    got = grid_to_numpy(port.grid)
    equal = got["weight"] == want["weight"]
    print(f"slice: {int((~equal).sum())} of {equal.size} voxels with another weight, "
          f"{(want['weight'] > 0).sum()} observed")
    assert (want["weight"] > 0).mean() > 0.01
    assert equal.mean() >= SLICE_MIN_EQUAL_WEIGHT_SHARE
    np.testing.assert_allclose(got["tsdf"][equal], want["tsdf"][equal], rtol=0, atol=SLICE_TSDF_ATOL)
    np.testing.assert_array_equal(port._origin_host, ref._origin_host)
    assert port.stats.integrated_frames == ref.stats.integrated_frames == SLICE_FRAMES
