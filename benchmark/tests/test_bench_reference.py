"""The plain reference against the program, on the CPU at small sizes: the
reference is frozen at what the program computes (exactly where the
program's result is exact), and the rig the benchmark builds from a
configuration's numbers is the program's own synthetic rig."""

import numpy as np
import pytest
import torch

from benchmark.core import spec
from benchmark.reference import orbit, scene
from benchmark.reference.tsdf import TsdfReference

DEPLOYED = "oak4-640x400-deployed"


@pytest.fixture(scope="module")
def cfg():
    return spec.config(DEPLOYED, spec.load_benchmark())


def _rig(cfg, width=160, height=100, color=(320, 200)):
    from thor_slam_tpu_torch.utils.flagship import flagship_rig

    r = cfg["rig"]
    return flagship_rig(num_cams=r["num_sources"], width=width, height=height, max_keypoints=64,
                        color_resolution=color, angular_rate=r["orbit"]["angular_rate"])


def _orbit_rig():
    return spec.rig_builder("synthetic_orbit")


@pytest.mark.parametrize("config", [DEPLOYED, "oak4-1280x720-flagship"])
def test_geometry_is_the_programs_rig(config):
    """Every number of the configuration's ``rig`` block is the program's
    synthetic rig's: the calibration the benchmark hands the engine, the
    eyes the scene renders from, the orbit and its IMU."""
    r = spec.config(config, spec.load_benchmark())["rig"]
    color = tuple(r["color_resolution"]) if r["color_resolution"] else None
    _, _, calib, sources, world, traj = _rig({"rig": r}, r["width"], r["height"], color)
    assert tuple(world.half_extents) == tuple(r["room_half_extents"]) and world.seed == r["texture_seed"]
    for key in ("radius", "angular_rate", "height", "height_amplitude", "height_rate", "rp_amplitude", "rp_rate"):
        assert getattr(traj, key) == r["orbit"][key]
    names, ours = _orbit_rig().calibration(r)
    assert names == calib.source_names == ours.source_names
    assert ours.imu_extrinsics.source_name == calib.imu_extrinsics.source_name
    np.testing.assert_allclose(ours.imu_extrinsics.extrinsics.to_4x4_matrix(), calib.imu_extrinsics.extrinsics.to_4x4_matrix())
    eyes = scene.body_t_eyes(r)
    times = np.array([0.0, 0.7, 13.3, 41.0])
    body = orbit.body_poses(r["orbit"], times).numpy()
    np.testing.assert_allclose(body, np.stack([traj.pose(t) for t in times]), atol=1e-12)
    for i, src in enumerate(sources):
        name = src.name
        for e in range(2):
            a, b = ours.intrinsics[name][e], calib.intrinsics[name][e]
            assert (a.width, a.height) == (b.width, b.height)
            np.testing.assert_array_equal(a.matrix, b.matrix)
            np.testing.assert_allclose(ours.extrinsics[name][e].to_4x4_matrix(), calib.extrinsics[name][e].to_4x4_matrix(),
                                       atol=1e-12)
            for t, g in zip(times, body):
                np.testing.assert_allclose(g @ eyes[i, e], src.world_t_optical(t, e), atol=1e-12)
        np.testing.assert_allclose(ours.rig_extrinsics[name].to_4x4_matrix(), calib.rig_extrinsics[name].to_4x4_matrix(),
                                   atol=1e-12)
        if color:
            want = src.get_rgb_intrinsics()
            got = _orbit_rig().rgbd_source(r, ours, i)
            np.testing.assert_array_equal(got["color_intrinsics"].matrix, want.matrix)
            np.testing.assert_allclose(got["left_t_color"], src.get_rgb_extrinsics().to_4x4_matrix())
            for t, g in zip(times, body):
                np.testing.assert_allclose(g @ scene.body_t_color(r, i), src.world_t_color(t), atol=1e-12)
    gyro, accel = orbit.imu_samples(r["orbit"], times)
    for t, g, a in zip(times, gyro, accel):
        g0, a0 = traj.imu_sample(t)
        np.testing.assert_allclose(g, g0, atol=1e-9)
        np.testing.assert_allclose(a, a0, atol=1e-6)


def test_scene_renders_the_programs_images(cfg):
    """The frozen scene casts the same rays into the same room as the
    program's renderer: the same images, bit for bit, from the same poses."""
    from thor_slam_tpu_torch.camera.sources import synthetic_torch

    r = cfg["rig"]
    _, _, _, sources, world, traj = _rig(cfg, width=96, height=60, color=None)
    poses = np.stack([src.world_t_optical(t, e) for t in (0.0, 2.5, 9.0) for src in sources for e in range(2)])
    k = orbit.pinhole(96, 60, r["focal_scale"])
    got = scene.render(r, k, 96, 60, poses, "cpu")
    want = synthetic_torch.render(world, sources[0].get_intrinsics()[0], poses, "cpu")
    assert got.shape == (len(poses), 60, 96) and float(got.std()) > 0.05
    assert torch.equal(got, want)


def test_rgbd_depth_equals_the_program_bit_for_bit(cfg):
    from thor_slam_tpu_torch.pipeline.rgbd import RGBDProcessor
    from thor_slam_tpu_torch.utils.flagship import render_sequence

    _, _, calib, sources, _, _ = _rig(cfg)
    src = sources[0]
    frames = (np.clip(render_sequence(sources[:1], 3) * 255.0, 0, 255)).astype(np.uint8)  # (3, 1, 2, H, W)
    colors = np.stack([src.render_color_frame(n) for n in range(3)])
    rig = dict(cfg["rig"], width=160, height=100, color_resolution=[320, 200])
    ref = _orbit_rig().rgbd_reference(rig, {"num_disparities": 16}, "cpu", torch.float32)
    want = ref.depth_mm(frames[:, 0, 0], frames[:, 0, 1])
    proc = RGBDProcessor(src.name, src.get_intrinsics(), src.get_extrinsics(), output_resolution=(320, 200),
                         num_disparities=16, color_intrinsics=src.get_rgb_intrinsics(),
                         left_t_color=src.get_rgb_extrinsics().to_4x4_matrix(), device="cpu")
    for n in range(3):
        got = proc._compute_color(proc.upload(frames[n, 0, 0]), proc.upload(frames[n, 0, 1]),
                                  torch.from_numpy(colors[n]))[1]
        assert got.dtype == want.dtype == torch.uint16 and int((got.to(torch.int32) > 0).sum()) > 1000
        assert torch.equal(got.to(torch.int32), want[n].to(torch.int32))


def test_tsdf_equals_the_program_bit_for_bit(cfg):
    from thor_slam_tpu_torch.camera.types import Intrinsics
    from thor_slam_tpu_torch.pipeline.mapper import DenseMapper, MapperConfig
    from thor_slam_tpu_torch.pipeline.rgbd import RGBDFrame

    m = dict(cfg["mapping"], dims=[40, 36, 24])
    mapper = DenseMapper(MapperConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                                         for k, v in m.items() if k != "integrate_every"}), device="cpu")
    ref = TsdfReference(m, device="cpu")
    rng = np.random.default_rng(5)
    k = orbit.pinhole(64, 48, 0.8)
    poses = orbit.body_poses(cfg["rig"]["orbit"], np.linspace(0.0, 40.0, 6)).numpy() @ orbit.BODY_T_OPTICAL
    for pose in poses:  # the last poses move the camera far enough to roll the grid
        depth = rng.integers(300, 3000, (48, 64)).astype(np.uint16)
        color = rng.integers(0, 255, (48, 64, 3)).astype(np.uint8)
        frame = RGBDFrame(rgb=color, depth_mm=depth, intrinsics=Intrinsics(64, 48, k, np.zeros(5)),
                          timestamp=0.0, camera_name="c")
        mapper.integrate(frame, pose)
        ref.integrate(depth, color, pose, k)
    assert mapper.stats.recenters > 0
    g = mapper.grid
    assert int((g.weight > 0).sum()) > 100
    assert torch.equal(g.tsdf, ref.tsdf) and torch.equal(g.weight, ref.weight) and torch.equal(g.color, ref.rgb)
    np.testing.assert_array_equal(g.origin.numpy(), ref.origin)


def test_sweep_and_its_imu(cfg):
    from benchmark.core.traffic import FrameSetFactory

    r, n = cfg["rig"], 8
    small = {"rig": dict(r, width=32, height=20)}
    mix = {"cycle_frames": n, "fps": 30}
    rig = _orbit_rig().build(small, mix, 3000000031, "cpu")
    times = rig.frame_times()
    half = n / 30 / 2  # half a cycle: the rig runs half a cycle's worth of orbit each way
    np.testing.assert_allclose(times[[0, n // 2]], [0.0, half])
    assert np.all(np.diff(times[: n // 2 + 1]) > 0) and np.all(np.diff(times[n // 2 :]) < 0)
    assert rig.frames.shape == (n, r["num_sources"], 2, 20, 32) and rig.frames.dtype == np.uint8
    # The rendered frames are the scene at the sweep's poses.
    p = 5
    want = scene.render(r, orbit.pinhole(32, 20, r["focal_scale"]), 32, 20,
                        orbit.body_poses(r["orbit"], times[p : p + 1]).numpy() @ scene.body_t_eyes(r)[1, 0], "cpu")
    np.testing.assert_array_equal(rig.frames[p, 1, 0], (want[0] * 255.0).clamp(0, 255).to(torch.uint8).numpy())

    rig.start = 0
    f = FrameSetFactory(rig, 30.0, 400.0)
    first, second = f(1).sensor_data, f(3).sensor_data  # tick 3 after tick 1: two frames of samples
    assert len(first["timestamps"]) == 13 and len(second["timestamps"]) == 27
    np.testing.assert_allclose(np.diff(second["timestamps"]), 1 / 400)
    want = orbit.imu_samples(r["orbit"], second["timestamps"], offset=0.0, cycle_s=n / 30)
    np.testing.assert_allclose(second["gyroscope"], want[0]) and np.testing.assert_allclose(second["accelerometer"], want[1])
    # A seed's stream starts elsewhere in the cycle: the frames, the IMU and the truth shift together.
    rig.start = 3
    g = FrameSetFactory(rig, 30.0, 400.0)
    assert [rig.frame(k) for k in (0, 5, 6)] == [3, 0, 1]
    shifted = g(1).sensor_data
    np.testing.assert_allclose(shifted["gyroscope"], orbit.imu_samples(
        r["orbit"], shifted["timestamps"] + 3 / 30, offset=0.0, cycle_s=n / 30)[0])
    gt = rig.gt_poses([0, 2, 5]).numpy()
    np.testing.assert_allclose(gt[0], np.eye(4), atol=1e-12)
    body = orbit.body_poses(r["orbit"], times[[3, 5, 0]]).numpy()
    np.testing.assert_allclose(gt[1:], np.linalg.inv(body[0]) @ body[1:], atol=1e-12)
    # At the ends of the sweep the rig stands: the gyro reads the orbit's
    # roll and pitch oscillation alone, and the motion turns smoothly.
    mid = orbit.imu_samples(r["orbit"], [n / 30 / 4], offset=0.0, cycle_s=n / 30)[0][0]
    end = orbit.imu_samples(r["orbit"], [0.0], offset=0.0, cycle_s=n / 30)[0][0]
    assert abs(end[2]) < 0.05 * abs(mid[2])
