"""The EuRoC cell's reference and rig, and its cells, on the CPU at small sizes.

* The program's radial-tangential model (``ops/calib.py``) against the
  reference's at EuRoC's coefficients.
* The rig: the calibration the program makes from the rig's ``sensor.yaml``
  files is the reference's; its frames are the reference's ray cast; its
  IMU integrates back to the truth's relative rotation and velocity, with
  white noise at the published densities.
* A run of ``euroc-752x480-stereo-imu.replay-vio`` on a CPU-sized window
  is within the cell's limits; planted faults (the IMU's pose at the
  identity, the distortion zeroed in the program's calibration) and the
  control (the reference in bfloat16) come out not correct.
* ``oak4-640x400-deployed.cadence30`` resolves from files of its own, and
  its control comes out not correct.
* The readers ``imu_predict_ms`` and ``imu_accel_pct`` on planted spans.

On the card, ``python -m pytest benchmark/tests/test_bench_euroc.py -m cuda
-s`` prints the program's and the control's readings over three seeds.
"""

import json

import numpy as np
import pytest
import torch

from benchmark.core import spec
from benchmark.reference import euroc, orbit
from benchmark.run import run_cell
from benchmark.tests.test_bench_program_spans import Planter, _run

EUROC = "euroc-752x480-stereo-imu.replay-vio"
CADENCE = "oak4-640x400-deployed.cadence30"
#: The CPU size of the EuRoC cell: the published 752x480 (at 160x100 one
#: pair of eyes gives too few pixels of disparity to hold the translation:
#: 3 mrad and 16 mm a step on a CPU), 512 slots, a 14-frame sweep,
#: the accelerometer path engaged before the window (60 warm-up ticks).
CPU_SIZE = dict(width=752, height=480)


@pytest.fixture(scope="module")
def cfg():
    return spec.config("euroc-752x480-stereo-imu", spec.load_benchmark())


def _small_rig(cfg, width=64, height=40, n=16, seed=3000000041):
    rig_cfg = {**cfg, "rig": dict(cfg["rig"], width=width, height=height)}
    return spec.rig_builder("euroc_vi").build(rig_cfg, {"fps": 20, "cycle_frames": n}, seed, "cpu")


def test_programs_lens_model_is_the_references():
    from thor_slam_tpu_torch.ops import calib

    for eye in (0, 1):
        fu, fv, cu, cv = euroc.intrinsics(eye)
        uu, vv = np.meshgrid(np.arange(0, euroc.WIDTH, 2.0), np.arange(0, euroc.HEIGHT, 2.0))
        raw = np.stack([(uu - cu) / fu, (vv - cv) / fv], -1)
        ref = euroc.undistort(raw, euroc.DISTORTION[eye])
        np.testing.assert_allclose(euroc.distort(ref, euroc.DISTORTION[eye]), raw, atol=1e-14)  # converged
        torch_ref = euroc.undistort(torch.from_numpy(raw), euroc.DISTORTION[eye]).numpy()
        np.testing.assert_allclose(torch_ref, ref, atol=1e-15)
        coeffs = torch.tensor([*euroc.DISTORTION[eye], 0.0], dtype=torch.float64)
        prog = calib.distort_normalized(torch.from_numpy(ref), coeffs).numpy()
        np.testing.assert_allclose(prog, raw, atol=1e-14)
        # The program's six fixed-point iterations stop short where the lens
        # bends most, at the left and right edges: 0.19 px at most, and
        # within 0.001 px on half of the image.
        px = np.abs(calib.undistort_normalized(torch.from_numpy(raw), coeffs).numpy() - ref) * [fu, fv]
        assert px.max() < 0.2 and np.median(px.max(-1)) < 1e-3, (px.max(), np.median(px))


def test_programs_calibration_is_made_from_the_rigs_files(cfg):
    rig = _small_rig(cfg)
    calib = rig.calibration
    (name,) = rig.source_names
    assert calib.source_names == [name] and rig.num_cameras == 2
    for e in range(2):
        intr = calib.intrinsics[name][e]
        assert (intr.width, intr.height) == (64, 40)
        np.testing.assert_array_equal(intr.matrix, euroc.matrix(e, 64, 40))
        np.testing.assert_array_equal(intr.coeffs, [*euroc.DISTORTION[e], 0.0])
    np.testing.assert_array_equal(calib.extrinsics[name][0].to_4x4_matrix(), np.eye(4))
    np.testing.assert_allclose(calib.extrinsics[name][1].to_4x4_matrix(), euroc.cam0_t_cam1(), atol=1e-14)
    assert calib.imu_extrinsics.source_name == name
    np.testing.assert_allclose(calib.imu_extrinsics.to_4x4_matrix(), euroc.cam0_t_imu(), atol=1e-14)
    assert abs(np.linalg.norm(euroc.cam0_t_imu()[:3, 3]) - 0.0689) < 1e-4
    # The frames are the reference's ray cast at the sweep's poses, each eye through its own lens.
    p = 5
    body = orbit.body_poses(cfg["rig"]["orbit"], rig.frame_times()[p : p + 1]).numpy()
    for e, body_t_eye in enumerate((orbit.BODY_T_OPTICAL, orbit.BODY_T_OPTICAL @ euroc.cam0_t_cam1())):
        want = euroc.render(cfg["rig"], euroc.rays(e, 64, 40), body @ body_t_eye, "cpu")
        np.testing.assert_array_equal(rig.frames[p, 0, e], (want[0] * 255.0).clamp(0, 255).to(torch.uint8).numpy())
    assert rig.frames.shape == (16, 1, 2, 40, 64)
    # Truth: cam0 relative to tick 0.
    gt = rig.gt_poses([0, 3]).numpy()
    np.testing.assert_allclose(gt[0], np.eye(4), atol=1e-12)
    cams = orbit.body_poses(cfg["rig"]["orbit"], rig.frame_times()[[rig.frame(0), rig.frame(3)]]).numpy()
    cams = cams @ orbit.BODY_T_OPTICAL
    np.testing.assert_allclose(gt[1], np.linalg.inv(cams[0]) @ cams[1], atol=1e-12)


def _exp(w):
    theta = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if theta < 1e-12:
        return np.eye(3) + k
    return np.eye(3) + np.sin(theta) / theta * k + (1 - np.cos(theta)) / theta**2 * k @ k


def test_imu_integrates_back_to_the_truth(cfg):
    r = cfg["rig"]
    cycle_s, dt = 8.0, 1.0 / 2000.0
    t = np.arange(1.3, 2.3 + dt / 2, dt)  # a second of the sweep, near its fastest
    b_t_imu = orbit.BODY_T_OPTICAL @ euroc.cam0_t_imu()
    gyro, accel = euroc.imu_samples(r["orbit"], t, b_t_imu, 0.0, cycle_s)
    imu = orbit.body_poses(r["orbit"], orbit.sweep_time(t, 0.0, cycle_s)).numpy() @ b_t_imu
    rot = np.eye(3)
    for k in range(len(t) - 1):
        rot = rot @ _exp(0.5 * (gyro[k] + gyro[k + 1]) * dt)
    truth = imu[0, :3, :3].T @ imu[-1, :3, :3]
    assert np.linalg.norm(rot - truth) < 1e-6
    assert np.linalg.norm(truth - np.eye(3)) > 0.1  # it turned
    acc_w = np.einsum("nij,nj->ni", imu[:, :3, :3], accel) + np.asarray(orbit.GRAVITY_W)
    dv = (0.5 * (acc_w[1:] + acc_w[:-1]) * dt).sum(0)

    def vel(x):
        h = 1e-5
        p = [orbit.body_poses(r["orbit"], orbit.sweep_time(np.array([x + s]), 0.0, cycle_s)).numpy()[0] @ b_t_imu
             for s in (-h, h)]
        return (p[1][:3, 3] - p[0][:3, 3]) / (2 * h)

    np.testing.assert_allclose(dv, vel(t[-1]) - vel(t[0]), atol=1e-5)
    # The lever arm is in the specific force: it differs from cam0's.
    _, at_cam0 = euroc.imu_samples(r["orbit"], t, orbit.BODY_T_OPTICAL, 0.0, cycle_s)
    assert np.abs(np.linalg.norm(accel, axis=1) - np.linalg.norm(at_cam0, axis=1)).max() > 1e-4
    # The rig's samples: the same, with white noise at the published densities drawn from the seed.
    rig = _small_rig(cfg, n=160)
    times = np.arange(4096) / 200.0
    g, a = rig.imu(times)
    g0, a0 = euroc.imu_samples(r["orbit"], times + rig.start / 20.0, b_t_imu, 0.0, 8.0)
    assert abs(np.std(g - g0) / (euroc.GYRO_NOISE_DENSITY * np.sqrt(200.0)) - 1) < 0.05
    assert abs(np.std(a - a0) / (euroc.ACCEL_NOISE_DENSITY * np.sqrt(200.0)) - 1) < 0.05
    np.testing.assert_array_equal(rig.imu(times)[0], g)


def _cell(name, **mix_update):
    from benchmark.tests.conftest import shrink

    bench = spec.load_benchmark()
    cell = spec.cell(name, bench)
    cfg, mix = shrink(spec.config(cell["config"], bench), spec.traffic(cell["traffic"]))
    if name == EUROC:
        cfg["rig"].update(CPU_SIZE)
        cfg["engine"]["params"]["max_keypoints"] = 512
        mix["warmup_ticks"] = 60
    mix.update(mix_update)
    return cell, cfg, mix, spec.limits(name), bench


def _euroc_run(control=None, seconds=4.0, seed=3000000043):
    cell, cfg, mix, limits, bench = _cell(EUROC)
    return run_cell(cell, cfg, mix, limits, bench, seed, seconds, False, torch.device("cpu"), log=lambda m: None,
                    control=control)


def test_sound_run_is_correct_and_the_control_is_not():
    result = _euroc_run(control=torch.bfloat16)
    assert result["attempted"] >= 30 and result["failed"] == 0
    assert result["correct"], result["checks"]
    assert not result["control_correct"], result["control_checks"]


def test_imu_at_the_identity_is_not_correct(monkeypatch):
    from thor_slam_tpu_torch.camera.sources import euroc_sensor
    from thor_slam_tpu_torch.camera.types import Extrinsics, IMUExtrinsics

    monkeypatch.setattr(euroc_sensor, "imu_extrinsics",
                        lambda src: IMUExtrinsics(source_name=src.name, extrinsics=Extrinsics.identity()))
    result = _euroc_run()
    assert not result["correct"], result["checks"]


def test_distortion_zeroed_is_not_correct(monkeypatch):
    from thor_slam_tpu_torch.camera.sources import euroc_sensor

    real = euroc_sensor.read_calibration

    def zeroed(root, override=None):
        calib = real(root, override)
        for intr in calib.intrinsics:
            intr.coeffs = np.zeros(5)
        return calib

    monkeypatch.setattr(euroc_sensor, "read_calibration", zeroed)
    result = _euroc_run()
    assert not result["correct"], result["checks"]


def test_cadence30_resolves_from_files_of_its_own():
    bench = spec.load_benchmark()
    cell = spec.cell(CADENCE, bench)
    mix, mapped = spec.traffic(cell["traffic"]), spec.traffic("cadence30-map")
    assert cell["config"] == "oak4-640x400-deployed" and cell["chips"] == 1
    assert mix == dict(mapped, rgbd_every=0, map=False, depth_sample=0)
    assert spec.generator(mix["generator"]).Clock.paced
    d = spec.limits("oak4-640x400-deployed.cadence30-map")
    assert spec.limits(CADENCE) == {k: v for k, v in d.items() if k not in ("depth_bad_px_pct", "tsdf_bad_vox_pct")}
    untraced = {m["name"] for m in spec.metrics_for(CADENCE, bench, False)}
    assert untraced == {"tick_rate", "pose_latency_p95_ms", "setup_s"}
    traced = {m["name"] for m in spec.metrics_for(CADENCE, bench, True)}
    assert {"imu_predict_ms", "imu_accel_pct"} <= traced and not traced & {"rgbd_call_ms", "integrate_device_ms"}
    c, cfg, small, limits, bench = _cell(CADENCE)
    from benchmark.tests.conftest import SMALL_LIMITS

    result = run_cell(c, cfg, small, {k: SMALL_LIMITS[k] for k in limits}, bench, 3000000047, 3.0, False,
                      torch.device("cpu"), log=lambda m: None, control=torch.bfloat16)
    assert result["correct"], result["checks"]
    assert not result["control_correct"], result["control_checks"]


def test_imu_readers_on_planted_spans(monkeypatch):
    from thor_slam_tpu_torch.utils import profiling

    p = Planter()
    for tick, (at, ms, accel) in enumerate([(0, 0.5, False), (200, 0.25, True), (400, 9.0, True), (600, 1.0, True)]):
        root = p.add("engine.process_frames", at, 100, tick=tick)
        d = p.add("engine.dispatch", at + 1, 60, parent=root)
        if tick != 3:
            p.add("engine.imu", at + 2, ms, parent=d, samples=10, accel=accel)
    run = _run([(-1, 101, False), (199, 301, False), (399, 501, True), (599, 701, False)])
    monkeypatch.setattr(profiling, "spans", lambda: list(p.spans))
    # Ticks 0, 1 and 3 untraced; tick 3 carried no IMU batch.
    assert spec.reader("imu_predict_ms").read(run) == pytest.approx((0.5 + 0.25 + 0.0) / 3)
    assert spec.reader("imu_accel_pct").read(run) == pytest.approx(100.0 / 3)
    plain = Planter()
    root = plain.add("engine.process_frames", 0, 100, tick=0)
    plain.add("engine.dispatch", 1, 60, parent=root)
    monkeypatch.setattr(profiling, "spans", lambda: list(plain.spans))
    assert spec.reader("imu_predict_ms").read(run) is None and spec.reader("imu_accel_pct").read(run) is None


@pytest.mark.cuda
def test_control_fails_on_the_card(cuda_device):
    bench = spec.load_benchmark()
    cell = spec.cell(EUROC, bench)
    cfg, mix, limits = spec.config(cell["config"], bench), spec.traffic(cell["traffic"]), spec.limits(EUROC)
    for seed in (3100000011, 3100000012, 3100000013):
        result = run_cell(cell, cfg, mix, limits, bench, seed, 20.0, False, cuda_device, log=lambda m: None,
                          control=torch.bfloat16)
        print(json.dumps({"cell": EUROC, "seed": seed, "program": result["readings"],
                          "control": result["control_readings"]}))
        assert not result["control_correct"]
