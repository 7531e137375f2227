"""The patrol lap's pieces on the CPU: the plain pose-graph solve, the lap
rig, and a loop closure the port's engine makes, re-solved by the plain
reference.

* The closed-form edge Jacobian of ``posegraph`` against ``jacfwd``'s.
* ``posegraph.optimize`` against ``benchmark/reference/posegraph.py`` in
  float64 on seeded drifted chains closed by a loop edge, at 8, 32 and 64
  nodes, live and padded: within the reference's tolerances, node 0 (the
  gauge) and the padding left where they were; the reference in bfloat16
  lies outside the same tolerances.
* The lap rig (``benchmark/rigs/orbit_lap.py``) of the patrol
  configuration: the lap closes (frame 628's pose is frame 0's), the IMU
  runs on across the seam, the black frame sits on the lights-out's ticks
  alone, and their truth is the lap's.
* A revisit orbit with a blackout through the port's engine (the loop
  end-to-end configuration of ``tests/test_torch_loop.py``, on the port's
  own synthetic rig): every closure's graph (``chip_smoke.
  closures_recorded``), re-solved by the plain reference, agrees with the
  program's solve, and the correction it applied is its solve's.
* On a card (``-m cuda``): every solve of a window of the patrol cell
  against the plain reference, and its bfloat16 control outside.

This file imports no JAX.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import chip_smoke
from benchmark.core import spec
from benchmark.reference import orbit
from benchmark.reference import posegraph as ref
from thor_slam_tpu_torch.camera.rig import CameraRig
from thor_slam_tpu_torch.camera.sources.synthetic import (
    OrbitTrajectory,
    SyntheticRigSpec,
    SyntheticWorld,
    make_synthetic_rig,
)
from thor_slam_tpu_torch.engine import posegraph
from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
from thor_slam_tpu_torch.ops import lie
from thor_slam_tpu_torch.slam.interface import SlamConfig

torch.set_num_threads(2)

PATROL = "oak4-640x400-patrol"
CELL = "oak4-640x400-patrol.orbit-loop"


# ---------------------------------------------------------- pose graph


def _chain(k, step, yaw, noise, seed):
    rng = np.random.default_rng(seed)
    poses = [np.eye(4)]
    for _ in range(k - 1):
        xi = np.array([step, 0.0, 0.02, 0.01, 0.0, yaw]) + rng.normal(0, noise, 6)
        poses.append(poses[-1] @ lie.se3_exp(torch.from_numpy(xi)).numpy())
    return np.stack(poses)


def _graph(live, capacity, seed):
    """A drifted chain of ``live`` nodes round a circle, closed by a loop
    edge (weight 3) from node 0 to the last holding the true relative pose,
    padded to ``capacity`` nodes and edges as the loop backend pads it."""
    true = _chain(live, 0.3, 2 * np.pi / live, 0.0, seed)
    drift = _chain(live, 0.3, 2 * np.pi / live, 0.02, seed + 1).astype(np.float32)
    ei, ej, et, w = posegraph.sequential_graph(drift, capacity_edges=capacity)
    ei[live - 1], ej[live - 1] = 0, live - 1
    et[live - 1] = np.linalg.inv(true[0]) @ true[live - 1]
    w[live - 1] = 3.0
    poses = np.tile(np.eye(4, dtype=np.float32), (capacity, 1, 1))
    poses[:live] = drift
    mask = (np.arange(capacity) < live).astype(np.float32)
    return dict(poses=poses, node_mask=mask, edge_i=ei, edge_j=ej, edge_t=et, edge_weight=w)


GRAPHS = [(8, 8, 0), (32, 32, 10), (20, 32, 20), (64, 64, 30), (40, 64, 40)]


@pytest.mark.parametrize("live, capacity, seed", GRAPHS)
def test_optimize_agrees_with_the_plain_reference(live, capacity, seed):
    arrays = _graph(live, capacity, seed)
    port, port_rms = posegraph.optimize(posegraph.PoseGraph(**{k: torch.from_numpy(v) for k, v in arrays.items()}))
    plain, plain_rms = ref.optimize(**arrays)
    trans, rot = ref.pose_differences(port, plain)
    assert trans < ref.TRANS_TOL_M and rot < ref.ROT_TOL, (trans, rot)
    assert float(port_rms) == pytest.approx(float(plain_rms), rel=1e-3)
    moved, _ = ref.pose_differences(arrays["poses"][:live], plain[:live])
    assert moved > 20 * ref.TRANS_TOL_M  # the solve did work
    np.testing.assert_array_equal(port[0].numpy(), arrays["poses"][0])  # the gauge
    np.testing.assert_array_equal(port[live:].numpy(), arrays["poses"][live:])  # the padding
    np.testing.assert_array_equal(plain[0].numpy(), arrays["poses"][0].astype(np.float64))
    np.testing.assert_array_equal(plain[live:].numpy(), arrays["poses"][live:].astype(np.float64))


@pytest.mark.parametrize("live, capacity, seed", GRAPHS)
def test_reference_in_bfloat16_fails_the_tolerance(live, capacity, seed):
    arrays = _graph(live, capacity, seed)
    plain, _ = ref.optimize(**arrays)
    control, _ = ref.optimize(**arrays, dtype=torch.bfloat16)
    trans, rot = ref.pose_differences(control, plain)
    assert trans > ref.TRANS_TOL_M or rot > ref.ROT_TOL, (trans, rot)


def test_reference_exp_and_log_are_the_se3_maps():
    rng = np.random.default_rng(5)
    for scale in (1e-7, 1e-3, 0.1, 0.8):  # angles below pi: log inverts exp
        xi = torch.from_numpy(rng.normal(0, scale, (40, 6)))
        np.testing.assert_allclose(ref.exp(xi).numpy(), lie.se3_exp(xi).numpy(), atol=1e-12)
        np.testing.assert_allclose(ref.log(ref.exp(xi)).numpy(), xi.numpy(), atol=1e-10)


def _edge_jacobians_by_jacfwd(x_i, x_j, t_meas, w):
    """``torch.func.jacfwd`` of the residual at left-perturbed nodes, per edge."""
    def res(d_i, d_j, a, b, t, wt):
        return posegraph._edge_logs((lie.se3_exp(d_i) @ a)[None], (lie.se3_exp(d_j) @ b)[None], t[None])[0][0] * wt

    zero = torch.zeros((len(w), 6), dtype=x_i.dtype)
    return torch.func.vmap(torch.func.jacfwd(res, argnums=(0, 1)))(zero, zero, x_i, x_j, t_meas, w)


@pytest.mark.parametrize("angle", [1e-9, 1e-4, 0.03, 0.2, 1.0, 2.5])
def test_closed_form_edge_jacobian_is_jacfwds(angle):
    """The closed-form 6x12 edge blocks against ``jacfwd`` of the residual:
    1e-9 in float64; in float32, within 1e-5 of float64's ``jacfwd`` of the
    same inputs. Edges whose error turns by ``angle`` (either side of the
    series' switch at 0.1 rad) and moves up to metres."""
    rng = np.random.default_rng(int(angle * 1e3) + 7)

    def rnd(rot, trans, n=64):
        return lie.se3_exp(torch.from_numpy(np.concatenate([rng.normal(0, trans, (n, 3)), rng.normal(0, rot, (n, 3))], 1)))

    x_i, x_j = rnd(1.0, 3.0), rnd(1.0, 3.0)
    t_meas = lie.se3_inverse(x_i) @ x_j @ rnd(angle, 1.0)
    w = torch.from_numpy(rng.uniform(0.0, 3.0, 64))
    want_i, want_j = _edge_jacobians_by_jacfwd(x_i, x_j, t_meas, w)
    got, r = posegraph._edge_jacobians(x_i, x_j, t_meas, w)
    np.testing.assert_allclose(got.numpy(), want_j.numpy(), atol=1e-9)
    np.testing.assert_allclose(-got.numpy(), want_i.numpy(), atol=1e-9)
    np.testing.assert_allclose(r.numpy(), posegraph._edge_logs(x_i, x_j, t_meas)[0].numpy() * w.numpy()[:, None])
    f32 = [x.float() for x in (x_i, x_j, t_meas, w)]
    want_i, want_j = _edge_jacobians_by_jacfwd(*(x.double() for x in f32))
    got, _ = posegraph._edge_jacobians(*f32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(), want_j.numpy(), atol=1e-5)


# ------------------------------------------------------------- the lap


@pytest.fixture(scope="module")
def patrol():
    bench = spec.load_benchmark()
    cell = spec.cell(CELL, bench)
    return spec.config(PATROL, bench), spec.traffic(cell["traffic"])


@pytest.fixture(scope="module")
def small_lap(patrol):
    """The patrol lap's rig, rendered at 32x20."""
    cfg, mix = patrol
    cfg = {**cfg, "rig": dict(cfg["rig"], width=32, height=20)}
    return spec.rig_builder("orbit_lap").build(cfg, mix, 3000000041, torch.device("cpu"))


def test_the_lap_closes(patrol):
    cfg, mix = patrol
    r, fps = cfg["rig"], mix["fps"]
    assert r["lap_frames"] == mix["cycle_frames"] == 628 and r["builder"] == "orbit_lap"
    g = orbit.body_poses(r["orbit"], np.array([0.0, r["lap_frames"] / fps, 1.0 / fps, (r["lap_frames"] + 1) / fps]))
    assert float((g[0] - g[1]).abs().max()) < 1e-9 and float((g[2] - g[3]).abs().max()) < 1e-9
    lap_rate = 2 * np.pi * fps / r["lap_frames"]
    o = r["orbit"]
    for rate, times in ((o["angular_rate"], 1), (o["height_rate"], 2), (o["rp_rate"], 5), (0.8 * o["rp_rate"], 4)):
        assert rate == pytest.approx(times * lap_rate, rel=1e-12)


def test_the_imu_runs_on_across_the_seam(small_lap):
    rig = small_lap
    seam = (rig.n - rig.start) / rig.fps  # camera time at which the lap wraps
    t = seam + np.arange(-8, 9) / 400.0
    gyro, accel = rig.imu(t)
    for x in (gyro, accel):
        second = x[2:] - 2 * x[1:-1] + x[:-2]  # a jump would show here
        assert np.abs(second).max() < 1e-3
    # The samples are the orbit's at the lap's time: the lap's frames show it.
    g0, a0 = orbit.imu_samples(rig.rig["orbit"], (t + rig.start / rig.fps) % rig.lap_s)
    np.testing.assert_allclose(gyro, g0, atol=1e-6)
    np.testing.assert_allclose(accel, a0, atol=1e-5)


def test_the_black_frame_sits_on_the_lights_out(small_lap, patrol):
    rig, (_, mix) = small_lap, patrol
    lo, hi = mix["blackout_s"]
    ks = np.arange(2000)
    dark = [k for k in ks if rig.frame(k) == rig.n]
    assert dark == [k for k in ks if lo <= k / rig.fps < hi] and len(dark) == round((hi - lo) * rig.fps)
    assert not rig.frames[rig.n].any() and all(rig.frames[p].any() for p in range(rig.n))
    lit = [k for k in ks if k not in dark]
    assert [rig.frame(k) for k in lit] == [(k + rig.start) % rig.n for k in lit]
    # The truth of a dark tick is the lap's: the pose the tick would have shown.
    twins = [k + rig.n for k in dark]
    np.testing.assert_array_equal(rig.gt_poses(dark).numpy(), rig.gt_poses(twins).numpy())
    assert rig.frames.shape == (rig.n + 1, 4, 2, 20, 32)


# ------------------------------------- a closure of the engine, re-solved

BLACKOUT = range(60, 74)
LOOP_ARGS = dict(loop_db_capacity=30, loop_exclude_recent=6, loop_cooldown_kfs=8, loop_min_votes=40, loop_min_inliers=25)


@pytest.fixture(scope="module")
def closures():
    """170 ticks of a revisit orbit with a blackout (the loop end-to-end
    configuration) through the port's engine; each closure the loop
    backend applied, with the graph it solved (``closures_recorded``)."""
    spec_ = SyntheticRigSpec(num_sources=2, stereo=True, width=160, height=120, fps=20.0, baseline_m=0.12)
    sources, rig_ext, _, _ = make_synthetic_rig(spec_, world=SyntheticWorld(half_extents=(4.0, 4.0, 2.0)),
                                                trajectory=OrbitTrajectory(radius=1.5, angular_rate=1.0))
    engine = TorchSlamEngine(
        params=dict(max_keypoints=256, keyframe_min_inliers=40, keyframe_max_translation=0.3, keyframe_max_rotation=0.35),
        enable_ba=False, use_imu=False, light_ticks=False, device="cpu", **LOOP_ARGS,
    )
    with CameraRig(sources, rig_extrinsics=rig_ext) as rig, chip_smoke.closures_recorded() as out:
        engine.initialize(rig.calibration, SlamConfig(num_cameras=4, enable_loop_closure=True))
        for i in range(170):
            sync = rig.get_synchronized_frames()
            if i in BLACKOUT:
                for fs in sync.frame_sets.values():
                    for f in fs.frames:
                        f.image = np.zeros_like(f.image)
            engine.process_frames(sync)
        engine.flush()
    engine.shutdown()
    return out


def test_each_closure_re_solved_by_the_plain_reference(closures):
    assert closures
    for c in closures:
        g, kk = c["graph"], c["kk"]
        assert g["node_mask"].sum() == kk and g["poses"].shape[0] >= kk and g["edge_weight"][kk - 1] == 3.0
        assert (g["edge_i"][kk - 1], g["edge_j"][kk - 1]) == (c["ci"], c["qi"])
        # The correction the backend applied is its solve's.
        np.testing.assert_allclose(c["t_corr"], c["poses"][kk - 1].astype(np.float64)
                                   @ np.linalg.inv(g["poses"][kk - 1].astype(np.float64)), atol=1e-12)
        plain, _ = ref.optimize(**g)
        trans, rot = ref.pose_differences(c["poses"], plain)
        assert trans < ref.TRANS_TOL_M and rot < ref.ROT_TOL, (trans, rot)
        moved, _ = ref.pose_differences(g["poses"][:kk], plain[:kk])
        assert moved > ref.TRANS_TOL_M  # a closure that moved the trajectory
        json.dumps({k: c[k] for k in ("ci", "qi", "kk", "query_ts")})  # plain host values


# ------------------------------------------------------------ the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from thor_slam_tpu_torch.utils.platform import pin_precision

    pin_precision()
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_each_solve_of_a_patrol_window_on_the_card_agrees_with_the_plain_reference(cuda_device):
    """A 25-s window of the patrol cell through the benchmark's harness on
    the card: the run is correct, it closes a loop, and every pose-graph
    solve lies within the float64 reference's tolerances while the
    reference in bfloat16 lies outside them."""
    out = chip_smoke.record_patrol(cuda_device, 3210000901, seconds=25.0)
    assert out["correct"] and not out["control_correct"] and out["closures"]
    for c in out["closures"]:
        assert c["agrees"] and c["control_fails"], c
