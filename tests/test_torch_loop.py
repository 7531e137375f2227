"""The port's loop closure against the JAX package's.

* ``find_candidate``: the same integer votes for every entry.
* ``verify_candidate`` with the reference's ``PRNGKey`` draws injected:
  the same accept flag and inlier count, the pose within 1e-4.
* ``posegraph.optimize`` on a 32-node drifted chain plus a loop edge (all
  nodes live, and 20 live nodes padded to 32): poses within 1e-4.
* ``LoopBackend`` replayed over one recorded keyframe sequence: the port
  engine's keyframe signatures from a revisit orbit with a sensor
  blackout (the JAX package's loop end-to-end configuration), fed to both
  backends with the same draws: the same closures (ci, qi), the
  map correction within 1e-3. The same run checks the port engine closed
  the loop itself and that its map-lifted pose beats the odometry.
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
from thor_slam_tpu.engine import loop as jloop
from thor_slam_tpu.engine import posegraph as jpg
from thor_slam_tpu.engine import setup as jsetup
from thor_slam_tpu.engine.backends.loop_closure import LoopBackend as JaxLoopBackend
from thor_slam_tpu.ops import rectify as jrectify
from thor_slam_tpu.slam.interface import SlamConfig
from thor_slam_tpu_torch.engine import loop as tloop
from thor_slam_tpu_torch.engine import posegraph as tpg
from thor_slam_tpu_torch.engine.backends.loop_closure import LoopBackend
from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
from thor_slam_tpu_torch.ops import lie
from thor_slam_tpu_torch.ops import rectify as trectify

torch.set_num_threads(2)


def _i32(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words, np.uint32).view(np.int32))


def _jax_draws(frame_count: int, n: int) -> torch.Tensor:
    return torch.from_numpy(np.array(jax.random.uniform(jax.random.PRNGKey(frame_count), (tloop.NUM_HYPOTHESES, n))))


# ---------------------------------------------------------- detection


def _flip(words: np.ndarray, nbits: int, rng) -> np.ndarray:
    out = words.copy()
    for row in out.reshape(-1, 8):
        for b in rng.choice(256, nbits, replace=False):
            row[b // 32] ^= np.uint32(1 << (b % 32))
    return out


@pytest.mark.parametrize("k", [48, 20])
def test_find_candidate_votes_equal(k):
    rng = np.random.default_rng(k)
    n = 64
    db = rng.integers(0, 2**32, (k, n, 8), dtype=np.uint64).astype(np.uint32)
    query = db[5].copy()
    query[: n // 2] = _flip(db[5, : n // 2], 20, rng)  # half close, half distant
    db[11, :40] = _flip(query[:40], 40, rng)  # a weaker second place
    db_valid = rng.random((k, n)) > 0.1
    q_valid = rng.random(n) > 0.05
    mask = (rng.random(k) > 0.2).astype(np.float32)
    mask[5] = 1.0
    mask[k - 4 :] = 0.0  # a block with no eligible entry at k=48
    ref = jloop.find_candidate(
        jnp.asarray(query), jnp.asarray(q_valid), jnp.asarray(db), jnp.asarray(db_valid), jnp.asarray(mask)
    )
    port = tloop.find_candidate(
        _i32(query), torch.from_numpy(q_valid), _i32(db), torch.from_numpy(db_valid), torch.from_numpy(mask)
    )
    np.testing.assert_array_equal(port.all_votes.numpy(), np.asarray(ref.all_votes))
    assert int(port.keyframe) == int(ref.keyframe) == 5
    assert int(port.votes) == int(ref.votes) > 20


def _verify_case(seed: int):
    rng = np.random.default_rng(seed)
    n = 256
    lm = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2, 6, n)], -1).astype(np.float32)
    desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    valid = rng.random(n) > 0.1
    true = lie.se3_exp(torch.tensor([0.05, -0.03, 0.02, 0.01, -0.02, 0.015])).numpy()  # body_t_world
    perm = rng.permutation(n)
    p_b = lm[perm] @ true[:3, :3].T + true[:3, 3]
    obs = (p_b[:, :2] / p_b[:, 2:3] + rng.normal(0, 5e-4, (n, 2))).astype(np.float32)
    q_desc = _flip(desc[perm], 6, rng)
    out = rng.random(n) < 0.2  # outliers: foreign descriptors
    q_desc[out] = rng.integers(0, 2**32, (int(out.sum()), 8), dtype=np.uint64).astype(np.uint32)
    q_valid = rng.random(n) > 0.05
    init = np.eye(4, dtype=np.float32)
    cam_rot, cam_trans = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    return lm, valid, desc, obs, q_desc, q_valid, cam_rot, cam_trans, init, true


@pytest.mark.parametrize("seed,min_inliers", [(0, 40), (1, 40), (2, 10_000)])
def test_verify_candidate_with_injected_draws(seed, min_inliers):
    lm, valid, desc, obs, q_desc, q_valid, cam_rot, cam_trans, init, true = _verify_case(seed)
    key = 7 + seed
    ref = jloop.verify_candidate(
        jax.random.PRNGKey(key), jnp.asarray(lm), jnp.asarray(valid), jnp.asarray(desc), jnp.asarray(obs),
        jnp.asarray(q_desc), jnp.asarray(q_valid), jnp.asarray(cam_rot), jnp.asarray(cam_trans),
        jnp.asarray(init), min_inliers=min_inliers,
    )
    port = tloop.verify_candidate(
        torch.from_numpy(lm), torch.from_numpy(valid), _i32(desc), torch.from_numpy(obs), _i32(q_desc),
        torch.from_numpy(q_valid), torch.from_numpy(cam_rot), torch.from_numpy(cam_trans), torch.from_numpy(init),
        min_inliers=min_inliers, uniforms=_jax_draws(key, lm.shape[0]),
    )
    assert bool(port.accepted) == bool(ref.accepted) == (min_inliers < 1000)
    assert int(port.num_inliers) == int(ref.num_inliers) > 100
    np.testing.assert_allclose(port.body_t_candidate.numpy(), np.asarray(ref.body_t_candidate), atol=1e-4)
    np.testing.assert_allclose(port.body_t_candidate.numpy(), true, atol=5e-3)  # and it found the pose
    np.testing.assert_allclose(port.covariance.numpy(), np.asarray(ref.covariance), rtol=1e-2, atol=1e-9)


def test_undistort_normalized_matches_reference():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.6, 0.6, (50, 2))
    coeffs = np.array([-0.28, 0.07, 1e-3, -5e-4, -0.01])
    np.testing.assert_array_equal(trectify.undistort_normalized(pts, coeffs), jrectify.undistort_normalized(pts, coeffs))


# ---------------------------------------------------------- pose graph


def _chain(k, step, yaw, noise, seed):
    rng = np.random.default_rng(seed)
    poses = [np.eye(4)]
    for _ in range(k - 1):
        xi = np.array([step, 0, 0, 0, 0, yaw]) + rng.normal(0, noise, 6)
        poses.append(poses[-1] @ lie.se3_exp(torch.from_numpy(xi)).numpy())
    return np.stack(poses).astype(np.float32)


@pytest.mark.parametrize("live", [32, 20])
def test_posegraph_optimize_matches_reference(live):
    k = 32
    true = _chain(live, 0.3, 2 * np.pi / live, 0.0, 0)
    drift = _chain(live, 0.3, 2 * np.pi / live, 0.02, 3)
    ei, ej, et, w = tpg.sequential_graph(drift, capacity_edges=k)
    ref_edges = jpg.sequential_graph(drift, capacity_edges=k)
    for a, b in zip((ei, ej, et, w), ref_edges):
        np.testing.assert_array_equal(a, b)
    ei[live - 1], ej[live - 1] = 0, live - 1
    et[live - 1] = np.linalg.inv(true[0]) @ true[live - 1]
    w[live - 1] = 3.0
    poses = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    poses[:live] = drift
    mask = (np.arange(k) < live).astype(np.float32)
    arrays = dict(poses=poses, node_mask=mask, edge_i=ei, edge_j=ej, edge_t=et, edge_weight=w)
    ref_poses, ref_rms = jpg.optimize(jpg.PoseGraph(**{f: jnp.asarray(v) for f, v in arrays.items()}))
    port_poses, port_rms = tpg.optimize(tpg.PoseGraph(**{f: torch.from_numpy(v) for f, v in arrays.items()}))
    np.testing.assert_allclose(port_poses.numpy(), np.asarray(ref_poses), atol=1e-4)
    np.testing.assert_allclose(float(port_rms), float(ref_rms), rtol=1e-3, atol=1e-6)
    before = np.linalg.norm(drift[-1, :3, 3] - true[-1, :3, 3])
    after = np.linalg.norm(port_poses.numpy()[live - 1, :3, 3] - true[-1, :3, 3])
    assert after < 0.3 * before
    np.testing.assert_array_equal(port_poses.numpy()[live:], poses[live:])  # padding nodes stay


def test_posegraph_consistent_chain_is_fixed_point():
    poses = _chain(8, 0.2, 0.05, 0.0, 0)
    ei, ej, et, w = tpg.sequential_graph(poses)
    graph = tpg.PoseGraph(
        poses=torch.from_numpy(poses), node_mask=torch.ones(8), edge_i=torch.from_numpy(ei),
        edge_j=torch.from_numpy(ej), edge_t=torch.from_numpy(et), edge_weight=torch.from_numpy(w),
    )
    out, rms = tpg.optimize(graph, iters=3)
    assert float(rms) < 1e-5
    np.testing.assert_allclose(out.numpy(), poses, atol=1e-4)


# ------------------------------------------------ backend and engine run

BLACKOUT = range(60, 74)
LOOP_ARGS = dict(loop_db_capacity=30, loop_exclude_recent=6, loop_cooldown_kfs=8, loop_min_votes=40, loop_min_inliers=25)


@pytest.fixture(scope="module")
def loop_run():
    """170 ticks of a revisit orbit with a blackout, the JAX package's loop
    end-to-end configuration, through the port engine; every keyframe's
    loop-closure hook call is recorded."""
    spec = SyntheticRigSpec(num_sources=2, stereo=True, width=160, height=120, fps=20.0, baseline_m=0.12)
    traj = OrbitTrajectory(radius=1.5, angular_rate=1.0)
    sources, rig_ext, _, _ = make_synthetic_rig(spec, world=SyntheticWorld(half_extents=(4.0, 4.0, 2.0)), trajectory=traj)
    engine = TorchSlamEngine(
        params=dict(max_keypoints=256, keyframe_min_inliers=40, keyframe_max_translation=0.3, keyframe_max_rotation=0.35),
        enable_ba=False, use_imu=False, light_ticks=False, device="cpu", **LOOP_ARGS,
    )
    calls = []
    hook = engine._loop.on_keyframe

    def record(world_t_body, ts, sig, map_t_odom, frame_count, **kw):
        calls.append((np.linalg.inv(map_t_odom) @ world_t_body, ts, sig, frame_count))
        return hook(world_t_body, ts, sig, map_t_odom, frame_count, **kw)

    engine._loop.on_keyframe = record
    est, world, gt = [], [], []
    gt0 = None
    with CameraRig(sources, rig_extrinsics=rig_ext) as rig:
        cal = rig.calibration
        engine.initialize(cal, SlamConfig(num_cameras=4, enable_loop_closure=True))
        for i in range(170):
            sync = rig.get_synchronized_frames()
            if i in BLACKOUT:
                for fs in sync.frame_sets.values():
                    for f in fs.frames:
                        f.image = np.zeros_like(f.image)
            pose = engine.process_frames(sync)
            g = traj.pose(sync.timestamp)
            gt0 = g if gt0 is None else gt0
            if pose is not None and i not in BLACKOUT:
                est.append(pose.position.copy())
                world.append(engine.get_world_pose(pose).position)
                gt.append((np.linalg.inv(gt0) @ g)[:3, 3])
    engine.flush()
    return dict(engine=engine, calls=calls, cal=cal, est=np.asarray(est), world=np.asarray(world), gt=np.asarray(gt))


def test_port_engine_closes_the_loop(loop_run):
    engine = loop_run["engine"]
    assert engine.loops_closed >= 1
    assert len(engine.get_map().keyframe_poses) > engine._loop.capacity
    assert np.linalg.norm(engine.map_t_odom[:3, 3]) > 1e-4
    odom = engine._tracker_state.world_t_body.numpy().astype(np.float64)
    np.testing.assert_allclose(odom[:3, 3], loop_run["est"][-1], atol=1e-5)  # the live tracker stays odom
    err_odo = np.linalg.norm(loop_run["est"][-1] - loop_run["gt"][-1])
    err_world = np.linalg.norm(loop_run["world"][-1] - loop_run["gt"][-1])
    assert err_world < 0.7 * err_odo, (err_world, err_odo)


def _replay(backend, calls):
    m = np.eye(4)
    closures = []
    for odom, ts, sig, frame_count in calls:
        res = backend.poll(block=True)
        if res is not None:
            t_corr, _, _, info = res
            closures.append((info["ci"], info["qi"], t_corr))
            m = t_corr @ m
        backend.on_keyframe(m @ odom, ts, sig, m, frame_count)
    res = backend.poll(block=True)
    if res is not None:
        closures.append((res[3]["ci"], res[3]["qi"], res[0]))
    return closures, backend


def test_loop_backend_replay_matches_reference(loop_run):
    engine = loop_run["engine"]
    args = dict(capacity=30, min_votes=40, min_inliers=25, exclude_recent=6, cooldown_kfs=8)
    ref = JaxLoopBackend(**args)
    ref.bind(jsetup.build_camera_setup(loop_run["cal"])[0], 256)
    port = LoopBackend(**args)
    port.bind(engine._setup, 256)
    port.uniform_source = _jax_draws
    ref_closures, ref = _replay(ref, loop_run["calls"])
    port_closures, port = _replay(port, loop_run["calls"])
    assert len(port_closures) >= 1
    assert [(c[0], c[1]) for c in port_closures] == [(c[0], c[1]) for c in ref_closures]
    for a, b in zip(port_closures, ref_closures):
        np.testing.assert_allclose(a[2], b[2], atol=1e-3)
    # The serialized databases agree too.
    pa, ra = port.export_arrays(), ref.export_arrays()
    assert set(pa) == set(ra)
    np.testing.assert_array_equal(pa["db_desc"], ra["db_desc"])
    np.testing.assert_allclose(pa["db_poses"], ra["db_poses"], atol=1e-3)
