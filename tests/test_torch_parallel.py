"""The port's sharded tracking (``parallel/mesh.py``) against the JAX package's.

The JAX side runs on the suite's virtual CPU devices under ``shard_map``;
the port's on virtual CPU shards (``make_camera_mesh(n, "cpu")``, 2 and 4
shards). Both
start from one state (the reference's ``init_state``, sharded on each
side) and take the same rendered ticks of the reference's flagship rig at
128x96 with 64 slots a camera, with a keyframe gate tight enough that a
tracked keyframe (inheritance across shards) comes within the 4 ticks.
Each shard's RANSAC draws are the reference's
(``uniform(fold_in(subkey, d), (H // n, n_local))``) injected into the port.

Bars: inlier and match counts, keyframe decisions and the id counter
equal, the pose to 1e-5, the same set of landmark ids, fresh ids unique
across shards; the port's sharded step within 0.02 m of its single-device
step (the reference's bar).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from thor_slam_tpu.engine import tracker as jtrk
from thor_slam_tpu.engine.pnp import project_points as jproject
from thor_slam_tpu.parallel import mesh as jmesh
from thor_slam_tpu.utils.flagship import flagship_rig, render_sequence
from thor_slam_tpu_torch.engine import convert
from thor_slam_tpu_torch.engine import tracker as ttrk
from thor_slam_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

TICKS = 4
N = 64
CPU2 = tmesh.make_camera_mesh(2, "cpu")
RUNS = {"cam": "cam_run", "slot": "slot_run", "cam4": "cam4_run", "slot4": "slot4_run"}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _port_state(state_j) -> ttrk.TrackerState:
    return convert.state_to_torch({f: np.asarray(v) for f, v in state_j._asdict().items()}, "cpu")


def _params(params_j) -> ttrk.TrackerParams:
    fields = {f.name for f in dataclasses.fields(ttrk.TrackerParams)}
    return ttrk.TrackerParams(**{k: v for k, v in params_j.__dict__.items() if k in fields})


def _rig(num_cams: int):
    params_j, setup_j, _, sources, _, _ = flagship_rig(num_cams=num_cams, width=128, height=96, max_keypoints=N)
    params_j = dataclasses.replace(params_j, keyframe_max_translation=0.02)
    seq = np.asarray(render_sequence(sources, TICKS))
    setup_t = convert.setup_to_torch({f: np.asarray(v) for f, v in setup_j._asdict().items()}, "cpu")
    return params_j, setup_j, _params(params_j), setup_t, seq


def _lockstep(num_cams: int, mode: str, n_shards: int = 2):
    params_j, setup_j, params_t, setup_t, seq = _rig(num_cams)
    mesh_j = jmesh.make_camera_mesh(n_shards)
    mesh_t = tmesh.make_camera_mesh(n_shards, "cpu")
    step_j = jmesh.make_sharded_track_step(params_j, setup_j, mesh_j, axis_mode=mode)
    step_t = tmesh.make_sharded_track_step(params_t, setup_t, mesh_t, axis_mode=mode)
    state0 = jtrk.init_state(params_j)
    state_j = jmesh.shard_state(state0, mesh_j, axis_mode=mode)
    state_t = tmesh.shard_state(_port_state(state0), mesh_t, axis_mode=mode)
    hl = params_j.ransac_hypotheses // n_shards
    n_local = num_cams * N // n_shards
    rows, first_ids = [], None
    for images in seq:
        _, subkey = jax.random.split(state_j.key)
        uniforms = [
            _t(jax.random.uniform(jax.random.fold_in(subkey, d), (hl, n_local))) for d in range(n_shards)
        ]
        state_j, out_j = step_j(state_j, jnp.asarray(images))
        state_t, out_t = step_t(state_t, _t(images), uniforms=uniforms)
        rows.append((out_j, out_t))
        if first_ids is None:  # the bootstrap keyframe: every id is fresh
            first_ids = [s.lm_id[s.lm_valid].tolist() for s in state_t.shards]
    return rows, state_j, state_t, (params_t, setup_t, seq, first_ids)


@pytest.fixture(scope="module")
def cam_run():
    return _lockstep(2, "cam")  # 2 stereo cameras, one a shard


@pytest.fixture(scope="module")
def slot_run():
    return _lockstep(1, "slot")  # 1 stereo camera, 2 x 32 slots


@pytest.fixture(scope="module")
def cam4_run():
    return _lockstep(4, "cam", 4)  # 4 stereo cameras, one a shard


@pytest.fixture(scope="module")
def slot4_run():
    return _lockstep(1, "slot", 4)  # 1 stereo camera, 4 x 16 slots


@pytest.mark.parametrize(
    "num_cams,max_keypoints,n_devices,want",
    [(6, 128, 8, "slot"), (8, 128, 8, "cam"), (2, 64, 2, "cam"), (1, 512, 2, "slot")],
)
def test_choose_axis(num_cams, max_keypoints, n_devices, want):
    assert tmesh.choose_axis(num_cams, max_keypoints, n_devices) == want
    assert jmesh.choose_axis(num_cams, max_keypoints, n_devices) == want


@pytest.mark.parametrize("args", [(6, 100, 8), (3, 5, 2)])
def test_choose_axis_rejects_indivisible(args):
    with pytest.raises(ValueError, match="divisible"):
        tmesh.choose_axis(*args)
    with pytest.raises(ValueError, match="SPMD needs"):
        tmesh.choose_axis(4, 64, 1)


def test_nothing_divisible_rejected_by_the_step():
    params = ttrk.TrackerParams(num_cams=6, height=96, width=128, max_keypoints=100)
    with pytest.raises(ValueError, match="divisible"):
        tmesh.make_sharded_track_step(params, None, tmesh.make_camera_mesh(8, "cpu"))


def test_make_camera_mesh():
    assert tmesh.make_camera_mesh(3, "cpu").devices == (torch.device("cpu"),) * 3
    mesh = tmesh.make_camera_mesh(devices=["cpu", "cpu"])
    assert mesh.size == 2 and mesh.axis_names == ("d",)
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="devices"):
            tmesh.make_camera_mesh(2)


@pytest.mark.parametrize("mode", ["cam", "slot"])
def test_shard_gather_round_trip(mode):
    params = ttrk.TrackerParams(num_cams=2, height=16, width=24, max_keypoints=8)
    gen = torch.Generator().manual_seed(3)
    full = ttrk.init_state(params, "cpu")
    full = full._replace(
        lm_pos_w=torch.randn((2, 8, 3), generator=gen),
        lm_id=torch.arange(16, dtype=torch.int32).reshape(2, 8),
        prev_left0=torch.rand((2, 16, 24), generator=gen),
    )
    sharded = tmesh.shard_state(full, CPU2, mode)
    dim = 0 if mode == "cam" else 1
    assert sharded.shards[1].lm_pos_w.shape[dim] == full.lm_pos_w.shape[dim] // 2
    assert sharded.shards[1].prev_left0.shape[0] == (1 if mode == "cam" else 2)  # pyramids: slot mode replicates
    back = tmesh.gather_state(sharded)
    for f in ttrk.TrackerState._fields:
        torch.testing.assert_close(getattr(back, f), getattr(full, f), rtol=0, atol=0)
    assert torch.equal(sharded.lm_id, full.lm_id)  # a sharded field reads gathered
    moved = sharded._replace(lm_id=full.lm_id + 100, world_t_body=2 * full.world_t_body)
    assert torch.equal(moved.shards[1].lm_id, (full.lm_id + 100).chunk(2, dim)[1])
    assert all(torch.equal(s.world_t_body, 2 * full.world_t_body) for s in moved.shards)
    assert torch.equal(sharded.lm_id, full.lm_id)  # _replace makes a new state


def test_collectives():
    xs = [torch.tensor([1.0, 5.0]), torch.tensor([3.0, 2.0])]
    for y in tmesh.psum(xs):
        assert torch.equal(y, torch.tensor([4.0, 7.0]))
    for y in tmesh.pmax(xs):
        assert torch.equal(y, torch.tensor([3.0, 5.0]))
    a, b = torch.arange(6).reshape(2, 3), torch.arange(6, 12).reshape(2, 3)
    stacked = tmesh.all_gather([a, b])
    tiled = tmesh.all_gather([a, b], axis=1, tiled=True)
    assert stacked[0].shape == (2, 2, 3) and torch.equal(stacked[1][1], b)
    assert torch.equal(tiled[1], torch.cat([a, b], 1))


def test_distributed_ransac_pnp_matches_jax():
    """Both distributed solvers on the same correspondences and draws (2
    shards of 48; 20 % outliers): the same pose, inliers and covariance."""
    rng = np.random.default_rng(5)
    n = 96
    pts = rng.uniform([-2, -1, 3], [2, 1, 8], (n, 3)).astype(np.float32)
    rot = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    trans = np.zeros((n, 3), np.float32)
    rot[n // 2 :] = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], np.float32)  # a second camera, yawed
    pts[n // 2 :] = pts[n // 2 :][:, [2, 1, 0]] * np.array([1, 1, -1], np.float32)
    truth = np.eye(4, dtype=np.float32)
    truth[:3, 3] = [0.05, -0.02, 0.1]
    _, _, uv = jproject(jnp.asarray(truth), jnp.asarray(pts), jnp.asarray(rot), jnp.asarray(trans))
    obs = np.asarray(uv) + rng.normal(0, 1e-3, (n, 2)).astype(np.float32)
    obs[rng.choice(n, n // 5, replace=False)] += 0.2
    valid = rng.uniform(size=n) > 0.1
    init = np.eye(4, dtype=np.float32)
    thr = np.float32(0.01)
    hl = 8
    key = jax.random.PRNGKey(7)

    def body(p, o, v, r, t):
        return jmesh._distributed_ransac_pnp(
            key, p, o, v, r, t, jnp.asarray(init), thr, axis_name=jmesh.AXIS, hyp_per_device=hl
        )

    mesh_j = jmesh.make_camera_mesh(2)
    fn = jax.jit(jax.shard_map(
        body, mesh=mesh_j, in_specs=(P(jmesh.AXIS),) * 5,
        out_specs=(P(), P(jmesh.AXIS), P(), P(), P()), check_vma=False,
    ))
    x_j, inl_j, num_j, rms_j, cov_j = fn(*(jnp.asarray(a) for a in (pts, obs, valid, rot, trans)))
    uniforms = [_t(jax.random.uniform(jax.random.fold_in(key, d), (hl, n // 2))) for d in range(2)]
    halves = [[_t(a[: n // 2]), _t(a[n // 2 :])] for a in (pts, obs, valid, rot, trans)]
    res = tmesh._distributed_ransac_pnp(
        *halves, [_t(init)] * 2, [torch.tensor(thr)] * 2, hyp_per_device=hl, uniforms=uniforms
    )
    assert int(res.num_inliers[0]) == int(num_j) and int(res.num_inliers[1]) == int(num_j)
    np.testing.assert_array_equal(torch.cat(res.inliers).numpy(), np.asarray(inl_j))
    for k in range(2):
        np.testing.assert_allclose(res.body_t_world[k].numpy(), np.asarray(x_j), atol=1e-5)
        np.testing.assert_allclose(res.rms_error[k].numpy(), np.asarray(rms_j), rtol=1e-4)
        np.testing.assert_allclose(res.covariance[k].numpy(), np.asarray(cov_j), rtol=1e-3, atol=1e-12)
    np.testing.assert_allclose(res.body_t_world[0].numpy()[:3, 3], truth[:3, 3], atol=0.01)


def _assert_lockstep(rows, state_j, state_t):
    for i, (out_j, out_t) in enumerate(rows):
        assert int(out_t.num_inliers) == int(out_j.num_inliers), f"tick {i}"
        assert int(out_t.num_matches) == int(out_j.num_matches), f"tick {i}"
        assert int(out_t.num_landmarks) == int(out_j.num_landmarks), f"tick {i}"
        assert bool(out_t.refreshed) == bool(out_j.refreshed), f"tick {i}"
        np.testing.assert_allclose(out_t.world_t_body.numpy(), np.asarray(out_j.world_t_body), atol=1e-5)
    assert int(state_t.lm_id_counter) == int(np.asarray(state_j.lm_id_counter))
    ids_j = np.asarray(state_j.lm_id)[np.asarray(state_j.lm_valid)]
    ids_t = state_t.lm_id.numpy()[state_t.lm_valid.numpy()]
    assert set(ids_t.tolist()) == set(ids_j.tolist())
    assert sum(bool(o.refreshed) for o, _ in rows[1:]) >= 1, "no tracked keyframe in the run"
    assert int(rows[-1][1].num_inliers) >= 12


@pytest.mark.parametrize("run", ["cam", "cam4"])
def test_cam_sharded_step_matches_jax(run, request):
    rows, state_j, state_t, _ = request.getfixturevalue(RUNS[run])
    _assert_lockstep(rows, state_j, state_t)


@pytest.mark.parametrize("run", ["slot", "slot4"])
def test_slot_sharded_step_matches_jax(run, request):
    rows, state_j, state_t, _ = request.getfixturevalue(RUNS[run])
    _assert_lockstep(rows, state_j, state_t)


@pytest.mark.parametrize("mode", ["cam", "slot", "cam4", "slot4"])
def test_landmark_ids_unique_across_shards(mode, request):
    """Fresh ids never collide across shards. In cam mode a camera
    inherits only its own landmarks, so its shard's ids stay its own; in
    slot mode a slot may inherit a landmark of another shard, so the
    bootstrap keyframe (every id fresh) is where the ranges show."""
    rows, _, state_t, (*_, first_ids) = request.getfixturevalue(RUNS[mode])
    ids = [s.lm_id[s.lm_valid].tolist() for s in state_t.shards] if mode.startswith("cam") else first_ids
    # Within a shard two detections may inherit one landmark, as on one
    # device; across shards no id repeats.
    sets = [set(i) for i in ids]
    assert len(sets) == state_t.mesh.size and all(sets), "a shard without landmarks"
    for a in range(len(sets)):
        for b in range(a + 1, len(sets)):
            assert not sets[a] & sets[b], f"a landmark id on shards {a} and {b}"
    # The counter advanced by the global mint count at every keyframe.
    kfs = sum(bool(o.refreshed) for _, o in rows)
    assert int(state_t.lm_id_counter) == kfs * state_t.lm_id.numel()


def test_pose_prediction_accepted(slot_run):
    _, _, _, (params, setup, seq, _) = slot_run
    step = tmesh.make_sharded_track_step(params, setup, CPU2, axis_mode="slot")
    state = tmesh.shard_state(ttrk.init_state(params, "cpu"), CPU2, "slot")
    gens = tmesh.shard_generators(CPU2, 0)
    state, out = step(state, _t(seq[0]), generators=gens)
    state, out = step(state, _t(seq[1]), generators=gens, pose_prediction=out.world_t_body)
    assert torch.isfinite(out.world_t_body).all()
    assert int(out.num_inliers) >= params.min_track_inliers


@pytest.mark.parametrize("mode", ["cam", "slot", "cam4", "slot4"])
def test_sharded_step_near_single_device(mode, request):
    """The distributed solver against the batched RANSAC of ``track_step``
    on the same frames: near, not equal (the reference's 0.02 m)."""
    rows, _, _, (params, setup, seq, _) = request.getfixturevalue(RUNS[mode])
    state = ttrk.init_state(params, "cpu")
    gen = torch.Generator().manual_seed(0)
    dists = []
    for images, (_, out_sharded) in zip(seq, rows):
        state, out = ttrk.track_step(params, setup, state, _t(images), generator=gen)
        pos = out.world_t_body.numpy()[:3, 3]
        dists.append(float(np.linalg.norm(pos - out_sharded.world_t_body.numpy()[:3, 3])))
    print(f"{mode}: largest sharded - single-device position difference {max(dists):.6f} m")
    assert dists[-1] < 0.02


def test_packed_returns(slot_run):
    _, _, _, (params, setup, seq, _) = slot_run
    step = tmesh.make_sharded_track_step(params, setup, CPU2, pack="ba+kf")
    state = tmesh.shard_state(ttrk.init_state(params, "cpu"), CPU2, "slot")
    state, out, packed, ba_obs, kf_sig = step(state, _t(seq[0]), generators=tmesh.shard_generators(CPU2, 0))
    assert packed.shape == (ttrk.PACKED_LEN,) and ttrk.unpack_output(packed)["refreshed"]
    assert ba_obs.shape == (1, N, 10) and kf_sig.shape == (1, N, 14)
    np.testing.assert_array_equal(ttrk.unpack_ba_obs(ba_obs)["ids"], state.lm_id.numpy())
