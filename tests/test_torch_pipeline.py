"""Pipelined ticks of the port's engine: any depth, ``defer_sync``, the
correction-epoch lift, and the engine's lifecycle with ticks in flight.

* Depth 1 gives the synchronous engine's poses exactly, one call later:
  the device work, the RANSAC draws and every backend (BA, the IMU shadow)
  run in the same order.
* Depth 3 keeps the reference's latency contract, depth 4 with every
  backend on its bars against depth 1 (tests/test_engine_pipeline_deep.py).
* A record dispatched before a BA correction is lifted into the corrected
  frame at its finalize: pose, covariance and the position channels of its
  BA observations and keyframe signature, as the reference's
  ``_finalize_values`` lifts them.
* ``defer_sync`` returns nothing until ``flush`` and then the synchronous
  run's poses; its four refusals are the reference's.

Rig: 2 stereo cameras at 160x120 with an IMU on source 0. Every engine pins
``adaptive_half_res=False`` (a CPU tick can fall in the controller's
real-time band).
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from thor_slam_tpu.engine import tracker as jtrk
from thor_slam_tpu.engine.tpu_engine import TpuSlamEngine
from thor_slam_tpu_torch.camera.rig import CameraRig
from thor_slam_tpu_torch.camera.sources.synthetic import (
    OrbitTrajectory,
    SyntheticRigSpec,
    SyntheticWorld,
    make_synthetic_rig,
)
from thor_slam_tpu_torch.engine import tracker as ttrk
from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
from thor_slam_tpu_torch.slam.interface import SlamConfig
from thor_slam_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(2)

TICKS = 60
PARAMS = dict(max_keypoints=256, keyframe_min_inliers=40)
TRAJ = OrbitTrajectory(radius=1.5, angular_rate=0.5)


@pytest.fixture(scope="module")
def rig():
    spec = SyntheticRigSpec(num_sources=2, stereo=True, width=160, height=120, fps=30.0, baseline_m=0.12)
    sources, rig_ext, _, _ = make_synthetic_rig(spec, world=SyntheticWorld(half_extents=(4.0, 4.0, 2.0)), trajectory=TRAJ)
    with CameraRig(sources, rig_extrinsics=rig_ext, imu_source=sources[0].name) as r:
        cal = r.calibration
        frames = [r.get_synchronized_frames() for _ in range(TICKS)]
    return dict(cal=cal, frames=frames)


def _ba_solved(d: dict) -> bool:
    """A window was solved: applied, or withheld by an acceptance gate."""
    return "ba_rms" in d or ("ba_skip" in d and not str(d["ba_skip"]).startswith(("window", "joined")))


def _run(rig, ticks=TICKS, config=None, **kwargs):
    engine = TorchSlamEngine(params=PARAMS, device="cpu", adaptive_half_res=False, **kwargs)
    engine.initialize(rig["cal"], config or SlamConfig(num_cameras=4))
    frames = rig["frames"][:ticks]
    gt0 = TRAJ.pose(frames[0].timestamp)
    # Every finalized tick's diagnostics: one call may finalize several.
    diags = []
    finalize = engine._finalize_values

    def logged(rec):
        pose = finalize(rec)
        diags.append(dict(engine.last_diagnostics))
        return pose

    engine._finalize_values = logged
    returned = [engine.process_frames(fs) for fs in frames]
    tail = engine.flush()
    solved = sum(_ba_solved(d) for d in diags)
    stream = [p for p in returned if p is not None] + ([tail] if tail is not None else [])
    est = np.asarray([p.position for p in stream])
    gt = np.asarray([(np.linalg.inv(gt0) @ TRAJ.pose(p.timestamp))[:3, 3] for p in stream])
    out = dict(
        returned=returned, tail=tail, stream=stream, solved=solved, ate=ate_rmse(est, gt) if len(stream) > 2 else None,
        empty=engine.imu_empty_windows, engine=engine, kf=len(engine.get_map().keyframe_poses),
    )
    engine.shutdown()
    return out


def _matrices(poses):
    return [None if p is None else p.to_4x4_matrix() for p in poses]


def test_depth_one_equals_the_synchronous_engine_one_call_later(rig):
    """BA, the IMU with accel and loop closure on, light ticks off (their
    scheduler reads the finalized state one tick later when pipelined)."""
    sync = _run(rig, ticks=40, light_ticks=False)
    pipe = _run(rig, ticks=40, light_ticks=False, pipelined=True)
    assert sync["solved"] >= 1 and sync["tail"] is None
    assert pipe["returned"][0] is None
    want, got = _matrices(sync["returned"]), _matrices(pipe["returned"][1:] + [pipe["tail"]])
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), k
        if g is not None:
            np.testing.assert_array_equal(g, w, err_msg=f"tick {k}")
    assert pipe["kf"] == sync["kf"]


def test_latency_contract_at_depth_three(rig):
    """At depth 3 the first 3 calls return None, then poses stream in
    timestamp order; flush returns the last tick's pose."""
    r = _run(rig, ticks=8, pipelined=True, pipeline_depth=3)
    assert all(p is None for p in r["returned"][:3])
    assert len(r["stream"]) >= 2
    ts = [p.timestamp for p in r["stream"]]
    assert ts == sorted(ts)
    assert r["tail"] is not None and r["tail"].timestamp == rig["frames"][7].timestamp


def test_depth_four_with_every_backend(rig):
    """BA, IMU and loop closure at depth 4 against depth 1: BA solves at
    both, IMU windows are not empty, and the ATE holds (the reference's
    bars)."""
    d1 = _run(rig, pipelined=True, pipeline_depth=1)
    d4 = _run(rig, pipelined=True, pipeline_depth=4)
    assert d4["engine"]._config.enable_loop_closure
    assert all(p is None for p in d4["returned"][:4])
    assert d1["solved"] >= 1 and d4["solved"] >= 1
    assert d1["empty"] <= 2 and d4["empty"] <= 2
    assert d4["ate"] < 1.5 * d1["ate"] + 0.02, (d4["ate"], d1["ate"])
    assert d4["engine"]._imu._pred_capacity == 64 * 4


def _lift_record(rng, c=2, n=16):
    """A fetched record whose dispatch-time epoch is stale."""
    from thor_slam_tpu_torch import geometry

    def rigid(scale):
        q = rng.normal(size=4)
        return geometry.se3_matrix(geometry.quat_to_matrix(q / np.linalg.norm(q)), rng.normal(scale=scale, size=3))

    cov = np.cov(rng.normal(size=(6, 12)))
    packed = np.concatenate([rigid(1.0).ravel(), [80, 90, 100, 0.001, 0], cov.ravel()]).astype(np.float32)
    rec = dict(
        packed=packed, ba_obs=rng.normal(size=(c, n, 10)).astype(np.float32),
        kf_sig=rng.normal(size=(c, n, 14)).astype(np.float32), ts=1.0, pred=None, stale_sources=frozenset(),
        light=False, half=False, mono_bootstrap=None, event=None, corr_epoch=rigid(0.05),
    )
    return rec, rigid(0.05) @ rec["corr_epoch"]


def test_epoch_lift_matches_the_reference():
    """The same stale record through the port's and the reference's
    ``_finalize_values`` (engines constructed, not initialized): pose,
    covariance and the position channels come out lifted alike."""
    rec_t, total = _lift_record(np.random.default_rng(7))
    rec_j = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in rec_t.items()}
    port = TorchSlamEngine(device="cpu", enable_ba=False, use_imu=False)
    ref = TpuSlamEngine(enable_ba=False, use_imu=False)
    port._params = ttrk.TrackerParams(num_cams=2, height=120, width=160)
    ref._params = jtrk.TrackerParams(num_cams=2, height=120, width=160)
    port._ba_corr_total = total
    ref._ba_corr_total = total.copy()
    pose_t = port._finalize_values(rec_t)
    pose_j = ref._finalize_values(rec_j, rec_j["packed"])
    np.testing.assert_allclose(pose_t.to_4x4_matrix(), pose_j.to_4x4_matrix(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(pose_t.covariance, pose_j.covariance, rtol=0, atol=1e-12)
    lifted = total @ np.linalg.inv(rec_t["corr_epoch"]) @ rec_t["packed"][:16].reshape(4, 4).astype(np.float64)
    np.testing.assert_allclose(pose_t.to_4x4_matrix(), lifted, atol=1e-6)  # through SlamPose's quaternion
    for key in ("ba_obs", "kf_sig"):
        np.testing.assert_array_equal(rec_t[key], rec_j[key], err_msg=key)
    # Only the position channels moved.
    raw, _ = _lift_record(np.random.default_rng(7))
    np.testing.assert_array_equal(rec_t["ba_obs"][..., :7], raw["ba_obs"][..., :7])
    np.testing.assert_array_equal(rec_t["kf_sig"][..., :11], raw["kf_sig"][..., :11])
    assert not np.allclose(rec_t["ba_obs"][..., 7:10], raw["ba_obs"][..., 7:10])


def test_current_epoch_is_not_lifted():
    rec, _ = _lift_record(np.random.default_rng(8))
    port = TorchSlamEngine(device="cpu", enable_ba=False, use_imu=False)
    port._params = ttrk.TrackerParams(num_cams=2, height=120, width=160)
    port._ba_corr_total = rec["corr_epoch"]
    raw = rec["ba_obs"].copy()
    pose = port._finalize_values(rec)
    np.testing.assert_allclose(pose.to_4x4_matrix(), rec["packed"][:16].reshape(4, 4), atol=1e-6)
    assert rec["ba_obs"] is not raw and np.array_equal(rec["ba_obs"], raw)


def test_defer_sync_gives_the_synchronous_poses_at_flush(rig, caplog):
    vo = dict(enable_ba=False, use_imu=False)
    sync = _run(rig, ticks=30, light_ticks=False, **vo)
    with caplog.at_level("WARNING", logger="thor_slam_tpu_torch.engine.torch_engine"):
        engine = TorchSlamEngine(params=PARAMS, device="cpu", pipelined=True, defer_sync=True, **vo)
        engine.initialize(rig["cal"], SlamConfig(num_cameras=4))
    assert "disabling loop closure" in caplog.text and not engine._config.enable_loop_closure
    assert not engine._light_ctl.light  # light ticks resolve off under defer_sync
    assert all(engine.process_frames(fs) is None for fs in rig["frames"][:30])
    tail = engine.flush()
    poses = engine.last_flush_poses
    assert len(poses) == 30 and tail is poses[-1]
    for k, (got, want) in enumerate(zip(_matrices(poses), _matrices(sync["returned"]))):
        np.testing.assert_array_equal(got, want, err_msg=f"tick {k}")
    engine.shutdown()


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(pipelined=True, pipeline_depth=0), "pipeline_depth"),
        (dict(defer_sync=True, enable_ba=False, use_imu=False), "requires pipelined"),
        (dict(pipelined=True, defer_sync=True, use_imu=False), "enable_ba"),
        (dict(pipelined=True, defer_sync=True, enable_ba=False), "use_imu"),
    ],
)
def test_mode_arguments_refused_like_the_reference(kwargs, match):
    with pytest.raises(ValueError, match=match):
        TpuSlamEngine(**kwargs)
    with pytest.raises(ValueError, match=match):
        TorchSlamEngine(device="cpu", **kwargs)


def _uploader_threads():
    return [t for t in threading.enumerate() if t.name.startswith("uploader") and t.is_alive()]


def test_reset_and_shutdown_with_ticks_in_flight(rig):
    before = len(_uploader_threads())
    engine = TorchSlamEngine(params=PARAMS, device="cpu", pipelined=True, pipeline_depth=3, adaptive_half_res=False)
    engine.initialize(rig["cal"], SlamConfig(num_cameras=4, enable_loop_closure=False))
    for fs in rig["frames"][:5]:
        engine.process_frames(fs)
    assert len(engine._pending_q) > 0 and len(_uploader_threads()) == before + 1
    engine.reset()
    assert len(engine._pending_q) == 0 and len(_uploader_threads()) == before
    assert engine.upload_stats == {"full": 0, "light": 0, "light_half": 0, "bytes": 0}
    # The engine runs again from a fresh state, with a new uploader.
    returned = [engine.process_frames(fs) for fs in rig["frames"][:4]]
    assert returned[:3] == [None] * 3 and returned[3].timestamp == rig["frames"][2].timestamp
    assert engine._frame_count == 3
    engine.shutdown()
    assert len(engine._pending_q) == 0 and len(_uploader_threads()) == before
    with pytest.raises(RuntimeError):
        engine.process_frames(rig["frames"][0])
