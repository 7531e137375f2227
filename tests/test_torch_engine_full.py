"""TorchSlamEngine at its defaults against TpuSlamEngine at its defaults.

Both engines run bundle adjustment, IMU fusion with the accelerometer term
and loop closure (their defaults) over the same 70 rendered ticks of a
2-camera stereo rig at 160x120 with an IMU on source 0. Light ticks are
off in both (tests/test_torch_light.py holds them against each other). Bars: both ATEs
under 5 cm and within 1 cm of each other (RANSAC draws differ), BA solved
at least twice in both, the two gravity estimates within 5 degrees.

Then the maps: a map saved by either engine loads in the other with every
array intact, and a fresh port engine on a rig whose clocks start 1 s
later relocalizes against the JAX engine's saved map and tracks in its
frame within 5 cm.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from thor_slam_tpu.camera.rig import CameraRig
from thor_slam_tpu.camera.sources.synthetic import (
    GRAVITY_W,
    OrbitTrajectory,
    SyntheticRigSpec,
    SyntheticWorld,
    make_synthetic_rig,
)
from thor_slam_tpu.engine.tpu_engine import TpuSlamEngine
from thor_slam_tpu.slam.interface import SlamConfig
from thor_slam_tpu.utils.evaluation import ate_rmse
from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
from thor_slam_tpu_torch.ops import fast_cuda, patches_cuda
from thor_slam_tpu_torch.slam.interface import TrackingState as PortState

torch.set_num_threads(2)

TICKS = 70
# The keyframe spacing and loop candidates of chip_smoke.py's full-engine
# phase (FULL_PARAMS, FULL_ENGINE_ARGS), the same in both engines.
PARAMS = dict(max_keypoints=256, keyframe_min_inliers=40, keyframe_max_translation=0.3, keyframe_max_rotation=0.35)
ENGINE_ARGS = dict(loop_exclude_recent=30, imu_buffer_capacity=512)
SPEC = SyntheticRigSpec(num_sources=2, stereo=True, width=160, height=120, fps=30.0, baseline_m=0.12)
WORLD = SyntheticWorld(half_extents=(4.0, 4.0, 2.0))
TRAJ = OrbitTrajectory(radius=1.5, angular_rate=0.5)


def _ba_solved(d: dict) -> bool:
    """The window was solved: applied, or withheld by an acceptance gate."""
    return "ba_rms" in d or str(d.get("ba_skip", "")).startswith(("rms", "corr"))


def _run(engine, frames, calibration):
    engine.initialize(calibration, SlamConfig(num_cameras=4))
    gt0 = TRAJ.pose(frames[0].timestamp)
    est, gt, states, solved = [], [], [], 0
    for fs in frames:
        pose = engine.process_frames(fs)
        states.append(engine.get_tracking_state().name)  # each package has its own enum
        solved += _ba_solved(engine.last_diagnostics)
        if pose is not None:
            est.append(pose.position.copy())
            gt.append((np.linalg.inv(gt0) @ TRAJ.pose(fs.timestamp))[:3, 3])
    g_true = np.linalg.inv(gt0)[:3, :3] @ GRAVITY_W
    return dict(
        ate=ate_rmse(np.asarray(est), np.asarray(gt)), states=states, solved=solved,
        gravity=engine._imu.gravity_w, gravity_n=engine._imu.gravity_n, g_true=g_true,
        diag=dict(engine.last_diagnostics), gt0=gt0,
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    sources, rig_ext, _, _ = make_synthetic_rig(SPEC, world=WORLD, trajectory=TRAJ)
    with CameraRig(sources, rig_extrinsics=rig_ext, imu_source=sources[0].name) as rig:
        calibration = rig.calibration
        frames = [rig.get_synchronized_frames() for _ in range(TICKS)]
    ref = TpuSlamEngine(params=PARAMS, light_ticks=False, adaptive_half_res=False, **ENGINE_ARGS)
    port = TorchSlamEngine(params=PARAMS, device="cpu", light_ticks=False, **ENGINE_ARGS)
    out = dict(ref=_run(ref, frames, calibration), port=_run(port, frames, calibration))
    tmp = tmp_path_factory.mktemp("maps")
    out["ref_map"], out["port_map"] = str(tmp / "ref_map"), str(tmp / "port_map")
    assert ref.save_map(out["ref_map"]) and port.save_map(out["port_map"])
    out.update(ref_engine=ref, port_engine=port, calibration=calibration, frames=frames)
    return out


def test_defaults_match_the_reference():
    import inspect

    ref = inspect.signature(TpuSlamEngine.__init__).parameters
    port = inspect.signature(TorchSlamEngine.__init__).parameters
    shared = [n for n in ref if n not in ("self", "devices")]
    assert len(shared) == 29
    for name in shared:
        assert name in port, name
        assert port[name].default == ref[name].default, name
    # None resolves as the reference's does: light ticks (and the adaptive
    # controller) on for one device.
    sources, rig_ext, _, _ = make_synthetic_rig(SyntheticRigSpec(num_sources=1, stereo=True, width=64, height=48),
                                                render=False)
    engine = TorchSlamEngine(device="cpu")
    engine.initialize(CameraRig(sources, rig_extrinsics=rig_ext).calibration, SlamConfig(num_cameras=2))
    assert engine._light_ctl.light and engine._light_ctl.adaptive and not engine._pipelined
    engine.shutdown()


def test_ate_under_bar_and_close_to_reference(runs):
    ref, port = runs["ref"], runs["port"]
    assert port["ate"] < 0.05 and ref["ate"] < 0.05
    assert abs(port["ate"] - ref["ate"]) <= 0.01
    for r in (ref, port):
        first = r["states"].index("TRACKING")
        assert first <= 3
        assert np.mean([s == "TRACKING" for s in r["states"][first:]]) >= 0.9


def test_ba_solved_in_both(runs):
    assert runs["port"]["solved"] >= 2 and runs["ref"]["solved"] >= 2


def test_gravity_estimates_agree(runs):
    port, ref = runs["port"], runs["ref"]
    assert port["gravity_n"] >= 30 and ref["gravity_n"] >= 30
    g, r = port["gravity"], ref["gravity"]
    angle = np.degrees(np.arccos(np.clip(g @ r / (np.linalg.norm(g) * np.linalg.norm(r)), -1, 1)))
    assert angle < 5.0, angle
    assert 8.0 < np.linalg.norm(g) < 12.0
    assert port["diag"]["accel_pred"] is True and np.isfinite(port["diag"]["imu_pred_err_m"])
    assert runs["port_engine"].imu_empty_windows == 0


def test_cpu_engine_uses_plain_versions(runs):
    # The module's runs went through the plain versions on the CPU only.
    assert patches_cuda.counts["kernel"] == 0 and fast_cuda.counts["kernel"] == 0


@pytest.fixture(scope="module")
def fresh_ref(runs):
    """A second JAX engine on the same rig (its initialize compiles once)."""
    ref = TpuSlamEngine(params=PARAMS, light_ticks=False, adaptive_half_res=False, **ENGINE_ARGS)
    ref.initialize(runs["calibration"], SlamConfig(num_cameras=4))
    return ref


def _loaded(engine_cls, path, calibration, **kwargs):
    engine = engine_cls(params=PARAMS, **ENGINE_ARGS, **kwargs)
    engine.initialize(calibration, SlamConfig(num_cameras=4))
    assert engine.load_map(path)
    return engine


def _map_arrays(engine):
    st = engine._tracker_state
    as_np = (lambda x: x.detach().cpu().numpy()) if isinstance(st.lm_pos_w, torch.Tensor) else np.asarray
    desc = as_np(st.lm_desc)
    return dict(
        lm_pos_w=as_np(st.lm_pos_w), lm_desc=desc.view(np.uint32), lm_valid=as_np(st.lm_valid),
        keyframes=np.stack([p.to_4x4_matrix() for p in engine._keyframe_poses]),
        **engine._loop.export_arrays(),
    )


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_maps_round_trip_between_engines(runs, fresh_ref, direction):
    src = "port" if direction == "port_to_ref" else "ref"
    saved = np.load(runs[f"{src}_map"] + ".npz")
    assert saved["lm_desc"].dtype == np.uint32
    if direction == "port_to_ref":
        dst = fresh_ref
        assert dst.load_map(runs["port_map"])
    else:
        dst = _loaded(TorchSlamEngine, runs["ref_map"], runs["calibration"], device="cpu")
    got = _map_arrays(dst)
    for key in ("lm_pos_w", "lm_desc", "lm_valid", "db_desc", "db_valid", "db_lm_w", "db_poses", "db_ts"):
        np.testing.assert_array_equal(got[key], saved[key], err_msg=key)
    # Keyframes pass through SlamPose's quaternion: f64 round-off.
    np.testing.assert_allclose(got["keyframes"], saved["keyframes"], rtol=0, atol=1e-12)
    assert len(dst._loop.db) >= 3 and dst._map_loaded


def test_relocalizes_against_the_reference_map(runs):
    """save_map (JAX engine) -> fresh port engine on a rig starting 1 s
    later on the same trajectory -> load_map -> relocalize -> 10 ticks."""
    sources, rig_ext, _, _ = make_synthetic_rig(SPEC, world=WORLD, trajectory=TRAJ, clock_offsets=(1.0, 1.0))
    gt0 = runs["ref"]["gt0"]
    with CameraRig(sources, rig_extrinsics=rig_ext, imu_source=sources[0].name) as rig:
        engine = _loaded(TorchSlamEngine, runs["ref_map"], rig.calibration, device="cpu")
        assert engine.relocalize()
        assert engine.get_tracking_state() == PortState.RELOCALIZING
        errs = []
        for _ in range(10):
            sync = rig.get_synchronized_frames()
            pose = engine.process_frames(sync)
            if pose is not None:
                errs.append(np.linalg.norm(pose.position - (np.linalg.inv(gt0) @ TRAJ.pose(sync.timestamp))[:3, 3]))
    assert not engine._want_reloc  # relocalization succeeded
    assert engine.get_tracking_state() == PortState.TRACKING
    assert np.median(errs) < 0.05, errs
    assert len(engine.get_landmark_cloud()) > len(engine.get_map().points)


def test_save_load_state_round_trip(runs, fresh_ref, tmp_path):
    engine = runs["port_engine"]
    path = str(tmp_path / "state")
    assert engine.save_state(path)
    before = {f: getattr(engine._tracker_state, f).clone() for f in ("lm_pos_w", "world_t_body", "lm_desc", "lm_id")}
    engine.reset()
    assert engine.load_state(path)
    for f, v in before.items():
        torch.testing.assert_close(getattr(engine._tracker_state, f), v, rtol=0, atol=0)
    # The JAX engine restores the port's checkpoint too.
    ref = fresh_ref
    assert ref.load_state(path)
    np.testing.assert_array_equal(np.asarray(ref._tracker_state.lm_pos_w), before["lm_pos_w"].numpy())
    np.testing.assert_array_equal(np.asarray(ref._tracker_state.lm_desc).view(np.int32), before["lm_desc"].numpy())
