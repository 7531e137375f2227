"""``TorchSlamEngine(devices=N)``: tracking over several devices as an
engine capability, on two virtual CPU shards.

The counterparts of the JAX package's ``tests/test_engine_spmd.py``: the
engine API with the host backends (IMU fusion, track-level BA, loop
closure) running against the sharded state, held to the single-device
engine on the same frames; and ``dryrun_multidevice``, the port's
``dryrun_multichip``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from thor_slam_tpu_torch.camera.rig import CameraRig
from thor_slam_tpu_torch.camera.sources.synthetic import (
    OrbitTrajectory,
    SyntheticRigSpec,
    SyntheticWorld,
    make_synthetic_rig,
)
from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
from thor_slam_tpu_torch.parallel import ShardedTrackerState
from thor_slam_tpu_torch.parallel.dryrun import dryrun_multidevice
from thor_slam_tpu_torch.slam.interface import SlamConfig, TrackingState
from thor_slam_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(2)


def _run_engine(devices, num_sources, frames=40, width=128, height=96, **engine_kw):
    spec = SyntheticRigSpec(
        num_sources=num_sources, stereo=True, width=width, height=height, fps=30.0, baseline_m=0.12
    )
    world = SyntheticWorld(half_extents=(4.0, 4.0, 2.0))
    traj = OrbitTrajectory(radius=1.5, angular_rate=0.5)
    sources, rig_ext, _, _ = make_synthetic_rig(spec, world=world, trajectory=traj)
    engine = TorchSlamEngine(
        params=dict(max_keypoints=128, keyframe_min_inliers=40),
        devices=devices, device="cpu", adaptive_half_res=False, **engine_kw,
    )
    est, gt, states, diags = [], [], [], []
    gt0 = None
    imu = engine_kw.get("use_imu", True)
    with CameraRig(sources, rig_extrinsics=rig_ext, imu_source=sources[0].name if imu else None) as rig:
        engine.initialize(rig.calibration, SlamConfig(num_cameras=2 * num_sources))
        for _ in range(frames):
            sync = rig.get_synchronized_frames()
            pose = engine.process_frames(sync)
            diags.append(engine.last_diagnostics)
            g = traj.pose(sync.timestamp)
            if gt0 is None:
                gt0 = g
            if pose is not None:
                est.append(pose.position.copy())
                gt.append((np.linalg.inv(gt0) @ g)[:3, 3])
                states.append(pose.tracking_state)
    engine.diagnostics_by_tick = diags
    return engine, np.asarray(est), np.asarray(gt), states


def test_slot_sharded_single_camera_matches_single_device():
    """1 stereo camera over 2 shards (the EuRoC layout, slot sharding) with
    the default feature set (BA + IMU + loop) against the single device."""
    eng2, est2, gt2, states2 = _run_engine(devices=2, num_sources=1)
    eng1, est1, gt1, _ = _run_engine(devices=1, num_sources=1)
    assert TrackingState.TRACKING in states2
    ate2, ate1 = ate_rmse(est2, gt2), ate_rmse(est1, gt1)
    # Different robust solvers (batched RANSAC against the distributed
    # consensus): near-equal accuracy, not equality.
    assert ate2 < max(2.0 * ate1, 0.02), f"sharded ATE {ate2:.4f} vs single {ate1:.4f}"
    assert eng2._mesh is not None and eng2._mesh.size == 2 and eng2._step.axis_mode == "slot"
    assert isinstance(eng2._tracker_state, ShardedTrackerState)


def test_cam_sharded_rig_runs_ba_and_imu():
    """2 stereo cameras over 2 shards (camera sharding) with BA and the IMU
    against the sharded state."""
    eng, est, gt, states = _run_engine(devices=2, num_sources=2, frames=30)
    assert eng._step.axis_mode == "cam"
    assert TrackingState.TRACKING in states
    assert ate_rmse(est, gt) < 0.05
    # BA ran against the sharded state (at a keyframe: each tick's own
    # diagnostics).
    assert any("ba_rms" in d or "ba_skip" in d for d in eng.diagnostics_by_tick)


def test_save_load_roundtrip_sharded(tmp_path):
    eng, *_ = _run_engine(devices=2, num_sources=2, frames=20)
    before = eng._tracker_state.gather()
    assert eng.save_map(str(tmp_path / "m"))
    assert eng.load_map(str(tmp_path / "m"))
    assert eng.save_state(str(tmp_path / "s"))
    assert eng.load_state(str(tmp_path / "s"))
    after = eng._tracker_state
    assert isinstance(after, ShardedTrackerState) and after.axis_mode == "cam"
    for f in ("lm_pos_w", "lm_id", "lm_valid", "world_t_body", "lm_id_counter"):
        assert torch.equal(getattr(after, f), getattr(before, f)), f


def test_more_devices_than_visible_rejected(monkeypatch):
    """Asking for more CUDA devices than are visible raises at initialize
    (the card's count is stubbed to 1 here; nothing reaches CUDA)."""
    spec = SyntheticRigSpec(num_sources=1, stereo=True, width=64, height=48)
    sources, rig_ext, _, _ = make_synthetic_rig(spec)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    engine = TorchSlamEngine(devices=512)
    with CameraRig(sources, rig_extrinsics=rig_ext) as rig:
        with pytest.raises(RuntimeError, match="devices"):
            engine.initialize(rig.calibration, SlamConfig(num_cameras=2))


def test_dryrun_multidevice():
    result = dryrun_multidevice(2, "cpu")
    assert result["unique_lm_ids"] > 0 and result["slot_inliers"] >= 12
    assert result["keyframes"] > 0 and result["ba_window"] > 0 and result["loop_db"] > 0


#: The runners' config: 2 stereo sources at 160x100 and the deployed YAML's
#: backend values (adaptive half-res pinned off, as the runner tests do), on
#: two devices, mapping off.
RUNNER_CFG = {
    "fps": 30,
    "imu_report_rate": 400,
    "watchdog_timeout_s": 1.0,
    "backend": {
        "max_keypoints": 512, "enable_ba": True, "use_imu": True, "use_accel": True, "pipelined": True,
        "pipeline_depth": 1, "devices": 2, "light_half_res": False, "adaptive_half_res": False, "tracker": {},
    },
    "synthetic": {
        "enabled": True, "num_cameras": 2, "resolution": [160, 100], "baseline_m": 0.075,
        "trajectory_radius": 0.6, "room_half_extents": [1.5, 1.5, 1.0],
    },
    "mapping": {"enabled": False},
}


@pytest.mark.parametrize("name", ["run_slam", "run_pipeline"])
def test_runners_honour_backend_devices(name, caplog):
    """``backend.devices: 2`` tracks over two (virtual CPU) devices in both
    runners: rc 0 and every frame done."""
    import contextlib
    import io
    import logging
    import re

    from thor_slam_tpu_torch.scripts import run_pipeline, run_slam
    from thor_slam_tpu_torch.utils.config import RunConfig

    module = run_slam if name == "run_slam" else run_pipeline
    out = io.StringIO()
    with caplog.at_level(logging.INFO), contextlib.redirect_stdout(out):
        rc = module.run(RunConfig.from_dict(RUNNER_CFG), max_frames=6, device="cpu")
    assert rc == 0
    assert "SPMD tracking over 2 devices (cam-sharded)" in caplog.text
    done = re.search(r"^Done: (\d+) frames", out.getvalue(), re.M)
    assert done and int(done.group(1)) == 6
