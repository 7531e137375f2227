"""A dry run of multi-device tracking through the engine's own API.

The port's counterpart of the JAX package's ``dryrun_multichip``: the same
two segments at the same sizes, through ``TorchSlamEngine(devices=n)``,
with the same assertions.

1. **Camera sharding**: n stereo cameras over n devices, VO only, 4 frames
   at 128x96; landmark ids unique across the camera shards and the last
   pose TRACKING.
2. **Slot sharding with the full engine**: one stereo camera over n
   devices, BA, IMU and loop closure on, pipelined at depth 3, 12 frames:
   >= 12 inliers, keyframes, a non-empty BA window and loop database, and
   a 6x6 covariance.

Run it on the CPU (n virtual shards) or on the card::

    python -m thor_slam_tpu_torch.parallel.dryrun --devices 2 --device cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def dryrun_multidevice(n: int, device=None) -> dict:
    """Run both segments over ``n`` devices (``device="cpu"``: n virtual
    shards) and return what they showed."""
    from thor_slam_tpu_torch.camera.rig import CameraRig
    from thor_slam_tpu_torch.camera.sources.synthetic import (
        OrbitTrajectory,
        SyntheticRigSpec,
        SyntheticWorld,
        make_synthetic_rig,
    )
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.slam.interface import SlamConfig, TrackingState

    world = SyntheticWorld(half_extents=(4.0, 4.0, 2.0))
    traj = OrbitTrajectory(radius=1.5, angular_rate=0.5)

    def drive(num_sources, frames, **engine_kw):
        spec = SyntheticRigSpec(
            num_sources=num_sources, stereo=True, width=128, height=96, fps=30.0, baseline_m=0.12
        )
        sources, rig_ext, _, _ = make_synthetic_rig(spec, world=world, trajectory=traj)
        engine = TorchSlamEngine(
            params=dict(max_keypoints=128, keyframe_min_inliers=40, keyframe_max_translation=0.04),
            devices=n, device=device, **engine_kw,
        )
        poses = []
        imu = engine_kw.get("use_imu", True)
        with CameraRig(sources, rig_extrinsics=rig_ext, imu_source=sources[0].name if imu else None) as rig:
            engine.initialize(rig.calibration, SlamConfig(num_cameras=2 * num_sources))
            for _ in range(frames):
                pose = engine.process_frames(rig.get_synchronized_frames())
                if pose is not None:
                    poses.append(pose)
            tail = engine.flush()  # pipelined: drain the ticks in flight
            if tail is not None:
                poses.append(tail)
        return engine, poses

    # Segment 1: camera sharding, VO only.
    eng_cam, poses_cam = drive(n, frames=4, use_imu=False, enable_ba=False)
    st = eng_cam._tracker_state
    lm_id = st.lm_id.cpu().numpy()
    lm_valid = st.lm_valid.cpu().numpy()
    per_cam = [set(lm_id[c][lm_valid[c]].tolist()) for c in range(n)]
    total = sum(len(s) for s in per_cam)
    merged = set().union(*per_cam)
    assert len(merged) == total, f"landmark-id collision across camera shards ({total - len(merged)} dups)"
    assert poses_cam and poses_cam[-1].tracking_state == TrackingState.TRACKING

    # Segment 2: slot sharding, the full engine (BA + IMU + loop closure),
    # pipelined at depth 3.
    eng_slot, poses_slot = drive(1, frames=12, use_imu=True, enable_ba=True, pipelined=True, pipeline_depth=3)
    assert poses_slot and poses_slot[-1].tracking_state == TrackingState.TRACKING
    diag = eng_slot.last_diagnostics
    assert diag.get("num_inliers", 0) >= 12, f"slot-sharded tracking weak: {diag}"
    assert eng_slot._keyframe_poses, "no keyframes under slot sharding"
    assert any(k.startswith("ba_") for k in diag) or len(eng_slot._ba) > 0, "BA never saw sharded observations"
    assert eng_slot._loop.db, "loop-closure DB empty under slot sharding"
    cov = poses_slot[-1].covariance
    assert cov is not None and cov.shape == (6, 6)
    result = dict(
        devices=n, cam_inliers=eng_cam.last_diagnostics.get("num_inliers"), unique_lm_ids=len(merged),
        slot_inliers=diag.get("num_inliers"), keyframes=len(eng_slot._keyframe_poses), ba_window=len(eng_slot._ba),
        loop_db=len(eng_slot._loop.db), cov_trace=float(np.trace(cov)),
    )
    print(
        f"dryrun_multidevice: engine API over {n} devices — cam-sharded rig: inliers={result['cam_inliers']}, "
        f"unique_lm_ids={len(merged)}; slot-sharded full engine (BA+IMU+loop): inliers={result['slot_inliers']}, "
        f"keyframes={result['keyframes']}, ba_window={result['ba_window']}, loop_db={result['loop_db']}, "
        f"cov_trace={result['cov_trace']:.2e}"
    )
    for engine in (eng_cam, eng_slot):
        engine.shutdown()
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--devices", type=int, default=2)
    parser.add_argument("--device", default=None, help="cpu for virtual shards (default: cuda:0..N-1)")
    args = parser.parse_args(argv)
    dryrun_multidevice(args.devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
