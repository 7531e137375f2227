"""EuRoC sequence evaluation: replay -> track -> ATE against ground truth.

Port of the JAX package's ``scripts/run_euroc.py``, with the same flags and
output lines: the accuracy path. Expects the standard ASL layout; if
``mav0/state_groundtruth_estimate0/data.csv`` exists, reports ATE-RMSE
against it, for the odometry stream, the loop-corrected world estimate
(after a closure) and the keyframes of the map. The sequence's calibration,
its IMU's pose in cam0 included, is read as ``camera/sources/euroc_sensor``
says (the three ``sensor.yaml`` files of a recorded sequence), where the
reference's runner declares the IMU at cam0 in cam0's axes. The engine runs on the
card unless ``--cpu`` or ``--device`` says otherwise; ``--devices N``
tracks over N devices (landmark-slot sharding for this one camera), N
virtual shards with ``--cpu``.

Usage:
    python -m thor_slam_tpu_torch.scripts.run_euroc --sequence /data/euroc/MH_01_easy \
           [--frames 500] [--out traj.csv]
    python -m thor_slam_tpu_torch.scripts.make_euroc_synthetic --out /tmp/seq
    python -m thor_slam_tpu_torch.scripts.run_euroc --sequence /tmp/seq --cpu
    python -m thor_slam_tpu_torch.scripts.run_euroc --sequence /tmp/seq --cpu --devices 2
"""

from __future__ import annotations

import argparse
import csv
import logging
import sys
import time
from pathlib import Path

import numpy as np

logger = logging.getLogger("run_euroc")


def load_groundtruth(seq_root: Path):
    gt_csv = seq_root / "mav0" / "state_groundtruth_estimate0" / "data.csv"
    if not gt_csv.exists():
        return None
    ts, pos = [], []
    with open(gt_csv) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            vals = [float(v) for v in row]
            ts.append(vals[0] * 1e-9)
            pos.append(vals[1:4])
    return np.asarray(ts), np.asarray(pos)


def nearest(gt_ts: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """Index of the ground-truth sample nearest in time to each of ``ts``.

    searchsorted alone returns the first GT entry at-or-after each estimate,
    pairing every pose with GT up to one sample late (~5 ms at 200 Hz) and
    biasing ATE with velocity; ties go to the earlier sample."""
    hi = np.clip(np.searchsorted(gt_ts, ts), 0, len(gt_ts) - 1)
    lo = np.clip(hi - 1, 0, len(gt_ts) - 1)
    return np.where(np.abs(gt_ts[lo] - ts) <= np.abs(gt_ts[hi] - ts), lo, hi)


def build_engine(args: argparse.Namespace, device):
    """``TorchSlamEngine`` with the reference runner's arguments."""
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine

    return TorchSlamEngine(
        use_imu=not args.no_imu, use_accel=not args.no_accel,
        enable_ba=not args.no_ba, devices=args.devices,
        light_ticks=False if args.no_light else None,
        light_half_res=args.light_half_res,
        params=dict(median_prefilter=True) if args.median_filter else None,
        device=device,
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--sequence", required=True)
    parser.add_argument("--frames", type=int, default=None)
    parser.add_argument("--out", default=None, help="Write trajectory CSV")
    parser.add_argument("--no-imu", action="store_true")
    parser.add_argument(
        "--no-accel", action="store_true",
        help="Gyro-only IMU prediction (constant-velocity translation)",
    )
    parser.add_argument("--no-ba", action="store_true", help="Disable window bundle adjustment")
    parser.add_argument("--no-loop", action="store_true", help="Disable loop closure")
    parser.add_argument(
        "--no-light", action="store_true",
        help="Disable light (left-only) tick scheduling (ablation)",
    )
    parser.add_argument(
        "--light-half-res", action="store_true",
        help="Ship light ticks 2x-downsampled (1/8 of a full tick's upload "
        "bytes; some inter-keyframe subpixel precision cost)",
    )
    parser.add_argument(
        "--median-filter", action="store_true",
        help="3x3 median prefilter on input images (salt-and-pepper / "
        "dead-pixel robustness)",
    )
    parser.add_argument(
        "--devices", type=int, default=None,
        help="Track over an N-device mesh (landmark-slot sharding for this "
        "single-camera sequence; with --cpu, N virtual shards)",
    )
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (same as --device cpu)")
    parser.add_argument("--device", default=None, help="Compute device (default: the current CUDA device)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    from thor_slam_tpu_torch.camera.rig import CameraRig
    from thor_slam_tpu_torch.camera.sources.euroc_sensor import EurocSensorSource, imu_extrinsics
    from thor_slam_tpu_torch.slam.interface import SlamConfig
    from thor_slam_tpu_torch.utils.evaluation import ate_rmse

    seq = Path(args.sequence)
    try:
        src = EurocSensorSource(seq, read_imu=not args.no_imu, max_frames=args.frames)
    except FileNotFoundError as e:
        print(f"run_euroc: {e}", file=sys.stderr)
        return 2
    engine = build_engine(args, "cpu" if args.cpu else args.device)

    est_ts, est_pos, world_pos = [], [], []
    t0 = time.monotonic()
    imu_source = src.name if src.has_sensor_data else None
    with CameraRig([src], imu_extrinsics=imu_extrinsics(src), imu_source=imu_source) as rig:
        engine.initialize(
            rig.calibration,
            SlamConfig(num_cameras=2, enable_loop_closure=not args.no_loop),
        )
        n = 0
        while not src.exhausted:
            sync = rig.get_synchronized_frames()
            if sync is None:
                break
            pose = engine.process_frames(sync)
            n += 1
            if pose is not None:
                est_ts.append(sync.timestamp)
                # Smooth odometry stream (the reference's odometry topic)...
                est_pos.append(pose.position.copy())
                # ...and the loop-corrected world estimate (odometry lifted
                # through map<-odom, the reference's map->odom TF).
                world_pos.append(engine.get_world_pose(pose).position)
            if n % 100 == 0:
                print(f"{n} frames, {n / (time.monotonic() - t0):.1f} fps, "
                      f"state={engine.get_tracking_state().name}", flush=True)
    elapsed = time.monotonic() - t0
    est_ts = np.asarray(est_ts)
    est_pos = np.asarray(est_pos)
    print(f"Tracked {len(est_pos)} frames in {elapsed:.1f}s ({len(est_pos) / elapsed:.1f} fps)")

    if args.out:
        with open(args.out, "w") as f:
            w = csv.writer(f)
            w.writerow(["#timestamp_s", "x", "y", "z"])
            for t, p in zip(est_ts, est_pos):
                w.writerow([f"{t:.9f}", *[f"{v:.6f}" for v in p]])
        print(f"Trajectory written to {args.out}")

    gt = load_groundtruth(seq)
    if gt is None:
        print("No ground truth in sequence; ATE not computed.")
        return 0
    gt_ts, gt_pos = gt
    matched_gt = gt_pos[nearest(gt_ts, est_ts)]
    ate = ate_rmse(est_pos, matched_gt)
    path_len = float(np.linalg.norm(np.diff(matched_gt, axis=0), axis=1).sum())
    loops = engine.loops_closed
    print(
        f"ATE-RMSE: {ate * 100:.2f} cm over {len(est_pos)} poses "
        f"({path_len:.1f} m path, {loops} loop closures, "
        f"ba={'on' if not args.no_ba else 'off'} "
        f"loop={'on' if not args.no_loop else 'off'} "
        f"imu={'on' if not args.no_imu else 'off'})"
    )
    if loops:
        # The live world estimate (odometry lifted through map<-odom): the
        # number a consumer of the full TF tree experiences. Odometry ATE
        # above stays loop-independent by design (smooth stream).
        print(
            f"world-frame live ATE-RMSE: {ate_rmse(np.asarray(world_pos), matched_gt) * 100:.2f} cm "
            f"(odometry composed with map->odom)"
        )

    # The MAP trajectory: keyframe poses retro-corrected by loop-closure
    # pose-graph optimization and window BA. The live odometry stream
    # (above) necessarily contains the pre-correction drift plus the snap
    # at each closure; the map trajectory is where loop closure's benefit
    # is measurable.
    kf = engine.get_map().keyframe_poses
    if len(kf) >= 3:
        kf_ts = np.asarray([p.timestamp for p in kf])
        kf_pos = np.asarray([p.position for p in kf])
        kf_ate = ate_rmse(kf_pos, gt_pos[nearest(gt_ts, kf_ts)])
        print(f"map-trajectory ATE-RMSE: {kf_ate * 100:.2f} cm over {len(kf)} keyframes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
