"""IMU diagnostics: rates, per-axis statistics, plots, dead reckoning.

Port of the JAX package's ``examples/test_imu.py``, on the port's sources
and IMU preintegration (matplotlib only under ``--plot`` and ``--live``).

The reference's examples/test_imu.py is its IMU hardware-verification tool:
live matplotlib plotting (IMUPlotter, reference test_imu.py:129-239),
single-camera and rig-synchronized readout modes. This version produces the
same diagnostics hardware-free on the synthetic rig — the plot renders to a
PNG (headless Agg backend) instead of a live window, and the integrated
rotation is checked against the analytic trajectory, which hardware cannot
offer.

Usage: python -m thor_slam_tpu_torch.examples.test_imu [--seconds 2.0]
       python -m thor_slam_tpu_torch.examples.test_imu --plot /tmp/imu.png
       python -m thor_slam_tpu_torch.examples.test_imu --live       # live scrolling window
       python -m thor_slam_tpu_torch.examples.test_imu --rig        # IMU through CameraRig sync
"""

from __future__ import annotations

import argparse

import numpy as np


def _collect(src, seconds: float, fps: float):
    frames = int(seconds * fps)
    all_ts, all_gyro, all_accel = [], [], []
    for _ in range(frames):
        src.get_latest_frames()
        data, _ = src.get_timestamped_sensor_data()
        if data is None:
            continue
        all_ts.extend(data["timestamps"])
        all_gyro.extend(data["gyroscope"])
        all_accel.extend(data["accelerometer"])
    return np.asarray(all_ts), np.asarray(all_gyro), np.asarray(all_accel)


def _axis_stats(name: str, arr: np.ndarray, unit: str) -> None:
    for i, ax in enumerate("xyz"):
        col = arr[:, i]
        print(
            f"  {name}.{ax}: mean={col.mean():+8.4f} sigma={col.std():7.4f} "
            f"min={col.min():+8.3f} max={col.max():+8.3f} {unit}"
        )


def _plot(path: str, ts, gyro, accel) -> None:
    import matplotlib

    matplotlib.use("Agg")  # headless: the reference's live window becomes a PNG
    import matplotlib.pyplot as plt

    t = ts - ts[0]
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
    for i, axname in enumerate("xyz"):
        ax1.plot(t, accel[:, i], label=f"accel {axname}", linewidth=0.8)
        ax2.plot(t, gyro[:, i], label=f"gyro {axname}", linewidth=0.8)
    ax1.set_ylabel("m/s^2")
    ax2.set_ylabel("rad/s")
    ax2.set_xlabel("time [s]")
    ax1.legend(loc="upper right", fontsize=8)
    ax2.legend(loc="upper right", fontsize=8)
    rate = (len(t) - 1) / (t[-1] - t[0]) if len(t) > 1 else 0.0
    ax1.set_title(f"IMU stream: {len(t)} samples @ ~{rate:.0f} Hz")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    print(f"plot written to {path}")


def _live_plot(src, seconds: float, fps: float, window_s: float = 3.0) -> None:
    """Live scrolling accel/gyro traces — the reference's IMUPlotter role
    (reference test_imu.py:129-239). Needs a display; headless
    environments should use --plot (PNG) instead."""
    import matplotlib

    try:
        import matplotlib.pyplot as plt

        fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
        plt.show(block=False)
    except Exception as e:  # pragma: no cover - no display
        print(f"live plotting unavailable ({e}); use --plot <path> instead")
        return
    ts, gyro, accel = [], [], []
    lines1 = [ax1.plot([], [], label=f"accel {a}", linewidth=0.8)[0] for a in "xyz"]
    lines2 = [ax2.plot([], [], label=f"gyro {a}", linewidth=0.8)[0] for a in "xyz"]
    ax1.set_ylabel("m/s^2"); ax1.legend(loc="upper right", fontsize=8)
    ax2.set_ylabel("rad/s"); ax2.set_xlabel("time [s]")
    ax2.legend(loc="upper right", fontsize=8)
    for _ in range(int(seconds * fps)):
        src.get_latest_frames()
        data, _ = src.get_timestamped_sensor_data()
        if data is None:
            continue
        ts.extend(data["timestamps"]); gyro.extend(data["gyroscope"])
        accel.extend(data["accelerometer"])
        t = np.asarray(ts) - ts[0]
        keep = t >= t[-1] - window_s
        ga, aa = np.asarray(gyro)[keep], np.asarray(accel)[keep]
        for i in range(3):
            lines1[i].set_data(t[keep], aa[:, i])
            lines2[i].set_data(t[keep], ga[:, i])
        for ax in (ax1, ax2):
            ax.relim(); ax.autoscale_view()
        fig.canvas.draw_idle(); fig.canvas.flush_events()
        plt.pause(1.0 / fps)
    plt.close(fig)


def _rig_mode(seconds: float) -> None:
    """IMU through CameraRig synchronization (the reference's
    run_synchronized mode, reference test_imu.py:444-498): reports batch
    sizes, sample coverage per frame window, and empty windows."""
    from thor_slam_tpu_torch.camera.rig import CameraRig
    from thor_slam_tpu_torch.camera.sources.synthetic import SyntheticRigSpec, make_synthetic_rig

    spec = SyntheticRigSpec(num_sources=2, width=64, height=48, fps=30.0, imu_rate_hz=400.0)
    sources, rig_ext, _, _ = make_synthetic_rig(spec, clock_offsets=(0.0, 0.003))
    batch_sizes, empty_windows, last_ts = [], 0, None
    with CameraRig(sources, rig_extrinsics=rig_ext, imu_source=sources[0].name) as rig:
        for _ in range(int(seconds * spec.fps)):
            sync = rig.get_synchronized_frames()
            if sync is None or sync.sensor_data is None:
                continue
            ts = np.asarray(sync.sensor_data["timestamps"])
            batch_sizes.append(len(ts))
            if last_ts is not None:
                in_window = ((ts > last_ts) & (ts <= sync.timestamp)).sum()
                if in_window == 0:
                    empty_windows += 1
            last_ts = sync.timestamp
    b = np.asarray(batch_sizes)
    print(f"rig mode: {len(b)} synchronized sets, IMU batch sizes "
          f"mean={b.mean():.1f} min={b.min()} max={b.max()} "
          f"(expected ~{spec.imu_rate_hz / spec.fps:.1f}/frame)")
    print(f"empty preintegration windows: {empty_windows} "
          f"(nonzero means IMU samples arrive late — the engine would fall "
          f"back to constant-velocity)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--plot", default=None, help="Write accel/gyro traces to a PNG")
    parser.add_argument(
        "--live", action="store_true",
        help="Live scrolling plot window (needs a display; the reference's "
             "IMUPlotter role)",
    )
    parser.add_argument("--rig", action="store_true", help="Run IMU through CameraRig sync")
    args = parser.parse_args(argv)

    from thor_slam_tpu_torch.camera.sources.synthetic import (
        OrbitTrajectory,
        SyntheticCameraSource,
        SyntheticRigSpec,
        SyntheticWorld,
    )
    from thor_slam_tpu_torch.engine import imu as imu_mod

    spec = SyntheticRigSpec(num_sources=1, width=64, height=48, fps=30.0, imu_rate_hz=400.0)
    traj = OrbitTrajectory()
    src = SyntheticCameraSource(
        "imu-cam", SyntheticWorld(), traj, np.eye(4), spec, emit_imu=True, render=False
    )
    src.start()
    all_ts, all_gyro, all_accel = _collect(src, args.seconds, spec.fps)

    rate = len(all_ts) / args.seconds
    g = np.linalg.norm(np.mean(all_accel, axis=0))
    dts = np.diff(all_ts)
    print(f"{len(all_ts)} IMU samples in {args.seconds:.1f}s  (~{rate:.0f} Hz)")
    print(f"sample spacing: mean={dts.mean() * 1e3:.2f} ms  max={dts.max() * 1e3:.2f} ms  "
          f"monotonic={bool((dts > 0).all())}")
    print(f"mean |accel| = {g:.2f} m/s^2 (gravity + centripetal)")
    _axis_stats("accel", all_accel, "m/s^2")
    _axis_stats("gyro", all_gyro, "rad/s")

    # Dead-reckon through the preintegrator and compare with ground truth.
    g_, a_, d_, m_ = imu_mod.pack_imu_window(
        all_ts, all_gyro, all_accel, t_start=0.0, t_end=args.seconds, capacity=len(all_ts)
    )
    pre = imu_mod.preintegrate_np(g_, a_, d_, m_)
    true_rel = np.linalg.inv(traj.pose(all_ts[0])) @ traj.pose(all_ts[-1])
    rot_err = np.degrees(
        np.arccos(np.clip((np.trace(np.asarray(pre.delta_r).T @ true_rel[:3, :3]) - 1) / 2, -1, 1))
    )
    print(f"gyro-integrated rotation error over {args.seconds:.1f}s: {rot_err:.3f} deg")

    if args.plot:
        _plot(args.plot, all_ts, all_gyro, all_accel)
    if args.live:
        _live_plot(src, args.seconds, spec.fps)
    if args.rig:
        _rig_mode(args.seconds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
