"""Generate a synthetic stereo+IMU sequence in the EuRoC ASL layout.

Port of the JAX package's ``scripts/make_euroc_synthetic.py``, rendering
with the port's synthetic source: the same arguments write the same
frames, timestamps, ground truth and calibration (``calibration.npz``'s
arrays; every other file byte for byte) and the same IMU samples expressed
in cam0's axes. The reference writes them in the synthetic body's FLU axes,
but a replay (``EurocCameraSource``, as the reference's) declares the IMU
co-located with cam0 (identity sensor extrinsics), whose axes are RDF: yaw
read as roll, so a run with the IMU on diverges once the orbit turns fast
(0.7 rad/s at 752x480). cam0 sits at the body's origin, so the rotated
samples are exactly what an IMU on cam0 measures. It validates the accuracy path
(``thor_slam_tpu_torch.scripts.run_euroc``) without the real dataset: the
renderer writes ``mav0/cam{0,1}/data/*.npy`` + ``data.csv``,
``imu0/data.csv``, ``state_groundtruth_estimate0/data.csv`` (analytic
trajectory), and a ``calibration.npz`` that ``EurocCameraSource`` picks up
in place of the standard VI-sensor calibration (real ASL sequences don't
carry the file and keep the standard values).

``--imu-frame vi-sensor`` (the port's alone) writes the IMU as EuRoC's
sensor head carries it instead: in its own body frame, placed against cam0
by the VI-sensor's published ``T_BS`` of cam0 (6.9 cm off, axes turned),
its specific force measured at that place. The sequence then also holds
the three ``sensor.yaml`` files that describe the head, and
``calibration.npz`` carries the IMU's pose in cam0 (``c0_t_imu``). The
default, ``cam0``, writes what it always has.

Usage:
    python -m thor_slam_tpu_torch.scripts.make_euroc_synthetic --out /tmp/seq [--frames 60]
    python -m thor_slam_tpu_torch.scripts.run_euroc --sequence /tmp/seq --frames 60
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", required=True, help="Sequence root to create")
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--height", type=int, default=400)
    parser.add_argument("--fps", type=float, default=20.0)
    parser.add_argument(
        "--trajectory-rate", type=float, default=0.25,
        help="Orbit angular rate (rad/s). A full revisit takes 2*pi/rate "
             "seconds — e.g. rate 0.35 at 20 fps revisits the start near "
             "frame 359, exercising loop closure in the ATE number.",
    )
    parser.add_argument("--radius", type=float, default=1.8)
    # Robustness nuisances (accuracy ablations).
    parser.add_argument("--exposure-drift", type=float, default=0.0,
                        help="Sinusoidal gain amplitude (e.g. 0.3)")
    parser.add_argument("--noise-std", type=float, default=0.0,
                        help="Gaussian intensity noise std (0-255 scale)")
    parser.add_argument("--salt-prob", type=float, default=0.0,
                        help="Per-pixel salt&pepper probability")
    parser.add_argument("--motion-blur", type=float, default=0.0,
                        help="Horizontal blur px per rad/s of yaw rate")
    parser.add_argument("--gyro-bias", type=float, default=0.0,
                        help="Injected constant gyro bias (rad/s, z axis)")
    parser.add_argument(
        "--imu-frame", choices=("cam0", "vi-sensor"), default="cam0",
        help="The IMU's frame: cam0's axes at cam0, or the VI-sensor's body frame "
             "placed by its published T_BS, with the sensor.yaml files",
    )
    return parser.parse_args(argv)


def imu_sample_at(traj, t: float, body_t_imu: np.ndarray, dt: float = 1e-4) -> tuple[np.ndarray, np.ndarray]:
    """(gyro, accel) of an IMU at ``body_t_imu`` on the trajectory's body at
    time ``t``, in the IMU's axes: ``OrbitTrajectory.imu_sample``'s central
    differences of the IMU's own pose, so that the specific force holds the
    lever arm's centripetal and tangential terms."""
    from thor_slam_tpu_torch.camera.sources.synthetic import GRAVITY_W

    m0, m1, m2 = (traj.pose(t + k * dt) @ body_t_imu for k in (-1.0, 0.0, 1.0))
    omega_skew = m1[:3, :3].T @ ((m2[:3, :3] - m0[:3, :3]) / (2.0 * dt))
    gyro = np.array([omega_skew[2, 1], omega_skew[0, 2], omega_skew[1, 0]])
    acc_w = (m2[:3, 3] - 2.0 * m1[:3, 3] + m0[:3, 3]) / (dt * dt)
    return gyro, m1[:3, :3].T @ (acc_w - GRAVITY_W)


def build_source(args: argparse.Namespace):
    """(source, trajectory) of the sequence: one stereo camera with its IMU.
    Its frames are deterministic per index, so they may be rendered ahead
    (``SyntheticCameraSource.prerender``) before :func:`write_sequence`."""
    from thor_slam_tpu_torch.camera.sources.synthetic import (
        OrbitTrajectory,
        SyntheticCameraSource,
        SyntheticRigSpec,
        SyntheticWorld,
    )

    spec = SyntheticRigSpec(
        num_sources=1, stereo=True, width=args.width, height=args.height,
        baseline_m=0.11, fps=args.fps, imu_rate_hz=200.0,
        exposure_drift=args.exposure_drift,
        noise_std=args.noise_std,
        salt_prob=args.salt_prob,
        motion_blur_px_per_rad_s=args.motion_blur,
        imu_gyro_bias=(0.0, 0.0, args.gyro_bias),
    )
    world = SyntheticWorld(half_extents=(5.0, 5.0, 2.5))
    traj = OrbitTrajectory(radius=args.radius, angular_rate=args.trajectory_rate)
    src = SyntheticCameraSource(
        "cam0", world, traj, np.eye(4), spec, emit_imu=True, render=True
    )
    return src, traj


def write_sequence(args: argparse.Namespace, src, traj) -> int:
    """Write ``args.frames`` frames of ``src`` in the ASL layout under
    ``args.out``; returns the number of IMU samples written."""
    from thor_slam_tpu_torch import geometry

    root = Path(args.out)
    mav = root / "mav0"
    for cam in ("cam0", "cam1"):
        data_dir = mav / cam / "data"
        if data_dir.exists():  # regenerating: drop frames from a prior run
            for stale in data_dir.glob("*.npy"):
                stale.unlink()
        data_dir.mkdir(parents=True, exist_ok=True)
    (mav / "imu0").mkdir(exist_ok=True)
    (mav / "state_groundtruth_estimate0").mkdir(exist_ok=True)

    # The IMU (identity in the source frame) in cam0's axes: cam0_R_imu.
    c0_r_imu = (
        np.linalg.inv(src.get_extrinsics()[0].to_4x4_matrix())
        @ src.get_sensor_extrinsics().to_4x4_matrix()
    )[:3, :3]
    vi_sensor = args.imu_frame == "vi-sensor"
    if vi_sensor:
        from thor_slam_tpu_torch.camera.sources.euroc_sensor import T_BS_CAM0

        c0_t_imu = np.linalg.inv(T_BS_CAM0)
        body_t_imu = src.get_extrinsics()[0].to_4x4_matrix() @ c0_t_imu
    cam_rows: dict[str, list[str]] = {"cam0": [], "cam1": []}
    gt_rows: list[str] = []
    imu_rows: list[str] = []
    src.start()
    for i in range(args.frames):
        frames = src.get_latest_frames()
        data, _ts = src.get_timestamped_sensor_data()
        ts_ns = int(round(frames[0].timestamp * 1e9))
        for cam, frame in zip(("cam0", "cam1"), frames):
            img = frame.image
            if img.dtype != np.uint8:
                img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            np.save(mav / cam / "data" / f"{ts_ns}.npy", img)
            cam_rows[cam].append(f"{ts_ns},{ts_ns}.npy")

        pose = traj.pose(src.frame_time(i))  # world_T_body
        q = geometry.matrix_to_quat(pose[:3, :3])  # xyzw
        p = pose[:3, 3]
        gt_rows.append(
            f"{ts_ns},{p[0]:.9f},{p[1]:.9f},{p[2]:.9f},"
            f"{q[3]:.9f},{q[0]:.9f},{q[1]:.9f},{q[2]:.9f},"
            + ",".join(["0.0"] * 9)
        )
        if data is not None:
            if vi_sensor:
                gyros, accels = (np.stack(v) for v in zip(*(imu_sample_at(traj, t, body_t_imu)
                                                            for t in data["timestamps"])))
                gyros = gyros + [0.0, 0.0, args.gyro_bias]  # the bias knob, on the IMU's own z
            else:
                gyros, accels = data["gyroscope"] @ c0_r_imu.T, data["accelerometer"] @ c0_r_imu.T
            for t_s, gyro, accel in zip(data["timestamps"], gyros, accels):
                imu_rows.append(
                    f"{int(round(t_s * 1e9))},"
                    f"{gyro[0]:.9f},{gyro[1]:.9f},{gyro[2]:.9f},"
                    f"{accel[0]:.9f},{accel[1]:.9f},{accel[2]:.9f}"
                )
    src.stop()

    header = "#timestamp [ns],filename"
    for cam in ("cam0", "cam1"):
        (mav / cam / "data.csv").write_text(header + "\n" + "\n".join(cam_rows[cam]) + "\n")
    (mav / "imu0" / "data.csv").write_text(
        "#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n" + "\n".join(imu_rows) + "\n"
    )
    (mav / "state_groundtruth_estimate0" / "data.csv").write_text(
        "#timestamp [ns],px,py,pz,qw,qx,qy,qz,vx,vy,vz,bwx,bwy,bwz,bax,bay,baz\n"
        + "\n".join(gt_rows) + "\n"
    )

    intr = src.get_intrinsics()
    ext = src.get_extrinsics()
    c0_t_c1 = np.linalg.inv(ext[0].to_4x4_matrix()) @ ext[1].to_4x4_matrix()
    extra = {}
    if vi_sensor:
        from thor_slam_tpu_torch.camera.sources.euroc_sensor import sensor_yaml

        extra["c0_t_imu"] = c0_t_imu
        t_bs_c0 = np.linalg.inv(c0_t_imu)
        (mav / "cam0" / "sensor.yaml").write_text(sensor_yaml(t_bs_c0, args.fps, intr[0], "synthetic cam0"))
        (mav / "cam1" / "sensor.yaml").write_text(sensor_yaml(t_bs_c0 @ c0_t_c1, args.fps, intr[1], "synthetic cam1"))
        (mav / "imu0" / "sensor.yaml").write_text(sensor_yaml(np.eye(4), 200.0, None, "synthetic IMU"))
    np.savez(
        mav / "calibration.npz",
        width=np.int64(args.width), height=np.int64(args.height),
        k0=np.asarray(intr[0].matrix), d0=np.asarray(intr[0].coeffs),
        k1=np.asarray(intr[1].matrix), d1=np.asarray(intr[1].coeffs),
        c0_t_c1=c0_t_c1, **extra,
    )
    return len(imu_rows)


def main(argv=None) -> int:
    args = parse_args(argv)
    src, traj = build_source(args)
    imu_samples = write_sequence(args, src, traj)
    print(
        f"Wrote {args.frames} stereo frames + {imu_samples} IMU samples "
        f"+ ground truth to {Path(args.out)}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
