"""Single-camera driver smoke test.

Port of the JAX package's ``examples/test_camera_driver.py``: exercises one
CameraSource end to end (bring-up, frame rate, calibration readout,
teardown). Synthetic by default; --ip drives a real OAK camera through the
port's ``camera/sources/luxonis.py`` (requires depthai).

Usage: python -m thor_slam_tpu_torch.examples.test_camera_driver [--ip 192.168.2.21] [--frames 30]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ip", default=None, help="Real camera IP (needs depthai)")
    parser.add_argument("--frames", type=int, default=30)
    parser.add_argument("--stereo", action="store_true", default=True)
    args = parser.parse_args(argv)

    if args.ip:
        from thor_slam_tpu_torch.camera.sources.luxonis import LuxonisCameraConfig, LuxonisCameraSource
        from thor_slam_tpu_torch.camera.types import IPv4

        src = LuxonisCameraSource(
            LuxonisCameraConfig(ip=IPv4(args.ip), stereo=args.stereo, read_imu=True)
        )
    else:
        from thor_slam_tpu_torch.camera.sources.synthetic import (
            OrbitTrajectory,
            SyntheticCameraSource,
            SyntheticRigSpec,
            SyntheticWorld,
        )

        src = SyntheticCameraSource(
            "synthetic-cam", SyntheticWorld(), OrbitTrajectory(), np.eye(4),
            SyntheticRigSpec(num_sources=1, stereo=args.stereo, width=320, height=200),
            emit_imu=True,
        )

    print(f"source: {src.name}")
    for i, intr in enumerate(src.get_intrinsics()):
        print(f"  imager {i}: {intr.width}x{intr.height} fx={intr.fx:.1f} "
              f"cx={intr.cx:.1f} dist={np.asarray(intr.coeffs)[:2]}")
    for i, ext in enumerate(src.get_extrinsics()):
        print(f"  extrinsics {i}: t={ext.translation}")
    print(f"  imu: {src.has_sensor_data}")

    src.start()
    t0 = time.monotonic()
    ts_first = ts_last = None
    for i in range(args.frames):
        frames = src.get_latest_frames()
        if not frames:
            break
        if ts_first is None:
            ts_first = frames[0].timestamp
        ts_last = frames[0].timestamp
        if i % 10 == 0:
            shapes = [f.image.shape for f in frames]
            print(f"frame {i}: ts={frames[0].timestamp:.3f} shapes={shapes}")
    src.stop()
    wall = time.monotonic() - t0
    stream_fps = (args.frames - 1) / (ts_last - ts_first) if ts_last != ts_first else 0
    print(f"\n{args.frames} frames | stream clock {stream_fps:.1f} fps | wall {args.frames / wall:.1f} fps")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
