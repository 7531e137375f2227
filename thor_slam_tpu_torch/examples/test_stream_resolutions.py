"""Independent SLAM vs RGB-D stream resolutions.

Port of the JAX package's ``examples/test_stream_resolutions.py``: verifies
the product contract, the tracker consuming the stereo stream at one
resolution while the RGB-D product is emitted at another, with
consistently scaled intrinsics. The port's ``RGBDProcessor`` runs on the
card unless ``--device`` says otherwise.

Usage: python -m thor_slam_tpu_torch.examples.test_stream_resolutions [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default=None, help="compute device (default: the current CUDA device)")
    args = parser.parse_args(argv)

    from thor_slam_tpu_torch.camera.rig import CameraRig
    from thor_slam_tpu_torch.camera.sources.synthetic import (
        OrbitTrajectory,
        SyntheticCameraSource,
        SyntheticRigSpec,
        SyntheticWorld,
    )
    from thor_slam_tpu_torch.pipeline.rgbd import RGBDProcessor

    slam_res = (320, 200)
    rgbd_res = (160, 100)

    spec = SyntheticRigSpec(
        num_sources=1, stereo=True, width=slam_res[0], height=slam_res[1], baseline_m=0.2
    )
    world = SyntheticWorld(half_extents=(3.0, 3.0, 1.8))
    src = SyntheticCameraSource("cam0", world, OrbitTrajectory(radius=1.2), np.eye(4), spec)

    with CameraRig([src]) as rig:
        sync = rig.get_synchronized_frames()
        slam_frame = sync.frame_sets["cam0"].frames[0]
        print(f"SLAM stream:  {slam_frame.image.shape[::-1]}  "
              f"fx={src.get_intrinsics()[0].fx:.1f}")

        proc = RGBDProcessor(
            "cam0", src.get_intrinsics(), src.get_extrinsics(), output_resolution=rgbd_res, device=args.device
        )
        frame = proc.process(sync)
        print(f"RGB-D stream: {frame.depth_mm.shape[::-1]}  fx={frame.intrinsics.fx:.1f}")

        assert slam_frame.image.shape == (slam_res[1], slam_res[0])
        assert frame.depth_mm.shape == (rgbd_res[1], rgbd_res[0])
        # Intrinsics scale with resolution (fx ratio == width ratio).
        ratio = frame.intrinsics.fx / proc.rectification.fx
        assert abs(ratio - rgbd_res[0] / slam_res[0]) < 1e-6
        valid = frame.depth_mm > 0
        print(f"depth valid: {valid.mean() * 100:.0f}%  "
              f"median {np.median(frame.depth_mm[valid]) / 1000:.2f} m")
        print("OK: streams are resolution-independent with consistent intrinsics")

    # Part 2: a COLOR imager at a THIRD resolution, depth aligned to it —
    # the full three-way independence the reference's tool verifies
    # (SLAM stream / RGB sensor / RGB-D output; reference
    # test_stream_resolutions.py:181-394, run_pipeline.py:138-148).
    color_res = (256, 160)
    spec_c = SyntheticRigSpec(
        num_sources=1, stereo=True, width=slam_res[0], height=slam_res[1],
        baseline_m=0.2, color_camera=True, color_resolution=color_res,
    )
    src_c = SyntheticCameraSource(
        "cam0", world, OrbitTrajectory(radius=1.2), np.eye(4), spec_c
    )
    with CameraRig([src_c]) as rig:
        sync = rig.get_synchronized_frames()
        color = src_c.try_get_latest_rgb_frame()
        proc_c = RGBDProcessor(
            "cam0", src_c.get_intrinsics(), src_c.get_extrinsics(),
            color_intrinsics=src_c.get_rgb_intrinsics(),
            left_t_color=src_c.get_rgb_extrinsics().to_4x4_matrix(), device=args.device,
        )
        frame_c = proc_c.process(sync, color_frame=color)
        print(f"\ncolor mode:   SLAM {slam_res}  color sensor {color_res}  "
              f"product {frame_c.rgb.shape[1::-1]} rgb8 + aligned depth")
        assert frame_c.rgb.shape == (color_res[1], color_res[0], 3)
        assert frame_c.depth_mm.shape == (color_res[1], color_res[0])
        print("OK: color RGB-D at its own resolution, depth in the color frame")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
