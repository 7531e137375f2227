"""RGB-D product visualization.

Port of the JAX package's ``examples/rgbd_stream.py``: SGM depth for a
synthetic stereo camera through the port's ``RGBDProcessor`` (the SGM scan
and winner kernels), written as colorized depth + RGB side-by-side PNGs
(``.npy`` panels without cv2). The processor runs on the card unless
``--device`` says otherwise; panels go to ``--out`` (default:
``rgbd_stream`` in the temporary directory).

Usage: python -m thor_slam_tpu_torch.examples.rgbd_stream [--frames 3] [--out /tmp/rgbd]
       python -m thor_slam_tpu_torch.examples.rgbd_stream --color    # color-aligned RGB-D
       python -m thor_slam_tpu_torch.examples.rgbd_stream --device cpu
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np


def colorize_depth(depth_mm: np.ndarray, max_mm: float = 8000.0) -> np.ndarray:
    """16UC1 mm depth -> uint8 heatmap (invalid = black)."""
    d = depth_mm.astype(np.float32)
    valid = d > 0
    norm = np.clip(d / max_mm, 0, 1)
    r = (255 * norm).astype(np.uint8)
    b = (255 * (1 - norm)).astype(np.uint8)
    g = np.zeros_like(r)
    img = np.stack([r, g, b], axis=-1)
    img[~valid] = 0
    return img


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--frames", type=int, default=3)
    parser.add_argument("--out", default=str(Path(tempfile.gettempdir()) / "rgbd_stream"))
    parser.add_argument(
        "--color", action="store_true",
        help="Use the synthetic COLOR imager and align depth to it "
             "(the nvblox feed mode; reference luxonis.py:464-549)",
    )
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

    spec = SyntheticRigSpec(
        num_sources=1, stereo=True, width=320, height=200, baseline_m=0.2,
        color_camera=args.color, color_resolution=(256, 160) if args.color else None,
    )
    world = SyntheticWorld(half_extents=(3.0, 3.0, 1.8))
    src = SyntheticCameraSource("cam0", world, OrbitTrajectory(radius=1.2), np.eye(4), spec)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with CameraRig([src]) as rig:
        if args.color:
            proc = RGBDProcessor(
                "cam0", src.get_intrinsics(), src.get_extrinsics(),
                color_intrinsics=src.get_rgb_intrinsics(),
                left_t_color=src.get_rgb_extrinsics().to_4x4_matrix(), device=args.device,
            )
            print("color-aligned mode: depth in the color camera's frame at "
                  f"{proc.output_intrinsics.width}x{proc.output_intrinsics.height}")
        else:
            proc = RGBDProcessor("cam0", src.get_intrinsics(), src.get_extrinsics(), device=args.device)
        for i in range(args.frames):
            sync = rig.get_synchronized_frames()
            color = src.try_get_latest_rgb_frame() if args.color else None
            frame = proc.process(sync, color_frame=color)
            if frame is None:
                continue
            depth_vis = colorize_depth(frame.depth_mm)
            rgb_vis = np.stack([frame.rgb] * 3, axis=-1) if frame.rgb.ndim == 2 else frame.rgb
            panel = np.concatenate([rgb_vis, depth_vis], axis=1)
            valid = frame.depth_mm > 0
            med = np.median(frame.depth_mm[valid]) / 1000.0 if valid.any() else float("nan")
            print(
                f"frame {i}: depth valid {valid.mean() * 100:.0f}%  median {med:.2f} m"
            )
            try:
                import cv2

                cv2.imwrite(str(out / f"rgbd_{i:03d}.png"), panel[..., ::-1])
            except ImportError:
                np.save(out / f"rgbd_{i:03d}.npy", panel)
    print(f"wrote {args.frames} panels to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
