"""URDF rig-extrinsics demo.

Port of the JAX package's ``examples/pull_extrinsics.py``: reads the rig's
camera mounts from a URDF with the port's URDF reader. The default URDF is
the repo's ``examples/assets/rig.urdf``.

Usage: python -m thor_slam_tpu_torch.examples.pull_extrinsics [--urdf examples/assets/rig.urdf]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

DEFAULT_URDF = Path(__file__).resolve().parents[2] / "examples" / "assets" / "rig.urdf"

CAMERA_MAP = {
    "192.168.2.21": "link_Camera_1",
    "192.168.2.22": "link_Camera_2",
    "192.168.2.23": "link_Camera_3",
    "192.168.2.25": "link_Camera_4",
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--urdf", default=str(DEFAULT_URDF))
    args = parser.parse_args(argv)

    from thor_slam_tpu_torch.camera.utils import load_rig_extrinsics_from_urdf

    ext = load_rig_extrinsics_from_urdf(args.urdf, CAMERA_MAP)
    for name, e in ext.items():
        t = e.translation
        yaw = np.degrees(np.arctan2(e.rotation[1, 0], e.rotation[0, 0]))
        print(f"{name} <- {CAMERA_MAP[name]}: t=({t[0]:+.3f}, {t[1]:+.3f}, {t[2]:+.3f}) m  yaw={yaw:+.1f} deg")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
