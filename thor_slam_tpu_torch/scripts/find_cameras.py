"""List DepthAI devices reachable on the network (port of the JAX package's
scripts/find_cameras.py).

Usage: python -m thor_slam_tpu_torch.scripts.find_cameras
"""

from __future__ import annotations

import sys


def main() -> int:
    try:
        from thor_slam_tpu_torch.camera.utils import get_luxonis_devices_info
    except ImportError:
        print("depthai not installed — hardware discovery unavailable.")
        return 1
    try:
        infos = get_luxonis_devices_info()
    except ImportError as e:
        print(str(e))
        return 1
    if not infos:
        print("No DepthAI devices found on the network.")
        return 0
    for info in infos:
        print(f"{info.name}  mxid={info.getMxId()}  state={info.state}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
