"""Flash a static/dynamic IP onto an OAK PoE camera's bootloader.

Copy of the JAX package's ``scripts/set_ip.py`` (itself the reference's
``scripts/set_ip.py``); ``depthai`` is imported inside ``main``.

Usage: python -m thor_slam_tpu_torch.scripts.set_ip <current-ip> --static 192.168.2.21 \
           --mask 255.255.255.0 --gateway 192.168.2.1
       python -m thor_slam_tpu_torch.scripts.set_ip <current-ip> --dynamic
"""

from __future__ import annotations

import argparse
import sys


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("current_ip", help="Device's current IP")
    parser.add_argument("--static", default=None, help="New static IP")
    parser.add_argument("--mask", default="255.255.255.0")
    parser.add_argument("--gateway", default="192.168.2.1")
    parser.add_argument("--dynamic", action="store_true", help="Switch to DHCP")
    args = parser.parse_args()

    try:
        import depthai as dai
    except ImportError:
        print("depthai not installed — IP flashing unavailable.")
        return 1

    found, info = dai.DeviceBootloader.getFirstAvailableDevice()
    if not found:
        print("No bootloader-visible device found.")
        return 1

    with dai.DeviceBootloader(info) as bl:
        conf = dai.DeviceBootloader.Config()
        if args.dynamic:
            conf.setDynamicIPv4()
            print(f"Flashing dynamic IP config to {info.name}...")
        elif args.static:
            conf.setStaticIPv4(args.static, args.mask, args.gateway)
            print(f"Flashing static {args.static}/{args.mask} gw {args.gateway}...")
        else:
            print("Specify --static <ip> or --dynamic")
            return 2
        ok, err = bl.flashConfig(conf)
        print("Done." if ok else f"FAILED: {err}")
        return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
