"""Camera-layer utilities: URDF rig calibration and device discovery.

URDF semantics follow the reference's documented intent (reference:
thor_slam/camera/utils.py:101-178): a star topology of fixed joints from
``base_link`` to per-camera links; joint ``origin`` carries ``xyz`` meters
and ``rpy`` as *extrinsic* (fixed-axis) XYZ Euler angles per the URDF spec.
Note: the reference's implementation calls scipy with uppercase ``"XYZ"``
(intrinsic) while its comment claims extrinsic — a convention bug for
multi-axis rpy, flagged by its own ``TODO: write tests`` (utils.py:99-100).
We implement the URDF standard. Device discovery requires the optional
``depthai`` dependency and is gated accordingly.

Copy of :mod:`thor_slam_tpu.camera.utils`, kept in the port so that the
port imports nothing of the JAX package; keep the two in step.
"""

from __future__ import annotations

import logging
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from thor_slam_tpu_torch import geometry
from thor_slam_tpu_torch.camera.types import Extrinsics, IPv4

logger = logging.getLogger(__name__)


def parse_urdf_transform(joint_elem: ET.Element) -> np.ndarray:
    """4x4 transform of a URDF fixed joint's ``origin``.

    Missing ``origin`` (or missing xyz/rpy attributes) default to identity /
    zeros, matching URDF semantics.
    """
    origin = joint_elem.find("origin")
    if origin is None:
        logger.warning("Joint %s has no origin tag, assuming identity.", joint_elem.get("name"))
        return np.eye(4)

    xyz = np.fromstring(origin.get("xyz", "0 0 0"), sep=" ", dtype=np.float64)
    roll, pitch, yaw = (float(v) for v in origin.get("rpy", "0 0 0").split())

    return geometry.se3_matrix(
        geometry.euler_xyz_extrinsic_to_matrix(roll, pitch, yaw), xyz
    )


def load_rig_extrinsics_from_urdf(
    urdf_path: str | Path, camera_map: dict[str, str]
) -> dict[str, Extrinsics]:
    """Extract per-source rig extrinsics from a star-topology URDF.

    Args:
        urdf_path: URDF whose fixed joints connect ``base_link`` to camera links.
        camera_map: source name (e.g. IP) -> URDF child link name.

    Returns:
        source name -> Extrinsics (base_T_source) for every link found.
    """
    urdf_path = Path(urdf_path)
    if not urdf_path.exists():
        raise FileNotFoundError(f"URDF not found at {urdf_path}")

    root = ET.parse(urdf_path).getroot()

    # Index joints by child link, keeping only those parented to base_link.
    joints_by_child: dict[str, ET.Element] = {}
    for joint in root.findall("joint"):
        child = joint.find("child")
        parent = joint.find("parent")
        if child is None or child.get("link") is None:
            continue
        if parent is None or parent.get("link") != "base_link":
            logger.warning("Skipping joint %s: parent is not base_link", joint.get("name"))
            continue
        joints_by_child[child.get("link", "")] = joint

    out: dict[str, Extrinsics] = {}
    for source_name, link_name in camera_map.items():
        joint = joints_by_child.get(link_name)
        if joint is None:
            logger.warning("Could not find URDF link matching '%s' for source %s", link_name, source_name)
            continue
        out[source_name] = Extrinsics.from_4x4_matrix(parse_urdf_transform(joint))
        logger.info("Loaded extrinsics for %s (found link: %s)", source_name, link_name)

    return out


# ---------------------------------------------------------------------------
# Hardware discovery (optional depthai dependency)
# ---------------------------------------------------------------------------

def _require_depthai():  # pragma: no cover - needs hardware SDK
    try:
        import depthai as dai
    except ImportError as e:
        raise ImportError(
            "depthai is required for hardware camera discovery; "
            "install with: pip install 'thor-slam-tpu[hardware]'"
        ) from e
    return dai


def get_luxonis_devices_info() -> list:  # pragma: no cover - needs hardware
    """All DepthAI devices reachable on the network."""
    dai = _require_depthai()
    return dai.Device.getAllAvailableDevices()


def get_luxonis_device(ip: IPv4):  # pragma: no cover - needs hardware
    """Open the DepthAI device at ``ip``, or None if not found."""
    dai = _require_depthai()
    infos = dai.Device.getAllAvailableDevices()
    for info in infos:
        if info.name == ip.ip:
            return dai.Device(info)
    logger.error(
        "Device with IP address %s not found. Possible IP addresses: %s",
        ip,
        ", ".join(info.name for info in infos),
    )
    return None


def get_luxonis_camera_valid_resolutions(device, socket) -> list[tuple[int, int]]:  # pragma: no cover
    """Valid (width, height) configs for one camera socket."""
    for feature in device.getConnectedCameraFeatures():
        if feature.socket == socket:
            return [(cfg.width, cfg.height) for cfg in feature.configs]
    logger.warning("No valid resolutions found for device %s with socket %s", device.getMxId(), socket)
    return []


def get_luxonis_camera_valid_modes(device, socket) -> list:  # pragma: no cover
    """Supported sensor types (COLOR/MONO) for one camera socket."""
    for feature in device.getConnectedCameraFeatures():
        if feature.socket == socket:
            return list(feature.supportedTypes)
    logger.warning("No valid modes found for device %s with socket %s", device.getMxId(), socket)
    return []


def prompt_for_resolution(
    choices: list[tuple[int, int]],
    prompt: str = "Select a resolution",
    input_fn=input,
) -> tuple[int, int] | None:
    """Interactively pick one of ``choices`` (reference camera/utils.py:55-96).

    Prints a numbered menu and reads an index; returns the chosen
    (width, height), or None on empty choices / EOF / explicit quit ("q").
    ``input_fn`` is injectable so the menu is unit-testable without a TTY.
    """
    if not choices:
        logger.warning("No resolutions to choose from")
        return None
    print(prompt + ":")
    for i, (w, h) in enumerate(choices):
        print(f"  [{i}] {w}x{h}")
    while True:
        try:
            raw = input_fn(f"choice [0-{len(choices) - 1}] (q to abort): ").strip()
        except EOFError:
            return None
        if raw.lower() in ("q", "quit", ""):
            return None
        try:
            idx = int(raw)
        except ValueError:
            print(f"not a number: {raw!r}")
            continue
        if 0 <= idx < len(choices):
            return choices[idx]
        print(f"out of range: {idx}")
