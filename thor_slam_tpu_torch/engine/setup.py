"""Build the tracker's per-camera constants from a RigCalibration.

Port of :func:`thor_slam_tpu.engine.setup.build_camera_setup` for stereo
sources (numpy, run once at initialize). The result holds numpy arrays in
the reference's layout; :func:`thor_slam_tpu_torch.engine.convert.setup_to_torch`
moves it to a device.
"""

from __future__ import annotations

import numpy as np

from thor_slam_tpu_torch import geometry
from thor_slam_tpu_torch.camera.rig import RigCalibration
from thor_slam_tpu_torch.engine.tracker import CameraSetup
from thor_slam_tpu_torch.ops import rectify


def build_camera_setup(calibration: RigCalibration) -> tuple[CameraSetup, list[str], int, int]:
    """Rectified geometry for every stereo source, ordered by source name.

    Returns:
        (setup of numpy arrays, source_order, height, width).

    Raises:
        NotImplementedError: For a mono source (ROADMAP Queue 1 #11).
        RuntimeError: On mixed resolutions.
    """
    source_order = sorted(calibration.source_names)
    cols: dict[str, list] = {f: [] for f in CameraSetup._fields}
    height = width = None

    def k4(intr):
        return np.asarray([intr.fx, intr.fy, intr.cx, intr.cy], np.float32)

    def dist5(intr):
        d = np.zeros(5, np.float32)
        c = np.asarray(intr.coeffs, np.float32).reshape(-1)
        d[: min(5, c.size)] = c[:5]
        return d

    for name in source_order:
        intrs = calibration.intrinsics[name]
        exts = calibration.extrinsics[name]
        if len(intrs) < 2:
            raise NotImplementedError(
                f"source {name!r} is mono: mono sources are not ported yet (ROADMAP Queue 1 #11)"
            )
        world_exts = calibration.get_world_extrinsics(name)
        body_t_caml = world_exts[0].to_4x4_matrix()
        cam_t_body = geometry.se3_inverse(body_t_caml)
        sr = rectify.rectification_from_extrinsics(intrs[0], intrs[1], exts[0], exts[1])
        if height is None:
            height, width = sr.height, sr.width
        elif (sr.height, sr.width) != (height, width):
            raise RuntimeError("All sources must share one resolution for dense stacking")
        camr_t_body = geometry.se3_inverse(world_exts[1].to_4x4_matrix())

        cols["k_left"].append(k4(intrs[0]))
        cols["k_right"].append(k4(intrs[1]))
        cols["dist_left"].append(dist5(intrs[0]))
        cols["dist_right"].append(dist5(intrs[1]))
        cols["rect_left"].append(sr.rect_rotation_left)
        cols["rect_right"].append(sr.rect_rotation_right)
        cols["k_rect"].append(
            np.asarray([sr.fx, sr.new_matrix[0, 2], sr.new_matrix[1, 2]], np.float32)
        )
        cols["baseline"].append(sr.baseline_m)
        cols["cam_r_body"].append(cam_t_body[:3, :3])
        cols["cam_t_body"].append(cam_t_body[:3, 3])
        cols["body_t_cam"].append(body_t_caml)
        cols["cam_r_body_right"].append(camr_t_body[:3, :3])
        cols["cam_t_body_right"].append(camr_t_body[:3, 3])
        cols["stereo_mask"].append(True)

    setup = CameraSetup(
        **{
            f: np.asarray(v, bool) if f == "stereo_mask" else np.stack(v).astype(np.float32)
            for f, v in cols.items()
        }
    )
    return setup, source_order, height, width
