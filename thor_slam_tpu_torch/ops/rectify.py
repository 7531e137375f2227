"""Bouguet stereo rectification geometry from calibrated extrinsics (numpy).

The map-free part of :mod:`thor_slam_tpu.ops.rectify`, re-homed here
because that module imports the JAX image ops: the tracker rectifies
keypoint coordinates, never images, so it needs only the rectifying
rotations, the shared rectified intrinsics and the baseline. Image
remapping (the RGB-D product) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from thor_slam_tpu import geometry
from thor_slam_tpu.camera.types import Extrinsics, Intrinsics


@dataclass
class StereoRectification:
    """Rectified geometry of one stereo pair.

    Attributes:
        rect_rotation_left/right: 3x3 old-cam -> rectified-cam rotations.
        new_matrix: Shared rectified camera matrix K'.
        baseline_m: Rectified baseline (meters).
        width, height: Rectified image size.
    """

    rect_rotation_left: np.ndarray
    rect_rotation_right: np.ndarray
    new_matrix: np.ndarray
    baseline_m: float
    width: int
    height: int

    @property
    def fx(self) -> float:
        return float(self.new_matrix[0, 0])


def stereo_rectify(
    left: Intrinsics,
    right: Intrinsics,
    left_t_right: np.ndarray,
    out_width: int | None = None,
    out_height: int | None = None,
) -> StereoRectification:
    """Bouguet rectification; ``left_t_right`` is the right camera's pose
    in the left camera frame (p_left = left_T_right @ p_right)."""
    out_width = out_width or left.width
    out_height = out_height or left.height

    r_lr = left_t_right[:3, :3]
    t_lr = left_t_right[:3, 3]

    # Split the relative rotation evenly between the two cameras.
    q = geometry.matrix_to_quat(r_lr)
    angle = 2.0 * np.arctan2(np.linalg.norm(q[:3]), q[3])
    axis = q[:3] / max(np.linalg.norm(q[:3]), 1e-12)
    half_l = geometry.quat_to_matrix(geometry.axis_angle_to_quat(axis, -angle / 2.0))
    half_r = half_l @ r_lr
    t_new = half_l @ t_lr

    # Rotate so the new +x axis runs along the baseline.
    e1 = t_new / np.linalg.norm(t_new)
    if e1[0] < 0:
        e1 = -e1  # keep left->right along +x so disparity is positive
    e2 = np.array([-e1[1], e1[0], 0.0])
    n2 = np.linalg.norm(e2)
    if n2 < 1e-9:  # baseline along z (degenerate): any perpendicular
        e2 = np.array([0.0, 1.0, 0.0])
    else:
        e2 = e2 / n2
    e3 = np.cross(e1, e2)
    r_align = np.stack([e1, e2, e3])

    f = 0.25 * (left.fx + left.fy + right.fx + right.fy)
    k_new = np.array([[f, 0.0, out_width / 2.0], [0.0, f, out_height / 2.0], [0.0, 0.0, 1.0]])
    return StereoRectification(
        rect_rotation_left=r_align @ half_l,
        rect_rotation_right=r_align @ half_r,
        new_matrix=k_new,
        baseline_m=float(np.linalg.norm(t_new)),
        width=out_width,
        height=out_height,
    )


def rectification_from_extrinsics(
    left: Intrinsics,
    right: Intrinsics,
    left_ext: Extrinsics,
    right_ext: Extrinsics,
    out_width: int | None = None,
    out_height: int | None = None,
) -> StereoRectification:
    """Rectification from per-imager source_T_cam extrinsics."""
    left_t_right = geometry.se3_inverse(left_ext.to_4x4_matrix()) @ right_ext.to_4x4_matrix()
    return stereo_rectify(left, right, left_t_right, out_width, out_height)
