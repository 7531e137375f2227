"""Bouguet stereo rectification: geometry, sampling maps, image rectify.

Port of :mod:`thor_slam_tpu.ops.rectify`. The geometry and the maps are
host numpy at init time, copied from the reference because that module
imports the JAX image ops; :func:`undistort_normalized` serves loop
verification and relocalization. The tracker rectifies keypoint coordinates and
needs only the rotations, the rectified intrinsics and the baseline, so
it builds no maps (``compute_maps=False``, the default here); the RGB-D
product remaps whole images with them (:func:`rectify_image`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from thor_slam_tpu_torch import geometry
from thor_slam_tpu_torch.camera.types import Extrinsics, Intrinsics
from thor_slam_tpu_torch.ops.image import remap_bilinear

_NO_MAP = (np.zeros((0, 0), np.float32), np.zeros((0, 0), np.float32))


def _pad_coeffs(coeffs: np.ndarray) -> np.ndarray:
    c = np.zeros(5)
    coeffs = np.asarray(coeffs, dtype=np.float64).reshape(-1)
    c[: min(5, coeffs.size)] = coeffs[:5]
    return c


def distort_normalized(pts: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """Apply plumb-bob distortion (k1, k2, p1, p2, k3) to normalized points (..., 2)."""
    k1, k2, p1, p2, k3 = _pad_coeffs(coeffs)
    x, y = pts[..., 0], pts[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def undistort_normalized(pts: np.ndarray, coeffs: np.ndarray, iters: int = 8) -> np.ndarray:
    """Invert plumb-bob distortion of normalized points (..., 2) by
    fixed-point iteration (OpenCV-style)."""
    k1, k2, p1, p2, k3 = _pad_coeffs(coeffs)
    xd, yd = pts[..., 0], pts[..., 1]
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return np.stack([x, y], axis=-1)


def init_undistort_rectify_map(
    intrinsics: Intrinsics,
    rect_rotation: np.ndarray,
    new_matrix: np.ndarray,
    out_width: int,
    out_height: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(map_x, map_y) float32 (out_height, out_width): rectified pixel ->
    source-image coordinates, ``cv2.initUndistortRectifyMap`` semantics.

    Each output pixel's ray ``new_K^-1 p`` is rotated back by
    ``rect_rotation^T``, perspective-divided, distorted and projected
    through the original K. Rays behind the camera map to -1e6, which
    every sampler treats as outside the image.
    """
    u, v = np.meshgrid(
        np.arange(out_width, dtype=np.float64), np.arange(out_height, dtype=np.float64)
    )
    kn_inv = np.linalg.inv(new_matrix)
    rays = np.stack([u, v, np.ones_like(u)], axis=-1) @ kn_inv.T  # (H, W, 3)
    rays = rays @ rect_rotation  # == (R^T @ ray) for each ray
    z = rays[..., 2]
    safe_z = np.where(np.abs(z) < 1e-9, 1e-9, z)
    xn = rays[..., 0] / safe_z
    yn = rays[..., 1] / safe_z
    dist = distort_normalized(np.stack([xn, yn], axis=-1), intrinsics.coeffs)
    k = intrinsics.matrix
    map_x = k[0, 0] * dist[..., 0] + k[0, 2]
    map_y = k[1, 1] * dist[..., 1] + k[1, 2]
    invalid = z <= 1e-9
    map_x = np.where(invalid, -1e6, map_x)
    map_y = np.where(invalid, -1e6, map_y)
    return map_x.astype(np.float32), map_y.astype(np.float32)


@dataclass
class StereoRectification:
    """Rectified geometry of one stereo pair.

    Attributes:
        rect_rotation_left/right: 3x3 old-cam -> rectified-cam rotations.
        new_matrix: Shared rectified camera matrix K'.
        baseline_m: Rectified baseline (meters).
        width, height: Rectified image size.
        map_left/map_right: (map_x, map_y) sampling maps per camera; empty
            (0, 0) arrays when built with ``compute_maps=False``.
    """

    rect_rotation_left: np.ndarray
    rect_rotation_right: np.ndarray
    new_matrix: np.ndarray
    baseline_m: float
    width: int
    height: int
    map_left: tuple[np.ndarray, np.ndarray] = field(default=_NO_MAP)
    map_right: tuple[np.ndarray, np.ndarray] = field(default=_NO_MAP)

    @property
    def fx(self) -> float:
        return float(self.new_matrix[0, 0])


def stereo_rectify(
    left: Intrinsics,
    right: Intrinsics,
    left_t_right: np.ndarray,
    out_width: int | None = None,
    out_height: int | None = None,
    compute_maps: bool = False,
) -> StereoRectification:
    """Bouguet rectification; ``left_t_right`` is the right camera's pose
    in the left camera frame (p_left = left_T_right @ p_right).
    ``compute_maps`` also builds both cameras' sampling maps."""
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

    rect_l = r_align @ half_l
    rect_r = r_align @ half_r
    f = 0.25 * (left.fx + left.fy + right.fx + right.fy)
    k_new = np.array([[f, 0.0, out_width / 2.0], [0.0, f, out_height / 2.0], [0.0, 0.0, 1.0]])
    maps = {}
    if compute_maps:
        maps = dict(
            map_left=init_undistort_rectify_map(left, rect_l, k_new, out_width, out_height),
            map_right=init_undistort_rectify_map(right, rect_r, k_new, out_width, out_height),
        )
    return StereoRectification(
        rect_rotation_left=rect_l,
        rect_rotation_right=rect_r,
        new_matrix=k_new,
        baseline_m=float(np.linalg.norm(t_new)),
        width=out_width,
        height=out_height,
        **maps,
    )


def rectification_from_extrinsics(
    left: Intrinsics,
    right: Intrinsics,
    left_ext: Extrinsics,
    right_ext: Extrinsics,
    out_width: int | None = None,
    out_height: int | None = None,
    compute_maps: bool = False,
) -> StereoRectification:
    """Rectification from per-imager source_T_cam extrinsics."""
    left_t_right = geometry.se3_inverse(left_ext.to_4x4_matrix()) @ right_ext.to_4x4_matrix()
    return stereo_rectify(left, right, left_t_right, out_width, out_height, compute_maps)


def rectify_image(images: torch.Tensor, rect_map: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Remap (..., H, W) images through a (map_x, map_y) pair on their device."""
    map_x, map_y = rect_map
    return remap_bilinear(images, map_x, map_y)
