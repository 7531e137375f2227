"""Camera calibration math on point coordinates: distort, undistort, rectify.

Port of :mod:`thor_slam_tpu.ops.calib` (plumb-bob k1, k2, p1, p2, k3). The
tracker rectifies coordinates, never images. Functions take per-camera
parameters with a leading camera axis where the reference is ``vmap``-ed:
points (C, N, 2), intrinsics (C, 4), coefficients (C, 5), rotations
(C, 3, 3); a single camera passes C = 1 or unbatched parameters.
"""

from __future__ import annotations

import torch


def _c(p: torch.Tensor, i: int) -> torch.Tensor:
    """Coefficient ``i`` of (..., K) parameters, broadcastable over points."""
    return p[..., i, None]


def distort_normalized(pts: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Apply plumb-bob distortion to normalized points (..., N, 2)."""
    k1, k2, p1, p2, k3 = (_c(coeffs, i) for i in range(5))
    x, y = pts[..., 0], pts[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], -1)


def undistort_normalized(pts: torch.Tensor, coeffs: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Invert plumb-bob distortion by fixed-point iteration (..., N, 2)."""
    k1, k2, p1, p2, k3 = (_c(coeffs, i) for i in range(5))
    xd, yd = pts[..., 0], pts[..., 1]
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return torch.stack([x, y], -1)


def _pixels_to_normalized(xy_raw: torch.Tensor, k_raw: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            (xy_raw[..., 0] - _c(k_raw, 2)) / _c(k_raw, 0),
            (xy_raw[..., 1] - _c(k_raw, 3)) / _c(k_raw, 1),
        ],
        -1,
    )


def raw_pixels_to_rect(
    xy_raw: torch.Tensor,
    k_raw: torch.Tensor,
    dist: torch.Tensor,
    rect_rot: torch.Tensor,
    k_rect: torch.Tensor,
) -> torch.Tensor:
    """Raw (distorted) pixels (..., N, 2) -> rectified pixels (..., N, 2).

    ``k_raw`` (..., 4) = (fx, fy, cx, cy); ``rect_rot`` (..., 3, 3) old-cam
    -> rectified-cam; ``k_rect`` (..., 3) = (f, cx, cy).
    """
    xu = undistort_normalized(_pixels_to_normalized(xy_raw, k_raw), dist)
    rays = torch.cat([xu, torch.ones_like(xu[..., :1])], -1)
    r = rays @ rect_rot.transpose(-1, -2)
    z = torch.clamp(r[..., 2], min=1e-6)
    return torch.stack(
        [
            _c(k_rect, 0) * r[..., 0] / z + _c(k_rect, 1),
            _c(k_rect, 0) * r[..., 1] / z + _c(k_rect, 2),
        ],
        -1,
    )


def raw_pixels_to_normalized(
    xy_raw: torch.Tensor, k_raw: torch.Tensor, dist: torch.Tensor
) -> torch.Tensor:
    """Raw pixels -> undistorted normalized coords in the raw camera frame."""
    return undistort_normalized(_pixels_to_normalized(xy_raw, k_raw), dist)


def cam_points_to_raw_pixels(
    p_cam: torch.Tensor, k_raw: torch.Tensor, dist: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame points (..., N, 3) -> distorted raw pixels and z > 0 mask."""
    z = torch.clamp(p_cam[..., 2], min=1e-6)
    xn = torch.stack([p_cam[..., 0] / z, p_cam[..., 1] / z], -1)
    xd = distort_normalized(xn, dist)
    uv = torch.stack(
        [
            _c(k_raw, 0) * xd[..., 0] + _c(k_raw, 2),
            _c(k_raw, 1) * xd[..., 1] + _c(k_raw, 3),
        ],
        -1,
    )
    return uv, p_cam[..., 2] > 1e-3
