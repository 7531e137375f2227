"""Rectified stereo triangulation, batched over cameras.

Port of ``match_disparities`` and ``stereo_triangulate`` from
:mod:`thor_slam_tpu.engine.triangulate`.
"""

from __future__ import annotations

import torch


def stereo_triangulate(
    xy_left: torch.Tensor,
    disparity: torch.Tensor,
    k_rect: torch.Tensor,
    baseline_m: torch.Tensor,
    min_disparity: float = 0.25,
    max_depth_m: float = 40.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rectified pixel + disparity -> 3D point in the rectified left frame.

    Args:
        xy_left: (C, N, 2) rectified left pixels.
        disparity: (C, N) disparities (x_left - x_right).
        k_rect: (C, 3) rectified (f, cx, cy), fx == fy.
        baseline_m: (C,) rectified baselines.

    Returns:
        (points (C, N, 3), valid (C, N)).
    """
    fx, cx, cy = k_rect[:, 0, None], k_rect[:, 1, None], k_rect[:, 2, None]
    d = torch.clamp(disparity, min=1e-6)
    z = fx * baseline_m[:, None] / d
    x = (xy_left[..., 0] - cx) * z / fx
    y = (xy_left[..., 1] - cy) * z / fx
    pts = torch.stack([x, y, z], -1)
    valid = (disparity >= min_disparity) & (z <= max_depth_m) & (z > 0)
    return pts, valid


def match_disparities(
    xy_left: torch.Tensor,
    xy_right: torch.Tensor,
    match_idx: torch.Tensor,
    match_valid: torch.Tensor,
    max_dy: float = 1.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Disparities of left->right matches on rectified (C, N, 2) / (C, M, 2) pairs.

    Returns (disparity (C, N), valid (C, N)): match valid, epipolar-
    consistent and positive.
    """
    matched = torch.gather(xy_right, 1, match_idx[..., None].expand(-1, -1, 2))
    disparity = xy_left[..., 0] - matched[..., 0]
    dy = torch.abs(xy_left[..., 1] - matched[..., 1])
    valid = match_valid & (dy <= max_dy) & (disparity > 0)
    return torch.where(valid, disparity, 0.0), valid
