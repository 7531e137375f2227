"""Subpixel stereo disparity refinement (the sparse keyframe path).

Port of ``thor_slam_tpu.ops.stereo.refine_disparity_photometric``. Dense
SGM stereo (the RGB-D depth product) is not part of this package yet.
"""

from __future__ import annotations

import torch

from thor_slam_tpu_torch.ops.image import extract_patches


def refine_disparity_photometric(
    left: torch.Tensor,
    right: torch.Tensor,
    xy_left: torch.Tensor,
    disparity: torch.Tensor,
    valid: torch.Tensor,
    patch_radius: int = 3,
) -> torch.Tensor:
    """Subpixel disparity by a parabola through patch SADs at d-1, d, d+1.

    Args:
        left: (C, H, W) left images.
        right: (C, H, W) right images.
        xy_left: (C, N, 2) left keypoints.
        disparity: (C, N) coarse disparities.
        valid: (C, N) mask.

    Returns:
        (C, N) refined disparities (the coarse value where the refinement
        is ill-conditioned or the slot invalid).
    """
    h, w = left.shape[-2:]
    r = patch_radius
    size = 2 * r + 1
    x0 = torch.clamp(torch.round(xy_left[..., 0]).int(), r + 1, w - r - 2)
    y0 = torch.clamp(torch.round(xy_left[..., 1]).int(), r, h - r - 1)
    d0 = torch.round(disparity).int()
    lpatch = extract_patches(left, torch.stack([x0, y0], -1), size)

    def sad_at(offset):
        xr = torch.clamp(x0 - d0 + offset, r, w - r - 1)
        rp = extract_patches(right, torch.stack([xr, y0], -1), size)
        return torch.sum(torch.abs(lpatch - rp), dim=(-2, -1))

    s_m = sad_at(-1)  # disparity d0 + 1
    s_0 = sad_at(0)
    s_p = sad_at(1)  # disparity d0 - 1
    denom = s_m - 2.0 * s_0 + s_p
    ok_d = torch.abs(denom) > 1e-9
    off = torch.where(ok_d, 0.5 * (s_p - s_m) / torch.where(ok_d, denom, 1.0), 0.0)
    off = torch.clamp(off, -1.0, 1.0)
    refined = d0.float() + off
    ok = valid & (s_0 <= s_m) & (s_0 <= s_p)
    return torch.where(ok, refined, disparity)
