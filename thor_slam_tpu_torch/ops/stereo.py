"""Stereo: dense census + SGM disparity (the RGB-D depth product) and the
sparse keyframe path's subpixel refinement.

Port of :mod:`thor_slam_tpu.ops.stereo`. Dense SGM runs the census
transform and the Hamming cost volume as plain tensor code, then the two
hand-written kernels of :mod:`thor_slam_tpu_torch.ops.sgm_cuda` (4-direction
path aggregation, winner + left-right data) and the reference's subpixel /
uniqueness / LR tail. The aggregation is the exact recurrence always: the
reference's blocked-halo scan is a workaround for TPU scan latency and
approximates it.
"""

from __future__ import annotations

import torch

from thor_slam_tpu_torch.ops import sgm_cuda
from thor_slam_tpu_torch.ops.image import extract_patches
from thor_slam_tpu_torch.ops.match import popcount32

CENSUS_MAX_COST = 32.0  # cost where x < d: finite, never better than a match


def census_transform(images: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Census codes of (..., H, W) float32 images -> (..., H, W) int64.

    Bit ``b`` is (neighbor < center) for the b-th neighbour in dy-major,
    then dx order (centre skipped), neighbours edge-replicated at the
    border: the reference's bit layout. A 5x5 window gives 24-bit codes,
    held in int64 because PyTorch's uint32 has few ops.
    """
    r = window // 2
    if window * window - 1 > 32:
        raise ValueError(f"census window {window} has more than 32 neighbours")
    h, w = images.shape[-2:]
    rows = torch.clamp(torch.arange(-r, h + r, device=images.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-r, w + r, device=images.device), 0, w - 1)
    padded = images[..., rows, :][..., cols]
    code = torch.zeros(images.shape, dtype=torch.int64, device=images.device)
    bit = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            neighbor = padded[..., r + dy : r + dy + h, r + dx : r + dx + w]
            code = code | ((neighbor < images).long() << bit)
            bit += 1
    return code


def census_cost_volume(census_l: torch.Tensor, census_r: torch.Tensor, num_disparities: int) -> torch.Tensor:
    """(D, H, W) float32 Hamming costs: cost[d, y, x] = ham(L[y, x], R[y, x - d]).

    The right codes are shifted with edge padding, so x < d reads column 0,
    and those comparisons cost 32: finite for SGM smoothing, never a win.
    """
    h, w = census_l.shape
    dev = census_l.device
    xs = torch.arange(w, device=dev)
    src = xs[None, :] - torch.arange(num_disparities, device=dev)[:, None]  # (D, W)
    shifted = census_r[:, torch.clamp(src, min=0)]  # (H, D, W)
    cost = popcount32(census_l[:, None, :] ^ shifted).float()
    cost = torch.where(src[None] >= 0, cost, CENSUS_MAX_COST)
    return cost.permute(1, 0, 2).contiguous()


def disparity_from_winners(
    d_best: torch.Tensor,
    c0: torch.Tensor,
    cm: torch.Tensor,
    cp: torch.Tensor,
    second: torch.Tensor,
    d_r_at: torch.Tensor,
    num_disparities: int,
    lr_threshold: float = 1.25,
    uniqueness: float = 0.95,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The subpixel / uniqueness / left-right / in-range tail of SGM on the
    outputs of :func:`sgm_cuda.winner_lr` -> (disparity, valid), (H, W)."""
    h, w = d_best.shape
    # Subpixel parabola: offset = (cm - cp) / (2 (cm - 2 c0 + cp)). The
    # reference clamps the denominator with maximum(), not abs().
    denom = cm - 2.0 * c0 + cp
    offset = torch.where(torch.abs(denom) > 1e-6, 0.5 * (cm - cp) / torch.clamp(denom, min=1e-6), 0.0)
    offset = torch.clamp(offset, -0.5, 0.5)
    interior = (d_best > 0) & (d_best < num_disparities - 1)
    disp = d_best.float() + torch.where(interior, offset, 0.0)

    unique_ok = c0 <= uniqueness * second
    lr_ok = torch.abs(d_best - d_r_at) <= lr_threshold
    xs = torch.arange(w, device=d_best.device)[None, :]
    in_range = xs >= d_best  # matched pixel inside the right image
    valid = unique_ok & lr_ok & in_range & (d_best > 0)
    return torch.where(valid, disp, 0.0), valid


def sgm_disparity(
    left: torch.Tensor,
    right: torch.Tensor,
    num_disparities: int = 64,
    p1: float = 6.0,
    p2: float = 96.0,
    num_paths: int = 4,
    lr_threshold: float = 1.25,
    uniqueness: float = 0.95,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Semi-global matching disparity for a rectified (H, W) float32 pair.

    Returns (disparity, valid): (H, W) float32 subpixel disparities (0
    where invalid) and the (H, W) bool mask. Arguments as the reference's
    ``stereo.sgm_disparity``.
    """
    codes = census_transform(torch.stack([left, right]))
    cost = census_cost_volume(codes[0], codes[1], num_disparities)
    agg = sgm_cuda.sgm_aggregate_4dir(cost, p1, p2, num_paths)
    winners = sgm_cuda.winner_lr(agg, num_disparities)
    return disparity_from_winners(*winners, num_disparities, lr_threshold, uniqueness)


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


def disparity_to_depth(disparity: torch.Tensor, valid: torch.Tensor, fx: float, baseline_m: float) -> torch.Tensor:
    """Depth (m) from disparity; invalid pixels get 0."""
    # A true f32 division (``scalar / tensor`` would multiply by a reciprocal).
    z = torch.full_like(disparity, fx * baseline_m) / torch.clamp(disparity, min=1e-6)
    return torch.where(valid, z, 0.0)


def depth_to_millimeters_u16(depth_m: torch.Tensor) -> torch.Tensor:
    """Depth (m) -> 16UC1 millimetres, the nvblox feed encoding (round half
    to even, as ``jnp.round``)."""
    return torch.clamp(torch.round(depth_m * 1000.0), 0.0, 65535.0).to(torch.uint16)
