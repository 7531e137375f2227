"""FAST-9 keypoint detection with a fixed, bucketed budget.

Port of :mod:`thor_slam_tpu.ops.fast`: dense FAST-9 response and 3x3 NMS
(the kernel in :mod:`thor_slam_tpu_torch.ops.fast_cuda`), then per-cell
top-k, a global top-N and parabola subpixel refinement. Output shapes are
fixed; empty slots are masked.

Tie order: the reference takes its top-k with ``lax.top_k`` and argmax
rounds, both of which return equal scores lowest index first. ``torch.topk``
does not promise that, so selection here is a stable descending sort.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from thor_slam_tpu_torch.ops import fast_cuda


class Keypoints(NamedTuple):
    """A fixed-capacity keypoint set per camera.

    Attributes:
        xy: (C, N, 2) float32 (x, y) pixels (0 in empty slots).
        score: (C, N) float32 corner response (0 in empty slots).
        valid: (C, N) bool slot mask.
    """

    xy: torch.Tensor
    score: torch.Tensor
    valid: torch.Tensor


def _top_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, equal values lowest index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _select_keypoints(
    raw: torch.Tensor,
    score: torch.Tensor,
    max_keypoints: int,
    cell_size: int,
    per_cell: int,
    border_margin: int,
) -> Keypoints:
    """Bucketing + top-N + subpixel refinement from (C, H, W) response maps.

    ``raw`` is the pre-NMS response (for the parabola fits), ``score`` the
    NMS'd one.
    """
    c, h, w = raw.shape
    dev = raw.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inside = (ys >= border_margin) & (ys < h - border_margin) & (xs >= border_margin) & (xs < w - border_margin)
    score = torch.where(inside, score, 0.0)

    gh = -(-h // cell_size)
    gw = -(-w // cell_size)
    padded = score.new_zeros((c, gh * cell_size, gw * cell_size))
    padded[:, :h, :w] = score
    cells = padded.reshape(c, gh, cell_size, gw, cell_size).permute(0, 1, 3, 2, 4)
    cells = cells.reshape(c, gh * gw, cell_size * cell_size)
    cell_scores, cell_idx = _top_stable(cells, per_cell)  # (C, G, per_cell)

    cell_ids = torch.arange(gh * gw, device=dev)[:, None]
    cy = (cell_ids // gw) * cell_size + cell_idx // cell_size
    cx = (cell_ids % gw) * cell_size + cell_idx % cell_size
    flat_scores = cell_scores.reshape(c, -1)
    flat_y = cy.reshape(c, -1)
    flat_x = cx.reshape(c, -1)

    k = min(max_keypoints, flat_scores.shape[1])
    top_scores, top_i = _top_stable(flat_scores, k)
    if k < max_keypoints:  # small images: pad the candidate pool
        pad = max_keypoints - k
        top_scores = torch.cat([top_scores, top_scores.new_zeros((c, pad))], 1)
        top_i = torch.cat([top_i, top_i.new_zeros((c, pad))], 1)
    xi = torch.gather(flat_x, 1, top_i)
    yi = torch.gather(flat_y, 1, top_i)

    raw_flat = raw.reshape(c, -1)

    def sample(yy, xx):
        yy = torch.clamp(yy, 0, h - 1)
        xx = torch.clamp(xx, 0, w - 1)
        return torch.gather(raw_flat, 1, yy * w + xx)

    s_c = sample(yi, xi)
    s_l = sample(yi, xi - 1)
    s_r = sample(yi, xi + 1)
    s_u = sample(yi - 1, xi)
    s_d = sample(yi + 1, xi)
    denom_x = s_l - 2.0 * s_c + s_r
    denom_y = s_u - 2.0 * s_c + s_d
    ok_x = torch.abs(denom_x) > 1e-9
    ok_y = torch.abs(denom_y) > 1e-9
    dx = torch.where(ok_x, 0.5 * (s_l - s_r) / torch.where(ok_x, denom_x, 1.0), 0.0)
    dy = torch.where(ok_y, 0.5 * (s_u - s_d) / torch.where(ok_y, denom_y, 1.0), 0.0)
    dx = torch.clamp(dx, -0.5, 0.5)
    dy = torch.clamp(dy, -0.5, 0.5)

    xy = torch.stack([xi.float() + dx, yi.float() + dy], -1)
    valid = top_scores > 0.0
    return Keypoints(
        xy=torch.where(valid[..., None], xy, 0.0),
        score=torch.where(valid, top_scores, 0.0),
        valid=valid,
    )


def detect_keypoints_batched(
    images: torch.Tensor,
    threshold: float = 0.06,
    max_keypoints: int = 512,
    cell_size: int = 32,
    per_cell: int = 8,
    border_margin: int = 20,
) -> Keypoints:
    """FAST-9 -> NMS -> grid bucketing -> global top-N over (C, H, W) images."""
    raw, score = fast_cuda.fast_scores_batched(images, threshold)
    return _select_keypoints(raw, score, max_keypoints, cell_size, per_cell, border_margin)
