"""Pyramidal inverse-compositional Lucas-Kanade over all rig tracks.

Port of :mod:`thor_slam_tpu.ops.klt`. Per track and level one window is
gathered around the integer initial position (the patch-gather kernel,
:mod:`thor_slam_tpu_torch.ops.patches_cuda`), its integer-shifted views are
materialized once (an im2col copy), and bilinear sampling at any
fractional offset is a contraction of one-hot-lerp weights with those
views. The reference's ``(M, K^2, P^2)`` view algebra and the ``vproj``
projection are kept so the numbers follow it; the TPU-only
``optimization_barrier`` is gone (PyTorch runs eagerly).

Nothing here copies from the host, so the whole tracker can be captured in
a CUDA graph; the gather is a parameter (``gather``), so that a capture can
run it between its graphs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from thor_slam_tpu_torch.ops import patches_cuda


class TrackResult(NamedTuple):
    """Tracks of C*N points into the current frame, (C, N)-shaped.

    Attributes:
        xy: (C, N, 2) refined positions.
        residual: (C, N) mean absolute photometric error of the final patch.
        valid: (C, N) bool: in bounds and residual below the gate.
    """

    xy: torch.Tensor
    residual: torch.Tensor
    valid: torch.Tensor


def _extract_windows(
    prev: torch.Tensor, cur: torch.Tensor, cam: torch.Tensor, centers: torch.Tensor, wr: int, gather=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Windows of both frames of a level: (2, M, S, S) at the clipped integer
    centres, and the (2, M, 2) clipped centres, from one gather launch
    (``gather``, called as :func:`patches_cuda.extract_patches_pair`, its
    default).

    ``centers`` is (2, M, 2) int32: row 0 in ``prev``, row 1 in ``cur``. The
    gather clips them to [wr, W-wr-1] x [wr, H-wr-1] itself (the reference
    clamps them in tensor code before its gather) and returns what it used.
    """
    gather = patches_cuda.extract_patches_pair if gather is None else gather
    return gather(prev, cur, cam, centers, 2 * wr + 1)


def _shifted_views(win: torch.Tensor, radius: int, m: int) -> torch.Tensor:
    """All integer-shift (P x P) views of (S x S) windows: (M, K*K, P*P).

    View (a, b) is the patch at integer offset (a - m, b - m) from the
    window centre, flattened row-major: the im2col layout of the
    reference's ``conv_general_dilated_patches``. The sliding windows are a
    strided view (``Tensor.unfold``), materialized by one copy;
    ``F.unfold`` computes the same values but launches one im2col kernel
    per window on CUDA.
    """
    n = win.shape[0]
    p = 2 * radius + 1
    k = 2 * m + 2
    views = win.unfold(1, p, 1).unfold(2, p, 1)  # (M, S-P+1, S-P+1, P, P)
    # The view at shift (a - m, b - m) has top-left (a + 1, b + 1).
    return views[:, 1 : 1 + k, 1 : 1 + k].reshape(n, k * k, p * p)


def _interp_weights(d: torch.Tensor, m: int) -> torch.Tensor:
    """Bilinear one-hot-lerp weights over the K*K shift grid: (..., K*K).

    d: (..., 2) fractional offsets from the window centre, in [-m, m].
    """
    k = 2 * m + 2
    fl = torch.floor(d)
    fr = d - fl
    base = (fl + m).long()
    j = torch.arange(k, device=d.device)

    def axis_w(base_a, fr_a):
        b = base_a[..., None]
        f = fr_a[..., None]
        return torch.where(j == b, 1.0 - f, torch.where(j == b + 1, f, 0.0))

    wx = axis_w(base[..., 0], fr[..., 0])  # (..., K)
    wy = axis_w(base[..., 1], fr[..., 1])
    return (wy[..., :, None] * wx[..., None, :]).reshape(*d.shape[:-1], k * k)


def _lk_level(
    prev: torch.Tensor,
    cur: torch.Tensor,
    cam: torch.Tensor,
    pts_prev: torch.Tensor,
    pts_cur: torch.Tensor,
    radius: int,
    iters: int,
    m: int,
    gather,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse-compositional LK at one level, flat over all M rig tracks."""
    wr = radius + m + 1
    n = pts_prev.shape[0]
    centers = torch.round(torch.stack([pts_prev, pts_cur])).int()
    win, ctr = _extract_windows(prev, cur, cam, centers, wr, gather)
    views = _shifted_views(win.reshape(2 * n, *win.shape[2:]), radius, m)  # both frames, one copy
    views_p, views_c = views[:n], views[n:]
    cp, cc = ctr.float().unbind(0)
    mf = float(m)

    # Template + central-difference gradients at the previous position: all
    # five samples in one (M, 5, K^2) x (M, K^2, P^2) contraction.
    d_t = torch.clamp(pts_prev - cp, -1.0, 1.0)
    ex, ey = torch.eye(2, dtype=d_t.dtype, device=d_t.device)  # unit offsets, made on the device
    w5 = torch.stack([_interp_weights(d_t + o, m) for o in (0.0, ex, -ex, ey, -ey)], 1)
    tp = torch.bmm(w5, views_p)  # (M, 5, P^2)
    t = tp[:, 0]
    gx = 0.5 * (tp[:, 1] - tp[:, 2])
    gy = 0.5 * (tp[:, 3] - tp[:, 4])

    gxx = torch.sum(gx * gx, 1)
    gxy = torch.sum(gx * gy, 1)
    gyy = torch.sum(gy * gy, 1)
    det = gxx * gyy - gxy * gxy
    inv_ok = det > 1e-8
    det_safe = torch.where(inv_ok, det, 1.0)

    # The update needs only e.gx and e.gy; sampling is linear, so project
    # the current views onto (gx, gy) once: (M, K^2, 2).
    vproj = torch.bmm(views_c, torch.stack([gx, gy], 1).transpose(1, 2))
    tgx = torch.sum(t * gx, 1)
    tgy = torch.sum(t * gy, 1)

    xy = cc + torch.clamp(pts_cur - cc, -mf, mf)
    for _ in range(iters):
        d = torch.clamp(xy - cc, -mf, mf)
        w2 = _interp_weights(d, m)
        bx = torch.sum(w2 * vproj[:, :, 0], 1) - tgx
        by = torch.sum(w2 * vproj[:, :, 1], 1) - tgy
        ux = (gyy * bx - gxy * by) / det_safe
        uy = (gxx * by - gxy * bx) / det_safe
        step = torch.clamp(torch.stack([ux, uy], -1), -float(radius), float(radius))
        xy = xy - step * inv_ok[:, None]
        xy = cc + torch.clamp(xy - cc, -mf, mf)
    w_fin = _interp_weights(torch.clamp(xy - cc, -mf, mf), m)
    sampled = torch.bmm(w_fin[:, None, :], views_c)[:, 0]
    resid = torch.mean(torch.abs(sampled - t), 1)

    # A clamped window cannot represent the track: pass the input through
    # unrefined and let finer levels (whose windows fit) handle it.
    clipped = (torch.amax(torch.abs(pts_prev - cp), 1) > 1.5) | (
        torch.amax(torch.abs(pts_cur - cc), 1) > m
    )
    xy = torch.where(clipped[:, None], pts_cur, xy)
    resid = torch.where(clipped, 0.0, resid)
    return xy, resid


def track_points_rig(
    prev_pyramid: tuple[torch.Tensor, ...],
    cur_pyramid: tuple[torch.Tensor, ...],
    pts_prev: torch.Tensor,
    pts_init: torch.Tensor,
    valid: torch.Tensor,
    num_levels: int = 3,
    radius: int = 4,
    iters: int = 8,
    max_residual: float = 0.08,
    border: int = 4,
    search: int = 4,
    gather=None,
) -> TrackResult:
    """Track all rig points from the previous frame into the current one.

    Args:
        prev_pyramid: (C, H/2^l, W/2^l) stacks, level 0 first.
        cur_pyramid: Same structure for the current frame.
        pts_prev: (C, N, 2) template positions in the previous frame.
        pts_init: (C, N, 2) initial guesses in the current frame.
        valid: (C, N) bool input mask.
        num_levels: Pyramid levels used.
        radius: Patch half-size.
        iters: LK iterations per level.
        max_residual: Mean-absolute-error acceptance gate.
        border: Reject tracks closer than this to the border (at least the
            level-0 window radius).
        search: Per-level search half-range m in pixels.
        gather: The windows' patch gather (:func:`_extract_windows`).
    """
    c, n = pts_prev.shape[:2]
    cam = torch.arange(c, dtype=torch.int32, device=pts_prev.device).repeat_interleave(n)
    pts_prev = pts_prev.reshape(c * n, 2)
    xy = pts_init.reshape(c * n, 2) / 2.0 ** (num_levels - 1)
    resid = torch.zeros(c * n, device=pts_prev.device)
    for lvl in range(num_levels - 1, -1, -1):
        s = 2.0**lvl
        xy, resid = _lk_level(
            prev_pyramid[lvl], cur_pyramid[lvl], cam, pts_prev / s, xy, radius, iters, search, gather
        )
        if lvl > 0:
            xy = xy * 2.0

    h, w = cur_pyramid[0].shape[1:]
    border = max(border, radius + search + 1)
    in_bounds = (
        (xy[:, 0] >= border) & (xy[:, 0] < w - border) & (xy[:, 1] >= border) & (xy[:, 1] < h - border)
    )
    ok = valid.reshape(c * n) & in_bounds & (resid <= max_residual)
    return TrackResult(xy=xy.reshape(c, n, 2), residual=resid.reshape(c, n), valid=ok.reshape(c, n))
