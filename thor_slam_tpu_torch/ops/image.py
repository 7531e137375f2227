"""Image ops on (C, H, W) float32 stacks: blur, pyramid, patch gather.

Port of the parts of :mod:`thor_slam_tpu.ops.image` the tracking tick
uses. Blur and pyramid keep the reference's arithmetic order (unrolled tap
sums with edge replication), so they agree with it to float rounding.
"""

from __future__ import annotations

import torch


def _gaussian_taps(sigma: float, radius: int) -> list[float]:
    """Normalized f32 taps as Python floats (exact f32 values)."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return (k / torch.sum(k)).tolist()


def gaussian_blur(images: torch.Tensor, sigma: float = 1.0, radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W) images with edge replication.

    Vertical pass then horizontal pass, each an unrolled sum of shifted
    slices in tap order, as the reference computes it.
    """
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    taps = _gaussian_taps(sigma, radius)
    h, w = images.shape[-2:]
    top = images[..., :1, :].expand(*images.shape[:-2], radius, w)
    bot = images[..., -1:, :].expand(*images.shape[:-2], radius, w)
    padded = torch.cat([top, images, bot], -2)
    out = torch.zeros_like(images)
    for i, k in enumerate(taps):
        out = out + k * padded[..., i : i + h, :]
    left = out[..., :, :1].expand(*out.shape[:-1], radius)
    right = out[..., :, -1:].expand(*out.shape[:-1], radius)
    padded = torch.cat([left, out, right], -1)
    out2 = torch.zeros_like(images)
    for i, k in enumerate(taps):
        out2 = out2 + k * padded[..., :, i : i + w]
    return out2


def downsample2(images: torch.Tensor, blur: bool = True) -> torch.Tensor:
    """Halve (..., H, W) images: 2x2 mean after an optional Gaussian."""
    if blur:
        images = gaussian_blur(images, sigma=1.0, radius=2)
    h2, w2 = images.shape[-2] // 2, images.shape[-1] // 2
    x = images[..., : h2 * 2, : w2 * 2]
    x = x.reshape(*x.shape[:-2], h2, 2, w2, 2)
    return x.mean(dim=(-3, -1))


def extract_patches_flat(
    images: torch.Tensor, cam: torch.Tensor, centers: torch.Tensor, size: int
) -> torch.Tensor:
    """(M, S, S) patches from a (C, H, W) stack at per-patch cameras.

    The clipped integer-centre gather of the reference's
    ``extract_patches_mxu``, by direct indexing: centres (M, 2) int (x, y)
    are clipped to [r, W-r-1] x [r, H-r-1] so every patch lies inside the
    image; ``cam`` (M,) is clipped to [0, C-1].
    """
    c, h, w = images.shape
    r = size // 2
    cx = torch.clamp(centers[:, 0].long(), r, w - r - 1)
    cy = torch.clamp(centers[:, 1].long(), r, h - r - 1)
    ci = torch.clamp(cam.long(), 0, c - 1)
    d = torch.arange(-r, r + 1, device=images.device)
    rows = (cy[:, None] + d[None, :])[:, :, None]  # (M, S, 1)
    cols = (cx[:, None] + d[None, :])[:, None, :]  # (M, 1, S)
    return images[ci[:, None, None], rows, cols]


def extract_patches(images: torch.Tensor, centers: torch.Tensor, size: int) -> torch.Tensor:
    """(C, N, S, S) patches from (C, H, W) images at (C, N, 2) int centres."""
    c, n = centers.shape[:2]
    cam = torch.arange(c, device=images.device).repeat_interleave(n)
    flat = extract_patches_flat(images, cam, centers.reshape(c * n, 2), size)
    return flat.reshape(c, n, size, size)
