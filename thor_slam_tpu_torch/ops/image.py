"""Image ops on (..., H, W) float32 stacks: blur, median, pyramid, patch
gather, bilinear remap and resize.

Port of the parts of :mod:`thor_slam_tpu.ops.image` the tracking tick and
the RGB-D product use. Every op keeps the reference's arithmetic order
(unrolled tap sums with edge replication; the bilinear blend's
floor/clip/weight order), so it agrees with it to float rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


#: Smith's median-of-9 exchange network (19 compare-exchanges).
_MEDIAN9_NETWORK = (
    (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8), (0, 3),
    (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7), (4, 2), (6, 4), (4, 2),
)


def median3x3(images: torch.Tensor) -> torch.Tensor:
    """Exact 3x3 median of (..., H, W) images with edge replication.

    The reference's 19-comparator median-of-9 network in minimum/maximum
    operations, no sort: an isolated extreme pixel (salt and pepper, a
    dead pixel) can never be the median of its neighbourhood, while edges
    and corners pass unblurred.
    """
    h, w = images.shape[-2:]
    p = torch.cat([images[..., :1, :], images, images[..., -1:, :]], -2)
    p = torch.cat([p[..., :, :1], p, p[..., :, -1:]], -1)
    n = [p[..., dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)]
    for a, b in _MEDIAN9_NETWORK:
        n[a], n[b] = torch.minimum(n[a], n[b]), torch.maximum(n[a], n[b])
    return n[4]


def downsample2(images: torch.Tensor, blur: bool = True) -> torch.Tensor:
    """Halve (..., H, W) images: 2x2 mean after an optional Gaussian."""
    if blur:
        images = gaussian_blur(images, sigma=1.0, radius=2)
    h2, w2 = images.shape[-2] // 2, images.shape[-1] // 2
    x = images[..., : h2 * 2, : w2 * 2]
    x = x.reshape(*x.shape[:-2], h2, 2, w2, 2)
    return x.mean(dim=(-3, -1))


def upsample2(images: torch.Tensor) -> torch.Tensor:
    """(C, S, h, w) -> (C, S, 2h, 2w) bilinear upsample with half-pixel
    centres: the reference's ``jax.image.resize(method="linear")`` at a
    scale of two, the inverse of the host's 2x2 mean
    (``downsample2_host``) up to the finest octave."""
    h, w = images.shape[-2:]
    return F.interpolate(images, size=(2 * h, 2 * w), mode="bilinear", align_corners=False)


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


def remap_bilinear(images: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    """Sample (..., H, W) images at fractional (Ho, Wo) coordinates.

    ``cv2.remap(INTER_LINEAR, BORDER_CONSTANT)`` semantics, as the
    reference computes them: floor, clip of x0, x0+1, y0, y0+1 into the
    image, ``top = v00*(1-fx) + v01*fx`` (``bot`` likewise), then
    ``top*(1-fy) + bot*fy``; the whole sample is 0 where the coordinate
    lies outside [0, W-1] x [0, H-1]. (``F.grid_sample`` blends border
    samples with its zero padding and orders the arithmetic differently.)
    """
    h, w = images.shape[-2:]
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    x0i = x0.long()
    y0i = y0.long()
    valid = (map_x >= 0) & (map_x <= w - 1) & (map_y >= 0) & (map_y <= h - 1)
    x0c = torch.clamp(x0i, 0, w - 1)
    x1c = torch.clamp(x0i + 1, 0, w - 1)
    y0c = torch.clamp(y0i, 0, h - 1)
    y1c = torch.clamp(y0i + 1, 0, h - 1)

    flat = images.reshape(*images.shape[:-2], h * w)

    def take(yy, xx):
        return flat[..., (yy * w + xx).reshape(-1)].reshape(*images.shape[:-2], *map_x.shape)

    top = take(y0c, x0c) * (1.0 - fx) + take(y0c, x1c) * fx
    bot = take(y1c, x0c) * (1.0 - fx) + take(y1c, x1c) * fx
    out = top * (1.0 - fy) + bot * fy
    return torch.where(valid, out, 0.0)


def resize_bilinear(images: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of (..., H, W) images (align_corners=False, clamped
    to the edge), as the reference builds it: a remap at pixel centres."""
    h, w = images.shape[-2:]
    dev = images.device
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * (h / out_h) - 0.5
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * (w / out_w) - 0.5
    map_y, map_x = torch.meshgrid(ys, xs, indexing="ij")
    map_y = torch.clamp(map_y, 0.0, h - 1.0)
    map_x = torch.clamp(map_x, 0.0, w - 1.0)
    return remap_bilinear(images, map_x, map_y)
