"""Upright BRIEF-256 descriptors, batched over cameras and keypoints.

Port of the upright path of :mod:`thor_slam_tpu.ops.brief` (the tracker's
default, ``oriented_descriptors=False``). The test pattern and the
bilinear sampling matrix are rebuilt here from the same numpy seed, so the
pattern is identical to the reference's.

Packing: the 256 comparison bits are summed into 8 words in int64 and
stored as int32 bit patterns (word value ``v`` in [0, 2^32) becomes
``v - 2^32`` when ``v >= 2^31``); PyTorch's uint32 supports too few
operations. :mod:`thor_slam_tpu_torch.engine.convert` maps them to and
from the reference's uint32 words bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from thor_slam_tpu_torch.ops import patches_cuda

PATCH_RADIUS = 18
PATCH_SIZE = 2 * PATCH_RADIUS + 1
PAIR_RADIUS = 13.0
NUM_BITS = 256
NUM_WORDS = NUM_BITS // 32


def _make_test_pairs(seed: int = 42) -> np.ndarray:
    """(256, 4) test pairs (x1, y1, x2, y2): Gaussian, clipped to the radius."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PAIR_RADIUS / 2.5, size=(NUM_BITS, 4))
    return np.clip(pts, -PAIR_RADIUS, PAIR_RADIUS)


TEST_PAIRS = _make_test_pairs()


def _upright_sampling_matrix() -> np.ndarray:
    """(P*P, 512) bilinear sampling matrix of the upright pattern."""
    s = np.zeros((PATCH_SIZE * PATCH_SIZE, 2 * NUM_BITS), dtype=np.float32)
    pts = np.concatenate([TEST_PAIRS[:, :2], TEST_PAIRS[:, 2:]], axis=0)
    for col, (px, py) in enumerate(pts):
        x = np.clip(px + PATCH_RADIUS, 0, PATCH_SIZE - 1.001)
        y = np.clip(py + PATCH_RADIUS, 0, PATCH_SIZE - 1.001)
        x0, y0 = int(np.floor(x)), int(np.floor(y))
        fx, fy = x - x0, y - y0
        s[y0 * PATCH_SIZE + x0, col] += (1 - fx) * (1 - fy)
        s[y0 * PATCH_SIZE + x0 + 1, col] += fx * (1 - fy)
        s[(y0 + 1) * PATCH_SIZE + x0, col] += (1 - fx) * fy
        s[(y0 + 1) * PATCH_SIZE + x0 + 1, col] += fx * fy
    return s


UPRIGHT_SAMPLING = _upright_sampling_matrix()
_BIT_WEIGHTS = (np.int64(1) << np.arange(32, dtype=np.int64)).tolist()


class Descriptors(NamedTuple):
    """Packed descriptors: ``bits`` (C, N, 8) int32 bit patterns, ``valid`` (C, N)."""

    bits: torch.Tensor
    valid: torch.Tensor


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool -> (..., 8) int32 bit patterns (bit i of word w = bit 32w+i)."""
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(*bits.shape[:-1], NUM_WORDS, 32).long() * weights).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).int()


def _describe(patches: torch.Tensor) -> torch.Tensor:
    """(..., P, P) smoothed patches -> (..., 8) packed upright BRIEF words."""
    sampling = torch.as_tensor(UPRIGHT_SAMPLING, device=patches.device)
    samples = patches.reshape(*patches.shape[:-2], -1) @ sampling  # (..., 512)
    return pack_bits(samples[..., :NUM_BITS] < samples[..., NUM_BITS:])


def compute_descriptors_batched(
    images: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor
) -> Descriptors:
    """Upright BRIEF-256 for (C, N, 2) keypoints on (C, H, W) smoothed images."""
    centers = torch.round(xy).int()
    patches = patches_cuda.extract_patches_batched(images, centers, size=PATCH_SIZE)
    return Descriptors(bits=_describe(patches), valid=valid)


def compute_descriptors_pair(
    images_a: torch.Tensor, images_b: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor
) -> Descriptors:
    """Upright BRIEF-256 on two smoothed (C, H, W) stacks (the left and the
    right eye) with one gather launch: ``xy`` is (2, C, N, 2), row 0 on
    ``images_a`` and row 1 on ``images_b``; bits come back (2, C, N, 8)."""
    _, c, n = xy.shape[:3]
    cam = torch.arange(c, dtype=torch.int32, device=xy.device).repeat_interleave(n)
    centers = torch.round(xy).int().reshape(2, c * n, 2)
    patches, _ = patches_cuda.extract_patches_pair(images_a, images_b, cam, centers, PATCH_SIZE)
    return Descriptors(bits=_describe(patches).reshape(2, c, n, NUM_WORDS), valid=valid)
