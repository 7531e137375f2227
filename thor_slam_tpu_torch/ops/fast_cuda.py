"""FAST-9 score + 3x3 NMS: the CUDA kernel ``csrc/fast.cu`` and its plain version.

Replaces ``thor_slam_tpu/ops/fast_pallas.py::_fast_kernel``; runs on
keyframe ticks, once for both eyes of every camera (the (C, 2, H, W) frame
tensor viewed as 2C images). Both
versions implement the XLA reference (``fast.fast_score_map`` +
``fast.nms3x3``) on the whole image, with the excess sums accumulated in
``CIRCLE_OFFSETS`` order, so kernel and plain version agree bit for bit.

Dispatch is by the tensor's device: a CPU tensor gets the plain version;
any other tensor gets the kernel or an exception.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from thor_slam_tpu_torch.utils import cuda_lib

# FAST-16 Bresenham circle, radius 3, clockwise from 12 o'clock: (dy, dx).
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LENGTH = 9  # FAST-9: contiguous arc of 9 of 16

#: Kernel launches and plain-version calls since the last :func:`reset_counts`.
counts = {"kernel": 0, "plain": 0}


def reset_counts() -> None:
    counts["kernel"] = 0
    counts["plain"] = 0


def _has_arc(mask: torch.Tensor) -> torch.Tensor:
    """(16, ...) bool circle masks -> (...) contiguous (wrapping) run >= 9."""
    ext = torch.cat([mask, mask[: ARC_LENGTH - 1]], 0)
    hit = torch.zeros_like(mask[0])
    for start in range(16):
        run = ext[start]
        for j in range(1, ARC_LENGTH):
            run = run & ext[start + j]
        hit = hit | run
    return hit


def fast_scores_plain(images: torch.Tensor, threshold: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch FAST-9 + NMS the kernel is held against."""
    counts["plain"] += 1
    c, h, w = images.shape
    padded = F.pad(images[:, None], (3, 3, 3, 3), mode="replicate")[:, 0]
    diffs = torch.stack(
        [padded[:, 3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] - images for dy, dx in CIRCLE_OFFSETS]
    )  # (16, C, H, W)
    excess_b = torch.zeros_like(images)
    excess_d = torch.zeros_like(images)
    for d in diffs:  # CIRCLE_OFFSETS order, as the kernel accumulates
        excess_b = excess_b + torch.clamp(d - threshold, min=0.0)
        excess_d = excess_d + torch.clamp(-d - threshold, min=0.0)
    corner = _has_arc(diffs > threshold) | _has_arc(diffs < -threshold)
    raw = torch.where(corner, torch.maximum(excess_b, excess_d), 0.0)
    ninf = F.pad(raw[:, None], (1, 1, 1, 1), value=float("-inf"))
    local_max = F.max_pool2d(ninf, 3, stride=1)[:, 0]
    nms = torch.where(raw >= local_max, raw, 0.0)
    return raw, nms


def fast_scores_cuda(images: torch.Tensor, threshold: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``thor_fast_nms`` on the current stream."""
    lib = cuda_lib.load()
    if not images.is_cuda:
        raise ValueError(f"FAST kernel needs a CUDA tensor, got {images.device}")
    if images.dtype != torch.float32 or images.dim() != 3 or not images.is_contiguous():
        raise ValueError(
            f"FAST kernel takes contiguous (C, H, W) float32, got {images.dtype} "
            f"{tuple(images.shape)}"
        )
    c, h, w = images.shape
    raw = torch.empty_like(images)
    nms = torch.empty_like(images)
    # The library launches on the host thread's current device: make it the
    # tensors' one, whose stream the launch takes.
    with torch.cuda.device(images.device):
        status = lib.thor_fast_nms(
            images.data_ptr(), raw.data_ptr(), nms.data_ptr(), c, h, w, float(threshold),
            torch.cuda.current_stream(images.device).cuda_stream,
        )
    cuda_lib.check(status, "thor_fast_nms")
    counts["kernel"] += 1
    return raw, nms


def fast_scores_batched(images: torch.Tensor, threshold: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, H, W) float32 images in [0, 1] -> (raw, nms) FAST-9 response maps."""
    if images.device.type == "cpu":
        return fast_scores_plain(images, threshold)
    return fast_scores_cuda(images, threshold)
