"""Patch gather: the CUDA kernel ``csrc/patches.cu`` and its plain version.

Replaces ``thor_slam_tpu/ops/patches_pallas.py::_gather_kernel``. KLT pulls
its (2*(radius+search+1)+1)-pixel windows through it every tick, and BRIEF
its 37-pixel patches on keyframes.

Dispatch is by the tensor's device: a CPU tensor gets the plain PyTorch
gather (:func:`thor_slam_tpu_torch.ops.image.extract_patches_flat`); any
other tensor gets the kernel or an exception, never the plain version.
"""

from __future__ import annotations

import torch

from thor_slam_tpu_torch.ops import image
from thor_slam_tpu_torch.utils import cuda_lib

#: Kernel launches and plain-version calls since the last :func:`reset_counts`.
counts = {"kernel": 0, "plain": 0}


def reset_counts() -> None:
    counts["kernel"] = 0
    counts["plain"] = 0


def extract_patches_flat_plain(
    images: torch.Tensor, cam: torch.Tensor, centers: torch.Tensor, size: int
) -> torch.Tensor:
    """The plain PyTorch gather the kernel is held against."""
    counts["plain"] += 1
    return image.extract_patches_flat(images, cam, centers, size)


def extract_patches_flat_cuda(
    images: torch.Tensor, cam: torch.Tensor, centers: torch.Tensor, size: int
) -> torch.Tensor:
    """Launch ``thor_patches_gather`` on the current stream."""
    lib = cuda_lib.load()
    c, h, w = images.shape
    m = cam.shape[0]
    if not images.is_cuda:
        raise ValueError(f"patch gather kernel needs CUDA tensors, got {images.device}")
    if images.dtype != torch.float32 or cam.dtype != torch.int32 or centers.dtype != torch.int32:
        raise ValueError(
            f"patch gather takes float32 images and int32 cam/centers, got "
            f"{images.dtype}, {cam.dtype}, {centers.dtype}"
        )
    if centers.shape != (m, 2) or cam.device != images.device or centers.device != images.device:
        raise ValueError(f"cam {tuple(cam.shape)} / centers {tuple(centers.shape)} mismatch")
    if size % 2 != 1 or size > min(h, w):
        raise ValueError(f"patch size {size} must be odd and fit a {h}x{w} image")
    if not (images.is_contiguous() and cam.is_contiguous() and centers.is_contiguous()):
        raise ValueError("patch gather needs contiguous inputs")
    out = torch.empty((m, size, size), dtype=torch.float32, device=images.device)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    status = lib.thor_patches_gather(
        images.data_ptr(), cam.data_ptr(), centers.data_ptr(), out.data_ptr(),
        c, h, w, m, size, stream,
    )
    cuda_lib.check(status, "thor_patches_gather")
    counts["kernel"] += 1
    return out


def extract_patches_flat(
    images: torch.Tensor, cam: torch.Tensor, centers: torch.Tensor, size: int
) -> torch.Tensor:
    """(M, S, S) patches from (C, H, W) images at per-patch cameras.

    Args:
        images: (C, H, W) float32 stack.
        cam: (M,) int32 camera index per patch.
        centers: (M, 2) int32 (x, y) centres, clipped so patches lie inside.
        size: Odd patch side S.
    """
    if images.device.type == "cpu":
        return extract_patches_flat_plain(images, cam, centers, size)
    return extract_patches_flat_cuda(images, cam, centers, size)


def extract_patches_batched(images: torch.Tensor, centers: torch.Tensor, size: int = 37) -> torch.Tensor:
    """(C, H, W) images + (C, N, 2) int32 centres -> (C, N, S, S) patches."""
    c, n = centers.shape[:2]
    cam = torch.arange(c, dtype=torch.int32, device=images.device).repeat_interleave(n)
    flat = extract_patches_flat(images, cam, centers.reshape(c * n, 2).contiguous(), size)
    return flat.reshape(c, n, size, size)
