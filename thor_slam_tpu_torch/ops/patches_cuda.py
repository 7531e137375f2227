"""Patch gather: the CUDA kernel ``csrc/patches.cu`` and its plain version.

Replaces ``thor_slam_tpu/ops/patches_pallas.py::_gather_kernel``. KLT pulls
its (2*(radius+search+1)+1)-pixel windows through it every tick, and BRIEF
its 37-pixel patches on keyframes. Both gather from two stacks at a time
(the previous and the current frame of a pyramid level; the left and the
right smoothed images), so the pair entry :func:`extract_patches_pair`
serves both with one launch and also returns the clipped centres, which
KLT needs; :func:`extract_patches_flat` is the single-stack entry over the
same kernel.

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


def extract_patches_pair_plain(
    images_a: torch.Tensor, images_b: torch.Tensor, cam: torch.Tensor, centers: torch.Tensor, size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the pair entry: two gathers and the
    tensor clamps of the centres."""
    counts["plain"] += 1
    _, h, w = images_a.shape
    r = size // 2
    clipped = torch.stack(
        [torch.clamp(centers[..., 0], r, w - r - 1), torch.clamp(centers[..., 1], r, h - r - 1)], -1
    )
    patches = torch.stack(
        [
            image.extract_patches_flat(images_a, cam, clipped[0], size),
            image.extract_patches_flat(images_b, cam, clipped[1], size),
        ]
    )
    return patches, clipped


def _launch(
    stacks: tuple[torch.Tensor, ...], cam: torch.Tensor, centers: torch.Tensor, size: int, want_clipped: bool
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch ``thor_patches_gather`` on the current stream for one or two
    stacks; ``centers`` is (len(stacks) * M, 2)."""
    lib = cuda_lib.load()
    first = stacks[0]
    if not first.is_cuda or first.dim() != 3:
        raise ValueError(f"patch gather kernel needs (C, H, W) CUDA tensors, got {first.device} {tuple(first.shape)}")
    c, h, w = first.shape
    m = cam.shape[0]
    n = len(stacks)
    for s in stacks:
        if s.shape != first.shape or s.device != first.device:
            raise ValueError(f"patch gather needs stacks of one shape and device, got {[tuple(t.shape) for t in stacks]}")
        if s.dtype != torch.float32:
            raise ValueError(f"patch gather takes float32 images, got {s.dtype}")
        # Each image must be dense (rows W apart); cameras may lie at any
        # stride, so one eye of a (C, 2, H, W) tensor is taken as it lies.
        if s.stride(2) != 1 or s.stride(1) != w:
            raise ValueError(f"patch gather needs dense images, got strides {s.stride()}")
    if cam.dtype != torch.int32 or centers.dtype != torch.int32:
        raise ValueError(f"patch gather takes int32 cam/centers, got {cam.dtype}, {centers.dtype}")
    if cam.dim() != 1 or centers.shape != (n * m, 2) or cam.device != first.device or centers.device != first.device:
        raise ValueError(f"cam {tuple(cam.shape)} / centers {tuple(centers.shape)} mismatch for {n} stack(s)")
    if not (cam.is_contiguous() and centers.is_contiguous()):
        raise ValueError("patch gather needs contiguous cam/centers")
    if size % 2 != 1 or size > min(h, w):
        raise ValueError(f"patch size {size} must be odd and fit a {h}x{w} image")
    out = torch.empty((n * m, size, size), dtype=torch.float32, device=first.device)
    clipped = torch.empty((n * m, 2), dtype=torch.int32, device=first.device) if want_clipped else None
    last = stacks[-1]
    # The library launches on the host thread's current device: make it the
    # tensors' one, whose stream the launch takes.
    with torch.cuda.device(first.device):
        status = lib.thor_patches_gather(
            first.data_ptr(), last.data_ptr(), first.stride(0), last.stride(0), cam.data_ptr(), centers.data_ptr(),
            out.data_ptr(), clipped.data_ptr() if want_clipped else None, n, c, h, w, m, size,
            torch.cuda.current_stream(first.device).cuda_stream,
        )
    cuda_lib.check(status, "thor_patches_gather")
    counts["kernel"] += 1
    return out, clipped


def extract_patches_flat_cuda(
    images: torch.Tensor, cam: torch.Tensor, centers: torch.Tensor, size: int
) -> torch.Tensor:
    """One launch of the gather kernel on one stack."""
    return _launch((images,), cam, centers, size, want_clipped=False)[0]


def extract_patches_pair_cuda(
    images_a: torch.Tensor, images_b: torch.Tensor, cam: torch.Tensor, centers: torch.Tensor, size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the gather kernel on two stacks; it clips the centres."""
    if centers.dim() != 3 or centers.shape[0] != 2:
        raise ValueError(f"pair gather takes (2, M, 2) centres, got {tuple(centers.shape)}")
    m = centers.shape[1]
    out, clipped = _launch((images_a, images_b), cam, centers.reshape(2 * m, 2), size, want_clipped=True)
    return out.reshape(2, m, size, size), clipped.reshape(2, m, 2)


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


def extract_patches_pair(
    images_a: torch.Tensor, images_b: torch.Tensor, cam: torch.Tensor, centers: torch.Tensor, size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Patches from two (C, H, W) stacks of one shape, in one launch.

    Args:
        images_a: (C, H, W) float32 stack of ``centers[0]``.
        images_b: (C, H, W) float32 stack of ``centers[1]``.
        cam: (M,) int32 camera index per patch, shared by both stacks.
        centers: (2, M, 2) int32 (x, y) centres.
        size: Odd patch side S.

    Returns:
        ((2, M, S, S) patches, (2, M, 2) int32 centres clipped to
        [r, W-r-1] x [r, H-r-1], the positions the patches were read at).
    """
    if images_a.device.type == "cpu":
        return extract_patches_pair_plain(images_a, images_b, cam, centers, size)
    return extract_patches_pair_cuda(images_a, images_b, cam, centers, size)


def extract_patches_batched(images: torch.Tensor, centers: torch.Tensor, size: int = 37) -> torch.Tensor:
    """(C, H, W) images + (C, N, 2) int32 centres -> (C, N, S, S) patches."""
    c, n = centers.shape[:2]
    cam = torch.arange(c, dtype=torch.int32, device=images.device).repeat_interleave(n)
    flat = extract_patches_flat(images, cam, centers.reshape(c * n, 2).contiguous(), size)
    return flat.reshape(c, n, size, size)
