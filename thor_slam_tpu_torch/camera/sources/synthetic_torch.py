"""The synthetic world's renderer in PyTorch, for frames made on the device.

Counterpart of :meth:`SyntheticWorld.render` and :func:`procedural_texture`
of :mod:`thor_slam_tpu_torch.camera.sources.synthetic` called with
``xp=jax.numpy`` in the JAX package (its ``utils/flagship.render_sequence``
role): the same ray cast into the textured box room and the same hash
texture, in float32 on any torch device, for a batch of poses at once.

Where it departs from the array-module code, and why:

* the lattice hash's uint32 arithmetic runs in int64, masked to 32 bits
  after every multiply and xor (CUDA has no uint32 multiply in PyTorch);
  every shifted value is non-negative, and the float32 conversion of the
  masked value rounds as a uint32's does;
* the 3-wide products (``points @ rot.T``, ``dirs_cam @ r_wc.T``) are three
  explicit multiply-adds, so that no TF32 setting touches them.

The numpy path computes in float64 where its inputs are float64 (NumPy 2
promotion), this one in float32: a point within a rounding of a texture
cell's face can land in the neighbouring cell, so a small share of pixels
differ by a whole texture value (``tests/test_torch_measure.py`` bounds it).
"""

from __future__ import annotations

import numpy as np
import torch

from thor_slam_tpu_torch.camera.sources.synthetic import _OCTAVE_ROTATIONS, SyntheticWorld
from thor_slam_tpu_torch.camera.types import Intrinsics

_MASK = 0xFFFFFFFF
_OCTAVES = ((2.03, 0.4), (5.19, 0.3), (12.67, 0.2), (30.71, 0.1))  # (cells per metre, weight)


def hash01(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor, seed: int) -> torch.Tensor:
    """The integer lattice hash of ``synthetic._hash01`` -> [0, 1) float32.

    ``ix``, ``iy``, ``iz``: integer tensors (their 32-bit two's complement
    is the uint32 the reference hashes).
    """
    ix, iy, iz = (a.to(torch.int64) & _MASK for a in (ix, iy, iz))
    h = ((ix * 73856093) & _MASK) ^ ((iy * 19349663) & _MASK) ^ ((iz * 83492791) & _MASK) ^ (seed * 2654435761 & _MASK)
    h = h ^ (h >> 13)
    h = (h * 0x5BD1E995) & _MASK
    h = h ^ (h >> 15)
    return h.to(torch.float32) * (1.0 / 4294967296.0)


def procedural_texture(points: torch.Tensor, seed: int = 7) -> torch.Tensor:
    """The multi-octave blocky texture in [0, 1] at (..., 3) world points."""
    x, y, z = points.unbind(-1)
    out = None
    for k, (scale, w) in enumerate(_OCTAVES):
        rot = _OCTAVE_ROTATIONS[k].tolist()
        cells = [torch.floor((x * r[0] + y * r[1] + z * r[2]) * scale).to(torch.int32) for r in rot]
        v = hash01(*cells, seed + k) * w
        out = v if out is None else out + v
    return out


def render(
    world: SyntheticWorld, intrinsics: Intrinsics, world_t_cams, device: str | torch.device
) -> torch.Tensor:
    """Grayscale images of ``world`` from B camera poses, on ``device``.

    Args:
        world: The textured box room.
        intrinsics: Pinhole intrinsics (distortion ignored, as the reference).
        world_t_cams: (B, 4, 4) camera-to-world transforms (RDF).
        device: Where the images are made.

    Returns:
        (B, H, W) float32 images in [0, 1].
    """
    poses = torch.from_numpy(np.asarray(world_t_cams, np.float32)).to(device)
    k = intrinsics.matrix
    fx, fy, cx, cy = (float(k[i, j]) for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
    u = torch.arange(intrinsics.width, dtype=torch.float32, device=device) + 0.5
    v = torch.arange(intrinsics.height, dtype=torch.float32, device=device) + 0.5
    uu, vv = torch.meshgrid(u, v, indexing="xy")  # (H, W)
    dx, dy = (uu - cx) / fx, (vv - cy) / fy  # the third component is 1

    r = poses[:, :3, :3, None, None]  # (B, 3, 3, 1, 1)
    origin = poses[:, :3, 3, None, None]  # (B, 3, 1, 1)
    dirs_w = dx * r[:, :, 0] + dy * r[:, :, 1] + r[:, :, 2]  # (B, 3, H, W)

    he = torch.tensor(world.half_extents, dtype=torch.float32, device=device)[None, :, None, None]
    eps = 1e-6
    small = torch.abs(dirs_w) < eps
    d_safe = torch.where(small, eps, dirs_w)
    t_exit = (torch.sign(d_safe) * he - origin) / d_safe
    t_exit = torch.where(small, 1e9, t_exit)
    t_hit = torch.amin(t_exit, dim=1)  # (B, H, W)

    hit = origin + dirs_w * t_hit[:, None]  # (B, 3, H, W)
    img = procedural_texture(hit.movedim(1, -1), seed=world.seed)
    depth = t_hit * torch.sqrt(dx * dx + dy * dy + 1.0)
    shade = 1.0 / (1.0 + 0.02 * depth)
    return torch.clamp(img * (0.55 + 0.45 * shade) + 0.15, 0.0, 1.0)
