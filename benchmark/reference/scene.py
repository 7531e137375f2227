"""The synthetic rig's images: a textured box room, ray cast from any pose.

A frozen copy of the repository's synthetic scene (the ray cast and the
multi-octave hash texture of ``camera/sources/synthetic_torch.py``), so
that the frames both the program and the reference are fed are made here,
from the configuration's ``rig`` block, and not by the program. Plain
PyTorch in float32 on any device, a batch of poses at a time; the hash's
uint32 arithmetic runs in int64 masked to 32 bits, and the 3-wide products
are explicit multiply-adds (no TF32 setting touches them).

The room is axis-aligned with half sizes ``room_half_extents`` (the camera
inside); a ray's colour is the texture at the wall it hits, shaded by its
depth. The eyes of source i sit on a mount at yaw 2 pi i / N,
``mount_offset_m`` off the body's axis (:func:`benchmark.reference.orbit.
mount`), the right eye ``baseline_m`` along the left's optical +x, the
color imager at ``color_offset_m`` in the left's optical frame.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import orbit

_MASK = 0xFFFFFFFF
#: (cells per metre, weight) of the texture's four octaves.
_OCTAVES = ((2.03, 0.4), (5.19, 0.3), (12.67, 0.2), (30.71, 0.1))
#: Each octave's lattice is turned by Rz(a) Ry(b) (float32), which breaks
#: the walls' axis-aligned repetition.
_OCTAVE_ANGLES = ((0.0, 0.0), (0.61, 0.23), (1.13, 0.77), (0.37, 1.41))


def _octave_rotation(a: float, b: float) -> list:
    rot = np.array(
        [
            [np.cos(a) * np.cos(b), -np.sin(a), np.cos(a) * np.sin(b)],
            [np.sin(a) * np.cos(b), np.cos(a), np.sin(a) * np.sin(b)],
            [-np.sin(b), 0.0, np.cos(b)],
        ],
        dtype=np.float32,
    )
    return rot.tolist()


def _hash01(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor, seed: int) -> torch.Tensor:
    """An integer lattice hash -> [0, 1) float32."""
    ix, iy, iz = (a.to(torch.int64) & _MASK for a in (ix, iy, iz))
    h = ((ix * 73856093) & _MASK) ^ ((iy * 19349663) & _MASK) ^ ((iz * 83492791) & _MASK) ^ (seed * 2654435761 & _MASK)
    h = h ^ (h >> 13)
    h = (h * 0x5BD1E995) & _MASK
    h = h ^ (h >> 15)
    return h.to(torch.float32) * (1.0 / 4294967296.0)


def texture(points: torch.Tensor, seed: int) -> torch.Tensor:
    """The blocky texture in [0, 1] at (..., 3) float32 world points."""
    x, y, z = points.unbind(-1)
    out = None
    for k, ((scale, w), (a, b)) in enumerate(zip(_OCTAVES, _OCTAVE_ANGLES)):
        cells = [torch.floor((x * r[0] + y * r[1] + z * r[2]) * scale).to(torch.int32) for r in _octave_rotation(a, b)]
        v = _hash01(*cells, seed + k) * w
        out = v if out is None else out + v
    return out


def render(rig: dict, k: np.ndarray, width: int, height: int, world_t_cams, device) -> torch.Tensor:
    """(B, H, W) float32 images in [0, 1] of the room from B camera poses.

    ``k``: the 3x3 pinhole matrix; ``world_t_cams``: (B, 4, 4) RDF
    camera-to-world transforms (cast to float32).
    """
    poses = torch.as_tensor(np.asarray(world_t_cams, np.float32)).to(device)
    fx, fy, cx, cy = (float(k[i][j]) for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
    u = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    v = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    uu, vv = torch.meshgrid(u, v, indexing="xy")  # (H, W)
    dx, dy = (uu - cx) / fx, (vv - cy) / fy  # the third component is 1

    r = poses[:, :3, :3, None, None]
    origin = poses[:, :3, 3, None, None]
    dirs = dx * r[:, :, 0] + dy * r[:, :, 1] + r[:, :, 2]  # (B, 3, H, W)

    he = torch.tensor(rig["room_half_extents"], dtype=torch.float32, device=device)[None, :, None, None]
    eps = 1e-6
    small = torch.abs(dirs) < eps
    safe = torch.where(small, eps, dirs)
    t_exit = torch.where(small, 1e9, (torch.sign(safe) * he - origin) / safe)
    t_hit = torch.amin(t_exit, dim=1)  # (B, H, W)

    img = texture((origin + dirs * t_hit[:, None]).movedim(1, -1), rig["texture_seed"])
    depth = t_hit * torch.sqrt(dx * dx + dy * dy + 1.0)
    shade = 1.0 / (1.0 + 0.02 * depth)
    return torch.clamp(img * (0.55 + 0.45 * shade) + 0.15, 0.0, 1.0)


def _offset(v) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = v
    return m


def body_t_eyes(rig: dict) -> np.ndarray:
    """(N, 2, 4, 4) body_T_optical of each source's left and right eye."""
    n = rig["num_sources"]
    return np.stack([
        np.stack([orbit.mount(2.0 * math.pi * i / n, rig["mount_offset_m"]) @ orbit.BODY_T_OPTICAL
                  @ _offset([rig["baseline_m"] * e, 0.0, 0.0]) for e in range(2)])
        for i in range(n)
    ])


def body_t_color(rig: dict, source: int) -> np.ndarray:
    """body_T_optical of source ``source``'s color imager."""
    yaw = 2.0 * math.pi * source / rig["num_sources"]
    return orbit.mount(yaw, rig["mount_offset_m"]) @ orbit.BODY_T_OPTICAL @ _offset(rig["color_offset_m"])
