"""Euclidean signed-distance fields from the TSDF grid.

Port of :mod:`thor_slam_tpu.mapping.esdf`: the planning product the
reference gets from nvblox's ESDF integrator (3D), plus the 2D costmap
slice its nav stack consumes.

The transform is EXACT and separable: the squared Euclidean distance
transform factorizes per axis as a min-plus transform

    d2'[.., k] = min_j ( d2[.., j] + ((k - j) * h)^2 )

Three axis passes give the exact 3D EDT. Each pass is evaluated in output
chunks (a Python loop, as the reference's ``lax.scan``), so the broadcast
term never materializes the full (.., L, L) tensor; ``chunk`` changes the
transient memory only, never the result.
"""

from __future__ import annotations

import numpy as np
import torch


def _dt_axis(d2: torch.Tensor, axis: int, h: float, chunk: int) -> torch.Tensor:
    """One exact min-plus squared-distance pass along ``axis``."""
    d2m = torch.movedim(d2, axis, -1)
    length = d2m.shape[-1]
    j = torch.arange(length, dtype=torch.float32, device=d2.device)
    rows = d2m[..., None, :]
    outs = []
    for start in range(0, length, chunk):
        k = torch.arange(start, start + chunk, dtype=torch.float32, device=d2.device)
        dist2 = ((k[:, None] - j[None, :]) * h) ** 2  # (chunk, L)
        outs.append(torch.amin(rows + dist2, dim=-1))  # (.., chunk)
    out = torch.cat(outs, dim=-1)[..., :length]
    return torch.movedim(out, -1, axis)


def _cap(max_distance_m: float) -> float:
    return float(np.float32(max_distance_m) ** 2)


def esdf_from_tsdf(
    tsdf: torch.Tensor,
    weight: torch.Tensor,
    voxel_size_m: float,
    max_distance_m: float = 2.0,
    occupied_threshold_m: float = 0.0,
    chunk: int = 8,
) -> torch.Tensor:
    """Exact 3D Euclidean distance (meters) to the nearest occupied voxel.

    A voxel is occupied when it has been observed (``weight > 0``) with
    ``tsdf <= occupied_threshold_m``. Distances are clamped to
    ``max_distance_m`` (and are 0 inside obstacles).

    Args:
        tsdf: (nx, ny, nz) f32 metric TSDF.
        weight: (nx, ny, nz) f32 observation weights.
        voxel_size_m: Grid voxel size.
        max_distance_m: Clamp radius.
        occupied_threshold_m: TSDF value at/below which a voxel is an
            obstacle (0 = the zero crossing itself).
        chunk: Output positions evaluated per step (transient memory only).
    """
    cap = _cap(max_distance_m)
    occupied = (weight > 0.0) & (tsdf <= occupied_threshold_m)
    d2 = torch.where(occupied, 0.0, cap).to(torch.float32)
    for axis in range(3):
        d2 = torch.clamp(_dt_axis(d2, axis, voxel_size_m, chunk), max=cap)
    return torch.sqrt(d2)


def esdf_slice_2d(
    tsdf: torch.Tensor,
    weight: torch.Tensor,
    voxel_size_m: float,
    z_lo_vox: int,
    z_hi_vox: int,
    max_distance_m: float = 2.0,
    occupied_threshold_m: float = 0.0,
    chunk: int = 16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """2D costmap slice: obstacles in the height band projected to the floor.

    Occupancy over voxel layers ``[z_lo_vox, z_hi_vox)`` is OR-projected,
    then the exact 2D EDT runs on the plane.

    Returns:
        ``(distance, occupied, observed)`` — (nx, ny) f32 meters,
        (nx, ny) bool obstacle mask, (nx, ny) bool "any observation in
        band" mask.
    """
    band_t = tsdf[:, :, z_lo_vox:z_hi_vox]
    band_w = weight[:, :, z_lo_vox:z_hi_vox]
    occ3 = (band_w > 0.0) & (band_t <= occupied_threshold_m)
    occupied = torch.any(occ3, dim=2)
    observed = torch.any(band_w > 0.0, dim=2)
    cap = _cap(max_distance_m)
    d2 = torch.where(occupied, 0.0, cap).to(torch.float32)
    for axis in range(2):
        d2 = torch.clamp(_dt_axis(d2, axis, voxel_size_m, chunk), max=cap)
    return torch.sqrt(d2), occupied, observed
