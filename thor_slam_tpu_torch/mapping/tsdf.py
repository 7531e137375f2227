"""Projective TSDF integration on a dense voxel grid.

Port of :mod:`thor_slam_tpu.mapping.tsdf`: the role nvblox's
``ProjectiveTsdfIntegrator`` plays in the reference deployment, with its
parameters as the :class:`GridSpec` defaults (voxel 0.05 m, truncation 4
voxels, max integration distance 10 m).

One dense grid on one device. The update is voxel-parallel: every voxel
centre projects into the depth image, rounds to a pixel and reads its
depth (and colour) with one gather; no scatter. The voxel coordinates are
broadcast 1-D ``arange``s, shapes (nx, 1, 1), (1, ny, 1), (1, 1, nz), so no
iota grid is materialised. Moving the map is a roll of the grid contents
(:func:`make_recenter`); the world origin is a (3,) tensor on the device.

Host cost per integrated frame: no synchronising runtime call. The pose
and the intrinsics enter the pass as Python floats (kernel arguments), not
as tensors copied from the host, and the grid's tensors are written in
place when ``donate=True`` (the counterpart of the reference's buffer
donation).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from thor_slam_tpu_torch.utils.platform import select_device


@dataclass(frozen=True)
class GridSpec:
    """Static geometry + integration policy of a TSDF grid.

    Attributes:
        dims: Voxel counts ``(nx, ny, nz)``; ``nz`` is the innermost axis.
        voxel_size_m: Edge length of one voxel.
        truncation_vox: Truncation band in voxels (metric band =
            ``truncation_vox * voxel_size_m``).
        max_integration_distance_m: Depth samples beyond this are ignored.
        min_integration_distance_m: Depth samples closer than this are
            treated as invalid (matches the RGB-D product's hole value 0).
        max_weight: Per-voxel observation weight cap.
        integrate_color: Whether grids carry a color channel.
    """

    dims: tuple[int, int, int] = (256, 256, 128)
    voxel_size_m: float = 0.05
    truncation_vox: float = 4.0
    max_integration_distance_m: float = 10.0
    min_integration_distance_m: float = 0.1
    max_weight: float = 100.0
    integrate_color: bool = True

    @property
    def truncation_m(self) -> float:
        return self.truncation_vox * self.voxel_size_m

    @property
    def extent_m(self) -> tuple[float, float, float]:
        return (
            self.dims[0] * self.voxel_size_m,
            self.dims[1] * self.voxel_size_m,
            self.dims[2] * self.voxel_size_m,
        )


class TsdfGrid(NamedTuple):
    """TSDF state, all tensors on one device.

    Attributes:
        tsdf: (nx, ny, nz) f32 truncated signed distance, METERS, clamped
            to +-truncation; unobserved voxels hold +truncation.
        weight: (nx, ny, nz) f32 accumulated observation weight (0 =
            never observed).
        color: (nx, ny, nz, 3) f32 running-mean RGB in [0, 255], or a
            (0,) placeholder when the spec disables color.
        origin: (3,) f32 world position of the (0, 0, 0) voxel CORNER.
    """

    tsdf: torch.Tensor
    weight: torch.Tensor
    color: torch.Tensor
    origin: torch.Tensor


def _origin_tensor(values, device: torch.device, out: torch.Tensor | None = None) -> torch.Tensor:
    """A (3,) f32 origin on ``device`` holding the f32 ``values`` bit for bit,
    written by three fills (scalar kernel arguments) instead of a copy from
    pageable host memory, which would synchronise the host."""
    out = torch.empty(3, dtype=torch.float32, device=device) if out is None else out
    for i, v in enumerate(np.asarray(values, np.float32).tolist()):
        out[i].fill_(v)
    return out


def make_grid(
    spec: GridSpec,
    origin_m: np.ndarray | tuple = (0.0, 0.0, 0.0),
    device: str | torch.device | None = None,
) -> TsdfGrid:
    """Allocate an empty grid with its corner at ``origin_m`` (world).

    ``device=None`` is the current CUDA device (and raises without one).
    """
    dev = select_device(device)
    nx, ny, nz = spec.dims
    color = (
        torch.zeros((nx, ny, nz, 3), dtype=torch.float32, device=dev)
        if spec.integrate_color
        else torch.zeros((0,), dtype=torch.float32, device=dev)
    )
    return TsdfGrid(
        tsdf=torch.full((nx, ny, nz), spec.truncation_m, dtype=torch.float32, device=dev),
        weight=torch.zeros((nx, ny, nz), dtype=torch.float32, device=dev),
        color=color,
        origin=_origin_tensor(origin_m, dev),
    )


def centered_origin(spec: GridSpec, center_m: np.ndarray) -> np.ndarray:
    """World origin that centers the grid on ``center_m``, voxel-snapped."""
    half = 0.5 * np.asarray(spec.extent_m)
    raw = np.asarray(center_m, np.float64) - half
    return (np.round(raw / spec.voxel_size_m) * spec.voxel_size_m).astype(np.float32)


def _voxel_centers_cam(spec: GridSpec, origin: torch.Tensor, cam_t_world: list[list[float]]):
    """Camera-frame coordinates of every voxel center, as three (nx, ny, nz)
    tensors built from broadcast 1-D aranges, in the reference's order of
    operations (it decides which pixel a voxel rounds to)."""
    nx, ny, nz = spec.dims
    vs = spec.voxel_size_m
    dev = origin.device
    ix = torch.arange(nx, dtype=torch.float32, device=dev).view(nx, 1, 1)
    iy = torch.arange(ny, dtype=torch.float32, device=dev).view(1, ny, 1)
    iz = torch.arange(nz, dtype=torch.float32, device=dev).view(1, 1, nz)
    px = origin[0] + (ix + 0.5) * vs
    py = origin[1] + (iy + 0.5) * vs
    pz = origin[2] + (iz + 0.5) * vs
    (r00, r01, r02, t0), (r10, r11, r12, t1), (r20, r21, r22, t2) = cam_t_world[:3]
    xc = r00 * px + r01 * py + r02 * pz + t0
    yc = r10 * px + r11 * py + r12 * pz + t1
    zc = r20 * px + r21 * py + r22 * pz + t2
    return xc, yc, zc


def _on(x, device: torch.device) -> torch.Tensor:
    """A tensor argument as is (moved to ``device`` if elsewhere), or a host
    array uploaded."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _host_floats(a, shape) -> list:
    """An array-like of f32 values as nested Python floats (kernel scalars)."""
    return np.asarray(a, np.float32).reshape(shape).tolist()


def _integrate_one(spec: GridSpec, grid: TsdfGrid, depth_mm_u16, color_u8, cam_t_world, intr4) -> None:
    """One frame's voxel-parallel TSDF update, written into ``grid`` in place."""
    trunc = spec.truncation_m  # sdf stored metric, like nvblox
    dev = grid.tsdf.device
    depth = _on(depth_mm_u16, dev)
    h, w = depth.shape
    depth_flat = depth.reshape(-1).to(torch.float32) * 1e-3
    xc, yc, zc = _voxel_centers_cam(spec, grid.origin, _host_floats(cam_t_world, (4, 4)))
    fx, fy, cx, cy = _host_floats(intr4, (4,))
    zs = torch.clamp(zc, min=1e-6)
    u = fx * xc / zs + cx
    v = fy * yc / zs + cy
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    in_view = (
        (zc > spec.min_integration_distance_m)
        & (zc < spec.max_integration_distance_m)
        & (ui >= 0)
        & (ui < w)
        & (vi >= 0)
        & (vi < h)
    )
    flat = torch.clamp(vi * w + ui, 0, h * w - 1)
    d = torch.take(depth_flat, flat)  # the one gather
    valid = in_view & (d > spec.min_integration_distance_m)
    sdf = d - zc  # projective distance along the optical axis
    update = valid & (sdf > -trunc)
    w_obs = update.to(torch.float32)
    new_w = torch.clamp(grid.weight + w_obs, max=spec.max_weight)
    sdf_c = torch.clamp(sdf, -trunc, trunc)
    num = grid.weight * grid.tsdf + w_obs * sdf_c
    tsdf = torch.where(new_w > 0.0, num / torch.clamp(new_w, min=1e-9), grid.tsdf)

    if spec.integrate_color:
        color_flat = _on(color_u8, dev).reshape(h * w, 3).to(torch.float32)
        c = color_flat[flat]  # (nx, ny, nz, 3)
        # Color only carries meaning in the surface band.
        w_c = (update & (torch.abs(sdf) < trunc)).to(torch.float32)[..., None]
        cw_old = torch.clamp(grid.weight, max=spec.max_weight)[..., None]
        cw_new = cw_old + w_c
        torch.where(
            cw_new > 0.0,
            (cw_old * grid.color + w_c * c) / torch.clamp(cw_new, min=1e-9),
            grid.color,
            out=grid.color,
        )
    grid.tsdf.copy_(tsdf)
    grid.weight.copy_(new_w)


def _clone(grid: TsdfGrid) -> TsdfGrid:
    return TsdfGrid(*(t.clone() for t in grid))


def make_integrator(spec: GridSpec, donate: bool = False):
    """Build the per-frame integrator for one depth-image shape.

    Returns:
        ``integrate(grid, depth_mm_u16, color_u8, cam_t_world, intr4)``
        -> the updated :class:`TsdfGrid`, where

        * ``depth_mm_u16``: (H, W) uint16 depth in millimeters, 0 =
          invalid (the RGB-D product's encoding), a tensor on the grid's
          device or a host array (uploaded);
        * ``color_u8``: (H, W, 3) uint8 aligned color (an empty (0,)
          array when the spec disables color);
        * ``cam_t_world``: (4, 4) world->camera transform (RDF camera, +z
          forward), a HOST array: its f32 entries enter the pass as
          scalars;
        * ``intr4``: ``[fx, fy, cx, cy]`` at the depth resolution, a host
          array as well.

    Args:
        spec: Static grid geometry/policy.
        donate: Write the input grid's tensors in place and return it (the
            streaming mapper does); otherwise the input is left as it was
            and a new grid is returned.
    """

    def integrate(grid: TsdfGrid, depth_mm_u16, color_u8, cam_t_world, intr4) -> TsdfGrid:
        out = grid if donate else _clone(grid)
        _integrate_one(spec, out, depth_mm_u16, color_u8, cam_t_world, intr4)
        return out

    return integrate


def make_scan_integrator(spec: GridSpec, donate: bool = False):
    """Build the BULK integrator: N frames in one call.

    ``integrate_scan(grid, depths, colors, poses, intr4) -> TsdfGrid``
    where ``depths`` is (N, H, W) uint16 mm, ``colors`` (N, H, W, 3) uint8
    (or (N, 0) when color is disabled), ``poses`` (N, 4, 4) world->camera
    (host array). Identical to N sequential :func:`make_integrator` calls:
    the offline form (dataset replay, map rebuilds). ``donate`` as there.
    """

    def integrate_scan(grid: TsdfGrid, depths, colors, poses, intr4) -> TsdfGrid:
        out = grid if donate else _clone(grid)
        depths = _on(depths, out.tsdf.device)
        colors = _on(colors, out.tsdf.device) if spec.integrate_color else colors
        for n in range(depths.shape[0]):
            _integrate_one(spec, out, depths[n], colors[n], poses[n], intr4)
        return out

    return integrate_scan


def make_decay(spec: GridSpec, min_weight: float = 1e-2, donate: bool = False):
    """Build the weight-decay pass (dynamic-scene maintenance).

    The nvblox ``TsdfDecayIntegrator`` role: observation weights shrink by
    a factor so stale geometry fades; voxels decayed below ``min_weight``
    revert to unobserved. ``decay(grid, factor)``, ``factor`` a host float;
    ``donate`` as in :func:`make_integrator`.
    """

    def decay(grid: TsdfGrid, factor) -> TsdfGrid:
        out = grid if donate else _clone(grid)
        out.weight.mul_(float(np.float32(factor)))
        dead = out.weight < min_weight
        out.tsdf.masked_fill_(dead, spec.truncation_m)
        out.weight.masked_fill_(dead, 0.0)
        if spec.integrate_color:
            out.color.masked_fill_(dead[..., None], 0.0)
        return out

    return decay


def save_grid(path, grid: TsdfGrid, spec: GridSpec) -> None:
    """Serialize a grid + its spec to ``.npz``, in the reference's keys and
    dtypes (a file loads in either package)."""
    np.savez_compressed(
        path,
        **{name: t.detach().cpu().numpy() for name, t in grid._asdict().items()},
        dims=np.asarray(spec.dims, np.int64),
        voxel_size_m=spec.voxel_size_m,
        truncation_vox=spec.truncation_vox,
        max_integration_distance_m=spec.max_integration_distance_m,
        min_integration_distance_m=spec.min_integration_distance_m,
        max_weight=spec.max_weight,
        integrate_color=spec.integrate_color,
    )


def load_grid(path, device: str | torch.device | None = None) -> tuple[TsdfGrid, GridSpec]:
    """Load a grid saved by :func:`save_grid` (of either package) onto
    ``device`` (``None``: the current CUDA device); the spec rides the file."""
    d = np.load(path)
    spec = GridSpec(
        dims=tuple(int(x) for x in d["dims"]),
        voxel_size_m=float(d["voxel_size_m"]),
        truncation_vox=float(d["truncation_vox"]),
        max_integration_distance_m=float(d["max_integration_distance_m"]),
        min_integration_distance_m=float(d["min_integration_distance_m"]),
        max_weight=float(d["max_weight"]),
        integrate_color=bool(d["integrate_color"]),
    )
    dev = select_device(device)
    grid = TsdfGrid(*(torch.from_numpy(np.asarray(d[f], np.float32)).to(dev) for f in TsdfGrid._fields))
    return grid, spec


def _wrapped_slice(s: int, n: int) -> slice | None:
    """Local indices along one axis whose content wrapped around in a roll
    by ``-s`` (they hold nothing of the world's voxels there)."""
    if s > 0:
        return slice(max(n - s, 0), n)
    if s < 0:
        return slice(0, min(-s, n))
    return None


def make_recenter(spec: GridSpec, donate: bool = False):
    """Build the rolling-grid shift (the map follows the robot).

    Content keeps its world position; voxels that wrap around are reset to
    unobserved. ``donate`` as in :func:`make_integrator`.

    Returns:
        ``recenter(grid, shift_vox, new_origin=None)`` -> grid, where
        ``shift_vox`` is three host ints, the voxels to ADD to the origin.
        ``new_origin`` optionally supplies the post-shift origin (3,) f32
        (host array) directly, taken bit for bit: callers keeping a HOST
        shadow of the origin (the DenseMapper) pass their own value so host
        and device stay identical.
    """
    vs = spec.voxel_size_m

    def recenter(grid: TsdfGrid, shift_vox, new_origin=None) -> TsdfGrid:
        s = [int(x) for x in np.asarray(shift_vox).astype(np.int32)]
        shifts, dims = (-s[0], -s[1], -s[2]), (0, 1, 2)
        tsdf = torch.roll(grid.tsdf, shifts, dims)
        weight = torch.roll(grid.weight, shifts, dims)
        color = torch.roll(grid.color, shifts, dims) if spec.integrate_color else grid.color
        # Content at world voxel j lands at local index j - shift.
        for axis, n in enumerate(spec.dims):
            sl = _wrapped_slice(s[axis], n)
            if sl is None:
                continue
            idx = (slice(None),) * axis + (sl,)
            tsdf[idx] = spec.truncation_m
            weight[idx] = 0.0
            if spec.integrate_color:
                color[idx] = 0.0
        if new_origin is None:
            # origin + f32(s) * f32(vs) rounded once, as the reference's
            # compiled code computes it (one fused multiply-add): the exact
            # product and sum in f64 on the device, then one rounding to f32.
            step = (np.asarray(s, np.float64) * np.float64(np.float32(vs))).tolist()
            origin = torch.stack([o.double() + d for o, d in zip(grid.origin.unbind(), step)]).float()
        else:
            origin = _origin_tensor(new_origin, grid.origin.device)
        if not donate:
            return TsdfGrid(tsdf=tsdf, weight=weight, color=color, origin=origin)
        for dst, src in zip(grid, (tsdf, weight, color, origin)):
            if dst is not src:
                dst.copy_(src)
        return grid

    return recenter
