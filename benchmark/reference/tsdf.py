"""Plain reference of the dense map: projective TSDF fusion on a rolling grid.

The semantics of the program's ``pipeline/mapper.DenseMapper.integrate``
(over ``mapping/tsdf.py``), frozen here as plain PyTorch: the grid is
centred on the first frame's camera, voxel-snapped; it rolls horizontally
when the camera comes within ``recenter_margin_m`` of a face (wrapped
voxels reset to unobserved); each frame projects every voxel centre into
the depth image, rounds to a pixel and fuses the truncated projective
distance with weight 1 (capped at 100), and the colour as a running mean
inside the surface band.

It imports nothing of the program and computes in ``dtype`` where the
program computes in float32.
"""

from __future__ import annotations

import numpy as np
import torch


class TsdfReference:
    """The grid after fusing frames in order: ``integrate(depth_mm, color, world_t_cam, k)``."""

    def __init__(self, mapping: dict, device="cpu", dtype=torch.float32, max_weight=100.0, min_distance_m=0.1):
        self.dims = tuple(mapping["dims"])
        self.vs = float(mapping["voxel_size_m"])
        self.trunc = float(mapping["truncation_vox"]) * self.vs
        self.max_dist = float(mapping["max_integration_distance_m"])
        self.margin = float(mapping["recenter_margin_m"])
        self.color = bool(mapping["integrate_color"])
        self.min_dist, self.max_weight = min_distance_m, max_weight
        self.device, self.dtype = torch.device(device), dtype
        self.origin = None  # host float32 (3,)
        self.tsdf = self.weight = self.rgb = None

    def _centered(self, center: np.ndarray) -> np.ndarray:
        raw = np.asarray(center, np.float64) - 0.5 * np.asarray([n * self.vs for n in self.dims])
        return (np.round(raw / self.vs) * self.vs).astype(np.float32)

    def _roll(self, cam_pos: np.ndarray) -> None:
        origin = self.origin.astype(np.float64)
        lo = origin + self.margin
        hi = origin + np.asarray([n * self.vs for n in self.dims]) - self.margin
        if not ((cam_pos[:2] < lo[:2]) | (cam_pos[:2] > hi[:2])).any():
            return
        shift = np.zeros(3, np.int64)
        shift[:2] = np.round((self._centered(cam_pos)[:2] - origin[:2]) / self.vs).astype(np.int64)
        self.origin = self.origin.astype(np.float32) + shift.astype(np.float32) * np.float32(self.vs)
        s = [int(x) for x in shift]
        for name in ("tsdf", "weight", "rgb"):
            t = torch.roll(getattr(self, name), (-s[0], -s[1], -s[2]), (0, 1, 2))
            for axis, n in enumerate(self.dims):
                if s[axis]:
                    sl = slice(max(n - s[axis], 0), n) if s[axis] > 0 else slice(0, min(-s[axis], n))
                    t[(slice(None),) * axis + (sl,)] = self.trunc if name == "tsdf" else 0.0
            setattr(self, name, t)

    def integrate(self, depth_mm, color_u8, world_t_cam: np.ndarray, k: np.ndarray) -> None:
        """Fuse one (H, W) uint16 mm depth and (H, W, 3) uint8 color seen from
        ``world_t_cam`` (4, 4) with the 3x3 camera matrix ``k``."""
        dev, dt = self.device, self.dtype
        cam_pos = np.asarray(world_t_cam, np.float64)[:3, 3]
        nx, ny, nz = self.dims
        if self.origin is None:
            self.origin = self._centered(cam_pos)
            self.tsdf = torch.full(self.dims, self.trunc, dtype=dt, device=dev)
            self.weight = torch.zeros(self.dims, dtype=dt, device=dev)
            self.rgb = torch.zeros((*self.dims, 3), dtype=dt, device=dev)
        elif self.margin > 0:
            self._roll(cam_pos)
        depth = torch.as_tensor(depth_mm).to(dev)
        h, w = depth.shape
        depth_flat = depth.reshape(-1).to(dt) * 1e-3
        m = np.asarray(np.linalg.inv(np.asarray(world_t_cam, np.float64)), np.float32).tolist()
        fx, fy, cx, cy = np.asarray([k[0][0], k[1][1], k[0][2], k[1][2]], np.float32).tolist()
        origin = torch.tensor(self.origin, dtype=dt, device=dev)
        ix = torch.arange(nx, dtype=dt, device=dev).view(nx, 1, 1)
        iy = torch.arange(ny, dtype=dt, device=dev).view(1, ny, 1)
        iz = torch.arange(nz, dtype=dt, device=dev).view(1, 1, nz)
        px = origin[0] + (ix + 0.5) * self.vs
        py = origin[1] + (iy + 0.5) * self.vs
        pz = origin[2] + (iz + 0.5) * self.vs
        xc, yc, zc = (m[i][0] * px + m[i][1] * py + m[i][2] * pz + m[i][3] for i in range(3))
        zs = torch.clamp(zc, min=1e-6)
        ui = torch.round(fx * xc / zs + cx).to(torch.int64)
        vi = torch.round(fy * yc / zs + cy).to(torch.int64)
        in_view = (zc > self.min_dist) & (zc < self.max_dist) & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
        flat = torch.clamp(vi * w + ui, 0, h * w - 1)
        d = torch.take(depth_flat, flat)
        sdf = d - zc
        update = in_view & (d > self.min_dist) & (sdf > -self.trunc)
        w_obs = update.to(dt)
        new_w = torch.clamp(self.weight + w_obs, max=self.max_weight)
        num = self.weight * self.tsdf + w_obs * torch.clamp(sdf, -self.trunc, self.trunc)
        tsdf = torch.where(new_w > 0.0, num / torch.clamp(new_w, min=1e-9), self.tsdf)
        if self.color:
            c = torch.as_tensor(color_u8).to(dev).reshape(h * w, 3).to(dt)[flat]
            w_c = (update & (torch.abs(sdf) < self.trunc)).to(dt)[..., None]
            cw_old = torch.clamp(self.weight, max=self.max_weight)[..., None]
            cw_new = cw_old + w_c
            self.rgb = torch.where(cw_new > 0.0, (cw_old * self.rgb + w_c * c) / torch.clamp(cw_new, min=1e-9), self.rgb)
        self.tsdf, self.weight = tsdf, new_w
