"""Host-side dense-mapping orchestration: the in-process nvblox node.

Port of :mod:`thor_slam_tpu.pipeline.mapper`. :class:`DenseMapper`
consumes the RGB-D product (:class:`~thor_slam_tpu_torch.pipeline.rgbd.
RGBDFrame`) plus the engine's pose stream, keeps a TSDF grid on its device
that ROLLS with the robot, and serves the nvblox output surface (surface
cloud, Surface-Nets mesh, 2D ESDF costmap slice).

Frames: integration happens in the engine's ODOM frame, as the reference's
nvblox configuration (``global_frame: odom``).

Host cost per integrated frame: no synchronising runtime call when fed
``RGBDProcessor.process(..., fetch=False)`` device frames (depth and color
are consumed where the depth pipeline produced them; the pose enters as
scalars). The grid's tensors are written in place by every integrate,
decay and recenter, so a :class:`TsdfGrid` obtained from
:attr:`DenseMapper.grid` changes with the next one — copy it to keep it.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from thor_slam_tpu_torch.mapping import (
    GridSpec,
    SurfaceMesh,
    TsdfGrid,
    centered_origin,
    esdf_slice_2d,
    extract_mesh,
    extract_surface_points,
    load_grid,
    make_decay,
    make_grid,
    make_integrator,
    make_recenter,
    save_grid,
)
from thor_slam_tpu_torch.pipeline.rgbd import RGBDFrame
from thor_slam_tpu_torch.utils.platform import select_device

logger = logging.getLogger(__name__)


@dataclass
class MapperConfig:
    """Dense-mapper options (defaults = the reference's nvblox launch).

    Attributes:
        voxel_size_m: Voxel edge (reference ``voxel_size: 0.05``).
        dims: Grid voxel counts (x, y, z); z innermost. The default
            256x256x128 spans 12.8 x 12.8 x 6.4 m around the robot.
        truncation_vox: TSDF truncation band in voxels (reference 4.0).
        max_integration_distance_m: Depth cutoff (reference 10.0).
        integrate_color: Carry a color channel for mesh/cloud export.
        recenter_margin_m: Roll the grid when the robot gets closer than
            this to a horizontal grid face (0 disables recentering).
        slice_axis: Grid/odom axis the costmap slices across (2 = z, the
            vertical for an FLU body rig).
        slice_band_m: Costmap band (lo, hi) in ABSOLUTE odom coordinates
            along ``slice_axis``.
        esdf_max_distance_m: Costmap clamp radius.
    """

    voxel_size_m: float = 0.05
    dims: tuple[int, int, int] = (256, 256, 128)
    truncation_vox: float = 4.0
    max_integration_distance_m: float = 10.0
    integrate_color: bool = True
    recenter_margin_m: float = 2.0
    slice_axis: int = 2
    slice_band_m: tuple[float, float] = (0.0, 1.0)
    esdf_max_distance_m: float = 2.0


@dataclass
class MapperStats:
    """Observability counters for the status line. ``shapes_compiled``
    keeps the reference's name: the depth shapes seen, one integrator each
    (nothing compiles here)."""

    integrated_frames: int = 0
    recenters: int = 0
    last_observed_voxels: int = 0
    shapes_compiled: set = field(default_factory=set)


class DenseMapper:
    """TSDF mapping service driven by RGB-D frames and SLAM poses."""

    def __init__(self, config: MapperConfig | None = None, device: str | torch.device | None = None) -> None:
        """``device``: the grid's device; ``None`` is the current CUDA device
        (and raises without one), ``"cpu"`` runs on the CPU."""
        self.config = config or MapperConfig()
        self.device = select_device(device)
        c = self.config
        self._spec = GridSpec(
            dims=tuple(c.dims),
            voxel_size_m=c.voxel_size_m,
            truncation_vox=c.truncation_vox,
            max_integration_distance_m=c.max_integration_distance_m,
            integrate_color=c.integrate_color,
        )
        self._grid: TsdfGrid | None = None
        self._integrators: dict[tuple[int, int], object] = {}
        self._recenter = make_recenter(self._spec, donate=True)
        self._decay = None
        # Host shadow of the grid origin: every origin change is computed
        # on the host (make_grid / recenter shift), so reading it never
        # fetches grid.origin from the device (that would wait for the
        # previous integrate).
        self._origin_host: np.ndarray | None = None
        self.stats = MapperStats()

    @property
    def spec(self) -> GridSpec:
        return self._spec

    @property
    def grid(self) -> TsdfGrid | None:
        """The live grid on the device (None before the first frame); its
        tensors change with the next integrate/decay/recenter."""
        return self._grid

    def integrate(self, frame: RGBDFrame, world_t_product: np.ndarray) -> None:
        """Fuse one RGB-D frame taken at ``world_t_product`` (odom frame).

        With device tensors in ``frame`` (``RGBDProcessor.process(
        fetch=False)``) the depth->TSDF hop stays on the device and makes no
        synchronising call; host-numpy frames upload their payloads.

        Args:
            frame: The RGB-D product (u16 millimeter depth + aligned rgb).
            world_t_product: (4, 4) pose of the frame's PRODUCT camera
                frame (``RGBDProcessor.product_t_in_left`` composed with
                the body pose) in the mapping frame, a host array.
        """
        cam_pos = np.asarray(world_t_product, np.float64)[:3, 3]
        if self._grid is None:
            self._origin_host = centered_origin(self._spec, cam_pos)
            self._grid = make_grid(self._spec, origin_m=self._origin_host, device=self.device)
        elif self.config.recenter_margin_m > 0:
            self._maybe_recenter(cam_pos)

        h, w = frame.depth_mm.shape
        integ = self._integrators.get((h, w))
        if integ is None:
            integ = make_integrator(self._spec, donate=True)
            self._integrators[(h, w)] = integ
            self.stats.shapes_compiled.add((h, w))
        k = np.asarray(frame.intrinsics.matrix, np.float64)
        intr4 = np.asarray([k[0, 0], k[1, 1], k[0, 2], k[1, 2]], np.float32)
        if self._spec.integrate_color:
            rgb = frame.rgb
            if rgb.ndim == 2:  # grayscale product: replicate where it lies
                rgb = rgb[..., None]
                rgb = rgb.expand(h, w, 3) if isinstance(rgb, torch.Tensor) else np.repeat(rgb, 3, -1)
            color = rgb
        else:
            color = np.zeros((0,), np.uint8)
        cam_t_world = np.linalg.inv(np.asarray(world_t_product, np.float64))
        self._grid = integ(
            self._grid,
            frame.depth_mm,
            color,
            cam_t_world.astype(np.float32),
            intr4,
        )
        self.stats.integrated_frames += 1

    def _maybe_recenter(self, cam_pos: np.ndarray) -> None:
        origin = np.asarray(self._origin_host, np.float64)
        extent = np.asarray(self._spec.extent_m)
        margin = self.config.recenter_margin_m
        lo = origin + margin
        hi = origin + extent - margin
        # Only roll horizontally; z stays anchored (floors/ceilings).
        need = (cam_pos[:2] < lo[:2]) | (cam_pos[:2] > hi[:2])
        if not need.any():
            return
        target = centered_origin(self._spec, cam_pos)
        shift = np.zeros(3, np.int64)
        shift[:2] = np.round(
            (target[:2] - origin[:2]) / self._spec.voxel_size_m
        ).astype(np.int64)
        # The host computes the post-shift origin and hands it over: the
        # shadow and the device origin stay BIT-identical.
        self._origin_host = (
            self._origin_host.astype(np.float32)
            + shift.astype(np.float32) * np.float32(self._spec.voxel_size_m)
        )
        self._grid = self._recenter(self._grid, shift.astype(np.int32), self._origin_host)
        self.stats.recenters += 1
        logger.info("mapper: recentered grid by %s voxels", shift.tolist())

    def decay(self, factor: float = 0.95) -> None:
        """Shrink observation weights (dynamic-scene maintenance): stale
        geometry fades out; fully-decayed voxels revert to unobserved. Call
        at a fixed cadence (e.g. 1 Hz), independent of integration."""
        if self._grid is None:
            return
        if self._decay is None:
            self._decay = make_decay(self._spec, donate=True)
        self._grid = self._decay(self._grid, np.float32(factor))

    def save(self, path) -> None:
        """Persist the dense map (the reference's ``.npz`` layout)."""
        if self._grid is None:
            raise RuntimeError("no map to save: nothing integrated yet")
        save_grid(path, self._grid, self._spec)

    def load(self, path) -> None:
        """Restore a saved dense map (of either package) onto this mapper's
        device; its spec replaces the configured one."""
        self._grid, self._spec = load_grid(path, device=self.device)
        self._origin_host = self._grid.origin.cpu().numpy()  # one-time fetch
        self._integrators.clear()  # spec changed: integrators rebuild lazily
        self._recenter = make_recenter(self._spec, donate=True)
        self._decay = None

    # --- the nvblox output surface -------------------------------------

    def surface_cloud(self, max_points: int = 131072) -> tuple[np.ndarray, np.ndarray]:
        """Colored surface point cloud ((N, 3) f32 m, (N, 3) u8)."""
        if self._grid is None:
            return np.empty((0, 3), np.float32), np.empty((0, 3), np.uint8)
        return extract_surface_points(self._grid, self._spec, max_points=max_points)

    def mesh(self, max_vertices: int = 65536, max_quads: int = 65536) -> SurfaceMesh:
        """Surface-Nets mesh of the current map (world/odom coordinates)."""
        if self._grid is None:
            return SurfaceMesh(
                vertices=np.empty((0, 3), np.float32),
                colors=np.empty((0, 3), np.uint8),
                triangles=np.empty((0, 3), np.int32),
            )
        return extract_mesh(self._grid, self._spec, max_vertices=max_vertices, max_quads=max_quads)

    def esdf_slice(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """2D costmap slice over the configured band of ``slice_axis``.

        Returns:
            ``(distance_m, occupied, observed, plane_origin)`` — 2D
            arrays over the two NON-slice grid axes (in ascending axis
            order) plus the odom coordinates of cell (0, 0)'s corner on
            that plane.
        """
        spec = self._spec
        axis = self.config.slice_axis
        plane_axes = [a for a in range(3) if a != axis]
        n0, n1 = spec.dims[plane_axes[0]], spec.dims[plane_axes[1]]
        if self._grid is None:
            return (
                np.full((n0, n1), self.config.esdf_max_distance_m, np.float32),
                np.zeros((n0, n1), bool),
                np.zeros((n0, n1), bool),
                np.zeros(2, np.float64),
            )
        origin = np.asarray(self._origin_host, np.float64)
        lo_m, hi_m = self.config.slice_band_m
        n_axis = spec.dims[axis]
        k_lo = int(np.clip((lo_m - origin[axis]) / spec.voxel_size_m, 0, n_axis - 1))
        k_hi = int(np.clip((hi_m - origin[axis]) / spec.voxel_size_m, k_lo + 1, n_axis))
        tsdf = torch.movedim(self._grid.tsdf, axis, 2)
        weight = torch.movedim(self._grid.weight, axis, 2)
        dist, occ, obs = esdf_slice_2d(
            tsdf,
            weight,
            voxel_size_m=spec.voxel_size_m,
            z_lo_vox=k_lo,
            z_hi_vox=k_hi,
            max_distance_m=self.config.esdf_max_distance_m,
        )
        dist, occ, obs = (t.cpu().numpy() for t in (dist, occ, obs))
        self.stats.last_observed_voxels = int(obs.sum())
        plane_origin = origin[plane_axes]
        return dist, occ, obs, plane_origin
