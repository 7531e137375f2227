"""Dense mapping of the port: the nvblox replacement on the card.

Port of :mod:`thor_slam_tpu.mapping`, which consumes the RGB-D stream the
system already produces (``pipeline/rgbd.py``):

* :mod:`tsdf` — projective TSDF integration over a dense voxel grid
  (voxel-parallel gather from the depth image; no scatters), with the
  reference deployment's parameters as defaults (voxel 0.05 m, truncation
  4 voxels, max integration distance 10 m).
* :mod:`esdf` — EXACT Euclidean signed-distance field via separable
  min-plus distance transforms (3D for planning, 2D slice for costmaps).
* :mod:`mesh` — Surface-Nets dual contouring with fixed budgets.

The reference computes all three in plain XLA code (no Pallas kernel), so
the port's plain PyTorch forms are the port.
"""

from thor_slam_tpu_torch.mapping.esdf import esdf_from_tsdf, esdf_slice_2d
from thor_slam_tpu_torch.mapping.mesh import SurfaceMesh, extract_mesh, extract_surface_points
from thor_slam_tpu_torch.mapping.tsdf import (
    GridSpec,
    TsdfGrid,
    centered_origin,
    load_grid,
    make_decay,
    make_grid,
    make_integrator,
    make_recenter,
    make_scan_integrator,
    save_grid,
)

__all__ = [
    "GridSpec",
    "TsdfGrid",
    "SurfaceMesh",
    "centered_origin",
    "esdf_from_tsdf",
    "esdf_slice_2d",
    "extract_mesh",
    "extract_surface_points",
    "load_grid",
    "make_decay",
    "make_grid",
    "make_integrator",
    "make_recenter",
    "make_scan_integrator",
    "save_grid",
]
