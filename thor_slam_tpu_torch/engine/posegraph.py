"""Pose-graph optimization: Gauss-Newton over SE(3) relative constraints.

Port of :mod:`thor_slam_tpu.engine.posegraph`. Up to K nodes and E edges
as dense masked tensors; the residual of edge (i, j) is
``log(inv(T_meas) inv(X_i) X_j)``. The reference differentiates the whole
(E*6,) residual against all K*6 tangents with one ``jax.jacfwd``; an edge
depends only on its two nodes, so here ``torch.func.jacfwd`` runs per edge
over its 12 tangents (vmapped over edges) and the 6x12 blocks are
scattered into the same dense (E*6, K*6) Jacobian.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from thor_slam_tpu_torch.ops import lie


class PoseGraph(NamedTuple):
    """A fixed-capacity pose graph.

    Attributes:
        poses: (K, 4, 4) node poses (world_T_body).
        node_mask: (K,) float 1/0, nodes in use.
        edge_i, edge_j: (E,) int64 source and target node per edge.
        edge_t: (E, 4, 4) measured relative transforms body_i_T_body_j.
        edge_weight: (E,) float weights (0 disables an edge).
    """

    poses: torch.Tensor
    node_mask: torch.Tensor
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    edge_t: torch.Tensor
    edge_weight: torch.Tensor


def sequential_graph(poses, rel_noise_weight: float = 1.0, capacity_edges: int | None = None):
    """Odometry-chain edges of a pose sequence (host numpy).

    Returns (edge_i, edge_j, edge_t, weight) padded to ``capacity_edges``.
    """
    poses = np.asarray(poses)
    k = poses.shape[0]
    e = capacity_edges or (k - 1)
    edge_i = np.zeros(e, np.int32)
    edge_j = np.zeros(e, np.int32)
    edge_t = np.tile(np.eye(4, dtype=np.float32), (e, 1, 1))
    w = np.zeros(e, np.float32)
    for idx in range(min(k - 1, e)):
        edge_i[idx] = idx
        edge_j[idx] = idx + 1
        edge_t[idx] = np.linalg.inv(poses[idx]) @ poses[idx + 1]
        w[idx] = rel_noise_weight
    return edge_i, edge_j, edge_t, w


def _edge_residual(d_i, d_j, x_i, x_j, t_meas, w):
    """(6,) weighted residual of one edge at node tangent offsets d_i, d_j."""
    xi = lie.se3_exp(d_i) @ x_i
    xj = lie.se3_exp(d_j) @ x_j
    err = lie.se3_inverse(t_meas) @ (lie.se3_inverse(xi) @ xj)
    return lie.se3_log(err) * w


def _edge_residual_aux(d_i, d_j, x_i, x_j, t_meas, w):
    r = _edge_residual(d_i, d_j, x_i, x_j, t_meas, w)
    return r, r


_edge_jacobians = torch.func.vmap(
    torch.func.jacfwd(_edge_residual_aux, argnums=(0, 1), has_aux=True)
)


def residuals(graph: PoseGraph, poses: torch.Tensor | None = None) -> torch.Tensor:
    """(E, 6) weighted edge residuals at ``poses`` (the graph's own by default)."""
    poses = graph.poses if poses is None else poses
    zero = torch.zeros((graph.edge_i.shape[0], 6), dtype=poses.dtype, device=poses.device)
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    return torch.func.vmap(_edge_residual)(zero, zero, poses[ei], poses[ej], graph.edge_t, graph.edge_weight)


def optimize(graph: PoseGraph, iters: int = 10, damping: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton pose-graph solve; node 0 is the gauge anchor.

    Returns:
        (poses (K, 4, 4), final residual RMS).
    """
    g = graph
    k = g.poses.shape[0]
    e = g.edge_i.shape[0]
    dt, dev = g.poses.dtype, g.poses.device
    ei, ej = g.edge_i.long(), g.edge_j.long()
    free = g.node_mask.clone()
    free[0] = 0.0
    sel = free.repeat_interleave(6)
    h_fixed = damping * torch.eye(k * 6, dtype=dt, device=dev) + torch.diag(1.0 - sel)
    cols = torch.arange(6, device=dev)
    rows = (torch.arange(e, device=dev)[:, None] * 6 + cols)[:, :, None]  # (E, 6, 1)
    cols_i = (ei[:, None] * 6 + cols)[:, None, :].expand(e, 6, 6)
    cols_j = (ej[:, None] * 6 + cols)[:, None, :].expand(e, 6, 6)
    rows = rows.expand(e, 6, 6)
    zero = torch.zeros((e, 6), dtype=dt, device=dev)

    poses = g.poses
    for _ in range(iters):
        (j_i, j_j), r = _edge_jacobians(zero, zero, poses[ei], poses[ej], g.edge_t, g.edge_weight)
        jac = torch.zeros((e * 6, k * 6), dtype=dt, device=dev)
        jac.index_put_((rows, cols_i), j_i, accumulate=True)
        jac.index_put_((rows, cols_j), j_j, accumulate=True)
        jac = jac * sel[None, :]
        h = jac.T @ jac + h_fixed
        b = jac.T @ r.reshape(-1)
        delta = -torch.linalg.solve_ex(h, b)[0]
        delta = torch.where(torch.isfinite(delta).all(), delta, 0.0)
        poses = lie.se3_exp(delta.reshape(k, 6) * free[:, None]) @ poses

    final = residuals(g, poses)
    active = torch.sum(g.edge_weight > 0)
    rms = torch.sqrt(torch.sum(final**2) / torch.clamp(active * 6, min=1))
    return poses, rms
