"""Pose-graph optimization: Gauss-Newton over SE(3) relative constraints.

Port of :mod:`thor_slam_tpu.engine.posegraph`. Up to K nodes and E edges
as dense masked tensors; the residual of edge (i, j) is
``log(inv(T_meas) inv(X_i) X_j)``. The reference differentiates the whole
(E*6,) residual against all K*6 tangents with one ``jax.jacfwd``; an edge
depends only on its two nodes, so here each edge's 6x12 block is written
in closed form (:func:`_edge_jacobians`) and scattered into the same dense
(E*6, K*6) Jacobian: ``torch.func.jacfwd`` of :func:`_edge_logs` at
perturbed nodes gives the same blocks, at several times the host time.
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


def _edge_logs(x_i, x_j, t_meas):
    """(E, 6) unweighted residuals ``log(inv(T_meas) inv(X_i) X_j)`` and
    the (E, 4, 4) errors they are the logs of."""
    e = lie.se3_inverse(t_meas) @ (lie.se3_inverse(x_i) @ x_j)
    return lie.se3_log(e), e


def _edge_jacobians(x_i, x_j, t_meas, w):
    """(E, 6, 6) weighted Jacobian of each edge's residual against its
    target node's tangent, and the (E, 6) residuals.

    With ``E = inv(T_meas) inv(X_i) X_j`` and left perturbations
    ``X <- exp(d) X``, to first order ``E <- E exp(Ad(inv(X_j)) (d_j -
    d_i))``, so ``dr/dd_j = w Jr^-1(log E) Ad(inv(X_j))`` and ``dr/dd_i``
    is its negative. ``Jr^-1`` of SE(3) over [rho, phi] is ``[[A, M A],
    [0, A]]``: ``A = I + K/2 + c K^2`` (K = hat(phi), c(t) = (1 - (t/2)
    cot(t/2)) / t^2, the coefficient of :func:`lie.se3_log`) is SO(3)'s,
    and ``M`` is the derivative of the log's ``rho = (I - K/2 + c K^2) t``
    against phi. Taken in float64 from the dtype's poses, with the series
    of c and c'/t below t = 0.1.
    """
    xi, e = _edge_logs(x_i, x_j, t_meas)
    r = xi * w[:, None]
    phi, t = xi[:, 3:].double(), e[:, :3, 3].double()
    t2 = (phi * phi).sum(-1)[:, None, None]
    small = t2 < 1e-2
    th2 = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(th2)
    cot = torch.cos(0.5 * th) / torch.sin(0.5 * th)
    c = torch.where(small, 1 / 12 + t2 / 720 + t2 * t2 / 30240, (1.0 - 0.5 * th * cot) / th2)
    dc = torch.where(small, 1 / 360 + t2 / 7560 + t2 * t2 / 201600,
                     -2.0 / (th2 * th2) + cot / (2.0 * th2 * th) + 1.0 / (4.0 * th2 * torch.sin(0.5 * th) ** 2))
    k = lie.hat(phi)
    eye = torch.eye(3, dtype=k.dtype, device=k.device)
    a = eye + 0.5 * k + c * (k @ k)
    pt, tc, pc = phi[:, :, None], t[:, :, None], (k @ (k @ t[:, :, None]))
    m = 0.5 * lie.hat(t) + c * ((pt.transpose(1, 2) @ tc) * eye + pt @ tc.transpose(1, 2) - 2.0 * tc @ pt.transpose(1, 2))
    m = m + dc * (pc @ pt.transpose(1, 2))
    zero = torch.zeros_like(a)
    jr_inv = torch.cat([torch.cat([a, m @ a], -1), torch.cat([zero, a], -1)], -2)
    rt = x_j[:, :3, :3].double().transpose(1, 2)
    ad = torch.cat([torch.cat([rt, lie.hat(-(rt @ x_j[:, :3, 3:].double())[..., 0]) @ rt], -1),
                    torch.cat([zero, rt], -1)], -2)
    return (w[:, None, None].double() * (jr_inv @ ad)).to(x_j.dtype), r


def residuals(graph: PoseGraph, poses: torch.Tensor | None = None) -> torch.Tensor:
    """(E, 6) weighted edge residuals at ``poses`` (the graph's own by default)."""
    poses = graph.poses if poses is None else poses
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    return _edge_logs(poses[ei], poses[ej], graph.edge_t)[0] * graph.edge_weight[:, None]


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

    poses = g.poses
    for _ in range(iters):
        j_j, r = _edge_jacobians(poses[ei], poses[ej], g.edge_t, g.edge_weight)
        jac = torch.zeros((e * 6, k * 6), dtype=dt, device=dev)
        jac.index_put_((rows, cols_i), -j_j, accumulate=True)
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
