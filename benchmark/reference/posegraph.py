"""The plain pose-graph solve: Gauss-Newton over SE(3) relative constraints.

Plain PyTorch in any dtype (float64 for the reference, bfloat16 for the
control), written from the solver's published definition and importing
nothing of the program. It mirrors the loop closure's solve
(``engine/posegraph.py`` of the port, ``optimize``):

* nodes are world_T_body poses; the residual of edge (i, j) with measured
  body_i_T_body_j ``T`` is ``w * log(inv(T) inv(X_i) X_j)``, the SE(3) log
  as [rho, phi] (rho = V(phi)^-1 t);
* a node moves by a left perturbation ``X <- exp(delta) X``;
* Gauss-Newton, 10 iterations, each solving ``(J^T J + 1e-5 I) delta =
  -J^T r`` with the Jacobian taken at delta = 0;
* node 0 is the gauge: it and the padded nodes (``node_mask`` 0) stay
  where they are; edges of weight 0 are padding;
* the final residual RMS is over the live edges' 6 components.

Departures, none of which changes a step's value in exact arithmetic:

* the Jacobian of the whole residual is taken at once with
  ``torch.func.jacfwd`` (the port: each edge's two 6x6 blocks in closed
  form, in float64, scattered into the dense matrix);
* the normal equations hold the free nodes alone (the port keeps every
  node and puts an identity on the fixed ones' rows, whose step is then 0)
  and the edges of weight 0 are left out (the port multiplies them by 0);
* exp and log are closed forms (the log's rotation from ``atan2`` of the
  skew part and the trace; the port goes through the quaternion) with
  Taylor series below an angle of the dtype's epsilon to the 1/4;
* a step that is not finite raises (the port skips it);
* no linear solver runs in bfloat16: the control solves its bfloat16
  normal equations in float32 and rounds the step back to bfloat16.
"""

from __future__ import annotations

import torch

ITERATIONS = 10
DAMPING = 1e-5
#: How far the program's float32 solve of a graph may lie from this one's
#: float64 solve of the same graph, node by node: translation (m) and
#: rotation (|R_a^T R_b - I|_F / sqrt(2)). Float32 keeps ~7 digits of a
#: metre-scale pose; ten re-linearized steps through a chain of up to 256
#: nodes, solved by float32 normal equations of up to 1,536 unknowns, cost
#: a few more. On an H100 the program's solves of the patrol cell's
#: closures lay at most 2.9e-6 m and 3.4e-5 off (54 of 15-210 nodes with
#: the Jacobian by ``jacfwd``, 25 of 15-227 nodes in closed form); the
#: bfloat16 control at least 3.7e-3 m or 2.9e-3 off, and it diverges on
#: the longer chains.
TRANS_TOL_M = 1e-3
ROT_TOL = 1e-3


def _small(t2: torch.Tensor) -> torch.Tensor:
    """Where the squared angle ``t2`` is below the square root of the
    dtype's epsilon (an angle of 1.2e-4 rad in float64, 0.3 in bfloat16):
    there the closed forms lose their digits and the Taylor series, exact
    to the dtype's precision, stand in."""
    return t2 < torch.finfo(t2.dtype).eps ** 0.5


def hat(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrices."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1), torch.stack([-y, x, o], -1)], -2)


def _coefficients(t2: torch.Tensor):
    """A = sin t / t, B = (1 - cos t) / t^2, C = (t - sin t) / t^3 of the
    squared angle ``t2``, with their series where t is small (no square
    root of 0 is taken: its derivative would not be finite)."""
    small = _small(t2)
    t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / (t * t))
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (t - torch.sin(t)) / (t * t * t))
    return a, b, c


def exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) tangents [rho, phi] -> (..., 4, 4) transforms."""
    rho, phi = xi[..., :3], xi[..., 3:]
    k = hat(phi)
    k2 = k @ k
    a, b, c = _coefficients((phi * phi).sum(-1)[..., None, None])
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(k.shape)
    r = eye + a * k + b * k2
    v = eye + b * k + c * k2
    t = (v @ rho[..., None])[..., 0]
    top = torch.cat([r, t[..., None]], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom = torch.cat([bottom[..., :3], torch.ones_like(bottom[..., 3:])], -1)
    return torch.cat([top, bottom], -2)


def log(m: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) transforms -> (..., 6) tangents [rho, phi]."""
    r = m[..., :3, :3]
    w = 0.5 * torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0], r[..., 1, 0] - r[..., 0, 1]], -1)
    s2 = (w * w).sum(-1)  # sin^2 of the angle
    cos = 0.5 * (r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2] - 1.0)
    small = _small(s2) & (cos > 0)
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    theta = torch.atan2(s, cos)
    phi = w * torch.where(small, 1.0 + s2 / 6.0, theta / s)[..., None]
    t2 = torch.where(small, s2, theta * theta)[..., None, None]
    a, b, _ = _coefficients(t2)
    d = torch.where(_small(t2), 1.0 / 12.0 + t2 / 720.0,
                    (1.0 - a / (2.0 * b)) / torch.where(_small(t2), torch.ones_like(t2), t2))
    k = hat(phi)
    v_inv = torch.eye(3, dtype=m.dtype, device=m.device).expand(k.shape) - 0.5 * k + d * (k @ k)
    rho = (v_inv @ m[..., :3, 3:4])[..., 0]
    return torch.cat([rho, phi], -1)


def inverse(m: torch.Tensor) -> torch.Tensor:
    """Rigid inverse of (..., 4, 4) transforms."""
    rt = m[..., :3, :3].transpose(-1, -2)
    t = -(rt @ m[..., :3, 3:4])
    top = torch.cat([rt, t], -1)
    return torch.cat([top, m[..., 3:4, :]], -2)


def residuals(poses, edge_i, edge_j, edge_t, edge_w) -> torch.Tensor:
    """(E, 6) weighted residuals of the edges at (K, 4, 4) ``poses``."""
    err = inverse(edge_t) @ (inverse(poses[edge_i]) @ poses[edge_j])
    return log(err) * edge_w[:, None]


def optimize(poses, node_mask, edge_i, edge_j, edge_t, edge_weight, dtype=torch.float64,
             iters: int = ITERATIONS, damping: float = DAMPING) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve a padded pose graph in ``dtype``; returns ((K, 4, 4) poses, RMS).

    Takes the graph's fields as the program's ``PoseGraph`` holds them
    (tensors or numpy arrays, any device: the solve runs on ``poses``'s
    device, or the CPU for numpy).
    """
    dev = poses.device if isinstance(poses, torch.Tensor) else torch.device("cpu")

    def t(x, dt=None):
        return torch.as_tensor(x).to(dev, dt)

    poses = t(poses, dtype)
    live = t(edge_weight, torch.float64) != 0
    ei, ej = t(edge_i, torch.long)[live], t(edge_j, torch.long)[live]
    et, ew = t(edge_t, dtype)[live], t(edge_weight, dtype)[live]
    free = torch.nonzero(t(node_mask, torch.float64) != 0).flatten()
    free = free[free != 0]
    solve_dtype = torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype
    for _ in range(iters):
        def r_of(delta, base=poses):
            moved = base.index_put((free,), exp(delta) @ base[free])
            return residuals(moved, ei, ej, et, ew).reshape(-1)

        zero = torch.zeros((len(free), 6), dtype=dtype, device=dev)
        jac = torch.func.jacfwd(r_of)(zero).reshape(-1, len(free) * 6)
        r = r_of(zero)
        h = (jac.T @ jac).to(solve_dtype) + damping * torch.eye(len(free) * 6, dtype=solve_dtype, device=dev)
        step = torch.linalg.solve(h, -(jac.T @ r).to(solve_dtype)).to(dtype)
        if not bool(torch.isfinite(step).all()):
            raise FloatingPointError("the Gauss-Newton step is not finite")
        poses = poses.index_put((free,), exp(step.reshape(-1, 6)) @ poses[free])
    final = residuals(poses, ei, ej, et, ew)
    rms = torch.sqrt((final.to(torch.float64) ** 2).sum() / max(6 * len(ei), 1))
    return poses, rms


def pose_differences(a, b) -> tuple[float, float]:
    """The largest translation (m) and rotation difference between two
    (K, 4, 4) pose sets, in float64; the rotation's is |R_a^T R_b - I|_F /
    sqrt(2), 2 sin(angle / 2), as the benchmark's pose check reads it."""
    a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
    trans = torch.linalg.norm(a[:, :3, 3] - b[:, :3, 3], dim=-1)
    rel = a[:, :3, :3].transpose(-1, -2) @ b[:, :3, :3] - torch.eye(3, dtype=torch.float64)
    rot = torch.linalg.norm(rel, dim=(-2, -1)) / 2.0**0.5
    return float(trans.max()), float(rot.max())
