"""Lie-group math on tensors: SO(3)/SE(3) exp/log, quaternions (xyzw).

Port of :mod:`thor_slam_tpu.ops.lie`. Every function takes a leading batch
(``(..., 3)``, ``(..., 3, 3)``, ``(..., 4, 4)``, ``(..., 6)``) where the
reference is ``vmap``-ed; small-angle branches use the same Taylor
fallbacks selected with ``torch.where``. se(3) tangents are ``[rho, phi]``.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def hat(v: torch.Tensor) -> torch.Tensor:
    """so(3) hat: (..., 3) -> (..., 3, 3) skew-symmetric."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )


def vee(m: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], -1)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) rotation vectors -> (..., 3, 3) rotations."""
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    k = hat(phi)
    small = theta2 > _EPS
    a = torch.where(small, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(small, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    return _eye(3, phi) + a[..., None, None] * k + b[..., None, None] * (k @ k)


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3), batched."""
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    k = hat(phi)
    small = theta2 > _EPS
    b = torch.where(small, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = torch.where(
        small, (theta - torch.sin(theta)) / (theta2 * theta), 1.0 / 6.0 - theta2 / 120.0
    )
    return _eye(3, phi) + b[..., None, None] * k + c[..., None, None] * (k @ k)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) tangents [rho, phi] -> (..., 4, 4) transforms."""
    rho, phi = xi[..., :3], xi[..., 3:]
    r = so3_exp(phi)
    t = (so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    m = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    m[..., :3, :3] = r
    m[..., :3, 3] = t
    m[..., 3, 3] = 1.0
    return m


def matrix_to_quat(r: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations -> (..., 4) unit quaternions (xyzw), w >= 0."""
    r00, r01, r02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    r10, r11, r12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    r20, r21, r22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    t = r00 + r11 + r22
    qx = torch.stack([1.0 + r00 - r11 - r22, r01 + r10, r02 + r20, r21 - r12], -1)
    qy = torch.stack([r01 + r10, 1.0 - r00 + r11 - r22, r12 + r21, r02 - r20], -1)
    qz = torch.stack([r02 + r20, r12 + r21, 1.0 - r00 - r11 + r22, r10 - r01], -1)
    qw = torch.stack([r21 - r12, r02 - r20, r10 - r01, 1.0 + t], -1)
    candidates = torch.stack([qx, qy, qz, qw], -2)  # (..., 4, 4)
    mags = torch.stack(
        [1.0 + r00 - r11 - r22, 1.0 - r00 + r11 - r22, 1.0 - r00 - r11 + r22, 1.0 + t], -1
    )
    best = torch.argmax(mags, -1)
    q = torch.take_along_dim(candidates, best[..., None, None], -2)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., 3:4] < 0, -q, q)


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations -> (..., 3) rotation vectors, via the quaternion."""
    q = matrix_to_quat(r)
    qv, qw = q[..., :3], q[..., 3]
    n = torch.linalg.norm(qv, dim=-1)
    angle = 2.0 * torch.atan2(n, qw)
    scale = torch.where(
        n > _EPS, angle / torch.clamp(n, min=_EPS), 2.0 / torch.clamp(qw, min=_EPS)
    )
    return qv * scale[..., None]


def se3_log(m: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) transforms -> (..., 6) tangents [rho, phi]."""
    phi = so3_log(m[..., :3, :3])
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    k = hat(phi)
    half = 0.5 * theta
    cot_term = torch.where(
        theta2 > _EPS,
        (1.0 - 0.5 * theta * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS)) / theta2,
        1.0 / 12.0 + theta2 / 720.0,
    )
    j_inv = _eye(3, m) - 0.5 * k + cot_term[..., None, None] * (k @ k)
    rho = (j_inv @ m[..., :3, 3:4])[..., 0]
    return torch.cat([rho, phi], -1)


def se3_inverse(m: torch.Tensor) -> torch.Tensor:
    """Analytic rigid inverse of (..., 4, 4) transforms."""
    r_t = m[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(m)
    out[..., :3, :3] = r_t
    out[..., :3, 3] = -(r_t @ m[..., :3, 3:4])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def transform_points(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) transform to (..., 3) points."""
    return pts @ m[:3, :3].T + m[:3, 3]


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternions (xyzw) -> (..., 3, 3) rotations."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product (xyzw), batched."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        -1,
    )
