"""Small SPD systems by an unrolled Cholesky factor.

Port of :mod:`thor_slam_tpu.ops.linalg`, kept op for op so the
Gauss-Newton steps follow the reference's arithmetic: the factor and the
two substitutions are statically unrolled over n and batched over any
leading dims (the RANSAC hypothesis axis). Inputs must be SPD; every call
site passes Levenberg-damped normal equations.
"""

from __future__ import annotations

import torch


def _chol_rows(a: torch.Tensor) -> list[list[torch.Tensor]]:
    """Rows ``[i][j]`` (j <= i) of the lower Cholesky factor, each (...,)."""
    n = a.shape[-1]
    rows: list[list[torch.Tensor]] = [[None] * (i + 1) for i in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - rows[i][k] * rows[j][k]
            if i == j:
                rows[i][j] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                rows[i][j] = s / rows[j][j]
    return rows


def _solve_from_rows(rows: list[list[torch.Tensor]], b: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = b given the unrolled factor; b is (..., n)."""
    n = len(rows)
    y: list[torch.Tensor] = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - rows[i][k] * y[k]
        y[i] = s / rows[i][i]
    x: list[torch.Tensor] = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - rows[k][i] * x[k]
        x[i] = s / rows[i][i]
    return torch.stack(x, -1)


def spd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a @ x = b`` for SPD ``a``: (..., n, n), (..., n) -> (..., n)."""
    return _solve_from_rows(_chol_rows(a), b)


def spd_inverse(a: torch.Tensor) -> torch.Tensor:
    """Inverse of SPD ``a`` (..., n, n), symmetrized."""
    n = a.shape[-1]
    rows = _chol_rows(a)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    cols = [_solve_from_rows(rows, eye[i].expand(a.shape[:-2] + (n,))) for i in range(n)]
    inv = torch.stack(cols, -1)
    return 0.5 * (inv + inv.transpose(-1, -2))
