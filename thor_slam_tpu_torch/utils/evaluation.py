"""Trajectory evaluation: ATE (with rigid alignment) and RPE.

The framework's accuracy metric is ATE-RMSE vs ground truth (BASELINE.md:
"EuRoC ATE-RMSE <= cuVSLAM baseline"). Implements the standard TUM-style
evaluation: associate by timestamp, rigidly align (Umeyama, no scale for
stereo), report translational RMSE.

Copy of :mod:`thor_slam_tpu.utils.evaluation`, kept in the port so that
the port imports nothing of the JAX package; keep the two in step.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (optionally similarity) transform src -> dst.

    Args:
        src: (N, 3) source points (estimated trajectory positions).
        dst: (N, 3) destination points (ground truth).
        with_scale: Solve for scale too (monocular); stereo keeps scale = 1.

    Returns:
        (scale, R (3,3), t (3,)): dst ~ scale * R @ src + t.
    """
    if src.shape[0] < 3:
        return 1.0, np.eye(3), dst.mean(axis=0) - src.mean(axis=0) if len(src) else np.zeros(3)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1.0
    r = u @ s @ vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        scale = np.trace(np.diag(d) @ s) / var_s
    else:
        scale = 1.0
    t = mu_d - scale * r @ mu_s
    return scale, r, t


def ate_rmse(
    est_positions: np.ndarray,
    gt_positions: np.ndarray,
    align: bool = True,
    with_scale: bool = False,
) -> float:
    """Absolute trajectory error (RMSE over aligned positions), meters."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    assert est.shape == gt.shape
    if align:
        scale, r, t = umeyama_alignment(est, gt, with_scale)
        est = scale * est @ r.T + t
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=-1))))


def rpe_translation(
    est_poses: np.ndarray,
    gt_poses: np.ndarray,
    delta: int = 1,
) -> float:
    """Relative pose error: RMSE of per-``delta``-step translation drift.

    Args:
        est_poses: (N, 4, 4) estimated world_T_body poses.
        gt_poses: (N, 4, 4) ground-truth poses.
        delta: Frame separation for relative motions.

    Returns:
        RMSE of relative translation errors (meters per delta frames).
    """
    est = np.asarray(est_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    errs = []
    for i in range(len(est) - delta):
        rel_est = np.linalg.inv(est[i]) @ est[i + delta]
        rel_gt = np.linalg.inv(gt[i]) @ gt[i + delta]
        err = np.linalg.inv(rel_gt) @ rel_est
        errs.append(np.linalg.norm(err[:3, 3]))
    return float(np.sqrt(np.mean(np.square(errs)))) if errs else 0.0


def rotation_rmse_deg(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """RMSE of absolute orientation error in degrees (after no alignment)."""
    errs = []
    for e, g in zip(np.asarray(est_poses), np.asarray(gt_poses)):
        rel = np.linalg.inv(g[:3, :3]) @ e[:3, :3]
        ang = np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1))
        errs.append(np.degrees(ang))
    return float(np.sqrt(np.mean(np.square(errs)))) if errs else 0.0
