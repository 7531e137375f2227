"""Multi-camera PnP: batched Gauss-Newton with Huber IRLS, and RANSAC.

Port of :mod:`thor_slam_tpu.engine.pnp`. The optimized variable is
``body_T_world``; observations are normalized image coordinates with a
per-observation ``cam_T_body``; tangents are ``[rho, phi]``, applied on the
left. RANSAC is a fixed batch of hypotheses solved together; everything is
fixed-iteration and fixed-shape, with no host synchronization.

The hypothesis draws of the reference come from ``jax.random.uniform``,
which PyTorch cannot reproduce: :func:`ransac_pnp` takes them as an
optional ``uniforms`` tensor and otherwise draws them from a caller-owned
``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from thor_slam_tpu_torch.ops import lie, linalg


class PnPResult(NamedTuple):
    """Robust pose estimate.

    Attributes:
        body_t_world: (4, 4) pose (world -> body).
        inliers: (N,) bool inlier mask at the final pose.
        num_inliers: () int64.
        rms_error: () float32 inlier RMS reprojection error (normalized).
        covariance: (6, 6) covariance in the left tangent [rho, phi].
    """

    body_t_world: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor
    rms_error: torch.Tensor
    covariance: torch.Tensor


def project_points(body_t_world, points_w, cam_rot, cam_trans):
    """World points -> body, camera frames and normalized projections.

    Batched: ``body_t_world`` (..., 4, 4), ``points_w`` (..., N, 3),
    ``cam_rot`` (..., N, 3, 3), ``cam_trans`` (..., N, 3).
    """
    p_b = points_w @ body_t_world[..., :3, :3].transpose(-1, -2) + body_t_world[..., None, :3, 3]
    p_c = (cam_rot @ p_b[..., None])[..., 0] + cam_trans
    z = torch.clamp(p_c[..., 2], min=1e-6)
    uv = p_c[..., :2] / z[..., None]
    return p_b, p_c, uv


def _residuals_and_jacobian(body_t_world, points_w, obs, cam_rot, cam_trans):
    p_b, p_c, uv = project_points(body_t_world, points_w, cam_rot, cam_trans)
    r = uv - obs
    z = torch.clamp(p_c[..., 2], min=1e-6)
    inv_z = 1.0 / z
    x, y = p_c[..., 0], p_c[..., 1]
    zero = torch.zeros_like(inv_z)
    j_proj = torch.stack(
        [
            torch.stack([inv_z, zero, -x * inv_z * inv_z], -1),
            torch.stack([zero, inv_z, -y * inv_z * inv_z], -1),
        ],
        -2,
    )  # (..., N, 2, 3)
    eye = torch.eye(3, dtype=p_b.dtype, device=p_b.device).expand(p_b.shape[:-1] + (3, 3))
    dpb = torch.cat([eye, -lie.hat(p_b)], -1)  # (..., N, 3, 6)
    j = j_proj @ cam_rot @ dpb  # (..., N, 2, 6)
    behind = p_c[..., 2] <= 1e-4
    return r, j, behind


def _huber_weights(r_norm: torch.Tensor, delta: float) -> torch.Tensor:
    return torch.where(r_norm <= delta, 1.0, delta / torch.clamp(r_norm, min=1e-12))


def _normal_equations(j, r, w, damping):
    jw = j * w[..., None, None]
    eye = torch.eye(6, dtype=j.dtype, device=j.device)
    h = torch.einsum("...nai,...naj->...ij", jw, j) + damping * eye
    g = torch.einsum("...nai,...na->...i", jw, r)
    return h, g


def gauss_newton_pnp(
    points_w: torch.Tensor,
    obs: torch.Tensor,
    weights: torch.Tensor,
    cam_rot: torch.Tensor,
    cam_trans: torch.Tensor,
    init_body_t_world: torch.Tensor,
    iters: int = 8,
    huber_delta: float = 0.01,
    damping: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """IRLS Gauss-Newton refinement over masked correspondences.

    Batched over any leading dims (the hypothesis axis): ``points_w``
    (..., N, 3), ``obs`` (..., N, 2), ``weights`` (..., N) (0 disables),
    ``cam_rot`` (..., N, 3, 3), ``cam_trans`` (..., N, 3),
    ``init_body_t_world`` (4, 4) or (..., 4, 4).

    Returns:
        (body_t_world (..., 4, 4), residual norms (..., N)).
    """
    x = init_body_t_world.expand(points_w.shape[:-2] + (4, 4))
    for _ in range(iters):
        r, j, behind = _residuals_and_jacobian(x, points_w, obs, cam_rot, cam_trans)
        r_norm = torch.linalg.norm(r, dim=-1)
        w = weights * _huber_weights(r_norm, huber_delta) * (1.0 - behind.float())
        h, g = _normal_equations(j, r, w, damping)
        delta = -linalg.spd_solve(h, g)
        delta = torch.where(torch.isfinite(delta).all(-1, keepdim=True), delta, 0.0)
        x = lie.se3_exp(delta) @ x
    r, _, behind = _residuals_and_jacobian(x, points_w, obs, cam_rot, cam_trans)
    r_norm = torch.linalg.norm(r, dim=-1) + behind * 1e3
    return x, r_norm


def pose_covariance(
    body_t_world: torch.Tensor,
    points_w: torch.Tensor,
    obs: torch.Tensor,
    inlier_weights: torch.Tensor,
    cam_rot: torch.Tensor,
    cam_trans: torch.Tensor,
    damping: float = 1e-6,
) -> torch.Tensor:
    """(6, 6) ``sigma^2 (J^T W J)^-1`` in the [rho, phi] tangent.

    ``sigma^2`` is the per-coordinate residual variance of the weighted
    inliers; a non-finite result becomes 1e6 * I.
    """
    r, j, behind = _residuals_and_jacobian(body_t_world, points_w, obs, cam_rot, cam_trans)
    w = inlier_weights * (1.0 - behind.float())
    h, _ = _normal_equations(j, r, w, damping)
    n_eff = torch.sum(w)
    dof = torch.clamp(2.0 * n_eff - 6.0, min=1.0)
    sigma2 = torch.sum(w[:, None] * r**2) / dof
    cov = sigma2 * linalg.spd_inverse(h)
    cov = 0.5 * (cov + cov.T)
    big = torch.eye(6, dtype=cov.dtype, device=cov.device) * 1e6
    return torch.where(torch.isfinite(cov).all(), cov, big)


def ransac_pnp(
    points_w: torch.Tensor,
    obs: torch.Tensor,
    valid: torch.Tensor,
    cam_rot: torch.Tensor,
    cam_trans: torch.Tensor,
    init_body_t_world: torch.Tensor,
    num_hypotheses: int = 32,
    sample_size: int = 8,
    hyp_iters: int = 5,
    refine_iters: int = 6,
    inlier_threshold: float | torch.Tensor = 0.012,
    uniforms: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> PnPResult:
    """Batched-hypothesis robust PnP.

    Every hypothesis runs Gauss-Newton from ``init_body_t_world`` on a
    random ``sample_size`` subset of valid correspondences (Gumbel top-k
    over the validity mask); the hypothesis with the most inliers seeds a
    final IRLS polish over its inlier set.

    Args:
        points_w: (N, 3) world landmarks.
        obs: (N, 2) normalized observations.
        valid: (N,) bool correspondence mask.
        cam_rot: (N, 3, 3) per-observation cam_T_body rotations.
        cam_trans: (N, 3) translations.
        init_body_t_world: (4, 4) pose prediction.
        num_hypotheses: Hypotheses H.
        sample_size: Correspondences per hypothesis S.
        hyp_iters: GN iterations per hypothesis.
        refine_iters: GN iterations for the polish.
        inlier_threshold: Normalized-coordinate inlier gate.
        uniforms: Optional (H, N) draws in [0, 1) for the hypothesis
            sampling (tests inject the reference's draws).
        generator: Source of the draws when ``uniforms`` is None.
    """
    n = points_w.shape[0]
    if uniforms is None:
        uniforms = torch.rand(
            (num_hypotheses, n), generator=generator, device=points_w.device, dtype=points_w.dtype
        )
    gumbel = -torch.log(-torch.log(uniforms + 1e-12) + 1e-12)
    scores = torch.where(valid[None, :], gumbel, float("-inf"))
    # S rounds of (argmax, mask): the reference's top-k, with its
    # first-index tie order.
    iota_n = torch.arange(n, device=points_w.device)[None, :]
    cols = []
    for _ in range(sample_size):
        i = torch.argmax(scores, 1)
        cols.append(i)
        scores = torch.where(iota_n == i[:, None], float("-inf"), scores)
    subset_idx = torch.stack(cols, 1)  # (H, S)

    hyp_poses, _ = gauss_newton_pnp(
        points_w[subset_idx],
        obs[subset_idx],
        valid[subset_idx].float(),
        cam_rot[subset_idx],
        cam_trans[subset_idx],
        init_body_t_world,
        iters=hyp_iters,
    )  # (H, 4, 4)

    _, _, uv = project_points(hyp_poses, points_w, cam_rot, cam_trans)  # (H, N, 2)
    err = torch.linalg.norm(uv - obs, dim=-1)
    inlier_masks = (err <= inlier_threshold) & valid
    counts = inlier_masks.sum(1)
    best = torch.argmax(counts)
    best_pose = hyp_poses[best]
    best_inliers = inlier_masks[best]

    refined, r_norm = gauss_newton_pnp(
        points_w, obs, best_inliers.float(), cam_rot, cam_trans, best_pose, iters=refine_iters
    )
    final_inliers = (r_norm <= inlier_threshold) & valid
    num = torch.sum(final_inliers)
    rms = torch.sqrt(
        torch.sum(torch.where(final_inliers, r_norm**2, 0.0)) / torch.clamp(num, min=1)
    )
    # If the polish lost inliers (degenerate), keep the better of the two.
    use_refined = num >= torch.sum(best_inliers) // 2
    pose_out = torch.where(use_refined, refined, best_pose)
    inl_out = torch.where(use_refined, final_inliers, best_inliers)
    cov = pose_covariance(pose_out, points_w, obs, inl_out.float(), cam_rot, cam_trans)
    return PnPResult(
        body_t_world=pose_out,
        inliers=inl_out,
        num_inliers=torch.sum(inl_out),
        rms_error=rms,
        covariance=cov,
    )
