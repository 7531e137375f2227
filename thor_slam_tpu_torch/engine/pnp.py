"""Multi-camera PnP: batched Gauss-Newton with Huber IRLS, and RANSAC.

Port of :mod:`thor_slam_tpu.engine.pnp`. The optimized variable is
``body_T_world``; observations are normalized image coordinates with a
per-observation ``cam_T_body``; tangents are ``[rho, phi]``, applied on the
left. RANSAC is a fixed batch of hypotheses solved together; everything is
fixed-iteration and fixed-shape, with no host synchronization.

On the card the tracker's solve is :data:`ransac_pnp_graphed`: the same
function captured once per input shape in a CUDA graph and replayed, so
that its ~2,200 small kernels cost one launch of host time.

The hypothesis draws of the reference come from ``jax.random.uniform``,
which PyTorch cannot reproduce: :func:`ransac_pnp` takes them as an
optional ``uniforms`` tensor and otherwise draws them from a caller-owned
``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from thor_slam_tpu_torch.ops import lie, linalg
from thor_slam_tpu_torch.utils import cuda_graph, profiling


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


def sample_subsets(
    uniforms: torch.Tensor,
    valid: torch.Tensor,
    sample_size: int,
    obs_weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """(H, S) row indices: Gumbel top-k over the valid rows, one subset a
    hypothesis, in one stable descending sort.

    ``uniforms`` (H, N) are draws in [0, 1); ``obs_weight`` (N,) shifts the
    scores by its logarithm, so rows are drawn in proportion to it. Ties
    keep the lower index first. With fewer than ``sample_size`` valid rows
    the places left over hold index 0, as often as it takes: what the
    reference's rounds of argmax over an exhausted row return, and what
    callers' weights (``valid[idx]``) then count.
    """
    gumbel = -torch.log(-torch.log(uniforms + 1e-12) + 1e-12)
    if obs_weight is not None:
        gumbel = gumbel + torch.log(torch.clamp(obs_weight, min=1e-6))[None, :]
    scores = torch.where(valid[None, :], gumbel, float("-inf"))
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return torch.where(torch.isneginf(top[:, :sample_size]), 0, idx[:, :sample_size])


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-dim index tensor, gathered on the device: indexing
    by a 0-dim integer tensor reads the index back to the host first."""
    return x.index_select(0, i.view(1))[0]


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
    obs_weight: torch.Tensor | None = None,
) -> PnPResult:
    """Batched-hypothesis robust PnP.

    Every hypothesis runs Gauss-Newton from ``init_body_t_world`` on a
    random ``sample_size`` subset of valid correspondences
    (:func:`sample_subsets`); the hypothesis with the most inliers seeds a
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
        obs_weight: Optional (N,) a-priori observation weights (inverse
            relative variance): they scale the normal equations of every
            solve and of the covariance, and rows enter the hypotheses in
            proportion to them. None means uniform.
    """
    n = points_w.shape[0]
    if uniforms is None:
        uniforms = torch.rand(
            (num_hypotheses, n), generator=generator, device=points_w.device, dtype=points_w.dtype
        )
    subset_idx = sample_subsets(uniforms, valid, sample_size, obs_weight)  # (H, S)

    def weighted(mask: torch.Tensor, idx=None) -> torch.Tensor:
        w = mask.float()
        if obs_weight is None:
            return w
        return w * (obs_weight if idx is None else obs_weight[idx])

    hyp_poses, _ = gauss_newton_pnp(
        points_w[subset_idx],
        obs[subset_idx],
        weighted(valid[subset_idx], subset_idx),
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
    best_pose = _pick(hyp_poses, best)
    best_inliers = _pick(inlier_masks, best)

    refined, r_norm = gauss_newton_pnp(
        points_w, obs, weighted(best_inliers), cam_rot, cam_trans, best_pose, iters=refine_iters
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
    cov = pose_covariance(pose_out, points_w, obs, weighted(inl_out), cam_rot, cam_trans)
    return PnPResult(
        body_t_world=pose_out,
        inliers=inl_out,
        num_inliers=torch.sum(inl_out),
        rms_error=rms,
        covariance=cov,
    )


class GraphedRansacPnP(cuda_graph.GraphCache):
    """:func:`ransac_pnp` replayed from CUDA graphs
    (:mod:`thor_slam_tpu_torch.utils.cuda_graph`), one graph per key.

    Called as :func:`ransac_pnp` is, and with its result, cloned out of
    the graph. The draws come from ``generator`` into the static
    ``uniforms`` outside the graph, as the eager call takes them. The key
    is device, N, ``num_hypotheses``, ``sample_size``, ``hyp_iters``,
    ``refine_iters``, dtype and whether ``obs_weight`` is given. The open
    span gets ``graph``: ``"capture"``, ``"replay"`` or ``"eager"``.
    """

    def __call__(
        self,
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
        obs_weight: torch.Tensor | None = None,
    ) -> PnPResult:
        dev, n = points_w.device, points_w.shape[0]
        static_args = dict(num_hypotheses=num_hypotheses, sample_size=sample_size, hyp_iters=hyp_iters,
                           refine_iters=refine_iters)
        if not (isinstance(inlier_threshold, torch.Tensor) and inlier_threshold.device == dev):
            inlier_threshold = float(inlier_threshold)  # a number, or a CPU 0-dim tensor (read on the host)
        inputs = dict(points_w=points_w, obs=obs, valid=valid, cam_rot=cam_rot, cam_trans=cam_trans,
                      init_body_t_world=init_body_t_world, obs_weight=obs_weight,
                      inlier_threshold=inlier_threshold, uniforms=uniforms)

        def eager() -> PnPResult:
            profiling.annotate(graph="eager")
            return ransac_pnp(**inputs, generator=generator, **static_args)

        def make() -> cuda_graph.Captured:
            return cuda_graph.Captured(dev, {**inputs, "inlier_threshold": points_w.new_empty(()),
                                             "uniforms": points_w.new_empty((num_hypotheses, n))})

        def replay(entry: cuda_graph.Captured) -> PnPResult:
            static = entry.load("inputs", inputs)
            if uniforms is None:  # the generator advances as the eager draw advances it
                torch.rand(static["uniforms"].shape, generator=generator, out=static["uniforms"])
            chain = entry.chains[0]
            profiling.annotate(graph=entry.run(chain, lambda _: ransac_pnp(**static, **static_args)))
            return entry.own(chain.outputs)

        key = (dev, n, num_hypotheses, sample_size, hyp_iters, refine_iters, points_w.dtype, obs_weight is not None)
        return self.dispatch(key, dev, eager, make, replay)


#: The tracker's solve (``track_step``); loop verification and the sharded
#: solve call :func:`ransac_pnp` eagerly.
ransac_pnp_graphed = GraphedRansacPnP()
