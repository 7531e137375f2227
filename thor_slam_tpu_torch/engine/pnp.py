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

import threading
from typing import NamedTuple

import torch

from thor_slam_tpu_torch.ops import lie, linalg
from thor_slam_tpu_torch.utils import profiling


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


class _CapturedPnP:
    """One :func:`ransac_pnp` captured in a CUDA graph over static buffers.

    Each call copies its tensors into the buffers, draws (or copies) the
    hypothesis uniforms into theirs outside the graph, replays, and clones
    the outputs: a result the caller holds is never overwritten by the
    next replay.
    """

    def __init__(self, inputs: dict, num_hypotheses: int, sample_size: int, hyp_iters: int, refine_iters: int):
        points_w = inputs["points_w"]
        self.device = points_w.device
        self.inputs = {name: torch.empty_like(t) for name, t in inputs.items()}
        self.threshold = torch.empty((), dtype=points_w.dtype, device=self.device)
        self.uniforms = torch.empty((num_hypotheses, points_w.shape[0]), dtype=points_w.dtype, device=self.device)
        self.static_args = dict(num_hypotheses=num_hypotheses, sample_size=sample_size, hyp_iters=hyp_iters,
                                refine_iters=refine_iters)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs: PnPResult | None = None
        self.free: torch.cuda.Event | None = None  # recorded once the last call's outputs were cloned

    def load(self, inputs: dict, inlier_threshold, uniforms, generator) -> None:
        """This call's inputs into the static buffers, on the current stream."""
        if self.free is not None:  # the last call's clones, on whichever stream it came
            torch.cuda.current_stream(self.device).wait_event(self.free)
        for name, t in inputs.items():
            self.inputs[name].copy_(t)
        if isinstance(inlier_threshold, torch.Tensor) and inlier_threshold.device == self.device:
            self.threshold.copy_(inlier_threshold)
        else:  # a number, or a CPU 0-dim tensor (read on the host)
            self.threshold.fill_(inlier_threshold)
        if uniforms is None:  # the generator advances as the eager draw advances it
            torch.rand(self.uniforms.shape, generator=generator, out=self.uniforms)
        else:
            if uniforms.shape != self.uniforms.shape or uniforms.dtype != self.uniforms.dtype:
                raise ValueError(f"uniforms must be {tuple(self.uniforms.shape)} {self.uniforms.dtype}, "
                                 f"got {tuple(uniforms.shape)} {uniforms.dtype}")
            self.uniforms.copy_(uniforms)

    def _solve(self) -> PnPResult:
        return ransac_pnp(**self.inputs, inlier_threshold=self.threshold, uniforms=self.uniforms,
                          **self.static_args)

    def capture(self) -> None:
        """One eager run on a side stream (lazy handles and workspaces come
        up there), then the capture. ``thread_local``: the uploader's thread
        keeps staging and copying meanwhile. A failed capture raises."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.device(self.device):
            with torch.cuda.stream(side):
                self._solve()
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                self.outputs = self._solve()
        self.graph = graph

    def replay(self) -> PnPResult:
        self.graph.replay()
        result = PnPResult(*(t.clone() for t in self.outputs))
        if self.free is None:
            self.free = torch.cuda.Event()
        self.free.record(torch.cuda.current_stream(self.device))
        return result


class GraphedRansacPnP:
    """:func:`ransac_pnp` replayed from CUDA graphs, one graph per key.

    Called as :func:`ransac_pnp` is, and with its result: the graph
    replays the same kernels on the same numbers, and the draws come from
    ``generator`` as the eager call takes them. The key is everything that
    shapes the captured work: device, N, ``num_hypotheses``,
    ``sample_size``, ``hyp_iters``, ``refine_iters``, dtype and whether
    ``obs_weight`` is given. The first call of a key captures its graph;
    every call, that one too, replays it. CPU tensors take the eager
    function. The open span gets ``graph``: ``"capture"``, ``"replay"`` or
    ``"eager"``.
    """

    def __init__(self) -> None:
        self._graphs: dict[tuple, _CapturedPnP] = {}
        self._lock = threading.Lock()
        self.captures = 0

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
        if points_w.device.type != "cuda":
            profiling.annotate(graph="eager")
            return ransac_pnp(
                points_w, obs, valid, cam_rot, cam_trans, init_body_t_world, num_hypotheses=num_hypotheses,
                sample_size=sample_size, hyp_iters=hyp_iters, refine_iters=refine_iters,
                inlier_threshold=inlier_threshold, uniforms=uniforms, generator=generator, obs_weight=obs_weight,
            )
        inputs = dict(points_w=points_w, obs=obs, valid=valid, cam_rot=cam_rot, cam_trans=cam_trans,
                      init_body_t_world=init_body_t_world)
        if obs_weight is not None:
            inputs["obs_weight"] = obs_weight
        key = (points_w.device, points_w.shape[0], num_hypotheses, sample_size, hyp_iters, refine_iters,
               points_w.dtype, obs_weight is not None)
        with self._lock:
            entry = self._graphs.get(key)
            if entry is None:
                entry = _CapturedPnP(inputs, num_hypotheses, sample_size, hyp_iters, refine_iters)
            entry.load(inputs, inlier_threshold, uniforms, generator)
            mode = "replay"
            if entry.graph is None:
                entry.capture()
                self._graphs[key] = entry
                self.captures += 1
                mode = "capture"
            profiling.annotate(graph=mode)
            return entry.replay()


#: The tracker's solve (``track_step``); loop verification and the sharded
#: solve call :func:`ransac_pnp` eagerly.
ransac_pnp_graphed = GraphedRansacPnP()
