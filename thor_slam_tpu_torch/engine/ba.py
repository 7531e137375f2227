"""Sliding-window bundle adjustment: fixed-shape Schur-complement Gauss-Newton.

Port of :mod:`thor_slam_tpu.engine.ba`. The window is a fixed-shape
problem (K poses, L landmarks, observations as a dense masked (K, C, L)
tensor); the BA sparsity is used algebraically: the landmark 3x3 blocks
are inverted in one batch, the Schur complement is a set of einsums over
(K, C, L), and the reduced camera system is one dense (6K, 6K) solve.
Pose 0 is the gauge anchor. Everything runs in float32 with TF32 off
(:func:`thor_slam_tpu_torch.utils.platform.pin_precision`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from thor_slam_tpu_torch.ops import lie


class BAProblem(NamedTuple):
    """A fixed-shape bundle-adjustment window.

    Attributes:
        body_t_world: (K, 4, 4) poses (world -> body).
        landmarks_w: (L, 3) world landmark positions.
        obs: (K, C, L, 2) normalized observations (undistorted, raw camera).
        obs_mask: (K, C, L) float weights; 0 where nothing was observed.
        cam_rot: (C, 3, 3) cam_T_body rotations.
        cam_trans: (C, 3) cam_T_body translations.
        pose_mask: (K,) float 1/0, which poses exist.
        lm_mask: (L,) float 1/0, which landmarks may move.
    """

    body_t_world: torch.Tensor
    landmarks_w: torch.Tensor
    obs: torch.Tensor
    obs_mask: torch.Tensor
    cam_rot: torch.Tensor
    cam_trans: torch.Tensor
    pose_mask: torch.Tensor
    lm_mask: torch.Tensor


class BAResult(NamedTuple):
    """Refined window: (K, 4, 4) poses, (L, 3) landmarks, and the masked
    reprojection RMS before and after (the input returned unchanged when
    the solve did not lower it)."""

    body_t_world: torch.Tensor
    landmarks_w: torch.Tensor
    initial_rms: torch.Tensor
    final_rms: torch.Tensor


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / determinant)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co = [
        [e * i - f * h, c * h - b * i, b * f - c * e],
        [f * g - d * i, a * i - c * g, c * d - a * f],
        [d * h - e * g, b * g - a * h, a * e - b * d],
    ]
    det = a * co[0][0] + b * co[1][0] + c * co[2][0]
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, 1e-20)
    adj = torch.stack([torch.stack(row, -1) for row in co], -2)
    return adj * inv_det[..., None, None]


def _residuals_jacobians(poses, landmarks, obs, cam_rot, cam_trans):
    """Residuals r (K,C,L,2), pose Jacobians (K,C,L,2,6), landmark
    Jacobians (K,C,L,2,3) and the behind-camera mask (K,C,L)."""
    p_b = torch.einsum("kij,lj->kli", poses[:, :3, :3], landmarks) + poses[:, None, :3, 3]
    p_c = torch.einsum("cij,klj->kcli", cam_rot, p_b) + cam_trans[None, :, None, :]
    z = torch.clamp(p_c[..., 2], min=1e-6)
    r = p_c[..., :2] / z[..., None] - obs

    inv_z = 1.0 / z
    x, y = p_c[..., 0], p_c[..., 1]
    zero = torch.zeros_like(inv_z)
    j_proj = torch.stack(
        [
            torch.stack([inv_z, zero, -x * inv_z * inv_z], -1),
            torch.stack([zero, inv_z, -y * inv_z * inv_z], -1),
        ],
        -2,
    )  # (K, C, L, 2, 3)
    # d p_b / d delta_k = [I | -hat(p_b)] (left se(3) perturbation of pose k).
    eye3 = torch.eye(3, dtype=p_b.dtype, device=p_b.device).expand(p_b.shape + (3,))
    dpb = torch.cat([eye3, -lie.hat(p_b)], -1)  # (K, L, 3, 6)
    dpc_pose = torch.einsum("cij,kljm->kclim", cam_rot, dpb)
    j_pose = torch.einsum("kclai,kclim->kclam", j_proj, dpc_pose)
    rc_rk = torch.einsum("cij,kjm->kcim", cam_rot, poses[:, :3, :3])
    j_lm = torch.einsum("kclai,kcim->kclam", j_proj, rc_rk)
    behind = p_c[..., 2] <= 1e-4
    return r, j_pose, j_lm, behind


def _masked_rms(r: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    num = torch.sum(w * torch.sum(r * r, -1))
    return torch.sqrt(num / torch.clamp(torch.sum(w), min=1.0))


def bundle_adjust(
    problem: BAProblem,
    iters: int = 5,
    huber_delta: float = 0.01,
    damping: float = 1e-4,
    landmark_damping: float = 1e-3,
) -> BAResult:
    """Fixed-iteration Schur-complement Gauss-Newton on a window.

    Args:
        problem: The window (:class:`BAProblem`).
        iters: GN iterations.
        huber_delta: Huber kernel width (normalized coordinates).
        damping: Levenberg damping of the reduced camera system.
        landmark_damping: Damping added to the landmark 3x3 blocks.
    """
    pb = problem
    k = pb.obs_mask.shape[0]
    dev, dt = pb.landmarks_w.device, pb.landmarks_w.dtype
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye_k = torch.eye(k, dtype=dt, device=dev)[:, :, None, None]
    free = pb.pose_mask.clone()
    free[0] = 0.0  # gauge
    sel = (free[:, None] * free[None, :])[:, :, None, None]
    pinned = eye_k * ((1.0 - free)[:, None, None, None] * eye6)
    lm_mask = pb.lm_mask[:, None]

    def rms_of(poses, landmarks):
        r, _, _, behind = _residuals_jacobians(poses, landmarks, pb.obs, pb.cam_rot, pb.cam_trans)
        return _masked_rms(r, pb.obs_mask * (~behind).to(dt))

    poses, landmarks = pb.body_t_world, pb.landmarks_w
    for _ in range(iters):
        r, j_p, j_l, behind = _residuals_jacobians(poses, landmarks, pb.obs, pb.cam_rot, pb.cam_trans)
        r_norm = torch.linalg.norm(r, dim=-1)
        huber = torch.where(r_norm <= huber_delta, 1.0, huber_delta / torch.clamp(r_norm, min=1e-12))
        w = pb.obs_mask * huber * (~behind).to(dt)
        jp_w = j_p * w[..., None, None]
        jl_w = j_l * w[..., None, None]

        h_pp = torch.einsum("kclai,kclaj->kij", jp_w, j_p)  # (K, 6, 6)
        h_ll = torch.einsum("kclai,kclaj->lij", jl_w, j_l)  # (L, 3, 3)
        h_pl = torch.einsum("kclai,kclaj->klij", jp_w, j_l)  # (K, L, 6, 3)
        g_p = torch.einsum("kclai,kcla->ki", jp_w, r)  # (K, 6)
        g_l = torch.einsum("kclai,kcla->li", jl_w, r)  # (L, 3)

        h_ll_inv = inv3x3(h_ll + landmark_damping * eye3) * lm_mask[..., None]
        # Schur complement S = Hpp - Hpl Hll^-1 Hlp, dense (6K, 6K).
        hpl_hinv = torch.einsum("klij,ljm->klim", h_pl, h_ll_inv)
        s_off = torch.einsum("klim,qlnm->kqin", hpl_hinv, h_pl)  # (K, K, 6, 6)
        s = -s_off + eye_k * h_pp[:, None]
        b = g_p - torch.einsum("klim,lm->ki", hpl_hinv, g_l)
        s = s * sel + pinned
        b = b * free[:, None]
        s_mat = s.permute(0, 2, 1, 3).reshape(k * 6, k * 6) + damping * torch.eye(
            k * 6, dtype=dt, device=dev
        )
        delta_p = -torch.linalg.solve_ex(s_mat, b.reshape(k * 6))[0].reshape(k, 6)
        delta_p = torch.where(torch.isfinite(delta_p).all(), delta_p, 0.0)

        # Back-substitution: dl = -Hll^-1 (g_l + Hlp^T dp).
        hlp_dp = torch.einsum("klij,ki->lj", h_pl, delta_p)
        delta_l = -torch.einsum("lij,lj->li", h_ll_inv, g_l + hlp_dp)
        delta_l = torch.where(torch.isfinite(delta_l), delta_l, 0.0) * lm_mask

        poses = lie.se3_exp(delta_p) @ poses
        landmarks = landmarks + delta_l

    initial_rms = rms_of(pb.body_t_world, pb.landmarks_w)
    final_rms = rms_of(poses, landmarks)
    ok = final_rms <= initial_rms  # reject a diverged solve outright
    return BAResult(
        body_t_world=torch.where(ok, poses, pb.body_t_world),
        landmarks_w=torch.where(ok, landmarks, pb.landmarks_w),
        initial_rms=initial_rms,
        final_rms=torch.where(ok, final_rms, initial_rms),
    )
