"""The multi-camera stereo visual-odometry tick.

Port of the stereo path of :mod:`thor_slam_tpu.engine.tracker`. One
:func:`track_step` consumes a (C, 2, H, W) rig tick and returns the new
state and the body pose:

* every tick (:func:`run_hot_frontend`): uint8 normalization, a 2-level
  pyramid, pyramidal KLT over all C*N landmark slots, then multi-camera
  RANSAC PnP with a Gauss-Newton polish and covariance;
* keyframe ticks only (:func:`run_keyframe_frontend` + :func:`mint_bank`):
  FAST-9 detection, upright BRIEF, stereo matching, photometric disparity
  refinement, triangulation and the landmark bank refresh.

The reference selects the keyframe branch with a device-side ``lax.cond``;
here it is a host ``if`` on the refresh flag, one 1-byte readback per
tick. Every tensor keeps a fixed shape, so the hot path can later be
captured in a CUDA graph.

An external pose prediction (the IMU backend's) seeds KLT and PnP in place
of the constant-velocity model. :func:`pack_ba_obs` and
:func:`pack_kf_sig` ship the tick's bundle-adjustment observations and
keyframe signature to the host backends in the reference's layouts.

Mono sources, the all-mono bootstrap, light ticks, half-resolution
staging, the median prefilter and oriented BRIEF are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from thor_slam_tpu_torch.engine import pnp, triangulate
from thor_slam_tpu_torch.ops import brief, calib, fast, klt, match
from thor_slam_tpu_torch.ops import stereo as stereo_ops
from thor_slam_tpu_torch.ops.image import downsample2, gaussian_blur
from thor_slam_tpu_torch.ops.lie import se3_inverse


@dataclass(frozen=True)
class TrackerParams:
    """Static tracker configuration: the stereo-path fields of the
    reference's ``thor_slam_tpu.engine.tracker.TrackerParams``, with its
    defaults. (Its mono, median-prefilter and oriented-BRIEF switches
    select paths not ported yet.)"""

    num_cams: int
    height: int
    width: int
    max_keypoints: int = 512
    fast_threshold: float = 0.05
    cell_size: int = 32
    per_cell: int = 8
    border_margin: int = 20
    match_max_distance: float = 64.0
    match_ratio: float = 0.95
    stereo_max_dy: float = 1.5
    max_disparity_px: float = 100.0
    klt_radius: int = 4
    klt_iters: int = 3
    klt_levels: int = 2
    klt_max_residual: float = 0.08
    persist_radius_px: float = 2.0
    min_disparity: float = 0.25
    max_depth_m: float = 40.0
    ransac_hypotheses: int = 16
    ransac_sample_size: int = 6
    inlier_threshold_px: float = 3.0
    keyframe_min_inliers: int = 50
    keyframe_max_translation: float = 0.12
    keyframe_max_rotation: float = 0.12
    keyframe_low_inlier_interval: int = 8
    min_track_inliers: int = 12
    restart_after_untracked: int = 5


class CameraSetup(NamedTuple):
    """Per-camera constants stacked over the camera axis C (see the
    reference's ``CameraSetup``): raw intrinsics ``k_left/k_right`` (C, 4),
    distortion ``dist_left/dist_right`` (C, 5), rectifying rotations
    ``rect_left/rect_right`` (C, 3, 3), rectified ``k_rect`` (C, 3) and
    ``baseline`` (C,), ``cam_r_body``/``cam_t_body`` body -> raw-left-cam,
    ``body_t_cam`` (C, 4, 4), the right-camera transforms and the (C,)
    ``stereo_mask``."""

    k_left: torch.Tensor
    k_right: torch.Tensor
    dist_left: torch.Tensor
    dist_right: torch.Tensor
    rect_left: torch.Tensor
    rect_right: torch.Tensor
    k_rect: torch.Tensor
    baseline: torch.Tensor
    cam_r_body: torch.Tensor
    cam_t_body: torch.Tensor
    body_t_cam: torch.Tensor
    cam_r_body_right: torch.Tensor
    cam_t_body_right: torch.Tensor
    stereo_mask: torch.Tensor


class TrackerState(NamedTuple):
    """Device-resident tracker state with fixed shapes.

    The reference's fields, without its PRNG ``key`` (RANSAC draws come from
    a caller-owned ``torch.Generator`` or are injected). ``lm_desc`` holds
    the (C, N, 8) descriptor words as int32 bit patterns.
    """

    world_t_body: torch.Tensor
    prev_world_t_body: torch.Tensor
    velocity_w: torch.Tensor
    lm_pos_w: torch.Tensor
    lm_desc: torch.Tensor
    lm_valid: torch.Tensor
    lm_px: torch.Tensor
    lm_obs_px: torch.Tensor
    lm_robs_px: torch.Tensor
    lm_robs_valid: torch.Tensor
    lm_id: torch.Tensor
    lm_id_counter: torch.Tensor
    kf_world_t_body: torch.Tensor
    prev_left0: torch.Tensor
    prev_left1: torch.Tensor
    prev_left2: torch.Tensor
    frame_idx: torch.Tensor
    untracked_streak: torch.Tensor
    lm_pending: torch.Tensor
    lm_anchor_px: torch.Tensor
    lm_weight: torch.Tensor
    last_kf_frame: torch.Tensor


class TrackOutput(NamedTuple):
    """Per-tick outputs; fields as the reference's ``TrackOutput``."""

    world_t_body: torch.Tensor
    num_inliers: torch.Tensor
    num_matches: torch.Tensor
    num_landmarks: torch.Tensor
    rms_error: torch.Tensor
    refreshed: torch.Tensor
    covariance: torch.Tensor
    obs_norm: torch.Tensor
    robs_norm: torch.Tensor
    lm_id: torch.Tensor
    lm_valid: torch.Tensor
    robs_valid: torch.Tensor


class HotProducts(NamedTuple):
    """Every-tick products: left pyramid, KLT tracks, PnP observations."""

    left: torch.Tensor
    cur_pyr1: torch.Tensor
    cur_pyr2: torch.Tensor
    tracks_xy: torch.Tensor
    tracks_valid: torch.Tensor
    obs_norm: torch.Tensor
    corr_valid: torch.Tensor


class KeyframeProducts(NamedTuple):
    """Keyframe products: detections, descriptors, stereo geometry."""

    kp_xy: torch.Tensor
    kp_valid: torch.Tensor
    desc_bits: torch.Tensor
    pts_cam: torch.Tensor
    tri_valid: torch.Tensor
    right_obs_px: torch.Tensor


def init_state(
    params: TrackerParams, device: torch.device | str, world_t_body0=None
) -> TrackerState:
    """Fresh state: no landmarks, pose at ``world_t_body0`` (identity)."""
    c, n = params.num_cams, params.max_keypoints
    h, w = params.height, params.width
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    pose0 = (
        torch.eye(4, **f32)
        if world_t_body0 is None
        else torch.as_tensor(np.asarray(world_t_body0, np.float32), device=device)
    )
    return TrackerState(
        world_t_body=pose0,
        prev_world_t_body=pose0.clone(),
        velocity_w=torch.zeros(3, **f32),
        lm_pos_w=torch.zeros((c, n, 3), **f32),
        lm_desc=torch.zeros((c, n, 8), **i32),
        lm_valid=torch.zeros((c, n), dtype=torch.bool, device=device),
        lm_px=torch.zeros((c, n, 2), **f32),
        lm_obs_px=torch.zeros((c, n, 2), **f32),
        lm_robs_px=torch.zeros((c, n, 2), **f32),
        lm_robs_valid=torch.zeros((c, n), dtype=torch.bool, device=device),
        lm_id=-torch.ones((c, n), **i32),
        lm_id_counter=torch.zeros((), **i32),
        kf_world_t_body=pose0.clone(),
        prev_left0=torch.zeros((c, h, w), **f32),
        prev_left1=torch.zeros((c, h // 2, w // 2), **f32),
        prev_left2=torch.zeros((c, h // 4, w // 4), **f32),
        frame_idx=torch.zeros((), **i32),
        untracked_streak=torch.zeros((), **i32),
        lm_pending=torch.zeros((c, n), dtype=torch.bool, device=device),
        lm_anchor_px=torch.zeros((c, n, 2), **f32),
        lm_weight=torch.ones((c, n), **f32),
        last_kf_frame=torch.zeros((), **i32),
    )


def track_step(
    params: TrackerParams,
    setup: CameraSetup,
    state: TrackerState,
    images: torch.Tensor,
    uniforms: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    cam_active: torch.Tensor | None = None,
    pose_prediction: torch.Tensor | None = None,
) -> tuple[TrackerState, TrackOutput]:
    """One VO tick.

    Args:
        params: Static configuration.
        setup: Per-camera constants (on the state's device).
        state: Current state.
        images: (C, 2, H, W) uint8 frames, or float32 in [0, 1] (left, right).
        uniforms: Optional (ransac_hypotheses, C*N) RANSAC draws in [0, 1).
        generator: Source of the RANSAC draws when ``uniforms`` is None.
        cam_active: Optional (C,) bool of live cameras; dead cameras are
            masked out of the solve and mint no landmarks.
        pose_prediction: Optional (4, 4) world_T_body prediction (IMU
            preintegration); it seeds both KLT and the PnP solve. None
            means the constant-velocity model.

    Returns:
        (new_state, output).
    """
    p = params
    if images.dtype == torch.uint8:
        images = images.float() * (1.0 / 255.0)

    if pose_prediction is None:
        # KLT starts from the constant-velocity extrapolation; PnP from the
        # last solved pose (extrapolating our own output compounds its error).
        delta = state.world_t_body @ se3_inverse(state.prev_world_t_body)
        extrapolated = delta @ state.world_t_body
        klt_prediction = torch.where(state.untracked_streak > 0, state.world_t_body, extrapolated)
        init_body_t_world = se3_inverse(state.world_t_body)
    else:  # an external prediction is independent of our own output
        klt_prediction = pose_prediction.to(state.world_t_body)
        init_body_t_world = se3_inverse(klt_prediction)
    klt_body_t_world = se3_inverse(klt_prediction)

    hot = run_hot_frontend(params, setup, state, images, klt_body_t_world)
    if cam_active is not None:
        hot = hot._replace(
            corr_valid=hot.corr_valid & cam_active[:, None],
            tracks_valid=hot.tracks_valid & cam_active[:, None],
        )

    c, n = p.num_cams, p.max_keypoints
    # Normalized-coordinate inlier gate from the pixel budget (largest focal).
    inlier_threshold = p.inlier_threshold_px / torch.amax(setup.k_left[:, 0])
    result = pnp.ransac_pnp(
        state.lm_pos_w.reshape(c * n, 3),
        hot.obs_norm.reshape(c * n, 2),
        hot.corr_valid.reshape(c * n),
        setup.cam_r_body.repeat_interleave(n, 0),
        setup.cam_t_body.repeat_interleave(n, 0),
        init_body_t_world,
        num_hypotheses=p.ransac_hypotheses,
        sample_size=p.ransac_sample_size,
        inlier_threshold=inlier_threshold,
        uniforms=uniforms,
        generator=generator,
    )
    return _finish_step(
        params, setup, state, hot, images,
        body_t_world=result.body_t_world,
        num_inliers=result.num_inliers,
        inliers_cn=result.inliers.reshape(c, n),
        rms_error=result.rms_error,
        init_body_t_world=init_body_t_world,
        covariance=result.covariance,
        cam_active=cam_active,
    )


def run_hot_frontend(
    params: TrackerParams,
    setup: CameraSetup,
    state: TrackerState,
    images: torch.Tensor,
    klt_body_t_world: torch.Tensor,
) -> HotProducts:
    """The every-tick path: left pyramid + KLT tracking of the landmark bank."""
    p = params
    left = images[:, 0].contiguous()
    pred_r = torch.einsum("cij,jk->cik", setup.cam_r_body, klt_body_t_world[:3, :3])
    pred_t = torch.einsum("cij,j->ci", setup.cam_r_body, klt_body_t_world[:3, 3]) + setup.cam_t_body
    lm_cam = torch.einsum("cij,cnj->cni", pred_r, state.lm_pos_w) + pred_t[:, None, :]
    uv_pred, in_front = calib.cam_points_to_raw_pixels(lm_cam, setup.k_left, setup.dist_left)

    cur_pyr1 = downsample2(left)
    cur_pyr2 = downsample2(cur_pyr1)
    tracks = klt.track_points_rig(
        (state.prev_left0, state.prev_left1, state.prev_left2),
        (left, cur_pyr1, cur_pyr2),
        state.lm_px, uv_pred,
        state.lm_valid & in_front,
        num_levels=p.klt_levels, radius=p.klt_radius, iters=p.klt_iters,
        max_residual=p.klt_max_residual,
    )
    obs_norm = calib.raw_pixels_to_normalized(tracks.xy, setup.k_left, setup.dist_left)
    return HotProducts(
        left=left,
        cur_pyr1=cur_pyr1,
        cur_pyr2=cur_pyr2,
        tracks_xy=tracks.xy,
        tracks_valid=tracks.valid,
        obs_norm=obs_norm,
        corr_valid=tracks.valid & state.lm_valid,
    )


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx, axis=1)`` for (C, M[, K]) x and (C, N) idx."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def run_keyframe_frontend(
    params: TrackerParams, setup: CameraSetup, images: torch.Tensor
) -> KeyframeProducts:
    """Keyframe work: detect -> describe -> stereo associate -> triangulate."""
    p = params
    left = images[:, 0].contiguous()
    right = images[:, 1].contiguous()
    left_sm = gaussian_blur(left, 2.0, radius=4)
    right_sm = gaussian_blur(right, 2.0, radius=4)

    def detect(ims):
        return fast.detect_keypoints_batched(
            ims,
            threshold=p.fast_threshold,
            max_keypoints=p.max_keypoints,
            cell_size=p.cell_size,
            per_cell=p.per_cell,
            border_margin=p.border_margin,
        )

    kp_l = detect(left)
    kp_r = detect(right)
    desc_l = brief.compute_descriptors_batched(left_sm, kp_l.xy, kp_l.valid)
    desc_r = brief.compute_descriptors_batched(right_sm, kp_r.xy, kp_r.valid)

    # Stereo association on rectified coordinates (the images stay raw).
    rect_xy_l = calib.raw_pixels_to_rect(
        kp_l.xy, setup.k_left, setup.dist_left, setup.rect_left, setup.k_rect
    )
    rect_xy_r = calib.raw_pixels_to_rect(
        kp_r.xy, setup.k_right, setup.dist_right, setup.rect_right, setup.k_rect
    )
    dy_lr = torch.abs(rect_xy_l[:, :, None, 1] - rect_xy_r[:, None, :, 1])
    dx_lr = rect_xy_l[:, :, None, 0] - rect_xy_r[:, None, :, 0]
    stereo_gate = (dy_lr <= p.stereo_max_dy + 1.0) & (dx_lr > 0) & (dx_lr <= p.max_disparity_px)
    stereo_m = match.match_descriptors(
        desc_l.bits, desc_l.valid, desc_r.bits, desc_r.valid,
        max_distance=p.match_max_distance, ratio=p.match_ratio, allowed=stereo_gate,
    )
    disp_rect, disp_valid = triangulate.match_disparities(
        rect_xy_l, rect_xy_r, stereo_m.idx, stereo_m.valid, max_dy=p.stereo_max_dy
    )

    # Subpixel: photometric refinement in raw image space, mapped back
    # through the rectification as a correction of the rectified disparity.
    disp_raw = kp_l.xy[..., 0] - _take(kp_r.xy[..., 0], stereo_m.idx)
    disp_raw_ref = stereo_ops.refine_disparity_photometric(left, right, kp_l.xy, disp_raw, disp_valid)
    disp = disp_rect + torch.where(disp_valid, disp_raw_ref - disp_raw, 0.0)

    pts_rect, tri_valid = triangulate.stereo_triangulate(
        rect_xy_l, disp, setup.k_rect, setup.baseline,
        min_disparity=p.min_disparity, max_depth_m=p.max_depth_m,
    )
    tri_valid = tri_valid & disp_valid & kp_l.valid & setup.stereo_mask[:, None]
    # Rectified-frame points -> raw left camera frame: p_cam = R_rect^T p_rect.
    pts_cam = torch.einsum("cji,cnj->cni", setup.rect_left, pts_rect)

    right_y = _take(kp_r.xy[..., 1], stereo_m.idx)
    right_obs_px = torch.stack([kp_l.xy[..., 0] - disp_raw_ref, right_y], -1)
    return KeyframeProducts(
        kp_xy=kp_l.xy,
        kp_valid=kp_l.valid,
        desc_bits=desc_l.bits,
        pts_cam=pts_cam,
        tri_valid=tri_valid,
        right_obs_px=right_obs_px,
    )


def mint_bank(
    params: TrackerParams,
    setup: CameraSetup,
    world_t_body: torch.Tensor,
    kf: KeyframeProducts,
    anchor_ok: torch.Tensor,
    cand_tracks_xy: torch.Tensor,
    cand_pos_w: torch.Tensor,
    cand_id: torch.Tensor,
    fresh_ids: torch.Tensor,
    cam_active: torch.Tensor | None,
    cand_weight: torch.Tensor,
) -> tuple:
    """Mint a landmark bank from keyframe products (stereo rigs).

    New landmarks are the triangulated points lifted to world with the new
    pose, except where a fresh keypoint lands within ``persist_radius_px``
    of a trusted tracked candidate: it inherits that candidate's world
    position, id and weight, anchoring the world frame across keyframes.

    Returns the 11-tuple (lm_pos, lm_desc, lm_valid, lm_px, lm_obs,
    lm_robs, lm_robs_valid, lm_id, lm_pending, lm_anchor_px, lm_weight).
    """
    p = params
    world_t_cam = torch.einsum("ij,cjk->cik", world_t_body, setup.body_t_cam)
    pts_w = (
        torch.einsum("cij,cnj->cni", world_t_cam[:, :3, :3], kf.pts_cam)
        + world_t_cam[:, None, :3, 3]
    )

    d2 = torch.sum((kf.kp_xy[:, :, None, :] - cand_tracks_xy[:, None, :, :]) ** 2, -1)
    d2 = torch.where(anchor_ok[:, None, :], d2, float("inf"))
    nearest = torch.argmin(d2, -1)
    near_d2 = torch.amin(d2, -1)
    inherits = near_d2 <= p.persist_radius_px**2
    lm_pos = torch.where(inherits[..., None], _take(cand_pos_w, nearest), pts_w)
    lm_valid = kf.tri_valid | (inherits & kf.kp_valid)
    lm_id = torch.where(inherits, _take(cand_id, nearest), fresh_ids)
    lm_weight = torch.where(inherits, _take(cand_weight, nearest), 1.0)
    lm_pending = torch.zeros_like(lm_valid)

    # BA observation: inherited landmarks keep their subpixel tracked
    # position; fresh ones the detection.
    lm_obs = torch.where(inherits[..., None], _take(cand_tracks_xy, nearest), kf.kp_xy)
    lm_robs = kf.right_obs_px + (lm_obs - kf.kp_xy)
    # The right observation is a measurement only for fresh triangulations.
    lm_robs_valid = kf.tri_valid & lm_valid & ~inherits
    if cam_active is not None:  # dead cameras mint no landmarks
        lm_valid = lm_valid & cam_active[:, None]
        lm_robs_valid = lm_robs_valid & cam_active[:, None]
    return (
        lm_pos, kf.desc_bits, lm_valid, kf.kp_xy, lm_obs,
        lm_robs, lm_robs_valid, lm_id, lm_pending, lm_obs, lm_weight,
    )


def _finish_step(
    params: TrackerParams,
    setup: CameraSetup,
    state: TrackerState,
    hot: HotProducts,
    images: torch.Tensor,
    body_t_world: torch.Tensor,
    num_inliers: torch.Tensor,
    inliers_cn: torch.Tensor,
    rms_error: torch.Tensor,
    init_body_t_world: torch.Tensor,
    covariance: torch.Tensor,
    cam_active: torch.Tensor | None = None,
) -> tuple[TrackerState, TrackOutput]:
    """Back half of a tick: acceptance, keyframe policy, state update."""
    p = params
    tracked = num_inliers >= p.min_track_inliers
    body_t_world = torch.where(tracked, body_t_world, init_body_t_world)
    world_t_body = se3_inverse(body_t_world)
    untracked_streak = torch.where(tracked, 0, state.untracked_streak + 1)

    rel = se3_inverse(state.kf_world_t_body) @ world_t_body
    trans_dist = torch.linalg.norm(rel[:3, 3])
    rot_angle = torch.arccos(torch.clamp(0.5 * (torch.trace(rel[:3, :3]) - 1.0), -1.0, 1.0))
    since_kf = state.frame_idx - state.last_kf_frame
    want_kf = (
        ((num_inliers < p.keyframe_min_inliers) & (since_kf >= p.keyframe_low_inlier_interval))
        | (trans_dist > p.keyframe_max_translation)
        | (rot_angle > p.keyframe_max_rotation)
    )
    restart = untracked_streak >= p.restart_after_untracked
    refresh_t = (state.frame_idx == 0) | (tracked & want_kf) | restart
    untracked_streak = torch.where(restart, 0, untracked_streak)

    c_, n_ = p.num_cams, p.max_keypoints
    refresh = bool(refresh_t)  # the tick's one readback: selects the branch
    if refresh:
        kf = run_keyframe_frontend(p, setup, images)
        fresh_ids = state.lm_id_counter + torch.arange(
            c_ * n_, dtype=torch.int32, device=state.lm_id.device
        ).reshape(c_, n_)
        bank = mint_bank(
            p, setup, world_t_body, kf,
            anchor_ok=hot.corr_valid & inliers_cn,  # trusted tracks
            cand_tracks_xy=hot.tracks_xy,
            cand_pos_w=state.lm_pos_w,
            cand_id=state.lm_id,
            fresh_ids=fresh_ids,
            cam_active=cam_active,
            cand_weight=state.lm_weight,
        )
    else:  # landmarks persist, KLT anchors advance
        bank = (
            state.lm_pos_w, state.lm_desc, hot.corr_valid, hot.tracks_xy,
            hot.tracks_xy, state.lm_robs_px, state.lm_robs_valid, state.lm_id,
            state.lm_pending, state.lm_anchor_px, state.lm_weight,
        )
    (
        lm_pos_w, lm_desc, lm_valid, lm_px, lm_obs_px,
        lm_robs_px, lm_robs_valid, lm_id, lm_pending, lm_anchor_px, lm_weight,
    ) = bank

    new_state = TrackerState(
        world_t_body=world_t_body,
        prev_world_t_body=state.world_t_body,
        velocity_w=state.velocity_w,
        lm_pos_w=lm_pos_w,
        lm_desc=lm_desc,
        lm_valid=lm_valid,
        lm_px=lm_px,
        lm_obs_px=lm_obs_px,
        lm_robs_px=lm_robs_px,
        lm_robs_valid=lm_robs_valid,
        lm_id=lm_id,
        lm_id_counter=state.lm_id_counter + c_ * n_ if refresh else state.lm_id_counter,
        kf_world_t_body=world_t_body if refresh else state.kf_world_t_body,
        prev_left0=hot.left,
        prev_left1=hot.cur_pyr1,
        prev_left2=hot.cur_pyr2,
        frame_idx=state.frame_idx + 1,
        untracked_streak=untracked_streak,
        lm_pending=lm_pending,
        lm_anchor_px=lm_anchor_px,
        lm_weight=lm_weight,
        last_kf_frame=state.frame_idx if refresh else state.last_kf_frame,
    )
    obs_norm_out = calib.raw_pixels_to_normalized(lm_obs_px, setup.k_left, setup.dist_left)
    robs_norm_out = calib.raw_pixels_to_normalized(lm_robs_px, setup.k_right, setup.dist_right)
    # World-frame covariance: rotate the [rho, phi] tangent covariance.
    r_wb = world_t_body[:3, :3]
    rot6 = torch.zeros((6, 6), dtype=r_wb.dtype, device=r_wb.device)
    rot6[:3, :3] = r_wb
    rot6[3:, 3:] = r_wb
    big = torch.eye(6, dtype=r_wb.dtype, device=r_wb.device) * 1e6
    cov_world = torch.where(tracked, rot6 @ covariance @ rot6.T, big)
    output = TrackOutput(
        world_t_body=world_t_body,
        num_inliers=num_inliers,
        num_matches=torch.sum(hot.corr_valid),
        num_landmarks=torch.sum(lm_valid),
        rms_error=rms_error,
        refreshed=refresh_t,
        covariance=cov_world,
        obs_norm=obs_norm_out,
        robs_norm=robs_norm_out,
        lm_id=lm_id,
        lm_valid=lm_valid,
        robs_valid=lm_robs_valid,
    )
    return new_state, output


#: Length of the packed per-tick output vector (see ``pack_output``).
PACKED_LEN = 57


def pack_output(out: TrackOutput) -> torch.Tensor:
    """The per-tick outputs as one (57,) float32 vector.

    Layout: world_t_body.ravel() (16) | num_inliers | num_matches |
    num_landmarks | rms_error | refreshed | covariance.ravel() (36).
    """
    scalars = torch.stack(
        [
            out.num_inliers.float(),
            out.num_matches.float(),
            out.num_landmarks.float(),
            out.rms_error.float(),
            out.refreshed.float(),
        ]
    )
    return torch.cat([out.world_t_body.reshape(-1), scalars, out.covariance.reshape(-1)])


def unpack_output(vec) -> dict:
    """Host-side parse of a fetched :func:`pack_output` vector."""
    v = vec.detach().cpu().numpy() if isinstance(vec, torch.Tensor) else np.asarray(vec)
    return {
        "world_t_body": v[:16].reshape(4, 4).astype(np.float64),
        "num_inliers": int(v[16]),
        "num_matches": int(v[17]),
        "num_landmarks": int(v[18]),
        "rms_error": float(v[19]),
        "refreshed": bool(v[20] > 0.5),
        "covariance": v[21:57].reshape(6, 6).astype(np.float64),
    }


def _host(arr) -> np.ndarray:
    return arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)


def pack_ba_obs(out: TrackOutput, lm_pos_w: torch.Tensor) -> torch.Tensor:
    """The tick's BA observations as one (C, N, 10) float32 tensor.

    Channels: obs_norm (2) | robs_norm (2) | lm_id (bit-cast) | lm_valid |
    robs_valid | lm_pos_w (3), where ``lm_pos_w`` is the post-tick bank.
    The id channel holds the int32 bit pattern viewed as float32, not a
    numeric cast: float32 is exact only to 2^24 and ids pass that in long
    runs.
    """
    return torch.cat(
        [
            out.obs_norm.float(),
            out.robs_norm.float(),
            out.lm_id.to(torch.int32).view(torch.float32)[..., None],
            out.lm_valid.float()[..., None],
            out.robs_valid.float()[..., None],
            lm_pos_w.float(),
        ],
        -1,
    )


def unpack_ba_obs(arr) -> dict:
    """Host-side parse of a fetched :func:`pack_ba_obs` array."""
    a = _host(arr)
    return {
        "obs": a[..., 0:2].astype(np.float32),
        "robs": a[..., 2:4].astype(np.float32),
        "ids": np.ascontiguousarray(a[..., 4], np.float32).view(np.int32),
        "valid": a[..., 5] > 0.5,
        "robs_valid": a[..., 6] > 0.5,
        "pos": a[..., 7:10].astype(np.float32),
    }


def pack_kf_sig(state: TrackerState) -> torch.Tensor:
    """The all-camera keyframe signature as one (C, N, 14) float32 tensor.

    Channels: descriptor words (8, bit-cast) | obs_px (2) | lm_valid (1) |
    lm_pos_w (3): what the place database stores per keyframe.
    """
    return torch.cat(
        [
            state.lm_desc.to(torch.int32).view(torch.float32),
            state.lm_obs_px.float(),
            (state.lm_valid & ~state.lm_pending).float()[..., None],
            state.lm_pos_w.float(),
        ],
        -1,
    )


def unpack_kf_sig(arr) -> dict:
    """Host-side parse of a :func:`pack_kf_sig` array: (C, N, 14), or a
    single-camera (N, 14) signature parsed with a C=1 axis. Descriptor
    words come back as uint32, the reference's type."""
    a = _host(arr)
    if a.ndim == 2:
        a = a[None]
    return {
        "desc": np.ascontiguousarray(a[..., 0:8], np.float32).view(np.uint32),
        "obs_px": a[..., 8:10].astype(np.float32),
        "valid": a[..., 10] > 0.5,
        "pos": a[..., 11:14].astype(np.float64),
    }
