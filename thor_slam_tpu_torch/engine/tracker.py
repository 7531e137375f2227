"""The multi-camera visual-odometry tick.

Port of :mod:`thor_slam_tpu.engine.tracker`. One :func:`track_step`
consumes a (C, 2, H, W) rig tick and returns the new state and the body
pose:

* every tick (:func:`run_hot_frontend`): uint8 normalization, a 2-level
  pyramid, pyramidal KLT over all C*N landmark slots, then multi-camera
  RANSAC PnP with a Gauss-Newton polish and covariance;
* keyframe ticks only (:func:`run_keyframe_frontend` + :func:`mint_bank`):
  FAST-9 detection (one launch for both eyes of every camera), BRIEF
  (one gather launch for both eyes; upright, or steered with
  ``oriented_descriptors``), stereo matching, photometric disparity
  refinement, triangulation and the landmark bank refresh.

``median_prefilter`` passes every input image through an exact 3x3 median
first.

A light tick (``allow_refresh=False``) takes the left images only, (C, 1,
H, W): the keyframe branch, the only reader of the right images, is never
entered and its flag is never read back. With ``half_res`` the images
arrive at half resolution (the host's 2x2 mean) and are upsampled 2x,
bilinearly, before anything else reads them.

Mono sources (``stereo_mask`` False; the engine sets ``has_mono``) never
triangulate. On a mixed rig their keyframe detections are seeded from the
landmarks the stereo cameras minted in the same keyframe, each with a
weight the PnP solve applies. On a rig with no stereo source
(``mono_bootstrap``) fresh detections enter the bank as pending 2D tracks;
the first map comes from :func:`mono_init` (two views of camera 0), and
later keyframes promote pending tracks by motion triangulation
(:func:`mint_bank`). A mono source ships a zero-filled right image: the
keyframe front end still makes its one FAST launch and one gather launch
over both eyes of every camera, the same counts as on a stereo rig, and
``stereo_mask`` drops every stereo product of such a camera.

The reference selects the keyframe branch with a device-side ``lax.cond``;
here it is a host ``if`` on the refresh flag, one 1-byte readback per full
tick (:attr:`TrackOutput.refreshed_host` hands it to the caller). Every
tensor keeps a fixed shape, so on the card :data:`track_step_graphed`
replays the tick around its PnP solve from captured CUDA graphs, which
leaves the readback and the keyframe branch on the host.

An external pose prediction (the IMU backend's) seeds KLT and PnP in place
of the constant-velocity model. :func:`pack_ba_obs` and
:func:`pack_kf_sig` ship the tick's bundle-adjustment observations and
keyframe signature to the host backends in the reference's layouts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from thor_slam_tpu_torch.engine import epipolar, pnp, triangulate
from thor_slam_tpu_torch.ops import brief, calib, fast, klt, match, patches_cuda
from thor_slam_tpu_torch.ops import stereo as stereo_ops
from thor_slam_tpu_torch.ops.image import downsample2, gaussian_blur, median3x3, upsample2
from thor_slam_tpu_torch.ops.lie import se3_inverse
from thor_slam_tpu_torch.utils import cuda_graph, profiling


@dataclass(frozen=True)
class TrackerParams:
    """Static tracker configuration: the fields and defaults of the
    reference's ``thor_slam_tpu.engine.tracker.TrackerParams``.

    ``has_mono`` and ``mono_bootstrap`` are set by the engine from the
    rig (a mono source present; no stereo source at all). The
    ``mono_seed_*`` fields gate the cross-camera seeding of a mixed rig,
    ``mono_obs_weight`` is the prior weight of a seeded observation (and
    of a mono camera in the BA window), ``mono_seed_disp_sigma_px`` the
    stereo disparity noise its per-landmark weight assumes. The
    ``mono_init_*`` / ``mono_trigger_parallax`` fields gate the two-view
    bootstrap, ``mono_min_parallax`` every motion triangulation, and below
    ``mono_reboot_min_tracks`` tracked anchors an unbootstrapped rig
    re-mints them."""

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
    oriented_descriptors: bool = False
    median_prefilter: bool = False
    has_mono: bool = False
    mono_seed_radius_px: float = 3.0
    mono_seed_max_hamming: float = 64.0
    mono_obs_weight: float = 0.25
    mono_seed_disp_sigma_px: float = 0.4
    mono_bootstrap: bool = False
    mono_init_min_inliers: int = 40
    mono_trigger_parallax: float = 0.02
    mono_min_parallax: float = 0.01
    mono_reboot_min_tracks: int = 30


class CameraSetup(NamedTuple):
    """Per-camera constants stacked over the camera axis C (see the
    reference's ``CameraSetup``): raw intrinsics ``k_left/k_right`` (C, 4),
    distortion ``dist_left/dist_right`` (C, 5), rectifying rotations
    ``rect_left/rect_right`` (C, 3, 3), rectified ``k_rect`` (C, 3) and
    ``baseline`` (C,), ``cam_r_body``/``cam_t_body`` body -> raw-left-cam,
    ``body_t_cam`` (C, 4, 4), the right-camera transforms and the (C,)
    ``stereo_mask``. A mono source carries its left geometry in the
    right-imager fields, identity rectification and a placeholder
    baseline; ``stereo_mask`` is False for it."""

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
    the (C, N, 8) descriptor words as int32 bit patterns. ``lm_pending``
    marks slots tracked in 2D with no 3D position yet (all-mono rigs),
    ``lm_anchor_px`` their observation at the minting keyframe, and
    ``lm_weight`` each landmark's PnP observation weight (1 for a
    stereo-triangulated one).
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
    """Per-tick outputs; fields as the reference's ``TrackOutput``, plus
    ``refreshed_host``: ``refreshed`` as the host read it to select the
    keyframe branch (False on a light tick, which reads nothing back)."""

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
    refreshed_host: bool = False


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
    allow_refresh: bool = True,
    half_res: bool = False,
) -> tuple[TrackerState, TrackOutput]:
    """One VO tick.

    The tick runs in four parts, each a function that
    :data:`track_step_graphed` captures or calls in the same order: the
    front segment (:func:`_front`), the RANSAC PnP solve (:func:`_solve`),
    the back segment (:func:`_back`: the keyframe decision and the persist
    branch's state and outputs), then the one readback of the decision and,
    on a keyframe, the keyframe branch (:func:`_complete`). The spans
    ``tracker.front`` and ``tracker.back`` say ``graph="eager"``.

    Args:
        params: Static configuration.
        setup: Per-camera constants (on the state's device).
        state: Current state.
        images: (C, 2, H, W) uint8 frames, or float32 in [0, 1] (left,
            right); (C, 1, H, W) left images on a light tick; at (H/2, W/2)
            with ``half_res``.
        uniforms: Optional (ransac_hypotheses, C*N) RANSAC draws in [0, 1).
        generator: Source of the RANSAC draws when ``uniforms`` is None.
        cam_active: Optional (C,) bool of live cameras; dead cameras are
            masked out of the solve and mint no landmarks.
        pose_prediction: Optional (4, 4) world_T_body prediction (IMU
            preintegration); it seeds both KLT and the PnP solve. None
            means the constant-velocity model.
        allow_refresh: False makes a light tick: no keyframe, no restart
            (the untracked streak keeps counting and trips at the next full
            tick), the keyframe front end is never entered and nothing is
            read back. The state and outputs are those of a full tick that
            chose not to refresh.
        half_res: The images are 2x-downsampled; they are upsampled back
            bilinearly (half-pixel centres, as the host's 2x2 mean) before
            the median prefilter and KLT.

    Returns:
        (new_state, output).
    """
    with profiling.span("tracker.front", graph="eager"):
        front = _front(params, setup, state, images, cam_active, pose_prediction, half_res)
    result = _solve(params, state, front, uniforms, generator)
    with profiling.span("tracker.back", graph="eager"):
        back = _back(params, setup, state, front.hot, result, front.init_body_t_world, allow_refresh)
    return _complete(params, setup, state, front, result, back, cam_active, allow_refresh)


class FrontProducts(NamedTuple):
    """The front segment's products: the prepared (C, S, H, W) float
    images, the every-tick products, the PnP prior and the solve's
    per-row inputs over the C*N slots."""

    images: torch.Tensor
    hot: HotProducts
    init_body_t_world: torch.Tensor
    pnp_valid: torch.Tensor
    cam_rot: torch.Tensor
    cam_trans: torch.Tensor
    inlier_threshold: torch.Tensor


def _front(
    params: TrackerParams,
    setup: CameraSetup,
    state: TrackerState,
    images: torch.Tensor,
    cam_active: torch.Tensor | None,
    pose_prediction: torch.Tensor | None,
    half_res: bool,
    gather=None,
) -> FrontProducts:
    """Every tick before the solve: normalization, upsampling, the median
    prefilter, the KLT prediction, :func:`run_hot_frontend` (``gather`` as
    :func:`klt.track_points_rig` takes it) and the PnP inputs."""
    p = params
    if images.dtype == torch.uint8:
        images = images.float() * (1.0 / 255.0)
    if half_res:
        images = upsample2(images)
    if p.median_prefilter:
        images = median3x3(images)

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

    hot = run_hot_frontend(params, setup, state, images, klt_body_t_world, gather=gather)
    if cam_active is not None:
        hot = hot._replace(
            corr_valid=hot.corr_valid & cam_active[:, None],
            tracks_valid=hot.tracks_valid & cam_active[:, None],
        )

    n = p.max_keypoints
    # Pending slots are 2D only: no position to constrain the pose.
    pnp_valid = hot.corr_valid & ~state.lm_pending if p.mono_bootstrap else hot.corr_valid
    return FrontProducts(
        images=images,
        hot=hot,
        init_body_t_world=init_body_t_world,
        pnp_valid=pnp_valid.reshape(-1),
        cam_rot=setup.cam_r_body.repeat_interleave(n, 0),
        cam_trans=setup.cam_t_body.repeat_interleave(n, 0),
        # Normalized-coordinate inlier gate from the pixel budget (largest focal).
        inlier_threshold=p.inlier_threshold_px / torch.amax(setup.k_left[:, 0]),
    )


def _solve(
    params: TrackerParams,
    state: TrackerState,
    front: FrontProducts,
    uniforms: torch.Tensor | None,
    generator: torch.Generator | None,
) -> pnp.PnPResult:
    """The tick's RANSAC PnP (:data:`pnp.ransac_pnp_graphed`) in its span."""
    p = params
    c, n = p.num_cams, p.max_keypoints
    with profiling.span("tracker.pnp"):
        return pnp.ransac_pnp_graphed(
            state.lm_pos_w.reshape(c * n, 3),
            front.hot.obs_norm.reshape(c * n, 2),
            front.pnp_valid,
            front.cam_rot,
            front.cam_trans,
            front.init_body_t_world,
            num_hypotheses=p.ransac_hypotheses,
            sample_size=p.ransac_sample_size,
            inlier_threshold=front.inlier_threshold,
            uniforms=uniforms,
            generator=generator,
            # Seeded mono slots carry their own weight; stereo slots are 1.
            obs_weight=state.lm_weight.reshape(c * n) if p.has_mono else None,
        )


def run_hot_frontend(
    params: TrackerParams,
    setup: CameraSetup,
    state: TrackerState,
    images: torch.Tensor,
    klt_body_t_world: torch.Tensor,
    gather=None,
) -> HotProducts:
    """The every-tick path: left pyramid + KLT tracking of the landmark bank
    (``gather``: KLT's patch gather, :func:`klt.track_points_rig`)."""
    p = params
    left = images[:, 0].contiguous()
    pred_r = torch.einsum("cij,jk->cik", setup.cam_r_body, klt_body_t_world[:3, :3])
    pred_t = torch.einsum("cij,j->ci", setup.cam_r_body, klt_body_t_world[:3, 3]) + setup.cam_t_body
    lm_cam = torch.einsum("cij,cnj->cni", pred_r, state.lm_pos_w) + pred_t[:, None, :]
    uv_pred, in_front = calib.cam_points_to_raw_pixels(lm_cam, setup.k_left, setup.dist_left)
    if p.mono_bootstrap:
        # A pending slot has no position to project: its search starts at
        # its last tracked pixel (the pyramid absorbs the displacement).
        uv_pred = torch.where(state.lm_pending[..., None], state.lm_px, uv_pred)
        in_front = in_front | state.lm_pending

    cur_pyr1 = downsample2(left)
    cur_pyr2 = downsample2(cur_pyr1)
    tracks = klt.track_points_rig(
        (state.prev_left0, state.prev_left1, state.prev_left2),
        (left, cur_pyr1, cur_pyr2),
        state.lm_px, uv_pred,
        state.lm_valid & in_front,
        num_levels=p.klt_levels, radius=p.klt_radius, iters=p.klt_iters,
        max_residual=p.klt_max_residual, gather=gather,
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
    images = images.contiguous()
    c, _, h, w = images.shape
    left, right = images[:, 0], images[:, 1]
    smooth = gaussian_blur(images, 2.0, radius=4)  # both eyes in one pass

    # One detection over the 2C images of the stereo pair (image 2c + eye):
    # one FAST launch and one selection, all per image.
    kp = fast.detect_keypoints_batched(
        images.reshape(2 * c, h, w),
        threshold=p.fast_threshold,
        max_keypoints=p.max_keypoints,
        cell_size=p.cell_size,
        per_cell=p.per_cell,
        border_margin=p.border_margin,
    )
    n = kp.xy.shape[1]
    xy = kp.xy.reshape(c, 2, n, 2).transpose(0, 1).contiguous()  # (2, C, N, 2): eye-major
    valid = kp.valid.reshape(c, 2, n).transpose(0, 1).contiguous()
    score = kp.score.reshape(c, 2, n)
    kp_l, kp_r = (fast.Keypoints(xy[eye], score[:, eye], valid[eye]) for eye in (0, 1))
    # Both eyes' patches in one gather launch, each from its eye of `smooth`.
    desc = brief.compute_descriptors_pair(
        smooth[:, 0], smooth[:, 1], xy, valid, oriented=p.oriented_descriptors
    )
    desc_l = brief.Descriptors(desc.bits[0], desc.valid[0])
    desc_r = brief.Descriptors(desc.bits[1], desc.valid[1])

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
    # A mono source's right image is a zero fill and its stereo calibration
    # a placeholder: nothing it triangulates is real.
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


def _promote_pending(
    params: TrackerParams,
    setup: CameraSetup,
    world_t_cam: torch.Tensor,
    prev_kf_pose: torch.Tensor,
    cand_tracks_xy: torch.Tensor,
    cand_anchor_px: torch.Tensor,
    cand_pending: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Motion triangulation of the pending candidates of an all-mono rig.

    Each candidate's two views are its anchor ray at the previous keyframe
    (pose ``prev_kf_pose``) and its tracked ray now (``world_t_cam``). It is
    promoted when the rays meet in front of both views with at least
    ``mono_min_parallax`` between them. Returns (promoted (C, M), world
    positions (C, M, 3)).
    """
    h0 = epipolar.homogeneous(calib.raw_pixels_to_normalized(cand_anchor_px, setup.k_left, setup.dist_left))
    h1 = epipolar.homogeneous(calib.raw_pixels_to_normalized(cand_tracks_xy, setup.k_left, setup.dist_left))
    world_t_cam_a = torch.einsum("ij,cjk->cik", prev_kf_pose, setup.body_t_cam)
    cam_a_t_b = se3_inverse(world_t_cam_a) @ world_t_cam
    tri_pts, tri_ok = triangulate.two_view_midpoint(h0, h1, cam_a_t_b)
    r0n = h0 / torch.linalg.norm(h0, dim=-1, keepdim=True)
    r1w = torch.einsum("cij,cnj->cni", cam_a_t_b[:, :3, :3], h1)
    r1n = r1w / torch.linalg.norm(r1w, dim=-1, keepdim=True)
    ang = torch.arccos(torch.clamp(torch.sum(r0n * r1n, -1), -1.0, 1.0))
    promoted = cand_pending & tri_ok & (ang >= params.mono_min_parallax)
    promoted_w = (
        torch.einsum("cij,cnj->cni", world_t_cam_a[:, :3, :3], tri_pts) + world_t_cam_a[:, None, :3, 3]
    )
    return promoted, promoted_w


def _seed_mono_cameras(
    params: TrackerParams,
    setup: CameraSetup,
    world_t_body: torch.Tensor,
    world_t_cam: torch.Tensor,
    kf: KeyframeProducts,
    lm_pos: torch.Tensor,
    lm_valid: torch.Tensor,
    lm_id: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cross-camera seeding of a mixed rig's mono cameras.

    A mono camera cannot triangulate, so its fresh detections adopt
    landmarks the stereo cameras hold after this keyframe's minting: every
    stereo-slot landmark is projected into every camera, and a detection
    takes the landmark matched by mutual-nearest descriptor distance (with
    ratio test) among those projecting within ``mono_seed_radius_px`` of
    it. Nearest projection alone is not enough: corners cluster, and a
    wrong neighbour inside the gate would pass the PnP inlier threshold
    too.

    Returns (seeded (C, N) match mask, source slot index (C, N) into the
    flattened (C*N) bank, observation weight (C, N)). The weight is
    ``mono_obs_weight`` (the prior: a seeded observation's landmark error
    is correlated with its source camera's own observations) times
    ``sigma0^2 / (sigma0^2 + sigma_proj^2)``, where ``sigma0`` is one pixel
    of detector noise and ``sigma_proj`` the source camera's triangulation
    depth error ``z^2 s_d / (f b)`` as seen from the mono camera: along
    the source ray, it shows laterally as ``sigma_z sin(theta) / rho`` for
    inter-ray angle ``theta`` and mono range ``rho``.
    """
    p = params
    c, n = lm_valid.shape
    src_valid = (lm_valid & setup.stereo_mask[:, None]).reshape(-1)
    src_pts = lm_pos.reshape(-1, 3)
    body_t_world = se3_inverse(world_t_body)
    cam_r_w = torch.einsum("cij,jk->cik", setup.cam_r_body, body_t_world[:3, :3])
    cam_t_w = torch.einsum("cij,j->ci", setup.cam_r_body, body_t_world[:3, 3]) + setup.cam_t_body
    p_cam = torch.einsum("cij,nj->cni", cam_r_w, src_pts) + cam_t_w[:, None, :]  # (C, C*N, 3)
    uv, in_front = calib.cam_points_to_raw_pixels(p_cam, setup.k_left, setup.dist_left)
    sd2 = torch.sum((kf.kp_xy[:, :, None, :] - uv[:, None, :, :]) ** 2, -1)  # (C, N, C*N)
    allowed = src_valid[None, None, :] & in_front[:, None, :] & (sd2 <= p.mono_seed_radius_px**2)
    seeds = match.match_descriptors(
        kf.desc_bits, kf.kp_valid, kf.desc_bits.reshape(-1, brief.NUM_WORDS), src_valid,
        max_distance=p.mono_seed_max_hamming, ratio=0.9, allowed=allowed,
    )

    src_cam = torch.arange(c, device=lm_pos.device).repeat_interleave(n)
    dvec = src_pts - world_t_cam[src_cam, :3, 3]
    z_src = torch.clamp(torch.linalg.norm(dvec, dim=-1), min=1e-3)
    ray_s = dvec / z_src[:, None]
    fb = (setup.k_rect[:, 0] * setup.baseline)[src_cam]
    sigma_z = z_src**2 * p.mono_seed_disp_sigma_px / torch.clamp(fb, min=1e-6)  # metres
    dm = src_pts[seeds.idx] - world_t_cam[:, None, :3, 3]
    rho = torch.clamp(torch.linalg.norm(dm, dim=-1), min=1e-3)
    sin_t = torch.linalg.norm(torch.linalg.cross(ray_s[seeds.idx], dm / rho[..., None]), dim=-1)
    sigma_proj = sigma_z[seeds.idx] * sin_t / rho  # radians, about normalized units
    sigma0 = 1.0 / setup.k_left[:, 0][:, None]
    weight = p.mono_obs_weight * sigma0**2 / (sigma0**2 + sigma_proj**2)
    return seeds.valid, seeds.idx, weight


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
    cand_weight: torch.Tensor | None = None,
    cand_pending: torch.Tensor | None = None,
    cand_anchor_px: torch.Tensor | None = None,
    prev_kf_pose: torch.Tensor | None = None,
) -> tuple:
    """Mint a landmark bank from keyframe products and the tracked candidates.

    New landmarks are the triangulated points lifted to world with the new
    pose, except where a fresh keypoint lands within ``persist_radius_px``
    of a trusted tracked candidate: it inherits that candidate's world
    position, id and weight (1 without ``cand_weight``), anchoring the
    world frame across keyframes.

    All-mono rigs (``mono_bootstrap``, with ``cand_pending``, the
    candidates' ``cand_anchor_px`` at the previous keyframe and that
    keyframe's ``prev_kf_pose``): pending candidates are first promoted by
    motion triangulation (:func:`_promote_pending`) and then inherit like
    any landmark; a fresh detection that inherits nothing enters as a
    pending 2D track. A candidate that stays pending is not trusted, so a
    detection landing on it starts a new track with a new anchor: the
    reference's rule, kept.

    Mixed rigs (``has_mono`` without ``mono_bootstrap``): mono cameras'
    detections are seeded from the stereo cameras' landmarks
    (:func:`_seed_mono_cameras`).

    Returns the 11-tuple (lm_pos, lm_desc, lm_valid, lm_px, lm_obs,
    lm_robs, lm_robs_valid, lm_id, lm_pending, lm_anchor_px, lm_weight).
    """
    p = params
    all_mono = p.mono_bootstrap and cand_pending is not None
    world_t_cam = torch.einsum("ij,cjk->cik", world_t_body, setup.body_t_cam)
    pts_w = (
        torch.einsum("cij,cnj->cni", world_t_cam[:, :3, :3], kf.pts_cam)
        + world_t_cam[:, None, :3, 3]
    )
    if all_mono:
        promoted, promoted_w = _promote_pending(
            p, setup, world_t_cam, prev_kf_pose, cand_tracks_xy, cand_anchor_px, cand_pending
        )
        cand_pos_w = torch.where(promoted[..., None], promoted_w, cand_pos_w)
        anchor_ok = anchor_ok | promoted
        cand_pending = cand_pending & ~promoted

    d2 = torch.sum((kf.kp_xy[:, :, None, :] - cand_tracks_xy[:, None, :, :]) ** 2, -1)
    d2 = torch.where(anchor_ok[:, None, :], d2, float("inf"))
    nearest = torch.argmin(d2, -1)
    near_d2 = torch.amin(d2, -1)
    inherits = near_d2 <= p.persist_radius_px**2
    lm_pos = torch.where(inherits[..., None], _take(cand_pos_w, nearest), pts_w)
    lm_valid = kf.tri_valid | (inherits & kf.kp_valid)
    lm_id = torch.where(inherits, _take(cand_id, nearest), fresh_ids)
    lm_weight = (
        torch.where(inherits, _take(cand_weight, nearest), 1.0)
        if cand_weight is not None
        else torch.ones_like(lm_valid, dtype=torch.float32)
    )
    lm_pending = torch.zeros_like(lm_valid)
    if all_mono:
        # An inheriting slot keeps its candidate's flag (cleared if it was
        # just promoted); a fresh detection waits for the next keyframe.
        fresh_pending = kf.kp_valid & ~inherits
        lm_pending = torch.where(inherits, _take(cand_pending, nearest), fresh_pending)
        lm_valid = lm_valid | fresh_pending

    if p.has_mono and not p.mono_bootstrap:
        seeded, src_idx, w_seed = _seed_mono_cameras(
            p, setup, world_t_body, world_t_cam, kf, lm_pos, lm_valid, lm_id
        )
        take = ~setup.stereo_mask[:, None] & seeded & ~inherits
        # The shared id joins both cameras' observations of the point in BA.
        lm_pos = torch.where(take[..., None], lm_pos.reshape(-1, 3)[src_idx], lm_pos)
        lm_id = torch.where(take, lm_id.reshape(-1)[src_idx], lm_id)
        lm_valid = lm_valid | take
        lm_weight = torch.where(take, w_seed, lm_weight)

    # BA observation: inherited landmarks keep their subpixel tracked
    # position; fresh ones the detection.
    lm_obs = torch.where(inherits[..., None], _take(cand_tracks_xy, nearest), kf.kp_xy)
    lm_robs = kf.right_obs_px + (lm_obs - kf.kp_xy)
    # The right observation is a measurement only for fresh triangulations.
    lm_robs_valid = kf.tri_valid & lm_valid & ~inherits
    if cam_active is not None:  # dead cameras mint no landmarks
        lm_valid = lm_valid & cam_active[:, None]
        lm_robs_valid = lm_robs_valid & cam_active[:, None]
        lm_pending = lm_pending & cam_active[:, None]
    return (
        lm_pos, kf.desc_bits, lm_valid, kf.kp_xy, lm_obs,
        lm_robs, lm_robs_valid, lm_id, lm_pending, lm_obs, lm_weight,
    )


class Decision(NamedTuple):
    """The tick's acceptance and keyframe decision (:func:`_decide`)."""

    tracked: torch.Tensor
    world_t_body: torch.Tensor
    untracked_streak: torch.Tensor
    refresh_t: torch.Tensor


def _decide(
    params: TrackerParams,
    state: TrackerState,
    hot: HotProducts,
    body_t_world: torch.Tensor,
    num_inliers: torch.Tensor,
    init_body_t_world: torch.Tensor,
    allow_refresh: bool,
) -> Decision:
    """Acceptance of the solve and the keyframe decision, on the device."""
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
    if p.mono_bootstrap:
        # Before the bootstrap every tick is untracked by construction, and
        # a restart would reset the pending anchors before parallax builds
        # up: re-mint only when the tracked anchor set itself has decayed.
        bootstrapped = torch.any(state.lm_valid & ~state.lm_pending)
        too_few = torch.sum(hot.tracks_valid & state.lm_valid) < p.mono_reboot_min_tracks
        restart = restart & (bootstrapped | too_few)
    refresh_t = (state.frame_idx == 0) | (tracked & want_kf) | restart
    if not allow_refresh:
        # Keyframes are scheduled onto full ticks by the host; the streak
        # keeps counting and trips at the next full tick.
        refresh_t = torch.zeros_like(refresh_t)
        restart = torch.zeros_like(restart)
    untracked_streak = torch.where(restart, 0, untracked_streak)
    return Decision(tracked, world_t_body, untracked_streak, refresh_t)


def _persist_bank(state: TrackerState, hot: HotProducts) -> tuple:
    """No keyframe: the landmarks persist, the KLT anchors advance."""
    return (
        state.lm_pos_w, state.lm_desc, hot.corr_valid, hot.tracks_xy,
        hot.tracks_xy, state.lm_robs_px, state.lm_robs_valid, state.lm_id,
        state.lm_pending, state.lm_anchor_px, state.lm_weight,
    )


def _keyframe_bank(
    params: TrackerParams,
    setup: CameraSetup,
    state: TrackerState,
    hot: HotProducts,
    images: torch.Tensor,
    world_t_body: torch.Tensor,
    inliers_cn: torch.Tensor,
    cam_active: torch.Tensor | None,
    fresh_id_base: torch.Tensor | None = None,
    keyframe_minter=None,
) -> tuple:
    """The keyframe branch (span ``tracker.keyframe``): the front end and a
    new bank, or ``keyframe_minter(world_t_body)``'s."""
    p = params
    c, n = p.num_cams, p.max_keypoints
    with profiling.span("tracker.keyframe"):
        if keyframe_minter is not None:
            return keyframe_minter(world_t_body)
        kf = run_keyframe_frontend(p, setup, images)
        base = state.lm_id_counter if fresh_id_base is None else fresh_id_base
        fresh_ids = base + torch.arange(c * n, dtype=torch.int32, device=state.lm_id.device).reshape(c, n)
        return mint_bank(
            p, setup, world_t_body, kf,
            anchor_ok=hot.corr_valid & inliers_cn,  # trusted tracks
            cand_tracks_xy=hot.tracks_xy,
            cand_pos_w=state.lm_pos_w,
            cand_id=state.lm_id,
            fresh_ids=fresh_ids,
            cam_active=cam_active,
            cand_weight=state.lm_weight,
            cand_pending=state.lm_pending if p.mono_bootstrap else None,
            cand_anchor_px=state.lm_anchor_px if p.mono_bootstrap else None,
            prev_kf_pose=state.kf_world_t_body,
        )


def _tail(
    params: TrackerParams,
    setup: CameraSetup,
    state: TrackerState,
    hot: HotProducts,
    decision: Decision,
    bank: tuple,
    num_inliers: torch.Tensor,
    rms_error: torch.Tensor,
    covariance: torch.Tensor,
    refresh: bool,
    id_advance: int | None = None,
) -> tuple[TrackerState, TrackOutput]:
    """The new state and the tick's outputs from the chosen bank."""
    p = params
    (
        lm_pos_w, lm_desc, lm_valid, lm_px, lm_obs_px,
        lm_robs_px, lm_robs_valid, lm_id, lm_pending, lm_anchor_px, lm_weight,
    ) = bank
    world_t_body = decision.world_t_body
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
        lm_id_counter=state.lm_id_counter + (p.num_cams * p.max_keypoints if id_advance is None else id_advance)
        if refresh
        else state.lm_id_counter,
        kf_world_t_body=world_t_body if refresh else state.kf_world_t_body,
        prev_left0=hot.left,
        prev_left1=hot.cur_pyr1,
        prev_left2=hot.cur_pyr2,
        frame_idx=state.frame_idx + 1,
        untracked_streak=decision.untracked_streak,
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
    cov_world = torch.where(decision.tracked, rot6 @ covariance @ rot6.T, big)
    # Pending slots are neither landmarks (the count) nor BA or loop
    # measurements (the valid mask) until promoted.
    lm_valid_out = lm_valid & ~lm_pending if p.mono_bootstrap else lm_valid
    output = TrackOutput(
        world_t_body=world_t_body,
        num_inliers=num_inliers,
        num_matches=torch.sum(hot.corr_valid),
        num_landmarks=torch.sum(lm_valid_out),
        rms_error=rms_error,
        refreshed=decision.refresh_t,
        covariance=cov_world,
        obs_norm=obs_norm_out,
        robs_norm=robs_norm_out,
        lm_id=lm_id,
        lm_valid=lm_valid_out,
        robs_valid=lm_robs_valid,
        refreshed_host=refresh,
    )
    return new_state, output


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
    allow_refresh: bool = True,
    fresh_id_base: torch.Tensor | None = None,
    id_advance: int | None = None,
    keyframe_minter=None,
    refresh: bool | None = None,
) -> tuple[TrackerState, TrackOutput]:
    """Back half of a tick for the sharded step: acceptance, keyframe
    policy, state update, from the same parts as :func:`track_step`'s.
    ``allow_refresh=False`` (a light tick) neither refreshes nor restarts
    and reads nothing back.

    The sharded step (:mod:`thor_slam_tpu_torch.parallel.mesh`) calls this
    once per shard, with the reference's three hooks: ``fresh_id_base``
    (default ``lm_id_counter``) is where this shard's fresh ids start and
    ``id_advance`` (default C * N) how far the replicated counter moves at
    a keyframe, so that ids stay unique across camera shards;
    ``keyframe_minter(world_t_body)`` replaces the whole keyframe branch
    (slot sharding mints this shard's slots of a full-image detection).
    ``refresh`` is the keyframe decision when the caller has read it
    already (every shard decides alike): it is not read back again.
    """
    decision = _decide(params, state, hot, body_t_world, num_inliers, init_body_t_world, allow_refresh)
    if refresh is None:
        refresh = _read_refresh(decision, allow_refresh)
    bank = (
        _keyframe_bank(params, setup, state, hot, images, decision.world_t_body, inliers_cn, cam_active,
                       fresh_id_base, keyframe_minter)
        if refresh
        else _persist_bank(state, hot)
    )
    return _tail(params, setup, state, hot, decision, bank, num_inliers, rms_error, covariance, refresh, id_advance)


def _read_refresh(decision: Decision, allow_refresh: bool) -> bool:
    """A full tick's one readback: it selects the branch. A light tick
    reads nothing."""
    if not allow_refresh:
        return False
    with profiling.span("tracker.refresh_readback", kind="wait"):
        return bool(decision.refresh_t)


def _back(
    params: TrackerParams,
    setup: CameraSetup,
    state: TrackerState,
    hot: HotProducts,
    result: pnp.PnPResult,
    init_body_t_world: torch.Tensor,
    allow_refresh: bool,
) -> tuple[Decision, TrackerState, TrackOutput]:
    """The back segment: the decision, and the new state and outputs of the
    persist branch (a keyframe tick drops them)."""
    decision = _decide(params, state, hot, result.body_t_world, result.num_inliers, init_body_t_world, allow_refresh)
    new_state, output = _tail(
        params, setup, state, hot, decision, _persist_bank(state, hot),
        result.num_inliers, result.rms_error, result.covariance, refresh=False,
    )
    return decision, new_state, output


def _complete(
    params: TrackerParams,
    setup: CameraSetup,
    state: TrackerState,
    front: FrontProducts,
    result: pnp.PnPResult,
    back: tuple[Decision, TrackerState, TrackOutput],
    cam_active: torch.Tensor | None,
    allow_refresh: bool,
) -> tuple[TrackerState, TrackOutput]:
    """After the back segment: the decision's readback (full ticks), and on
    a keyframe the keyframe branch and the tail on its bank."""
    decision, new_state, output = back
    if not _read_refresh(decision, allow_refresh):
        return new_state, output
    c, n = params.num_cams, params.max_keypoints
    bank = _keyframe_bank(
        params, setup, state, front.hot, front.images, decision.world_t_body, result.inliers.reshape(c, n), cam_active
    )
    return _tail(
        params, setup, state, front.hot, decision, bank,
        result.num_inliers, result.rms_error, result.covariance, refresh=True,
    )


def _placeholder_gather(prev, cur, cam, centers, size):
    """Zero windows and centres in the shapes of
    :func:`patches_cuda.extract_patches_pair`'s, launching nothing: a
    capture's warm-up run needs their shapes, not their values."""
    m = centers.shape[1]
    return (torch.zeros((2, m, size, size), dtype=torch.float32, device=cur.device),
            torch.zeros((2, m, 2), dtype=torch.int32, device=cur.device))


class GraphedTrackStep(cuda_graph.GraphCache):
    """:func:`track_step` replayed from CUDA graphs
    (:mod:`thor_slam_tpu_torch.utils.cuda_graph`), one set per key.

    Called as :func:`track_step` is, and with its results: the caller gets
    its own tensors or clones, never a graph's buffer. Per tick: the front
    segment (:func:`_front`, three graphs with KLT's two patch gathers
    launched between them), the PnP solve as :func:`track_step` calls it
    (:data:`pnp.ransac_pnp_graphed`), the back segment (:func:`_back`, one
    graph, reading the solve's result from its own static buffers), then,
    on a full tick, the one readback of the keyframe decision; a keyframe
    tick runs the keyframe branch and the tail eagerly, as
    :func:`track_step` does, and drops the back segment's persist products.

    The key is the device, ``params``, the images' shape and dtype,
    ``half_res``, ``allow_refresh`` and the prediction's shape and dtype
    (or none). ``cam_active`` is not: a tick without one runs with every
    camera live, the same numbers. ``cam_active`` and ``pose_prediction``
    may be host tensors (pinned: copied without a wait). The spans
    ``tracker.front`` and ``tracker.back`` get ``graph``: ``"capture"``,
    ``"replay"`` or ``"eager"``.
    """

    def __call__(
        self,
        params: TrackerParams,
        setup: CameraSetup,
        state: TrackerState,
        images: torch.Tensor,
        uniforms: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        cam_active: torch.Tensor | None = None,
        pose_prediction: torch.Tensor | None = None,
        allow_refresh: bool = True,
        half_res: bool = False,
    ) -> tuple[TrackerState, TrackOutput]:
        return self._tick(params, setup, state, images, uniforms, generator, cam_active, pose_prediction,
                          allow_refresh, half_res, live=True)

    def capture(self, params, setup, state, images, generator=None, pose_prediction=None, allow_refresh=True,
                half_res=False) -> None:
        """Capture the graphs of the key these arguments (as
        :meth:`__call__` takes them) select, if not yet captured, by one dry
        tick: the graphs replay once, but no hand-written kernel launches,
        nothing is read back and the keyframe branch does not run. CPU
        images have no graphs."""
        self._tick(params, setup, state, images, None, generator, None, pose_prediction, allow_refresh,
                   half_res, live=False)

    def _tick(self, params, setup, state, images, uniforms, generator, cam_active, pose_prediction,
              allow_refresh, half_res, live):
        inputs = dict(setup=setup, state=state, images=images, cam_active=True if cam_active is None else cam_active,
                      pose_prediction=pose_prediction)

        def eager():
            if not live:
                return None
            return track_step(params, setup, state, images, uniforms=uniforms, generator=generator,
                              cam_active=cam_active, pose_prediction=pose_prediction,
                              allow_refresh=allow_refresh, half_res=half_res)

        def make() -> cuda_graph.Captured:
            cams = torch.empty(params.num_cams, dtype=torch.bool)
            return cuda_graph.Captured(images.device, inputs | {"cam_active": cams}, chains=2,
                                       placeholder=_placeholder_gather)

        def replay(entry: cuda_graph.Captured):
            front_chain, back_chain = entry.chains
            launch = patches_cuda.extract_patches_pair if live else None
            with profiling.span("tracker.front"):
                s = entry.load("inputs", inputs)
                profiling.annotate(graph=entry.run(front_chain, lambda gather: _front(
                    params, s["setup"], s["state"], s["images"], s["cam_active"], s["pose_prediction"], half_res,
                    gather=gather,
                ), launch))
            front = front_chain.outputs
            result = _solve(params, state, front, uniforms, generator)
            with profiling.span("tracker.back"):
                r = entry.load("result", result)
                profiling.annotate(graph=entry.run(back_chain, lambda _: _back(
                    params, s["setup"], s["state"], front.hot, r, front.init_body_t_world, allow_refresh,
                ), launch))
            if not live:  # owns nothing, and keeps no reference to this call's inputs
                return entry.own(None)
            done = _complete(params, setup, state, front, result, back_chain.outputs, s["cam_active"],
                             allow_refresh)
            return entry.own(done)

        pred_key = None if pose_prediction is None else (tuple(pose_prediction.shape), pose_prediction.dtype)
        key = (images.device, params, tuple(images.shape), images.dtype, half_res, allow_refresh, pred_key)
        return self.dispatch(key, images.device, eager, make, replay)


#: The tracker's tick on the card (the engine's single-device path and the
#: benchmark loops); the sharded step, the parity tests and the per-stage
#: tools call :func:`track_step` itself.
track_step_graphed = GraphedTrackStep()


#: Length of the packed result of :func:`mono_init`.
MONO_INIT_PACKED_LEN = 4


def mono_init(
    params: TrackerParams,
    setup: CameraSetup,
    state: TrackerState,
    uniforms: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> tuple[TrackerState, torch.Tensor]:
    """One bootstrap attempt of an all-mono rig: ``state -> (state, (4,) f32)``.

    The reference's ``make_mono_init``. Camera 0's pending anchors (its
    observations at the last keyframe, pose ``kf_world_t_body``) and their
    current KLT tracks are the two views;
    :func:`epipolar.ransac_essential` recovers the relative pose (unit
    translation: monocular scale is unobservable) and the triangulated
    inliers become the first landmarks. The attempt gates itself: below
    ``mono_trigger_parallax`` mean displacement, or with fewer than
    ``mono_init_min_inliers`` epipolar inliers (or half as many
    triangulated points), the state passes through unchanged.

    Args:
        uniforms: Optional (64, N) hypothesis draws in [0, 1).
        generator: Source of the draws when ``uniforms`` is None.

    Returns:
        (state, packed): packed is [success, num_inliers, mean parallax,
        num_triangulated].
    """
    p = params
    anchor_norm = calib.raw_pixels_to_normalized(state.lm_anchor_px[:1], setup.k_left[:1], setup.dist_left[:1])[0]
    cur_norm = calib.raw_pixels_to_normalized(state.lm_obs_px[:1], setup.k_left[:1], setup.dist_left[:1])[0]
    valid = state.lm_valid[0] & state.lm_pending[0]
    moved = torch.where(valid, torch.linalg.norm(cur_norm - anchor_norm, dim=-1), 0.0)
    disp = torch.sum(moved) / torch.clamp(torch.sum(valid), min=1)

    res = epipolar.ransac_essential(
        anchor_norm, cur_norm, valid, min_parallax=p.mono_min_parallax, uniforms=uniforms, generator=generator
    )
    num_tri = torch.sum(res.tri_valid)
    success = (
        (disp >= p.mono_trigger_parallax)
        & (res.num_inliers >= p.mono_init_min_inliers)
        & (num_tri >= p.mono_init_min_inliers // 2)
    )

    # Frames: A is camera 0 at the anchor keyframe, B is camera 0 now.
    world_t_cam_a = state.kf_world_t_body @ setup.body_t_cam[0]
    world_t_cam_b = world_t_cam_a @ epipolar._a_t_b(res.r_ba, res.t_ba)
    new_pose = world_t_cam_b @ se3_inverse(setup.body_t_cam[0])
    pts_w = res.points_a @ world_t_cam_a[:3, :3].T + world_t_cam_a[:3, 3]

    promote = success & res.tri_valid & valid
    lm_pos_w = state.lm_pos_w.clone()
    lm_pos_w[0] = torch.where(promote[:, None], pts_w, state.lm_pos_w[0])
    lm_pending = state.lm_pending.clone()
    lm_pending[0] = state.lm_pending[0] & ~promote
    new_state = state._replace(
        world_t_body=torch.where(success, new_pose, state.world_t_body),
        prev_world_t_body=torch.where(success, state.world_t_body, state.prev_world_t_body),
        lm_pos_w=lm_pos_w,
        lm_pending=lm_pending,
        untracked_streak=torch.where(success, 0, state.untracked_streak).to(state.untracked_streak.dtype),
    )
    packed = torch.stack([success.float(), res.num_inliers.float(), disp.float(), num_tri.float()])
    return new_state, packed


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
