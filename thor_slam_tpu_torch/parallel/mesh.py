"""Tracking over a mesh of devices: camera-sharded or slot-sharded.

Port of :mod:`thor_slam_tpu.parallel.mesh`, with its names. The rig's
parallel axis is the camera: the image front end is independent per
camera, and the 6-DoF pose solve couples the cameras only through 6x6
normal equations.

* A :class:`Mesh` is an ordered list of devices with the axis ``"d"``. A
  device may repeat: shards on one device are run one after the other,
  which is how a one-card machine drives the sharded path at its shapes.
* ``"cam"`` mode shards every per-camera tensor (images, landmark banks,
  pyramids) on the camera axis; ``"slot"`` mode (more devices than
  cameras: one stereo camera, the EuRoC layout) replicates the images and
  pyramids and shards the landmark slots (dim 1) of the banks. Poses and
  scalars are replicated.
* The pose solve is the reference's distributed RANSAC: each shard solves
  its hypotheses from its own correspondences, the hypothesis poses are
  all-gathered and scored with one sum of the per-shard inlier counts, and
  the best one seeds a Huber-IRLS polish that sums each shard's (J^T W J,
  J^T W r) every iteration. Every shard then computes the same update.
* Keyframe decisions use the summed inlier count, so every shard refreshes
  on the same tick; the host reads that decision from shard 0 once.

One process drives every shard (the reference is single-controller too:
one program holds the mesh). The collectives (:func:`psum`,
:func:`pmax`, :func:`all_gather`) take one tensor per shard, reduce on the
first shard's device in shard order and copy the result to every shard;
nothing is read back to the host. A :class:`ShardedTrackerState` reads
like a ``TrackerState`` (a sharded field is gathered when read), which is
what the engine's host backends rely on.

The reference's sharded step applies neither ``median_prefilter`` nor the
mono paths (the engine refuses mono sources on more than one device); this
one neither.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from thor_slam_tpu_torch.engine import pnp
from thor_slam_tpu_torch.engine import tracker as trk
from thor_slam_tpu_torch.ops import lie, linalg

#: Mesh axis name (the reference's).
AXIS = "d"


class Mesh:
    """A 1-D mesh: an ordered list of devices (repeats allowed)."""

    axis_names = (AXIS,)

    def __init__(self, devices: Sequence[torch.device | str]) -> None:
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={AXIS!r})"


def make_camera_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over ``n_devices`` with the tracking axis.

    ``devices`` None takes ``cuda:0`` .. ``cuda:n-1`` (all visible CUDA
    devices when ``n_devices`` is None); a sequence is taken as given,
    repeats included; one device (``"cpu"``, ``"cuda:0"``) gives
    ``n_devices`` virtual shards on it.
    """
    if devices is None:
        visible = torch.cuda.device_count()
        n = visible if n_devices is None else n_devices
        if n > visible:
            raise RuntimeError(f"devices={n} requested but only {visible} CUDA devices are visible")
        return Mesh([torch.device("cuda", i) for i in range(n)])
    if isinstance(devices, (str, torch.device)):
        return Mesh([torch.device(devices)] * (n_devices or 1))
    devices = list(devices)
    return Mesh(devices[: n_devices or len(devices)])


#: TrackerState fields sharded on the camera axis in "cam" mode; the same
#: fields shard on their SLOT axis (dim 1) in "slot" mode, except the
#: pyramids, which stay replicated there (KLT needs full images).
_CAM_SHARDED_FIELDS = frozenset(
    {
        "lm_pos_w", "lm_desc", "lm_valid", "lm_px", "lm_obs_px", "lm_robs_px",
        "lm_robs_valid", "lm_id", "lm_pending", "lm_anchor_px", "lm_weight",
        "prev_left0", "prev_left1", "prev_left2",
    }
)
_SLOT_SHARDED_FIELDS = _CAM_SHARDED_FIELDS - {"prev_left0", "prev_left1", "prev_left2"}
#: TrackOutput fields that stay with their slots' shard.
_OUT_SHARDED_FIELDS = frozenset({"obs_norm", "robs_norm", "lm_id", "lm_valid", "robs_valid"})


def choose_axis(num_cams: int, max_keypoints: int, n_devices: int) -> str:
    """Pick the sharding axis for a rig: cameras when they divide evenly,
    landmark slots otherwise."""
    if n_devices <= 1:
        raise ValueError("SPMD needs n_devices > 1")
    if num_cams % n_devices == 0:
        return "cam"
    if max_keypoints % n_devices == 0:
        return "slot"
    raise ValueError(
        f"neither num_cams={num_cams} nor max_keypoints={max_keypoints} "
        f"divisible by {n_devices} devices"
    )


def _split(x: torch.Tensor, dim: int, mesh: Mesh) -> list[torch.Tensor]:
    """``x`` cut into equal shards along ``dim``, one copy on each device."""
    parts = torch.chunk(x, mesh.size, dim)
    return [part.to(dev, copy=True).contiguous() for part, dev in zip(parts, mesh.devices)]


def _replicate(x, mesh: Mesh) -> list:
    """One copy of ``x`` on each device (a non-tensor field as it is)."""
    if not isinstance(x, torch.Tensor):
        return [x] * mesh.size
    return [x.to(dev, copy=True) for dev in mesh.devices]


class _ShardedTuple:
    """Per-shard NamedTuples that read like one.

    A sharded field is concatenated along its dim onto the mesh's first
    device when read; a replicated field is shard 0's. ``_replace`` takes
    full-size values and re-shards them.
    """

    _cls: type
    _sharded_fields: dict[str, frozenset]

    def __init__(self, shards: Sequence, mesh: Mesh, axis_mode: str) -> None:
        self.shards = list(shards)
        self.mesh = mesh
        self.axis_mode = axis_mode

    def _dim(self, name: str) -> int | None:
        if name not in self._sharded_fields[self.axis_mode]:
            return None
        return 0 if self.axis_mode == "cam" else 1

    def __getattr__(self, name: str):
        if name.startswith("_") or name not in self._cls._fields:
            raise AttributeError(name)
        dim = self._dim(name)
        if dim is None:
            return getattr(self.shards[0], name)
        dev = self.mesh.devices[0]
        return torch.cat([getattr(s, name).to(dev) for s in self.shards], dim)

    def gather(self):
        """The full-size tuple on the mesh's first device."""
        return self._cls(**{f: getattr(self, f) for f in self._cls._fields})

    @classmethod
    def _place(cls, fields: dict, mesh: Mesh, axis_mode: str) -> list[dict]:
        """Full-size ``fields`` -> a dict of each shard's values, one a shard."""
        dim = 0 if axis_mode == "cam" else 1
        sharded = cls._sharded_fields[axis_mode]
        per_field = {f: _split(v, dim, mesh) if f in sharded else _replicate(v, mesh) for f, v in fields.items()}
        return [{f: vals[k] for f, vals in per_field.items()} for k in range(mesh.size)]

    @classmethod
    def shard(cls, full, mesh: Mesh, axis_mode: str):
        """Place a full-size tuple on the mesh per the axis mode."""
        return cls([cls._cls(**d) for d in cls._place(full._asdict(), mesh, axis_mode)], mesh, axis_mode)

    def _replace(self, **fields):
        """A new sharded tuple with full-size ``fields`` re-sharded."""
        placed = self._place(fields, self.mesh, self.axis_mode)
        return type(self)([s._replace(**d) for s, d in zip(self.shards, placed)], self.mesh, self.axis_mode)

    def per_shard(self, fn: Callable):
        """A new sharded tuple with ``fn`` applied to each shard's tuple."""
        return type(self)([fn(s) for s in self.shards], self.mesh, self.axis_mode)


class ShardedTrackerState(_ShardedTuple):
    """A ``TrackerState`` held as one shard per mesh entry."""

    _cls = trk.TrackerState
    _sharded_fields = {"cam": _CAM_SHARDED_FIELDS, "slot": _SLOT_SHARDED_FIELDS}


class ShardedTrackOutput(_ShardedTuple):
    """A ``TrackOutput`` whose per-slot fields stay with their shard."""

    _cls = trk.TrackOutput
    _sharded_fields = {"cam": _OUT_SHARDED_FIELDS, "slot": _OUT_SHARDED_FIELDS}


def shard_state(state: trk.TrackerState, mesh: Mesh, axis_mode: str = "cam") -> ShardedTrackerState:
    """Place a tracker state on the mesh per the axis mode."""
    return ShardedTrackerState.shard(state, mesh, axis_mode)


def gather_state(state: ShardedTrackerState) -> trk.TrackerState:
    """The full state on the mesh's first device."""
    return state.gather()


def shard_generators(mesh: Mesh, seed: int) -> list[torch.Generator]:
    """One RANSAC generator per shard, on its device, seeded from ``seed``
    and the shard index (the reference folds the axis index into its key)."""
    return [
        torch.Generator(device=dev).manual_seed(int(np.random.SeedSequence([seed, k]).generate_state(1, np.uint64)[0]))
        for k, dev in enumerate(mesh.devices)
    ]


# ------------------------------------------------------------ collectives


def psum(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of one tensor per shard, in shard order on the first shard's
    device, copied to every shard's device."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(total.device)
    return [total.to(x.device) for x in xs]


def pmax(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """As :func:`psum`, the elementwise maximum."""
    top = xs[0]
    for x in xs[1:]:
        top = torch.maximum(top, x.to(top.device))
    return [top.to(x.device) for x in xs]


def all_gather(xs: Sequence[torch.Tensor], axis: int = 0, tiled: bool = False) -> list[torch.Tensor]:
    """Every shard's tensor, stacked on a new ``axis`` (concatenated along
    it when ``tiled``), on the first shard's device, copied to every
    shard's device."""
    dev = xs[0].device
    parts = [x.to(dev) for x in xs]
    full = torch.cat(parts, axis) if tiled else torch.stack(parts, axis)
    return [full.to(x.device) for x in xs]


# ------------------------------------------------------------ pose solve


class _Solve(NamedTuple):
    """Per-shard lists of the distributed solve's results (each replicated
    value holds the same numbers on every shard)."""

    body_t_world: list
    inliers: list
    num_inliers: list
    rms_error: list
    covariance: list


def _distributed_robust_pnp(
    points_w, obs, valid, cam_rot, cam_trans, init_body_t_world, inlier_threshold,
    iters: int = 10, huber_delta: float = 0.01, damping: float = 1e-6, weights=None,
) -> _Solve:
    """Huber-IRLS Gauss-Newton with the normal equations summed over shards.

    Every argument is a list with one tensor per shard: the shard's
    correspondences, and the replicated pose and threshold. ``weights``
    (default ``valid``) selects which correspondences drive the solve; the
    final inlier census gates on ``valid``.
    """
    n_sh = len(points_w)
    if weights is None:
        weights = [v.float() for v in valid]
    x = list(init_body_t_world)
    for _ in range(iters):
        h_loc, g_loc = [], []
        for k in range(n_sh):
            r, j, behind = pnp._residuals_and_jacobian(x[k], points_w[k], obs[k], cam_rot[k], cam_trans[k])
            r_norm = torch.linalg.norm(r, dim=-1)
            w = weights[k] * pnp._huber_weights(r_norm, huber_delta) * (1.0 - behind.float())
            jw = j * w[:, None, None]
            h_loc.append(torch.einsum("nai,naj->ij", jw, j))
            g_loc.append(torch.einsum("nai,na->i", jw, r))
        h_sum, g_sum = psum(h_loc), psum(g_loc)
        for k in range(n_sh):
            h = h_sum[k] + damping * torch.eye(6, dtype=h_sum[k].dtype, device=h_sum[k].device)
            delta = -linalg.spd_solve(h, g_sum[k])
            delta = torch.where(torch.isfinite(delta).all(), delta, 0.0)
            x[k] = lie.se3_exp(delta) @ x[k]

    parts = [pnp._residuals_and_jacobian(x[k], points_w[k], obs[k], cam_rot[k], cam_trans[k]) for k in range(n_sh)]
    r_norm = [torch.linalg.norm(r, dim=-1) + behind * 1e3 for r, _, behind in parts]
    inliers = [(r_norm[k] <= inlier_threshold[k]) & valid[k] for k in range(n_sh)]
    num_inliers = psum([torch.sum(m) for m in inliers])
    sq = psum([torch.sum(torch.where(m, rn**2, 0.0)) for m, rn in zip(inliers, r_norm)])
    rms = [torch.sqrt(s / torch.clamp(num, min=1)) for s, num in zip(sq, num_inliers)]
    # Pose covariance sigma^2 (sum J^T W J)^-1 over the GLOBAL inlier set.
    wi = [m.float() * (1.0 - behind.float()) for m, (_, _, behind) in zip(inliers, parts)]
    h_cov = psum([torch.einsum("nai,naj->ij", j * w[:, None, None], j) for w, (_, j, _) in zip(wi, parts)])
    wr2 = psum([torch.sum(w[:, None] * r**2) for w, (r, _, _) in zip(wi, parts)])
    cov = []
    for k in range(n_sh):
        eye = torch.eye(6, dtype=h_cov[k].dtype, device=h_cov[k].device)
        dof = torch.clamp(2.0 * num_inliers[k].float() - 6.0, min=1.0)
        c = (wr2[k] / dof) * linalg.spd_inverse(h_cov[k] + damping * eye)
        c = 0.5 * (c + c.T)
        cov.append(torch.where(torch.isfinite(c).all(), c, eye * 1e6))
    return _Solve(x, inliers, num_inliers, rms, cov)


def _distributed_ransac_pnp(
    points_w, obs, valid, cam_rot, cam_trans, init_body_t_world, inlier_threshold,
    hyp_per_device: int = 4, sample_size: int = 6, hyp_iters: int = 5, refine_iters: int = 6,
    uniforms=None, generators=None,
) -> _Solve:
    """Cross-shard RANSAC PnP (the reference's SPMD twin of ``ransac_pnp``).

    Each shard draws ``hyp_per_device`` minimal subsets from its own
    correspondences and solves them (a subset from one camera constrains
    the whole body pose). The hypothesis poses are all-gathered, scored
    against every shard's correspondences with one sum of the inlier
    counts, and the winner seeds the summed Huber-IRLS polish weighted by
    its inliers. Unlike ``ransac_pnp`` there is no fallback to the
    hypothesis when the polish loses inliers.

    Args:
        uniforms: Optional per-shard (hyp_per_device, n_local) draws in
            [0, 1) (tests inject the reference's).
        generators: Per-shard ``torch.Generator`` on each shard's device,
            the source of the draws when ``uniforms`` is None.
    """
    n_sh = len(points_w)
    hyp_local = []
    for k in range(n_sh):
        u = uniforms[k] if uniforms is not None else None
        if u is None:
            u = torch.rand(
                (hyp_per_device, points_w[k].shape[0]), generator=generators[k],
                device=points_w[k].device, dtype=points_w[k].dtype,
            )
        idx = pnp.sample_subsets(u.to(points_w[k].device), valid[k], sample_size)  # (Hl, S)
        x, _ = pnp.gauss_newton_pnp(
            points_w[k][idx], obs[k][idx], valid[k][idx].float(), cam_rot[k][idx], cam_trans[k][idx],
            init_body_t_world[k], iters=hyp_iters,
        )
        hyp_local.append(x)
    hyps = [h.reshape(-1, 4, 4) for h in all_gather(hyp_local)]  # (n_sh * Hl, 4, 4) on every shard

    def inlier_masks(k, poses):
        _, _, uv = pnp.project_points(poses, points_w[k], cam_rot[k], cam_trans[k])
        return (torch.linalg.norm(uv - obs[k], dim=-1) <= inlier_threshold[k]) & valid[k]

    counts = psum([inlier_masks(k, hyps[k]).sum(-1) for k in range(n_sh)])
    best = [hyps[k][torch.argmax(counts[k])] for k in range(n_sh)]
    best_inl = [inlier_masks(k, best[k]).float() for k in range(n_sh)]
    return _distributed_robust_pnp(
        points_w, obs, valid, cam_rot, cam_trans, best, inlier_threshold, iters=refine_iters, weights=best_inl,
    )


# ------------------------------------------------------------ the step


def make_sharded_track_step(
    params: trk.TrackerParams,
    setup: trk.CameraSetup,
    mesh: Mesh,
    axis_mode: str | None = None,
    pack: bool | str = False,
):
    """Build the sharded tick on ``mesh``, mirroring ``track_step``.

    Returns ``step(state, images, uniforms=None, generators=None,
    cam_active=None, pose_prediction=None) -> (state, out[, packed[,
    ba_obs][, kf_sig]])`` over a :class:`ShardedTrackerState`; ``out`` is a
    :class:`ShardedTrackOutput`. ``images`` is the full (C, 2, H, W) tick
    on any device: cam mode copies each shard its cameras, slot mode every
    shard the whole tick. ``uniforms`` is a list of per-shard (Hl, n_local)
    draws, ``generators`` one ``torch.Generator`` per shard
    (:func:`shard_generators`); ``cam_active`` (C,) and ``pose_prediction``
    (4, 4) are full-size.

    Args:
        axis_mode: "cam" (``num_cams`` divisible by the mesh size), "slot"
            (``max_keypoints`` divisible) or None (:func:`choose_axis`).
        pack: ``True`` appends ``pack_output``; ``"ba"`` also
            ``pack_ba_obs``, ``"kf"`` ``pack_kf_sig`` instead, ``"ba+kf"``
            both (gathered onto the mesh's first device).
    """
    n_dev = mesh.size
    if axis_mode is None:
        axis_mode = choose_axis(params.num_cams, params.max_keypoints, n_dev)
    c_full, n_full = params.num_cams, params.max_keypoints
    fields = dict(params.__dict__)
    if axis_mode == "cam":
        if c_full % n_dev:
            raise ValueError(f"num_cams={c_full} not divisible by mesh size {n_dev}")
        local_params = trk.TrackerParams(**{**fields, "num_cams": c_full // n_dev})
        setups = [trk.CameraSetup(*parts) for parts in zip(*(_split(v, 0, mesh) for v in setup))]
    elif axis_mode == "slot":
        if n_full % n_dev:
            raise ValueError(f"max_keypoints={n_full} not divisible by mesh size {n_dev}")
        local_params = trk.TrackerParams(**{**fields, "max_keypoints": n_full // n_dev})
        setups = [trk.CameraSetup(*parts) for parts in zip(*(_replicate(v, mesh) for v in setup))]
    else:
        raise ValueError(f"unknown axis_mode {axis_mode!r}")
    c, n = local_params.num_cams, local_params.max_keypoints
    hyp_per_device = max(1, params.ransac_hypotheses // n_dev)

    def local(x: torch.Tensor, k: int) -> torch.Tensor:
        """Shard ``k``'s part of a per-camera input (all of it in slot mode)."""
        if axis_mode == "cam":
            x = x[k * c : (k + 1) * c]
        return x.to(mesh.devices[k])

    def step(state: ShardedTrackerState, images, uniforms=None, generators=None, cam_active=None,
             pose_prediction=None):
        shards = state.shards
        imgs, hots, inits, flat = [], [], [], []
        actives = [None if cam_active is None else local(cam_active, k) for k in range(n_dev)]
        for k, st in enumerate(shards):
            im = local(images, k)
            if im.dtype == torch.uint8:
                im = im.float() * (1.0 / 255.0)
            if pose_prediction is None:
                delta = st.world_t_body @ lie.se3_inverse(st.prev_world_t_body)
                extrapolated = delta @ st.world_t_body
                klt_prediction = torch.where(st.untracked_streak > 0, st.world_t_body, extrapolated)
                init = lie.se3_inverse(st.world_t_body)
            else:
                klt_prediction = pose_prediction.to(st.world_t_body)
                init = lie.se3_inverse(klt_prediction)
            hot = trk.run_hot_frontend(local_params, setups[k], st, im, lie.se3_inverse(klt_prediction))
            if actives[k] is not None:
                hot = hot._replace(
                    corr_valid=hot.corr_valid & actives[k][:, None],
                    tracks_valid=hot.tracks_valid & actives[k][:, None],
                )
            imgs.append(im)
            hots.append(hot)
            inits.append(init)
            flat.append((
                st.lm_pos_w.reshape(c * n, 3),
                hot.obs_norm.reshape(c * n, 2),
                hot.corr_valid.reshape(c * n),
                setups[k].cam_r_body.repeat_interleave(n, 0),
                setups[k].cam_t_body.repeat_interleave(n, 0),
            ))
        k_max = [torch.amax(s.k_left[:, 0]) for s in setups]
        if axis_mode == "cam":  # each shard holds its own cameras
            k_max = pmax(k_max)
        pts, obs, valid, rot, trans = (list(v) for v in zip(*flat))
        solve = _distributed_ransac_pnp(
            pts, obs, valid, rot, trans, inits, [params.inlier_threshold_px / km for km in k_max],
            hyp_per_device=hyp_per_device, sample_size=params.ransac_sample_size,
            uniforms=uniforms, generators=generators,
        )

        gathered: dict[str, list] = {}

        def candidates() -> dict[str, list]:
            """Slot mode's inheritance candidates over every shard's slots,
            gathered once, at the first keyframe mint of the tick."""
            if not gathered:
                gathered["tracks"] = all_gather([h.tracks_xy for h in hots], axis=1, tiled=True)
                gathered["pos"] = all_gather([s.lm_pos_w for s in shards], axis=1, tiled=True)
                gathered["id"] = all_gather([s.lm_id for s in shards], axis=1, tiled=True)
                gathered["anchor"] = all_gather(
                    [h.corr_valid & m.reshape(c, n) for h, m in zip(hots, solve.inliers)], axis=1, tiled=True
                )
            return gathered

        def slot_minter(k: int):
            st, lo = shards[k], k * n

            def mint(world_t_body):
                # Full-image detection on every shard (the same on each);
                # this shard mints its slot slice of it.
                kf_full = trk.run_keyframe_frontend(params, setups[k], imgs[k])
                kf = trk.KeyframeProducts(*(v.narrow(1, lo, n) for v in kf_full))
                fresh_ids = (
                    st.lm_id_counter
                    + torch.arange(c, dtype=torch.int32, device=st.lm_id.device)[:, None] * n_full
                    + lo
                    + torch.arange(n, dtype=torch.int32, device=st.lm_id.device)[None, :]
                )
                g = candidates()
                return trk.mint_bank(
                    local_params, setups[k], world_t_body, kf,
                    anchor_ok=g["anchor"][k], cand_tracks_xy=g["tracks"][k], cand_pos_w=g["pos"][k],
                    cand_id=g["id"][k], fresh_ids=fresh_ids, cam_active=actives[k],
                )

            return mint

        new_states, outs, refresh = [], [], None
        for k, st in enumerate(shards):
            if axis_mode == "cam":
                # lm_id is the BA and loop join key: each shard mints from
                # its own range and the counter advances by the global count.
                hooks = dict(fresh_id_base=st.lm_id_counter + k * c * n)
            else:
                hooks = dict(keyframe_minter=slot_minter(k))
            new_st, out = trk._finish_step(
                local_params, setups[k], st, hots[k], imgs[k],
                body_t_world=solve.body_t_world[k],
                num_inliers=solve.num_inliers[k],
                inliers_cn=solve.inliers[k].reshape(c, n),
                rms_error=solve.rms_error[k],
                init_body_t_world=inits[k],
                covariance=solve.covariance[k],
                cam_active=actives[k],
                id_advance=c_full * n_full,
                refresh=refresh,  # shard 0 reads the decision back, once
                **hooks,
            )
            refresh = out.refreshed_host
            new_states.append(new_st)
            outs.append(out)
        num_matches = psum([o.num_matches for o in outs])
        num_landmarks = psum([o.num_landmarks for o in outs])
        outs = [o._replace(num_matches=m, num_landmarks=l) for o, m, l in zip(outs, num_matches, num_landmarks)]
        new_state = ShardedTrackerState(new_states, mesh, axis_mode)
        out = ShardedTrackOutput(outs, mesh, axis_mode)
        if not pack:
            return new_state, out
        rets = [new_state, out, trk.pack_output(out)]
        if pack in ("ba", "ba+kf"):
            rets.append(trk.pack_ba_obs(out, new_state.lm_pos_w))
        if pack in ("kf", "ba+kf"):
            rets.append(trk.pack_kf_sig(new_state))
        return tuple(rets)

    step.axis_mode = axis_mode
    return step
