"""Track-level sliding-window bundle adjustment backend.

Port of :mod:`thor_slam_tpu.engine.backends.track_ba`. The measurements
are the tracker's own per-tick outputs (:func:`~thor_slam_tpu_torch.
engine.tracker.pack_ba_obs`): KLT positions joined across ticks by the
persistent landmark id, so keyframe-boundary slot changes never poison a
window. Only finalized-tick data is read; a correction lands on the live
tracker state as one left-multiplied pose delta plus a by-id landmark
update (:func:`apply_correction`). On a card the window reaches the
solve through pinned host buffers, the solve replays a captured CUDA graph
(:data:`~thor_slam_tpu_torch.engine.ba.bundle_adjust_graphed`) and its
result comes back in one copy behind one event.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from thor_slam_tpu_torch.engine import ba
from thor_slam_tpu_torch.engine import tracker as trk
from thor_slam_tpu_torch.parallel.mesh import ShardedTrackerState

_ID_PAD = np.iinfo(np.int32).max  # sorts after every real id
#: The window's fields that :meth:`TrackBA.build_problem` fills on the host.
_WINDOW = ("body_t_world", "landmarks_w", "obs", "obs_mask", "pose_mask", "lm_mask")


def apply_correction(
    state: trk.TrackerState,
    t_corr: torch.Tensor,
    upd_ids: torch.Tensor,
    upd_pos: torch.Tensor,
    upd_ok: torch.Tensor,
) -> trk.TrackerState:
    """Write a BA correction into the live tracker state.

    ``t_corr`` (4, 4) left-multiplies every pose of the state (and rotates
    its velocity); landmarks whose id appears in the sorted ``upd_ids``
    (L,) int32, padded with int32 max, with ``upd_ok`` set, take their
    ``upd_pos`` (L, 3) position. A sharded state is corrected shard by
    shard: the write is elementwise by id.
    """
    if isinstance(state, ShardedTrackerState):
        return state.per_shard(
            lambda s: apply_correction(s, *(v.to(s.lm_id.device) for v in (t_corr, upd_ids, upd_pos, upd_ok)))
        )
    l_cap = upd_ids.shape[0]
    idx = torch.clamp(torch.searchsorted(upd_ids, state.lm_id.contiguous()), 0, l_cap - 1)
    hit = (upd_ids[idx] == state.lm_id) & state.lm_valid & upd_ok[idx]
    return state._replace(
        world_t_body=t_corr @ state.world_t_body,
        prev_world_t_body=t_corr @ state.prev_world_t_body,
        kf_world_t_body=t_corr @ state.kf_world_t_body,
        velocity_w=t_corr[:3, :3] @ state.velocity_w,
        lm_pos_w=torch.where(hit[..., None], upd_pos[idx], state.lm_pos_w),
    )


class TrackBA:
    """Sliding-window BA over finalized tick observations.

    Args:
        window: Ticks per BA window (pose count K).
        landmarks: Landmark slots per window (L).
        tick_stride: Collect every Nth tick (keyframe ticks always).
        max_correction_m: Reject a pose correction larger than this (junk
            guard); also the per-landmark write-back bound.
        noise_gate_sigma: A correction below this multiple of the PnP
            solve's positional sigma is withheld.
    """

    def __init__(
        self,
        window: int = 10,
        landmarks: int = 384,
        tick_stride: int = 2,
        max_correction_m: float = 0.08,
        noise_gate_sigma: float = 3.0,
    ) -> None:
        self.window = window
        self.landmarks = landmarks
        self.tick_stride = max(1, tick_stride)
        self.max_correction_m = max_correction_m
        self.noise_gate_sigma = noise_gate_sigma
        self._ticks: deque[dict] = deque(maxlen=window)
        self._cam_rot: torch.Tensor | None = None
        self._cam_trans: torch.Tensor | None = None
        self._cam_weight: np.ndarray | None = None
        self._num_cams = 0
        self._device: torch.device | None = None
        #: Host buffers of the bound shape (pinned on a card) and their numpy views.
        self._host: dict[str, torch.Tensor] = {}
        self._np: dict[str, np.ndarray] = {}
        self._fetched: torch.cuda.Event | None = None
        #: What the last :meth:`run` learned: ``solved`` (the solver ran),
        #: ``rms`` (before, after) and ``correction_m`` (the last pose's move),
        #: None where it stopped before; the engine's ``backend.ba`` span
        #: carries them.
        self.last_solve: dict = {"solved": False, "rms": None, "correction_m": None}

    def bind(self, setup: trk.CameraSetup, num_cams: int, mono_obs_weight: float = 0.25) -> None:
        """Bind the per-camera constants (tensors on the engine's device).

        The BA camera axis is 2C: left imagers, then right imagers (the
        stereo constraint anchors scale inside the window).
        ``mono_obs_weight`` is the weight of a mono camera's observations
        in the window (``TrackerParams.mono_obs_weight``); a stereo
        camera's weigh 1.
        """
        self._num_cams = num_cams
        self._cam_weight = np.where(setup.stereo_mask.cpu().numpy(), 1.0, mono_obs_weight).astype(np.float32)
        self._device = setup.cam_r_body.device
        self._cam_rot = torch.cat([setup.cam_r_body, setup.cam_r_body_right]).float()
        self._cam_trans = torch.cat([setup.cam_t_body, setup.cam_t_body_right]).float()
        k, c2, l_cap = self.window, 2 * num_cams, self.landmarks
        shapes = dict(
            body_t_world=(k, 4, 4), landmarks_w=(l_cap, 3), obs=(k, c2, l_cap, 2), obs_mask=(k, c2, l_cap),
            pose_mask=(k,), lm_mask=(l_cap,), result=(16 * k + 3 * l_cap + 2,), t_corr=(4, 4),
        )
        pin = self._device.type == "cuda"
        self._host = {name: torch.empty(shape, pin_memory=pin) for name, shape in shapes.items()}
        self._host["upd_ids"] = torch.empty(l_cap, dtype=torch.int32, pin_memory=pin)
        self._host["upd_ok"] = torch.empty(l_cap, dtype=torch.bool, pin_memory=pin)
        self._np = {name: t.numpy() for name, t in self._host.items()}
        self._fetched = torch.cuda.Event() if pin else None

    def warm(self) -> None:
        """Solve one empty window of the bound shape as :meth:`run` solves
        it: on a card that captures the solve's graph (and initializes the
        dense solver) here, not in a window's tick."""
        h = self._np
        for name in _WINDOW:
            h[name].fill(0.0)
        h["body_t_world"][:] = np.eye(4, dtype=np.float32)
        self._solve(self._problem())

    def _problem(self) -> ba.BAProblem:
        """The window held in the host buffers, with the bound constants."""
        return ba.BAProblem(cam_rot=self._cam_rot, cam_trans=self._cam_trans, **{k: self._host[k] for k in _WINDOW})

    def _solve(self, problem: ba.BAProblem) -> tuple[ba.BAResult, torch.Tensor]:
        """The window's solve and its one readback: the result on the host
        (the ``result`` buffer's views on a card) and the refined landmarks
        on the solve's device."""
        packed = ba.bundle_adjust_graphed(problem, huber_delta=0.004)
        host = packed
        if self._fetched is not None:
            host = self._host["result"]
            host.copy_(packed, non_blocking=True)
            self._fetched.record(torch.cuda.current_stream(self._device))
            self._fetched.synchronize()
        k, l_cap = self.window, self.landmarks
        return ba.unpack(host, k, l_cap), ba.unpack(packed, k, l_cap).landmarks_w

    def clear(self) -> None:
        self._ticks.clear()

    def __len__(self) -> int:
        return len(self._ticks)

    def push_tick(self, ba_obs, world_t_body: np.ndarray, ts: float, refreshed: bool) -> None:
        """Append one finalized tick (its fetched ``pack_ba_obs`` array)."""
        if ba_obs is None:
            return
        rec = trk.unpack_ba_obs(ba_obs)
        rec["body_t_world"] = np.linalg.inv(np.asarray(world_t_body, np.float64))
        rec["ts"] = ts
        rec["refreshed"] = bool(refreshed)
        self._ticks.append(rec)

    def build_problem(self, diagnostics: dict):
        """Assemble the window's fixed-shape problem in the host buffers:
        the window's fields are host tensors (pinned on a card; the next
        call overwrites them), the camera constants the bound device's.

        Returns ``(problem, chosen ids, initial landmarks)`` or None (the
        reason lands in ``diagnostics["ba_skip"]``).
        """
        ticks = list(self._ticks)
        if len(ticks) < 4:
            diagnostics["ba_skip"] = f"window={len(ticks)}"
            return None
        k_win = self.window
        ticks = ticks[-k_win:]
        c = self._num_cams
        l_cap = self.landmarks

        # Only ids alive in the last tick's post-tick bank can receive a
        # correction, so only those are optimized.
        last = ticks[-1]
        bank_ids = last["ids"]
        bank_valid = last["valid"]
        bank_pos = np.asarray(last["pos"], np.float64)
        alive = set(bank_ids[bank_valid].tolist())

        counts: dict[int, int] = {}
        for t in ticks:
            for lid in np.unique(t["ids"][t["valid"]]):
                ilid = int(lid)
                if ilid >= 0 and ilid in alive:
                    counts[ilid] = counts.get(ilid, 0) + 1
        multi = [lid for lid, n in counts.items() if n >= 3]
        if len(multi) < 24:
            diagnostics["ba_skip"] = f"joined_landmarks={len(multi)}"
            return None
        multi.sort(key=lambda lid: -counts[lid])
        chosen = np.sort(np.asarray(multi[:l_cap], np.int64))  # sorted: searchsorted joins
        l_n = len(chosen)

        h = self._np
        obs, mask, poses, pose_mask, lms = (h[k] for k in ("obs", "obs_mask", "body_t_world", "pose_mask",
                                                           "landmarks_w"))
        for a in (obs, mask, pose_mask, lms):
            a.fill(0.0)
        poses[:] = np.eye(4, dtype=np.float32)
        for ki, t in enumerate(ticks):
            poses[ki] = t["body_t_world"]
            pose_mask[ki] = 1.0
            idx = np.clip(np.searchsorted(chosen, t["ids"]), 0, l_n - 1)
            hit = (chosen[idx] == t["ids"]) & t["valid"]  # (C, N)
            for ci in range(c):
                sel = hit[ci]
                li = idx[ci, sel]
                obs[ki, ci, li] = t["obs"][ci, sel]
                mask[ki, ci, li] = self._cam_weight[ci]
                if t["refreshed"]:  # the stereo measurement exists only at mint
                    rsel = sel & t["robs_valid"][ci]
                    rli = idx[ci, rsel]
                    obs[ki, c + ci, rli] = t["robs"][ci, rsel]
                    mask[ki, c + ci, rli] = 1.0

        # Landmarks start from the last tick's bank.
        bidx = np.clip(np.searchsorted(chosen, bank_ids), 0, l_n - 1)
        bhit = (chosen[bidx] == bank_ids) & bank_valid
        lm_present = np.zeros(l_cap, np.float32)
        for ci in range(c):
            sel = bhit[ci]
            lms[bidx[ci, sel]] = bank_pos[ci, sel]
            lm_present[bidx[ci, sel]] = 1.0
        mask[:, :, lm_present == 0.0] = 0.0
        # Only landmarks with an in-window stereo observation may move: a
        # monocular-only depth slides along its ray and biases the scale.
        # Fixed landmarks still constrain the poses.
        has_stereo = mask[:, c:, :].sum(axis=(0, 1)) > 0.0
        h["lm_mask"][:] = lm_present * has_stereo.astype(np.float32)
        return self._problem(), chosen, lms

    def run(self, world_t_body: np.ndarray, covariance: np.ndarray | None, tracker_state, diagnostics: dict):
        """Optimize the window; push an accepted correction to the tracker.

        Variables: one pose per window tick and the landmarks seen in >= 3
        ticks. A correction applies only when the rms drops below 0.9x, the
        last pose moves less than ``max_correction_m`` and more than the
        PnP solve's own noise floor.

        ``last_solve`` holds what the call learned.

        Returns:
            ``(tracker_state, world_t_body, t_corr)``; ``t_corr`` is the
            applied odom-frame delta, or None (reason in
            ``diagnostics["ba_skip"]``).
        """
        self.last_solve = {"solved": False, "rms": None, "correction_m": None}
        built = self.build_problem(diagnostics)
        if built is None:
            return tracker_state, world_t_body, None
        problem, chosen, lms = built
        dev = self._device
        result, refined_lms_dev = self._solve(problem)
        initial_rms, final_rms = float(result.initial_rms), float(result.final_rms)
        self.last_solve.update(solved=True, rms=(initial_rms, final_rms))
        # Only a meaningful improvement: near-neutral refinements are noise
        # reshuffling whose pose corrections compound as drift of their own.
        if not final_rms < 0.9 * initial_rms:
            diagnostics["ba_skip"] = f"rms {initial_rms:.5f}->{final_rms:.5f}"
            return tracker_state, world_t_body, None

        refined_poses = result.body_t_world.double().numpy()
        refined_lms = result.landmarks_w.numpy()
        ticks = list(self._ticks)[-self.window :]
        new_world = np.linalg.inv(refined_poses[len(ticks) - 1])
        corr = np.linalg.norm(new_world[:3, 3] - world_t_body[:3, 3])
        self.last_solve["correction_m"] = float(corr)
        if corr > self.max_correction_m:
            diagnostics["ba_skip"] = f"correction {corr:.3f} m"
            return tracker_state, world_t_body, None  # junk guard
        if covariance is not None:
            floor = self.noise_gate_sigma * float(np.sqrt(max(np.trace(covariance[:3, :3]), 0.0)))
            if corr < floor:
                diagnostics["ba_skip"] = f"corr {corr:.4f} m < noise floor {floor:.4f} m"
                return tracker_state, world_t_body, None

        # A landmark the solver moved implausibly far disagrees with the
        # window (wrong association, degenerate depth): keep its position.
        l_n = len(chosen)
        lm_ok = np.linalg.norm(refined_lms - lms, axis=-1) <= self.max_correction_m
        t_corr = new_world @ np.linalg.inv(np.asarray(world_t_body, np.float64))
        h = self._np
        h["t_corr"][:] = t_corr
        h["upd_ids"].fill(_ID_PAD)
        h["upd_ids"][:l_n] = chosen
        h["upd_ok"].fill(False)
        h["upd_ok"][:l_n] = lm_ok[:l_n]
        t_corr_d, upd_ids, upd_ok = (self._host[k].to(dev, non_blocking=True) for k in ("t_corr", "upd_ids", "upd_ok"))
        tracker_state = apply_correction(tracker_state, t_corr_d, upd_ids, refined_lms_dev, upd_ok)
        for ki, t in enumerate(ticks):  # the next solve starts warm
            t["body_t_world"] = refined_poses[ki]
        diagnostics["ba_rms"] = (initial_rms, final_rms)
        diagnostics["ba_landmarks"] = int(l_n)
        return tracker_state, new_world, t_corr
