"""Track-level sliding-window bundle adjustment backend.

Port of :mod:`thor_slam_tpu.engine.backends.track_ba`. The measurements
are the tracker's own per-tick outputs (:func:`~thor_slam_tpu_torch.
engine.tracker.pack_ba_obs`): KLT positions joined across ticks by the
persistent landmark id, so keyframe-boundary slot changes never poison a
window. Only finalized-tick data is read; a correction lands on the live
tracker state as one left-multiplied pose delta plus a by-id landmark
update (:func:`apply_correction`).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from thor_slam_tpu_torch.engine import ba
from thor_slam_tpu_torch.engine import tracker as trk

_ID_PAD = np.iinfo(np.int32).max  # sorts after every real id


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
    ``upd_pos`` (L, 3) position.
    """
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
        self._num_cams = 0
        self._device: torch.device | None = None

    def bind(self, setup: trk.CameraSetup, num_cams: int) -> None:
        """Bind the per-camera constants (tensors on the engine's device).

        The BA camera axis is 2C: left imagers, then right imagers (the
        stereo constraint anchors scale inside the window).
        """
        self._num_cams = num_cams
        self._device = setup.cam_r_body.device
        self._cam_rot = torch.cat([setup.cam_r_body, setup.cam_r_body_right]).float()
        self._cam_trans = torch.cat([setup.cam_t_body, setup.cam_t_body_right]).float()

    def warm(self) -> None:
        """Solve one empty window of the bound shape (the first dense
        solve on a device initializes its solver library)."""
        k, c2, l_cap = self.window, self._cam_rot.shape[0], self.landmarks
        f32 = dict(dtype=torch.float32, device=self._device)
        ba.bundle_adjust(
            ba.BAProblem(
                body_t_world=torch.eye(4, **f32).expand(k, 4, 4), landmarks_w=torch.zeros((l_cap, 3), **f32),
                obs=torch.zeros((k, c2, l_cap, 2), **f32), obs_mask=torch.zeros((k, c2, l_cap), **f32),
                cam_rot=self._cam_rot, cam_trans=self._cam_trans, pose_mask=torch.zeros(k, **f32),
                lm_mask=torch.zeros(l_cap, **f32),
            ),
            iters=1,
        )

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
        """Assemble the window's fixed-shape problem (on the host, then
        copied to the bound device).

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

        obs = np.zeros((k_win, 2 * c, l_cap, 2), np.float32)
        mask = np.zeros((k_win, 2 * c, l_cap), np.float32)
        poses = np.tile(np.eye(4, dtype=np.float32), (k_win, 1, 1))
        pose_mask = np.zeros(k_win, np.float32)
        lms = np.zeros((l_cap, 3), np.float32)
        for ki, t in enumerate(ticks):
            poses[ki] = t["body_t_world"]
            pose_mask[ki] = 1.0
            idx = np.clip(np.searchsorted(chosen, t["ids"]), 0, l_n - 1)
            hit = (chosen[idx] == t["ids"]) & t["valid"]  # (C, N)
            for ci in range(c):
                sel = hit[ci]
                li = idx[ci, sel]
                obs[ki, ci, li] = t["obs"][ci, sel]
                mask[ki, ci, li] = 1.0
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
        lm_mask = lm_present * has_stereo.astype(np.float32)
        arrays = dict(
            body_t_world=poses, landmarks_w=lms, obs=obs, obs_mask=mask,
            pose_mask=pose_mask, lm_mask=lm_mask,
        )
        problem = ba.BAProblem(
            cam_rot=self._cam_rot, cam_trans=self._cam_trans,
            **{k: torch.from_numpy(v).to(self._device) for k, v in arrays.items()},
        )
        return problem, chosen, lms

    def run(self, world_t_body: np.ndarray, covariance: np.ndarray | None, tracker_state, diagnostics: dict):
        """Optimize the window; push an accepted correction to the tracker.

        Variables: one pose per window tick and the landmarks seen in >= 3
        ticks. A correction applies only when the rms drops below 0.9x, the
        last pose moves less than ``max_correction_m`` and more than the
        PnP solve's own noise floor.

        Returns:
            ``(tracker_state, world_t_body, t_corr)``; ``t_corr`` is the
            applied odom-frame delta, or None (reason in
            ``diagnostics["ba_skip"]``).
        """
        built = self.build_problem(diagnostics)
        if built is None:
            return tracker_state, world_t_body, None
        problem, chosen, lms = built
        dev = self._device
        result = ba.bundle_adjust(problem, huber_delta=0.004)
        initial_rms, final_rms = torch.stack([result.initial_rms, result.final_rms]).tolist()
        # Only a meaningful improvement: near-neutral refinements are noise
        # reshuffling whose pose corrections compound as drift of their own.
        if not final_rms < 0.9 * initial_rms:
            diagnostics["ba_skip"] = f"rms {initial_rms:.5f}->{final_rms:.5f}"
            return tracker_state, world_t_body, None

        refined_poses = result.body_t_world.double().cpu().numpy()
        refined_lms = result.landmarks_w.cpu().numpy()
        ticks = list(self._ticks)[-self.window :]
        new_world = np.linalg.inv(refined_poses[len(ticks) - 1])
        corr = np.linalg.norm(new_world[:3, 3] - world_t_body[:3, 3])
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
        l_cap, l_n = self.landmarks, len(chosen)
        lm_ok = np.linalg.norm(refined_lms - lms, axis=-1) <= self.max_correction_m
        t_corr = new_world @ np.linalg.inv(np.asarray(world_t_body, np.float64))
        upd_ids = np.full(l_cap, _ID_PAD, np.int32)
        upd_ids[:l_n] = chosen
        upd_ok = np.zeros(l_cap, bool)
        upd_ok[:l_n] = lm_ok[:l_n]
        tracker_state = apply_correction(
            tracker_state,
            torch.as_tensor(t_corr, dtype=torch.float32, device=dev),
            torch.from_numpy(upd_ids).to(dev),
            result.landmarks_w,
            torch.from_numpy(upd_ok).to(dev),
        )
        for ki, t in enumerate(ticks):  # the next solve starts warm
            t["body_t_world"] = refined_poses[ki]
        diagnostics["ba_rms"] = (initial_rms, final_rms)
        diagnostics["ba_landmarks"] = int(l_n)
        return tracker_state, new_world, t_corr
