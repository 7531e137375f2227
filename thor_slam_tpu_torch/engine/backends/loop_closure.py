"""Loop-closure / place-recognition backend.

Port of :mod:`thor_slam_tpu.engine.backends.loop_closure`. Owns the place
database (host entries plus a device-resident descriptor ring), the
asynchronous find -> verify -> apply machine, the noise-floor discrepancy
gate, the pose-graph solve, and relocalization against a loaded map.

It consumes only finalized keyframe signatures (``pack_kf_sig``), never
the live tracker state. Everything it stores (entry poses, landmarks)
lives in the MAP frame; the engine composes the corrections it returns
into its ``map_t_odom`` and rewrites its keyframe trajectory.

Differences from the reference: a dispatch is "ready" when a
``torch.cuda.Event`` recorded after it reports done (``event.query()``,
where the reference polls ``is_ready()``); on the CPU a dispatch is
complete at once. Verification draws come from a ``torch.Generator``
seeded with the keyframe's frame count (the reference seeds
``jax.random.PRNGKey(frame_count)``); ``uniform_source`` injects others.
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np
import torch

from thor_slam_tpu_torch.engine import loop, posegraph
from thor_slam_tpu_torch.engine import tracker as trk
from thor_slam_tpu_torch.ops import brief, fast, rectify
from thor_slam_tpu_torch.ops.image import gaussian_blur

logger = logging.getLogger(__name__)


def _next_pow2(k: int, floor: int = 8) -> int:
    """Smallest power of two >= max(k, floor) (graph-size bucketing)."""
    cap = floor
    while cap < k:
        cap *= 2
    return cap


def _record_event(device: torch.device):
    """An event marking the work queued so far, or None on the CPU."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _ready(event) -> bool:
    return event is None or event.query()


class LoopBackend:
    """Place DB + async loop detection/verification + pose graph.

    Args mirror the engine's ``loop_*`` parameters. The DB is
    multi-camera: each keyframe entry stores every camera's signature and
    detection looks the query (camera 0) up against all of them, so a
    revisit is recognized from any heading.

    ``uniform_source(frame_count, n)``, when set, returns the (48, n)
    verification draws in [0, 1) (tests inject the reference's).
    """

    def __init__(
        self,
        capacity: int = 256,
        min_votes: int = 60,
        min_inliers: int = 40,
        exclude_recent: int = 12,
        cooldown_kfs: int = 20,
        min_correction_m: float = 0.05,
        noise_gate_sigma: float = 3.0,
    ) -> None:
        self.capacity = capacity
        self.min_votes = min_votes
        self.min_inliers = min_inliers
        self.exclude_recent = exclude_recent
        self.cooldown_kfs = cooldown_kfs
        self.min_correction_m = min_correction_m
        self.noise_gate_sigma = noise_gate_sigma
        self.uniform_source: Callable[[int, int], torch.Tensor] | None = None
        self._setup: trk.CameraSetup | None = None
        self._device = torch.device("cpu")
        self._max_keypoints = 0
        self._num_cams = 1
        self.reset()

    def bind(self, setup: trk.CameraSetup, max_keypoints: int) -> None:
        """Bind the per-camera constants (tensors on the engine's device)."""
        self._setup = setup
        self._device = setup.k_left.device
        self._max_keypoints = max_keypoints
        self._num_cams = int(setup.k_left.shape[0])
        self._k0 = setup.k_left[0].double().cpu().numpy()
        self._d0 = setup.dist_left[0].double().cpu().numpy()
        self._body_t_cam = setup.body_t_cam.double().cpu().numpy()

    def warm(self) -> None:
        """Run one pose-graph solve on a small chain: the first
        ``torch.func`` transform of a process pays a one-time set-up of
        seconds, which belongs in the engine's initialize, not in a tick."""
        chain = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
        chain[:, 0, 3] = np.arange(8, dtype=np.float32)
        arrays = dict(zip(("edge_i", "edge_j", "edge_t", "edge_weight"), posegraph.sequential_graph(chain, capacity_edges=8)))
        arrays.update(poses=chain, node_mask=np.ones(8, np.float32))
        posegraph.optimize(posegraph.PoseGraph(**{k: torch.from_numpy(v).to(self._device) for k, v in arrays.items()}), iters=1)

    def reset(self) -> None:
        self.db: list[dict] = []
        self.loops_closed = 0
        self.kf_total = 0
        self._cooldown = 0
        #: The in-flight detection/verification (see :meth:`poll`).
        self._pending: dict | None = None
        self._dev_desc: torch.Tensor | None = None
        self._dev_valid: torch.Tensor | None = None

    # ------------------------------------------------------ device ring

    def _ensure_dev_db(self) -> None:
        """Allocate the (capacity * C, N, 8) int32 descriptor ring and its
        (capacity * C, N) validity: keyframe ``slot`` owns rows
        ``[slot * C, (slot + 1) * C)``."""
        if self._dev_desc is not None:
            return
        rows, n = self.capacity * self._num_cams, self._max_keypoints
        self._dev_desc = torch.zeros((rows, n, 8), dtype=torch.int32, device=self._device)
        self._dev_valid = torch.zeros((rows, n), dtype=torch.bool, device=self._device)

    def _insert(self, slot: int, desc: np.ndarray, valid: np.ndarray) -> None:
        """Write one entry's (C, N', 8) uint32 words into its ring rows."""
        c, n = self._num_cams, self._max_keypoints
        k = min(n, desc.shape[1])
        rows = slice(slot * c, (slot + 1) * c)
        words = torch.from_numpy(np.ascontiguousarray(desc[:, :k]).view(np.int32))
        self._dev_desc[rows] = 0
        self._dev_valid[rows] = False
        self._dev_desc[rows, :k] = words.to(self._device)
        self._dev_valid[rows, :k] = torch.from_numpy(np.ascontiguousarray(valid[:, :k])).to(self._device)

    def _fit_cams(self, arr: np.ndarray) -> np.ndarray:
        """Crop/zero-pad an entry array's camera axis to this session's C
        (a loaded map may come from another rig)."""
        c = self._num_cams
        if arr.shape[0] == c:
            return arr
        out = np.zeros((c,) + arr.shape[1:], arr.dtype)
        out[: min(c, arr.shape[0])] = arr[:c]
        return out

    def rebuild_dev_db(self) -> None:
        """Re-seed the device ring from the host DB (map load)."""
        self._dev_desc = None
        if not self.db:
            return
        self._ensure_dev_db()
        for e in self.db:
            self._insert(e["slot"], self._fit_cams(e["desc"]), self._fit_cams(e["valid"]))

    def _eligible(self, entries) -> torch.Tensor:
        """(capacity * C,) float mask of the ring rows of ``entries``."""
        mask = np.zeros((self.capacity, self._num_cams), np.float32)
        for e in entries:
            mask[e["slot"], :] = 1.0
        return torch.from_numpy(mask.reshape(-1))

    def _draws(self, frame_count: int, n: int) -> torch.Tensor:
        if self.uniform_source is not None:
            return self.uniform_source(frame_count, n).to(self._device, torch.float32)
        gen = torch.Generator(device=self._device).manual_seed(int(frame_count))
        return torch.rand((loop.NUM_HYPOTHESES, n), generator=gen, device=self._device)

    def _obs_norm(self, xy: np.ndarray) -> torch.Tensor:
        """Camera-0 raw pixels (N, 2) -> undistorted normalized coordinates."""
        k0 = self._k0
        xn = np.stack([(xy[:, 0] - k0[2]) / k0[0], (xy[:, 1] - k0[3]) / k0[1]], -1)
        return torch.from_numpy(rectify.undistort_normalized(xn, self._d0).astype(np.float32)).to(self._device)

    def _verify(self, cand_e: dict, cam: int, obs_norm, q_desc, q_valid, frame_count: int):
        s, dev = self._setup, self._device
        init = torch.as_tensor(np.linalg.inv(self._match_pose(cand_e, cam)), dtype=torch.float32, device=dev)
        return loop.verify_candidate(
            torch.as_tensor(cand_e["lm_w"][cam], dtype=torch.float32, device=dev),
            torch.as_tensor(cand_e["valid"][cam], device=dev),
            torch.from_numpy(np.ascontiguousarray(cand_e["desc"][cam]).view(np.int32)).to(dev),
            obs_norm, q_desc, q_valid,
            s.cam_r_body[0], s.cam_t_body[0], init,
            min_inliers=self.min_inliers,
            uniforms=self._draws(frame_count, q_desc.shape[0]),
        )

    # -------------------------------------------------------- keyframes

    def on_keyframe(
        self, world_t_body: np.ndarray, ts: float, sig: dict, map_t_odom: np.ndarray, frame_count: int
    ) -> None:
        """Record a keyframe signature; maybe start an async detection.

        ``world_t_body`` is the MAP-frame keyframe pose and ``sig`` the
        unpacked all-camera signature (:func:`~thor_slam_tpu_torch.engine.
        tracker.unpack_kf_sig`); its landmarks are stored in the map frame.
        """
        m = map_t_odom
        slot = self.kf_total % self.capacity
        self.kf_total += 1
        entry = {
            "desc": self._fit_cams(sig["desc"]),
            "valid": self._fit_cams(sig["valid"]),
            "lm_w": self._fit_cams(sig["pos"] @ m[:3, :3].T + m[:3, 3]),
            "obs_px": self._fit_cams(sig["obs_px"]),
            "world_t_body": world_t_body.copy(),
            "ts": ts,
            "slot": slot,
        }
        self.db.append(entry)
        if len(self.db) > self.capacity:
            # Insertion order is slot order: this drops exactly the entry
            # whose ring slot is being reused.
            self.db = self.db[-self.capacity :]
        self._ensure_dev_db()
        self._insert(slot, entry["desc"], entry["valid"])

        if self._cooldown > 0:
            self._cooldown -= 1
            return
        if len(self.db) <= self.exclude_recent + 1 or self._pending is not None:
            return
        dev = self._device
        cand = loop.find_candidate(
            torch.from_numpy(np.ascontiguousarray(entry["desc"][0]).view(np.int32)).to(dev),
            torch.from_numpy(entry["valid"][0]).to(dev),
            self._dev_desc, self._dev_valid,
            self._eligible(self.db[: -self.exclude_recent - 1]),
        )
        self._pending = {
            "stage": "find",
            "cand": cand,
            "event": _record_event(dev),
            "query": entry,
            "query_map_pose": world_t_body.copy(),
            "frame_count": frame_count,
        }

    def _match_pose(self, cand_e: dict, cam: int) -> np.ndarray:
        """Initial query body pose for verifying a hit on camera ``cam``:
        ``cand_pose @ body_t_cam[cam] @ inv(body_t_cam[0])`` (the query
        sees through camera 0 what the entry recorded through ``cam``;
        for a reverse-heading revisit this is ~pi from the drifted live
        heading, far outside what the fixed-iteration solve recovers)."""
        b_t_cam = self._body_t_cam
        return cand_e["world_t_body"] @ b_t_cam[cam] @ np.linalg.inv(b_t_cam[0])

    # ------------------------------------------------------------- poll

    def poll(self, block: bool = False, diagnostics: dict | None = None):
        """Advance the async machine: ``find`` -> ``verify`` -> apply.

        Returns None, or ``(t_corr, opt_poses, kk, info)``: the map<-map
        delta of the newest node (compose into ``map_t_odom``), the
        smoothed map-frame DB trajectory (``kk`` poses) and a log dict.
        ``block=True`` drains to completion.
        """
        p = self._pending
        if p is None:
            return None
        if p["stage"] == "find":
            if not (block or _ready(p["event"])):
                return None
            votes, row = torch.stack([p["cand"].votes, p["cand"].keyframe]).tolist()
            if votes < self.min_votes:
                self._pending = None
                return None
            slot, cam = divmod(int(row), self._num_cams)
            cand_e = next((e for e in self.db if e["slot"] == slot), None)
            if cand_e is None:  # evicted while the lookup was in flight
                self._pending = None
                return None
            entry = p["query"]
            dev = self._device
            p["ver"] = self._verify(
                cand_e, cam, self._obs_norm(entry["obs_px"][0]),
                torch.from_numpy(np.ascontiguousarray(entry["desc"][0]).view(np.int32)).to(dev),
                torch.from_numpy(entry["valid"][0]).to(dev),
                p["frame_count"],
            )
            p["event"] = _record_event(dev)
            p["votes"] = int(votes)
            p["cand_e"] = cand_e
            p["stage"] = "verify"
            if not block:
                return None
        if p["stage"] == "verify":
            if not (block or _ready(p["event"])):
                return None
            ver = loop.LoopVerification(*(t.detach().cpu().numpy() for t in p["ver"]))
            self._pending = None
            if not bool(ver.accepted):
                return None
            return self._apply(p, ver, diagnostics)
        return None

    def _apply(self, p: dict, ver, diagnostics: dict | None):
        """Gate and apply a verified loop constraint (map side only)."""
        entry = p["query"]
        cand_e = p["cand_e"]
        world_t_body = p["query_map_pose"]
        # The constraint must disagree with the query's map pose by more
        # than its own noise floor (the verification solve's covariance).
        loop_pose_est = np.linalg.inv(np.asarray(ver.body_t_candidate, np.float64))
        disc = np.linalg.norm(loop_pose_est[:3, 3] - world_t_body[:3, 3])
        sigma_t = float(np.sqrt(max(np.trace(np.asarray(ver.covariance, np.float64)[:3, :3]), 0.0)))
        noise_floor = max(self.min_correction_m, self.noise_gate_sigma * sigma_t)
        if disc < noise_floor:
            self._cooldown = self.cooldown_kfs
            if diagnostics is not None:
                diagnostics["loop_skip"] = f"disc {disc:.4f} m < floor {noise_floor:.4f} m (sigma {sigma_t:.4f})"
            return None
        try:
            ci = next(i for i, e in enumerate(self.db) if e is cand_e)
            qi = next(i for i, e in enumerate(self.db) if e is entry)
        except StopIteration:
            return None  # evicted while verification was in flight

        graph, poses = self.build_graph(ci, qi, np.linalg.inv(cand_e["world_t_body"]) @ loop_pose_est)
        kk = poses.shape[0]
        opt_poses, _ = posegraph.optimize(graph)
        opt_poses = opt_poses.double().cpu().numpy()[:kk]

        # Map side only: the live tracker state (odom) is left alone.
        t_corr = opt_poses[-1] @ np.linalg.inv(poses[-1].astype(np.float64))
        for idx, e in enumerate(self.db):
            e["world_t_body"] = opt_poses[idx]
            node_corr = opt_poses[idx] @ np.linalg.inv(poses[idx].astype(np.float64))
            e["lm_w"] = e["lm_w"] @ node_corr[:3, :3].T + node_corr[:3, 3]

        self.loops_closed += 1
        self._cooldown = self.cooldown_kfs
        info = {"ci": ci, "qi": qi, "votes": p["votes"], "inliers": int(ver.num_inliers)}
        logger.info(
            "Loop closed: kf %d <-> %d (votes=%d inliers=%d), |corr|=%.3f m",
            ci, qi, info["votes"], info["inliers"], float(np.linalg.norm(t_corr[:3, 3])),
        )
        return t_corr, opt_poses, kk, info

    def build_graph(self, ci: int, qi: int, loop_t: np.ndarray) -> tuple[posegraph.PoseGraph, np.ndarray]:
        """The pose graph of a closure: the odometry chain over the DB
        trajectory plus a loop edge ``loop_t`` (body_ci_T_body_qi) between
        DB indices ``ci`` and ``qi``, padded to a power of two, on the
        device. Returns it with the (kk, 4, 4) float32 DB poses."""
        poses = np.stack([e["world_t_body"] for e in self.db]).astype(np.float32)
        kk = poses.shape[0]
        kk_pad = _next_pow2(kk)
        ei, ej, et, w = posegraph.sequential_graph(poses, capacity_edges=kk_pad)
        ei[kk - 1], ej[kk - 1] = ci, qi
        et[kk - 1] = loop_t
        w[kk - 1] = 3.0
        poses_pad = np.tile(np.eye(4, dtype=np.float32), (kk_pad, 1, 1))
        poses_pad[:kk] = poses
        node_mask = (np.arange(kk_pad) < kk).astype(np.float32)
        arrays = dict(poses=poses_pad, node_mask=node_mask, edge_i=ei, edge_j=ej, edge_t=et, edge_weight=w)
        graph = posegraph.PoseGraph(**{k: torch.from_numpy(v).to(self._device) for k, v in arrays.items()})
        return graph, poses

    # ----------------------------------------------------- relocalization

    def relocalize_attempt(self, img: torch.Tensor, params: trk.TrackerParams, frame_count: int):
        """One attempt against the DB; the MAP-frame body pose or None.

        ``img`` is the camera-0 left image, (H, W) float32 in [0, 1] on the
        engine's device. Detection and description run as a (1, H, W)
        stack through the FAST and patch-gather kernels.
        """
        if not self.db:
            return None
        p = params
        stack = img[None]
        kp = fast.detect_keypoints_batched(
            stack, threshold=p.fast_threshold, max_keypoints=p.max_keypoints,
            cell_size=p.cell_size, per_cell=p.per_cell, border_margin=p.border_margin,
        )
        desc = brief.compute_descriptors_batched(gaussian_blur(stack, 2.0, radius=4), kp.xy, kp.valid)
        if self._dev_desc is None:
            self.rebuild_dev_db()
        cand = loop.find_candidate(
            desc.bits[0], desc.valid[0], self._dev_desc, self._dev_valid, self._eligible(self.db)
        )
        votes, row = torch.stack([cand.votes, cand.keyframe]).tolist()
        if votes < self.min_votes:
            return None
        slot, cam = divmod(int(row), self._num_cams)
        cand_e = next((e for e in self.db if e["slot"] == slot), None)
        if cand_e is None:
            return None
        obs_norm = self._obs_norm(kp.xy[0].double().cpu().numpy())
        ver = self._verify(cand_e, cam, obs_norm, desc.bits[0], desc.valid[0], frame_count)
        if not bool(ver.accepted):
            return None
        pose = np.linalg.inv(ver.body_t_candidate.double().cpu().numpy())
        logger.info(
            "Relocalized against keyframe slot %d cam %d (votes=%d inliers=%d)",
            slot, cam, int(votes), int(ver.num_inliers),
        )
        return pose

    # ----------------------------------------------------- serialization

    def export_arrays(self) -> dict:
        """The place DB as savez-ready arrays (travels with a saved map)."""
        if not self.db:
            return {}
        return {
            "db_desc": np.stack([self._fit_cams(e["desc"]) for e in self.db]),
            "db_valid": np.stack([self._fit_cams(e["valid"]) for e in self.db]),
            "db_lm_w": np.stack([self._fit_cams(e["lm_w"]) for e in self.db]),
            "db_poses": np.stack([e["world_t_body"] for e in self.db]),
            "db_ts": np.asarray([e["ts"] for e in self.db]),
        }

    def load_arrays(self, data) -> None:
        """Restore the DB from :meth:`export_arrays` output.

        A DB larger than ``capacity`` keeps its newest entries; single-camera
        maps ((K, N, 8) descriptors) load as one camera lane.
        """
        n = int(data["db_desc"].shape[0])
        legacy = data["db_desc"].ndim == 3
        start = max(0, n - self.capacity)
        if start:
            logger.warning(
                "Loaded place DB has %d keyframes > capacity %d; keeping the newest %d",
                n, self.capacity, self.capacity,
            )

        def cams(arr):
            return arr[None] if legacy else arr

        self.db = [
            {
                "desc": cams(np.asarray(data["db_desc"][i], np.uint32)),
                "valid": cams(data["db_valid"][i]),
                "lm_w": cams(data["db_lm_w"][i]),
                "obs_px": np.zeros(cams(data["db_lm_w"][i]).shape[:-1] + (2,)),
                "world_t_body": data["db_poses"][i],
                "ts": float(data["db_ts"][i]),
                "slot": i - start,
            }
            for i in range(start, n)
        ]
        self.kf_total = len(self.db)
        self._pending = None
        self.rebuild_dev_db()
