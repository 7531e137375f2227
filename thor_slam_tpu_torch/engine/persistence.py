"""Map and state persistence, relocalization and the landmark cloud.

The ``.npz`` layouts are the JAX engine's (``TpuSlamEngine.save_map`` /
``save_state``): descriptor words are written as uint32 and every field
keeps its name, so a map or state saved by either engine loads in the
other. A saved map is expressed in the MAP frame (the live bank and pose
lifted through ``map_t_odom``) and carries the place database, which is
what makes relocalization work after loading it.

Each function takes the engine (:class:`~thor_slam_tpu_torch.engine.
torch_engine.TorchSlamEngine`) whose state it reads or rewrites.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from thor_slam_tpu.camera.types import SynchronizedFrameSet
from thor_slam_tpu.slam.interface import SlamPose, TrackingState
from thor_slam_tpu_torch.engine import convert
from thor_slam_tpu_torch.engine import tracker as trk

logger = logging.getLogger(__name__)


def _npz_path(path) -> str:
    path = str(path)
    return path if path.endswith(".npz") else f"{path}.npz"  # np.savez appends it


def _lift(points: np.ndarray, m: np.ndarray) -> np.ndarray:
    return points @ m[:3, :3].T + m[:3, 3]


def get_landmark_cloud(engine) -> np.ndarray:
    """(M, 3) map-frame landmarks: the live bank plus the place DB's."""
    st = engine._tracker_state
    if st is None:
        return np.zeros((0, 3))
    pos = st.lm_pos_w.detach().cpu().numpy().astype(np.float64).reshape(-1, 3)
    valid = st.lm_valid.detach().cpu().numpy().reshape(-1)
    clouds = [_lift(pos[valid], engine._map_t_odom)]
    for e in engine._loop.db:
        clouds.append(np.asarray(e["lm_w"], np.float64)[np.asarray(e["valid"])])
    return np.concatenate(clouds)


def save_map(engine, path) -> bool:
    """Write the keyframes, the live bank and the place DB, map frame."""
    st = engine._tracker_state
    if st is None:
        return False
    kfs = engine._keyframe_poses
    m = engine._map_t_odom
    try:
        np.savez_compressed(
            path,
            lm_pos_w=_lift(st.lm_pos_w.detach().cpu().numpy().astype(np.float64), m).astype(np.float32),
            lm_desc=st.lm_desc.detach().cpu().numpy().view(np.uint32),
            lm_valid=st.lm_valid.detach().cpu().numpy(),
            world_t_body=m @ st.world_t_body.detach().cpu().numpy().astype(np.float64),
            keyframes=np.stack([p.to_4x4_matrix() for p in kfs]) if kfs else np.zeros((0, 4, 4)),
            keyframe_ts=np.asarray([p.timestamp for p in kfs]),
            **engine._loop.export_arrays(),
        )
        return True
    except OSError:
        logger.exception("Failed to save map to %s", path)
        return False


def load_map(engine, path) -> bool:
    """Load a saved map: its bank, keyframes and place DB. The session's
    odom frame is re-anchored to the map (``map_t_odom`` = identity)."""
    if engine._tracker_state is None:
        return False
    try:
        data = np.load(_npz_path(path))
    except OSError:
        logger.exception("Failed to load map from %s", path)
        return False
    dev = engine._device
    engine._tracker_state = engine._tracker_state._replace(
        lm_pos_w=torch.as_tensor(np.asarray(data["lm_pos_w"], np.float32), device=dev),
        lm_desc=torch.as_tensor(np.asarray(data["lm_desc"]).astype(np.uint32).view(np.int32), device=dev),
        lm_valid=torch.as_tensor(np.asarray(data["lm_valid"], bool), device=dev),
    )
    engine._map_t_odom = np.eye(4)
    engine._keyframe_poses = [
        SlamPose.from_4x4_matrix(mat, timestamp=float(t))
        for mat, t in zip(data["keyframes"], data["keyframe_ts"])
    ]
    if "db_desc" in data:
        engine._loop.load_arrays(data)
        engine._map_loaded = True  # arms auto-relocalization on LOST
    return True


def save_state(engine, path) -> bool:
    """Checkpoint the full tracker state (resume-capable) and map_t_odom."""
    if engine._tracker_state is None:
        return False
    arrays = convert.state_to_numpy(engine._tracker_state)
    arrays["map_t_odom"] = engine._map_t_odom
    try:
        np.savez_compressed(path, **arrays)
        return True
    except OSError:
        logger.exception("Failed to save engine state to %s", path)
        return False


def load_state(engine, path) -> bool:
    """Restore a :func:`save_state` checkpoint; fields it lacks take their
    fresh-state value (the JAX engine's PRNG key is ignored)."""
    if engine._tracker_state is None:
        return False
    try:
        data = np.load(_npz_path(path))
    except OSError:
        logger.exception("Failed to load engine state from %s", path)
        return False
    fields = convert.state_to_numpy(trk.init_state(engine._params, "cpu"))
    fields.update({f: data[f] for f in trk.TrackerState._fields if f in data})
    engine._tracker_state = convert.state_to_torch(fields, engine._device)
    if "map_t_odom" in data:
        engine._map_t_odom = np.asarray(data["map_t_odom"], np.float64)
    # The restored state starts a fresh shadow and correction epoch.
    engine._imu.reset_shadow()
    engine._ba_corr_total = np.eye(4)
    return True


def relocalize(engine) -> bool:
    """Arm relocalization against the loaded place DB: each following
    ``process_frames`` attempts it (rate-limited) until one verifies."""
    if engine._tracker_state is None:
        return False
    engine._want_reloc = True
    engine._reloc_countdown = 0  # attempt on the next tick
    engine._state_enum = TrackingState.RELOCALIZING
    return True


def attempt_relocalization(engine, frame_set: SynchronizedFrameSet) -> bool:
    """One attempt with camera 0's left image; True when it verified.

    The recovered pose is map-frame: the tracker snaps to it, its bank is
    invalidated and the restart path re-mints landmarks there at the next
    tick.
    """
    frames = frame_set.get_frames_for_source(engine._source_order[0])
    if not frames:
        return False
    img = torch.from_numpy(np.ascontiguousarray(frames[0].image)).to(engine._device)
    img = img.float() * (1.0 / 255.0) if img.dtype == torch.uint8 else img.float()
    pose = engine._loop.relocalize_attempt(img, engine._params, engine._frame_count)
    if pose is None:
        return False
    engine._map_t_odom = np.eye(4)
    st = engine._tracker_state
    pose_t = torch.as_tensor(pose, dtype=torch.float32, device=engine._device)
    engine._tracker_state = st._replace(
        world_t_body=pose_t,
        prev_world_t_body=pose_t.clone(),
        kf_world_t_body=pose_t.clone(),
        lm_valid=torch.zeros_like(st.lm_valid),
        untracked_streak=torch.full_like(st.untracked_streak, engine._params.restart_after_untracked),
    )
    engine._ba.clear()  # window poses are in the pre-relocalization frame
    engine._imu.reset_shadow()
    engine._ba_corr_total = np.eye(4)
    return True
