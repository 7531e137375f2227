"""Carry tracker state, camera setup and TSDF grids between the reference
and the port.

Both directions go through numpy arrays, so this module imports no JAX:
the caller turns the reference's ``CameraSetup`` / ``TrackerState`` into
numpy (``np.asarray`` per field) and back.

* The reference's PRNG ``key`` is dropped: the port takes RANSAC draws
  from a ``torch.Generator`` or as injected uniforms.
* ``lm_desc`` words are reinterpreted bit for bit: uint32 in the
  reference, int32 bit patterns here.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from thor_slam_tpu_torch.engine.tracker import CameraSetup, TrackerState
from thor_slam_tpu_torch.mapping.tsdf import TsdfGrid

_BOOL_FIELDS = frozenset({"lm_valid", "lm_robs_valid", "lm_pending", "stereo_mask"})
_INT_FIELDS = frozenset({"lm_id", "lm_id_counter", "frame_idx", "untracked_streak", "last_kf_frame"})


def _field(obj: Any, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _to_torch(name: str, value, device) -> torch.Tensor:
    a = np.asarray(value)
    if name in _BOOL_FIELDS:
        a = a.astype(bool)
    elif name in _INT_FIELDS:
        a = a.astype(np.int32)
    elif name == "lm_desc":
        a = a.astype(np.uint32).view(np.int32)
    else:
        a = a.astype(np.float32)
    return torch.as_tensor(np.array(a, order="C"), device=device)  # keeps 0-d shapes


def setup_to_torch(setup: Any, device: torch.device | str) -> CameraSetup:
    """Any object or dict with the ``CameraSetup`` fields as arrays -> tensors."""
    return CameraSetup(**{f: _to_torch(f, _field(setup, f), device) for f in CameraSetup._fields})


def state_to_torch(state: Any, device: torch.device | str) -> TrackerState:
    """The reference's ``TrackerState`` fields as arrays -> the port's full
    state (``parallel.mesh.shard_state`` places it on a mesh)."""
    return TrackerState(**{f: _to_torch(f, _field(state, f), device) for f in TrackerState._fields})


def state_to_numpy(state: TrackerState) -> dict[str, np.ndarray]:
    """The port's state -> numpy arrays in the reference's dtypes (no key).
    A sharded state gives its full (gathered) fields."""
    out = {}
    for f in TrackerState._fields:
        a = getattr(state, f).detach().cpu().numpy()
        out[f] = a.view(np.uint32) if f == "lm_desc" else a
    return out


def grid_to_torch(arrays: Any, device: torch.device | str) -> TsdfGrid:
    """A TSDF grid's fields as arrays (the reference's ``TsdfGrid`` through
    ``np.asarray``, or a dict) -> the port's grid of f32 tensors."""
    return TsdfGrid(**{
        f: torch.as_tensor(np.array(_field(arrays, f), np.float32, order="C"), device=device)
        for f in TsdfGrid._fields
    })


def grid_to_numpy(grid: TsdfGrid) -> dict[str, np.ndarray]:
    """The port's grid -> numpy arrays by field name (f32, as the reference's)."""
    return {f: getattr(grid, f).detach().cpu().numpy() for f in TsdfGrid._fields}
