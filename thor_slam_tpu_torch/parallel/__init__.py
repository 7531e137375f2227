"""Tracking over several devices: camera- or slot-sharded ticks over a
:class:`~thor_slam_tpu_torch.parallel.mesh.Mesh`, driven by one process."""

from thor_slam_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedTrackerState,
    gather_state,
    make_camera_mesh,
    make_sharded_track_step,
    shard_state,
)

__all__ = [
    "Mesh",
    "ShardedTrackerState",
    "gather_state",
    "make_camera_mesh",
    "make_sharded_track_step",
    "shard_state",
]
