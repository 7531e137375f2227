"""Pipelined tick execution: the pending queue and batched output fetching.

The port's copy of :mod:`thor_slam_tpu.engine.pipeline_exec` (which uses
no JAX). This object owns the in-flight tick records and the order in which
their outputs come back; the engine hands it two callables, ``fetch``
(materialize a batch of records' outputs on the host) and ``finalize`` (run
the host state machine over one fetched record), so the executor holds no
SLAM logic.

* A tick's outputs start their device-to-host copies at dispatch, into
  pinned host memory, with one ``torch.cuda.Event`` recorded after them
  (the engine's ``_dispatch_tick``), so by the time a record is finalized
  its fetch usually finds the values on the host.
* Finalizes batch: finalizing the oldest pending tick also finalizes every
  newer tick whose outputs are already on the host.
* ``defer_sync`` never finalizes mid-stream: one fetch over the whole
  stream at :meth:`drain`.

The one difference from the reference: a record is ready when its
``"event"`` (the event recorded after its copies) reports done
(``event.query()``), where the reference asks its device array
(``is_ready()``). A record without an event (the CPU, where the outputs
are on the host at once) is ready.
"""

from __future__ import annotations

from collections import deque
from typing import Callable


def record_ready(record: dict) -> bool:
    """True when a record's outputs are on the host."""
    event = record.get("event")
    return event is None or bool(event.query())


class PipelineExecutor:
    """In-flight tick records and their finalize order.

    Args:
        depth: Number of in-flight ticks before finalizes begin (pose
            latency in ticks).
        defer_sync: Never finalize mid-stream; :meth:`drain` fetches the
            whole stream's outputs in one batch and replays them.
        fetch: ``fetch(records)`` brings every record's outputs to the host
            in place (the engine's ``_fetch_records``). Looked up through
            this callable at call time, so shims that wrap the engine
            method keep seeing every fetch.
        finalize: ``finalize(record)`` runs the host state machine over
            one fetched record and returns the pose (or None).
    """

    def __init__(
        self,
        depth: int,
        defer_sync: bool,
        fetch: Callable[[list[dict]], None],
        finalize: Callable[[dict], object],
    ) -> None:
        self.depth = max(1, int(depth))
        self.defer_sync = bool(defer_sync)
        self._fetch = fetch
        self._finalize = finalize
        self._q: deque[dict] = deque()

    def __len__(self) -> int:
        return len(self._q)

    def clear(self) -> None:
        """Drop in-flight records without finalizing (reset/relocalize)."""
        self._q.clear()

    def submit(self, record: dict) -> None:
        self._q.append(record)

    @property
    def at_depth(self) -> bool:
        """True when the queue has reached the pipeline depth (the next
        submit should be preceded by a finalize)."""
        return len(self._q) >= self.depth

    def finalize_ready(self):
        """Finalize the oldest pending tick and, in the same fetch, every
        newer tick whose outputs are already on the host."""
        q = self._q
        take = 1
        while take < len(q) and record_ready(q[take]):
            take += 1
        records = [q.popleft() for _ in range(take)]
        self._fetch(records)
        pose = None
        for rec in records:
            pose = self._finalize(rec)
        return pose

    def drain(self):
        """Finalize every in-flight tick in order (stream flush).

        In ``defer_sync`` mode this is where the whole stream's outputs
        come back: one fetch over every deferred tick, then the host state
        machine replays them in order. Returns ``(last_pose,
        per_tick_poses)``; ``per_tick_poses`` is filled only in defer_sync
        mode (the engine's ``last_flush_poses``), None otherwise.
        """
        if self.defer_sync and self._q:
            records = list(self._q)
            self._q.clear()
            self._fetch(records)
            pose = None
            poses = []
            for rec in records:
                pose = self._finalize(rec)
                poses.append(pose)
            return pose, poses
        pose = None
        while self._q:
            pose = self.finalize_ready()
        return pose, None
