"""Observability: rate counters, stage timers, status lines.

A copy of :mod:`thor_slam_tpu.utils.profiling` without ``jax_trace`` (the
JAX profiler hook has no counterpart in the port yet): the operator status
line, per-stage EMA timers and structured snapshots.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass, field


class RateCounter:
    """Windowed events-per-second counter (FPS)."""

    def __init__(self, window: int = 60) -> None:
        self._times: deque[float] = deque(maxlen=window)

    def tick(self, t: float | None = None) -> None:
        self._times.append(time.monotonic() if t is None else t)

    @property
    def rate_hz(self) -> float:
        if len(self._times) < 2:
            return 0.0
        span = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / span if span > 0 else 0.0


@dataclass
class StageTimer:
    """Exponential-moving-average wall time for a named pipeline stage."""

    name: str
    alpha: float = 0.1
    ema_ms: float = 0.0
    last_ms: float = 0.0
    count: int = 0

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.last_ms = (time.perf_counter() - t0) * 1000.0
            self.ema_ms = (
                self.last_ms if self.count == 0 else (1 - self.alpha) * self.ema_ms + self.alpha * self.last_ms
            )
            self.count += 1


@dataclass
class PipelineStats:
    """Aggregated runtime stats for the status line and structured logging."""

    fps: RateCounter = field(default_factory=RateCounter)
    stages: dict[str, StageTimer] = field(default_factory=dict)
    max_time_delta_ms: float = 0.0
    num_inliers: int = 0
    tracking_state: str = "NOT_INITIALIZED"

    def stage(self, name: str) -> StageTimer:
        if name not in self.stages:
            self.stages[name] = StageTimer(name)
        return self.stages[name]

    def status_line(self, frame_count: int) -> str:
        """The operator status line (reference run_slam.py:349-357 shape)."""
        stages = " ".join(f"{n}={t.ema_ms:.1f}ms" for n, t in sorted(self.stages.items()))
        return (
            f"Frame {frame_count} | {self.fps.rate_hz:5.1f} FPS | "
            f"state={self.tracking_state} | inliers={self.num_inliers} | "
            f"sync_dt={self.max_time_delta_ms:.1f}ms | {stages}"
        )

    def snapshot(self, frame_count: int) -> dict:
        """Structured metrics record (one JSON-able dict per interval)."""
        return {
            "frame": frame_count,
            "fps": round(self.fps.rate_hz, 2),
            "tracking_state": self.tracking_state,
            "num_inliers": self.num_inliers,
            "sync_max_dt_ms": round(self.max_time_delta_ms, 2),
            "stages_ms": {n: round(t.ema_ms, 2) for n, t in self.stages.items()},
        }
