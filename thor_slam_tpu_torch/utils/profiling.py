"""Observability: rate counters, stage timers, status lines, profiler hooks.

A copy of :mod:`thor_slam_tpu.utils.profiling` (the operator status line,
per-stage EMA timers and structured snapshots) whose profiler hook is
:func:`torch_trace`, the counterpart of the reference's ``jax_trace``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
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


#: Host-side runtime calls that launch work on the device (one per kernel
#: launch; a graph launch counts once).
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch")
#: The port's hand-written kernels, by the name their counts go by.
KERNELS = ("patch_gather", "fast9_nms", "sgm_scan", "sgm_winner_lr")
_trace_ids = itertools.count()


def _count_tables() -> dict:
    from thor_slam_tpu_torch.ops import fast_cuda, patches_cuda, sgm_cuda

    return {"patch_gather": (patches_cuda.counts, patches_cuda.reset_counts),
            "fast9_nms": (fast_cuda.counts, fast_cuda.reset_counts),
            **{name: (c, sgm_cuda.reset_counts) for name, c in sgm_cuda.counts.items()}}


def kernel_counts(names=KERNELS) -> dict:
    """Launches of the port's hand-written kernels (``kernel``) and calls of
    their plain versions (``plain``, CPU tensors) so far, for each of
    ``names``."""
    tables = _count_tables()
    return {name: dict(tables[name][0]) for name in names}


def counts_since(before: dict) -> dict:
    """:func:`kernel_counts` of the same kernels minus an earlier snapshot."""
    now = kernel_counts(tuple(before))
    return {k: {r: now[k][r] - before[k][r] for r in ("kernel", "plain")} for k in now}


def reset_kernel_counts(names=KERNELS) -> None:
    """Set the counts of ``names`` to 0 (the two SGM kernels share one reset)."""
    tables = _count_tables()
    for reset in {tables[name][1] for name in names}:
        reset()


@dataclass
class TraceWindow:
    """What :func:`torch_trace` read from its window, filled on exit.

    ``launches`` counts the host's kernel-launch calls (:data:`LAUNCH_CALLS`),
    ``device_ms`` sums the durations of the CUDA kernels (copies, memsets
    and named ranges left out; kernels that overlap count twice), ``path``
    is the Chrome trace written into the log directory.
    """

    launches: int = 0
    device_ms: float = 0.0
    path: str | None = None


@contextlib.contextmanager
def torch_trace(log_dir: str, cuda: bool | None = None):
    """Capture a torch.profiler trace (CPU and CUDA activities) around a block.

    Port of the reference's ``jax_trace``. Yields a :class:`TraceWindow`;
    on exit every visible device is synchronized, the trace is written as
    Chrome JSON into ``log_dir`` (open it in Perfetto or chrome://tracing)
    and the window's launches and device-busy ms are filled in. ``cuda``
    (default: whether a CUDA device is visible) adds the CUDA activity;
    without it the window reports 0 device ms.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() if cuda is None else cuda
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    window = TraceWindow()
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield window
        finally:
            if cuda:  # the traced work may run on any device
                for index in range(torch.cuda.device_count()):
                    torch.cuda.synchronize(index)
    events = list(prof.events())
    window.launches = sum(1 for e in events if e.device_type == DeviceType.CPU and e.name in LAUNCH_CALLS)
    kernels = [
        e for e in events
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
        and not e.name.startswith(("Memcpy", "Memset"))
    ]
    window.device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    window.path = os.path.join(log_dir, f"trace_{os.getpid()}_{next(_trace_ids)}.json")
    prof.export_chrome_trace(window.path)
