"""Observability: rate counters, stage timers, status lines, profiler hooks,
and an in-process tracer of spans.

A copy of :mod:`thor_slam_tpu.utils.profiling` (the operator status line,
per-stage EMA timers and structured snapshots) whose profiler hook is
:func:`torch_trace`, the counterpart of the reference's ``jax_trace``.

The tracer (:func:`span`, :func:`tracing`, :func:`spans`) records named
spans at the port's layer boundaries, on the host clock
``time.perf_counter_ns()``, into a bounded ring. Off (the default), a span
is a shared null context after one global check. On, each span keeps its
thread, its enclosing span, its tick and its attributes; under an active
``torch.profiler`` it also opens a ``thor/<name>`` range, so that the
device's work lies beneath it in every exported trace; and on a CUDA build
every synchronizing call (``torch.cuda.set_sync_debug_mode("warn")``) is
counted on the innermost open span of its thread.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
import warnings
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
            with span(f"pipeline.{self.name}"):
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


# ------------------------------------------------------------------ tracer

#: The text of the warning ``torch.cuda.set_sync_debug_mode("warn")`` raises
#: on every synchronizing call (a blocking copy between host and device,
#: ``.item()``, ``.tolist()``, ``.cpu()``, a stream synchronize); a CUDA
#: event's ``synchronize()`` raises none.
SYNC_WARNING = "called a synchronizing CUDA operation"
#: Finished spans the ring holds; the oldest beyond it are dropped, and counted.
SPAN_CAPACITY = 1_000_000


class Span:
    """One span of the program's work, and the context manager that times it.

    ``t0`` / ``t1`` are ``time.perf_counter_ns()`` (the host clock the
    benchmark times its calls with, in ns); ``index`` is unique in the process and
    ``parent`` is the index of the span that enclosed this one on its
    ``thread`` (None for a root); ``tick`` is the engine's dispatch
    sequence number of the tick the work belongs to (inherited from the
    parent unless given); ``kind`` is ``"work"``, or ``"wait"`` where the
    host blocks on the device or on another thread; ``syncs`` counts the
    synchronizing calls made while this was the innermost open span.
    """

    __slots__ = ("index", "name", "t0", "t1", "thread", "parent", "tick", "kind", "attrs", "syncs", "_ranged")

    def __init__(self, name: str, kind: str = "work", tick: int | None = None, attrs: dict | None = None, *,
                 index: int = -1, t0: int = 0, t1: int = 0, thread: int = 0, parent: int | None = None,
                 syncs: int = 0) -> None:
        self.name, self.kind, self.tick, self.attrs = name, kind, tick, {} if attrs is None else attrs
        self.index, self.t0, self.t1, self.thread, self.parent, self.syncs = index, t0, t1, thread, parent, syncs
        self._ranged = None

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.kind!r}, tick={self.tick}, attrs={self.attrs}, index={self.index}, "
                f"parent={self.parent}, thread={self.thread}, ms={self.ms:.3f}, syncs={self.syncs})")

    def __enter__(self) -> Span:
        stack = _tracer.stack()
        if stack:
            parent = stack[-1]
            self.parent = parent.index
            if self.tick is None:
                self.tick = parent.tick
        self.index = next(_tracer.ids)
        self.thread = threading.get_ident()
        stack.append(self)
        if _tracer.profiler_enabled():
            self._ranged = _tracer.record_function(f"thor/{self.name}")
            self._ranged.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        if self._ranged is not None:
            self._ranged.__exit__(*exc)
            self._ranged = None
        stack = _tracer.stack()
        if stack and stack[-1] is self:
            stack.pop()
        _tracer.keep(self)
        return False


class _NullSpan:
    """The span while the tracer is off: enters to None, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Tracer:
    """The process's spans and synchronizing-call counter (one instance,
    driven through the module's functions)."""

    def __init__(self, capacity: int = SPAN_CAPACITY) -> None:
        self.on = False
        self.ring: deque[Span] = deque(maxlen=capacity)
        self.dropped = 0
        self.ids = itertools.count()
        self.lock = threading.Lock()
        self.local = threading.local()
        self.profiler_enabled = None  # torch.autograd._profiler_enabled, bound when turned on
        self.record_function = None
        self._sync_filter = None  # what start() changed, for stop() to restore
        self._shown = None
        self._mode = None

    def stack(self) -> list[Span]:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def keep(self, rec: Span) -> None:
        with self.lock:
            if len(self.ring) == self.ring.maxlen:
                self.dropped += 1
            self.ring.append(rec)

    def start(self) -> None:
        import torch

        self.profiler_enabled = torch.autograd._profiler_enabled
        self.record_function = torch.profiler.record_function
        warnings.filterwarnings("always", message=SYNC_WARNING)
        self._sync_filter, self._shown = warnings.filters[0], warnings.showwarning
        warnings.showwarning = self._show
        if torch.cuda.is_available():  # a CPU build raises on the mode
            self._mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        self.on = True

    def stop(self) -> None:
        self.on = False
        if self._mode is not None:
            import torch

            torch.cuda.set_sync_debug_mode(self._mode)
            self._mode = None
        if warnings.showwarning == self._show:  # a warnings context may have restored it already
            warnings.showwarning = self._shown
        if self._sync_filter in warnings.filters:
            warnings.filters.remove(self._sync_filter)
            warnings._filters_mutated()
        self._sync_filter = self._shown = None

    def _show(self, message, category, filename, lineno, file=None, line=None):
        """``warnings.showwarning`` while on: counts the sync warning on the
        innermost open span of the calling thread (outside every span it is
        neither counted nor shown), shows every other."""
        if not str(message).startswith(SYNC_WARNING):
            (self._shown or warnings._showwarning_orig)(message, category, filename, lineno, file, line)
            return
        stack = self.stack()
        if stack:
            stack[-1].syncs += 1


_tracer = _Tracer()


def span(name: str, kind: str = "work", tick: int | None = None, **attrs):
    """A context manager around one piece of the program's work.

    Off, the shared null context (entered, it gives None). On, a new
    :class:`Span`, kept in the ring when it exits.
    ``kind="wait"`` marks the host blocking on the device or another thread.
    """
    if not _tracer.on:
        return _NULL_SPAN
    return Span(name, kind, tick, attrs)


def annotate(**attrs) -> None:
    """Add attributes to the innermost open span of this thread (no-op off)."""
    if not _tracer.on:
        return
    stack = _tracer.stack()
    if stack:
        stack[-1].attrs.update(attrs)


def tracing(on: bool) -> None:
    """Turn the tracer on or off. On, and where CUDA is available, the
    synchronizing calls are counted (the sync-debug mode is set to
    ``"warn"`` and its warning is counted instead of shown); off restores
    the mode, ``warnings.showwarning`` and the warning filters."""
    if bool(on) == _tracer.on:
        return
    if on:
        _tracer.start()
    else:
        _tracer.stop()


def spans() -> list[Span]:
    """The finished spans in the ring, in the order they ended."""
    with _tracer.lock:
        return list(_tracer.ring)


def dropped() -> int:
    """The spans the full ring let go since the last :func:`clear` (what is
    left of a tick may then read short)."""
    with _tracer.lock:
        return _tracer.dropped


def clear() -> None:
    """Empty the ring and zero its counts (open spans are kept when they end)."""
    with _tracer.lock:
        _tracer.ring.clear()
        _tracer.dropped = 0
