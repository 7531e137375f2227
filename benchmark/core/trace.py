"""The traced run: torch.profiler over a bounded stretch of the window.

The profile covers ``trace_ticks`` processed ticks and is kept in memory;
only its reduction leaves this module. Around each call into a layer the
driver opens a span (``record_function``) with the layer's name, so that
the device's idle gaps can be labelled by what the host was doing. While
the profile runs, the launchers named by the traced metrics' readers
(``LAUNCHERS``: a program function and the bytes one of its launches
moves) are wrapped to log those bytes.
"""

from __future__ import annotations

import contextlib
import importlib
from dataclasses import dataclass, field

#: Host runtime calls that launch work on the device (a graph launch counts once).
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch")
#: The driver's spans, one per layer it calls into.
SPANS = ("engine", "rgbd", "mapper", "traffic")


@dataclass
class TraceSummary:
    """What the profile showed. Times in seconds; ``ops`` are the device's
    operations as (name, start_s, end_s) inside the traced window."""

    window_s: float
    busy_s: float
    launches: int
    ticks: int
    ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)  # (label, seconds), longest first

    def seconds(self, *substrings: str) -> float:
        """Device seconds of the operations whose name holds any of ``substrings``."""
        return sum(e - s for n, s, e in self.ops if any(k in n for k in substrings))

    def top_ops(self, k: int = 10) -> list:
        """The ``k`` operations that took most device time, by name (cut to
        160 characters: templated kernel names run long)."""
        by_name: dict[str, float] = {}
        for n, s, e in self.ops:
            n = n.removeprefix("void ")[:160]
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        return sorted(([n, v] for n, v in by_name.items()), key=lambda x: -x[1])[:k]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, ticks: int) -> TraceSummary:
    """Reduce profiler events: device busy time (the union of the device's
    operations), launches, and the idle gaps labelled by the innermost
    driver span that covers each gap's midpoint."""
    from torch.autograd import DeviceType

    spans = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
             for e in events if e.device_type == DeviceType.CPU and e.name in SPANS]
    if not spans:
        return TraceSummary(0.0, 0.0, 0, ticks)
    w0, w1 = min(s for _, s, _ in spans), max(e for _, _, e in spans)
    ops = [
        (e.name, max(e.time_range.start / 1e6, w0), min(e.time_range.end / 1e6, w1))
        for e in events
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
        and e.time_range.end / 1e6 > w0 and e.time_range.start / 1e6 < w1
    ]
    launches = sum(1 for e in events if e.device_type == DeviceType.CPU and e.name in LAUNCH_CALLS
                   and w0 <= e.time_range.start / 1e6 <= w1)
    busy = _merge([(s, e) for _, s, e in ops])
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))

    def label(mid):
        inside = [(s, n) for n, s, e in spans if s <= mid <= e]
        return max(inside)[1] if inside else "harness"

    labelled = sorted(([label(0.5 * (s + e)), e - s] for s, e in gaps), key=lambda x: -x[1])
    return TraceSummary(w1 - w0, sum(e - s for s, e in busy), launches, ticks, ops, labelled)


class LaunchBytes:
    """Wraps the launchers a set of metric readers name and logs, per
    reader, the bytes each launch moves while :attr:`on` is set."""

    def __init__(self, readers: dict):
        self.on = False
        self.log: dict[str, list[float]] = {name: [] for name, r in readers.items() if hasattr(r, "LAUNCHERS")}
        self._undo = []
        for name, r in readers.items():
            for target, nbytes in getattr(r, "LAUNCHERS", {}).items():
                module_name, attr = target.rsplit(".", 1)
                module = importlib.import_module(module_name)
                inner = getattr(module, attr)
                setattr(module, attr, self._wrap(inner, name, nbytes))
                self._undo.append((module, attr, inner))

    def _wrap(self, inner, name, nbytes):
        def launcher(*args, **kwargs):
            if self.on:
                self.log[name].append(float(nbytes(*args, **kwargs)))
            return inner(*args, **kwargs)

        return launcher

    def restore(self) -> None:
        for module, attr, inner in reversed(self._undo):
            setattr(module, attr, inner)
        self._undo.clear()


class Profiler:
    """Starts and stops torch.profiler; :meth:`span` labels host work."""

    def __init__(self, readers: dict, cuda: bool):
        self.bytes = LaunchBytes(readers)
        self.cuda = cuda
        self._prof = None
        self._stopped = None  # (profile, ticks) until :meth:`finish` reduces it
        self.summary: TraceSummary | None = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    @property
    def done(self) -> bool:
        return self._stopped is not None or self.summary is not None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.bytes.on = True

    def stop(self, ticks: int) -> None:
        """End the profile; its events are reduced later, by :meth:`finish`."""
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.bytes.on = False
        self._prof.__exit__(None, None, None)
        self._stopped, self._prof = (self._prof, ticks), None

    def finish(self) -> None:
        if self._stopped is not None:
            prof, ticks = self._stopped
            self._stopped = None
            self.summary = summarize(prof.events(), ticks)

    def span(self, name: str):
        if self._prof is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)
