"""The program's own spans in a traced run, joined to the window's ticks.

The program records spans at its layer boundaries with the tracer of
``thor_slam_tpu_torch.utils.profiling`` (``span``, ``tracing``, ``spans``),
on the clock the benchmark times its calls with (``time.perf_counter``,
kept in ns). A reader of a ``program_span`` or ``program_counter`` metric
calls :func:`turn_on` when it is imported. Only a traced run imports the
per-layer readers (``spec.metrics_for``), so the untraced runs, which
measure the end-to-end metrics, never turn the tracer on. A program
without the tracer turns nothing on, and its readers read nothing.

:func:`window_ticks` gives the window's ticks outside the profiled
stretch: each ``engine.process_frames`` span that starts inside an untraced
call of ``run.calls`` (the calls ``engine_call_ms`` reads), with every span
its thread ran inside it.
"""

from __future__ import annotations

import bisect
import statistics
from dataclasses import dataclass, field

#: The span around each ``TorchSlamEngine.process_frames`` call: one tick.
ROOT = "engine.process_frames"


def _profiling():
    """The program's profiling module, or None where it has no tracer."""
    try:
        from thor_slam_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "tracing") else None


def turn_on() -> None:
    prof = _profiling()
    if prof is not None:
        prof.tracing(True)


@dataclass
class Tick:
    """One window tick: its root span and the spans of its thread inside it."""

    root: object
    inside: list = field(default_factory=list)

    def named(self, name: str) -> list:
        return [s for s in self.inside if s.name == name]

    def ms(self, name: str) -> float:
        """Host ms of the tick's spans called ``name``."""
        return sum(s.ms for s in self.named(name))

    def wait_ms(self) -> float:
        """Host ms of the tick's ``wait`` spans (a wait inside a wait counts once)."""
        waits = {s.index for s in self.inside if s.kind == "wait"}
        return sum(s.ms for s in self.inside if s.kind == "wait" and s.parent not in waits)

    @property
    def syncs(self) -> int:
        return self.root.syncs + sum(s.syncs for s in self.inside)


def window_ticks(run) -> list[Tick]:
    """The window's untraced ticks, in order; empty without program spans,
    and empty where the program's ring dropped spans (a tick would read
    short), so that the metrics are left out rather than wrong."""
    prof = _profiling()
    if prof is None or prof.dropped():
        return []
    return join(prof.spans(), run)


def join(spans: list, run) -> list[Tick]:
    calls = sorted((c["t0"], c["t1"]) for c in run.calls if not c["traced"])
    starts = [t0 for t0, _ in calls]

    def in_call(s) -> bool:
        i = bisect.bisect_right(starts, s.t0 / 1e9) - 1
        return i >= 0 and s.t1 / 1e9 <= calls[i][1]

    ticks = sorted((Tick(s) for s in spans if s.name == ROOT and in_call(s)), key=lambda t: t.root.t0)
    by_thread: dict[int, list[Tick]] = {}
    for t in ticks:
        by_thread.setdefault(t.root.thread, []).append(t)
    firsts = {th: [t.root.t0 for t in ts] for th, ts in by_thread.items()}
    for s in spans:
        ts = by_thread.get(s.thread)
        if s.name == ROOT or ts is None:
            continue
        i = bisect.bisect_right(firsts[s.thread], s.t0) - 1
        if i >= 0 and s.t1 <= ts[i].root.t1:
            ts[i].inside.append(s)
    return ticks


def mean(values: list) -> float | None:
    return float(statistics.fmean(values)) if values else None


def median(values: list) -> float | None:
    return float(statistics.median(values)) if values else None
