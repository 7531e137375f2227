"""The readers of the program's spans, on a fake run with planted spans:
each gives its exact value, takes only the untraced window ticks, and
reads nothing from a program without a tracer."""

from types import SimpleNamespace

import pytest

from benchmark.core import program_spans, spec
from thor_slam_tpu_torch.utils import profiling

MS = 1_000_000  # ns
READERS = ("tick_dispatch_ms", "pnp_host_ms", "keyframe_host_ms", "host_wait_ms", "syncs_per_tick", "ba_solve_ms",
           "loop_host_ms")


class Planter:
    """Spans on a fake clock: ``at`` and ``dur`` in ms from 100 s."""

    def __init__(self):
        self.spans, self.ids = [], 0

    def add(self, name, at, dur, parent=None, thread=1, tick=None, kind="work", syncs=0, **attrs):
        t0 = 100 * 10**9 + int(at * MS)
        s = profiling.Span(name, kind, tick if tick is not None or parent is None else parent.tick, attrs,
                           index=self.ids, t0=t0, t1=t0 + int(dur * MS), thread=thread,
                           parent=None if parent is None else parent.index, syncs=syncs)
        self.ids += 1
        self.spans.append(s)
        return s


def _run(calls):
    """A run's window calls (all a reader of program spans reads of it)."""
    return SimpleNamespace(calls=[dict(k=k, t0=100 + a / 1e3, t1=100 + b / 1e3, traced=traced, lost=False,
                                       keyframe=False) for k, (a, b, traced) in enumerate(calls)])


def _tick(p, at, tick, dispatch, pnp, keyframe=None, waits=(), syncs=(0, 0), ba=None, loop=()):
    """A tick at ``at`` ms: dispatch holding PnP (and a keyframe), wait
    spans after it, BA and loop spans of an earlier keyframe tick."""
    root = p.add("engine.process_frames", at, 100, tick=tick, syncs=syncs[0])
    d = p.add("engine.dispatch", at + 1, dispatch, parent=root)
    p.add("tracker.pnp", at + 2, pnp, parent=d, syncs=syncs[1])
    if keyframe is not None:
        p.add("tracker.keyframe", at + 3 + pnp, keyframe, parent=d)
    t = at + 2 + dispatch
    for w in waits:
        p.add("engine.fetch_wait", t, w, parent=root, kind="wait", tick=tick - 1)
        t += w + 0.5
    if ba is not None:
        solved, ms = ba
        p.add("backend.ba", t, ms, parent=root, tick=tick - 1, solved=solved, skip=None)
        t += ms + 0.5
    for ms in loop:
        p.add("backend.loop", t, ms, parent=root, tick=tick - 1, stage="find")
        t += ms + 0.5
    return root


@pytest.fixture
def planted(monkeypatch):
    p = Planter()
    # Window calls 0, 1 and 3 untraced; call 2 profiled; a span outside any call.
    _tick(p, 0, 0, dispatch=60, pnp=40, waits=(2.0,), syncs=(1, 6), ba=(True, 20), loop=(1.5,))
    _tick(p, 200, 1, dispatch=70, pnp=44, keyframe=10, waits=(1.0, 3.0), syncs=(0, 7), ba=(False, 0.25))
    _tick(p, 400, 2, dispatch=30, pnp=20, keyframe=5, waits=(9.0,), syncs=(9, 9), ba=(True, 40), loop=(9,))
    _tick(p, 600, 3, dispatch=50, pnp=36, keyframe=20, syncs=(2, 6), ba=(True, 30), loop=(0.5, 2.5))
    _tick(p, 800, 4, dispatch=60, pnp=40, keyframe=10, syncs=(9, 9))
    # A nested wait counts once; a span of another thread inside a tick is not the tick's.
    inner = [s for s in p.spans if s.name == "engine.fetch_wait"][0]
    p.add("tracker.refresh_readback", inner.t0 / MS - 100_000 + 0.1, 0.5, parent=inner, kind="wait")
    p.add("engine.upload_wait", 650, 5, thread=2, kind="wait", tick=3)
    run = _run([(-1, 101, False), (199, 301, False), (399, 501, True), (599, 701, False)])
    monkeypatch.setattr(profiling, "spans", lambda: list(p.spans))
    return run


def _read(name, run):
    return spec.reader(name).read(run)


def test_window_ticks_are_the_untraced_calls(planted):
    ticks = program_spans.window_ticks(planted)
    assert [t.root.tick for t in ticks] == [0, 1, 3]
    assert all(s.thread == 1 for t in ticks for s in t.inside)


def test_each_reader_gives_its_exact_value(planted):
    assert _read("tick_dispatch_ms", planted) == pytest.approx((60 + 70 + 50) / 3)
    assert _read("pnp_host_ms", planted) == pytest.approx((40 + 44 + 36) / 3)
    assert _read("keyframe_host_ms", planted) == pytest.approx((10 + 20) / 2)
    assert _read("host_wait_ms", planted) == pytest.approx((2.0 + 4.0 + 0.0) / 3)
    assert _read("syncs_per_tick", planted) == pytest.approx((7 + 7 + 8) / 3)
    assert _read("ba_solve_ms", planted) == pytest.approx(25.0)  # median of the solved 20 and 30
    assert _read("loop_host_ms", planted) == pytest.approx((1.5 + 0 + 3.0) / 3)


def test_nothing_to_read_without_window_ticks_or_a_tracer(planted, monkeypatch):
    empty = _run([])
    assert all(_read(name, empty) is None for name in READERS)
    monkeypatch.delattr(profiling, "tracing")  # a program without the tracer
    assert all(_read(name, planted) is None for name in READERS)



def test_nothing_to_read_when_the_ring_dropped_spans(planted, monkeypatch):
    monkeypatch.setattr(profiling, "dropped", lambda: 1)  # a wrapped ring: ticks could read short
    assert program_spans.window_ticks(planted) == []
    assert all(_read(name, planted) is None for name in READERS)
