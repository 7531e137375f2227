"""The reader of ``tick_graph_replay_pct`` on a fake run with planted
spans: nothing to read where no ``tracker.front`` or ``tracker.back`` span
carries ``graph``, and the share of the untraced window ticks whose two
segments both replayed where they do."""

import pytest

from benchmark.core import spec
from benchmark.tests.test_bench_program_spans import Planter, _run
from thor_slam_tpu_torch.utils import profiling


def _planted(monkeypatch, modes):
    """One tick every 200 ms with ``tracker.front``, ``tracker.pnp`` and
    ``tracker.back`` spans, the two segments tagged ``modes[i]`` (front,
    back; no attribute where None, no span where the pair is None); call 2
    is profiled, the rest untraced."""
    p = Planter()
    for i, pair in enumerate(modes):
        root = p.add("engine.process_frames", 200 * i, 100, tick=i)
        d = p.add("engine.dispatch", 200 * i + 1, 60, parent=root)
        p.add("tracker.pnp", 200 * i + 12, 2, parent=d, graph="replay")
        if pair is None:
            continue
        for name, mode, start in zip(("tracker.front", "tracker.back"), pair, (2, 20)):
            p.add(name, 200 * i + start, 8, parent=d, **({} if mode is None else {"graph": mode}))
    monkeypatch.setattr(profiling, "spans", lambda: list(p.spans))
    return _run([(200 * i - 1, 200 * i + 101, i == 2) for i in range(len(modes))])


def _read(run):
    return spec.reader("tick_graph_replay_pct").read(run)


R, C, E = "replay", "capture", "eager"


@pytest.mark.parametrize("modes, share", [
    ((None,) * 4, None),  # a program without the segments' spans (the parent)
    (((None, None),) * 4, None),  # spans that carry no graph
    (((R, R),) * 4, 100.0),
    (((C, C), (R, R), (E, E), (R, R)), 200.0 / 3),  # the profiled tick 2 is not read
    (((R, C), (C, R), (R, R), (R, E)), 0.0),  # both segments must have replayed
    (((E, E),) * 4, 0.0),
])
def test_share_of_window_ticks_that_replayed(monkeypatch, modes, share):
    got = _read(_planted(monkeypatch, modes))
    assert got == (None if share is None else pytest.approx(share))


def test_nothing_to_read_without_a_tracer(monkeypatch):
    run = _planted(monkeypatch, ((R, R),) * 3)
    monkeypatch.delattr(profiling, "tracing")
    assert _read(run) is None
