"""The reader of ``ba_graph_replay_pct`` on a fake run with planted spans:
the share of the solved ``backend.ba`` spans of the untraced window ticks
that replayed, and nothing to read where no span carries ``graph`` or no
span solved."""

import pytest

from benchmark.core import spec
from benchmark.tests.test_bench_program_spans import Planter, _run
from thor_slam_tpu_torch.utils import profiling


def _planted(monkeypatch, solves):
    """One tick every 200 ms, its ``backend.ba`` span ``solved`` where
    ``solves[i]`` is not False, tagged ``graph=solves[i]`` where it is a
    string; call 2 is profiled, the rest untraced."""
    p = Planter()
    for i, mode in enumerate(solves):
        root = p.add("engine.process_frames", 200 * i, 100, tick=i)
        attrs = {"graph": mode} if isinstance(mode, str) else {}
        p.add("backend.ba", 200 * i + 50, 20, parent=root, tick=i - 1, solved=mode is not False, **attrs)
    monkeypatch.setattr(profiling, "spans", lambda: list(p.spans))
    return _run([(200 * i - 1, 200 * i + 101, i == 2) for i in range(len(solves))])


def _read(run):
    return spec.reader("ba_graph_replay_pct").read(run)


@pytest.mark.parametrize("solves, share", [
    (("replay",) * 5, 100.0),
    (("replay", "eager", "capture", "replay", "replay"), 75.0),  # the profiled tick 2 is not read
    (("replay", "replay", "replay", False, "replay"), 100.0),  # a span that stopped before the solve is not read
    ((None, None, None, None), None),  # a program that tags no span (the parent)
    ((False, False, "replay", False), None),  # no solved span in the window
])
def test_share_of_solved_spans_that_replayed(monkeypatch, solves, share):
    got = _read(_planted(monkeypatch, solves))
    assert got == (None if share is None else pytest.approx(share))


def test_nothing_to_read_without_a_tracer(monkeypatch):
    run = _planted(monkeypatch, ("replay",) * 3)
    monkeypatch.delattr(profiling, "tracing")
    assert _read(run) is None
