"""The reader of ``pnp_graph_replay_pct`` on a fake run with planted spans:
nothing to read where no ``tracker.pnp`` span carries ``graph``, and the
share of the untraced window ticks that replayed where they do."""

import pytest

from benchmark.core import spec
from benchmark.tests.test_bench_program_spans import Planter, _run
from thor_slam_tpu_torch.utils import profiling


def _planted(monkeypatch, modes):
    """One tick every 200 ms, its ``tracker.pnp`` span tagged ``modes[i]``
    (no attribute where None); call 2 is profiled, the rest untraced."""
    p = Planter()
    for i, mode in enumerate(modes):
        root = p.add("engine.process_frames", 200 * i, 100, tick=i)
        d = p.add("engine.dispatch", 200 * i + 1, 60, parent=root)
        attrs = {} if mode is None else {"graph": mode}
        p.add("tracker.pnp", 200 * i + 2, 2, parent=d, **attrs)
    monkeypatch.setattr(profiling, "spans", lambda: list(p.spans))
    return _run([(200 * i - 1, 200 * i + 101, i == 2) for i in range(len(modes))])


def _read(run):
    return spec.reader("pnp_graph_replay_pct").read(run)


@pytest.mark.parametrize("modes, share", [
    ((None, None, None, None), None),  # a program that tags no span (the parent)
    (("replay",) * 4, 100.0),
    (("capture", "replay", "eager", "replay"), 200.0 / 3),  # the profiled tick 2 is not read
    (("eager", "eager", "replay", "eager"), 0.0),
])
def test_share_of_window_ticks_that_replayed(monkeypatch, modes, share):
    got = _read(_planted(monkeypatch, modes))
    assert got == (None if share is None else pytest.approx(share))


def test_nothing_to_read_without_a_tracer(monkeypatch):
    run = _planted(monkeypatch, ("replay",) * 3)
    monkeypatch.delattr(profiling, "tracing")
    assert _read(run) is None
