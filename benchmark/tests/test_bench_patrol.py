"""The patrol cell (``oak4-640x400-patrol.orbit-loop``) on the CPU.

* Its files resolve by name: the configuration (D's ``engine`` and ``slam``
  blocks, no loop parameter overridden, no RGB-D or map), the lap rig, the
  mix with its lights-out, the limits; the two per-layer metrics list it
  alone, and the pose latency covers it.
* The readers ``posegraph_solve_ms`` and ``relock_ticks`` on a fake run
  with planted spans: each exact value, and nothing to read where the
  window solved no graph, holds no lights-out, never came back to
  ``TRACKING``, or where the program's spans carry neither (the parent's).
"""

import pytest

from benchmark.core import spec
from benchmark.tests.test_bench_program_spans import Planter, _run
from thor_slam_tpu_torch.utils import profiling

CELL = "oak4-640x400-patrol.orbit-loop"
CONFIG = "oak4-640x400-patrol"


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_the_cells_files_resolve(bench):
    cell = spec.cell(CELL, bench)
    assert cell["config"] == CONFIG and cell["chips"] == 1
    cfg, deployed = spec.config(CONFIG, bench), spec.config("oak4-640x400-deployed", bench)
    assert cfg["engine"] == deployed["engine"] and cfg["slam"] == deployed["slam"]
    assert not any(k.startswith("loop_") for k in cfg["engine"]) and "rgbd" not in cfg and "mapping" not in cfg
    assert cfg["reduced"] == [] and cfg["rig"]["builder"] == "orbit_lap"
    assert {k: v for k, v in cfg["rig"].items() if k not in ("builder", "lap_frames", "orbit")} == \
        {k: v for k, v in deployed["rig"].items() if k not in ("builder", "orbit")}
    assert callable(spec.rig_builder("orbit_lap").build)
    mix = spec.traffic(cell["traffic"])
    assert mix["generator"] == "newest_wins" and mix["cycle_frames"] == cfg["rig"]["lap_frames"] == 628
    assert mix["blackout_s"] == [12.0, 13.0] and not mix["rgbd_every"] and not mix["map"]
    assert set(spec.limits(CELL)) == {"rpe_med_mrad", "rpe_med_mm", "steps_off_pct", "rpe_mm"}
    traced = {m["name"] for m in spec.metrics_for(CELL, bench, trace=True)}
    assert {"posegraph_solve_ms", "relock_ticks"} <= traced
    for name in ("posegraph_solve_ms", "relock_ticks"):
        m = next(m for m in bench["per_layer"] if m["name"] == name)
        assert m["workloads"] == [CELL]
    assert "pose_latency_p95_ms" in {m["name"] for m in spec.metrics_for(CELL, bench, trace=False)}


def _planted(monkeypatch, ticks, k0=0):
    """One call after another from tick ``k0`` on: ``ticks[i]`` is (state,
    its ``loop.posegraph`` ms or None, traced); the state None leaves the
    attribute out, as a program without it does."""
    p = Planter()
    calls, at = [], 0.0
    for i, (state, solve_ms, traced) in enumerate(ticks):
        attrs = {} if state is None else {"state": state}
        dur = 30 + (solve_ms or 0)
        root = p.add("engine.process_frames", at, dur, tick=i, **attrs)
        if solve_ms is not None:
            stage = p.add("backend.loop", at + 2, solve_ms + 1, parent=root, tick=i - 1, stage="posegraph")
            p.add("loop.posegraph", at + 2.5, solve_ms, parent=stage, nodes=64, edges=64)
        calls.append((at - 1, at + dur + 1, traced))
        at += dur + 10
    monkeypatch.setattr(profiling, "spans", lambda: list(p.spans))
    run = _run(calls)
    for i, c in enumerate(run.calls):
        c["k"] = k0 + i
    run.traffic = {"fps": 30, "blackout_s": [12.0, 13.0]}
    return run


def _read(name, run):
    return spec.reader(name).read(run)


T, L, R = "TRACKING", "LOST", "RELOCALIZING"


@pytest.mark.parametrize("solves, mean", [
    ((None, 400.0, None, 500.0, None), 450.0),
    ((None, 400.0, 9999.0, 500.0), 450.0),  # the profiled tick 2 is not read
    ((None, None, None), None),  # a window with no solve reads nothing, not 0
])
def test_posegraph_solve_ms(monkeypatch, solves, mean):
    run = _planted(monkeypatch, [(T, ms, i == 2 and ms == 9999.0) for i, ms in enumerate(solves)])
    got = _read("posegraph_solve_ms", run)
    assert got == (None if mean is None else pytest.approx(mean))


# Call i shows frame k0 + i; the lights-out's frames are 360-389 (12-13 s
# at 30 fps), its first lit frame 390.
OUT = [T] * 5 + [L, R] * 15  # frames k0 .. k0 + 34 from k0 = 355: dark at 360-389


@pytest.mark.parametrize("k0, states, ticks", [
    (355, OUT + [L, R, L, R, L, R, T, T], 6.0),  # back at frame 396
    (355, OUT + [T, T], 0.0),  # back at the first lit frame
    (355, [T] * 5 + [T, T, T, L] + [R] * 26 + [T], 0.0),  # left three frames in
    (355, [T] * 40, 0.0),  # tracking held through it
    (355, OUT + [L, R, L, R], None),  # not back in the window
    (300, [T] * 5, None),  # no lights-out in the window
    (400, [T, L, T], None),  # the window opened after it
    (355, [None] * 40, None),  # a program without the state
])
def test_relock_ticks(monkeypatch, k0, states, ticks):
    run = _planted(monkeypatch, [(s, None, False) for s in states], k0=k0)
    assert _read("relock_ticks", run) == ticks


def test_relock_counts_the_window_ticks_and_skips_the_profiled(monkeypatch):
    # Frames dropped by the camera clock: the reading is the frame the state
    # came back on, less the first lit frame, however many calls lie between;
    # the profiled call (traced) is not read, so the next call's frame counts.
    run = _planted(monkeypatch, [(T, None, False), (T, None, False), (L, None, False), (R, None, False),
                                 (T, None, True), (T, None, False)], k0=357)
    for c, k in zip(run.calls, (357, 360, 375, 388, 395, 399)):
        c["k"] = k
    assert _read("relock_ticks", run) == 9.0


def test_nothing_to_read_without_a_tracer(monkeypatch):
    run = _planted(monkeypatch, [(T, 400.0, False), (L, None, False), (T, None, False)], k0=359)
    run.calls[2]["k"] = 392
    monkeypatch.delattr(profiling, "tracing")
    assert _read("posegraph_solve_ms", run) is None and _read("relock_ticks", run) is None
