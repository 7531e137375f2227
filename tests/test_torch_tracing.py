"""The port's in-process tracer (``utils/profiling``: ``span``, ``tracing``,
``spans``) and the spans the engine, the tracker and the backends record.

* Off, a span is the shared null context and records nothing.
* On, spans nest per thread with their parents and ticks, the ring drops
  its oldest spans and counts them, and under ``torch.profiler`` each span
  is a ``thor/<name>`` range of the trace.
* The sync-debug warning is counted on the innermost open span, and turning
  the tracer off restores the warning machinery (and, on a card, the mode).
* Through the engine (synchronous, pipelined at depth 1 and 6): one
  ``engine.dispatch`` per call, every dispatched tick fetched and finalized
  once, one ``tracker.keyframe`` per keyframe tick, BA spans with their skip
  reasons and how the solve ran; and the engine's outputs are bit for bit those of an untraced run.
* Through a revisit orbit with a blackout: each loop-closure stage's outcome on its
  ``backend.loop`` span, the ``loop.posegraph`` span of each solve, and the tracking state each
  call left on ``engine.process_frames``.

This file imports no JAX: on a card, ``python -m pytest
tests/test_torch_tracing.py --noconftest -m cuda`` runs the card's case.
"""

from __future__ import annotations

import json
import threading
import warnings
from collections import Counter, deque

import numpy as np
import pytest
import torch

import chip_smoke
from thor_slam_tpu_torch.camera.rig import CameraRig
from thor_slam_tpu_torch.camera.sources.synthetic import (
    OrbitTrajectory,
    SyntheticRigSpec,
    SyntheticWorld,
    make_synthetic_rig,
)
from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
from thor_slam_tpu_torch.slam.interface import SlamConfig
from thor_slam_tpu_torch.utils import profiling

torch.set_num_threads(2)

TICKS = 30


@pytest.fixture
def tracer():
    """The tracer on over an empty ring; off and empty again afterwards."""
    profiling.tracing(False)
    profiling.clear()
    profiling.tracing(True)
    try:
        yield profiling
    finally:
        profiling.tracing(False)
        profiling.clear()


def _by_name(spans):
    return {s.name: s for s in spans}


# ------------------------------------------------------------ the tracer


def test_off_is_the_shared_null_context():
    was = profiling._tracer.on  # another test module may have turned it on
    profiling.tracing(False)
    profiling.clear()
    try:
        first, second = profiling.span("a"), profiling.span("b", kind="wait", tick=3, x=1)
        assert first is second
        with first as entered:
            assert entered is None
            profiling.annotate(y=2)
        assert profiling.spans() == [] and profiling.dropped() == 0
    finally:
        profiling.tracing(was)


def test_nesting_parents_ticks_and_threads(tracer):
    with tracer.span("root", tick=7, frame_ts=1.5) as root:
        tracer.annotate(light=True)
        with tracer.span("child") as child:
            with tracer.span("leaf", kind="wait"):
                pass
        with tracer.span("other", tick=3):
            pass
    seen = {}

    def worker():
        with tracer.span("thread_root", tick=11):
            with tracer.span("thread_child"):
                seen["thread"] = threading.get_ident()

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    s = _by_name(tracer.spans())
    assert [x.name for x in tracer.spans()] == ["leaf", "child", "other", "root", "thread_child", "thread_root"]
    assert s["root"] is root and s["child"] is child
    assert s["root"].parent is None and s["root"].tick == 7
    assert s["root"].attrs == {"frame_ts": 1.5, "light": True}
    assert s["child"].parent == root.index and s["child"].tick == 7 and s["child"].kind == "work"
    assert s["leaf"].parent == child.index and s["leaf"].tick == 7 and s["leaf"].kind == "wait"
    assert s["other"].parent == root.index and s["other"].tick == 3
    assert root.t0 <= child.t0 <= s["leaf"].t0 <= s["leaf"].t1 <= child.t1 <= root.t1
    assert {x.thread for x in (s["root"], s["child"], s["leaf"])} == {threading.get_ident()}
    assert s["thread_root"].parent is None and s["thread_child"].parent == s["thread_root"].index
    assert s["thread_child"].tick == 11 and s["thread_child"].thread == seen["thread"] != threading.get_ident()


def test_the_ring_drops_the_oldest_and_counts_them(tracer, monkeypatch):
    monkeypatch.setattr(tracer._tracer, "ring", deque(maxlen=3))
    for i in range(5):
        with tracer.span(f"s{i}"):
            pass
    assert [x.name for x in tracer.spans()] == ["s2", "s3", "s4"]
    assert tracer.dropped() == 2
    tracer.clear()
    assert tracer.spans() == [] and tracer.dropped() == 0


def test_spans_are_profiler_ranges(tracer, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with tracer.span("outside"):  # no profiler: no range
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("engine.dispatch"):
            with tracer.span("tracker.pnp"):
                torch.ones(8).sum()
    names = [e.name for e in prof.events()]
    assert "thor/engine.dispatch" in names and "thor/tracker.pnp" in names and "thor/outside" not in names
    with profiling.torch_trace(str(tmp_path), cuda=False) as window:
        with tracer.span("tracker.keyframe"):
            torch.ones(8).sum()
    events = json.loads(open(window.path).read())["traceEvents"]
    assert any(e.get("name") == "thor/tracker.keyframe" for e in events)
    assert [x.name for x in tracer.spans()] == ["outside", "tracker.pnp", "engine.dispatch", "tracker.keyframe"]


# ------------------------------------------------------ the sync counter


def test_sync_warnings_count_on_the_innermost_span_and_are_restored():
    profiling.tracing(False)
    filters, shown = list(warnings.filters), warnings.showwarning
    profiling.clear()
    profiling.tracing(True)
    try:
        with profiling.span("outer"):
            warnings.warn(profiling.SYNC_WARNING)
            with profiling.span("inner"):
                for _ in range(3):  # one line, three calls: each counts
                    warnings.warn(f"{profiling.SYNC_WARNING} (Triggered internally)")
        warnings.warn(profiling.SYNC_WARNING)  # outside every span: neither counted nor shown
        with pytest.warns(UserWarning, match="another warning"):
            warnings.warn("another warning")  # other warnings are still shown
        s = _by_name(profiling.spans())
        assert (s["outer"].syncs, s["inner"].syncs) == (1, 3) and len(s) == 2
    finally:
        profiling.tracing(False)
        profiling.clear()
    assert warnings.filters == filters and warnings.showwarning is shown
    with pytest.warns(UserWarning, match=profiling.SYNC_WARNING):  # shown again once off
        warnings.warn(profiling.SYNC_WARNING)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_blocking_copy_counts_one_sync_on_the_card(cuda_device):
    profiling.tracing(False)
    mode = torch.cuda.get_sync_debug_mode()
    x = torch.ones(4, device=cuda_device)
    torch.cuda.synchronize()
    profiling.clear()
    profiling.tracing(True)
    try:
        assert torch.cuda.get_sync_debug_mode() != mode
        with profiling.span("copy"):
            torch.tensor([1.0, 2.0, 3.0], device=cuda_device)
        with profiling.span("async"):
            (x * 2).add_(1)  # no host wait
        s = _by_name(profiling.spans())
        assert (s["copy"].syncs, s["async"].syncs) == (1, 0)
    finally:
        profiling.tracing(False)
        profiling.clear()
    assert torch.cuda.get_sync_debug_mode() == mode


# ------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def frames():
    traj = OrbitTrajectory(radius=1.5, angular_rate=0.5)
    spec = SyntheticRigSpec(num_sources=2, stereo=True, width=160, height=120, fps=30.0, baseline_m=0.12)
    sources, rig_ext, _, _ = make_synthetic_rig(spec, world=SyntheticWorld(half_extents=(4.0, 4.0, 2.0)),
                                                trajectory=traj)
    with CameraRig(sources, rig_extrinsics=rig_ext, imu_source=sources[0].name) as r:
        return r.calibration, [r.get_synchronized_frames() for _ in range(TICKS)]


def _run(frames, **kwargs):
    """The engine over the frames: every finalized record's tick and
    diagnostics, the poses returned, the upload counters."""
    calibration, sets = frames
    engine = TorchSlamEngine(params=dict(max_keypoints=256, keyframe_min_inliers=40), device="cpu",
                             adaptive_half_res=False, **kwargs)
    engine.initialize(calibration, SlamConfig(num_cameras=4))
    finalized = []
    finalize = engine._finalize_values

    def logged(rec):
        pose = finalize(rec)
        finalized.append((rec["tick"], dict(engine.last_diagnostics)))
        return pose

    engine._finalize_values = logged
    poses = [engine.process_frames(fs) for fs in sets] + [engine.flush()]
    out = dict(poses=[None if p is None else (p.to_4x4_matrix(), p.covariance, p.confidence) for p in poses],
               finalized=finalized, upload_stats=dict(engine.upload_stats), map_t_odom=engine.map_t_odom)
    engine.shutdown()
    return out


@pytest.mark.parametrize("mode", [dict(), dict(pipelined=True, pipeline_depth=1),
                                  dict(pipelined=True, pipeline_depth=6)], ids=["sync", "depth1", "depth6"])
def test_engine_spans(frames, tracer, mode):
    out = _run(frames, **mode)
    spans = tracer.spans()
    by_index = {s.index: s for s in spans}
    roots = [s for s in spans if s.name == "engine.process_frames"]
    assert [r.tick for r in roots] == list(range(TICKS)) and all(r.parent is None for r in roots)
    assert all({"frame_ts", "light", "half"} <= set(r.attrs) for r in roots)

    def root_of(s):
        while s.parent is not None:
            s = by_index[s.parent]
        return s

    dispatch = [s for s in spans if s.name == "engine.dispatch"]
    assert Counter(root_of(s).index for s in dispatch) == Counter(r.index for r in roots)  # one a call
    assert all(s.tick == root_of(s).tick for s in dispatch)
    # Every dispatched tick is fetched once and finalized once, in order.
    fetched = [s.tick for s in spans if s.name == "engine.fetch_wait"]
    assert sorted(fetched) == list(range(TICKS)) and [t for t, _ in out["finalized"]] == list(range(TICKS))
    assert all(s.kind == "wait" for s in spans if s.name in ("engine.fetch_wait", "engine.upload_wait",
                                                            "tracker.refresh_readback"))
    if mode.get("pipelined"):
        assert Counter(root_of(s).name for s in spans if s.name == "engine.upload_wait")["engine.process_frames"] >= TICKS
    # One keyframe front end in each keyframe tick's dispatch, none elsewhere.
    keyframes = {t for t, d in out["finalized"] if d["refreshed"]}
    kf_spans = Counter(s.tick for s in spans if s.name == "tracker.keyframe")
    assert len(keyframes) >= 3 and kf_spans == Counter(keyframes)
    assert all(root_of(s).name == "engine.process_frames" and by_index[s.parent].name == "engine.dispatch"
               for s in spans if s.name == "tracker.pnp")
    assert Counter(s.tick for s in spans if s.name == "tracker.pnp") == Counter(range(TICKS))
    # BA: one span per tracked keyframe, tagged with its tick and its outcome.
    diag = dict(out["finalized"])
    ba = [s for s in spans if s.name == "backend.ba"]
    assert ba and {s.tick for s in ba} <= keyframes
    assert any(s.attrs["solved"] for s in ba)
    for s in ba:
        assert s.attrs["skip"] == diag[s.tick].get("ba_skip")
        assert s.attrs["solved"] == (s.attrs["rms"] is not None)
    loop = [s for s in spans if s.name == "backend.loop"]
    assert loop and {s.tick for s in loop} <= keyframes and all(s.attrs["stage"] == "find" for s in loop)
    assert tracer.dropped() == 0


def test_ba_span_says_how_it_solved(frames, tracer):
    """A ``backend.ba`` span whose solver ran carries ``graph``
    (``"eager"``: CPU tensors take the eager solve); one that stopped
    before the solve carries none."""
    _run(frames, pipelined=True, pipeline_depth=1)
    ba = [s for s in tracer.spans() if s.name == "backend.ba"]
    assert any(s.attrs["solved"] for s in ba)
    for s in ba:
        assert s.attrs.get("graph") == ("eager" if s.attrs["solved"] else None), s.attrs


def test_tracker_segment_spans(frames, tracer):
    """Each dispatched tick: one ``tracker.front``, then ``tracker.pnp``,
    then one ``tracker.back``, all in its ``engine.dispatch``; the two
    segments carry ``graph`` (``"eager"``: CPU tensors take the eager
    tick)."""
    _run(frames, pipelined=True, pipeline_depth=2)
    spans = tracer.spans()
    by_index = {s.index: s for s in spans}
    named = {name: [s for s in spans if s.name == name] for name in ("tracker.front", "tracker.pnp", "tracker.back")}
    for name, ss in named.items():
        assert [s.tick for s in ss] == list(range(TICKS)), name
        assert all(by_index[s.parent].name == "engine.dispatch" and by_index[s.parent].tick == s.tick for s in ss)
    for front, solve, back in zip(*named.values()):
        assert front.attrs == back.attrs == {"graph": "eager"}
        assert front.t1 <= solve.t0 and solve.t1 <= back.t0


def test_imu_span(frames, tracer):
    """``engine.imu``: one span in each tick's dispatch that carries an IMU
    batch, with the batch's ``samples`` and ``accel`` (whether the
    prediction took the accelerometer path: here from the sixth gravity
    observation on), no synchronizing call, and the engine's outputs those
    of an untraced run."""
    calibration, sets = frames
    taken = []

    def run(traced):
        engine = TorchSlamEngine(params=dict(max_keypoints=256, keyframe_min_inliers=40), device="cpu",
                                 adaptive_half_res=False, gravity_min_ticks=5)
        engine.initialize(calibration, SlamConfig(num_cameras=4))
        predict = engine._imu.predict

        def logged(ts):
            pred = predict(ts)
            if traced:
                taken.append(pred is not None and engine._imu.accel_pred_active())
            return pred

        engine._imu.predict = logged
        poses = [engine.process_frames(fs) for fs in sets] + [engine.flush()]
        engine.shutdown()
        return [None if p is None else p.to_4x4_matrix() for p in poses]

    profiling.tracing(False)
    off = run(False)
    profiling.tracing(True)
    on = run(True)
    _same(on, off)
    spans = tracer.spans()
    by_index = {s.index: s for s in spans}
    imu = [s for s in spans if s.name == "engine.imu"]
    with_imu = [k for k, fs in enumerate(sets) if fs.sensor_data is not None]
    assert len(with_imu) >= TICKS - 1 and [s.tick for s in imu] == with_imu
    assert all(by_index[s.parent].name == "engine.dispatch" and by_index[s.parent].tick == s.tick for s in imu)
    assert [s.attrs["samples"] for s in imu] == [len(sets[k].sensor_data["gyroscope"]) for k in with_imu]
    assert [s.attrs["accel"] for s in imu] == taken and any(taken) and not all(taken)
    assert all(s.syncs == 0 and s.kind == "work" for s in imu)


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_tracing_changes_no_output(frames):
    mode = dict(pipelined=True, pipeline_depth=2)
    off = _run(frames, **mode)
    profiling.tracing(True)
    try:
        on = _run(frames, **mode)
        assert profiling.spans()
    finally:
        profiling.tracing(False)
        profiling.clear()
    _same(on, off)


# ------------------------------------------------- loop closure and state

LOOP_BLACKOUT = range(60, 74)


@pytest.fixture(scope="module")
def loop_spans():
    """The spans of 170 traced ticks of a revisit orbit with a blackout
    (the loop end-to-end configuration), with each tick's tracking state
    and the closures the loop backend applied (``closures_recorded``)."""
    spec = SyntheticRigSpec(num_sources=2, stereo=True, width=160, height=120, fps=20.0, baseline_m=0.12)
    sources, rig_ext, _, _ = make_synthetic_rig(spec, world=SyntheticWorld(half_extents=(4.0, 4.0, 2.0)),
                                                trajectory=OrbitTrajectory(radius=1.5, angular_rate=1.0))
    engine = TorchSlamEngine(
        params=dict(max_keypoints=256, keyframe_min_inliers=40, keyframe_max_translation=0.3, keyframe_max_rotation=0.35),
        enable_ba=False, use_imu=False, light_ticks=False, device="cpu", loop_db_capacity=30, loop_exclude_recent=6,
        loop_cooldown_kfs=8, loop_min_votes=40, loop_min_inliers=25,
    )
    states = []
    profiling.tracing(False)
    profiling.clear()
    profiling.tracing(True)
    try:
        with CameraRig(sources, rig_extrinsics=rig_ext) as rig, chip_smoke.closures_recorded() as closures:
            engine.initialize(rig.calibration, SlamConfig(num_cameras=4, enable_loop_closure=True))
            for i in range(170):
                sync = rig.get_synchronized_frames()
                if i in LOOP_BLACKOUT:
                    for fs in sync.frame_sets.values():
                        for f in fs.frames:
                            f.image = np.zeros_like(f.image)
                engine.process_frames(sync)
                states.append(engine.get_tracking_state().name)
            engine.flush()
        spans = profiling.spans()
        assert profiling.dropped() == 0
    finally:
        profiling.tracing(False)
        profiling.clear()
    engine.shutdown()
    return spans, states, closures


def test_loop_stages_carry_their_outcomes(loop_spans):
    """``backend.loop``: a find's readback carries its ``votes``, a
    verification's readback ``accepted`` and ``inliers``, the pose-graph
    stage the gate's verdict with its discrepancy and noise floor (and,
    where it applied, the graph's ``nodes``), around one ``loop.posegraph``
    span of the solve with ``nodes`` and ``edges``; none of them adds a
    synchronizing call."""
    spans, _, closures = loop_spans
    by_index = {s.index: s for s in spans}
    loop = [s for s in spans if s.name == "backend.loop"]
    finds = [s for s in loop if s.attrs["stage"] == "find" and "votes" in s.attrs]
    verifies = [s for s in loop if s.attrs["stage"] == "verify"]
    graphs = [s for s in loop if s.attrs["stage"] == "posegraph"]
    assert finds and all(isinstance(s.attrs["votes"], int) for s in finds)
    assert verifies and all(isinstance(s.attrs["accepted"], bool) and isinstance(s.attrs["inliers"], int)
                            for s in verifies)
    assert len(graphs) == sum(s.attrs["accepted"] for s in verifies) >= 1
    for s in graphs:
        assert s.attrs["gate"] in ("skip", "apply") and s.attrs["disc_m"] >= 0 and s.attrs["floor_m"] > 0
        assert (s.attrs["gate"] == "apply") == (s.attrs["disc_m"] >= s.attrs["floor_m"])
        assert s.attrs["closed"] == (s.attrs["gate"] == "apply") == ("nodes" in s.attrs)
    solves = [s for s in spans if s.name == "loop.posegraph"]
    applied = [s for s in graphs if s.attrs["gate"] == "apply"]
    assert len(solves) == len(applied) >= 1
    for s in solves:
        parent = by_index[s.parent]
        assert parent.name == "backend.loop" and parent.attrs["stage"] == "posegraph"
        assert s.attrs == {"nodes": parent.attrs["nodes"], "edges": parent.attrs["nodes"]}
        assert parent.t0 <= s.t0 and s.t1 <= parent.t1 and s.tick == parent.tick
    assert [s.attrs["nodes"] for s in solves] == [c["kk"] for c in closures]
    assert all(s.syncs == 0 for s in loop + solves)


def test_each_call_says_the_state_it_left(loop_spans):
    """``engine.process_frames`` carries ``state``: the tracking state the
    call left; the blackout's ticks leave tracking and it comes back."""
    spans, states, _ = loop_spans
    roots = [s for s in spans if s.name == "engine.process_frames"]
    assert [s.attrs["state"] for s in roots] == states
    assert states[LOOP_BLACKOUT.start - 1] == "TRACKING" and states[-1] == "TRACKING"
    lost = [i for i, s in enumerate(states) if s in ("LOST", "RELOCALIZING")]
    assert lost and LOOP_BLACKOUT.start <= lost[0] and lost[-1] < LOOP_BLACKOUT.stop + 10
