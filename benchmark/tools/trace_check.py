"""Checks of the program's tracer on a cell of the benchmark (no cell itself).

    python3 -m benchmark.tools.trace_check check <cell> <seed> [--seconds S] [--small] [--out FILE]
    python3 -m benchmark.tools.trace_check paired <cell> <seed> [--blocks N] [--ticks M] [--profile] [--small]
    python3 -m benchmark.tools.trace_check micro

From the root of a checkout. Each mode prints JSON lines (``--out`` also
appends them to a file).

``check`` runs the cell once traced (``benchmark.run``'s ``run_cell``,
``--trace 1``) and holds the tracer to what its metrics assume; it exits 1
when any verdict (the ``verdicts`` line) fails:

* ``clock``: the mean ``engine.process_frames`` span over the untraced
  window calls is within 2 % of ``engine_call_ms`` of the same run;
* ``dispatched_once``, ``fetched_once``, ``finalized_once``: every window
  tick is dispatched, fetched (``engine.fetch_wait``) and finalized
  (``TorchSlamEngine._finalize_values``) exactly once, by ``tick``;
  ``none_dropped``: the ring dropped no span;
* ``syncs``: in each profiled tick the tracer's synchronizing calls are
  within 1 of the profile's ``cudaStreamSynchronize`` +
  ``cudaDeviceSynchronize`` + ``cudaMemcpy`` runtime calls inside that
  tick's ``thor/engine.process_frames`` range;
* ``pnp_in_engine``: in the profile's Chrome export every
  ``thor/tracker.pnp`` range lies inside the driver's ``engine`` range;
* ``correct``: the run's own check.

It also prints the self ms per tick of each span (its duration less its
children's; they sum to the mean ``engine.process_frames`` span), the
launches and kernels under the PnP ranges, and the largest pose steps
against the truth with the ``backend.ba`` spans and frame gaps around them.

``paired`` measures the tracer's cost when on: two engines of the cell
built alike, fed the same frames in a closed loop and stepped in turn (on
then off, off then on, ...), the traced engine swapped every block of
``--ticks``; the host ms of each ``process_frames`` call, and the median
on-minus-off difference. ``--profile`` runs each block inside its own
``torch.profiler`` session with the driver's ``engine`` range around each
call, as a traced run's profiled stretch does (a span then also opens its
``thor/<name>`` range); a session's first pair of calls is not measured.

``micro`` times one span, one counted synchronizing call and one launch,
tracer off and on (needs a card; ``--profile``: inside a profiler session).
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time

#: The profile's runtime calls that a counted synchronizing call ends in.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")


class Emitter:
    def __init__(self, out: str | None):
        self.out = out

    def __call__(self, tag: str, obj: dict) -> None:
        line = json.dumps({"tag": tag, **obj}, default=float)
        print(line, flush=True)
        if self.out:
            os.makedirs(os.path.dirname(self.out) or ".", exist_ok=True)
            with open(self.out, "a") as f:
                f.write(line + "\n")


def _setup(args):
    import torch

    from benchmark.core import spec

    bench = spec.load_benchmark()
    cell = spec.cell(args.cell, bench)
    cfg, mix, lim = spec.config(cell["config"], bench), spec.traffic(cell["traffic"]), spec.limits(cell["name"])
    if args.small:  # the benchmark's own CPU size (benchmark/tests/conftest.py)
        from benchmark.tests.conftest import SMALL_LIMITS, shrink

        cfg, mix = shrink(cfg, mix)
        lim = {k: SMALL_LIMITS[k] for k in lim}
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    return bench, cell, cfg, mix, lim, dev


def _inside(intervals: list, a: float, b: float) -> bool:
    """Whether [a, b] lies inside one of the sorted, disjoint ``intervals``."""
    i = bisect.bisect_right([s for s, _ in intervals], a) - 1
    return i >= 0 and b <= intervals[i][1]


def _self_ms(ticks: list) -> tuple[dict, dict]:
    """Self ms and syncs per tick of each span name over the window ticks."""
    self_ms, syncs = collections.defaultdict(float), collections.defaultdict(int)
    for t in ticks:
        members = [t.root] + t.inside
        child = collections.defaultdict(float)
        for s in members:
            if s.parent is not None:
                child[s.parent] += s.ms
        for s in members:
            self_ms[s.name] += s.ms - child[s.index]
            syncs[s.name] += s.syncs
    n = max(len(ticks), 1)
    return ({k: v / n for k, v in sorted(self_ms.items(), key=lambda x: -x[1])},
            {k: v / n for k, v in syncs.items() if v})


def _profile_syncs(events, spans, run) -> dict:
    """Per profiled tick: the tracer's syncs and the profile's synchronizing runtime calls."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    ranges = sorted((e.time_range.start, e.time_range.end) for e in cpu if e.name == "thor/engine.process_frames")
    per = [collections.Counter() for _ in ranges]
    starts = [a for a, _ in ranges]
    for e in cpu:
        if e.name in SYNC_CALLS + ("cudaEventSynchronize",):
            i = bisect.bisect_right(starts, e.time_range.start) - 1
            if i >= 0 and e.time_range.end <= ranges[i][1]:
                per[i][e.name] += 1
    traced = sorted((c["t0"] * 1e9, c["t1"] * 1e9) for c in run.calls if c["traced"])
    roots = sorted((s for s in spans if s.name == "engine.process_frames" and _inside(traced, s.t0, s.t1)),
                   key=lambda s: s.t0)
    tracer = [sum(s.syncs for s in spans if s.thread == r.thread and r.t0 <= s.t0 and s.t1 <= r.t1) for r in roots]
    profile = [sum(c[n] for n in SYNC_CALLS) for c in per]
    diffs = [abs(a - b) for a, b in zip(tracer, profile)]
    return {"traced_ticks_tracer": len(roots), "traced_ticks_profile": len(ranges), "tracer_syncs_per_tick": tracer,
            "profile_sync_calls_per_tick": profile,
            "profile_event_syncs_per_tick": [c["cudaEventSynchronize"] for c in per],
            "max_abs_diff_per_tick": max(diffs, default=None),
            "ok": bool(roots) and len(roots) == len(ranges) and max(diffs) <= 1}


def _chrome(path: str) -> dict:
    """The Chrome export: PnP ranges inside the driver's engine ranges, and what lies beneath them."""
    with open(path) as f:
        xs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]

    def ranges(name, cat):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in xs if e["name"] == name and e.get("cat") == cat)

    engine = ranges("engine", "user_annotation")
    pnp, gpu_pnp = ranges("thor/tracker.pnp", "user_annotation"), ranges("thor/tracker.pnp", "gpu_user_annotation")
    launches = sorted(e["ts"] for e in xs if e.get("cat") == "cuda_runtime" and "Launch" in e["name"])
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in xs if e.get("cat") == "kernel")
    inside = sum(_inside(engine, a, b) for a, b in pnp)
    return {"engine_ranges": len(engine), "pnp_ranges": len(pnp), "pnp_inside_engine": inside,
            "launches_in_pnp_ranges": [bisect.bisect_right(launches, b) - bisect.bisect_left(launches, a)
                                       for a, b in pnp],
            "kernels_under_gpu_pnp": [sum(1 for s, e in kernels if a <= s and e <= b) for a, b in gpu_pnp],
            "bytes": os.path.getsize(path),
            "thor_names": sorted({e["name"] for e in xs if e["name"].startswith("thor/")}),
            "ok": bool(pnp) and inside == len(pnp)}


def _steps(run, system, spans) -> dict:
    """The largest steps between delivered poses against the truth, with
    the BA spans and long spans between them and the frame gaps."""
    import numpy as np
    import torch

    from benchmark.core.check import _steps as steps_of
    from benchmark.reference import orbit

    ks = [k for k, _, _ in run.poses]
    if len(ks) < 3:
        return {}
    est = np.stack([m for _, _, m in run.poses]).astype(np.float64)
    gt = system.rig.gt_poses(ks, torch.float64).numpy()
    rt, rr = (np.asarray(x) for x in orbit.pose_errors(steps_of(est), torch.from_numpy(steps_of(gt))))
    ba = [s for s in spans if s.name == "backend.ba"]
    top = []
    for i in np.argsort(-rt)[:4]:
        a, b = run.poses[i][1] * 1e9, run.poses[i + 1][1] * 1e9
        top.append(dict(step=int(i), k=(int(ks[i]), int(ks[i + 1])), frames_gap=int(ks[i + 1] - ks[i]),
                        err_mm=float(rt[i] * 1e3), err_mrad=float(rr[i] * 1e3),
                        ba_between=[dict(tick=s.tick, ms=s.ms, **s.attrs) for s in ba if a <= s.t1 <= b],
                        long_spans_between=[dict(name=s.name, tick=s.tick, ms=s.ms) for s in spans
                                            if s.ms > 40 and a <= s.t1 <= b
                                            and s.name not in ("tracker.pnp", "engine.dispatch")][:12]))
    gaps = np.diff(ks)
    return {"median_err_mm": float(np.median(rt) * 1e3), "top": top,
            "ba_applied": [dict(tick=s.tick, correction_m=s.attrs.get("correction_m")) for s in ba
                           if s.attrs.get("solved") and s.attrs.get("skip") is None][:50],
            "ba_solved": sum(1 for s in ba if s.attrs.get("solved")), "ba_spans": len(ba),
            "max_frames_gap": int(gaps.max()), "gap_hist": dict(collections.Counter(map(int, gaps)))}


def check(args, emit) -> int:
    from benchmark.core import driver as driver_mod
    from benchmark.core import program_spans
    from benchmark.core import trace as trace_mod
    from benchmark.run import run_cell
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.utils import profiling

    bench, cell, cfg, mix, lim, dev = _setup(args)
    # A fresh ring and a fresh hook on the warnings (a caller's warnings
    # context, such as a test's, may have put its own back); left on, as a
    # traced run leaves it.
    profiling.tracing(False)
    profiling.clear()
    profiling.tracing(True)
    seen, finalized = {}, []
    tmp = tempfile.TemporaryDirectory()
    finish, init, finalize = trace_mod.Profiler.finish, driver_mod.Driver.__init__, TorchSlamEngine._finalize_values

    def finish_kept(self):
        if self._stopped is not None:
            prof, _ = self._stopped
            seen["events"] = list(prof.events())
            seen["chrome"] = os.path.join(tmp.name, "trace.json")
            prof.export_chrome_trace(seen["chrome"])
        finish(self)

    def init_kept(self, system, run, *a, **k):
        seen["driver"] = self
        init(self, system, run, *a, **k)

    def finalize_logged(self, rec):
        finalized.append(rec["tick"])
        return finalize(self, rec)

    trace_mod.Profiler.finish, driver_mod.Driver.__init__ = finish_kept, init_kept
    TorchSlamEngine._finalize_values = finalize_logged
    try:
        result = run_cell(cell, cfg, mix, lim, bench, args.seed, args.seconds, True, dev,
                          lambda m: print(f"benchmark: {m}", file=sys.stderr, flush=True))
    finally:
        trace_mod.Profiler.finish, driver_mod.Driver.__init__ = finish, init
        TorchSlamEngine._finalize_values = finalize
    run, system = seen["driver"].run, seen["driver"].s
    emit("result", {"cell": args.cell, "seed": args.seed, "correct": result["correct"], "metrics": result["metrics"],
                    "checks": result["checks"], "device": result["device"]})
    spans = profiling.spans()
    ticks = program_spans.window_ticks(run)
    root_ms = statistics.fmean(t.root.ms for t in ticks)
    call_ms = result["metrics"]["engine_call_ms"]["value"]
    calls = sorted((c["t0"] * 1e9, c["t1"] * 1e9) for c in run.calls)
    roots = [s for s in spans if s.name == "engine.process_frames" and _inside(calls, s.t0, s.t1)]
    dispatched = sorted(s.tick for s in spans if s.name == "engine.dispatch" and _inside(calls, s.t0, s.t1))
    fetched = collections.Counter(s.tick for s in spans if s.name == "engine.fetch_wait")
    done = collections.Counter(finalized)
    verdicts = {"clock": abs(root_ms - call_ms) <= 0.02 * call_ms,
                "dispatched_once": len(dispatched) == len(set(dispatched)) == len(roots) == len(run.calls),
                "fetched_once": all(fetched[t] == 1 for t in dispatched),
                "finalized_once": all(done[t] == 1 for t in dispatched),
                "none_dropped": profiling.dropped() == 0}
    emit("clock_and_ticks", {"untraced_ticks": len(ticks), "mean_process_frames_span_ms": root_ms,
                             "engine_call_ms": call_ms, "diff_pct": 100 * (root_ms - call_ms) / call_ms,
                             "window_calls": len(run.calls), "dispatched": len(dispatched),
                             "dropped": profiling.dropped(), "spans": len(spans)})
    self_ms, syncs = _self_ms(ticks)
    emit("self_ms_per_tick", {"ticks": len(ticks), "self_ms": self_ms, "sum_ms": sum(self_ms.values()),
                              "root_ms": root_ms, "syncs_per_tick_by_span": syncs,
                              "keyframe_ticks": sum(1 for t in ticks if t.named("tracker.keyframe")),
                              "light": sum(1 for t in ticks if t.root.attrs.get("light")),
                              "half": sum(1 for t in ticks if t.root.attrs.get("half"))})
    sync = _profile_syncs(seen.get("events", []), spans, run)
    emit("syncs", sync)
    verdicts["syncs"] = sync["ok"]
    if "chrome" in seen:
        chrome = _chrome(seen["chrome"])
        emit("chrome", chrome)
        verdicts["pnp_in_engine"] = chrome["ok"]
    tmp.cleanup()
    emit("steps", _steps(run, system, spans))
    verdicts["correct"] = bool(result["correct"])
    emit("verdicts", {"cell": args.cell, "seed": args.seed, **verdicts, "all": all(verdicts.values())})
    return 0 if all(verdicts.values()) else 1


def paired(args, emit) -> int:
    import torch

    from benchmark.core.system import build
    from benchmark.core.traffic import FrameSetFactory
    from thor_slam_tpu_torch.utils import profiling

    bench, cell, cfg, mix, lim, dev = _setup(args)
    a, b = build(cfg, mix, args.seed, dev), build(cfg, mix, args.seed, dev)
    factory = FrameSetFactory(a.rig, float(mix["fps"]), mix.get("imu_hz", 0))
    for k in range(args.warmup):
        fs = factory(k)
        a.engine.process_frames(fs)
        b.engine.process_frames(fs)

    def session():
        if not args.profile:
            return contextlib.nullcontext()
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else []))

    def engine_range():
        if not args.profile:
            return contextlib.nullcontext()
        return torch.profiler.record_function("engine")  # the driver's span in a traced run

    on_ms, off_ms = [], []
    k = args.warmup
    for blk in range(args.blocks):
        traced, plain = (a.engine, b.engine) if blk % 2 == 0 else (b.engine, a.engine)
        with session():
            if args.profile:  # the session's first calls pay the profiler's start: unmeasured
                fs = factory(k)
                k += 1
                for eng in (a.engine, b.engine):
                    with engine_range():
                        eng.process_frames(fs)
            for i in range(args.ticks):
                fs = factory(k)
                k += 1
                order = ((traced, True), (plain, False)) if i % 4 in (0, 3) else ((plain, False), (traced, True))
                for eng, on in order:
                    profiling.tracing(on)
                    with engine_range():
                        t0 = time.perf_counter()
                        eng.process_frames(fs)
                        dt = 1e3 * (time.perf_counter() - t0)
                    profiling.tracing(False)
                    (on_ms if on else off_ms).append(dt)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        profiling.clear()
    same = dict(upload_stats=a.engine.upload_stats == b.engine.upload_stats,
                last=str(a.engine.last_diagnostics) == str(b.engine.last_diagnostics))
    for s in (a, b):
        s.engine.flush()
        s.engine.shutdown()
    d = [x - y for x, y in zip(on_ms, off_ms)]
    n = args.ticks
    blocks = [dict(median_diff_ms=statistics.median(d[j:j + n]), median_off_ms=statistics.median(off_ms[j:j + n]))
              for j in range(0, len(d), n)]
    q = statistics.quantiles(d, n=4)
    bm = [x["median_diff_ms"] for x in blocks]
    qb = statistics.quantiles(bm, n=4) if len(bm) > 1 else [bm[0]] * 3
    emit("paired", {"cell": args.cell, "profile": args.profile, "ticks": len(d), "same_work": same,
                    "median_diff_ms": statistics.median(d), "diff_q1_ms": q[0], "diff_q3_ms": q[2],
                    "mean_diff_ms": statistics.fmean(d), "median_off_ms": statistics.median(off_ms),
                    "mean_off_ms": statistics.fmean(off_ms),
                    "median_diff_pct": 100 * statistics.median(d) / statistics.median(off_ms),
                    "block_median_diffs_ms": bm, "block_q1_q3_ms": [qb[0], qb[2]], "blocks": blocks})
    return 0 if all(same.values()) else 1


def micro(args, emit) -> int:
    import torch

    from thor_slam_tpu_torch.utils import profiling

    x = torch.ones(1000, device="cuda")
    rows = []
    for on in (False, True) * 3:
        session = contextlib.nullcontext()
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            session = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        session.__enter__()
        profiling.tracing(on)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profiling.span("outer"):
            for _ in range(2000):
                x.sum().item()
        item_us = 1e6 * (time.perf_counter() - t) / 2000
        t = time.perf_counter()
        for _ in range(20000):
            with profiling.span("s", tick=1):
                pass
        span_us = 1e6 * (time.perf_counter() - t) / 20000
        t = time.perf_counter()
        for _ in range(2000):
            x.add_(1)
        launch_us = 1e6 * (time.perf_counter() - t) / 2000
        torch.cuda.synchronize()
        profiling.tracing(False)
        session.__exit__(None, None, None)
        profiling.clear()
        rows.append(dict(on=on, item_in_span_us=item_us, span_us=span_us, launch_us=launch_us))
    emit("micro", {"profile": args.profile, "rows": rows})
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", choices=("check", "paired", "micro"))
    ap.add_argument("cell", nargs="?")
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--blocks", type=int, default=20)
    ap.add_argument("--ticks", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=40)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--small", action="store_true", help="the CPU size of the benchmark's own tests")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    if args.mode != "micro" and args.cell is None:
        ap.error("check and paired need a cell and a seed")
    # Before numpy or torch loads: the host's pools held as a run holds them.
    os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    import torch

    emit = Emitter(args.out)
    if torch.cuda.is_available():
        emit("card", {"name": torch.cuda.get_device_name(0), "torch": torch.__version__})
    return {"check": check, "paired": paired, "micro": micro}[args.mode](args, emit)


if __name__ == "__main__":
    sys.exit(main())
