"""The window's arithmetic on a fake clock: latencies, percentiles, rates."""

import numpy as np
import pytest
import torch

from benchmark.core import spec, traffic
from benchmark.core.driver import Run


class FakeEvent:
    """A CUDA event stand-in: its device time in milliseconds."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def _run(generator="newest_wins"):
    mix = {"generator": generator, "fps": 30}
    run = Run(cell="c", config={}, traffic=mix, seed=1, trace=False, device=torch.device("cpu"))
    run.clock = spec.generator(generator).Clock(mix, origin=100.0)
    return run


def test_payload_copy():
    d = traffic.payload_stats({"full": 5, "light": 3, "light_half": 2, "bytes": 100},
                              {"full": 1, "light": 1, "light_half": 0, "bytes": 20})
    assert d["ticks"] == 8 and d["mean_bytes_per_tick"] == 10.0


def test_camera_clock_takes_the_newest_frame(monkeypatch):
    gen = spec.generator("newest_wins")
    now = [100.0]
    monkeypatch.setattr(gen.time, "perf_counter", lambda: now[0])
    monkeypatch.setattr(gen.time, "sleep", lambda s: now.__setitem__(0, now[0] + s))
    clock = gen.Clock({"fps": 30}, origin=100.0)
    assert clock.next_tick() == 0
    now[0] = 100.0 + 3.5 / 30  # frames 1, 2 missed: the newest is 3
    assert clock.next_tick() == 3
    assert clock.next_tick() == 4 and now[0] == pytest.approx(100.0 + 4 / 30)
    clock.hold(1.0)  # the host was held a second: the clock waits for it
    assert clock.capture_time(5) == pytest.approx(101.0 + 5 / 30)


def test_closed_loop_takes_every_tick():
    clock = spec.generator("closed_loop").Clock({"fps": 30}, origin=100.0)
    assert [clock.next_tick() for _ in range(4)] == [0, 1, 2, 3] and not clock.paced


def test_pose_latency_rate_and_map_latency():
    run = _run()
    run.t_start, run.t_end = 100.0, 102.0
    lat = np.linspace(0.05, 0.25, 40)
    run.calls = [dict(k=k, t0=0.0, t1=0.0, traced=False, lost=k == 7) for k in range(40)]
    run.poses = [(k, run.capture_time(k) + lat[k], np.eye(4)) for k in range(40)]
    assert spec.reader("tick_rate").read(run) == pytest.approx(39 / 2.0)
    assert spec.reader("pose_latency_p95_ms").read(run) == pytest.approx(np.percentile(lat, 95) * 1e3)
    run.anchor = (FakeEvent(0.0), 99.0)  # the anchor completed at host time 99 s
    done = [1000.0 + 10.0 * i for i in range(10)]  # ms after the anchor
    run.integrations = [dict(k=3 * i, ev0=FakeEvent(d - 2.0), ev1=FakeEvent(d), window=True, traced=False)
                        for i, d in enumerate(done)]
    want = [99.0 + d / 1e3 - run.capture_time(3 * i) for i, d in enumerate(done)]
    assert spec.reader("map_latency_p90_ms").read(run) == pytest.approx(np.percentile(want, 90) * 1e3)
    assert spec.reader("integrate_device_ms").read(run) == pytest.approx(2.0)


def test_closed_loop_reports_no_latency():
    run = _run("closed_loop")
    run.poses = [(0, 100.5, np.eye(4))]
    assert spec.reader("pose_latency_p95_ms").read(run) is None
    assert spec.reader("map_latency_p90_ms").read(run) is None


def test_trace_reduction_labels_idle_gaps():
    from torch.autograd import DeviceType

    from benchmark.core.trace import summarize

    class E:
        def __init__(self, name, dev, s, e):
            self.name, self.device_type = name, dev
            self.time_range = type("R", (), {"start": s, "end": e})()

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [E("engine", cpu, 0, 1000), E("rgbd", cpu, 1000, 1500), E("cudaLaunchKernel", cpu, 10, 11),
              E("cudaLaunchKernel", cpu, 20, 21), E("k1", gpu, 100, 300), E("k2", gpu, 250, 400),
              E("k1", gpu, 1200, 1300)]
    s = summarize(events, ticks=1)
    assert s.window_s == pytest.approx(1.5e-3) and s.busy_s == pytest.approx(4e-4)
    assert s.launches == 2 and s.seconds("k1") == pytest.approx(3e-4)
    assert s.idle_gaps[0] == ["engine", pytest.approx(8e-4)]
    assert {g[0] for g in s.idle_gaps} == {"engine", "rgbd"}
    assert spec.reader("device_idle_pct").read(type("R", (), {"summary": s})()) == pytest.approx(100 * (1 - 0.4 / 1.5))
