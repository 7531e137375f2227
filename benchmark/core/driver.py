"""The loop that drives the system: warm-up, the measured window, the drain.

It calls the program as ``run_pipeline.run`` does, tick by tick:
``process_frames``; on every ``rgbd_every``-th processed tick
``RGBDProcessor.process(fetch=False)``; then ``DenseMapper.integrate`` at
the delivered pose nearest in time (of the last 60). What it records is a
:class:`Run`, which the metric readers and the correctness check read.
Host times are ``time.perf_counter`` seconds; a map frame's completion on
the device is the anchor's host time plus the CUDA-event time from the
anchor, recorded after a synchronize before the window.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.core import spec
from benchmark.core import traffic as traffic_mod


@dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    seed: int
    trace: bool
    device: torch.device
    device_name: str = ""
    clock: object | None = None  # the mix generator's Clock
    setup_s: float = 0.0
    t_start: float = 0.0
    t_end: float = 0.0
    calls: list = field(default_factory=list)  # window ticks: dict(k, t0, t1, traced, lost, keyframe)
    poses: list = field(default_factory=list)  # window deliveries: (k, t_return, (4, 4) pose)
    integrations: list = field(default_factory=list)  # every integrate: dict(k, p, world_t_product, window, ...)
    rgbd_spans: list = field(default_factory=list)  # window RGB-D calls: (t0, t1, traced)
    kept_depth: list = field(default_factory=list)  # (p, (Hc, Wc) uint16 device tensor) sampled in the window
    upload_before: dict = field(default_factory=dict)
    upload_after: dict = field(default_factory=dict)
    anchor: tuple | None = None  # (CUDA event, host time)
    summary: object | None = None  # trace.TraceSummary of the traced run
    launch_bytes: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0

    @property
    def failed(self) -> int:
        """Window ticks that left tracking lost or relocalizing: their pose is
        missing or held. (A pipelined engine finalizes a batch of ticks per
        call and hands back the newest pose, so a pose per call is no test.)"""
        return sum(c["lost"] for c in self.calls)

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    def capture_time(self, k: int) -> float:
        return self.clock.capture_time(k)

    def completion_time(self, event) -> float:
        """Host time at which ``event`` completed on the device."""
        ev0, host0 = self.anchor
        return host0 + ev0.elapsed_time(event) / 1e3


class Driver:
    def __init__(self, system, run: Run, profiler=None, rng: np.random.Generator | None = None):
        self.s, self.run, self.prof = system, run, profiler
        mix = run.traffic
        self.fps = float(mix["fps"])
        self.factory = traffic_mod.FrameSetFactory(system.rig, self.fps, mix.get("imu_hz", 0))
        self.clock_type = spec.generator(mix["generator"]).Clock
        self.rgbd_every = int(mix.get("rgbd_every") or 0)
        self.integrate_every = int((run.config.get("mapping") or {}).get("integrate_every", 1))
        self.depth_sample = int(mix.get("depth_sample", 0))
        self.rng = rng or np.random.default_rng([int(run.seed), 2])
        self.cuda = run.device.type == "cuda"
        self.processed = 0
        self.pose_hist: list = []
        self.in_window = False
        self.traced_ticks = 0
        self._rgbd_seen = 0

    def _span(self, name):
        return self.prof.span(name) if self.prof is not None else _NULL

    def _deliver(self, pose, t_return: float) -> None:
        if pose is None:
            return
        k = int(round(pose.timestamp * self.fps))
        mat = pose.to_4x4_matrix()
        self.pose_hist.append((pose.timestamp, mat))
        if len(self.pose_hist) > 60:
            del self.pose_hist[:-60]
        if self.in_window:
            self.run.poses.append((k, t_return, mat))

    def _event(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def tick(self, k: int) -> None:
        """One rig tick: the engine, then the RGB-D product and the map."""
        s = self.s
        with self._span("traffic"):
            sync = self.factory(k)
        traced = self.prof is not None and self.prof.active
        with self._span("engine"):
            t0 = time.perf_counter()
            pose = s.engine.process_frames(sync)
            t1 = time.perf_counter()
        self._deliver(pose, t1)
        self.processed += 1
        if self.in_window:
            lost = s.engine.get_tracking_state().name in ("LOST", "RELOCALIZING")
            keyframe = pose is not None and bool(s.engine.last_diagnostics.get("refreshed"))
            self.run.calls.append(dict(k=k, t0=t0, t1=t1, traced=traced, lost=lost, keyframe=keyframe))
            self.traced_ticks += traced
        if not (s.rgbd is not None and self.processed % self.rgbd_every == 0):
            return
        p = s.rig.frame(k)
        from thor_slam_tpu_torch.camera.types import CameraFrame

        color = CameraFrame(image=s.rig.colors[p], timestamp=sync.timestamp, sequence_num=k,
                            camera_name=f"{s.rgbd.camera_name}_rgb")
        with self._span("rgbd"):
            r0 = time.perf_counter()
            frame = s.rgbd.process(sync, color_frame=color, fetch=False)
            r1 = time.perf_counter()
        if self.in_window:
            self.run.rgbd_spans.append((r0, r1, traced))
            self._keep(p, frame.depth_mm)
        if s.mapper is None or not self.pose_hist or (self.processed // self.rgbd_every) % self.integrate_every:
            return
        _, world_t_body = min(self.pose_hist, key=lambda h: abs(h[0] - frame.timestamp))
        world_t_product = np.asarray(world_t_body) @ s.product_t_body
        with self._span("mapper"):
            ev0 = self._event()
            s.mapper.integrate(frame, world_t_product)
            ev1 = self._event()
        self.run.integrations.append(dict(k=k, p=p, world_t_product=world_t_product, window=self.in_window,
                                          k_color=np.asarray(frame.intrinsics.matrix), ev0=ev0, ev1=ev1,
                                          traced=traced))

    def _keep(self, p: int, depth) -> None:
        """Reservoir sample, drawn from the seed, of the window's depth frames."""
        self._rgbd_seen += 1
        kept = self.run.kept_depth
        if len(kept) < self.depth_sample:
            kept.append((p, depth))
        else:
            j = int(self.rng.integers(self._rgbd_seen))
            if j < self.depth_sample:
                kept[j] = (p, depth)

    def drain(self) -> None:
        with self._span("engine"):
            pose = self.s.engine.flush()
            t = time.perf_counter()
        self._deliver(pose, t)

    def warm_up(self) -> None:
        """The stream's first ticks, untimed: every shape the window uses
        (full, light and half-resolution ticks, keyframes, the RGB-D product
        and the map) runs here first."""
        mix = self.run.traffic
        self.run.clock = self.clock_type(mix)
        if "warmup_ticks" in mix:
            for _ in range(int(mix["warmup_ticks"])):
                self.tick(self._next())
        else:
            end = time.perf_counter() + float(mix["warmup_s"])
            while time.perf_counter() < end:
                self.tick(self._next())
        self.drain()
        if self.cuda:
            torch.cuda.synchronize()
        gc.collect()
        gc.freeze()  # set-up's objects leave the collector's young generations

    def _next(self) -> int:
        """The next tick, as the mix's clock has it."""
        return self.run.clock.next_tick()

    def window(self, seconds: float, on_start=None) -> None:
        """The measured window: ticks for ``seconds``, then the drain."""
        run, mix = self.run, self.run.traffic
        if self.cuda:
            torch.cuda.synchronize()
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record()
            torch.cuda.synchronize()
            run.anchor = (anchor, time.perf_counter())
        run.upload_before = dict(self.s.engine.upload_stats)
        trace_from = run.trace and int(mix.get("trace_ticks", 0))
        k = self._next()  # the camera clock runs on: the window opens at the next frame
        self.in_window = True
        run.t_start = time.perf_counter()
        if on_start is not None:
            on_start()
        end = run.t_start + seconds
        while True:
            if trace_from and self.prof is not None:
                # Profile a bounded stretch from 30 % of the window on. The
                # profiler's own start and stop hold the host for a second or
                # more: the camera clock waits for them (a stream that jumps
                # that far loses track, and would be judged so).
                t_hold = time.perf_counter()
                if not self.prof.active and not self.prof.done and t_hold > run.t_start + 0.3 * seconds:
                    self.prof.start()
                    self.traced_ticks = 0
                elif self.prof.active and self.traced_ticks >= trace_from:
                    self.prof.stop(self.traced_ticks)
                run.clock.hold(time.perf_counter() - t_hold)
            self.tick(k)
            if time.perf_counter() >= end:
                break
            k = self._next()
        if self.prof is not None and self.prof.active:
            self.prof.stop(self.traced_ticks)  # the window's end: no frame waits on it
        self.drain()
        run.t_end = time.perf_counter()
        self.in_window = False
        run.upload_after = dict(self.s.engine.upload_stats)


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()
