"""Light-tick scheduling + the adaptive degrade-to-keep-up controller.

The port's copy of :mod:`thor_slam_tpu.engine.backends.light` (numpy
only): the same code under the same names, held to the original by
``tests/test_torch_host_layer.py``. The engine it serves here is
``TorchSlamEngine``; "the engine" below is either.

The upload-bound deployment levers of the engine, extracted
as a policy object (state in, tick plan out — no device work here):

* **Light scheduling**: ship LEFT-ONLY images on ticks the host predicts
  won't keyframe (the right image's only consumer is the keyframe
  front-end). Halves steady-state upload bytes; see the engine docstring
  (``light_ticks``).
* **Half-res staging**: light ticks may additionally ship 2x-downsampled
  (1/8 of a full tick's bytes), either forced (``light_half_res``) or
  under the adaptive controller.
* **Adaptive controller**: measures the engine's busy wall time per tick
  against the camera period and degrades light ticks to half-res instead
  of silently falling behind the rig (which drops whole frames — the
  reference's sync loop always consumes the newest frame set, reference
  rig.py:358-415). Recovers with wide hysteresis. The reference has no
  equivalent (its on-camera ASIC never contends with SLAM compute for a
  link); this is SURVEY.md §5.3's failure-recovery discipline applied to
  link overload.

Controller safeguards (both measured failure modes of the naive version):

* **Real-time gating**: offline replay drives frames faster than wall
  time; the busy time then exceeds the nominal camera period even though
  NO frames are being dropped, and degrading quality would be pure
  accuracy loss. The controller compares the frame-timestamp rate to the
  wall-clock rate and arms only when the stream is actually paced by a
  real rig (timestamps advancing ~1:1 with the wall).
* **Full-cost-aware restore**: restoring full-res only because HALF-res
  runs under budget is a limit cycle on a link where full-res never fit
  (degrade -> under budget -> restore -> overload -> degrade, dropping
  frames every cycle). The restore gate scales the measured busy EMA by
  the actual full/degraded payload byte ratio — an estimate of what
  full-res would cost — and restores only when THAT fits.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)


def downsample2_host(img: np.ndarray) -> np.ndarray:
    """2x2-mean downsample on the host (uint8-exact, anti-aliased).

    Used by half-res staging: the mean's half-pixel-center alignment
    matches the device-side bilinear upsample, so the round trip
    introduces no geometric shift. Odd trailing rows/cols are cropped
    (the engine requires even dims to enable the mode).
    """
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    a = img[: 2 * h2, : 2 * w2]
    if img.dtype == np.uint8:
        s = a[0::2, 0::2].astype(np.uint16)
        s += a[1::2, 0::2]
        s += a[0::2, 1::2]
        s += a[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    return 0.25 * (a[0::2, 0::2] + a[1::2, 0::2] + a[0::2, 1::2] + a[1::2, 1::2])


class LightController:
    """Schedules light/full ticks and runs the adaptive half-res policy.

    Pure host-side policy: the engine owns the executables and staging;
    this object answers "light or full?", "half-res or full-res?" and
    keeps the cadence-controller state. Constructed once per engine;
    :meth:`resolve` re-derives the active configuration at every
    ``initialize()``.
    """

    def __init__(
        self,
        light_requested: bool | None,
        half_requested: bool,
        adaptive_requested: bool,
        max_interval: int,
    ) -> None:
        self.light_requested = light_requested
        self.half_requested = bool(half_requested)
        self.adaptive_requested = bool(adaptive_requested)
        self.max_interval = max(1, int(max_interval))
        # Streak thresholds are attributes so tests can tighten them.
        self.adapt_up_ticks = 6  # consecutive over-budget EMAs to degrade
        self.adapt_down_ticks = 120  # sustained slack to restore full-res
        self.light = False
        self.light_half = False
        self.adaptive = False
        self.budget_s: float | None = None
        self.reset()

    # ------------------------------------------------------ configuration

    def resolve(
        self,
        devices: int,
        defer_sync: bool,
        height: int,
        width: int,
        fps: float,
    ) -> list[bool]:
        """Derive the active config; returns the light-step variants to
        compile (half-res flags), empty when light ticks are off."""
        light = self.light_requested
        if light is None:
            light = devices == 1 and not defer_sync
        elif light and devices > 1:
            logger.warning("light_ticks is not supported under SPMD; disabled")
            light = False
        elif light and defer_sync:
            logger.warning("light_ticks under defer_sync is pointless; disabled")
            light = False
        self.light = bool(light)
        even_dims = not (height % 2 or width % 2)
        light_half = self.light and self.half_requested
        if light_half and not even_dims:
            logger.warning(
                "light_half_res needs even frame dimensions (%dx%d); disabled",
                width, height,
            )
            light_half = False
        self.light_half = light_half
        # Adaptivity needs BOTH light variants compiled (the switch must
        # never pay a mid-flight jit) and is moot when half-res is forced.
        self.adaptive = (
            self.adaptive_requested and self.light and even_dims
            and not light_half
        )
        self.budget_s = None
        if self.adaptive and fps and fps > 0:
            self.budget_s = 1.0 / float(fps)
        else:
            self.adaptive = False
        self.reset()
        if not self.light:
            return []
        return [light_half] if not self.adaptive else [False, True]

    def reset(self) -> None:
        """Clear runtime state (initialize()/reset())."""
        self.half_active = self.light_half
        self.ticks_since_full = 0
        self._busy_ema: float | None = None
        self._over_streak = 0
        self._under_streak = 0
        # Payload accounting for the full-cost-aware restore gate.
        self._bytes_ema: float | None = None
        self._bytes_full_ema: float | None = None
        # Real-time gating state (frame-ts rate vs wall rate).
        self._last_wall: float | None = None
        self._last_ts: float | None = None
        self._wall_delta_ema: float | None = None
        self._ts_delta_ema: float | None = None
        self._pace_samples = 0
        #: Tests/callers that KNOW the pacing can pin the classification
        #: (True = real-time rig, False = replay); None = heuristic.
        self.pace_override: bool | None = None

    # -------------------------------------------------------- scheduling

    def schedule(
        self,
        *,
        frame_count: int,
        want_reloc: bool,
        tracking: bool,
        num_inliers: int,
        params,
        fin_pose: np.ndarray | None,
        last_kf_odom: np.ndarray | None,
    ) -> bool:
        """Light (left-only) or full tick for the NEXT dispatch.

        Host-side mirror of the device's keyframe policy at a 0.7x safety
        margin, on (pipeline-lagged) finalized diagnostics: the device may
        only refresh on FULL ticks, so this must say "full" before the
        device would say "keyframe". Mis-predictions delay a keyframe to
        the next full tick — bounded by ``max_interval``.
        """
        if not self.light:
            return False
        if frame_count == 0 or want_reloc:
            return False
        if not tracking:
            return False  # warm-up/LOST/RELOCALIZING: refresh/restart paths
        if self.ticks_since_full >= self.max_interval - 1:
            return False
        p = params
        if num_inliers < int(1.3 * p.keyframe_min_inliers):
            return False
        if fin_pose is None or last_kf_odom is None:
            return False
        rel = np.linalg.inv(last_kf_odom) @ fin_pose
        if np.linalg.norm(rel[:3, 3]) > 0.7 * p.keyframe_max_translation:
            return False
        ang = np.arccos(
            np.clip(0.5 * (np.trace(rel[:3, :3]) - 1.0), -1.0, 1.0)
        )
        if ang > 0.7 * p.keyframe_max_rotation:
            return False
        return True

    def note_dispatch(self, light: bool) -> None:
        """Record the tick type actually dispatched."""
        self.ticks_since_full = self.ticks_since_full + 1 if light else 0

    def note_payload(self, staged_bytes: int, full_bytes: int) -> None:
        """Record a tick's actual vs full-quality staged byte counts
        (feeds the restore gate's full-cost estimate)."""
        a = 0.1
        self._bytes_ema = (
            staged_bytes if self._bytes_ema is None
            else (1 - a) * self._bytes_ema + a * staged_bytes
        )
        self._bytes_full_ema = (
            full_bytes if self._bytes_full_ema is None
            else (1 - a) * self._bytes_full_ema + a * full_bytes
        )

    # ----------------------------------------------- cadence controller

    def _paced_realtime(self, now_wall: float, frame_ts: float) -> bool:
        """True when the stream is paced by a real rig.

        On a real rig the consumed frame timestamps advance ~1:1 with the
        wall clock — when keeping up because frames ARRIVE on the wall
        clock, and when overloaded because the sync loop DROPS missed
        frames (the newest-match semantics, reference rig.py:358-415), so
        the consumed timestamps jump by exactly the wall time lost.
        Offline replay breaks the 1:1 tie in either direction: driven
        faster than real time, timestamps outrun the wall (33 ms of
        stream per 5 ms iteration); driven by a slow consumer, they LAG
        it (33 ms of stream per 200 ms tick — no frames are dropped, the
        next index is simply processed late). Degrading quality in either
        replay regime is pure accuracy loss with no frames at stake, so
        the controller only arms inside the ~1:1 band.
        """
        lw, lt = self._last_wall, self._last_ts
        self._last_wall, self._last_ts = now_wall, frame_ts
        if lw is None or lt is None:
            return self._pace_ok()
        dw, dt = now_wall - lw, frame_ts - lt
        if dw <= 0 or dt <= 0:
            return self._pace_ok()
        a = 0.2
        self._wall_delta_ema = (
            dw if self._wall_delta_ema is None
            else (1 - a) * self._wall_delta_ema + a * dw
        )
        self._ts_delta_ema = (
            dt if self._ts_delta_ema is None
            else (1 - a) * self._ts_delta_ema + a * dt
        )
        self._pace_samples += 1
        return self._pace_ok()

    def _pace_ok(self) -> bool:
        if self.pace_override is not None:
            return self.pace_override
        if self._pace_samples < 5 or self._wall_delta_ema is None:
            return False
        return (
            0.6 * self._wall_delta_ema
            <= self._ts_delta_ema
            <= 1.5 * self._wall_delta_ema
        )

    def on_tick(self, busy_s: float, frame_ts: float, now_wall: float) -> None:
        """Advance the degrade-to-keep-up controller after one tick.

        ``busy_s`` is the wall time the tick spent inside
        ``process_frames`` — on an upload-bound link that is where the
        overload shows up (staging handoff, ``device_put`` backpressure,
        finalize fetch waits). The budget is the camera period: a consumer
        busy longer than the inter-frame gap cannot keep the rig's
        cadence, and the sync loop silently drops frames (reference
        rig.get_synchronized_frames returns the newest match).

        EMA over ~5 ticks; degrade after ``adapt_up_ticks`` consecutive
        over-budget readings, restore after ``adapt_down_ticks``
        consecutive readings whose ESTIMATED FULL-RES cost (busy EMA
        scaled by the measured full/actual payload byte ratio) fits in
        80% of the budget. The asymmetry is deliberate: dropping quality
        is urgent (every late tick is a lost camera frame), restoring it
        is not, and a link that flaps around the threshold should settle
        at half-res, not oscillate.
        """
        budget = self.budget_s
        if budget is None:
            return
        paced = self._paced_realtime(now_wall, frame_ts)
        ema = self._busy_ema
        self._busy_ema = busy_s if ema is None else 0.8 * ema + 0.2 * busy_s
        if not self.half_active:
            if not paced:
                # Replay / not-yet-confirmed pace: never DEGRADE (no
                # frames are at stake; see _paced_realtime). Restoring
                # below stays allowed — it only ever improves quality.
                self._over_streak = 0
                return
            if self._busy_ema > 0.92 * budget:
                self._over_streak += 1
                if self._over_streak >= self.adapt_up_ticks:
                    self.half_active = True
                    self._over_streak = 0
                    self._under_streak = 0
                    logger.warning(
                        "cadence %.1f ms/tick over the %.1f ms camera period: "
                        "light ticks now ship half-res (adaptive_half_res)",
                        1e3 * self._busy_ema, 1e3 * budget,
                    )
            else:
                self._over_streak = 0
        else:
            # Estimate what full-res would cost: busy scales ~linearly
            # with staged bytes on the upload-bound links this controller
            # exists for. Without the scale-up, "half-res fits" would
            # restore full-res on a link where full-res never fit — a
            # limit cycle that drops frames every period.
            ratio = 1.0
            if self._bytes_ema and self._bytes_full_ema:
                ratio = max(1.0, self._bytes_full_ema / self._bytes_ema)
            if self._busy_ema * ratio < 0.8 * budget:
                self._under_streak += 1
                if self._under_streak >= self.adapt_down_ticks:
                    self.half_active = False
                    self._under_streak = 0
                    self._over_streak = 0
                    logger.info(
                        "cadence recovered (%.1f ms/tick, est. full-res "
                        "%.1f ms vs %.1f ms budget): light ticks back to "
                        "full-res",
                        1e3 * self._busy_ema, 1e3 * self._busy_ema * ratio,
                        1e3 * budget,
                    )
            else:
                self._under_streak = 0
