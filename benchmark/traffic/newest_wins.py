"""The generator ``newest_wins``: the rig's camera clock, open loop.

Frame k is captured at ``origin + k / fps`` (a copy of the clock of
``thor_slam_tpu_torch/bench.py``'s ``_bench_e2e_cadence``). Each tick
waits for the next frame not yet taken and takes the newest one captured,
dropping those it missed, as the rig's ``get_synchronized_frames`` does.
A mix names it with ``"generator": "newest_wins"`` and sets ``fps``.
"""

from __future__ import annotations

import time


class Clock:
    #: Frames become available on the camera clock: a pose's and a map
    #: frame's latency run from their capture.
    paced = True

    def __init__(self, mix: dict, origin: float | None = None):
        self.fps = float(mix["fps"])
        self.origin = time.perf_counter() if origin is None else origin
        self.next_k = 0

    def capture_time(self, k: int) -> float:
        return self.origin + k / self.fps

    def next_tick(self) -> int:
        now = time.perf_counter()
        newest = int((now - self.origin) * self.fps)
        if newest < self.next_k:
            time.sleep(max(0.0, self.capture_time(self.next_k) - now))
            newest = self.next_k
        self.next_k = newest + 1
        return newest

    def hold(self, seconds: float) -> None:
        """The host was held (the profiler's start or stop): the camera
        clock waits for it, so that the stream does not jump."""
        self.origin += seconds
