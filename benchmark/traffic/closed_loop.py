"""The generator ``closed_loop``: a replay fed as fast as the engine takes it.

Tick k follows tick k - 1 as soon as its call has returned; no frame is
dropped and no capture time is meaningful, so a closed-loop cell reports
no latency. A mix names it with ``"generator": "closed_loop"``.
"""

from __future__ import annotations

import time


class Clock:
    paced = False

    def __init__(self, mix: dict, origin: float | None = None):
        self.fps = float(mix["fps"])
        self.origin = time.perf_counter() if origin is None else origin
        self.next_k = 0

    def capture_time(self, k: int) -> float:
        return self.origin + k / self.fps

    def next_tick(self) -> int:
        self.next_k += 1
        return self.next_k - 1

    def hold(self, seconds: float) -> None:
        pass
