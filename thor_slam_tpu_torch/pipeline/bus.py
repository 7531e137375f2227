"""In-process pub/sub: the transport the reference delegates to ROS 2 DDS.

A copy of :mod:`thor_slam_tpu.pipeline.bus` (framework-free), so the port
imports nothing of the JAX package.

The reference moves every artifact between OS processes over DDS topics
(reference isaac_ros.py publishers/subscribers, run_pipeline.py
RGBDPublisher). Running the whole stack in one process, the equivalent is a
thread-safe topic bus with bounded per-subscriber queues and the two QoS
semantics the reference actually uses: keep-latest (sensor-data QoS, IMU —
reference isaac_ros.py:115) and keep-all-bounded (RELIABLE, RGB-D —
reference run_pipeline.py:185-190).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class Topic:
    """A named channel with a queue-depth bound and drop policy."""

    name: str
    queue_size: int = 10
    keep_latest_only: bool = False
    _subs: list["Subscription"] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _seq: int = 0

    def publish(self, msg: Any) -> int:
        """Deliver ``msg`` to all subscriber queues; returns the sequence number."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            for sub in self._subs:
                sub._push(seq, msg)
        return seq

    def subscribe(self, callback: Callable[[Any], None] | None = None) -> "Subscription":
        """Create a subscription; with a callback it fires inline on publish."""
        sub = Subscription(self, callback)
        with self._lock:
            self._subs.append(sub)
        return sub

    def unsubscribe(self, sub: "Subscription") -> None:
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)


class Subscription:
    """A bounded queue view of one topic."""

    def __init__(self, topic: Topic, callback: Callable[[Any], None] | None) -> None:
        self._topic = topic
        self._callback = callback
        size = 1 if topic.keep_latest_only else topic.queue_size
        self._queue: deque[tuple[int, Any]] = deque(maxlen=size)
        self._cv = threading.Condition()
        self.dropped = 0

    def _push(self, seq: int, msg: Any) -> None:
        if self._callback is not None:
            self._callback(msg)
            return
        with self._cv:
            if len(self._queue) == self._queue.maxlen:
                self.dropped += 1
            self._queue.append((seq, msg))
            self._cv.notify()

    def get(self, timeout: float | None = None) -> Any | None:
        """Pop the oldest queued message (blocking up to ``timeout``)."""
        with self._cv:
            if not self._queue and not self._cv.wait_for(lambda: bool(self._queue), timeout):
                return None
            return self._queue.popleft()[1]

    def try_get(self) -> Any | None:
        """Pop the oldest queued message, or None immediately."""
        with self._cv:
            return self._queue.popleft()[1] if self._queue else None

    def latest(self) -> Any | None:
        """Peek the newest message, dropping older ones."""
        with self._cv:
            if not self._queue:
                return None
            while len(self._queue) > 1:
                self._queue.popleft()
            return self._queue[-1][1]

    def __len__(self) -> int:
        with self._cv:
            return len(self._queue)


class MessageBus:
    """A namespace of topics (the in-process "DDS domain")."""

    def __init__(self) -> None:
        self._topics: dict[str, Topic] = {}
        self._lock = threading.Lock()

    def topic(self, name: str, queue_size: int = 10, keep_latest_only: bool = False) -> Topic:
        """Get or create a topic; config applies only at creation."""
        with self._lock:
            if name not in self._topics:
                self._topics[name] = Topic(
                    name=name, queue_size=queue_size, keep_latest_only=keep_latest_only
                )
            return self._topics[name]

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._topics)
