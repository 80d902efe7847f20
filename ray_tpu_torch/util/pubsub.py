"""Publisher/subscriber channels with long-poll delivery (the counterpart
of ``ray_tpu/util/pubsub.py``).

The analogue of the reference's pubsub module (ref: src/ray/pubsub/
— Publisher publisher.h:297 buffers per-channel messages and answers
subscribers' long-poll requests; Subscriber subscriber.h:329 re-polls and
dispatches callbacks).  The reference uses this for GCS broadcast and
worker-to-worker object-eviction signals; here channels back in-process
control-plane fanout (the serve long-poll is a specialized sibling).

Semantics kept from the reference:
- per-channel sequence numbers; a subscriber polls "give me everything
  after seq N" and blocks until something newer arrives (long-poll);
- bounded per-channel history — a subscriber that lags past the buffer gets
  the oldest retained message next (the reference drops to newest-snapshot
  the same way for GCS channels);
- subscriptions are per-key or whole-channel.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple


class Publisher:
    """Per-channel buffered fanout with long-poll wakeups."""

    def __init__(self, max_buffer: int = 1024):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._max_buffer = max_buffer
        #: channel -> deque of (seq, key, message)
        self._channels: Dict[str, deque] = {}
        self._seq: Dict[str, int] = {}

    def publish(self, channel: str, message: Any, key: str = "") -> int:
        """Append; wakes every parked poll.  Returns the message's seq."""
        with self._cv:
            seq = self._seq.get(channel, 0) + 1
            self._seq[channel] = seq
            buf = self._channels.setdefault(
                channel, deque(maxlen=self._max_buffer))
            buf.append((seq, key, message))
            self._cv.notify_all()
            return seq

    def poll(self, channel: str, after_seq: int = 0,
             key: Optional[str] = None,
             timeout: Optional[float] = None) -> List[Tuple[int, str, Any]]:
        """Long-poll: block until messages newer than ``after_seq`` exist
        (optionally filtered by key); returns [] on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                buf = self._channels.get(channel, ())
                out = [(s, k, m) for (s, k, m) in buf
                       if s > after_seq and (key is None or k == key)]
                if out:
                    return out
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return []
                self._cv.wait(remaining)

    def latest_seq(self, channel: str) -> int:
        with self._lock:
            return self._seq.get(channel, 0)


class Subscriber:
    """Callback-dispatching poll loop (ref: subscriber.h:329).

    ``subscribe(channel, callback, key=...)`` registers interest; a single
    daemon thread long-polls the publisher and dispatches new messages in
    order.  ``unsubscribe``/``close`` stop delivery.
    """

    def __init__(self, publisher: Publisher):
        self._pub = publisher
        self._lock = threading.Lock()
        #: (channel, key-or-None) -> list of callbacks
        self._subs: Dict[Tuple[str, Optional[str]], List[Callable]] = {}
        self._cursor: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def subscribe(self, channel: str, callback: Callable[[str, Any], None],
                  key: Optional[str] = None) -> None:
        with self._lock:
            self._subs.setdefault((channel, key), []).append(callback)
            self._cursor.setdefault(channel, self._pub.latest_seq(channel))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="pubsub-subscriber", daemon=True)
                self._thread.start()

    def unsubscribe(self, channel: str, key: Optional[str] = None) -> None:
        with self._lock:
            self._subs.pop((channel, key), None)

    def close(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                channels = {c for (c, _k) in self._subs}
            if not channels:
                time.sleep(0.05)
                continue
            for channel in channels:
                msgs = self._pub.poll(channel,
                                      after_seq=self._cursor.get(channel, 0),
                                      timeout=0.1)
                if not msgs:
                    continue
                self._cursor[channel] = msgs[-1][0]
                with self._lock:
                    subs = {k: list(cbs) for k, cbs in self._subs.items()
                            if k[0] == channel}
                for seq, key, message in msgs:
                    for (c, filt), cbs in subs.items():
                        if filt is not None and filt != key:
                            continue
                        for cb in cbs:
                            try:
                                cb(key, message)
                            except Exception:  # noqa: BLE001 — isolate subscribers
                                pass


_global_publisher: Optional[Publisher] = None
_global_lock = threading.Lock()


def global_publisher() -> Publisher:
    """The process-wide control-plane publisher (ref: the GCS publisher —
    one per head)."""
    global _global_publisher
    with _global_lock:
        if _global_publisher is None:
            _global_publisher = Publisher()
        return _global_publisher
