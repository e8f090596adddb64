"""The port's own copy of the reference's ``emqx_tpu/transport/timerwheel.py``, so
that nothing here imports the JAX package.

Hashed timer wheel: O(1) coarse timers for the connection plane.

Behavioral reference: Erlang/OTP's timer wheel (and esockd's use of it
for per-connection keepalive) [U].  The per-connection timer model the
per-connection datapaths use — one ``loop.call_later`` per connection per tick —
costs one timer-heap entry, one heap pop and one scheduled callback *per
connection per second*: a 10k-connection node burns 10k heap operations
and 10k loop callbacks every second just deciding that nobody timed out.

The wheel replaces that with coarse hashed buckets:

* :meth:`call_later` / :meth:`call_repeat` insert into the bucket for
  ``ceil((now + delay) / tick)`` — an O(1) dict append, no heap;
* ``cancel()`` is O(1) — the entry is flagged dead and skipped (and
  dropped from its bucket) at expiry;
* the wheel keeps **exactly one** ``loop.call_later`` outstanding, ever:
  each advance runs every entry in the due buckets — a 10k-connection
  keepalive storm costs ONE scheduled callback whose body walks the
  bucket, not 10k separately scheduled callbacks — then re-arms for the
  next non-empty tick;
* when the last entry dies the wheel goes idle (no scheduled callback at
  all) and re-arms lazily on the next insert.

Timers fire **late, never early**: a delay rounds *up* to the next
bucket boundary, so observed latency is ``delay .. delay + tick``.
That is exactly right for keepalive (spec allows 1.5×) and retry
(interval >> tick) checks, and wrong for anything needing sub-tick
precision — which stays on ``loop.call_later``.

One wheel per event loop: the wheel is not thread-safe by design (it
lives and dies with its loop); each connection shard owns its own.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger(__name__)

__all__ = ["TimerWheel", "WheelTimer"]


class WheelTimer:
    """Handle for one scheduled callback; ``cancel()`` is O(1) — the
    entry is flagged dead (and released from the live gauge) now, and
    physically dropped when its bucket expires."""

    __slots__ = ("fn", "interval", "slot", "cancelled", "wheel")

    def __init__(self, fn: Callable[[], Any], interval: Optional[float],
                 slot: int, wheel: "Optional[TimerWheel]" = None) -> None:
        self.fn = fn
        self.interval = interval   # None = one-shot; seconds = periodic
        self.slot = slot
        self.cancelled = False
        self.wheel = wheel

    def cancel(self) -> None:
        if self.cancelled:
            return
        self.cancelled = True
        self.fn = None  # drop the ref cycle (conn → timer → bound method)
        w = self.wheel
        if w is not None:
            w._live -= 1


class TimerWheel:
    """Coarse hashed buckets + one outstanding loop timer (see module
    docstring).  ``clock``/``schedule`` are injectable for tests."""

    def __init__(
        self,
        tick_s: float = 1.0,
        clock: Optional[Callable[[], float]] = None,
        metrics: Any = None,
    ) -> None:
        if tick_s <= 0:
            raise ValueError("tick_s must be positive")
        self.tick_s = tick_s
        self.metrics = metrics
        self._clock = clock if clock is not None else time.monotonic
        self._buckets: Dict[int, List[WheelTimer]] = {}
        self._live = 0          # non-cancelled entries (gauge)
        self._handle = None     # the ONE outstanding loop.call_later
        self._armed_slot: Optional[int] = None
        self._closed = False
        self.ticks = 0          # advances run (test/ops visibility)

    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return self._live

    def _slot_for(self, delay: float) -> int:
        # ceil to the next bucket boundary: never fire early (landing
        # exactly on a boundary fires at that boundary's advance)
        now = self._clock()
        x = (now + max(delay, 0.0)) / self.tick_s
        slot = int(x)
        if slot < x:
            slot += 1
        cur = int(now / self.tick_s)
        return slot if slot > cur else cur + 1

    def call_later(self, delay: float, fn: Callable[[], Any]) -> WheelTimer:
        """One-shot timer after >= ``delay`` seconds (bucket-rounded)."""
        return self._insert(WheelTimer(fn, None, self._slot_for(delay),
                                       self))

    def call_repeat(self, interval: float,
                    fn: Callable[[], Any]) -> WheelTimer:
        """Periodic timer every ~``interval`` seconds (bucket-rounded,
        re-inserted after each firing, so a slow callback cannot pile
        up overlapping runs)."""
        if interval <= 0:
            raise ValueError("interval must be positive")
        return self._insert(WheelTimer(fn, interval,
                                       self._slot_for(interval), self))

    def sleep(self, delay: float) -> "asyncio.Future":
        """Awaitable one-shot: the wheel-backed replacement for periodic
        ``asyncio.sleep`` loops (gateway sweepers) — the sleeper rides a
        bucket instead of the loop's timer heap, so N sleepers cost one
        scheduled callback per tick."""
        fut = asyncio.get_running_loop().create_future()

        def _wake() -> None:
            if not fut.done():
                fut.set_result(None)

        timer = self.call_later(delay, _wake)
        # a cancelled await (task teardown) must not leave a dead entry
        # firing into a closed context
        fut.add_done_callback(
            lambda f: timer.cancel() if f.cancelled() else None)
        return fut

    def _insert(self, timer: WheelTimer) -> WheelTimer:
        if self._closed:
            timer.cancelled = True
            return timer
        bucket = self._buckets.get(timer.slot)
        if bucket is None:
            bucket = self._buckets[timer.slot] = []
        bucket.append(timer)
        self._live += 1
        self._arm()
        return timer

    # ------------------------------------------------------------------

    def _arm(self) -> None:
        """(Re)schedule the single outstanding loop timer for the
        earliest non-empty bucket."""
        if self._closed or not self._buckets:
            return
        nxt = min(self._buckets)
        if self._handle is not None:
            if self._armed_slot is not None and self._armed_slot <= nxt:
                return  # already armed at or before the earliest bucket
            self._handle.cancel()
        delay = max(nxt * self.tick_s - self._clock(), 0.0)
        try:
            loop = asyncio.get_event_loop()
        except RuntimeError:
            # no loop in this thread (pure-logic use with an injected
            # clock): stay unarmed — the next insert from loop context
            # re-arms
            self._handle = None
            self._armed_slot = None
            return
        self._armed_slot = nxt
        self._handle = loop.call_later(delay, self._advance)

    def _advance(self) -> None:
        """Run every entry in every due bucket — the one callback per
        wheel tick, regardless of how many timers are due."""
        self._handle = None
        self._armed_slot = None
        if self._closed:
            return
        self.ticks += 1
        cur = int(self._clock() / self.tick_s)
        due = [s for s in self._buckets if s <= cur]
        for slot in sorted(due):
            for timer in self._buckets.pop(slot):
                if timer.cancelled:
                    continue  # cancel() already released the gauge
                fn = timer.fn
                if timer.interval is None:
                    # one-shot consumed: mark cancelled so a late
                    # cancel() cannot double-release the gauge
                    timer.cancelled = True
                    timer.fn = None
                    self._live -= 1
                try:
                    fn()
                except Exception:
                    log.exception("timer wheel callback failed")
                if timer.interval is not None and not timer.cancelled:
                    timer.slot = self._slot_for(timer.interval)
                    self._buckets.setdefault(timer.slot,
                                             []).append(timer)
        if self.metrics is not None:
            self.metrics.set("broker.timer.wheel_conns", self._live)
        self._arm()

    def close(self) -> None:
        """Drop every timer and the outstanding loop callback."""
        self._closed = True
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
        for bucket in self._buckets.values():
            for timer in bucket:
                timer.cancelled = True
        self._buckets.clear()
        self._live = 0

    def info(self) -> Dict[str, Any]:
        return {"tick_s": self.tick_s, "timers": self._live,
                "buckets": len(self._buckets), "ticks": self.ticks}
