"""The port's own copy of the reference's ``emqx_tpu/broker/olp.py``, so
that nothing here imports the JAX package.

Overload protection: shed load when the control plane runs hot.

Behavioral reference: ``emqx_olp.erl`` / ``emqx_vm_mon`` / ``emqx_os_mon``
[U] (SURVEY.md §2.1): scheduler-usage-based shedding of new connections
and low-priority work, with alarms on sustained overload.  Our signals:
event-loop lag (sampled by :class:`LoopLagProbe`, the ``emqx_vm_mon``
scheduler-usage analog), pending publish-queue depth, and match-kernel
backlog — pushed in via :meth:`Olp.report`.

The lag probe closes a gap: the fanout drain reports queue depth,
but a CPU-saturated loop with an *empty* queue (every cycle spent inside
connection handlers) never grew a queue to observe.  Sleep drift is the
direct measurement — ``asyncio.sleep(t)`` wakes ``t + lag`` after it was
scheduled, where ``lag`` is exactly how far behind the loop is running.

**Brownout ladder** (the serve-plane extension): sustained overload
escalates through three stages instead of flipping one binary, so the
match serve plane degrades *latency-first* — stage 1 shrinks the serve
batch caps (smaller kernels, lower fill latency), stage 2 sheds QoS0
prefetches to the CPU trie (the device budget goes to acknowledged
traffic), stage 3 is full CPU serve.  :meth:`Olp.brownout_level` derives
the stage from how long the current overload episode has lasted: level 1
on entry, +1 per ``escalate`` seconds hot (default: the cooloff window),
capped at 3.  De-escalation rides the existing cooloff — once reports go
quiet the episode ends and the level drops straight to 0.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Callable, Optional

from ..observe.alarm import Alarms

__all__ = ["Olp", "LoopLagProbe"]


class Olp:
    def __init__(
        self,
        alarms: Optional[Alarms] = None,
        max_loop_lag: float = 0.5,
        max_queue_depth: int = 100_000,
        cooloff: float = 5.0,
        escalate: Optional[float] = None,
    ) -> None:
        self.alarms = alarms
        self.max_loop_lag = max_loop_lag
        self.max_queue_depth = max_queue_depth
        self.cooloff = cooloff
        # seconds of sustained overload per brownout stage; defaults to
        # the cooloff window so the ladder and recovery share one clock
        self.escalate = escalate if escalate is not None else cooloff
        self._overloaded_at: Optional[float] = None
        self._hot_since: Optional[float] = None  # current episode start
        self.shed_count = 0

    def report(
        self, loop_lag: float = 0.0, queue_depth: int = 0,
        now: Optional[float] = None,
    ) -> None:
        now = now if now is not None else time.time()
        hot = loop_lag > self.max_loop_lag or queue_depth > self.max_queue_depth
        if hot:
            if self._hot_since is None or (
                self._overloaded_at is not None
                and now - self._overloaded_at > self.cooloff
            ):
                # first hot report, or overload resuming after a silent
                # gap longer than the cooloff: a NEW episode — the ladder
                # must not inherit the old episode's escalation
                self._hot_since = now
            self._overloaded_at = now
            if self.alarms is not None:
                self.alarms.activate(
                    "overload",
                    {"loop_lag": loop_lag, "queue_depth": queue_depth},
                    "control plane overloaded",
                )
        elif (
            self._overloaded_at is not None
            and now - self._overloaded_at > self.cooloff
        ):
            self._overloaded_at = None
            self._hot_since = None
            if self.alarms is not None:
                self.alarms.deactivate("overload")

    def overloaded(self, now: Optional[float] = None) -> bool:
        if self._overloaded_at is None:
            return False
        now = now if now is not None else time.time()
        return now - self._overloaded_at <= self.cooloff

    def brownout_level(self, now: Optional[float] = None) -> int:
        """Staged-brownout stage (0–3) for the serve plane.

        0 = healthy; 1 on overload entry (shrink serve batch caps); one
        more stage per ``escalate`` seconds of sustained overload —
        2 sheds QoS0 prefetches to CPU, 3 is full CPU serve.  Returns to
        0 as soon as :meth:`overloaded` clears (cooloff elapsed)."""
        now = now if now is not None else time.time()
        if not self.overloaded(now) or self._hot_since is None:
            return 0
        if self.escalate <= 0:
            return 3
        return 1 + min(2, int((now - self._hot_since) / self.escalate))

    def should_shed_connect(self, now: Optional[float] = None) -> bool:
        """New CONNECTs are the first thing shed under overload."""
        if self.overloaded(now):
            self.shed_count += 1
            return True
        return False


class LoopLagProbe:
    """Sleep-drift sampler feeding :meth:`Olp.report`.

    Each tick schedules ``asyncio.sleep(interval)`` and measures how
    late it woke; an EWMA (``alpha``) smooths scheduler jitter so one
    GC pause doesn't trip overload, while sustained saturation does.
    Runs as a supervised child (``olp.lag_probe``); the clock and sleep
    are injectable so tests drive it deterministically.
    """

    def __init__(
        self,
        olp: Olp,
        metrics: Any = None,
        interval: float = 0.1,
        alpha: float = 0.3,
        clock: Optional[Callable[[], float]] = None,
        sleep: Optional[Callable[[float], Any]] = None,
    ) -> None:
        self.olp = olp
        self.metrics = metrics
        self.interval = interval
        self.alpha = alpha
        self._clock = clock if clock is not None else time.monotonic
        self._sleep = sleep if sleep is not None else asyncio.sleep
        self.lag = 0.0       # EWMA-smoothed drift (seconds)
        self.last_raw = 0.0  # most recent un-smoothed sample
        self.samples = 0

    def observe(self, raw_lag: float) -> float:
        """Fold one drift sample in and report it; returns the EWMA.
        Split out from :meth:`run` so tests feed samples directly."""
        raw_lag = max(0.0, raw_lag)
        self.last_raw = raw_lag
        self.samples += 1
        self.lag = (raw_lag if self.samples == 1
                    else self.lag * (1.0 - self.alpha)
                    + raw_lag * self.alpha)
        self.olp.report(loop_lag=self.lag)
        if self.metrics is not None:
            self.metrics.set("broker.olp.loop_lag_us",
                             int(self.lag * 1e6))
        return self.lag

    async def run(self) -> None:
        """The supervised sampler loop."""
        while True:
            t0 = self._clock()
            await self._sleep(self.interval)
            self.observe(self._clock() - t0 - self.interval)

    def info(self) -> dict:
        return {
            "lag_ms": round(self.lag * 1e3, 3),
            "last_raw_ms": round(self.last_raw * 1e3, 3),
            "samples": self.samples,
        }
