"""The port's own copy of the reference's ``emqx_tpu/services/delayed.py``, so
that nothing here imports the JAX package.

Delayed publish: ``$delayed/<secs>/<topic>`` scheduling.

Behavioral reference: ``apps/emqx_delayed`` [U] (SURVEY.md §2.3): a
PUBLISH to ``$delayed/5/a/b`` is intercepted (never routed immediately),
held for 5 seconds, then republished to ``a/b``.  Bad intervals are a
drop; an optional table bound sheds the newest (reference drops when the
mnesia table hits its limit).

Tick-driven like every timer here: the owner's event loop calls
:meth:`tick`, which republishes due messages through the normal broker
pipeline (hooks, retainer, metrics all see them).
"""

from __future__ import annotations

import heapq
import itertools
import time
from typing import List, Optional, Tuple

from ..broker.broker import Broker
from ..broker.hooks import STOP
from ..broker.message import Message

__all__ = ["DelayedPublish"]

PREFIX = "$delayed/"
MAX_DELAY = 4294967.0  # reference caps the interval at 2^32 ms


class DelayedPublish:
    def __init__(self, max_delayed_messages: int = 0, enable: bool = True) -> None:
        self.enable = enable
        self.max_delayed_messages = max_delayed_messages
        self._heap: List[Tuple[float, int, Message]] = []
        self._seq = itertools.count()
        self.stats = {"accepted": 0, "dropped_bad_topic": 0, "dropped_full": 0}

    def __len__(self) -> int:
        return len(self._heap)

    # ------------------------------------------------------------------

    def intercept(self, msg: Message, now: Optional[float] = None) -> Optional[Message]:
        """If ``msg`` targets $delayed/..., queue it and return None
        (callers drop it from the normal pipeline); else return ``msg``."""
        if not self.enable or not msg.topic.startswith(PREFIX):
            return msg
        rest = msg.topic[len(PREFIX):]
        secs_str, _, real_topic = rest.partition("/")
        try:
            secs = float(secs_str)
        except ValueError:
            secs = -1.0
        if not real_topic or not 0 <= secs <= MAX_DELAY:
            self.stats["dropped_bad_topic"] += 1
            return None
        if (
            self.max_delayed_messages > 0
            and len(self._heap) >= self.max_delayed_messages
        ):
            self.stats["dropped_full"] += 1
            return None
        now = now if now is not None else time.time()
        heapq.heappush(
            self._heap,
            (now + secs, next(self._seq), msg.clone(topic=real_topic)),
        )
        self.stats["accepted"] += 1
        return None

    def schedule(
        self, msg: Message, delay: float, now: Optional[float] = None
    ) -> None:
        """Direct enqueue of an already-stripped message (persistence
        restore path — bypasses the $delayed/ topic parsing)."""
        now = now if now is not None else time.time()
        heapq.heappush(self._heap, (now + delay, next(self._seq), msg))

    def due(self, now: Optional[float] = None) -> List[Message]:
        """Pop every message whose delay has elapsed."""
        now = now if now is not None else time.time()
        out: List[Message] = []
        while self._heap and self._heap[0][0] <= now:
            _, _, msg = heapq.heappop(self._heap)
            out.append(msg)
        return out

    def next_deadline(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def to_list(self) -> List[Tuple[float, Message]]:
        return [(at, m) for at, _, m in sorted(self._heap)]

    def entries(self) -> List[Tuple[float, int, Message]]:
        """(fire_at, seq, msg) rows — stable keys for persistence."""
        return sorted(self._heap)

    # ------------------------------------------------------------------

    def attach(self, broker: Broker) -> "DelayedPublish":
        def on_publish(acc: Message):
            if acc is None:
                return acc
            kept = self.intercept(acc)
            if kept is None:
                return (STOP, None)  # swallowed: scheduled or dropped
            return kept

        # intercept before ordinary priority-0 hooks (rule engine etc.)
        broker.hooks.add("message.publish", on_publish, priority=100,
                         name="delayed.intercept")
        self._broker = broker
        return self

    def tick(self, now: Optional[float] = None) -> int:
        """Republish due messages through the normal pipeline."""
        msgs = self.due(now)
        for m in msgs:
            self._broker.publish(m)
        return len(msgs)
