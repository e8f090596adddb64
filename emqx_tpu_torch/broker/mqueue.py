"""Session message queue with priorities and drop policy.

The port's own copy of the reference's ``emqx_tpu/broker/mqueue.py``, so
that nothing here imports the JAX package.

Behavioral reference: ``apps/emqx/src/emqx_mqueue.erl`` [U] (SURVEY.md
§2.1): bounded per-session queue buffering messages that cannot be
delivered yet (inflight window full / client offline).  Semantics kept:

* ``max_len`` bound (0 = unbounded); when full the **lowest-priority
  oldest** message is dropped to admit a higher-priority one, else the
  incoming message is dropped (emqx drops the queue head within the same
  priority band — oldest first).
* optional ``store_qos0`` — QoS0 messages may bypass storage when the
  client is disconnected.
* per-topic priorities via ``priorities`` map + ``default_priority``.
* dropped messages are returned so callers can emit ``message.dropped``.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Iterator, List, Optional, Tuple

from .message import Message

__all__ = ["MQueue"]


class MQueue:
    def __init__(
        self,
        max_len: int = 1000,
        store_qos0: bool = True,
        priorities: Optional[Dict[str, int]] = None,
        default_priority: int = 0,
    ) -> None:
        self.max_len = max_len
        self.store_qos0 = store_qos0
        self.priorities = priorities or {}
        self.default_priority = default_priority
        self._qs: Dict[int, Deque[Message]] = {}
        self._len = 0
        self.dropped = 0
        # queued messages carrying a Message-Expiry-Interval: while 0,
        # filter_expired short-circuits — nothing CAN expire, and the
        # O(queue) sweep per ack-driven dequeue was the dominant cost of
        # the acknowledged-delivery path under backlog.  Monotone
        # overcount (decremented on the expiry sweep itself, not on
        # pop/evict): a stale positive only costs one sweep.
        self._expiring = 0

    def __len__(self) -> int:
        return self._len

    def is_empty(self) -> bool:
        return self._len == 0

    def _prio(self, msg: Message) -> int:
        return self.priorities.get(msg.topic, self.default_priority)

    def insert(self, msg: Message) -> Optional[Message]:
        """Queue ``msg``; returns the dropped message if the bound forced
        one out (possibly ``msg`` itself), else None."""
        if msg.qos == 0 and not self.store_qos0:
            self.dropped += 1
            return msg
        prio = self._prio(msg)
        if self.max_len > 0 and self._len >= self.max_len:
            victim = self._drop_lowest_upto(prio)
            if victim is None:
                self.dropped += 1
                return msg  # nothing lower-priority to evict
            self.dropped += 1
            self._push(prio, msg)
            return victim
        self._push(prio, msg)
        return None

    def insert_many(self, msgs: List[Message]) -> List[Message]:
        """Bulk :meth:`insert` — returns every dropped message.  The
        fast path (no bound pressure, no priorities, QoS0 storable)
        appends the whole run into one band without per-message method
        dispatch; anything else falls through to ``insert`` per message
        so drop policy stays identical."""
        if not msgs:
            return []
        room = (self.max_len - self._len) if self.max_len > 0 else len(msgs)
        if (
            room >= len(msgs)
            and not self.priorities
            and (self.store_qos0 or all(m.qos != 0 for m in msgs))
        ):
            prio = self.default_priority
            q = self._qs.get(prio)
            if q is None:
                q = self._qs[prio] = deque()
            q.extend(msgs)
            self._len += len(msgs)
            for m in msgs:
                if "Message-Expiry-Interval" in m.properties:
                    self._expiring += 1
            return []
        dropped: List[Message] = []
        for m in msgs:
            victim = self.insert(m)
            if victim is not None:
                dropped.append(victim)
        return dropped

    def _push(self, prio: int, msg: Message) -> None:
        q = self._qs.get(prio)
        if q is None:
            q = self._qs[prio] = deque()
        q.append(msg)
        self._len += 1
        if "Message-Expiry-Interval" in msg.properties:
            self._expiring += 1

    def _drop_lowest_upto(self, prio: int) -> Optional[Message]:
        """Evict the oldest message from the lowest priority band ≤ prio."""
        for p in sorted(self._qs):
            if p > prio:
                return None
            q = self._qs[p]
            if q:
                self._len -= 1
                victim = q.popleft()
                if not q:
                    del self._qs[p]
                return victim
        return None

    def pop(self) -> Optional[Message]:
        """Dequeue the highest-priority oldest message."""
        for p in sorted(self._qs, reverse=True):
            q = self._qs[p]
            if q:
                self._len -= 1
                msg = q.popleft()
                if not q:
                    del self._qs[p]
                return msg
        return None

    def peek(self) -> Optional[Message]:
        for p in sorted(self._qs, reverse=True):
            if self._qs[p]:
                return self._qs[p][0]
        return None

    def to_list(self) -> List[Message]:
        out: List[Message] = []
        for p in sorted(self._qs, reverse=True):
            out.extend(self._qs[p])
        return out

    def filter_expired(self, now: Optional[float] = None) -> List[Message]:
        """Drop and return expired messages (MQTT5 message expiry).

        O(1) while no queued message carries an expiry interval — the
        common case, and this runs on every ack-driven dequeue."""
        if self._expiring <= 0:
            return []
        expired: List[Message] = []
        expiring = 0
        for p in list(self._qs):
            q = self._qs[p]
            keep = deque()
            for m in q:
                if m.is_expired(now):
                    expired.append(m)
                else:
                    keep.append(m)
                    if "Message-Expiry-Interval" in m.properties:
                        expiring += 1
            if keep:
                self._qs[p] = keep
            else:
                del self._qs[p]
        self._expiring = expiring
        self._len -= len(expired)
        self.dropped += len(expired)
        return expired
