"""Inflight window: unacked QoS1/2 deliveries awaiting client response.

The port's own copy of the reference's ``emqx_tpu/broker/inflight.py``, so
that nothing here imports the JAX package.

Behavioral reference: ``apps/emqx/src/emqx_inflight.erl`` [U] (SURVEY.md
§2.1): bounded insertion-ordered map packet-id → record, with
retry/expiry iteration in insertion order.

The retry scan is incremental: entries also ride an expiry-ordered lazy
heap, so :meth:`older_than` pops only the entries actually due instead
of walking the full window every timer tick (with thousands of sessions
× a 1 s retry tick, the full-window walk was pure per-tick overhead —
the acknowledged-delivery analog of the per-message publish walk the
fanout pipeline amortized).  Heap entries are invalidated lazily on
``delete``/``touch``; the map stays the source of truth.
"""

from __future__ import annotations

import heapq
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

from .. import faultinject as _fi

__all__ = ["Inflight", "InflightFullError"]


class InflightFullError(Exception):
    pass


class Inflight:
    def __init__(self, max_size: int = 32) -> None:
        self.max_size = max_size
        self._d: Dict[int, Tuple[float, Any]] = {}  # pid -> (ts, value)
        # lazy expiry heap of (ts, pid); an entry is live iff the map
        # still holds this pid at exactly this ts
        self._exp: List[Tuple[float, int]] = []

    def __len__(self) -> int:
        return len(self._d)

    def is_full(self) -> bool:
        return self.max_size > 0 and len(self._d) >= self.max_size

    def is_empty(self) -> bool:
        return not self._d

    def contains(self, pid: int) -> bool:
        return pid in self._d

    def insert(self, pid: int, value: Any, now: Optional[float] = None) -> None:
        if _fi._injector is not None:
            _fi._injector.check("inflight.insert")
        if self.is_full():
            raise InflightFullError(f"inflight window full ({self.max_size})")
        if pid in self._d:
            raise KeyError(f"packet id {pid} already inflight")
        ts = time.time() if now is None else now
        self._d[pid] = (ts, value)
        heapq.heappush(self._exp, (ts, pid))

    def insert_many(
        self, items: Iterable[Tuple[int, Any]], now: Optional[float] = None
    ) -> None:
        """Bulk :meth:`insert` sharing ONE timestamp — the fanout
        pipeline admits a whole per-session batch with a single clock
        read and heap extension instead of one of each per message."""
        if _fi._injector is not None:
            _fi._injector.check("inflight.insert")
        items = list(items)
        if not items:
            return
        if self.max_size > 0 and len(self._d) + len(items) > self.max_size:
            raise InflightFullError(
                f"inflight window full ({self.max_size})")
        ts = time.time() if now is None else now
        d = self._d
        for pid, _ in items:
            if pid in d:
                raise KeyError(f"packet id {pid} already inflight")
        for pid, value in items:
            d[pid] = (ts, value)
            heapq.heappush(self._exp, (ts, pid))

    def update(self, pid: int, value: Any) -> None:
        if pid not in self._d:
            raise KeyError(pid)
        ts, _ = self._d[pid]
        self._d[pid] = (ts, value)

    def update_many(self, pids: Iterable[int], value: Any) -> None:
        """Bulk phase transition: every ``pid`` takes the SAME new value
        with its timestamp preserved — the QoS2 state machine moves a
        whole PUBREC run from ``publish`` to ``pubrel`` in one pass."""
        d = self._d
        for pid in pids:
            ts, _ = d[pid]
            d[pid] = (ts, value)

    def touch(self, pid: int, now: Optional[float] = None) -> None:
        """Reset the age clock (after a retransmission)."""
        if pid not in self._d:
            raise KeyError(pid)
        _, v = self._d[pid]
        ts = now if now is not None else time.time()
        self._d[pid] = (ts, v)
        heapq.heappush(self._exp, (ts, pid))  # old heap entry goes stale

    def delete(self, pid: int) -> Optional[Any]:
        item = self._d.pop(pid, None)
        # stale heap entries collect until a compaction threshold; the
        # rebuild is amortized O(1) per delete
        if len(self._exp) > 64 and len(self._exp) > 4 * len(self._d):
            self._exp = [(ts, p) for p, (ts, _) in self._d.items()]
            heapq.heapify(self._exp)
        return item[1] if item is not None else None

    def lookup(self, pid: int) -> Optional[Any]:
        item = self._d.get(pid)
        return item[1] if item is not None else None

    def items(self) -> Iterator[Tuple[int, float, Any]]:
        """(pid, inserted_at, value) in insertion order."""
        for pid, (ts, v) in self._d.items():
            yield pid, ts, v

    def older_than(self, age_s: float, now: Optional[float] = None) -> List[int]:
        """Pids due for retry, in age order (oldest first).

        Incremental: pops the expiry heap only while the head is due, so
        an idle tick is O(1) instead of O(window).  Due entries are
        pushed back — a caller that neither ``touch``es nor ``delete``s
        them sees them again next call, exactly like the full scan did.
        """
        if _fi._injector is not None:
            _fi._injector.check("inflight.retry")
        now = now if now is not None else time.time()
        cutoff = now - age_s
        exp = self._exp
        d = self._d
        out: List[int] = []
        seen: set = set()
        push_back: List[Tuple[float, int]] = []
        while exp and exp[0][0] <= cutoff:
            ts, pid = heapq.heappop(exp)
            cur = d.get(pid)
            if cur is None or cur[0] != ts or pid in seen:
                continue  # deleted / touched since / duplicate heap entry
            seen.add(pid)
            out.append(pid)
            push_back.append((ts, pid))
        for e in push_back:
            heapq.heappush(exp, e)
        return out
