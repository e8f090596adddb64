"""Per-client session state: subscriptions, delivery, QoS 0/1/2 flows.

The port's own copy of the reference's ``emqx_tpu/broker/session.py``, so
that nothing here imports the JAX package.

Behavioral reference: ``apps/emqx/src/emqx_session.erl`` [U] (SURVEY.md
§2.1): subscriptions map, inflight window for unacked QoS1/2, message
queue for deferred deliveries, ``awaiting_rel`` for inbound QoS2
exactly-once, packet-id allocation, retry with DUP, session expiry.

The session is a pure state machine: methods return the packets the
caller (channel/connection layer) must send, never performing IO.

Outbound QoS flows::

    QoS1: deliver → PUBLISH(pid) inflight → puback(pid) → done
    QoS2: deliver → PUBLISH(pid) inflight → pubrec(pid) → PUBREL(pid)
          → pubcomp(pid) → done

Inbound QoS2 (exactly-once)::

    recv PUBLISH(pid): awaiting_rel[pid] (dedup) → reply PUBREC
    recv PUBREL(pid):  release → reply PUBCOMP
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .inflight import Inflight, InflightFullError
from .message import Message
from .mqueue import MQueue

__all__ = ["SubOpts", "Session", "Publish", "MAX_PACKET_ID"]

MAX_PACKET_ID = 0xFFFF


@dataclass(frozen=True)
class SubOpts:
    """MQTT subscription options (v5 §3.8.3.1)."""

    qos: int = 0
    nl: bool = False    # No Local
    rap: bool = False   # Retain As Published
    rh: int = 0         # Retain Handling (0/1/2)
    share: Optional[str] = None  # $share group name
    subid: Optional[int] = None  # Subscription Identifier


@dataclass
class Publish:
    """An outbound PUBLISH the connection layer must send."""

    pid: Optional[int]   # None for QoS0
    msg: Message


class Session:
    def __init__(
        self,
        clientid: str,
        clean_start: bool = True,
        max_inflight: int = 32,
        max_awaiting_rel: int = 100,
        retry_interval: float = 30.0,
        await_rel_timeout: float = 300.0,
        expiry_interval: float = 0.0,
        mqueue: Optional[MQueue] = None,
        max_mqueue_len: Optional[int] = None,
    ) -> None:
        self.clientid = clientid
        self.clean_start = clean_start
        self.connected = True  # False while the client is away (resumable)
        self.created_at = time.time()
        self.subscriptions: Dict[str, SubOpts] = {}
        self.inflight = Inflight(max_inflight)
        if mqueue is None:
            mqueue = (
                MQueue(max_len=max_mqueue_len)
                if max_mqueue_len is not None else MQueue()
            )
        self.mqueue = mqueue
        self.awaiting_rel: Dict[int, float] = {}  # inbound QoS2 pids
        self.max_awaiting_rel = max_awaiting_rel
        self.retry_interval = retry_interval
        self.await_rel_timeout = await_rel_timeout
        self.expiry_interval = expiry_interval
        self._next_pid = 0
        # counter table (broker.metrics), set by Broker.open_session;
        # sessions built directly in tests run unmetered
        self.metrics = None

    # ------------------------------------------------------------------
    # subscriptions
    # ------------------------------------------------------------------

    def subscribe(self, flt: str, opts: SubOpts) -> bool:
        """Returns True if this is a new subscription (vs an upgrade)."""
        is_new = flt not in self.subscriptions
        self.subscriptions[flt] = opts
        return is_new

    def unsubscribe(self, flt: str) -> bool:
        return self.subscriptions.pop(flt, None) is not None

    # ------------------------------------------------------------------
    # packet ids
    # ------------------------------------------------------------------

    def next_packet_id(self) -> int:
        """1..65535, skipping ids still inflight (emqx wraps the same way).

        Raises :class:`InflightFullError` when the id space is saturated
        instead of spinning the full 1..65535 range looking for a free
        slot that cannot exist — callers treat it as window backpressure
        (queue the message) rather than a crash.
        """
        inflight = self.inflight
        if len(inflight) >= MAX_PACKET_ID:
            raise InflightFullError("packet-id space exhausted")
        contains = inflight.contains
        for _ in range(MAX_PACKET_ID):
            self._next_pid = (self._next_pid % MAX_PACKET_ID) + 1
            if not contains(self._next_pid):
                return self._next_pid
        raise InflightFullError("no free packet id after one wrap")

    def alloc_packet_ids(self, k: int) -> List[int]:
        """Allocate ``k`` free packet ids in ONE wrap/skip scan.

        The batched delivery path reserves a (usually contiguous) run of
        ids per admitted batch instead of re-entering the wrap loop per
        message.  Raises :class:`InflightFullError` up front when fewer
        than ``k`` ids are free; otherwise one pass over at most the
        full id cycle finds them (each returned id is distinct — the
        scan ends before any position repeats)."""
        if k <= 0:
            return []
        inflight = self.inflight
        if MAX_PACKET_ID - len(inflight) < k:
            raise InflightFullError(
                f"{k} packet ids requested, "
                f"{MAX_PACKET_ID - len(inflight)} free")
        out: List[int] = []
        pid = self._next_pid
        contains = inflight.contains
        append = out.append
        while len(out) < k:
            pid = (pid % MAX_PACKET_ID) + 1
            if not contains(pid):
                append(pid)
        self._next_pid = pid
        return out

    # ------------------------------------------------------------------
    # outbound delivery
    # ------------------------------------------------------------------

    def deliver(self, msgs: List[Message]) -> Tuple[List[Publish], List[Message]]:
        """Accept routed messages for this session.

        Returns (to_send, dropped): QoS0 always sends; QoS1/2 send while
        the inflight window has room, else queue; queue overflow drops.

        Called once per session per batch by the fanout pipeline, so the
        common whole-batch cases (all-QoS0 to a connected client, client
        away) take amortized bulk paths instead of the per-message loop.
        """
        if not self.connected:
            # client away: everything queues (QoS0 subject to the
            # mqueue's store_qos0 policy) and drains on resume
            return [], self.mqueue.insert_many(msgs)
        if len(msgs) == 1 and msgs[0].qos == 0:
            # one routed QoS0 message (the publish path): the loop below
            # without its generator and list
            d = msgs[0].__dict__
            p = d.get("_pub0")
            if p is None:
                p = d["_pub0"] = Publish(None, msgs[0])
            return [p], []
        if all(m.qos == 0 for m in msgs):
            # fanout hot path: no window/queue bookkeeping.  A QoS0
            # Publish (pid None) is never retried or mutated, so every
            # session fanning out the same routed Message shares ONE
            # Publish object, cached on the message like its wire bytes.
            out = []
            append = out.append
            for m in msgs:
                d = m.__dict__
                p = d.get("_pub0")
                if p is None:
                    p = d["_pub0"] = Publish(None, m)
                append(p)
            return out, []
        # batched QoS1/2 admission: ONE id-run allocation + ONE bulk
        # inflight insert (single timestamp) for however many messages
        # the window has room for right now; the rest queue, exactly as
        # the per-message loop decided
        out: List[Publish] = []
        dropped: List[Message] = []
        inflight = self.inflight
        mqueue = self.mqueue
        n12 = sum(1 for m in msgs if m.qos != 0)
        admit = min(n12, self._window_room())
        pids = self.alloc_packet_ids(admit)
        entries: List[Tuple[int, Any]] = []
        i = 0
        for msg in msgs:
            if msg.qos == 0:
                out.append(Publish(None, msg))
                continue
            if i < admit:
                pid = pids[i]
                i += 1
                entries.append((pid, ("publish", msg)))
                out.append(Publish(pid, msg))
            else:
                victim = mqueue.insert(msg)
                if victim is not None:
                    dropped.append(victim)
        self._admit(entries)
        return out, dropped

    def _window_room(self) -> int:
        """Free inflight slots right now, bounded by the free packet-id
        space (an unbounded window still cannot outgrow 1..65535)."""
        inflight = self.inflight
        room = MAX_PACKET_ID - len(inflight)
        if inflight.max_size > 0:
            room = min(room, inflight.max_size - len(inflight))
        return max(0, room)

    def _admit(self, entries: List[Tuple[int, Any]]) -> None:
        if not entries:
            return
        self.inflight.insert_many(entries)
        if self.metrics is not None and len(entries) > 1:
            self.metrics.inc("broker.inflight.batch_admitted", len(entries))

    def _dequeue(self) -> List[Publish]:
        # expire first so drops are accounted in mqueue.dropped (and
        # visible via Session.info()) like every other drop path
        self.mqueue.filter_expired()
        room = self._window_room()
        if room <= 0 or self.mqueue.is_empty():
            return []
        msgs: List[Message] = []
        pop = self.mqueue.pop
        while len(msgs) < room:
            msg = pop()
            if msg is None:
                break
            msgs.append(msg)
        pids = self.alloc_packet_ids(len(msgs))
        self._admit([(pid, ("publish", m)) for pid, m in zip(pids, msgs)])
        return [Publish(pid, m) for pid, m in zip(pids, msgs)]

    def puback(self, pid: int) -> Tuple[Optional[Message], List[Publish]]:
        """QoS1 ack.  Returns (acked message | None, next publishes)."""
        item = self.inflight.lookup(pid)
        if item is None or item[0] != "publish":
            return None, []
        self.inflight.delete(pid)
        return item[1], self._dequeue()

    def puback_batch(self, pids: List[int]) -> Tuple[List[Message], List[Publish]]:
        """A burst of QoS1 acks in one call: every pid releases its
        window slot first (unknown / wrong-state pids ignored, exactly
        like :meth:`puback`), then ONE :meth:`_dequeue` refills the
        freed room — one id-run allocation and one bulk inflight insert
        instead of a full ack→refill cycle per packet.  Returns
        (acked messages, next publishes); refill order matches the
        sequential per-ack order (mqueue FIFO)."""
        inflight = self.inflight
        acked: List[Message] = []
        for pid in pids:
            item = inflight.lookup(pid)
            if item is None or item[0] != "publish":
                continue
            inflight.delete(pid)
            acked.append(item[1])
        return acked, (self._dequeue() if acked else [])

    def pubrec(self, pid: int) -> bool:
        """QoS2 phase 1 ack; caller must send PUBREL(pid).  False if the
        pid is unknown (protocol error — reply with reason 0x92)."""
        item = self.inflight.lookup(pid)
        if item is None or item[0] != "publish":
            return False
        # keep the slot (pid stays allocated) but drop the payload
        self.inflight.update(pid, ("pubrel", None))
        return True

    def pubrec_batch(self, pids: List[int]) -> List[bool]:
        """A run of QoS2 phase-1 acks in one call: the known pids make
        ONE bulk ``publish`` → ``pubrel`` inflight transition.  Returns
        per-pid verdicts in order, exactly what sequential
        :meth:`pubrec` calls would have said (a duplicate pid in the
        run is False the second time — the slot already transitioned)."""
        inflight = self.inflight
        lookup = inflight.lookup
        out: List[bool] = []
        known: List[int] = []
        seen: set = set()
        for pid in pids:
            item = lookup(pid)
            if item is None or item[0] != "publish" or pid in seen:
                out.append(False)
            else:
                known.append(pid)
                seen.add(pid)
                out.append(True)
        if known:
            inflight.update_many(known, ("pubrel", None))
            if self.metrics is not None and len(pids) > 1:
                self.metrics.inc("broker.qos2.batch")
        return out

    def pubcomp(self, pid: int) -> Tuple[bool, List[Publish]]:
        """QoS2 completion.  Returns (known?, next publishes)."""
        item = self.inflight.lookup(pid)
        if item is None or item[0] != "pubrel":
            return False, []
        self.inflight.delete(pid)
        return True, self._dequeue()

    def pubcomp_batch(self, pids: List[int]) -> Tuple[int, List[Publish]]:
        """A run of QoS2 completions: every known pid releases its
        window slot first, then ONE :meth:`_dequeue` refills the freed
        room (one id-run allocation + one bulk insert), mirroring
        :meth:`puback_batch`.  Returns (known count, next publishes)."""
        inflight = self.inflight
        known = 0
        for pid in pids:
            item = inflight.lookup(pid)
            if item is None or item[0] != "pubrel":
                continue
            inflight.delete(pid)
            known += 1
        if known and self.metrics is not None and len(pids) > 1:
            self.metrics.inc("broker.qos2.batch")
        return known, (self._dequeue() if known else [])

    def retry(self, now: Optional[float] = None) -> List[Tuple[int, str, Optional[Message]]]:
        """Unacked items older than retry_interval, for re-send with DUP.

        Returns [(pid, kind, msg|None)]: kind 'publish' → resend
        PUBLISH(dup), kind 'pubrel' → resend PUBREL.  Peek + commit in
        one step — callers that can observe the resend write failing
        use :meth:`retry_peek` / :meth:`retry_commit` instead, so a
        dead transport doesn't burn a DUP clone (and reset the age
        clock) for a resend that never reached the wire."""
        entries = self.retry_peek(now)
        self.retry_commit(entries, now)
        out: List[Tuple[int, str, Optional[Message]]] = []
        for pid, kind, msg in entries:
            if kind == "publish":
                item = self.inflight.lookup(pid)
                if item is not None:
                    msg = item[1]    # the committed DUP clone
            out.append((pid, kind, msg))
        return out

    def retry_peek(
        self, now: Optional[float] = None
    ) -> List[Tuple[int, str, Optional[Message]]]:
        """Due entries WITHOUT mutating session state: no clone stored,
        no age-clock touch.  ``msg`` is the stored message as-is (DUP
        flag only set if a previous retry committed a clone); the
        caller renders the resend with DUP regardless and calls
        :meth:`retry_commit` once the write went through."""
        out = []
        lookup = self.inflight.lookup
        for pid in self.inflight.older_than(self.retry_interval, now):
            kind, msg = lookup(pid)
            out.append((pid, kind, msg))
        return out

    def retry_commit(
        self,
        entries: List[Tuple[int, str, Optional[Message]]],
        now: Optional[float] = None,
    ) -> None:
        """Commit a peeked retry batch after the resend flush succeeded:
        store the DUP clone and reset the age clock (one resend per
        retry_interval).  Entries acked between peek and commit are
        skipped."""
        inflight = self.inflight
        for pid, kind, msg in entries:
            cur = inflight.lookup(pid)
            if cur is None:
                continue
            # only store the clone while the slot is still in the
            # peeked phase — an ack that transitioned it (publish →
            # pubrel) between peek and commit must not be clobbered
            if kind == "publish" and cur[0] == "publish" \
                    and msg is not None and not msg.dup:
                inflight.update(pid, (kind, msg.clone(dup=True)))
            inflight.touch(pid, now)

    # ------------------------------------------------------------------
    # inbound QoS2
    # ------------------------------------------------------------------

    def publish_qos2(self, pid: int, msg: Message) -> str:
        """Register an inbound QoS2 PUBLISH.

        Returns 'ok' (new, broker must route it), 'dup' (already awaiting
        release — do NOT re-route), or 'full' (awaiting_rel overflow —
        reply reason 0x97 quota exceeded)."""
        if pid in self.awaiting_rel:
            return "dup"
        if len(self.awaiting_rel) >= self.max_awaiting_rel:
            return "full"
        self.awaiting_rel[pid] = time.time()
        return "ok"

    def pubrel_received(self, pid: int) -> bool:
        """Inbound PUBREL; caller replies PUBCOMP.  False if unknown
        (reply reason 0x92 packet-id-not-found)."""
        return self.awaiting_rel.pop(pid, None) is not None

    def pubrel_received_batch(self, pids: List[int]) -> List[bool]:
        """A run of inbound PUBRELs released in one call (the receiver
        side of a QoS2 publish burst); per-pid verdicts in order."""
        pop = self.awaiting_rel.pop
        out = [pop(pid, None) is not None for pid in pids]
        if self.metrics is not None and len(pids) > 1:
            self.metrics.inc("broker.qos2.batch")
        return out

    def expire_awaiting_rel(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        stale = [
            pid for pid, ts in self.awaiting_rel.items()
            if now - ts >= self.await_rel_timeout
        ]
        for pid in stale:
            del self.awaiting_rel[pid]
        return stale

    # ------------------------------------------------------------------
    # takeover / resume (emqx_cm protocol, SURVEY.md §3.2)
    # ------------------------------------------------------------------

    def pending_messages(self) -> List[Message]:
        """Undelivered state for migration (cross-node takeover): unacked
        inflight publishes first (insertion order — pid order breaks when
        the counter wraps), then the queued backlog."""
        out: List[Message] = []
        for _pid, _ts, (kind, val) in self.inflight.items():
            if kind == "publish" and val is not None:
                out.append(val)
        out.extend(self.mqueue.to_list())
        return out

    def pending_count(self) -> int:
        return len(self.mqueue) + len(self.inflight)

    def resume_publishes(self) -> List[Publish]:
        """On reconnect: re-send inflight (DUP) then drain the queue."""
        out: List[Publish] = []
        for pid, _, (kind, msg) in list(self.inflight.items()):
            if kind == "publish" and msg is not None:
                msg = msg.clone(dup=True)
                self.inflight.update(pid, (kind, msg))
                out.append(Publish(pid, msg))
        out.extend(self._dequeue())
        return out

    def info(self) -> Dict[str, Any]:
        return {
            "clientid": self.clientid,
            "clean_start": self.clean_start,
            "created_at": self.created_at,
            "subscriptions_cnt": len(self.subscriptions),
            "inflight_cnt": len(self.inflight),
            "mqueue_len": len(self.mqueue),
            "mqueue_dropped": self.mqueue.dropped,
            "awaiting_rel_cnt": len(self.awaiting_rel),
        }
