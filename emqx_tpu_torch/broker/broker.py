"""The pubsub core: subscribe/unsubscribe/publish/dispatch.

The port's own copy of the reference's ``emqx_tpu/broker/broker.py``,
single-node: the subscriber table, the route table updates on the first
and last subscriber of a filter, shared groups delegated to
:class:`SharedSub`, and the publish pipeline (``'message.publish'`` hook
fold → route match → per-subscriber QoS cap → session delivery →
``message.delivered`` / ``message.dropped`` hooks, MQTT5 No-Local).

Publish consumes the device match through ``device_match`` (the match
service's ``hint_routes``): a fresh micro-batched device answer replaces
the host trie walk, and an absent or stale one falls back to
``router.match_routes``, so correctness never depends on the device.

The batched fanout (``broker/fanout.py``) publishes through the seams
the reference gives it: :meth:`Broker.publish_folded` and the batched
shared dispatch :meth:`Broker._dispatch_shared_batch`.  The node and its
channels read ``usernames`` (kept by the channel on CONNECT),
``enhanced_auth`` (no provider is registered: the port has no auth
backends) and ``admission`` (always None: the admission plane is not
ported); :meth:`attach_hists` wires the per-message publish path's
stage histograms, and :meth:`deliver_direct` is the retainer's replay.
The reference's cluster forwarding seams (``on_forward``,
``on_forward_shared``, ``dispatch_remote``) are not part of this copy;
sessions are not shard-owned, so there is no ``Session.mutex`` and
delivery calls ``Session.deliver`` directly.
"""

from __future__ import annotations

import logging
import time
from dataclasses import replace
from typing import Any, Dict, List, Optional, Tuple

from .. import topic as T
from .hooks import Hooks
from .message import Message
from .router import Router
from .session import Publish, Session, SubOpts
from .shared_sub import SharedSub

log = logging.getLogger(__name__)

__all__ = ["Broker", "DeliverResult"]


class DeliverResult:
    """Per-publish outcome: connection-layer sendouts + accounting."""

    __slots__ = ("publishes", "dropped", "matched", "no_subscribers")

    def __init__(self) -> None:
        self.publishes: Dict[str, List[Publish]] = {}  # clientid -> sends
        self.dropped: List[Tuple[str, Message]] = []   # (clientid, msg)
        self.matched: int = 0
        self.no_subscribers: bool = False


class Broker:
    def __init__(
        self,
        node: str = "local",
        hooks: Optional[Hooks] = None,
        shared_strategy: str = "random",
        session_defaults: Optional[dict] = None,
    ) -> None:
        self.node = node
        self.hooks = hooks if hooks is not None else Hooks()
        self.router = Router()
        self.shared = SharedSub(shared_strategy)
        self.sessions: Dict[str, Session] = {}
        # MQTT 5 enhanced auth providers: method name -> provider
        self.enhanced_auth: Dict[str, Any] = {}
        # filter -> {clientid -> SubOpts}; non-shared local subscribers
        self.subscribers: Dict[str, Dict[str, SubOpts]] = {}
        self.session_defaults = session_defaults or {}
        # clientid -> username, maintained by the channel on CONNECT
        self.usernames: Dict[str, Optional[str]] = {}
        # the serving layer sets on_deliver to push straight to
        # connections; otherwise deliveries accumulate in outbox
        self.on_deliver = None  # Optional[Callable[[str, List[Publish]], None]]
        self.outbox: Dict[str, List[Publish]] = {}
        # device match seam: set to the match service's hint_routes —
        # returns the routes of a topic when a provably fresh device
        # answer exists, None otherwise (the host trie then serves)
        self.device_match = None       # (topic) -> Optional[List[Route]]
        # the batched publish->deliver pipeline (broker/fanout.py), set by
        # whoever runs one; a channel offers publishes there and falls
        # back to publish() when it refuses
        self.fanout = None             # Optional[FanoutPipeline]
        # the admission plane's seam, read by the channel and the
        # transport; the port has no admission plane, so it stays None
        self.admission = None
        # counter table; broker-internal drop accounting (outbox
        # overflow) and delivery counts land here when present
        self.metrics = None
        # stage histograms of the per-message publish path (None: the
        # recording sites cost one attribute test), set by attach_hists
        self.hists = None
        self._h_deliver = None
        self._h_flush = None
        self._h_e2e = None
        self._outbox_warned: set = set()  # clients already logged for drops

    # ------------------------------------------------------------------
    # session lifecycle
    # ------------------------------------------------------------------

    def open_session(
        self, clientid: str, clean_start: bool = True, **kw
    ) -> Tuple[Session, bool]:
        """Returns (session, session_present)."""
        old = self.sessions.get(clientid)
        if old is not None and not clean_start:
            # a resuming client renegotiates flow-control/expiry knobs
            if "max_inflight" in kw:
                old.inflight.max_size = kw["max_inflight"]
            if "expiry_interval" in kw:
                old.expiry_interval = kw["expiry_interval"]
            old.connected = True
            self.hooks.run("session.resumed", (clientid,))
            return old, True
        if old is not None:
            self._drop_session_state(old)
            self.hooks.run("session.discarded", (clientid,))
        opts = {**self.session_defaults, **kw}
        sess = Session(clientid, clean_start=clean_start, **opts)
        sess.metrics = self.metrics
        self.sessions[clientid] = sess
        self.hooks.run("session.created", (clientid,))
        return sess, False

    def close_session(self, clientid: str, discard: bool = False) -> None:
        sess = self.sessions.get(clientid)
        if sess is None:
            return
        if discard or sess.clean_start:
            self._drop_session_state(sess)
            del self.sessions[clientid]
            self.usernames.pop(clientid, None)
            self.outbox.pop(clientid, None)
            self._outbox_warned.discard(clientid)
            self.hooks.run("session.terminated", (clientid,))
        else:
            sess.connected = False  # deliveries queue until resume

    def _drop_session_state(self, sess: Session) -> None:
        for flt in list(sess.subscriptions):
            self._do_unsubscribe(sess.clientid, flt, sess.subscriptions[flt])

    # ------------------------------------------------------------------
    # subscribe / unsubscribe
    # ------------------------------------------------------------------

    def subscribe(self, clientid: str, raw_filter: str,
                  opts: SubOpts = SubOpts()) -> bool:
        T.validate(raw_filter, "filter")
        sess = self.sessions.get(clientid)
        if sess is None:
            raise KeyError(f"no session for {clientid!r}")
        share = T.parse_share(raw_filter)
        if share is not None:
            group, flt = share
            opts = replace(opts, share=group)
        else:
            group, flt = None, raw_filter
        is_new = sess.subscribe(raw_filter, opts)
        if group is not None:
            self.shared.subscribe(group, flt, clientid, self.node)
            self.router.add_route(flt, (group, self.node))
        else:
            subs = self.subscribers.setdefault(flt, {})
            first = not subs
            subs[clientid] = opts
            if first:
                self.router.add_route(flt, self.node)
        self.hooks.run("session.subscribed",
                       (clientid, raw_filter, opts, is_new))
        return True

    def unsubscribe(self, clientid: str, raw_filter: str) -> bool:
        sess = self.sessions.get(clientid)
        if sess is None:
            return False
        opts = sess.subscriptions.get(raw_filter)
        if opts is None:
            return False
        sess.unsubscribe(raw_filter)
        self._do_unsubscribe(clientid, raw_filter, opts)
        self.hooks.run("session.unsubscribed", (clientid, raw_filter))
        return True

    def _do_unsubscribe(self, clientid: str, raw_filter: str,
                        opts: SubOpts) -> None:
        share = T.parse_share(raw_filter)
        if share is not None:
            group, flt = share
            self.shared.unsubscribe(group, flt, clientid, self.node)
            if not self.shared.members(group, flt):
                self.router.delete_route(flt, (group, self.node))
        else:
            flt = raw_filter
            subs = self.subscribers.get(flt)
            if subs and clientid in subs:
                del subs[clientid]
                if not subs:
                    del self.subscribers[flt]
                    self.router.delete_route(flt, self.node)

    # ------------------------------------------------------------------
    # publish / dispatch (the hot path)
    # ------------------------------------------------------------------

    def publish(self, msg: Message) -> DeliverResult:
        T.validate(msg.topic, "name")
        res = DeliverResult()
        msg = self.hooks.run_fold("message.publish", (), msg)
        if msg is None or msg.headers.get("allow_publish") is False:
            res.no_subscribers = True
            return res
        return self._publish_folded(msg, res)

    def publish_folded(self, msg: Message) -> DeliverResult:
        """Dispatch a message whose ``'message.publish'`` fold already ran
        (the fanout pipeline's fallback after its stage 1): running the
        fold again would fire its side effects twice."""
        return self._publish_folded(msg, DeliverResult())

    def attach_hists(self, hists) -> None:
        """Wire the per-message publish path's span recording sites."""
        self.hists = hists
        self._h_deliver = hists.hist("obs.stage.deliver")
        self._h_flush = hists.hist("obs.stage.flush")
        self._h_e2e = hists.hist("obs.e2e.publish_deliver")

    def _publish_folded(self, msg: Message,
                        res: DeliverResult) -> DeliverResult:
        # a fresh micro-batched device answer replaces the per-publish
        # host trie walk; stale or absent hints fall back
        t0 = time.perf_counter_ns() if self._h_deliver is not None else 0
        routes = None
        if self.device_match is not None:
            routes = self.device_match(msg.topic)
        if routes is None:
            routes = self.router.match_routes(msg.topic)
        if not routes:
            res.no_subscribers = True
            self.hooks.run("message.dropped", (msg, "no_subscribers"))
            return res
        seen_shared: set = set()
        for flt, dest in routes:
            if isinstance(dest, tuple):  # (group, node) shared route
                group, _node = dest
                if (group, flt) in seen_shared:
                    continue
                seen_shared.add((group, flt))
                self._dispatch_shared(group, flt, msg, res)
            elif dest == self.node:
                self._dispatch(flt, msg, res)
        # the fan-out shared one QoS0 Publish, cached on the message
        # (Session.deliver); dropped now, it leaves no Message <-> Publish
        # cycle, so both die by refcount instead of by the collector
        msg.__dict__.pop("_pub0", None)
        # push the fan-out to the connection layer (or the outbox when no
        # serving layer is attached — unit tests read res.publishes)
        t1 = time.perf_counter_ns() if self._h_deliver is not None else 0
        for clientid, pubs in res.publishes.items():
            self.emit(clientid, pubs)
        if self._h_deliver is not None:
            # match and deliver as one deliver span, the emit fan-out as
            # flush, and the publish -> deliver sample when anything was
            # delivered: the histograms the batched drain also writes
            t2 = time.perf_counter_ns()
            self._h_deliver.record(t1 - t0)
            self._h_flush.record(t2 - t1)
            if res.matched and self._h_e2e is not None:
                self._h_e2e.record_s(time.time() - msg.timestamp)
        return res

    def _dispatch(self, flt: str, msg: Message, res: DeliverResult) -> None:
        subs = self.subscribers.get(flt)
        if not subs:
            return
        for clientid, opts in subs.items():
            if opts.nl and msg.sender == clientid:
                continue  # MQTT5 No-Local
            self._deliver_to(clientid, opts, msg, res)

    def _shared_try_deliver(
        self, group: str, flt: str, msg: Message, res: DeliverResult
    ):
        """The per-member acceptance probe of single-message and batched
        $share dispatch (the ack-aware redispatch calls it until a member
        accepts)."""
        def try_deliver(member: Tuple[str, str]) -> bool:
            clientid, node = member
            if node != self.node:
                return False
            sess = self.sessions.get(clientid)
            if sess is None:
                return False
            opts = self._shared_opts(sess, group, flt)
            if opts is None:
                return False
            return self._deliver_to(clientid, opts, msg, res)

        return try_deliver

    @staticmethod
    def _shared_opts(sess: Session, group: str,
                     flt: str) -> Optional[SubOpts]:
        # $queue/... sessions store the raw legacy key, not $share form
        opts = sess.subscriptions.get(T.make_share(group, flt))
        if opts is None and group == T.QUEUE_PREFIX:
            opts = sess.subscriptions.get(f"{T.QUEUE_PREFIX}/{flt}")
        return opts

    def _dispatch_shared(
        self, group: str, flt: str, msg: Message, res: DeliverResult
    ) -> None:
        member = self.shared.dispatch_with_ack(
            group, flt, msg.topic,
            self._shared_try_deliver(group, flt, msg, res),
            msg.sender, self.node)
        if member is None:
            self.hooks.run("message.dropped", (msg, "shared_no_available"))

    def _dispatch_shared_batch(
        self, group: str, flt: str, msgs: List[Message], res: DeliverResult
    ) -> None:
        """Batched $share dispatch (the fanout pipeline): one
        ``pick_batch`` assigns a member to each message, advancing the
        round-robin, sticky and hash state exactly as per-message picks
        would; then the messages picked onto one member are delivered
        through one ``Session.deliver``.  A member that cannot take its
        messages (gone, unsubscribed, or its queue refused them) sends
        those messages, and only those, through the per-message ack-aware
        redispatch.  The reference's branch for remote members of the
        group (``on_forward_shared``) waits for the cluster layer."""
        picks = self.shared.pick_batch(
            group, flt, [(m.topic, m.sender) for m in msgs], self.node)
        by_member: Dict[Tuple[str, str], List[Message]] = {}
        hooks = self.hooks
        for m, member in zip(msgs, picks):
            if member is None:
                hooks.run("message.dropped", (m, "shared_no_available"))
                continue
            bucket = by_member.get(member)
            if bucket is None:
                bucket = by_member[member] = []
            bucket.append(m)
        for member, mlist in by_member.items():
            clientid, node = member
            sess = self.sessions.get(clientid) if node == self.node else None
            opts = (self._shared_opts(sess, group, flt)
                    if sess is not None else None)
            if opts is None:
                # the picked member cannot take them: redispatch each
                # message without it
                for m in mlist:
                    self._redispatch_shared(group, flt, m, res, member)
                continue
            effs = [self._effective(m, opts) for m in mlist]
            sends, dropped = sess.deliver(effs)
            if sends:
                res.matched += len(sends)
                if self.metrics is not None:
                    self.metrics.inc("messages.delivered", len(sends))
                res.publishes.setdefault(clientid, []).extend(sends)
                if hooks.has("message.delivered"):
                    for p in sends:
                        hooks.run("message.delivered", (clientid, p.msg))
            if not dropped:
                continue
            dropped_ids = set()
            for d in dropped:
                dropped_ids.add(d.id)
                res.dropped.append((clientid, d))
                hooks.run("message.dropped", (d, "queue_full"))
            # a message of this batch that was dropped (refused by the
            # queue, or evicted by a later one of the same batch) was
            # never sent: it goes to another member; victims of earlier
            # batches count as drops, as on the per-message path
            for m, eff in zip(mlist, effs):
                if eff.id in dropped_ids:
                    self._redispatch_shared(group, flt, m, res, member)

    def _redispatch_shared(
        self,
        group: str,
        flt: str,
        msg: Message,
        res: DeliverResult,
        nacked: Tuple[str, str],
    ) -> None:
        """Ack-aware redispatch of one message after ``nacked`` refused
        it (the batched path's twin of ``dispatch_with_ack``'s retry)."""
        member = self.shared.dispatch_with_ack(
            group, flt, msg.topic,
            self._shared_try_deliver(group, flt, msg, res),
            msg.sender, self.node, exclude=(nacked,))
        if member is None:
            self.hooks.run("message.dropped", (msg, "shared_no_available"))

    @staticmethod
    def _effective(msg: Message, opts: SubOpts) -> Message:
        """The per-subscription view of a routed message: QoS capped at
        the granted QoS, Retain-As-Published, Subscription-Identifier.
        Returns ``msg`` itself when no transform applies, so a fan-out
        shares one Message (and its payload) across subscribers."""
        eff = msg.with_qos(min(msg.qos, opts.qos))
        if not opts.rap:
            # Retain-As-Published off → clear retain flag on forward
            eff = eff.clone(retain=False) if eff.retain else eff
        if opts.subid is not None:
            # MQTT5 §3.3.4: echo the Subscription-Identifier with deliveries
            eff = eff.clone(
                properties={**eff.properties,
                            "Subscription-Identifier": opts.subid})
        return eff

    def _deliver_to(
        self, clientid: str, opts: SubOpts, msg: Message, res: DeliverResult
    ) -> bool:
        """Returns True iff *this* message was accepted (sent or queued) —
        a queue eviction of an older message is not a nack."""
        sess = self.sessions.get(clientid)
        if sess is None:
            return False
        # the common case needs no per-subscription view (_effective
        # would return msg itself): skip the call
        if opts.qos >= msg.qos and (opts.rap or not msg.retain) \
                and opts.subid is None:
            eff = msg
        else:
            eff = self._effective(msg, opts)
        sends, dropped = sess.deliver([eff])
        if sends:
            res.matched += 1
            res.publishes.setdefault(clientid, []).extend(sends)
            if self.metrics is not None:
                self.metrics.inc("messages.delivered")
            self.hooks.run("message.delivered", (clientid, eff))
        if not dropped:
            return True
        for d in dropped:
            res.dropped.append((clientid, d))
            self.hooks.run("message.dropped", (d, "queue_full"))
        return all(d.id != eff.id for d in dropped)

    # ------------------------------------------------------------------
    # out-of-band delivery (retained replay)
    # ------------------------------------------------------------------

    def deliver_direct(self, clientid: str, opts: SubOpts,
                       msgs: List[Message]) -> None:
        """Deliver ``msgs`` to one session outside a publish fan-out and
        emit the resulting sends to the connection layer."""
        sess = self.sessions.get(clientid)
        if sess is None:
            return
        effs = [m.with_qos(min(m.qos, opts.qos)) for m in msgs]
        sends, dropped = sess.deliver(effs)
        for d in dropped:
            self.hooks.run("message.dropped", (d, "queue_full"))
        if sends:
            if self.metrics is not None:
                self.metrics.inc("messages.delivered", len(sends))
            for pub in sends:   # only actually-sent messages, not queued
                self.hooks.run("message.delivered", (clientid, pub.msg))
            self.emit(clientid, sends)

    # ------------------------------------------------------------------
    # delivery to the connection layer
    # ------------------------------------------------------------------

    OUTBOX_MAX = 1000  # per client; oldest dropped beyond this

    def emit(self, clientid: str, pubs: List[Publish]) -> None:
        if self.on_deliver is not None:
            self.on_deliver(clientid, pubs)
        else:
            self.outbox_put(clientid, pubs)

    def outbox_put(self, clientid: str, pubs: List[Publish]) -> None:
        """Capped outbox append — the fallback path for deliveries with
        no live connection.  Overflow evicts oldest-first, counted in
        ``broker.outbox.dropped`` and logged once per client."""
        box = self.outbox.setdefault(clientid, [])
        box.extend(pubs)
        over = len(box) - self.OUTBOX_MAX
        if over > 0:
            del box[:over]
            if self.metrics is not None:
                self.metrics.inc("broker.outbox.dropped", over)
            if clientid not in self._outbox_warned:
                self._outbox_warned.add(clientid)
                log.warning(
                    "outbox overflow for %r: dropped %d oldest "
                    "(cap %d; further drops counted in "
                    "broker.outbox.dropped, logged once per client)",
                    clientid, over, self.OUTBOX_MAX,
                )

    def take_outbox(self, clientid: str) -> List[Publish]:
        return self.outbox.pop(clientid, [])

    # ------------------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        return {
            "sessions.count": len(self.sessions),
            "subscriptions.count": sum(
                len(s.subscriptions) for s in self.sessions.values()
            ),
            "subscribers.count": sum(len(v)
                                     for v in self.subscribers.values()),
            "routes.count": self.router.route_count(),
            "shared_groups.count": len(self.shared.groups()),
        }
