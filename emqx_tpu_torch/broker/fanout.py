"""Batched publish→deliver fanout pipeline: the broker-side twin of the
match plane's micro-batching.

The port's own copy of the reference's ``emqx_tpu/broker/fanout.py``.
The per-message publish path (``Broker.publish`` → ``_dispatch`` →
``_deliver_to`` → ``Session.deliver`` → ``emit``) walks several Python
frames per subscriber per message, and with the device match each
publish also awaits its own ``prefetch``.  This pipeline amortizes that
walk over micro-batches:

* the channel **offers** a publish here and falls back to the
  per-message ``Broker.publish`` whenever the pipeline refuses (not
  running, low-rate bypass, overload, shape gate);
* a drain loop collects up to the batch bound of messages per window
  and resolves the routes of every distinct topic of the batch with one
  :meth:`MatchService.prefetch_many` call (one walk dispatch for the
  batch), then once per distinct topic (device hint, else the host
  trie);
* deliveries are grouped ``session → [messages]``, so
  ``Session.deliver`` runs once per session per batch, and subscribers
  with equal ``SubOpts`` share one effective :class:`Message`;
* one ``emit`` per client per batch;
* shared-subscription routes batch per ``(group, filter)`` slice through
  :meth:`SharedSub.pick_batch` and ``Broker._dispatch_shared_batch``,
  which pick the members the per-message path would, in the same order.

**Shape gate** (``shape_routes``): an EWMA of the fan-out legs per
message; while it is at most ``shape_routes`` (about one subscriber a
message, nothing to amortize) a sender with nothing in the pipeline's
custody takes the per-message path, and a probe is admitted every
``shape_probe_s`` so that the estimate follows the workload.

**Adaptive batch bound**: one batch covers at most ``adapt_window_s`` of
the observed arrival rate, between ``min_batch`` and ``max_batch``.
Below ``bypass_rate`` messages/s an idle pipeline refuses (the window
would cost more latency than it saves).

Ordering per (client, topic) holds: the queue is FIFO, batches run in
order, grouping appends in message order, the bypass engages only while
nothing is queued or in flight, and the shape gate only for a sender
with nothing in the pipeline.  Queue overload (``queue_cap``) hands
messages to the per-message path ahead of the backlog (counted in
``broker.fanout.overflow``).

Fault containment: an accepted publish is never lost.  A raising publish
hook, a failed route plan or a failed delivery sends the messages
concerned down the per-message path (``Broker.publish_folded`` once the
``message.publish`` fold has run, so that its side effects do not fire
twice), and the drain loop lives on.  On :meth:`stop`, a batch cancelled
at an await point puts its unprocessed rest back at the queue's front,
and the queue is republished in order through ``Broker.publish``.  The
delivery-stage fallback is at-least-once: a leg delivered before the
error may be delivered again.

**Supervision and overload**, as the reference's: with a
``Supervisor`` the drain loop runs as a permanent child (a crash or an
injected kill restarts it, and a supervised shutdown republishes what
is still queued); with an ``Olp``, sustained overload sheds at
:meth:`offer`: QoS0 drops first (``broker.olp.shed_qos0``), retained and
``$delayed/`` publishes wait in a deferral queue of ``deferred_cap``
until the overload clears (``broker.olp.deferred``), and QoS1/2 ride
the inflight window's backpressure.  ``hists`` records the
``obs.stage.fanout_queue``, ``deliver`` and ``flush`` spans and the
``obs.e2e.publish_deliver`` sample (once per session per batch; every
``e2e_per_leg_sample``-th leg as well when it is set), ``flightrec``
the ``fanout`` ring.

The broker's admission shed is not ported (an ``admission`` set on the
broker raises NotImplementedError).  The port has no cluster, so the
reference's ``on_forward`` leg is absent, and no shard-owned sessions,
so ``Session.deliver`` is called directly (the reference takes
``sess.mutex`` where a session has one).
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from .. import faultinject as _fi
from .. import topic as T
from ..observe.flightrec import STAGES as _FR_STAGES
from .broker import DeliverResult
from .message import Message

log = logging.getLogger(__name__)

__all__ = ["FanoutPipeline"]

# packed flight-recorder stage ids (observe/flightrec.py STAGES)
_SID_QUEUE = _FR_STAGES.index("fanout_queue")
_SID_DELIVER = _FR_STAGES.index("deliver")
_SID_FLUSH = _FR_STAGES.index("flush")


class FanoutPipeline:
    """Defaults are the reference class's; the reference node's
    ``broker.fanout.*`` settings are ``max_batch`` 2048, ``min_batch``
    8, ``window`` 0.5 ms, ``adapt_window`` 50 ms, ``bypass_rate`` 0,
    ``queue_cap`` 65536, ``shape_routes`` 1.25, ``shape_probe`` 0.25 s."""

    def __init__(
        self,
        broker: Any,
        metrics: Any = None,
        match_service: Any = None,
        max_batch: int = 2048,
        min_batch: int = 8,
        window_s: float = 0.0005,
        adapt_window_s: float = 0.05,
        bypass_rate: float = 0.0,
        queue_cap: int = 65536,
        shape_routes: float = 0.0,
        shape_probe_s: float = 0.25,
        supervisor: Any = None,
        olp: Any = None,
        deferred_cap: int = 4096,
        hists: Any = None,
        e2e_per_leg_sample: int = 0,
        flightrec: Any = None,
    ) -> None:
        if getattr(broker, "admission", None) is not None:
            raise NotImplementedError(
                "the broker's admission shed is not ported")
        self.broker = broker
        self.metrics = metrics
        self.match_service = match_service
        self.max_batch = max_batch
        self.min_batch = min_batch
        self.window_s = window_s
        self.adapt_window_s = adapt_window_s
        self.bypass_rate = bypass_rate
        self.queue_cap = queue_cap
        self.shape_routes = shape_routes
        self.shape_probe_s = shape_probe_s
        self.supervisor = supervisor
        self.olp = olp
        self.deferred_cap = deferred_cap

        self._q: Deque[Message] = deque()
        # sender -> its messages in the pipeline's custody (queued or in
        # the batch in flight).  MQTT orders per publisher connection per
        # topic, so a sender with nothing in custody may take the
        # per-message path while other senders' messages are queued
        self._pending_senders: Dict[Any, int] = {}
        # retained and $delayed/ publishes deferred under overload; they
        # rejoin the queue when it clears
        self._deferred: Deque[Message] = deque()
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._child = None           # supervise.Child when supervised
        self._running = False
        self._busy = False  # a batch is in flight (its prefetch await)
        # arrival-rate window (as MatchService._note_arrival)
        self._win_start = time.monotonic()
        self._win_count = 0
        self._last_rate = 0.0
        # shape gate: EWMA of fan-out legs per message (None until the
        # first batch is measured), and when the next probe is due
        self._avg_routes: Optional[float] = None
        self._shape_probe_at = 0.0
        # lifetime accounting (also in metrics when attached)
        self.batches = 0
        self.msgs = 0
        # stage histograms (None: each recording site is one attribute
        # test); the drain loop is their one writer
        self.hists = hists
        self._h_queue = self._h_deliver = None
        self._h_flush = self._h_e2e = self._h_e2e_leg = None
        self.e2e_per_leg_sample = int(e2e_per_leg_sample)
        self._leg_ctr = 0
        if hists is not None:
            self._h_queue = hists.hist("obs.stage.fanout_queue")
            self._h_deliver = hists.hist("obs.stage.deliver")
            self._h_flush = hists.hist("obs.stage.flush")
            self._h_e2e = hists.hist("obs.e2e.publish_deliver")
            if self.e2e_per_leg_sample > 0:
                self._h_e2e_leg = hists.hist("obs.e2e.publish_deliver_leg")
        # when the queue's head message arrived (0: the queue is empty)
        self._q_head_ns = 0
        self.flightrec = flightrec
        self._ring = (flightrec.ring("fanout")
                      if flightrec is not None else None)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self) -> None:
        self._running = True
        if self.supervisor is not None:
            # a crashed or killed drain loop restarts; the drain callback
            # republishes the queue when the supervisor stops the child
            self._child = self.supervisor.start_child(
                "broker.fanout", self._run, restart="permanent",
                drain=self._drain_queue)
        else:
            self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        """Stop draining; messages still queued take the per-message
        path, so that a shutdown loses no accepted publish."""
        self._running = False
        if self._child is not None:
            await self._child.stop()   # runs _drain_queue after the task
            self._child = None
            return
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                log.debug("fanout drain task exit", exc_info=True)
            self._task = None
        self._drain_queue()

    def _drain_queue(self) -> None:
        """Republish everything still queued (and overload-deferred)
        through the per-message path.  Idempotent."""
        while self._deferred:
            self._q.append(self._deferred.popleft())
        while self._q:
            msg = self._q.popleft()
            self._untrack([msg])
            try:
                self.broker.publish(msg)
            except Exception:
                log.exception("fanout drain-on-stop publish failed")

    # ------------------------------------------------------------------
    # ingress
    # ------------------------------------------------------------------

    def _note_arrival(self) -> None:
        now = time.monotonic()
        dt = now - self._win_start
        if dt >= 0.05:
            self._last_rate = self._win_count / dt
            self._win_start = now
            self._win_count = 0
        self._win_count += 1

    def offer(self, msg: Message) -> bool:
        """Accept ``msg`` for batched fanout.  False: the caller must
        deliver it through the per-message path (``Broker.publish``)."""
        if not self._running:
            return False
        T.validate(msg.topic, "name")  # as Broker.publish
        self._note_arrival()
        olp = self.olp
        if olp is not None and olp.overloaded():
            # sustained overload: shed QoS0 first, defer retained and
            # delayed publishes, and let QoS1/2 ride the queue (their
            # backpressure is the inflight window, not queue growth)
            if msg.retain or msg.topic.startswith("$delayed/"):
                if len(self._deferred) < self.deferred_cap:
                    self._deferred.append(msg)
                    self._track(msg)
                    if self.metrics is not None:
                        self.metrics.inc("broker.olp.deferred")
                    return True
                return False  # the deferral is full: the sync path
            if msg.qos == 0:
                if self.metrics is not None:
                    self.metrics.inc("broker.olp.shed_qos0")
                self.broker.hooks.run("message.dropped", (msg, "olp_shed"))
                return True   # consumed: dropped by policy, not queued
        if len(self._q) >= self.queue_cap:
            # overload: shed to the per-message path, not an unbounded
            # queue
            if self.metrics is not None:
                self.metrics.inc("broker.fanout.overflow")
            return False
        if (
            self.bypass_rate > 0
            and not self._q
            and not self._busy
            and self._last_rate < self.bypass_rate
        ):
            # a low-rate publisher: the batching window would cost more
            # latency than it saves.  Nothing is queued or in flight that
            # this message could overtake
            if self.metrics is not None:
                self.metrics.inc("broker.fanout.bypass")
            return False
        if (
            self.shape_routes > 0
            and self._avg_routes is not None
            and self._avg_routes <= self.shape_routes
            and msg.sender not in self._pending_senders
        ):
            # shape gate: about one leg a message leaves nothing to
            # amortize, and the per-message path delivers at once.  This
            # sender has nothing in custody, so nothing of its own can be
            # overtaken; a probe every shape_probe_s re-measures the shape
            now2 = time.monotonic()
            if now2 >= self._shape_probe_at:
                self._shape_probe_at = now2 + self.shape_probe_s
            else:
                if self.metrics is not None:
                    self.metrics.inc("broker.fanout.shape_bypass")
                return False
        if self._h_queue is not None and not self._q:
            self._q_head_ns = time.perf_counter_ns()
        self._q.append(msg)
        self._track(msg)
        self._wake.set()
        return True

    def _track(self, msg: Message) -> None:
        d = self._pending_senders
        s = msg.sender
        d[s] = d.get(s, 0) + 1

    def _untrack(self, msgs: List[Message]) -> None:
        d = self._pending_senders
        for m in msgs:
            s = m.sender
            v = d.get(s)
            if v is not None:
                if v <= 1:
                    del d[s]
                else:
                    d[s] = v - 1

    def will_accept(self, headroom: int = 1) -> bool:
        """Side-effect-free preflight of :meth:`offer`: True only when
        the next ``headroom`` offers are certain to be accepted (and none
        would consume gate state such as the shape probe).  Only valid
        on the pipeline's own loop with no await between the check and
        the offers."""
        if not self._running:
            return False
        if self.olp is not None and self.olp.overloaded():
            return False
        if len(self._q) + headroom > self.queue_cap:
            return False
        idle = not self._q and not self._busy
        if self.bypass_rate > 0 and idle \
                and self._last_rate < self.bypass_rate:
            return False
        if self.shape_routes > 0 \
                and self._avg_routes is not None \
                and self._avg_routes <= self.shape_routes:
            # the shape gate may bypass per sender at any queue depth
            return False
        return True

    def _batch_bound(self) -> int:
        """Arrival-rate-adaptive batch bound: one batch covers at most
        ``adapt_window_s`` of offered traffic, so that the flush time
        (and with it the delivery p99) follows the load."""
        by_rate = int(self._last_rate * self.adapt_window_s)
        return max(self.min_batch, min(self.max_batch, by_rate))

    # ------------------------------------------------------------------
    # drain loop
    # ------------------------------------------------------------------

    async def _run(self) -> None:
        if self._q or self._deferred:
            # a restart with a backlog: the previous run's wake may have
            # been consumed; never stall on a non-empty queue
            self._wake.set()
        while True:
            await self._wake.wait()
            self._wake.clear()
            if _fi._injector is not None:
                # chaos seam: before the batch pops, so that a raise kills
                # the drain task without stranding popped messages
                act = _fi._injector.act("fanout.drain")
                if act == "raise":
                    raise _fi.InjectedFault("fanout.drain")
                if act == "delay":
                    await _fi._injector.pause()
            if self.olp is not None:
                self.olp.report(queue_depth=len(self._q))
                if self._deferred and not self.olp.overloaded():
                    # the overload cleared: deferred publishes rejoin
                    while self._deferred and len(self._q) < self.queue_cap:
                        self._q.append(self._deferred.popleft())
            if not self._q:
                continue
            if self.window_s > 0:
                # the batching window: let concurrent publishes pile in
                await asyncio.sleep(self.window_s)
            bound = self._batch_bound()
            n = min(len(self._q), bound)
            popleft = self._q.popleft
            batch = [popleft() for _ in range(n)]
            if self._h_queue is not None:
                # fanout_queue span: the batch's oldest queue wait (head
                # stamp to pop), re-armed for the rest of the queue
                now_ns = time.perf_counter_ns()
                head = self._q_head_ns
                if head:
                    self._h_queue.record(now_ns - head)
                    if self._ring is not None:
                        self._ring.push(_SID_QUEUE, head, now_ns - head, n)
                self._q_head_ns = now_ns if self._q else 0
            if self._q:
                self._wake.set()
            self._busy = True
            t0 = time.perf_counter()
            try:
                await self._process(batch)
            except asyncio.CancelledError:
                raise
            except Exception:
                # _process guards each stage itself; a fault here must
                # still not kill the drain task, or offer() would keep
                # accepting publishes that nothing delivers
                log.exception("fanout batch processing failed")
                if self.metrics is not None:
                    self.metrics.inc("broker.fanout.errors")
            finally:
                self._busy = False
            if self.metrics is not None:
                m = self.metrics
                m.inc("broker.fanout.batches")
                m.inc("broker.fanout.msgs", n)
                m.set("broker.fanout.batch_size", n)
                m.set("broker.fanout.depth", len(self._q))
                m.inc("broker.fanout.flush_us",
                      int((time.perf_counter() - t0) * 1e6))
            self.batches += 1
            self.msgs += n
            if self._deferred and (
                    self.olp is None or not self.olp.overloaded()):
                self._wake.set()   # re-queue the deferred next round

    # loop fairness: at most this many messages fan out per synchronous
    # stretch; between chunks the drain loop yields, so that connection
    # I/O keeps flowing under large batches
    CHUNK = 256

    async def _process(self, batch: List[Message]) -> None:
        done = 0
        try:
            # one prefetch_many resolves device hints for every distinct
            # topic of the batch, so that stage 2's device_match serves
            # from fresh hints (bounded by the service's
            # prefetch_timeout_s; on failure the host trie serves)
            if self.match_service is not None:
                try:
                    # {topic: max qos}: iterates as the topic set and
                    # carries the QoS that the reference's deadline serve
                    # plane sheds on
                    topic_qos: Dict[str, int] = {}
                    for m in batch:
                        q = topic_qos.get(m.topic)
                        if q is None or m.qos > q:
                            topic_qos[m.topic] = m.qos
                    await self.match_service.prefetch_many(topic_qos)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    log.exception(
                        "fanout prefetch_many failed (host trie serves)")
            for i in range(0, len(batch), self.CHUNK):
                self._process_chunk(batch[i:i + self.CHUNK])
                done = i + self.CHUNK
                if done < len(batch):
                    await asyncio.sleep(0)
        except asyncio.CancelledError:
            # stop() cancelled us at an await point.  Chunks run without
            # an await, so everything from `done` on is untouched: back
            # to the queue's front, in order, for stop()'s drain
            self._q.extendleft(reversed(batch[done:]))
            raise

    def _plan_routes(self, topics) -> Dict[str, list]:
        broker = self.broker
        routes_of: Dict[str, list] = {}
        device_match = broker.device_match
        match_routes = broker.router.match_routes
        for t in topics:
            routes = device_match(t) if device_match is not None else None
            routes_of[t] = routes if routes is not None else match_routes(t)
        return routes_of

    def _fallback(self, msgs: List[Message], folded: bool) -> None:
        """The per-message path for the messages of a failed stage;
        ``folded`` takes ``publish_folded`` for messages whose
        ``message.publish`` fold already ran."""
        broker = self.broker
        if self.metrics is not None:
            self.metrics.inc("broker.fanout.fallback", len(msgs))
        publish = broker.publish_folded if folded else broker.publish
        for m in msgs:
            try:
                publish(m)
            except Exception:
                log.exception("fanout fallback publish failed")

    def _process_chunk(self, batch: List[Message]) -> None:
        try:
            self._process_chunk_inner(batch)
        finally:
            # the chunk left the pipeline's custody (delivered, dropped
            # or fallen back): its senders may shape-bypass again
            self._untrack(batch)

    def _process_chunk_inner(self, batch: List[Message]) -> None:
        broker = self.broker
        hooks = broker.hooks
        # -- stage 1: the publish hooks, per message as Broker.publish
        # runs them.  A raising hook sends that message down the
        # per-message path; the rest stay batched
        msgs: List[Message] = []
        for msg in batch:
            try:
                m = hooks.run_fold("message.publish", (), msg)
            except Exception:
                log.exception("publish fold failed; message falls back "
                              "to the per-message path")
                self._fallback([msg], folded=False)
                continue
            if m is None or m.headers.get("allow_publish") is False:
                continue
            msgs.append(m)
        if not msgs:
            return
        # -- stage 2: routes once per distinct topic (device hints that
        # prefetch_many parked, else the host trie).  Nothing is
        # delivered yet and every fold ran: a failure falls back
        # fold-skipping, with no duplicate
        try:
            routes_of = self._plan_routes({m.topic for m in msgs})
        except Exception:
            log.exception("fanout planning failed; chunk falls back to "
                          "the per-message path")
            self._fallback(msgs, folded=True)
            return
        try:
            self._deliver_chunk(msgs, routes_of)
        except Exception:
            # stages 3-5 call back into sessions, shared picks, hooks and
            # emit.  Some legs may be delivered already, so the
            # fold-skipping fallback may deliver one twice (at least
            # once on this path); nothing is lost and the loop lives on
            log.exception("fanout delivery failed; chunk falls back to "
                          "the per-message path")
            self._fallback(msgs, folded=True)

    def _deliver_chunk(self, msgs: List[Message],
                       routes_of: Dict[str, list]) -> None:
        broker = self.broker
        hooks = broker.hooks
        # -- stage 3: group session -> [messages] and ($share group,
        # filter) -> [messages]
        plan: Dict[str, List[Message]] = {}
        shared_slices: Dict[Any, List[Message]] = {}
        res = DeliverResult()  # the shared path's sends and accounting
        effective = broker._effective
        subscribers = broker.subscribers
        node = broker.node
        views: List[Message] = []   # per-subscription copies made here
        for m in msgs:
            routes = routes_of[m.topic]
            if not routes:
                hooks.run("message.dropped", (m, "no_subscribers"))
                continue
            seen_shared = None
            for flt, dest in routes:
                if isinstance(dest, tuple):  # (group, node) shared route
                    group, _node = dest
                    if seen_shared is None:
                        seen_shared = set()
                    elif (group, flt) in seen_shared:
                        continue
                    seen_shared.add((group, flt))
                    bucket = shared_slices.get((group, flt))
                    if bucket is None:
                        bucket = shared_slices[(group, flt)] = []
                    bucket.append(m)
                elif dest == node:
                    sender, qos = m.sender, m.qos
                    plain = not m.retain
                    eff_cache: Dict[Any, Message] = {}
                    for clientid, opts in subscribers.get(flt, {}).items():
                        if opts.nl and sender == clientid:
                            continue  # MQTT5 No-Local
                        if opts.qos >= qos and (opts.rap or plain) \
                                and opts.subid is None:
                            # no per-subscription view applies: the leg
                            # shares the message itself (what _effective
                            # returns), without the call and the cache
                            eff = m
                        else:
                            # subscribers with equal SubOpts share one
                            # effective message: one copy per distinct
                            # transform, not per leg
                            eff = eff_cache.get(opts)
                            if eff is None:
                                eff = eff_cache[opts] = effective(m, opts)
                                if eff is not m:
                                    views.append(eff)
                        bucket = plan.get(clientid)
                        if bucket is None:
                            bucket = plan[clientid] = []
                        bucket.append(eff)
        # -- stage 3.5: one pick_batch per ($share group, filter) slice,
        # with per-message ack-aware redispatch only on a nack
        for (group, flt), ms in shared_slices.items():
            broker._dispatch_shared_batch(group, flt, ms, res)
        # the shape gate's signal: fan-out legs per message (EWMA)
        self._note_shape(
            len(msgs),
            sum(len(b) for b in plan.values())
            + sum(len(b) for b in shared_slices.values()))
        # -- stage 4: one Session.deliver per session per batch
        out = res.publishes
        sessions = broker.sessions
        delivered_taps = hooks.has("message.delivered")
        bmetrics = broker.metrics
        h_e2e = self._h_e2e
        h_leg = self._h_e2e_leg
        t4 = time.perf_counter_ns() if self._h_deliver is not None else 0
        now_wall = (time.time()
                    if h_e2e is not None or h_leg is not None else 0.0)
        for clientid, effs in plan.items():
            sess = sessions.get(clientid)
            if sess is None:
                continue
            sends, dropped = sess.deliver(effs)
            if sends:
                n_sends = len(sends)
                res.matched += n_sends
                if bmetrics is not None:
                    bmetrics.inc("messages.delivered", n_sends)
                bucket = out.get(clientid)
                if bucket is None:
                    out[clientid] = sends
                else:
                    bucket.extend(sends)
                if delivered_taps:
                    for p in sends:
                        hooks.run("message.delivered", (clientid, p.msg))
                if h_e2e is not None:
                    # publish -> deliver, sampled once per session per
                    # batch (its first send)
                    h_e2e.record_s(now_wall - sends[0].msg.timestamp)
                if h_leg is not None:
                    step = self.e2e_per_leg_sample
                    for p in sends:
                        self._leg_ctr += 1
                        if self._leg_ctr >= step:
                            self._leg_ctr = 0
                            h_leg.record_s(now_wall - p.msg.timestamp)
            for d in dropped:
                hooks.run("message.dropped", (d, "queue_full"))
        # the legs shared one QoS0 Publish per message, cached on it
        # (Session.deliver); dropped now, it leaves no Message <->
        # Publish cycle for the collector (as Broker.publish does)
        for m in msgs:
            m.__dict__.pop("_pub0", None)
        for m in views:
            m.__dict__.pop("_pub0", None)
        # -- stage 5: one emit per client per batch
        t5 = time.perf_counter_ns() if self._h_deliver is not None else 0
        emit = broker.emit
        for clientid, pubs in out.items():
            emit(clientid, pubs)
        if self._h_deliver is not None:
            t6 = time.perf_counter_ns()
            self._h_deliver.record(t5 - t4)
            self._h_flush.record(t6 - t5)
            if self._ring is not None:
                self._ring.push(_SID_DELIVER, t4, t5 - t4, len(msgs))
                self._ring.push(_SID_FLUSH, t5, t6 - t5, len(out))

    # ------------------------------------------------------------------

    def _note_shape(self, n_msgs: int, n_legs: int) -> None:
        if n_msgs <= 0:
            return
        r = n_legs / n_msgs
        a = self._avg_routes
        self._avg_routes = r if a is None else a * 0.8 + r * 0.2

    def depth(self) -> int:
        return len(self._q)

    def info(self) -> Dict[str, Any]:
        return {
            "running": self._running,
            "depth": len(self._q),
            "deferred": len(self._deferred),
            "batches": self.batches,
            "msgs": self.msgs,
            "batch_bound": self._batch_bound(),
            "last_rate": round(self._last_rate, 1),
            "avg_routes": (round(self._avg_routes, 2)
                           if self._avg_routes is not None else None),
        }
