"""BrokerNode: the application assembly, from config to a running broker.

The port's own copy of the reference's ``emqx_tpu/node.py``, for the
node's default datapath: the broker and its connection manager, the
counters, stats and alarms, the supervision tree, overload protection
with its loop-lag probe, the retainer and the delayed publish, the stage
histograms and the flight recorder, the limiter, the TCP listener with
the protocol-mode fast path (and the stream path when ``fast_path`` is
off), the match service on the card with the publish prefetch, the
batched fanout with its timer wheel when ``broker.fanout.enable`` is set,
the rule engine (``rule_engine/``, attached to the started match service
so that rule selection rides the walk on the card) and access control
(``auth/``: the authn chain and the authz sources on the broker's
``client.authenticate`` / ``client.authorize`` hooks, when the caller
passes ``auth_chain`` or ``authz``, or on :meth:`ensure_access_control`)
and the exhook client (``exhook/manager.py``: the HookProvider servers
of ``exhook.servers``, the match sidecar among them, with their advisory
round trips as the last stage of ``_intercept``).  Boot order is the
reference's (core workers, then services, the match service, the fanout
and exhook, listeners last); stop order is the reverse.

``BrokerNode(config, auth_chain=None, authz=None, device=None)`` serves
its match service on the card unless ``device`` names another (``"cpu"``
runs the kernels' plain versions).  ``device`` may be a list of devices:
with ``match.multichip.enable`` the mesh the table shards over (a
device may repeat, so ``["cpu"] * 8`` is an eight-shard mesh on the
CPU); the single-device table takes the first.  Where the reference logs a match
service that cannot start and serves from the host trie,
:meth:`BrokerNode.start` raises.

The subsystems the port does not have yet (the network-backed auth
backends, bridges, cluster, management and dashboard, gateways,
QUIC, TLS and WebSocket listeners, connection shards, admission,
persistence, statsd and telemetry, slow_subs, topic metrics, ``$SYS``
publishing, banned and flapping, rewrite and auto-subscribe) are left
out.  At their defaults the reference's are inert for a client of this
node, apart from ``$SYS``; a config that sets one of their keys
(:data:`UNPORTED_KEYS`) away from its default makes the constructor
raise NotImplementedError.  With no bridges, a rule's
``"<type>:<name>"`` action fails (counted in ``actions.failed``), as on
a reference node with no such bridge.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from . import __version__
from .auth.access_control import attach_auth
from .auth.authn import AuthChain
from .auth.authz import Authz
from .broker.broker import Broker
from .broker.channel import Channel
from .broker.cm import ConnectionManager
from .broker.limiter import LimiterGroup
from .broker.olp import LoopLagProbe, Olp
from .config import SCHEMA, Config
from .mqtt import packet as P
from .observe.flightrec import FlightRecorder
from .observe.hist import HistSet
from .observe.wiring import observe
from .rule_engine.engine import RuleEngine
from .services.delayed import DelayedPublish
from .services.retainer import Retainer
from .supervise import Supervisor
from .transport.connection import ConnInfo, Connection
from .transport.listener import Listener, Listeners

log = logging.getLogger(__name__)

__all__ = ["BrokerNode", "UNPORTED_KEYS"]

#: config key prefixes of the subsystems the port's node leaves out: a
#: key under one of them set away from its default raises at construction
UNPORTED_KEYS = {
    "admission.": "the admission plane",
    "api_key.": "the management API",
    "broker.conn.shards": "connection shards",
    "broker.sys_msg_interval": "$SYS publishing",
    "cluster.": "the cluster",
    "dashboard.": "the management API and dashboard",
    "durable_storage.": "persistence",
    "flapping_detect.": "flapping detection",
    "gateway.": "the gateways",
    "listeners.quic.": "the QUIC listener",
    "listeners.ssl.": "the TLS listener",
    "listeners.ws.": "the WebSocket listener",
    "node.data_dir": "persistence",
    "psk.": "TLS-PSK",
    "slow_subs.": "slow_subs",
    "statsd.": "statsd",
    "telemetry.": "telemetry",
    "topic_metrics.": "topic metrics",
}


def _check_ported(cfg: Config) -> None:
    for key, field in SCHEMA.items():
        for prefix, what in UNPORTED_KEYS.items():
            if key.startswith(prefix) and cfg.get(key) != field.default:
                raise NotImplementedError(
                    f"{key} = {cfg.get(key)!r}: {what} is not ported; the "
                    f"port's node needs its default {field.default!r}")


class BrokerNode:
    """One broker node: all ported subsystems wired, listeners optional.

    Synchronous parts (broker, session, services) work right after
    construction; ``await start()`` brings up the match service, the
    fanout, the listeners and the periodic jobs.
    """

    def __init__(self, config: Optional[Config] = None,
                 auth_chain: Optional[AuthChain] = None,
                 authz: Optional[Authz] = None, *,
                 device: Union[None, str, torch.device,
                               Sequence[Union[str, torch.device]]] = None
                 ) -> None:
        self.config = config if config is not None else Config()
        cfg = self.config
        _check_ported(cfg)
        self.device = device
        self.node_name = cfg.get("node.name")
        self.broker = Broker(
            node=self.node_name,
            shared_strategy=cfg.get("broker.shared_subscription_strategy"),
            session_defaults={
                "max_inflight": cfg.get("mqtt.max_inflight"),
                "max_mqueue_len": cfg.get("mqtt.max_mqueue_len"),
                "expiry_interval": cfg.get("mqtt.session_expiry_interval"),
                "max_awaiting_rel": cfg.get("mqtt.max_awaiting_rel"),
            },
        )
        self.cm = ConnectionManager(self.broker)
        self.observed = observe(self.broker)
        # supervision tree: every long-lived background task (fanout
        # drain, match loops, housekeeping, the lag probe) registers here;
        # restart intensity escalates to an alarm and degraded mode
        self.supervisor = Supervisor(
            metrics=self.observed.metrics,
            alarms=self.observed.alarms,
            max_restarts=cfg.get("supervisor.max_restarts"),
            window_s=cfg.get("supervisor.window"),
            backoff_base=cfg.get("supervisor.backoff_base"),
            backoff_max=cfg.get("supervisor.backoff_max"),
        )
        self.olp = Olp(
            alarms=self.observed.alarms,
            max_loop_lag=cfg.get("overload_protection.max_loop_lag"),
            max_queue_depth=cfg.get("overload_protection.max_queue_depth"),
            cooloff=cfg.get("overload_protection.cooloff"),
        )
        # sleep-drift sampler: CPU saturation trips overload protection
        # even when no queue grows (started as a supervised child)
        self.lag_probe = None
        probe_interval = cfg.get("overload_protection.lag_probe_interval")
        if probe_interval and probe_interval > 0:
            self.lag_probe = LoopLagProbe(
                self.olp, metrics=self.observed.metrics,
                interval=probe_interval,
            )
        # connection gauges come from the CM (a node-level table)
        self.observed.stats.provide(
            "connections.count", self.cm.total_connection_count)
        self.observed.stats.provide(
            "live_connections.count", self.cm.connection_count)
        self.retainer = (
            Retainer(
                msg_expiry_interval=cfg.get("retainer.msg_expiry_interval"),
                max_payload_size=cfg.get("retainer.max_payload_size"),
                max_retained_messages=cfg.get(
                    "retainer.max_retained_messages"),
            ).attach(self.broker)
            if cfg.get("retainer.enable")
            else None
        )
        self.delayed = (
            DelayedPublish(
                max_delayed_messages=cfg.get("delayed.max_delayed_messages")
            ).attach(self.broker)
            if cfg.get("delayed.enable")
            else None
        )
        # the rule engine taps message.publish and the lifecycle hooks
        # now; _start_match_service co-batches its FROM filters
        self.rule_engine = RuleEngine(self.broker)
        self.access_control = None
        if auth_chain is not None or authz is not None:
            self.ensure_access_control(auth_chain, authz)
        # stage-level latency observatory: the histogram set (None: every
        # recording site is one attribute test) and the always-on flight
        # recorder, dumping into ./trace (the reference's trace dir at
        # the default node.data_dir)
        self.hists = HistSet("main") if cfg.get("obs.hist.enable") \
            else None
        if self.hists is not None:
            # spans of the per-message publish path (fanout off, or the
            # traffic its shape gate lets by)
            self.broker.attach_hists(self.hists)
        self.flightrec = FlightRecorder(
            "trace",
            depth=cfg.get("obs.flightrec.depth"),
            metrics=self.observed.metrics,
        )
        self.supervisor.flightrec = self.flightrec
        self._attach_client_metrics()
        self._register_config_handlers()
        # session expiry: clientid -> disconnect time, swept by
        # housekeeping
        self._disconnected_at: Dict[str, float] = {}
        self.match_service = None    # the match service on the card
        self.exhook = None           # built in start() (needs a loop)
        self.fanout_pipeline = None  # the batched publish fanout
        self.limiter = LimiterGroup(
            max_conn_rate=cfg.get("limiter.max_conn_rate"),
            max_messages_rate=cfg.get("limiter.max_messages_rate"),
            max_bytes_rate=cfg.get("limiter.max_bytes_rate"),
        )
        # the hashed timer wheel, part of the one batched-stack opt-in:
        # keepalive and retry ticks ride coarse buckets, one scheduled
        # callback per tick whatever the connection count
        self.timer_wheel = None
        if cfg.get("broker.fanout.enable"):
            from .transport.timerwheel import TimerWheel

            self.timer_wheel = TimerWheel()
        self.listeners = Listeners()
        self.connections: Dict[str, Any] = {}  # clientid -> conn
        # every accepted connection, pre-CONNECT ones too: stop() must
        # close sockets that never completed a handshake
        self._all_conns: set = set()
        self.broker.on_deliver = self._on_deliver
        self._jobs: List[Any] = []  # supervised Child handles
        self.started_at = time.time()
        self._running = False
        self._configure_listeners()

    # ------------------------------------------------------------------

    def _attach_client_metrics(self) -> None:
        m = self.observed.metrics
        hooks = self.broker.hooks
        hooks.add("client.connect",
                  lambda cid, pkt: m.inc("client.connect"),
                  name="metrics.client.connect")
        hooks.add("client.connected",
                  lambda cid, info: (m.inc("client.connected"),
                                     self._disconnected_at.pop(cid, None))[0],
                  name="metrics.client.connected")
        hooks.add("client.disconnected",
                  lambda cid, reason: (m.inc("client.disconnected"),
                                       self._mark_disconnected(cid))[0],
                  name="metrics.client.disconnected")
        hooks.add("client.subscribe",
                  lambda cid, pkt: m.inc("client.subscribe"),
                  name="metrics.client.subscribe")
        hooks.add("client.unsubscribe",
                  lambda cid, pkt: m.inc("client.unsubscribe"),
                  name="metrics.client.unsubscribe")

    def _register_config_handlers(self) -> None:
        """Hot-update plumbing: push runtime config changes into the live
        components."""
        cfg = self.config
        cfg.on_update(
            "limiter.max_conn_rate",
            lambda p, o, n: self.limiter.reconfigure(max_conn_rate=n),
        )
        cfg.on_update(
            "limiter.max_messages_rate",
            lambda p, o, n: self.limiter.reconfigure(max_messages_rate=n),
        )
        cfg.on_update(
            "limiter.max_bytes_rate",
            lambda p, o, n: self.limiter.reconfigure(max_bytes_rate=n),
        )
        cfg.on_update(
            "mqtt.max_inflight",
            lambda p, o, n: self.broker.session_defaults.__setitem__(
                "max_inflight", n
            ),
        )
        cfg.on_update(
            "mqtt.max_mqueue_len",
            lambda p, o, n: self.broker.session_defaults.__setitem__(
                "max_mqueue_len", n
            ),
        )
        cfg.on_update(
            "broker.shared_subscription_strategy",
            lambda p, o, n: setattr(self.broker.shared, "strategy", n),
        )
        if self.retainer is not None:
            cfg.on_update(
                "retainer.msg_expiry_interval",
                lambda p, o, n: setattr(
                    self.retainer, "msg_expiry_interval", n
                ),
            )
        if self.delayed is not None:
            cfg.on_update(
                "delayed.max_delayed_messages",
                lambda p, o, n: setattr(
                    self.delayed, "max_delayed_messages", n
                ),
            )

    def _mark_disconnected(self, clientid: str) -> None:
        if self.broker.sessions.get(clientid) is not None:
            self._disconnected_at[clientid] = time.time()

    def _configure_listeners(self) -> None:
        cfg = self.config
        if cfg.get("listeners.tcp.default.enable"):
            self.listeners.add(
                Listener(
                    "default",
                    cfg.get("listeners.tcp.default.bind"),
                    self.handle_stream,
                    kind="tcp",
                    max_connections=cfg.get(
                        "listeners.tcp.default.max_connections"
                    ),
                    max_conn_rate=cfg.get("limiter.max_conn_rate"),
                    reuse_port=cfg.get("listeners.tcp.default.reuse_port"),
                    proto_factory=(
                        self.make_protocol
                        if cfg.get("listeners.tcp.default.fast_path")
                        else None
                    ),
                )
            )

    # ------------------------------------------------------------------
    # connection plumbing
    # ------------------------------------------------------------------

    def ensure_access_control(self, chain: Optional[AuthChain] = None,
                              authz: Optional[Authz] = None):
        """Attach access control on first use, with ``chain`` and
        ``authz`` or, for either not given, an empty one configured by
        ``authn.allow_anonymous`` / ``authz.no_match`` (a node that
        booted with no auth gets a live chain and pipeline); return it."""
        if self.access_control is None:
            cfg = self.config
            self.access_control = attach_auth(
                self.broker,
                chain if chain is not None else AuthChain(
                    allow_anonymous=cfg.get("authn.allow_anonymous")),
                authz if authz is not None else Authz(
                    no_match=cfg.get("authz.no_match")),
            )
        return self.access_control

    def make_channel(self, conninfo: Optional[dict] = None) -> Channel:
        cfg = self.config
        return Channel(
            self.broker,
            self.cm,
            conninfo=conninfo,
            max_topic_alias=cfg.get("mqtt.max_topic_alias"),
            max_inflight=cfg.get("mqtt.max_inflight"),
            server_keepalive=(cfg.get("mqtt.server_keepalive") or None),
        )

    def _wants_intercept(self) -> bool:
        return (
            self.exhook is not None
            or self.match_service is not None
            or (self.access_control is not None
                and self.access_control.needs_async())
        )

    def _register_on_connect(self, channel, conn) -> None:
        """Wrap handle_in so that the clientid -> connection registry
        fills the moment CONNECT lands (race-free on one loop)."""
        prev = channel.handle_in

        def handle_in_and_register(pkt):
            acts = prev(pkt)
            cid = channel.clientid
            if cid is not None and self.connections.get(cid) is not conn:
                if channel.state == "connected":
                    self.connections[cid] = conn
            return acts

        channel.handle_in = handle_in_and_register

    def make_protocol(self, info: ConnInfo):
        """Listener factory for the protocol-mode TCP datapath."""
        from .transport.proto_conn import MqttProtocol

        channel = self.make_channel(conninfo={"listener": info.listener})
        proto = MqttProtocol(
            channel,
            conninfo=info,
            max_packet_size=self.config.get("mqtt.max_packet_size"),
            limiter=self.limiter,
            on_closed=self._proto_closed,
            intercept=self._intercept if self._wants_intercept() else None,
            metrics=self.observed.metrics,
            # the batched-delivery stack is one opt-in: fanout, ack-burst
            # batching and write coalescing ride the same flag
            coalesce=bool(self.config.get("broker.fanout.enable")),
            wheel=self.timer_wheel,
        )
        if self.hists is not None:
            proto._h_parse = self.hists.hist("obs.stage.ingest_parse")
        channel.conn = proto
        self._register_on_connect(channel, proto)
        self._all_conns.add(proto)
        return proto

    def _proto_closed(self, proto) -> None:
        self._all_conns.discard(proto)
        self._conn_closed(proto)

    async def handle_stream(self, stream: Any, info: ConnInfo) -> None:
        """Listener entry of the stream path: run one client connection
        to completion."""
        channel = self.make_channel(
            conninfo={"peername": stream.peername(), "listener": info.listener}
        )
        conn = Connection(
            stream,
            channel,
            conninfo=info,
            max_packet_size=self.config.get("mqtt.max_packet_size"),
            limiter=self.limiter,
            on_closed=self._conn_closed,
            coalesce=bool(self.config.get("broker.fanout.enable")),
            wheel=self.timer_wheel,
        )
        channel.conn = conn  # takeover routing (connection.py)
        self._register_on_connect(channel, conn)
        if self._wants_intercept():
            conn.intercept = self._intercept
        self._all_conns.add(conn)
        try:
            await conn.run()
        finally:
            self._all_conns.discard(conn)
            self.limiter.drop_conn(str(id(conn)))

    def _conn_closed(self, conn) -> None:
        cid = conn.channel.clientid
        if cid is not None and self.connections.get(cid) is conn:
            del self.connections[cid]

    def _on_deliver(self, clientid: str, pubs: List[Any]) -> None:
        conn = self.connections.get(clientid)
        if conn is None:
            self.broker.outbox_put(clientid, pubs)
            return
        conn.deliver(pubs)

    def kick_client(self, clientid: str) -> bool:
        """Kick a client out (``emqx_mgmt:kickout_client``); also evicts
        an offline session (no live channel)."""
        had_session = clientid in self.broker.sessions
        chan = self.cm.kick(clientid)  # discards the broker session too
        conn = self.connections.pop(clientid, None)
        if conn is not None:
            conn.kick("kicked by management")
        self._disconnected_at.pop(clientid, None)
        return chan is not None or conn is not None or had_session

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def _intercept(self, channel, pkt):
        """The async stage before handle_in: the match prefetch, which
        micro-batches concurrent publishes into one walk on the card
        (Broker.publish consumes the hint; with the fanout on, its drain
        prefetches each batch at once instead), then the pre-resolution
        of async auth backends.  No ported backend is async
        (``needs_async()`` is false), so the second step runs only for a
        backend a caller adds that has ``authenticate_async`` or
        ``prefetch_async``; last, the exhook advisory round trips."""
        if self.match_service is not None and pkt.type == P.PUBLISH \
                and self.broker.fanout is None:
            try:
                await self.match_service.prefetch(pkt.topic, qos=pkt.qos)
            except Exception:
                log.exception("match prefetch failed (host path serves)")
        ac = self.access_control
        if ac is not None and ac.needs_async():
            # resolve async backends off the sync hook fold: the verdicts
            # park in the backends and the fold consumes them
            try:
                if pkt.type == P.CONNECT:
                    # enhanced-auth CONNECTs never run the authn chain
                    if not (pkt.proto_ver == 5 and pkt.properties.get(
                            "Authentication-Method")):
                        await ac.preauthenticate(channel, pkt)
                elif pkt.type == P.PUBLISH:
                    # a topic-alias publish carries an empty topic: the
                    # channel's alias map gives the one it authorizes
                    topic = channel.peek_topic(pkt)
                    if topic:
                        await ac.preauthorize(
                            channel.clientid, "publish", topic, pkt.qos)
                elif pkt.type == P.SUBSCRIBE:
                    # no subscribe rewrite in the port: the channel
                    # authorizes the filters as sent
                    for flt, opts in pkt.topic_filters:
                        await ac.preauthorize(
                            channel.clientid, "subscribe", flt,
                            opts.get("qos", 0))
            except Exception:
                log.exception("async auth pre-resolution failed")
        if self.exhook is not None:
            return await self.exhook.intercept(channel, pkt)
        return None

    async def start(self) -> None:
        await self._start_match_service()
        await self._start_fanout()
        await self._start_exhook()
        await self.listeners.start_all()
        self._running = True
        self._jobs.append(self.supervisor.start_child(
            "node.housekeeping", self._housekeeping))
        if self.lag_probe is not None:
            self._jobs.append(self.supervisor.start_child(
                "olp.lag_probe", self.lag_probe.run))

    async def _start_match_service(self) -> None:
        """Build and start the match service on the node's device, with
        the reference's arguments.  Unlike the reference, which logs the
        failure and serves from the host trie, a service that cannot
        start (no card, a failed kernel build, a failed warm-up, a
        start past ``tpu.start_timeout``) raises here."""
        if not self.config.get("tpu.enable"):
            return
        from .broker.match_service import MatchService

        cfg = self.config
        # the reference's segments directory; node.data_dir stays at its
        # default (persistence is not ported).  match.segments.xla_cache
        # has nothing to cache: the CUDA kernels are built once a process
        seg_dir = ""
        if cfg.get("match.segments.enable"):
            seg_dir = cfg.get("match.segments.dir") or os.path.join(
                cfg.get("node.data_dir") or "data", "segments")
        ms = MatchService(
            self.broker,
            metrics=self.observed.metrics,
            depth=min(cfg.get("tpu.max_levels"), 16),
            batch_window_s=cfg.get("tpu.batch_deadline"),
            max_batch=cfg.get("tpu.batch_size"),
            debounce_s=cfg.get("tpu.mirror_refresh_interval"),
            active_slots=cfg.get("tpu.active_slots"),
            max_matches=cfg.get("tpu.max_matches"),
            max_stale_deltas=cfg.get("tpu.max_stale_deltas"),
            bypass_rate=cfg.get("tpu.bypass_rate"),
            prefetch_timeout_s=cfg.get("tpu.prefetch_timeout"),
            table=cfg.get("tpu.table"),
            short_depth=cfg.get("tpu.short_depth"),
            split_min=cfg.get("tpu.split_min"),
            deadline=cfg.get("match.deadline.enable"),
            deadline_s=cfg.get("match.deadline_ms") / 1e3,
            pipeline=cfg.get("match.pipeline.enable"),
            pipeline_depth=cfg.get("match.pipeline.depth"),
            breaker_threshold=cfg.get("match.breaker.threshold"),
            breaker_probe_interval_s=cfg.get(
                "match.breaker.probe_interval"),
            alarms=self.observed.alarms,
            olp=self.olp,
            segments=cfg.get("match.segments.enable"),
            segments_dir=seg_dir,
            compact_interval_s=cfg.get(
                "match.segments.compact_interval"),
            compact_min_mutations=cfg.get(
                "match.segments.compact_min_mutations"),
            dirty_threshold=cfg.get("match.segments.dirty_threshold"),
            prewarm=cfg.get("match.segments.prewarm"),
            backend=cfg.get("match.backend"),
            autotune=cfg.get("match.autotune.enable"),
            autotune_reps=cfg.get("match.autotune.reps"),
            multichip=cfg.get("match.multichip.enable"),
            multichip_tp=cfg.get("match.multichip.tp"),
            multichip_native=cfg.get("match.multichip.native"),
            multichip_ep=cfg.get("match.multichip.ep.enable"),
            multichip_ep_slack=cfg.get(
                "match.multichip.ep.capacity_slack"),
            multichip_ep_micro=cfg.get(
                "match.multichip.ep.micro_matches"),
            multichip_ep_compact=cfg.get(
                "match.multichip.ep.compact"),
            multichip_degraded=cfg.get(
                "match.multichip.degraded.enable"),
            multichip_degraded_threshold=cfg.get(
                "match.multichip.degraded.fail_threshold"),
            multichip_ep_overflow_warn=cfg.get(
                "match.multichip.ep.overflow_warn"),
            multichip_ep_autotune=cfg.get(
                "match.multichip.ep.autotune.enable"),
            multichip_ep_grow_threshold=cfg.get(
                "match.multichip.ep.autotune.grow_threshold"),
            multichip_ep_shrink_threshold=cfg.get(
                "match.multichip.ep.autotune.shrink_threshold"),
            multichip_ep_max_cap_class=cfg.get(
                "match.multichip.ep.autotune.max_cap_class"),
            multichip_balance_budget=cfg.get(
                "match.multichip.ep.autotune.max_moved_roots"),
            readback_mode=cfg.get("match.readback.mode"),
            readback_auto_slack=cfg.get("match.readback.auto_slack"),
            hists=self.hists,
            flightrec=self.flightrec,
            device=self.device,
        )
        ms.supervisor = self.supervisor
        try:
            await asyncio.wait_for(ms.start(),
                                   timeout=cfg.get("tpu.start_timeout"))
            await self._await_ready(ms, cfg.get("tpu.start_timeout"))
        except BaseException:
            await ms.stop()
            raise
        self.match_service = ms
        self.broker.device_match = ms.hint_routes
        self.rule_engine.attach_match_service(ms)

    @staticmethod
    async def _await_ready(ms, timeout: float) -> None:
        """Wait until the service has synced and warmed its kernels: a
        failed warm-up (a kernel that does not build or launch) keeps
        ``ready`` false and raises here, with the warm-up's error."""
        deadline = time.monotonic() + timeout
        while not ms.ready:
            if ms.sync_error is not None:
                raise RuntimeError("the match service's first sync "
                                   "failed") from ms.sync_error
            if time.monotonic() > deadline:
                raise asyncio.TimeoutError(
                    f"the match service was not ready in {timeout} s")
            await asyncio.sleep(0.01)

    async def _start_fanout(self) -> None:
        if not self.config.get("broker.fanout.enable"):
            return
        from .broker.fanout import FanoutPipeline

        cfg = self.config
        self.fanout_pipeline = FanoutPipeline(
            self.broker,
            metrics=self.observed.metrics,
            match_service=self.match_service,
            max_batch=cfg.get("broker.fanout.max_batch"),
            min_batch=cfg.get("broker.fanout.min_batch"),
            window_s=cfg.get("broker.fanout.window"),
            adapt_window_s=cfg.get("broker.fanout.adapt_window"),
            bypass_rate=cfg.get("broker.fanout.bypass_rate"),
            queue_cap=cfg.get("broker.fanout.queue_cap"),
            shape_routes=cfg.get("broker.fanout.shape_routes"),
            shape_probe_s=cfg.get("broker.fanout.shape_probe"),
            supervisor=self.supervisor,
            olp=self.olp,
            hists=self.hists,
            e2e_per_leg_sample=cfg.get("obs.hist.e2e_per_leg_sample"),
            flightrec=self.flightrec,
        )
        await self.fanout_pipeline.start()
        self.broker.fanout = self.fanout_pipeline
        self.observed.stats.provide(
            "broker.fanout.depth", self.fanout_pipeline.depth)

    async def _start_exhook(self) -> None:
        """Dial the ``exhook.servers`` list (``name=host:port``, comma
        separated); a server that does not answer is retried by the
        manager's reconnect loop."""
        spec = (self.config.get("exhook.servers") or "").strip()
        if not spec:
            return
        from .exhook import ExHookManager, ServerSpec

        servers = []
        for part in spec.split(","):
            name, _, url = part.strip().partition("=")
            if not url:
                log.warning(
                    "exhook.servers entry %r ignored (expected name=host:port)",
                    part.strip(),
                )
                continue
            servers.append(
                ServerSpec(
                    name=name, url=url,
                    timeout=self.config.get("exhook.request_timeout"),
                    failure_action=self.config.get("exhook.failure_action"),
                )
            )
        if servers:
            self.exhook = ExHookManager(self, servers)
            await self.exhook.start()

    async def stop(self) -> None:
        self._running = False
        if self.fanout_pipeline is not None:
            # detach first, so that the drain-on-stop republishes (and
            # any offers in flight) take the per-message path
            self.broker.fanout = None
            await self.fanout_pipeline.stop()
            self.fanout_pipeline = None
        if self.match_service is not None:
            await self.match_service.stop()
            self.broker.device_match = None
            self.match_service = None
        if self.exhook is not None:
            await self.exhook.stop()
            self.exhook = None
        for job in self._jobs:
            job.cancel()
        if self._jobs:
            await asyncio.gather(*self._jobs, return_exceptions=True)
        self._jobs.clear()
        # sweep the supervision tree: any child not already stopped by
        # its subsystem's stop() goes down here, reverse boot order
        await self.supervisor.stop()
        # kick live connections before awaiting the listener's close:
        # Server.wait_closed() waits for every connection handler, and
        # _all_conns covers sockets that never completed CONNECT
        for conn in list(self._all_conns):
            conn.kick("node shutdown")
        # give connections a beat to flush their goodbyes
        await asyncio.sleep(0)
        await self.listeners.stop_all()
        if self.timer_wheel is not None:
            self.timer_wheel.close()

    async def _housekeeping(self) -> None:
        """Periodic jobs: delayed-publish firing, retained expiry and
        session expiry."""
        interval = 1.0
        while self._running:
            await asyncio.sleep(interval)
            try:
                if self.timer_wheel is not None:
                    self.observed.metrics.set(
                        "broker.timer.wheel_conns", len(self.timer_wheel))
                if self.delayed is not None:
                    self.delayed.tick()
                if self.retainer is not None:
                    self.retainer.clean_expired()
                self._expire_sessions()
            except Exception:
                log.exception("housekeeping job failed")

    def _expire_sessions(self) -> None:
        """MQTT session expiry: drop the sessions whose client stayed away
        past its Session-Expiry-Interval (emqx_cm session GC)."""
        now = time.time()
        for cid, t in list(self._disconnected_at.items()):
            sess = self.broker.sessions.get(cid)
            if sess is None or self.cm.lookup_channel(cid) is not None:
                del self._disconnected_at[cid]
                continue
            if now - t >= sess.expiry_interval:
                self.broker.close_session(cid, discard=True)
                del self._disconnected_at[cid]

    # ------------------------------------------------------------------

    def info(self) -> dict:
        """The reference's ``info()`` keys for the subsystems this node
        has; those of the subsystems it leaves out are absent.  ``auth``
        counts the attached chain's authenticators and sources (the
        reference counts those created over its management API, which
        the port does not have)."""
        ac = self.access_control
        return {
            "node": self.node_name,
            "version": __version__,
            "uptime": time.time() - self.started_at,
            "connections": len(self.connections),
            "listeners": [lst.info() for lst in self.listeners.all()],
            "rules": len(self.rule_engine.rules),
            "auth": {"authenticators": len(ac.chain._chain) if ac else 0,
                     "sources": len(ac.authz.sources) if ac else 0,
                     "attached": ac is not None},
            "tpu_match": (self.match_service.info()
                          if self.match_service is not None else None),
            "fanout": (self.fanout_pipeline.info()
                       if self.fanout_pipeline is not None else None),
            "supervisor": self.supervisor.info(),
            "flightrec": self.flightrec.info(),
            **self.broker.stats(),
        }
