"""Broker-side ExHook manager — streams hook points to gRPC servers.

The port's copy of ``emqx_tpu/exhook/manager.py``, over the port's
broker, channel and fault injector; ``BrokerNode`` builds it from
``exhook.servers``.  Its behaviour is the reference's.

Behavioral reference: ``apps/emqx_exhook/src/emqx_exhook_handler.erl`` /
``emqx_exhook_mgr.erl`` [U] (SURVEY.md §2.3, §3.6):

* each configured server is dialled at start; ``OnProviderLoaded``
  negotiates which hook points that server wants;
* *advisory* hooks (client.authenticate / client.authorize /
  message.publish) are synchronous gRPC round trips whose
  ``ValuedResponse`` may stop the chain with a verdict or a mutated
  message;
* *notification* hooks (client.connected, session.*, message.delivered,
  ...) are fire-and-forget events;
* per-server ``failure_action`` (``deny`` | ``ignore``) applies when the
  call errors or times out — ``ignore`` fails open (SURVEY.md §5.3).

Integration: the synchronous broker core never awaits; the async round
trips happen in :meth:`ExHookManager.intercept`, which the connection
loop awaits *before* ``Channel.handle_in`` for CONNECT / PUBLISH /
SUBSCRIBE packets, applying verdicts by rewriting the packet (mutation),
tagging it (``allow_publish`` / ``denied_filters``, consumed by the
channel), or short-circuiting with ``Channel.deny_in`` actions.
Notification events ride the normal sync hook bus into a bounded queue
drained by one background sender task per server.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import grpc
import grpc.aio

from .. import faultinject as _fi
from ..mqtt import packet as P
from .rpc import HookProviderStub, MirrorSyncStub, pb

log = logging.getLogger(__name__)

__all__ = ["ServerSpec", "ExHookManager"]

#: every hook point the manager can stream (reference exhook v2 set)
ALL_HOOKS = [
    "client.connect", "client.connack", "client.connected",
    "client.disconnected", "client.authenticate", "client.authorize",
    "client.subscribe", "client.unsubscribe",
    "session.created", "session.subscribed", "session.unsubscribed",
    "session.resumed", "session.discarded", "session.takenover",
    "session.terminated",
    "message.publish", "message.delivered", "message.dropped",
    "message.acked",
]

_NOTIFY_QUEUE_CAP = 10000


@dataclass
class ServerSpec:
    name: str
    url: str                       # "host:port"
    failure_action: str = "ignore"  # "deny" | "ignore"
    timeout: float = 5.0
    enable: bool = True


@dataclass
class _ServerState:
    spec: ServerSpec
    channel: Optional[grpc.aio.Channel] = None
    stub: Optional[HookProviderStub] = None
    hooks: List[str] = field(default_factory=list)
    queue: "asyncio.Queue" = field(default_factory=lambda: asyncio.Queue(_NOTIFY_QUEUE_CAP))
    sender: Optional[asyncio.Task] = None
    ok: int = 0
    failed: int = 0
    dropped: int = 0

    def wants(self, point: str) -> bool:
        return point in self.hooks


class ExHookManager:
    """Owns the server registry + the packet intercept stage."""

    def __init__(self, node: Any, servers: List[ServerSpec]) -> None:
        self.node = node
        self.broker = node.broker
        self.servers: List[_ServerState] = [
            _ServerState(spec=s) for s in servers if s.enable
        ]
        self._running = False
        self._hook_names: List[str] = []
        self._reconnector: Optional[asyncio.Task] = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    RECONNECT_INTERVAL = 5.0

    async def start(self) -> None:
        self._running = True
        # dial concurrently: N unreachable servers cost one timeout, not N
        await asyncio.gather(
            *(self._load_server(st) for st in self.servers)
        )
        self._register_notify_hooks()
        sup = getattr(self.node, "supervisor", None)
        if sup is not None:
            self._reconnector = sup.start_child(
                "exhook.reconnect", self._reconnect_loop)
        else:
            self._reconnector = asyncio.ensure_future(self._reconnect_loop())

    async def _reconnect_loop(self) -> None:
        """Keep retrying servers that failed to load — a deny-policy
        server fails closed while down (see ``_down_deny``), so recovery
        must not require a broker restart."""
        while self._running:
            await asyncio.sleep(self.RECONNECT_INTERVAL)
            for st in self.servers:
                if st.stub is None:
                    await self._load_server(st)

    async def stop(self) -> None:
        self._running = False
        if getattr(self, "_reconnector", None) is not None:
            self._reconnector.cancel()
            self._reconnector = None
        self._unregister_notify_hooks()
        for st in self.servers:
            if st.sender is not None:
                st.sender.cancel()
            if st.stub is not None:
                try:
                    await asyncio.wait_for(
                        st.stub.OnProviderUnloaded(
                            pb.ProviderUnloadedRequest(meta=self._meta())
                        ),
                        timeout=st.spec.timeout,
                    )
                except Exception:
                    log.debug("exhook %s OnProviderUnloaded failed",
                              st.spec.name, exc_info=True)
            if st.channel is not None:
                await st.channel.close()
                st.channel = None

    async def _load_server(self, st: _ServerState) -> None:
        # st.stub stays None until negotiation succeeds — _down_deny and
        # the advisory loops treat a non-None stub as "server usable"
        channel = stub = None
        try:
            channel = grpc.aio.insecure_channel(st.spec.url)
            stub = HookProviderStub(channel)
            resp = await asyncio.wait_for(
                stub.OnProviderLoaded(
                    pb.ProviderLoadedRequest(
                        broker=pb.BrokerInfo(
                            version="emqx_tpu",
                            sysdescr="tpu-native broker",
                            uptime=str(int(time.time() - self.node.started_at)),
                        ),
                        meta=self._meta(),
                    )
                ),
                timeout=st.spec.timeout,
            )
            st.hooks = [h.name for h in resp.hooks if h.name in ALL_HOOKS]
            st.channel, st.stub = channel, stub
            if st.sender is None:
                sup = getattr(self.node, "supervisor", None)
                if sup is not None:
                    # supervised: a crashed notification drain restarts
                    # instead of silently dropping every hook event for
                    # this server until broker restart
                    st.sender = sup.start_child(
                        f"exhook.sender.{st.spec.name}",
                        lambda st=st: self._sender_loop(st))
                else:
                    st.sender = asyncio.ensure_future(self._sender_loop(st))
            log.info("exhook server %s loaded hooks=%s", st.spec.name, st.hooks)
            await self._push_mirror_snapshot(st)
        except Exception as e:
            log.warning("exhook server %s load failed: %s", st.spec.name, e)
            st.hooks = []
            if channel is not None:
                await channel.close()

    async def _push_mirror_snapshot(self, st: _ServerState) -> None:
        """Reconcile a subscription-mirroring server (our TPU sidecar)
        with the broker's CURRENT filter set at (re)connect: hook events
        only stream changes, so without this a restarted sidecar keeps
        checkpoint ghosts and misses pre-existing subscriptions.  Stock
        HookProvider servers don't implement MirrorSync — UNIMPLEMENTED
        is expected and ignored."""
        if "session.subscribed" not in st.hooks:
            return
        ref: Dict[str, int] = {}
        for sess in self.broker.sessions.values():
            for flt in sess.subscriptions:
                f = self._strip_share(flt)
                ref[f] = ref.get(f, 0) + 1
        try:
            mirror = MirrorSyncStub(st.channel)
            items = sorted(ref.items())
            epoch = self.broker.router.epoch

            async def chunks():
                if not items:
                    yield pb.SnapshotChunk(epoch=epoch, last=True)
                for i in range(0, len(items), 1024):
                    part = items[i:i + 1024]
                    yield pb.SnapshotChunk(
                        epoch=epoch,
                        filters=[f for f, _ in part],
                        refcounts=[c for _, c in part],
                        last=i + 1024 >= len(items),
                    )

            ack = await asyncio.wait_for(
                mirror.InstallSnapshot(chunks()), timeout=st.spec.timeout * 4
            )
            log.info(
                "exhook server %s mirror snapshot: %d filters acked",
                st.spec.name, ack.n_filters,
            )
        except Exception as e:
            log.debug(
                "exhook server %s has no MirrorSync (%s) — hook-only feed",
                st.spec.name, e,
            )

    def _meta(self) -> pb.RequestMeta:
        return pb.RequestMeta(
            node=self.broker.node, version="0.1", sysdescr="emqx_tpu",
            cluster_name="emqx_tpu",
        )

    # ------------------------------------------------------------------
    # notification hooks (fire-and-forget over the sync hook bus)
    # ------------------------------------------------------------------

    def _register_notify_hooks(self) -> None:
        hooks = self.broker.hooks
        reg = [
            ("client.connected",
             lambda cid, info: self._notify("OnClientConnected",
                 pb.ClientConnectedRequest(clientinfo=self._clientinfo(cid),
                                           meta=self._meta()),
                 "client.connected")),
            ("client.disconnected",
             lambda cid, reason: self._notify("OnClientDisconnected",
                 pb.ClientDisconnectedRequest(clientinfo=self._clientinfo(cid),
                                              reason=str(reason),
                                              meta=self._meta()),
                 "client.disconnected")),
            ("session.created",
             lambda cid: self._notify("OnSessionCreated",
                 pb.SessionCreatedRequest(clientinfo=self._clientinfo(cid),
                                          meta=self._meta()),
                 "session.created")),
            # topic carries the routing filter ($share/<g>/ stripped — the
            # group rides subopts.share); the sidecar mirror matches on it
            ("session.subscribed",
             lambda cid, flt, opts, is_new: self._notify("OnSessionSubscribed",
                 pb.SessionSubscribedRequest(
                     clientinfo=self._clientinfo(cid),
                     topic=self._strip_share(flt),
                     subopts=pb.SubOpts(qos=opts.qos,
                                        share=opts.share or "",
                                        rh=opts.rh, rap=int(opts.rap),
                                        nl=int(opts.nl)),
                     meta=self._meta()),
                 "session.subscribed")),
            ("session.unsubscribed",
             lambda cid, flt: self._notify("OnSessionUnsubscribed",
                 pb.SessionUnsubscribedRequest(
                     clientinfo=self._clientinfo(cid),
                     topic=self._strip_share(flt),
                     meta=self._meta()),
                 "session.unsubscribed")),
            ("session.resumed",
             lambda cid: self._notify("OnSessionResumed",
                 pb.SessionResumedRequest(clientinfo=self._clientinfo(cid),
                                          meta=self._meta()),
                 "session.resumed")),
            ("session.discarded",
             lambda cid: self._notify("OnSessionDiscarded",
                 pb.SessionDiscardedRequest(clientinfo=self._clientinfo(cid),
                                            meta=self._meta()),
                 "session.discarded")),
            ("session.terminated",
             lambda cid: self._notify("OnSessionTerminated",
                 pb.SessionTerminatedRequest(clientinfo=self._clientinfo(cid),
                                             reason="terminated",
                                             meta=self._meta()),
                 "session.terminated")),
            ("message.delivered",
             lambda cid, msg: self._notify("OnMessageDelivered",
                 pb.MessageDeliveredRequest(clientinfo=self._clientinfo(cid),
                                            message=self._pb_msg(msg),
                                            meta=self._meta()),
                 "message.delivered")),
            ("message.acked",
             lambda cid, msg: self._notify("OnMessageAcked",
                 pb.MessageAckedRequest(clientinfo=self._clientinfo(cid),
                                        message=self._pb_msg(msg),
                                        meta=self._meta()),
                 "message.acked")),
            ("message.dropped",
             lambda msg, reason: self._notify("OnMessageDropped",
                 pb.MessageDroppedRequest(message=self._pb_msg(msg),
                                          reason=str(reason),
                                          meta=self._meta()),
                 "message.dropped")),
        ]
        self._hook_names = []
        for point, fn in reg:
            name = f"exhook.{point}"
            hooks.add(point, fn, priority=-100, name=name)  # after core hooks
            self._hook_names.append((point, name))

    def _unregister_notify_hooks(self) -> None:
        for point, name in self._hook_names:
            self.broker.hooks.delete(point, name)
        self._hook_names = []

    def _notify(self, method: str, req: Any, point: str) -> None:
        for st in self.servers:
            if st.stub is None or not st.wants(point):
                continue
            try:
                st.queue.put_nowait((method, req))
            except asyncio.QueueFull:
                st.dropped += 1

    async def _sender_loop(self, st: _ServerState) -> None:
        while True:
            method, req = await st.queue.get()
            try:
                await asyncio.wait_for(
                    getattr(st.stub, method)(req), timeout=st.spec.timeout
                )
                st.ok += 1
            except asyncio.CancelledError:
                raise
            except Exception:
                st.failed += 1

    # ------------------------------------------------------------------
    # advisory intercept (awaited by the connection loop pre-handle_in)
    # ------------------------------------------------------------------

    async def intercept(self, channel: Any, pkt: Any) -> Optional[List[Any]]:
        """Run advisory round trips for this packet.  Returns ``None`` to
        proceed with (a possibly mutated) ``pkt``, or a list of channel
        actions that replace normal handling (a deny)."""
        try:
            if pkt.type == P.CONNECT:
                if channel.state != "idle":
                    return None  # duplicate CONNECT: normal handling closes
                return await self._on_connect(channel, pkt)
            if pkt.type == P.PUBLISH and channel.state == "connected":
                return await self._on_publish(channel, pkt)
            if pkt.type == P.SUBSCRIBE and channel.state == "connected":
                return await self._on_subscribe(channel, pkt)
            if pkt.type == P.UNSUBSCRIBE and channel.state == "connected":
                self._notify_unsubscribe(channel, pkt)
        except Exception:
            log.exception("exhook intercept failed")
        return None

    async def _on_connect(self, channel, pkt) -> Optional[List[Any]]:
        conninfo = pb.ConnInfo(
            node=self.broker.node, clientid=pkt.clientid or "",
            username=pkt.username or "", peerhost=self._peerhost(channel),
            proto_name="MQTT", proto_ver=str(pkt.proto_ver),
            keepalive=pkt.keepalive,
        )
        self._notify("OnClientConnect",
                     pb.ClientConnectRequest(conninfo=conninfo,
                                             meta=self._meta()),
                     "client.connect")
        # fail-closed check first: a later deny-policy server that never
        # loaded must veto even if an earlier server would allow
        if any(self._down_deny(st) for st in self.servers):
            return channel.deny_in(pkt, P.RC.SERVER_UNAVAILABLE)
        for st in self.servers:
            if st.stub is None or not st.wants("client.authenticate"):
                continue
            req = pb.ClientAuthenticateRequest(
                clientinfo=pb.ClientInfo(
                    node=self.broker.node, clientid=pkt.clientid or "",
                    username=pkt.username or "",
                    password=(pkt.password or b"").decode("utf-8", "replace")
                    if isinstance(pkt.password, (bytes, bytearray))
                    else (pkt.password or ""),
                    peerhost=self._peerhost(channel),
                ),
                result=True, meta=self._meta(),
            )
            verdict = await self._advise(st, "OnClientAuthenticate", req)
            if verdict == "deny":
                return channel.deny_in(pkt, P.RC.NOT_AUTHORIZED)
            if verdict == "allow":
                break  # STOP_AND_RETURN true: short-circuit remaining servers
        return None

    async def _on_publish(self, channel, pkt) -> Optional[List[Any]]:
        # resolve v5 topic aliases so advisory rules see the real topic;
        # unresolvable (unknown alias / empty) → let the channel reject
        topic = channel.peek_topic(pkt)
        if topic is None:
            return None
        # fail-closed check covers BOTH advisory loops below (authorize and
        # message.publish), before any server's allow can short-circuit
        if any(self._down_deny(st) for st in self.servers):
            return channel.deny_in(pkt, P.RC.NOT_AUTHORIZED)
        for st in self.servers:
            if st.stub is None or not st.wants("client.authorize"):
                continue
            req = pb.ClientAuthorizeRequest(
                clientinfo=self._clientinfo(channel.clientid),
                type=pb.ClientAuthorizeRequest.PUBLISH,
                topic=topic, result=True, meta=self._meta(),
            )
            verdict = await self._advise(st, "OnClientAuthorize", req)
            if verdict == "deny":
                return channel.deny_in(pkt, P.RC.NOT_AUTHORIZED)
            if verdict == "allow":
                break
        for st in self.servers:
            if st.stub is None or not st.wants("message.publish"):
                continue
            req = pb.MessagePublishRequest(
                message=pb.Message(
                    node=self.broker.node, qos=pkt.qos,
                    **{"from": channel.clientid or ""},
                    topic=topic, payload=bytes(pkt.payload),
                    timestamp=int(time.time() * 1000),
                ),
                meta=self._meta(),
            )
            resp, err = await self._call(st, "OnMessagePublish", req)
            if err:
                if st.spec.failure_action == "deny":
                    return channel.deny_in(pkt, P.RC.UNSPECIFIED_ERROR)
                continue
            if resp.type == pb.ValuedResponse.STOP_AND_RETURN:
                if resp.WhichOneof("value") == "message":
                    m = resp.message
                    if m.headers.get("allow_publish") == "false":
                        pkt.allow_publish = False
                    else:
                        # mutate routed content only; the packet's QoS/ack
                        # flow and alias registration stay untouched (a QoS
                        # edit would desync the client's PUBACK/PUBREC
                        # expectations; a wire-topic edit would corrupt the
                        # alias map)
                        from .. import topic as T

                        if (
                            m.topic and m.topic != topic
                            and T.is_valid(m.topic, "name")
                        ):
                            pkt.route_topic = m.topic
                        pkt.payload = m.payload
                break
        return None

    async def _on_subscribe(self, channel, pkt) -> Optional[List[Any]]:
        filters = [
            pb.TopicFilter(name=flt, qos=o.get("qos", 0))
            for flt, o in pkt.topic_filters
        ]
        self._notify("OnClientSubscribe",
                     pb.ClientSubscribeRequest(
                         clientinfo=self._clientinfo(channel.clientid),
                         topic_filters=filters, meta=self._meta()),
                     "client.subscribe")
        if any(self._down_deny(st) for st in self.servers):
            pkt.denied_filters = set(range(len(pkt.topic_filters)))
            return None

        async def check(flt: str) -> bool:
            """True if this filter is denied.  Servers chain sequentially
            (chain semantics); independent filters run concurrently."""
            for st in self.servers:
                if st.stub is None or not st.wants("client.authorize"):
                    continue
                req = pb.ClientAuthorizeRequest(
                    clientinfo=self._clientinfo(channel.clientid),
                    type=pb.ClientAuthorizeRequest.SUBSCRIBE,
                    topic=flt, result=True, meta=self._meta(),
                )
                verdict = await self._advise(st, "OnClientAuthorize", req)
                if verdict == "deny":
                    return True
                if verdict == "allow":
                    return False
            return False

        verdicts = await asyncio.gather(
            *(check(flt) for flt, _ in pkt.topic_filters)
        )
        denied = {i for i, d in enumerate(verdicts) if d}
        if denied:
            pkt.denied_filters = denied
        return None

    def _notify_unsubscribe(self, channel, pkt) -> None:
        filters = [pb.TopicFilter(name=f) for f in pkt.topic_filters]
        self._notify("OnClientUnsubscribe",
                     pb.ClientUnsubscribeRequest(
                         clientinfo=self._clientinfo(channel.clientid),
                         topic_filters=filters, meta=self._meta()),
                     "client.unsubscribe")

    # ------------------------------------------------------------------

    def _down_deny(self, st: _ServerState) -> bool:
        """A deny-policy server that never loaded fails CLOSED: we don't
        know its hook set, so every advisory operation is refused until
        the reconnect loop brings it back."""
        return st.stub is None and st.spec.failure_action == "deny"

    async def _call(self, st: _ServerState, method: str, req) -> Tuple[Any, bool]:
        try:
            if _fi._injector is not None:
                # chaos seam: a raised call fault takes the server's
                # failure_action path (deny fails closed, ignore open);
                # a delay exercises the timeout handling
                act = _fi._injector.act("exhook.call")
                if act == "raise":
                    raise _fi.InjectedFault("exhook.call")
                if act == "delay":
                    await _fi._injector.pause()
            resp = await asyncio.wait_for(
                getattr(st.stub, method)(req), timeout=st.spec.timeout
            )
            st.ok += 1
            return resp, False
        except asyncio.CancelledError:
            raise
        except Exception as e:
            st.failed += 1
            log.debug("exhook %s %s failed: %s", st.spec.name, method, e)
            return None, True

    async def _advise(self, st: _ServerState, method: str, req) -> str:
        """Returns 'deny' | 'allow' (stop-and-return true) | 'continue'."""
        resp, err = await self._call(st, method, req)
        if err:
            return "deny" if st.spec.failure_action == "deny" else "continue"
        if resp.type == pb.ValuedResponse.STOP_AND_RETURN:
            if resp.WhichOneof("value") == "bool_result":
                return "allow" if resp.bool_result else "deny"
        return "continue"

    # ------------------------------------------------------------------

    @staticmethod
    def _strip_share(flt: str) -> str:
        from .. import topic as T

        share = T.parse_share(flt)
        return share[1] if share is not None else flt

    def _clientinfo(self, clientid: Optional[str]) -> pb.ClientInfo:
        cid = clientid or ""
        return pb.ClientInfo(
            node=self.broker.node, clientid=cid,
            username=self.broker.usernames.get(cid) or "",
        )

    def _pb_msg(self, msg: Any) -> pb.Message:
        return pb.Message(
            node=self.broker.node, id=str(getattr(msg, "id", "")),
            qos=getattr(msg, "qos", 0),
            **{"from": getattr(msg, "sender", "") or ""},
            topic=getattr(msg, "topic", ""),
            payload=bytes(getattr(msg, "payload", b"") or b""),
            timestamp=int(getattr(msg, "timestamp", time.time()) * 1000),
        )

    def _peerhost(self, channel) -> str:
        info = getattr(channel, "conninfo", None) or {}
        peer = info.get("peername") if isinstance(info, dict) else None
        return str(peer[0]) if isinstance(peer, (tuple, list)) and peer else ""

    def stats(self) -> List[dict]:
        return [
            {
                "name": st.spec.name, "url": st.spec.url,
                "hooks": list(st.hooks), "ok": st.ok, "failed": st.failed,
                "dropped": st.dropped,
                "connected": st.stub is not None,
            }
            for st in self.servers
        ]
