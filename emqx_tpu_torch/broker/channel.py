"""The port's own copy of the reference's ``emqx_tpu/broker/channel.py``, so
that nothing here imports the JAX package.

Channel: the per-connection MQTT protocol state machine.

Behavioral reference: ``apps/emqx/src/emqx_channel.erl`` (``handle_in/2``,
``handle_out/3``) [U] (SURVEY.md §2.1, §3.2-3.4): CONNECT/auth flow,
keepalive, will message, topic aliasing, QoS flows, takeover.

IO-free: :meth:`handle_in` consumes a parsed packet and returns a list of
actions for the connection layer::

    ("send", pkt)          serialize + write
    ("close", reason)      shut the transport (after flushing sends)

Routed deliveries enter through :meth:`handle_deliver`; timers call
:meth:`check_keepalive` / :meth:`retry_deliveries`.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from .. import topic as T
from ..mqtt import frame as F
from ..mqtt import packet as P
from .broker import Broker
from .cm import ConnectionManager
from .message import Message, make_message
from .session import Publish, Session, SubOpts

__all__ = ["Channel"]

Action = Tuple[str, Any]

# v5 reason code → v3 CONNACK return code
_V3_CONNACK = {
    P.RC.SUCCESS: 0,
    P.RC.UNSPECIFIED_ERROR: 3,
    P.RC.BAD_USER_NAME_OR_PASSWORD: 4,
    P.RC.NOT_AUTHORIZED: 5,
    P.RC.SERVER_UNAVAILABLE: 3,
    P.RC.BANNED: 5,
}


class Channel:
    def __init__(
        self,
        broker: Broker,
        cm: ConnectionManager,
        conninfo: Optional[Dict[str, Any]] = None,
        max_topic_alias: int = 16,
        max_inflight: int = 32,
        server_keepalive: Optional[int] = None,
    ) -> None:
        self.broker = broker
        self.cm = cm
        self.conninfo = conninfo or {}
        self.state = "idle"          # idle → connected → disconnected
        self.proto_ver = 4
        self.clientid: Optional[str] = None
        self.username: Optional[str] = None
        self.session: Optional[Session] = None
        self.will: Optional[P.Will] = None
        self.keepalive = 0
        self.server_keepalive = server_keepalive
        self.max_topic_alias = max_topic_alias
        self.max_inflight = max_inflight
        self._aliases: Dict[int, str] = {}   # inbound alias → topic
        self.last_rx = time.time()
        # peeked-but-uncommitted retry batch (see retry_deliveries /
        # retry_commit): (entries, now) until the flush is confirmed
        self._retry_pending = None

    # ------------------------------------------------------------------

    def handle_in(self, pkt: Any) -> List[Action]:
        self.last_rx = time.time()
        if self.state == "idle":
            if pkt.type != P.CONNECT:
                return [("close", "protocol_error: packet before CONNECT")]
            return self._handle_connect(pkt)
        if pkt.type == P.CONNECT:
            return [("close", "protocol_error: duplicate CONNECT")]
        if self.state == "authenticating" and pkt.type != P.AUTH:
            # nothing but the AUTH exchange is legal mid-handshake
            return [("close", "protocol_error: packet during auth")]
        handler = {
            P.PUBLISH: self._handle_publish,
            P.PUBACK: self._handle_puback,
            P.PUBREC: self._handle_pubrec,
            P.PUBREL: self._handle_pubrel,
            P.PUBCOMP: self._handle_pubcomp,
            P.SUBSCRIBE: self._handle_subscribe,
            P.UNSUBSCRIBE: self._handle_unsubscribe,
            P.PINGREQ: lambda _: [("send", P.PingResp())],
            P.DISCONNECT: self._handle_disconnect,
            P.AUTH: self._handle_auth,
        }.get(pkt.type)
        if handler is None:
            return [("close", f"unexpected packet type {pkt.type}")]
        return handler(pkt)

    def deny_in(self, pkt: Any, rc: int) -> List[Action]:
        """Refuse an inbound packet with the protocol-correct response —
        the surface an async advisory stage (exhook) uses to veto a
        CONNECT / PUBLISH / SUBSCRIBE without entering normal handling."""
        if pkt.type == P.CONNECT:
            if self.state == "idle":  # duplicate CONNECT stays a close
                self.proto_ver = pkt.proto_ver
                return self._connack_error(rc)
            return [("close", "protocol_error: duplicate CONNECT")]
        if pkt.type == P.PUBLISH:
            return self._puback_for(pkt, rc)
        if pkt.type == P.SUBSCRIBE:
            rcs = [self._sub_rc(rc)] * len(pkt.topic_filters)
            return [("send", P.Suback(packet_id=pkt.packet_id, reason_codes=rcs))]
        return [("close", f"denied 0x{rc:02x}")]

    def _sub_rc(self, rc: int) -> int:
        """SUBACK code for this protocol version: 3.1.1 only knows
        granted-QoS 0/1/2 and 0x80 failure (spec §3.9.3)."""
        return 0x80 if rc >= 0x80 and self.proto_ver < 5 else rc

    def peek_topic(self, pkt: P.Publish) -> Optional[str]:
        """Resolve the effective topic of an inbound PUBLISH without
        mutating alias state — for advisory stages that run pre-handle_in."""
        alias = pkt.properties.get("Topic-Alias")
        if alias is not None and not pkt.topic:
            return self._aliases.get(alias)
        return pkt.topic or None

    # ------------------------------------------------------------------
    # CONNECT
    # ------------------------------------------------------------------

    def _handle_connect(self, pkt: P.Connect) -> List[Action]:
        self.proto_ver = pkt.proto_ver
        props: Dict[str, Any] = {}
        # clientid assignment (v5 §3.1.3.1)
        clientid = pkt.clientid
        if not clientid:
            if pkt.proto_ver < 5 and not pkt.clean_start:
                return self._connack_error(P.RC.UNSPECIFIED_ERROR)
            clientid = f"emqx_tpu_{uuid.uuid4().hex[:12]}"
            if pkt.proto_ver == 5:
                props["Assigned-Client-Identifier"] = clientid

        if self.broker.hooks.run("client.connect", (clientid, pkt)) == "stop":
            return self._connack_error(P.RC.NOT_AUTHORIZED)

        # MQTT 5 enhanced auth (§4.12): an Authentication-Method property
        # swaps the password check for a challenge/response AUTH exchange
        method = pkt.properties.get("Authentication-Method") \
            if pkt.proto_ver == 5 else None
        if method is not None:
            provider = self.broker.enhanced_auth.get(method)
            if provider is None:
                return self._connack_error(P.RC.BAD_AUTH_METHOD)
            # the ban/flapping checks ride this fold (the normal
            # client.authenticate fold never runs on this path)
            pre = self.broker.hooks.run_fold(
                "client.enhanced_authenticate",
                (clientid, pkt.username, None, self.conninfo),
                True,
            )
            if pre is not True:
                rc = pre if isinstance(pre, int) else P.RC.NOT_AUTHORIZED
                return self._connack_error(rc)
            verdict = provider.start(
                clientid, pkt.username,
                pkt.properties.get("Authentication-Data", b""),
            )
            if verdict[0] == "continue":
                self._auth_pending = (pkt, props, clientid, method,
                                      provider, verdict[2])
                self.state = "authenticating"
                return [("send", P.Auth(
                    reason_code=P.RC.CONTINUE_AUTHENTICATION,
                    properties={"Authentication-Method": method,
                                "Authentication-Data": verdict[1]},
                ))]
            if verdict[0] == "ok":
                props["Authentication-Method"] = method
                if verdict[3]:
                    props["Authentication-Data"] = verdict[3]
                self._record_enhanced(clientid, method, verdict)
                return self._complete_connect(pkt, props, clientid,
                                              username=verdict[1])
            return self._connack_error(P.RC.NOT_AUTHORIZED)

        ok = self.broker.hooks.run_fold(
            "client.authenticate",
            (clientid, pkt.username, pkt.password, self.conninfo),
            True,
        )
        if ok is not True:
            adm = self.broker.admission
            if adm is not None:
                # admission feature seam: auth-failure rate (a
                # credential-stuffing storm never reaches
                # client.connected, so the connect hook can't see it);
                # the peerhost rides along so host-keyed rows catch
                # rotating-clientid stuffing from one source
                adm.note_auth_failure(clientid,
                                      self.conninfo.get("peerhost"))
            rc = ok if isinstance(ok, int) else P.RC.NOT_AUTHORIZED
            return self._connack_error(rc)
        return self._complete_connect(pkt, props, clientid)

    def _record_enhanced(self, clientid: str, method: str,
                         verdict: Tuple) -> None:
        """Both completion paths (single- and multi-round) record the
        authenticated identity, incl. peerhost for ip-scoped authz."""
        self._auth_method = method
        self.broker.hooks.run(
            "client.enhanced_authenticated",
            (clientid, verdict[1], bool(verdict[2]),
             self.conninfo.get("peerhost")),
        )

    def _handle_auth(self, pkt: P.Auth) -> List[Action]:
        """AUTH from the client: the response/re-auth legs of enhanced
        auth (MQTT 5 §4.12; re-authentication §4.12.1)."""
        if (self.state == "connected"
                and pkt.reason_code == P.RC.REAUTHENTICATE):
            method = getattr(self, "_auth_method", None)
            if method is None or pkt.properties.get(
                "Authentication-Method", method
            ) != method:
                return [("send", P.Disconnect(
                    reason_code=P.RC.PROTOCOL_ERROR)),
                    ("close", "re-auth method mismatch")]
            provider = self.broker.enhanced_auth.get(method)
            if provider is None:  # deregistered while connected
                return [("send", P.Disconnect(
                    reason_code=P.RC.BAD_AUTH_METHOD)),
                    ("close", "auth method no longer available")]
            verdict = provider.start(
                self.clientid, self.username,
                pkt.properties.get("Authentication-Data", b""),
            )
            if verdict[0] == "continue":
                self._auth_pending = (None, {}, self.clientid, method,
                                      provider, verdict[2])
                return [("send", P.Auth(
                    reason_code=P.RC.CONTINUE_AUTHENTICATION,
                    properties={"Authentication-Method": method,
                                "Authentication-Data": verdict[1]},
                ))]
            if verdict[0] == "ok":
                self._record_enhanced(self.clientid, method, verdict)
                return [("send", P.Auth(
                    reason_code=P.RC.SUCCESS,
                    properties={"Authentication-Method": method,
                                "Authentication-Data": verdict[3] or b""},
                ))]
            return [("send", P.Disconnect(
                reason_code=P.RC.NOT_AUTHORIZED)),
                ("close", "re-auth denied")]
        pending = getattr(self, "_auth_pending", None)
        if pending is None or self.state not in ("authenticating",
                                                 "connected"):
            return [("close", "unexpected AUTH")]
        cpkt, props, clientid, method, provider, state = pending
        if pkt.properties.get("Authentication-Method", method) != method:
            return self._connack_error(P.RC.BAD_AUTH_METHOD)
        verdict = provider.continue_auth(
            state, pkt.properties.get("Authentication-Data", b""))
        if verdict[0] == "continue":  # multi-round methods
            self._auth_pending = (cpkt, props, clientid, method, provider,
                                  verdict[2])
            return [("send", P.Auth(
                reason_code=P.RC.CONTINUE_AUTHENTICATION,
                properties={"Authentication-Method": method,
                            "Authentication-Data": verdict[1]},
            ))]
        self._auth_pending = None
        if verdict[0] != "ok":
            if self.state == "connected":   # re-auth continue leg failed
                return [("send", P.Disconnect(
                    reason_code=P.RC.NOT_AUTHORIZED)),
                    ("close", "re-auth denied")]
            return self._connack_error(P.RC.NOT_AUTHORIZED)
        self._record_enhanced(clientid, method, verdict)
        if self.state == "connected":       # re-auth continue leg done
            return [("send", P.Auth(
                reason_code=P.RC.SUCCESS,
                properties={"Authentication-Method": method,
                            "Authentication-Data": verdict[3] or b""},
            ))]
        props["Authentication-Method"] = method
        if verdict[3]:
            props["Authentication-Data"] = verdict[3]
        return self._complete_connect(cpkt, props, clientid,
                                      username=verdict[1])

    def _complete_connect(self, pkt: P.Connect, props: Dict[str, Any],
                          clientid: str,
                          username: Optional[str] = None) -> List[Action]:
        self.clientid = clientid
        # enhanced auth carries the identity in the SASL exchange, not
        # the CONNECT username field
        self.username = username if username is not None else pkt.username
        self.will = pkt.will
        self.keepalive = pkt.keepalive
        if self.server_keepalive is not None and pkt.proto_ver == 5:
            self.keepalive = self.server_keepalive
            props["Server-Keep-Alive"] = self.server_keepalive

        recv_max = pkt.properties.get("Receive-Maximum", self.max_inflight)
        if recv_max == 0:  # MQTT5 §3.1.2.11: value 0 is a protocol error
            return self._connack_error(P.RC.PROTOCOL_ERROR)
        expiry = pkt.properties.get("Session-Expiry-Interval")
        kw = {"max_inflight": min(recv_max, self.max_inflight)}
        if expiry is not None:
            kw["expiry_interval"] = float(expiry)
        elif pkt.proto_ver == 5 or pkt.clean_start:
            # v5 default: session ends at disconnect (§3.1.2.11)
            kw["expiry_interval"] = 0.0
        # else: 3.1.1 clean_session=0 has no expiry on the wire — the
        # configured mqtt.session_expiry_interval default applies
        sess, present, old_chan = self.cm.open_session(
            clientid, pkt.clean_start, self, **kw
        )
        self.session = sess
        self.state = "connected"
        if pkt.proto_ver == 5:
            props["Topic-Alias-Maximum"] = self.max_topic_alias
            props["Shared-Subscription-Available"] = 1
            props["Wildcard-Subscription-Available"] = 1
            props["Subscription-Identifier-Available"] = 1
        actions: List[Action] = []
        if old_chan is not None and old_chan is not self:
            actions.append(("takeover", old_chan))
        actions.append(
            (
                "send",
                P.Connack(
                    session_present=present,
                    reason_code=P.RC.SUCCESS if self.proto_ver == 5 else 0,
                    properties=props,
                ),
            )
        )
        self.broker.usernames[clientid] = self.username
        self.broker.hooks.run("client.connected", (clientid, self.conninfo))
        if present:
            for pub in sess.resume_publishes():
                actions.append(("send", self._to_publish_pkt(pub)))
        return actions

    def _connack_error(self, rc: int) -> List[Action]:
        code = rc if self.proto_ver == 5 else _V3_CONNACK.get(rc, 3)
        return [
            ("send", P.Connack(session_present=False, reason_code=code)),
            ("close", f"connack error 0x{rc:02x}"),
        ]

    # ------------------------------------------------------------------
    # PUBLISH (inbound)
    # ------------------------------------------------------------------

    def _resolve_alias(self, pkt: P.Publish) -> Optional[str]:
        alias = pkt.properties.get("Topic-Alias")
        if alias is not None:
            if not 1 <= alias <= self.max_topic_alias:
                return None
            if pkt.topic:
                self._aliases[alias] = pkt.topic
                return pkt.topic
            return self._aliases.get(alias)
        return pkt.topic or None

    def _handle_publish(self, pkt: P.Publish) -> List[Action]:
        topic = self._resolve_alias(pkt)
        if topic is None:
            return [("close", "topic alias invalid")]
        adm = self.broker.admission
        if adm is not None:
            # admission feature seam: publish rate / bytes / topic fan,
            # noted BEFORE validity/authz so denied floods register too
            adm.note_publish(self.clientid, topic, len(pkt.payload))
        if not T.is_valid(topic, "name"):
            return self._puback_for(pkt, P.RC.TOPIC_NAME_INVALID)
        allowed = self.broker.hooks.run_fold(
            "client.authorize",
            (self.clientid, "publish", topic,
             {"qos": pkt.qos, "retain": pkt.retain}),
            True,
        )
        if allowed is not True:
            return self._puback_for(pkt, P.RC.NOT_AUTHORIZED)
        # an advisory stage (exhook message.publish) may re-route without
        # touching the wire topic / alias registration
        route_topic = getattr(pkt, "route_topic", None) or topic
        msg = make_message(
            self.clientid, route_topic, pkt.payload, qos=pkt.qos,
            retain=pkt.retain, properties=dict(pkt.properties),
        )
        if getattr(pkt, "allow_publish", True) is False:
            # vetoed upstream (exhook advisory): ack normally, never route
            msg = msg.clone(headers={**msg.headers, "allow_publish": False})
        # batched fanout pipeline (broker/fanout.py): the hot path offers
        # the message and acks immediately — PUBACK/PUBREC mean "broker
        # took responsibility", so acking before the batch flushes is
        # spec-faithful (NO_MATCHING_SUBSCRIBERS is a MAY, §3.4.2.1).
        # A refusal (disabled / low-rate bypass / overload) falls back to
        # the synchronous per-message path unchanged.
        fanout = self.broker.fanout
        if pkt.qos == 2:
            st = self.session.publish_qos2(pkt.packet_id, msg)
            if st == "full":
                return [("send", P.PubAck(P.PUBREC, pkt.packet_id, P.RC.QUOTA_EXCEEDED))]
            if st == "ok" and not (fanout is not None and fanout.offer(msg)):
                self.broker.publish(msg)
            return [("send", P.PubAck(P.PUBREC, pkt.packet_id))]
        if fanout is not None and fanout.offer(msg):
            if pkt.qos == 1:
                return [("send", P.PubAck(P.PUBACK, pkt.packet_id))]
            return []
        res = self.broker.publish(msg)
        if pkt.qos == 1:
            rc = (
                P.RC.NO_MATCHING_SUBSCRIBERS
                if res.no_subscribers and self.proto_ver == 5
                else P.RC.SUCCESS
            )
            return [("send", P.PubAck(P.PUBACK, pkt.packet_id, rc))]
        return []

    def handle_publish_run(
        self, run: P.PublishRun
    ) -> Tuple[bytes, List[Action], List[P.Publish]]:
        """Consume a contiguous same-QoS (1/2) PUBLISH run wholesale
        (the parser's publish-run fast path, the ingest mirror of
        :meth:`handle_ack_run`): the topic-validity check and the
        ``client.authorize`` fold run once per unique (topic, retain)
        in the run instead of once per packet, the QoS2 receiver
        transition runs per packet, and the PUBACK/PUBREC burst is
        built inline (4 bytes per rc-0 ack, no serializer pass).

        Returns ``(reply_bytes, actions, rest)``.  The caller emits
        ``reply_bytes``, runs ``actions``, then feeds ``rest`` (still
        unprocessed packets) through normal per-packet handling —
        together byte-for-byte what the per-packet path would emit, in
        order.  The fast loop only engages while every message is
        GUARANTEED to enter the fanout pipeline
        (:meth:`FanoutPipeline.will_accept`): pipeline deliveries
        happen after the whole burst, so grouping the acks preserves
        order.  Anything that would take the synchronous publish path
        (whose deliveries interleave with acks) lands in ``rest``
        before any side effect runs for it."""
        self.last_rx = time.time()
        broker = self.broker
        fanout = broker.fanout
        pkts = run.pkts
        if fanout is None or not fanout.will_accept(len(pkts)):
            return b"", [], pkts
        adm = broker.admission
        if adm is not None:
            # admission feature seam, batch form: one row lookup for
            # the whole publish run
            adm.note_publish_batch(self.clientid, pkts)
        sess = self.session
        v5 = self.proto_ver == 5
        run_fold = broker.hooks.run_fold
        # (topic, retain) → True | rc   (qos is constant across the run)
        verdicts: Dict[Tuple[str, bool], Any] = {}
        qos = run.qos
        out = bytearray()
        ack_head = P.PUBREC << 4 if qos == 2 else P.PUBACK << 4
        for i, pkt in enumerate(pkts):
            topic = self._resolve_alias(pkt)
            if topic is None:
                return bytes(out), [("close", "topic alias invalid")], []
            key = (topic, pkt.retain)
            rc = verdicts.get(key)
            if rc is None:
                if not T.is_valid(topic, "name"):
                    rc = P.RC.TOPIC_NAME_INVALID
                else:
                    allowed = run_fold(
                        "client.authorize",
                        (self.clientid, "publish", topic,
                         {"qos": qos, "retain": pkt.retain}),
                        True,
                    )
                    rc = True if allowed is True else P.RC.NOT_AUTHORIZED
                verdicts[key] = rc
            pid = pkt.packet_id
            if rc is not True:
                # refusal acks carry the reason code only on a v5 wire
                if v5:
                    out += F.serialize(P.PubAck(
                        P.PUBREC if qos == 2 else P.PUBACK, pid, rc),
                        ver=5)
                else:
                    out += bytes((ack_head, 2, pid >> 8, pid & 0xFF))
                continue
            msg = make_message(
                self.clientid, topic, pkt.payload, qos=qos,
                retain=pkt.retain, properties=dict(pkt.properties),
            )
            if qos == 2:
                st = sess.publish_qos2(pid, msg)
                if st == "full":
                    if v5:
                        out += F.serialize(P.PubAck(
                            P.PUBREC, pid, P.RC.QUOTA_EXCEEDED), ver=5)
                        continue
                    out += bytes((ack_head, 2, pid >> 8, pid & 0xFF))
                    continue
                if st == "ok" and not fanout.offer(msg):
                    # can't happen after will_accept (no await between
                    # check and offers), but never lose the message
                    broker.publish(msg)
                out += bytes((ack_head, 2, pid >> 8, pid & 0xFF))
                continue
            # QoS1
            if not fanout.offer(msg):  # same: guaranteed-accept guard
                broker.publish(msg)
            out += bytes((ack_head, 2, pid >> 8, pid & 0xFF))
        return bytes(out), [], []

    def _puback_for(self, pkt: P.Publish, rc: int) -> List[Action]:
        if pkt.qos == 1:
            return [("send", P.PubAck(P.PUBACK, pkt.packet_id, rc))]
        if pkt.qos == 2:
            return [("send", P.PubAck(P.PUBREC, pkt.packet_id, rc))]
        if rc == P.RC.NOT_AUTHORIZED and self.proto_ver == 5:
            return [("send", P.Disconnect(reason_code=rc)), ("close", "not authorized")]
        return []

    # ------------------------------------------------------------------
    # QoS acks (outbound flow)
    # ------------------------------------------------------------------

    def _handle_puback(self, pkt: P.PubAck) -> List[Action]:
        msg, more = self.session.puback(pkt.packet_id)
        if msg is not None:
            self.broker.hooks.run("message.acked", (self.clientid, msg))
        return [("send", self._to_publish_pkt(p)) for p in more]

    def handle_puback_batch(self, pkts: List[P.PubAck]) -> List[Publish]:
        """A run of consecutive PUBACKs from one TCP read (the batched
        datapath calls this instead of per-packet :meth:`handle_in`):
        one window-refill cycle covers the whole burst.  Returns the
        refill publishes for the caller's bulk send path — the same
        packets per-ack handling would emit, in the same order."""
        self.last_rx = time.time()
        acked, more = self.session.puback_batch(
            [pkt.packet_id for pkt in pkts])
        if acked:
            hooks = self.broker.hooks
            if hooks.has("message.acked"):
                for msg in acked:
                    hooks.run("message.acked", (self.clientid, msg))
        return more

    # one reply head per inbound ack type that answers with an ack
    _ACK_REPLY_HEAD = {
        P.PUBREC: ((P.PUBREL << 4) | 2, P.PUBREL),
        P.PUBREL: (P.PUBCOMP << 4, P.PUBCOMP),
    }

    def handle_ack_run(self, run: P.AckRun) -> Tuple[bytes, List[Publish]]:
        """Consume a packed same-type ack run wholesale (the parser's
        ack-run fast path): one batched session transition covers the
        whole burst.  Returns ``(reply_bytes, refill)`` — the exact ack
        frames the per-packet path would have sent back, pre-serialized
        in order, plus the window-refill publishes for the caller's
        bulk send path."""
        self.last_rx = time.time()
        sess = self.session
        t = run.type
        if t == P.PUBACK:
            acked, more = sess.puback_batch(run.pids)
            if acked:
                hooks = self.broker.hooks
                if hooks.has("message.acked"):
                    for msg in acked:
                        hooks.run("message.acked", (self.clientid, msg))
            return b"", more
        if t == P.PUBCOMP:
            _known, more = sess.pubcomp_batch(run.pids)
            return b"", more
        if t == P.PUBREC:
            oks = sess.pubrec_batch(run.pids)
        else:  # PUBREL (inbound QoS2 release)
            oks = sess.pubrel_received_batch(run.pids)
        head, rtype = self._ACK_REPLY_HEAD[t]
        out = bytearray()
        v5 = self.proto_ver == 5
        for pid, ok in zip(run.pids, oks):
            if ok or not v5:
                # 4-byte pid-only ack: rc 0 (or a v3/4 peer, where the
                # reason code never hits the wire) — built inline, no
                # serializer pass
                out += bytes((head, 2, pid >> 8, pid & 0xFF))
            else:
                out += F.serialize(
                    P.PubAck(rtype, pid, P.RC.PACKET_ID_NOT_FOUND), ver=5)
        return bytes(out), []

    def _handle_pubrec(self, pkt: P.PubAck) -> List[Action]:
        if self.session.pubrec(pkt.packet_id):
            return [("send", P.PubAck(P.PUBREL, pkt.packet_id))]
        return [("send", P.PubAck(P.PUBREL, pkt.packet_id, P.RC.PACKET_ID_NOT_FOUND))]

    def _handle_pubrel(self, pkt: P.PubAck) -> List[Action]:
        if self.session.pubrel_received(pkt.packet_id):
            return [("send", P.PubAck(P.PUBCOMP, pkt.packet_id))]
        return [("send", P.PubAck(P.PUBCOMP, pkt.packet_id, P.RC.PACKET_ID_NOT_FOUND))]

    def _handle_pubcomp(self, pkt: P.PubAck) -> List[Action]:
        known, more = self.session.pubcomp(pkt.packet_id)
        return [("send", self._to_publish_pkt(p)) for p in more]

    # ------------------------------------------------------------------
    # SUBSCRIBE / UNSUBSCRIBE
    # ------------------------------------------------------------------

    def _handle_subscribe(self, pkt: P.Subscribe) -> List[Action]:
        if self.broker.hooks.run("client.subscribe", (self.clientid, pkt)) == "stop":
            rcs = [self._sub_rc(P.RC.NOT_AUTHORIZED)] * len(pkt.topic_filters)
            return [("send", P.Suback(packet_id=pkt.packet_id, reason_codes=rcs))]
        subid = pkt.properties.get("Subscription-Identifier")
        denied = getattr(pkt, "denied_filters", ())
        rcs: List[int] = []
        for i, (flt, o) in enumerate(pkt.topic_filters):
            if i in denied:  # vetoed upstream (exhook advisory)
                rcs.append(self._sub_rc(P.RC.NOT_AUTHORIZED))
                continue
            if not T.is_valid(flt, "filter"):
                rcs.append(self._sub_rc(P.RC.TOPIC_FILTER_INVALID))
                continue
            allowed = self.broker.hooks.run_fold(
                "client.authorize",
                (self.clientid, "subscribe", flt, {"qos": o.get("qos", 0)}),
                True,
            )
            if allowed is not True:
                rcs.append(self._sub_rc(P.RC.NOT_AUTHORIZED))
                continue
            opts = SubOpts(
                qos=o.get("qos", 0), nl=bool(o.get("nl", 0)),
                rap=bool(o.get("rap", 0)), rh=o.get("rh", 0), subid=subid,
            )
            self.broker.subscribe(self.clientid, flt, opts)
            rcs.append(opts.qos)  # granted qos
        return [("send", P.Suback(packet_id=pkt.packet_id, reason_codes=rcs))]

    def _handle_unsubscribe(self, pkt: P.Unsubscribe) -> List[Action]:
        # hooks may rewrite pkt.topic_filters in place (topic-rewrite rules)
        self.broker.hooks.run("client.unsubscribe", (self.clientid, pkt))
        rcs = []
        for flt in pkt.topic_filters:
            ok = self.broker.unsubscribe(self.clientid, flt)
            rcs.append(P.RC.SUCCESS if ok else 0x11)  # no-subscription-existed
        return [("send", P.Unsuback(packet_id=pkt.packet_id, reason_codes=rcs))]

    # ------------------------------------------------------------------
    # DISCONNECT / close / will
    # ------------------------------------------------------------------

    def _handle_disconnect(self, pkt: P.Disconnect) -> List[Action]:
        # MQTT5 §3.1.2.5/§3.14: only a normal disconnect (0x00) deletes the
        # will; 0x04 and every other non-zero reason publish it on close.
        if pkt.reason_code == 0:
            self.will = None
        expiry = pkt.properties.get("Session-Expiry-Interval")
        if expiry is not None and self.session is not None:
            self.session.expiry_interval = float(expiry)
        self.state = "disconnected"
        return [("close", "client disconnect")]

    def handle_close(self, reason: str = "closed") -> None:
        """Transport gone: publish will (if any), unregister, run hooks."""
        if self.state == "connected":
            self.state = "disconnected"
        if self.will is not None:
            wmsg = make_message(
                self.clientid, self.will.topic, self.will.payload,
                qos=self.will.qos, retain=self.will.retain,
                properties=dict(self.will.properties),
            )
            self.broker.publish(wmsg)
            self.will = None
        if self.clientid is not None:
            # Only the owning channel may tear down broker-side state; a
            # displaced channel closing late must not destroy its
            # successor's live session.
            owner = self.cm.lookup_channel(self.clientid) is self
            self.cm.unregister_channel(self.clientid, self)
            if owner:
                self.broker.close_session(self.clientid)
                self.broker.hooks.run(
                    "client.disconnected", (self.clientid, reason)
                )

    def handle_takeover(self) -> List[Action]:
        """This channel is displaced by a newer CONNECT of the same id."""
        self.will = None  # takeover does not fire the will
        self.state = "disconnected"
        out: List[Action] = []
        if self.proto_ver == 5:
            out.append(("send", P.Disconnect(reason_code=P.RC.SESSION_TAKEN_OVER)))
        out.append(("close", "session taken over"))
        return out

    # ------------------------------------------------------------------
    # outbound deliveries & timers
    # ------------------------------------------------------------------

    def handle_deliver(self, pubs: List[Publish]) -> List[Action]:
        return [("send", self._to_publish_pkt(p)) for p in pubs]

    # MQTT5 §3.3.2.3: publish properties forwarded to subscribers
    # (hoisted — this filter runs once per delivery/retry/resume leg,
    # the per-leg hot path of the acknowledged-delivery stack)
    _FWD_PROPS = frozenset((
        "Payload-Format-Indicator", "Message-Expiry-Interval",
        "Content-Type", "Response-Topic", "Correlation-Data",
        "User-Property", "Subscription-Identifier",
    ))

    def _to_publish_pkt(self, p: Publish) -> P.Publish:
        m = p.msg
        props: Dict[str, Any] = {}
        if self.proto_ver == 5 and m.properties:
            fwd = self._FWD_PROPS
            props = {k: v for k, v in m.properties.items() if k in fwd}
        return P.Publish(
            dup=m.dup, qos=m.qos, retain=m.retain, topic=m.topic,
            packet_id=p.pid, payload=m.payload, properties=props,
        )

    def check_keepalive(self, now: Optional[float] = None) -> List[Action]:
        """MQTT §3.1.2.10: close after 1.5 × keepalive of silence."""
        if self.state != "connected" or self.keepalive == 0:
            return []
        now = now if now is not None else time.time()
        if now - self.last_rx > self.keepalive * 1.5:
            return [("close", "keepalive timeout")]
        return []

    def retry_deliveries(self, now: Optional[float] = None) -> List[Action]:
        """Resend actions for due inflight entries.  Peek-only: the DUP
        clone / age-clock commit is deferred until the connection layer
        confirms the flush with :meth:`retry_commit` — a dead transport
        must not burn clones (and silently swallow a retry interval)
        for resends that never left the process."""
        if self.session is None:
            return []
        entries = self.session.retry_peek(now)
        self._retry_pending = (entries, now)
        out: List[Action] = []
        for pid, kind, msg in entries:
            if kind == "publish":
                pkt = self._to_publish_pkt(Publish(pid, msg))
                pkt.dup = True
                out.append(("send", pkt))
            else:
                out.append(("send", P.PubAck(P.PUBREL, pid)))
        return out

    def retry_wire_batch(self, now: Optional[float] = None) -> List[bytes]:
        """Batched-resend path (``broker.fanout.enable`` datapaths):
        the same due entries as :meth:`retry_deliveries`, rendered as
        wire bytes through the QoS1/2 template cache — patch the
        2 pid bytes and set the DUP bit instead of a full serializer
        pass per resend — for ONE coalesced flush per tick.  Commit
        rides :meth:`retry_commit` exactly like the action path."""
        sess = self.session
        if sess is None:
            return []
        entries = sess.retry_peek(now)
        self._retry_pending = (entries, now)
        if not entries:
            return []
        out: List[bytes] = []
        ver = self.proto_ver
        pubrel_head = (P.PUBREL << 4) | 2
        for pid, kind, msg in entries:
            if kind != "publish":
                # PUBREL resend: 4-byte pid-only shape in any version
                out.append(bytes((pubrel_head, 2, pid >> 8, pid & 0xFF)))
                continue
            data = None
            cache = msg.__dict__.get("_wire1")
            ent = cache.get(ver) if cache is not None else None
            if ent is not None:
                tpl, off = ent
                buf = bytearray(tpl)
                buf[0] |= 0x08           # DUP bit (fixed header, §3.3.1.1)
                buf[off] = pid >> 8
                buf[off + 1] = pid & 0xFF
                data = bytes(buf)
            else:
                pkt = self._to_publish_pkt(Publish(pid, msg))
                pkt.dup = True
                data = F.serialize(pkt, ver=ver)
            out.append(data)
        return out

    def retry_commit(self) -> None:
        """Commit the last peeked retry batch (clone/touch) — called by
        the connection layer once the resend flush went through."""
        pending = getattr(self, "_retry_pending", None)
        self._retry_pending = None
        if pending and self.session is not None:
            entries, now = pending
            self.session.retry_commit(entries, now)
