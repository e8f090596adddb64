"""The port's own copy of the reference's ``emqx_tpu/client.py``, so
that nothing here imports the JAX package.

Asyncio MQTT client — the `emqtt` analog (SURVEY.md §2.3: client lib +
load generator used for the baseline runs).

Full v3.1.1/v5 client over TCP or WebSocket: CONNECT negotiation,
QoS 0/1/2 publish flows with inflight tracking, SUBSCRIBE/UNSUBSCRIBE,
keepalive PINGREQ, auto reason-code surfacing.  Incoming PUBLISHes land in
an asyncio queue (or a callback), with the full QoS2 receiver FSM.
"""

from __future__ import annotations

import asyncio
import struct
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .mqtt import frame as F
from .mqtt import packet as P

__all__ = ["Client", "MqttError", "InboundMessage"]


class MqttError(Exception):
    pass


@dataclass
class InboundMessage:
    topic: str
    payload: bytes
    qos: int = 0
    retain: bool = False
    dup: bool = False
    properties: Dict[str, Any] = field(default_factory=dict)


class Client:
    def __init__(
        self,
        clientid: str = "",
        host: str = "127.0.0.1",
        port: int = 1883,
        proto_ver: int = 4,
        clean_start: bool = True,
        keepalive: int = 60,
        username: Optional[str] = None,
        password: Optional[bytes] = None,
        will: Optional[P.Will] = None,
        properties: Optional[Dict[str, Any]] = None,
        on_message: Optional[Callable[[InboundMessage], None]] = None,
        max_packet_size: int = F.MAX_REMAINING_LEN,
        on_auth: Optional[Callable[[bytes], bytes]] = None,
    ) -> None:
        self.clientid = clientid
        self.host, self.port = host, port
        self.proto_ver = proto_ver
        self.clean_start = clean_start
        self.keepalive = keepalive
        self.username, self.password = username, password
        self.will = will
        self.conn_properties = properties or {}
        self.on_message = on_message
        self.on_auth = on_auth  # enhanced auth: challenge bytes -> response
        self.messages: "asyncio.Queue[InboundMessage]" = asyncio.Queue()
        self.connack: Optional[P.Connack] = None
        self.connected = False
        self._parser = F.Parser(max_packet_size=max_packet_size)
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pid_counter = 0
        self._pending: Dict[Tuple[int, int], asyncio.Future] = {}
        self._pids: set = set()   # pids awaiting an ack (O(1) alloc)
        # (topic, payload_len) → serialized v4 QoS1 PUBLISH head: a
        # pipelined publisher re-sending one topic patches 2 pid bytes
        # instead of paying a serializer pass per message (bytes
        # identical to frame.serialize; v5/props/retain use the
        # serializer as before)
        self._pub_heads: Dict[Tuple[str, int], bytes] = {}
        # while a feed batch is being handled, outbound pid-only acks
        # (PUBACK/PUBREC/PUBCOMP) collect here and flush as ONE write
        # per TCP read — the consumer-side analog of the broker's
        # coalesced ack writes
        self._ack_buf: Optional[bytearray] = None
        self._rel_pending: Dict[int, P.Publish] = {}  # QoS2 rx, awaiting REL
        self._tasks: List[asyncio.Task] = []
        self._closed = asyncio.Event()
        self.disconnect_reason: Optional[int] = None
        self.reauth_result: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------

    async def connect(self, timeout: float = 10.0) -> P.Connack:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port
        )
        from .transport.connection import set_nodelay

        set_nodelay(self._writer.get_extra_info("socket"))
        # inbound packets parse with the version we offer (the server's
        # parser learns it from our CONNECT; ours must be pre-pinned)
        self._parser.proto_ver = self.proto_ver
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._pending[(P.CONNACK, 0)] = fut
        self._tasks.append(asyncio.ensure_future(self._read_loop()))
        self._send(
            P.Connect(
                proto_ver=self.proto_ver,
                clientid=self.clientid,
                clean_start=self.clean_start,
                keepalive=self.keepalive,
                username=self.username,
                password=self.password,
                will=self.will,
                properties=dict(self.conn_properties),
            )
        )
        try:
            self.connack = await asyncio.wait_for(fut, timeout)
        except (asyncio.TimeoutError, TimeoutError, MqttError):
            await self.close()  # no socket/task leak on a dead broker
            raise
        rc = self.connack.reason_code
        if rc != 0:
            await self.close()
            raise MqttError(f"CONNACK refused rc={rc}")
        if "Assigned-Client-Identifier" in self.connack.properties:
            self.clientid = self.connack.properties[
                "Assigned-Client-Identifier"
            ]
        self.connected = True
        if self.keepalive:
            self._tasks.append(asyncio.ensure_future(self._ping_loop()))
        return self.connack

    async def subscribe(
        self,
        filters,
        qos: int = 0,
        timeout: float = 10.0,
        **opts,
    ) -> List[int]:
        """filters: str or [(filter, qos)] / [filter]. Returns SUBACK codes."""
        if isinstance(filters, str):
            filters = [(filters, qos)]
        topics = [
            (x, {"qos": qos, **opts}) if isinstance(x, str)
            else (x[0], {"qos": x[1], **opts})
            for x in filters
        ]
        pid = self._next_pid()
        ack = await self._request(
            P.Subscribe(packet_id=pid, topic_filters=topics),
            (P.SUBACK, pid),
            timeout,
        )
        return list(ack.reason_codes)

    async def unsubscribe(self, filters, timeout: float = 10.0) -> List[int]:
        if isinstance(filters, str):
            filters = [filters]
        pid = self._next_pid()
        ack = await self._request(
            P.Unsubscribe(packet_id=pid, topic_filters=list(filters)),
            (P.UNSUBACK, pid),
            timeout,
        )
        return list(getattr(ack, "reason_codes", []) or [])

    async def publish(
        self,
        topic: str,
        payload: bytes = b"",
        qos: int = 0,
        retain: bool = False,
        properties: Optional[Dict[str, Any]] = None,
        timeout: float = 10.0,
    ) -> Optional[int]:
        """QoS0: fire-and-forget.  QoS1: await PUBACK.  QoS2: full
        PUBREC/PUBREL/PUBCOMP handshake.  Returns the ack reason code."""
        pkt = P.Publish(
            qos=qos, retain=retain, topic=topic, payload=payload,
            properties=properties or {},
        )
        if qos == 0:
            self._send(pkt)
            return None
        pid = pkt.packet_id = self._next_pid()
        if qos == 1:
            ack = await self._request(pkt, (P.PUBACK, pid), timeout)
            return getattr(ack, "reason_code", 0)
        return await self._publish_qos2(pkt, pid, timeout)

    def publish_start(
        self,
        topic: str,
        payload: bytes = b"",
        retain: bool = False,
        properties: Optional[Dict[str, Any]] = None,
    ):
        """Pipelined QoS1 publish: send now, return the PUBACK future —
        the emqtt_bench async-publish mode.  The caller bounds its own
        inflight window by awaiting futures."""
        pid = self._next_pid()
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        key = (P.PUBACK, pid)
        self._pending[key] = fut
        self._pids.add(pid)
        fut.add_done_callback(
            lambda _f: (self._pending.pop(key, None),
                        self._pids.discard(pid)))
        if self.proto_ver < 5 and not retain and not properties:
            # template fast path: head cached per (topic, len), only
            # the 2 pid bytes differ between repeats — identical bytes
            # to the serializer
            hkey = (topic, len(payload))
            head = self._pub_heads.get(hkey)
            if head is None:
                tb = topic.encode("utf-8")
                rl = 2 + len(tb) + 2 + len(payload)
                head = (bytes((0x32,)) + F._enc_varint(rl)
                        + struct.pack(">H", len(tb)) + tb)
                self._pub_heads[hkey] = head
            if self._writer is None:
                raise MqttError("not connected")
            self._writer.write(
                head + struct.pack(">H", pid) + payload)
            return fut
        pkt = P.Publish(
            qos=1, retain=retain, topic=topic, payload=payload,
            properties=properties or {}, packet_id=pid,
        )
        self._send(pkt)
        return fut

    async def _publish_qos2(self, pkt, pid: int, timeout: float):
        rec = await self._request(pkt, (P.PUBREC, pid), timeout)
        rc = getattr(rec, "reason_code", 0)
        if rc >= 0x80:
            return rc
        comp = await self._request(
            P.PubAck(P.PUBREL, pid), (P.PUBCOMP, pid), timeout
        )
        return getattr(comp, "reason_code", 0)

    async def recv(self, timeout: float = 10.0) -> "InboundMessage":
        if not self.messages.empty():
            # fast path: no timer arm/disarm per already-queued message
            return self.messages.get_nowait()
        return await asyncio.wait_for(self.messages.get(), timeout)

    async def recv_many(self, timeout: float = 10.0,
                        max_n: int = 0) -> List["InboundMessage"]:
        """Wait for at least one message, then drain everything already
        queued (up to ``max_n``; 0 = unbounded).  One await per burst
        instead of one per message — the consumer-side analog of the
        broker's batched fanout flush."""
        q = self.messages
        out: List[InboundMessage] = []
        if q.empty():
            out.append(await asyncio.wait_for(q.get(), timeout))
        while not q.empty() and (not max_n or len(out) < max_n):
            out.append(q.get_nowait())
        return out

    async def disconnect(self, reason_code: int = 0) -> None:
        if self._writer is not None and not self._writer.is_closing():
            try:
                self._send(P.Disconnect(reason_code=reason_code))
                await self._writer.drain()
            except ConnectionError:
                pass
        await self.close()

    async def close(self) -> None:
        self.connected = False
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except Exception:
                pass
        for t in self._tasks:
            t.cancel()
        self._tasks.clear()
        self._closed.set()

    async def wait_closed(self) -> None:
        await self._closed.wait()


    # ------------------------------------------------------------------

    def _next_pid(self) -> int:
        """1..65535 with wraparound, skipping ids still awaiting an ack
        (MQTT §2.2.1 packet identifiers are 16-bit).  O(1) via the
        in-use pid set (the old per-call scan of ``_pending`` was
        O(window) per publish — measurable at bench windows)."""
        in_use = self._pids
        for _ in range(65535):
            self._pid_counter = (self._pid_counter % 65535) + 1
            pid = self._pid_counter
            if pid not in in_use:
                return pid
        raise MqttError("no free packet id")

    def _send(self, pkt: Any) -> None:
        if self._writer is None:
            raise MqttError("not connected")
        self._writer.write(F.serialize(pkt, ver=self.proto_ver))

    async def _request(self, pkt: Any, key: Tuple[int, int], timeout: float):
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._pending[key] = fut
        self._pids.add(key[1])
        self._send(pkt)
        try:
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(key, None)
            self._pids.discard(key[1])

    async def _ping_loop(self) -> None:
        while True:
            await asyncio.sleep(max(self.keepalive * 0.75, 1.0))
            try:
                self._send(P.PingReq())
            except (MqttError, ConnectionError):
                return

    async def _read_loop(self) -> None:
        try:
            while True:
                data = await self._reader.read(65536)
                if not data:
                    break
                pkts = self._parser.feed(data)
                self._ack_buf = ab = bytearray()
                try:
                    for pkt in pkts:
                        self._handle(pkt)
                finally:
                    self._ack_buf = None
                    if ab and self._writer is not None:
                        # every pid-only ack for this TCP read in ONE
                        # write (bytes identical to per-packet sends)
                        self._writer.write(bytes(ab))
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self.connected = False
            self._closed.set()
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(MqttError("connection closed"))

    def _handle(self, pkt: Any) -> None:
        t = pkt.type
        if t == P.CONNACK:
            self._resolve((P.CONNACK, 0), pkt)
        elif t in (P.SUBACK, P.UNSUBACK, P.PUBACK, P.PUBCOMP, P.PUBREC):
            self._resolve((t, pkt.packet_id), pkt)
        elif t == P.PUBLISH:
            self._handle_publish(pkt)
        elif t == P.PUBREL:
            held = self._rel_pending.pop(pkt.packet_id, None)
            if held is not None:
                self._emit(held)
            self._ack(0x70, pkt.packet_id)  # PUBCOMP
        elif t == P.DISCONNECT:
            self.disconnect_reason = getattr(pkt, "reason_code", 0)
        elif t == P.AUTH and pkt.reason_code != P.RC.CONTINUE_AUTHENTICATION:
            # AUTH rc=0x00: server-side completion of a re-auth — expose
            # the final data (server signature) for caller verification
            self.reauth_result = dict(pkt.properties)
        elif t == P.AUTH and self.on_auth is None:
            # fail fast instead of hanging until the connect timeout
            self._resolve((P.CONNACK, 0), MqttError(
                "AUTH challenge received but no on_auth handler"))
        elif t == P.AUTH:
            # enhanced-auth challenge: compute + send the response leg
            try:
                data = self.on_auth(
                    pkt.properties.get("Authentication-Data", b""))
                self._send(P.Auth(
                    reason_code=P.RC.CONTINUE_AUTHENTICATION,
                    properties={
                        "Authentication-Method":
                            self.conn_properties.get(
                                "Authentication-Method", ""),
                        "Authentication-Data": data,
                    },
                ))
            except Exception as e:
                self._resolve((P.CONNACK, 0), MqttError(f"auth failed: {e}"))
        # PINGRESP: nothing to do

    def _ack(self, head: int, pid: int) -> None:
        """Send a pid-only ack (rc 0 — 4 bytes in every version):
        coalesced into one write per TCP read while a feed batch is
        open, identical bytes to a per-packet serialize+send."""
        if self._ack_buf is not None:
            self._ack_buf += bytes((head, 2, pid >> 8, pid & 0xFF))
        else:
            self._send(P.PubAck(head >> 4, pid))

    def _handle_publish(self, pkt: P.Publish) -> None:
        if pkt.qos == 0:
            self._emit(pkt)
        elif pkt.qos == 1:
            self._emit(pkt)
            self._ack(0x40, pkt.packet_id)  # PUBACK
        else:  # QoS2 receiver: hold until PUBREL (exactly-once)
            if pkt.packet_id not in self._rel_pending:
                self._rel_pending[pkt.packet_id] = pkt
            self._ack(0x50, pkt.packet_id)  # PUBREC

    def _emit(self, pkt: P.Publish) -> None:
        msg = InboundMessage(
            topic=pkt.topic, payload=pkt.payload, qos=pkt.qos,
            retain=pkt.retain, dup=pkt.dup, properties=dict(pkt.properties),
        )
        if self.on_message is not None:
            self.on_message(msg)
        else:
            self.messages.put_nowait(msg)

    def _resolve(self, key: Tuple[int, int], pkt: Any) -> None:
        fut = self._pending.get(key)
        if fut is not None and not fut.done():
            if isinstance(pkt, Exception):
                fut.set_exception(pkt)
            else:
                fut.set_result(pkt)
