"""The port's own copy of the reference's ``emqx_tpu/mqtt/frame.py``, so
that nothing here imports the JAX package.

MQTT wire codec: streaming parser + serializer, v3.1/3.1.1/5.0.

Behavioral reference: ``apps/emqx/src/emqx_frame.erl`` (``parse/2`` with
continuation state, ``serialize/2``) [U] (SURVEY.md §2.1): incremental
parse over a byte stream, remaining-length varint, v5 properties,
max-packet-size enforcement, malformed-packet errors.

Round-trip law (property-tested): ``parse(serialize(pkt)) == pkt``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

from .. import faultinject as _fi
from . import packet as P

__all__ = ["FrameError", "Parser", "serialize", "parse_one"]

MAX_REMAINING_LEN = 268_435_455


class FrameError(ValueError):
    def __init__(self, msg: str, reason_code: int = P.RC.MALFORMED_PACKET):
        super().__init__(msg)
        self.reason_code = reason_code


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _enc_varint(n: int) -> bytes:
    if n < 0 or n > MAX_REMAINING_LEN:
        raise FrameError(f"varint out of range: {n}")
    out = bytearray()
    while True:
        b = n % 128
        n //= 128
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _dec_varint(buf: bytes, i: int) -> Tuple[int, int]:
    mult, val = 1, 0
    for k in range(4):
        if i + k >= len(buf):
            raise _NeedMore()
        b = buf[i + k]
        val += (b & 0x7F) * mult
        if not b & 0x80:
            return val, i + k + 1
        mult *= 128
    raise FrameError("malformed varint")


class _NeedMore(Exception):
    """Internal: buffer does not hold a complete value yet."""


def _enc_utf8(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) > 0xFFFF:
        raise FrameError("utf8 string too long")
    return struct.pack(">H", len(b)) + b


def _enc_bin(b: bytes) -> bytes:
    if len(b) > 0xFFFF:
        raise FrameError("binary too long")
    return struct.pack(">H", len(b)) + b


class _Reader:
    __slots__ = ("buf", "i")

    def __init__(self, buf: bytes, i: int = 0):
        self.buf = buf
        self.i = i

    def remaining(self) -> int:
        return len(self.buf) - self.i

    def take(self, n: int) -> bytes:
        if self.remaining() < n:
            raise FrameError("truncated packet")
        b = self.buf[self.i : self.i + n]
        self.i += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack(">H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]

    def varint(self) -> int:
        try:
            v, self.i = _dec_varint(self.buf, self.i)
        except _NeedMore:
            raise FrameError("truncated varint")
        return v

    def utf8(self) -> str:
        n = self.u16()
        try:
            return self.take(n).decode("utf-8")
        except UnicodeDecodeError:
            raise FrameError("invalid utf8")

    def bin(self) -> bytes:
        return self.take(self.u16())

    def rest(self) -> bytes:
        b = self.buf[self.i :]
        self.i = len(self.buf)
        return b


# ---------------------------------------------------------------------------
# v5 properties
# ---------------------------------------------------------------------------

# id -> (name, kind)
_PROPS = {
    0x01: ("Payload-Format-Indicator", "u8"),
    0x02: ("Message-Expiry-Interval", "u32"),
    0x03: ("Content-Type", "utf8"),
    0x08: ("Response-Topic", "utf8"),
    0x09: ("Correlation-Data", "bin"),
    0x0B: ("Subscription-Identifier", "varint"),
    0x11: ("Session-Expiry-Interval", "u32"),
    0x12: ("Assigned-Client-Identifier", "utf8"),
    0x13: ("Server-Keep-Alive", "u16"),
    0x15: ("Authentication-Method", "utf8"),
    0x16: ("Authentication-Data", "bin"),
    0x17: ("Request-Problem-Information", "u8"),
    0x18: ("Will-Delay-Interval", "u32"),
    0x19: ("Request-Response-Information", "u8"),
    0x1A: ("Response-Information", "utf8"),
    0x1C: ("Server-Reference", "utf8"),
    0x1F: ("Reason-String", "utf8"),
    0x21: ("Receive-Maximum", "u16"),
    0x22: ("Topic-Alias-Maximum", "u16"),
    0x23: ("Topic-Alias", "u16"),
    0x24: ("Maximum-QoS", "u8"),
    0x25: ("Retain-Available", "u8"),
    0x26: ("User-Property", "pair"),
    0x27: ("Maximum-Packet-Size", "u32"),
    0x28: ("Wildcard-Subscription-Available", "u8"),
    0x29: ("Subscription-Identifier-Available", "u8"),
    0x2A: ("Shared-Subscription-Available", "u8"),
}
_PROP_IDS = {name: (pid, kind) for pid, (name, kind) in _PROPS.items()}


def _parse_props(r: _Reader) -> Dict[str, Any]:
    total = r.varint()
    end = r.i + total
    props: Dict[str, Any] = {}
    while r.i < end:
        pid = r.varint()
        ent = _PROPS.get(pid)
        if ent is None:
            raise FrameError(f"unknown property id 0x{pid:02x}")
        name, kind = ent
        if kind == "u8":
            v: Any = r.u8()
        elif kind == "u16":
            v = r.u16()
        elif kind == "u32":
            v = r.u32()
        elif kind == "varint":
            v = r.varint()
        elif kind == "utf8":
            v = r.utf8()
        elif kind == "bin":
            v = r.bin()
        else:  # pair
            v = (r.utf8(), r.utf8())
        if name == "User-Property":
            props.setdefault(name, []).append(v)
        else:
            if name in props:
                raise FrameError(f"duplicate property {name}", P.RC.PROTOCOL_ERROR)
            props[name] = v
    if r.i != end:
        raise FrameError("property length mismatch")
    return props


def _ser_props(props: Optional[Dict[str, Any]]) -> bytes:
    body = bytearray()
    for name, val in (props or {}).items():
        ent = _PROP_IDS.get(name)
        if ent is None:
            raise FrameError(f"unknown property {name!r}")
        pid, kind = ent
        vals = val if name == "User-Property" else [val]
        for v in vals:
            body += _enc_varint(pid)
            if kind == "u8":
                body.append(int(v) & 0xFF)
            elif kind == "u16":
                body += struct.pack(">H", int(v))
            elif kind == "u32":
                body += struct.pack(">I", int(v))
            elif kind == "varint":
                body += _enc_varint(int(v))
            elif kind == "utf8":
                body += _enc_utf8(str(v))
            elif kind == "bin":
                body += _enc_bin(bytes(v))
            else:
                k, s = v
                body += _enc_utf8(k) + _enc_utf8(s)
    return _enc_varint(len(body)) + bytes(body)


# ---------------------------------------------------------------------------
# parse
# ---------------------------------------------------------------------------

# first fixed-header byte of the four pid-only ack shapes the fast path
# recognizes (PUBREL carries its mandatory 0b0010 flags; the other three
# must have zero flags to match — anything else takes the slow path,
# which validates exactly as before)
_ACK_HEADS = frozenset((
    P.PUBACK << 4, P.PUBREC << 4, (P.PUBREL << 4) | 2, P.PUBCOMP << 4,
))


class Parser:
    """Incremental stream parser: feed bytes, collect packets.

    ``proto_ver`` starts at 4 and is updated from an inbound CONNECT so
    subsequent packets parse with the negotiated version (mirrors
    emqx_frame's parse-state options).

    ``ack_runs`` (opt-in, the broker's batched-ingest datapath):
    contiguous pid-only acks of one type (4-byte fixed shape —
    remaining length 2, so reason code 0 and no properties in ANY
    version) are recognized straight off the buffer, skipping
    ``_try_parse``/``_Reader``/props machinery, and emitted packed as
    one :class:`~emqx_tpu_torch.mqtt.packet.AckRun`.  Acks carrying a v5
    reason code or properties have remaining length > 2 and fall back
    to the per-packet path, byte-identical."""

    def __init__(self, max_packet_size: int = MAX_REMAINING_LEN,
                 proto_ver: int = 4, ack_runs: bool = False,
                 publish_runs: bool = False):
        self.max_packet_size = max_packet_size
        self.proto_ver = proto_ver
        self.ack_runs = ack_runs
        # opt-in (rides the same batched-ingest datapath as ack_runs):
        # contiguous QoS1/2 PUBLISHes of one feed pack into a
        # PublishRun so the channel amortizes per-run costs.  Off, the
        # emitted packet list is exactly the per-packet parse.
        self.publish_runs = publish_runs
        self._buf = bytearray()
        # decoded fixed header of the (incomplete) head packet:
        # (remaining_len, hdr_end), valid until bytes are consumed from
        # the buffer head — avoids re-decoding the varint on every feed
        # while a large packet straddles reads
        self._hdr: Optional[Tuple[int, int]] = None

    def feed(self, data: bytes) -> List[Any]:
        if _fi._injector is not None:
            # chaos seam: an injected parse fault takes the seam's
            # NATIVE error path (FrameError → connection close), so
            # recovery exercises the real malformed-packet handling
            if _fi._injector.act("frame.parse") == "raise":
                raise FrameError("injected fault: frame.parse")
        buf = self._buf
        buf += data
        out: List[Any] = []
        ack_runs = self.ack_runs
        while True:
            if ack_runs and len(buf) >= 4 and buf[0] in _ACK_HEADS \
                    and buf[1] == 0x02:
                # ack-run fast path: pack every contiguous same-type
                # 4-byte ack at the buffer head into ONE AckRun
                b1 = buf[0]
                n = len(buf)
                i = 4
                pids = [(buf[2] << 8) | buf[3]]
                append = pids.append
                while n - i >= 4 and buf[i] == b1 and buf[i + 1] == 0x02:
                    append((buf[i + 2] << 8) | buf[i + 3])
                    i += 4
                del buf[:i]
                self._hdr = None
                out.append(P.AckRun(b1 >> 4, pids))
                continue
            pkt, consumed = self._try_parse()
            if pkt is None:
                break
            out.append(pkt)
            del buf[:consumed]
        if self.publish_runs and len(out) > 1:
            out = self._pack_publish_runs(out)
        return out

    @staticmethod
    def _pack_publish_runs(pkts: List[Any]) -> List[Any]:
        """Group contiguous same-QoS (1/2) PUBLISHes into PublishRun
        objects (runs of one stay bare packets).  Pure regrouping: the
        concatenation of the output, runs expanded, is the input."""
        out: List[Any] = []
        run: List[Any] = []
        run_qos = 0
        for pkt in pkts:
            if type(pkt) is P.Publish and pkt.qos in (1, 2):
                if run and pkt.qos != run_qos:
                    out.append(P.PublishRun(run_qos, run)
                               if len(run) > 1 else run[0])
                    run = []
                run_qos = pkt.qos
                run.append(pkt)
                continue
            if run:
                out.append(P.PublishRun(run_qos, run)
                           if len(run) > 1 else run[0])
                run = []
            out.append(pkt)
        if run:
            out.append(P.PublishRun(run_qos, run)
                       if len(run) > 1 else run[0])
        return out

    def _try_parse(self):
        # Header is decoded straight off the bytearray (no copy); the body
        # is materialized once, only when the whole packet has arrived —
        # keeps large-packet reception O(n), not O(n²) in bytes copied.
        buf = self._buf
        if len(buf) < 2:
            return None, 0
        hdr = self._hdr
        if hdr is None:
            try:
                rl, hdr_end = _dec_varint(buf, 1)
            except _NeedMore:
                return None, 0
        else:
            rl, hdr_end = hdr
        total = hdr_end + rl
        if total > self.max_packet_size:
            raise FrameError("packet too large", P.RC.PACKET_TOO_LARGE)
        if len(buf) < total:
            self._hdr = (rl, hdr_end)
            return None, 0
        self._hdr = None
        pkt = _parse_packet(buf[0], bytes(buf[hdr_end:total]), self.proto_ver)
        if isinstance(pkt, P.Connect):
            self.proto_ver = pkt.proto_ver
        return pkt, total


def parse_one(data: bytes, proto_ver: int = 4):
    """Parse exactly one complete packet from ``data``."""
    pkts = Parser(proto_ver=proto_ver).feed(data)
    if not pkts:
        raise FrameError("incomplete packet")
    return pkts[0]


def _parse_packet(b1: int, body: bytes, ver: int):
    ptype = b1 >> 4
    flags = b1 & 0x0F
    r = _Reader(body)
    if ptype == P.CONNECT:
        return _parse_connect(r)
    if ptype == P.CONNACK:
        ack_flags = r.u8()
        rc = r.u8()
        props = _parse_props(r) if ver == 5 and r.remaining() else {}
        return P.Connack(P.CONNACK, bool(ack_flags & 1), rc, props)
    if ptype == P.PUBLISH:
        qos = (flags >> 1) & 3
        if qos == 3:
            raise FrameError("invalid qos 3")
        topic = r.utf8()
        pid = r.u16() if qos > 0 else None
        props = _parse_props(r) if ver == 5 else {}
        return P.Publish(
            P.PUBLISH, bool(flags & 8), qos, bool(flags & 1), topic, pid,
            r.rest(), props,
        )
    if ptype in (P.PUBACK, P.PUBREC, P.PUBREL, P.PUBCOMP):
        if ptype == P.PUBREL and flags != 2:
            raise FrameError("PUBREL flags must be 0b0010")
        pid = r.u16()
        rc, props = 0, {}
        if ver == 5 and r.remaining():
            rc = r.u8()
            if r.remaining():
                props = _parse_props(r)
        return P.PubAck(ptype, pid, rc, props)
    if ptype == P.SUBSCRIBE:
        if flags != 2:
            raise FrameError("SUBSCRIBE flags must be 0b0010")
        pid = r.u16()
        props = _parse_props(r) if ver == 5 else {}
        filters = []
        while r.remaining():
            flt = r.utf8()
            o = r.u8()
            opts = {"qos": o & 3}
            if ver == 5:
                opts.update(nl=(o >> 2) & 1, rap=(o >> 3) & 1, rh=(o >> 4) & 3)
            filters.append((flt, opts))
        if not filters:
            raise FrameError("empty SUBSCRIBE", P.RC.PROTOCOL_ERROR)
        return P.Subscribe(P.SUBSCRIBE, pid, filters, props)
    if ptype == P.SUBACK:
        pid = r.u16()
        props = _parse_props(r) if ver == 5 else {}
        return P.Suback(P.SUBACK, pid, list(r.rest()), props)
    if ptype == P.UNSUBSCRIBE:
        if flags != 2:
            raise FrameError("UNSUBSCRIBE flags must be 0b0010")
        pid = r.u16()
        props = _parse_props(r) if ver == 5 else {}
        filters = []
        while r.remaining():
            filters.append(r.utf8())
        if not filters:
            raise FrameError("empty UNSUBSCRIBE", P.RC.PROTOCOL_ERROR)
        return P.Unsubscribe(P.UNSUBSCRIBE, pid, filters, props)
    if ptype == P.UNSUBACK:
        pid = r.u16()
        props = _parse_props(r) if ver == 5 else {}
        return P.Unsuback(P.UNSUBACK, pid, list(r.rest()), props)
    if ptype == P.PINGREQ:
        return P.PingReq()
    if ptype == P.PINGRESP:
        return P.PingResp()
    if ptype == P.DISCONNECT:
        rc, props = 0, {}
        if ver == 5 and r.remaining():
            rc = r.u8()
            if r.remaining():
                props = _parse_props(r)
        return P.Disconnect(P.DISCONNECT, rc, props)
    if ptype == P.AUTH:
        rc, props = 0, {}
        if r.remaining():
            rc = r.u8()
            if r.remaining():
                props = _parse_props(r)
        return P.Auth(P.AUTH, rc, props)
    raise FrameError(f"unknown packet type {ptype}")


def _parse_connect(r: _Reader) -> P.Connect:
    proto_name = r.utf8()
    ver = r.u8()
    if proto_name not in ("MQTT", "MQIsdp") or ver not in (3, 4, 5):
        raise FrameError(
            "unsupported protocol", P.RC.UNSPECIFIED_ERROR
        )
    cflags = r.u8()
    if cflags & 1:
        raise FrameError("CONNECT reserved flag set")
    keepalive = r.u16()
    props = _parse_props(r) if ver == 5 else {}
    clientid = r.utf8()
    will = None
    if cflags & 0x04:
        wprops = _parse_props(r) if ver == 5 else {}
        wtopic = r.utf8()
        wpayload = r.bin()
        will = P.Will(
            wtopic, wpayload, (cflags >> 3) & 3, bool(cflags & 0x20), wprops
        )
    username = r.utf8() if cflags & 0x80 else None
    password = r.bin() if cflags & 0x40 else None
    return P.Connect(
        P.CONNECT, proto_name, ver, bool(cflags & 0x02), keepalive,
        clientid, will, username, password, props,
    )


# ---------------------------------------------------------------------------
# serialize
# ---------------------------------------------------------------------------

def serialize(pkt: Any, ver: int = 4) -> bytes:
    ptype = pkt.type
    flags = 0
    body = bytearray()
    if ptype == P.CONNECT:
        ver = pkt.proto_ver
        body += _enc_utf8(pkt.proto_name) + bytes([pkt.proto_ver])
        cflags = (
            (0x02 if pkt.clean_start else 0)
            | (0x04 if pkt.will else 0)
            | ((pkt.will.qos << 3) if pkt.will else 0)
            | (0x20 if pkt.will and pkt.will.retain else 0)
            | (0x40 if pkt.password is not None else 0)
            | (0x80 if pkt.username is not None else 0)
        )
        body.append(cflags)
        body += struct.pack(">H", pkt.keepalive)
        if ver == 5:
            body += _ser_props(pkt.properties)
        body += _enc_utf8(pkt.clientid)
        if pkt.will:
            if ver == 5:
                body += _ser_props(pkt.will.properties)
            body += _enc_utf8(pkt.will.topic) + _enc_bin(pkt.will.payload)
        if pkt.username is not None:
            body += _enc_utf8(pkt.username)
        if pkt.password is not None:
            body += _enc_bin(pkt.password)
    elif ptype == P.CONNACK:
        body.append(1 if pkt.session_present else 0)
        body.append(pkt.reason_code)
        if ver == 5:
            body += _ser_props(pkt.properties)
    elif ptype == P.PUBLISH:
        flags = (8 if pkt.dup else 0) | (pkt.qos << 1) | (1 if pkt.retain else 0)
        body += _enc_utf8(pkt.topic)
        if pkt.qos > 0:
            if pkt.packet_id is None:
                raise FrameError("QoS>0 PUBLISH needs packet id")
            body += struct.pack(">H", pkt.packet_id)
        if ver == 5:
            body += _ser_props(pkt.properties)
        body += pkt.payload
    elif ptype in (P.PUBACK, P.PUBREC, P.PUBREL, P.PUBCOMP):
        if ptype == P.PUBREL:
            flags = 2
        body += struct.pack(">H", pkt.packet_id)
        if ver == 5 and (pkt.reason_code or pkt.properties):
            body.append(pkt.reason_code)
            if pkt.properties:
                body += _ser_props(pkt.properties)
    elif ptype == P.SUBSCRIBE:
        flags = 2
        body += struct.pack(">H", pkt.packet_id)
        if ver == 5:
            body += _ser_props(pkt.properties)
        for flt, o in pkt.topic_filters:
            ob = o.get("qos", 0)
            if ver == 5:
                ob |= (o.get("nl", 0) << 2) | (o.get("rap", 0) << 3) | (
                    o.get("rh", 0) << 4
                )
            body += _enc_utf8(flt) + bytes([ob])
    elif ptype == P.SUBACK:
        body += struct.pack(">H", pkt.packet_id)
        if ver == 5:
            body += _ser_props(pkt.properties)
        body += bytes(pkt.reason_codes)
    elif ptype == P.UNSUBSCRIBE:
        flags = 2
        body += struct.pack(">H", pkt.packet_id)
        if ver == 5:
            body += _ser_props(pkt.properties)
        for flt in pkt.topic_filters:
            body += _enc_utf8(flt)
    elif ptype == P.UNSUBACK:
        body += struct.pack(">H", pkt.packet_id)
        if ver == 5:
            body += _ser_props(pkt.properties)
            body += bytes(pkt.reason_codes)
    elif ptype in (P.PINGREQ, P.PINGRESP):
        pass
    elif ptype == P.DISCONNECT:
        if ver == 5 and (pkt.reason_code or pkt.properties):
            body.append(pkt.reason_code)
            if pkt.properties:
                body += _ser_props(pkt.properties)
    elif ptype == P.AUTH:
        if pkt.reason_code or pkt.properties:
            body.append(pkt.reason_code)
            if pkt.properties:
                body += _ser_props(pkt.properties)
    else:
        raise FrameError(f"cannot serialize type {ptype}")
    return bytes([(ptype << 4) | flags]) + _enc_varint(len(body)) + bytes(body)
