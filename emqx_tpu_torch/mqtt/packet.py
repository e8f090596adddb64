"""The port's own copy of the reference's ``emqx_tpu/mqtt/packet.py``, so
that nothing here imports the JAX package.

MQTT control packet records (v3.1.1 + v5.0).

Behavioral reference: ``apps/emqx/src/emqx_packet.erl`` and the packet
records of ``emqx.hrl`` [U] (SURVEY.md §2.1).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "CONNECT", "CONNACK", "PUBLISH", "PUBACK", "PUBREC", "PUBREL",
    "PUBCOMP", "SUBSCRIBE", "SUBACK", "UNSUBSCRIBE", "UNSUBACK",
    "PINGREQ", "PINGRESP", "DISCONNECT", "AUTH",
    "TYPE_NAMES", "Connect", "Connack", "Publish", "PubAck", "Subscribe",
    "Suback", "Unsubscribe", "Unsuback", "PingReq", "PingResp",
    "Disconnect", "Auth", "Will", "AckRun", "PublishRun",
    "RC",
]

CONNECT, CONNACK, PUBLISH, PUBACK, PUBREC, PUBREL, PUBCOMP = range(1, 8)
SUBSCRIBE, SUBACK, UNSUBSCRIBE, UNSUBACK, PINGREQ, PINGRESP = range(8, 14)
DISCONNECT, AUTH = 14, 15

TYPE_NAMES = {
    CONNECT: "CONNECT", CONNACK: "CONNACK", PUBLISH: "PUBLISH",
    PUBACK: "PUBACK", PUBREC: "PUBREC", PUBREL: "PUBREL",
    PUBCOMP: "PUBCOMP", SUBSCRIBE: "SUBSCRIBE", SUBACK: "SUBACK",
    UNSUBSCRIBE: "UNSUBSCRIBE", UNSUBACK: "UNSUBACK", PINGREQ: "PINGREQ",
    PINGRESP: "PINGRESP", DISCONNECT: "DISCONNECT", AUTH: "AUTH",
}


class RC:
    """MQTT v5 reason codes used by the broker (spec §2.4)."""

    SUCCESS = 0x00
    GRANTED_QOS_1 = 0x01
    GRANTED_QOS_2 = 0x02
    NO_MATCHING_SUBSCRIBERS = 0x10
    UNSPECIFIED_ERROR = 0x80
    MALFORMED_PACKET = 0x81
    PROTOCOL_ERROR = 0x82
    NOT_AUTHORIZED = 0x87
    CONTINUE_AUTHENTICATION = 0x18
    REAUTHENTICATE = 0x19
    BAD_AUTH_METHOD = 0x8C
    BAD_USER_NAME_OR_PASSWORD = 0x86
    SERVER_UNAVAILABLE = 0x88
    SERVER_BUSY = 0x89
    BANNED = 0x8A
    SESSION_TAKEN_OVER = 0x8E
    TOPIC_FILTER_INVALID = 0x8F
    TOPIC_NAME_INVALID = 0x90
    PACKET_ID_IN_USE = 0x91
    PACKET_ID_NOT_FOUND = 0x92
    RECEIVE_MAX_EXCEEDED = 0x93
    TOPIC_ALIAS_INVALID = 0x94
    PACKET_TOO_LARGE = 0x95
    QUOTA_EXCEEDED = 0x97
    PAYLOAD_FORMAT_INVALID = 0x99
    RETAIN_NOT_SUPPORTED = 0x9A
    QOS_NOT_SUPPORTED = 0x9B
    SHARED_SUB_NOT_SUPPORTED = 0x9E
    KEEPALIVE_TIMEOUT = 0x8D
    SUB_ID_NOT_SUPPORTED = 0xA1
    WILDCARD_SUB_NOT_SUPPORTED = 0xA2


@dataclass
class Will:
    topic: str
    payload: bytes
    qos: int = 0
    retain: bool = False
    properties: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Connect:
    type: int = CONNECT
    proto_name: str = "MQTT"
    proto_ver: int = 4           # 3=3.1, 4=3.1.1, 5=5.0
    clean_start: bool = True
    keepalive: int = 60
    clientid: str = ""
    will: Optional[Will] = None
    username: Optional[str] = None
    password: Optional[bytes] = None
    properties: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Connack:
    type: int = CONNACK
    session_present: bool = False
    reason_code: int = 0
    properties: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Publish:
    type: int = PUBLISH
    dup: bool = False
    qos: int = 0
    retain: bool = False
    topic: str = ""
    packet_id: Optional[int] = None
    payload: bytes = b""
    properties: Dict[str, Any] = field(default_factory=dict)


@dataclass
class PubAck:
    """PUBACK / PUBREC / PUBREL / PUBCOMP share this layout."""

    type: int = PUBACK
    packet_id: int = 0
    reason_code: int = 0
    properties: Dict[str, Any] = field(default_factory=dict)


class AckRun:
    """A contiguous run of same-type pid-only acks (PUBACK / PUBREC /
    PUBREL / PUBCOMP, reason code 0, no properties), packed as one
    object by the parser's ack-run fast path.

    Not a wire packet itself: each pid stands for one 4-byte ack frame.
    Consumers that cannot take the run wholesale call :meth:`expand` to
    recover the per-packet :class:`PubAck` list the slow path would
    have produced."""

    __slots__ = ("type", "pids")

    def __init__(self, type: int, pids: List[int]) -> None:
        self.type = type
        self.pids = pids

    def expand(self) -> "List[PubAck]":
        t = self.type
        return [PubAck(t, pid) for pid in self.pids]

    def __len__(self) -> int:
        return len(self.pids)

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, AckRun) and other.type == self.type
                and other.pids == self.pids)

    def __repr__(self) -> str:  # pragma: no cover
        return f"AckRun({TYPE_NAMES.get(self.type)}, {self.pids})"


class PublishRun:
    """A contiguous run of same-QoS (1 or 2) inbound PUBLISHes from one
    client, packed by the parser's publish-run fast path (the ingest
    analog of :class:`AckRun`).  Each element is a fully parsed
    :class:`Publish`; packing only marks the contiguity so the channel
    can amortize the authz fold / alias resolution per run and answer
    with one PUBACK/PUBREC burst.

    Consumers that cannot take the run wholesale call :meth:`expand`
    to recover the per-packet list the slow path would have produced."""

    __slots__ = ("qos", "pkts")
    type = PUBLISH

    def __init__(self, qos: int, pkts: "List[Publish]") -> None:
        self.qos = qos
        self.pkts = pkts

    def expand(self) -> "List[Publish]":
        return self.pkts

    def __len__(self) -> int:
        return len(self.pkts)

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, PublishRun) and other.qos == self.qos
                and other.pkts == self.pkts)

    def __repr__(self) -> str:  # pragma: no cover
        return f"PublishRun(qos={self.qos}, n={len(self.pkts)})"


@dataclass
class Subscribe:
    type: int = SUBSCRIBE
    packet_id: int = 0
    # [(filter, {qos, nl, rap, rh})]
    topic_filters: List[Tuple[str, Dict[str, int]]] = field(default_factory=list)
    properties: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Suback:
    type: int = SUBACK
    packet_id: int = 0
    reason_codes: List[int] = field(default_factory=list)
    properties: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Unsubscribe:
    type: int = UNSUBSCRIBE
    packet_id: int = 0
    topic_filters: List[str] = field(default_factory=list)
    properties: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Unsuback:
    type: int = UNSUBACK
    packet_id: int = 0
    reason_codes: List[int] = field(default_factory=list)
    properties: Dict[str, Any] = field(default_factory=dict)


@dataclass
class PingReq:
    type: int = PINGREQ


@dataclass
class PingResp:
    type: int = PINGRESP


@dataclass
class Disconnect:
    type: int = DISCONNECT
    reason_code: int = 0
    properties: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Auth:
    type: int = AUTH
    reason_code: int = 0
    properties: Dict[str, Any] = field(default_factory=dict)
