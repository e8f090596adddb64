"""Broker message record.

The port's own copy of the reference's ``emqx_tpu/broker/message.py``, so
that nothing here imports the JAX package.

Behavioral reference: ``apps/emqx/src/emqx_message.erl`` [U] (SURVEY.md
§2.1) — id/qos/from/flags/headers/topic/payload/timestamp record plus the
expiry helpers used by retainer/delayed/session.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

__all__ = ["Message", "make_message"]

_seq = itertools.count()


def _guid() -> int:
    """Monotone-ish 64-bit message id: ms timestamp << 20 | seq."""
    return (time.time_ns() // 1_000_000) << 20 | (next(_seq) & 0xFFFFF)


@dataclass
class Message:
    id: int
    qos: int
    sender: Optional[str]       # clientid ('from' in the reference)
    topic: str
    payload: bytes
    retain: bool = False
    dup: bool = False
    headers: Dict[str, Any] = field(default_factory=dict)
    properties: Dict[str, Any] = field(default_factory=dict)  # MQTT5 props
    timestamp: float = field(default_factory=time.time)

    def expiry_interval(self) -> Optional[float]:
        v = self.properties.get("Message-Expiry-Interval")
        return float(v) if v is not None else None

    def is_expired(self, now: Optional[float] = None) -> bool:
        exp = self.expiry_interval()
        if exp is None:
            return False
        return (now if now is not None else time.time()) > self.timestamp + exp

    def with_qos(self, qos: int) -> "Message":
        # hot path: QoS already effective for most deliveries — no copy
        return self if qos == self.qos else self.clone(qos=qos)

    def clone(self, **kw) -> "Message":
        # dataclasses.replace() re-runs __init__ + field introspection —
        # measured as the dominant cost of wide fan-outs.  A __dict__
        # copy is ~4x cheaper; derived copies must not inherit per-object
        # caches keyed on the ORIGINAL's fields: the serialized-wire
        # cache (transport layer) and the shared QoS0 Publish
        # (Session.deliver) both go stale on any field change.
        m = Message.__new__(Message)
        d = dict(self.__dict__)
        d.pop("_wire", None)
        d.pop("_wire1", None)  # QoS1/2 wire template (transport layer)
        d.pop("_pub0", None)
        d.update(kw)
        m.__dict__ = d
        return m


def make_message(
    sender: Optional[str],
    topic: str,
    payload: bytes,
    qos: int = 0,
    retain: bool = False,
    properties: Optional[Dict[str, Any]] = None,
) -> Message:
    return Message(
        id=_guid(),
        qos=qos,
        sender=sender,
        topic=topic,
        payload=payload,
        retain=retain,
        properties=properties or {},
    )
