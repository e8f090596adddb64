"""The port's own copy of the reference's ``emqx_tpu/services/retainer.py``, so
that nothing here imports the JAX package.

Retained-message store with host wildcard replay.

Behavioral reference: ``apps/emqx_retainer`` (``emqx_retainer.erl``,
``emqx_retainer_mnesia.erl`` — wildcard scan via topic index) [U].
Semantics kept:

* a PUBLISH with retain=1 stores the message under its topic; an empty
  retained payload deletes the entry (MQTT §3.3.1.3);
* on subscribe, retained messages matching the new filter are replayed
  with the retain flag set, honoring MQTT5 Retain-Handling (rh=0 always,
  rh=1 only if the subscription is new, rh=2 never);
* per-message expiry (``Message-Expiry-Interval`` or the configured
  default) and store-size/payload-size limits.

Lookup is the transposed match problem — one *filter* against many
stored *topic names*: a literal word-trie over stored topics walked with
the filter (``+`` fans out one level, ``#`` takes the whole subtree).
The reference's batched device replay (``replay_batch``), which the node
never calls, is not part of this copy.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .. import topic as T
from ..broker.broker import Broker
from ..broker.message import Message

__all__ = ["Retainer"]


class _TopicNode:
    __slots__ = ("children", "topic")

    def __init__(self) -> None:
        self.children: Dict[str, "_TopicNode"] = {}
        self.topic: Optional[str] = None  # set ⇒ a retained topic ends here


class Retainer:
    def __init__(
        self,
        msg_expiry_interval: float = 0.0,   # 0 = no default expiry
        max_payload_size: int = 1 << 20,
        max_retained_messages: int = 0,     # 0 = unlimited
        enable: bool = True,
    ) -> None:
        self.enable = enable
        self.msg_expiry_interval = msg_expiry_interval
        self.max_payload_size = max_payload_size
        self.max_retained_messages = max_retained_messages
        self._store: Dict[str, Message] = {}
        self._root = _TopicNode()
        self.stats = {"dropped_oversize": 0, "dropped_table_full": 0}
        # change observer (cluster durable replication): called with
        # (topic, message) after a store, (topic, None) after a delete
        self.on_change = None

    # ------------------------------------------------------------------
    # store mutation
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._store)

    def topics(self) -> List[str]:
        return list(self._store)

    def get(self, topic: str) -> Optional[Message]:
        """The stored retained message for an exact topic, if any."""
        return self._store.get(topic)

    def insert(self, msg: Message) -> bool:
        """Store (or delete, for empty payloads) a retained message."""
        if not self.enable:
            return False
        if not msg.payload:
            self.delete(msg.topic)
            return True
        if len(msg.payload) > self.max_payload_size:
            self.stats["dropped_oversize"] += 1
            return False
        if (
            self.max_retained_messages > 0
            and msg.topic not in self._store
            and len(self._store) >= self.max_retained_messages
        ):
            self.stats["dropped_table_full"] += 1
            return False
        if self.msg_expiry_interval > 0 and msg.expiry_interval() is None:
            msg = msg.clone(
                properties={
                    **msg.properties,
                    "Message-Expiry-Interval": self.msg_expiry_interval,
                }
            )
        self._store[msg.topic] = msg.clone(retain=True)
        node = self._root
        for w in T.words(msg.topic):
            node = node.children.setdefault(w, _TopicNode())
        node.topic = msg.topic
        if self.on_change is not None:
            self.on_change(msg.topic, self._store[msg.topic])
        return True

    def delete(self, topic: str) -> bool:
        if self._store.pop(topic, None) is None:
            return False
        # prune the index path
        path: List[Tuple[_TopicNode, str]] = []
        node = self._root
        for w in T.words(topic):
            path.append((node, w))
            node = node.children[w]
        node.topic = None
        for parent, w in reversed(path):
            child = parent.children[w]
            if child.topic is None and not child.children:
                del parent.children[w]
            else:
                break
        if self.on_change is not None:
            self.on_change(topic, None)
        return True

    def clean_expired(self, now: Optional[float] = None) -> int:
        now = now if now is not None else time.time()
        stale = [t for t, m in self._store.items() if m.is_expired(now)]
        for t in stale:
            self.delete(t)
        return len(stale)

    # ------------------------------------------------------------------
    # lookup — host walk (single filter)
    # ------------------------------------------------------------------

    def match(self, flt: str, now: Optional[float] = None) -> List[Message]:
        """All live retained messages whose topic matches ``flt``."""
        now = now if now is not None else time.time()
        ws = T.words(flt)
        hits: List[str] = []
        self._walk(self._root, ws, 0, hits, at_root=True)
        return [
            self._store[t] for t in sorted(hits)
            if not self._store[t].is_expired(now)
        ]

    def _walk(
        self, node: _TopicNode, ws: Sequence[str], i: int,
        hits: List[str], at_root: bool,
    ) -> None:
        if i == len(ws):
            if node.topic is not None:
                hits.append(node.topic)
            return
        w = ws[i]
        if w == "#":
            # '#' matches the parent level too, but never $-topics at root
            self._collect(node, hits, skip_dollar=at_root)
            return
        if w == "+":
            for cw, child in node.children.items():
                if at_root and cw.startswith("$"):
                    continue  # MQTT §4.7.2
                self._walk(child, ws, i + 1, hits, False)
            return
        child = node.children.get(w)
        if child is not None:
            self._walk(child, ws, i + 1, hits, False)

    def _collect(self, node: _TopicNode, hits: List[str], skip_dollar: bool) -> None:
        if node.topic is not None:
            hits.append(node.topic)
        for cw, child in node.children.items():
            if skip_dollar and cw.startswith("$"):
                continue
            self._collect(child, hits, False)

    # ------------------------------------------------------------------
    # broker wiring
    # ------------------------------------------------------------------

    def attach(self, broker: Broker) -> "Retainer":
        """Register the publish-store and subscribe-replay hooks."""

        def on_publish(acc: Message):
            # run_fold passes only the accumulator (args=() in publish)
            if (
                acc is not None and acc.retain
                and acc.headers.get("allow_publish") is not False
                and not acc.topic.startswith("$")
            ):
                self.insert(acc)
            return acc

        def on_subscribed(clientid: str, raw_filter: str, opts, is_new: bool):
            if not self.enable or opts.rh == 2 or (opts.rh == 1 and not is_new):
                return
            share = T.parse_share(raw_filter)
            if share is not None:
                return  # $share subs get no retained replay (MQTT5 §4.8.2)
            msgs = self.match(raw_filter)
            if msgs:
                broker.deliver_direct(clientid, opts, msgs)

        broker.hooks.add("message.publish", on_publish, priority=-100,
                         name="retainer.store")
        broker.hooks.add("session.subscribed", on_subscribed,
                         name="retainer.replay")
        return self
