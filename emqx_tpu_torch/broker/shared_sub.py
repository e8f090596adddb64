"""Shared-subscription ($share/<group>/...) dispatch strategies.

The port's own copy of the reference's ``emqx_tpu/broker/shared_sub.py``, so
that nothing here imports the JAX package.

Behavioral reference: ``apps/emqx/src/emqx_shared_sub.erl`` [U]
(SURVEY.md §2.1): per-(group, filter) member registry with pluggable
pick strategies — ``random``, ``round_robin``, ``sticky``,
``hash_clientid``, ``hash_topic``, ``local`` — plus ack-aware redispatch:
when a picked member nacks (session gone / inflight full with
drop-policy), the message is redispatched to another member.
"""

from __future__ import annotations

import hashlib
import random
from typing import Dict, List, Optional, Sequence, Set, Tuple

__all__ = ["SharedSub", "STRATEGIES"]

STRATEGIES = (
    "random", "round_robin", "sticky", "hash_clientid", "hash_topic", "local",
)


def _hash(s: str) -> int:
    return int.from_bytes(hashlib.blake2s(s.encode(), digest_size=8).digest(), "big")


class SharedSub:
    def __init__(self, strategy: str = "random", seed: Optional[int] = None) -> None:
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}")
        self.strategy = strategy
        self._rng = random.Random(seed)
        # (group, filter) -> ordered member list of (clientid, node)
        self._members: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
        self._rr: Dict[Tuple[str, str], int] = {}
        self._sticky: Dict[Tuple[str, str], Tuple[str, str]] = {}

    # ------------------------------------------------------------------

    def subscribe(self, group: str, flt: str, clientid: str, node: str = "local") -> bool:
        key = (group, flt)
        members = self._members.setdefault(key, [])
        ent = (clientid, node)
        if ent in members:
            return False
        members.append(ent)
        return True

    def unsubscribe(self, group: str, flt: str, clientid: str, node: str = "local") -> bool:
        key = (group, flt)
        members = self._members.get(key)
        if not members:
            return False
        try:
            members.remove((clientid, node))
        except ValueError:
            return False
        if not members:
            del self._members[key]
            self._rr.pop(key, None)
            self._sticky.pop(key, None)
        elif self._sticky.get(key) == (clientid, node):
            del self._sticky[key]
        return True

    def members(self, group: str, flt: str) -> List[Tuple[str, str]]:
        return list(self._members.get((group, flt), ()))

    def groups(self) -> List[Tuple[str, str]]:
        return list(self._members)

    # ------------------------------------------------------------------

    def pick(
        self,
        group: str,
        flt: str,
        topic: str,
        sender: Optional[str] = None,
        local_node: str = "local",
        exclude: Sequence[Tuple[str, str]] = (),
        extra: Sequence[Tuple[str, str]] = (),
    ) -> Optional[Tuple[str, str]]:
        """Choose the member to receive a message on ``topic``.

        ``exclude`` supports ack-aware redispatch: members that already
        nacked this delivery.  ``extra`` adds candidates not in the local
        member table — the cluster layer passes remote nodes holding
        members of this group as ``("", node)`` markers, so strategies
        balance across the whole cluster (two-level pick: the remote
        node's own shared table chooses the concrete client there)."""
        key = (group, flt)
        members: Sequence[Tuple[str, str]] = self._members.get(key, ())
        if exclude or extra:
            # redispatch / cluster candidates: build the filtered view
            members = [m for m in members if m not in exclude]
            members += [m for m in extra
                        if m not in exclude and m not in members]
        # else: serve straight off the live list — one publish picks one
        # member, so the fanout hot path never allocates here
        if not members:
            return None
        s = self.strategy
        if s == "local":
            locals_ = [m for m in members if m[1] == local_node]
            pool = locals_ or members
            return pool[self._rng.randrange(len(pool))]
        if s == "random":
            return members[self._rng.randrange(len(members))]
        if s == "round_robin":
            i = self._rr.get(key, -1)
            i = (i + 1) % len(members)
            self._rr[key] = i
            return members[i]
        if s == "sticky":
            cur = self._sticky.get(key)
            if cur is not None and cur in members:
                return cur
            choice = members[self._rng.randrange(len(members))]
            self._sticky[key] = choice
            return choice
        if s == "hash_clientid":
            h = _hash(sender or "")
            return members[h % len(members)]
        if s == "hash_topic":
            return members[_hash(topic) % len(members)]
        raise AssertionError(s)

    def pick_batch(
        self,
        group: str,
        flt: str,
        keys: Sequence[Tuple[str, Optional[str]]],
        local_node: str = "local",
    ) -> List[Optional[Tuple[str, str]]]:
        """Choose a member per ``(topic, sender)`` key in one call.

        The fanout pipeline hands the whole batch slice of a
        ``(group, filter)`` here instead of one :meth:`pick` per message:
        the strategy state (round-robin cursor, sticky choice, RNG
        stream) advances exactly as the same sequence of per-message
        picks would, so batched and unbatched dispatch assign the same
        members in the same order."""
        key = (group, flt)
        members = self._members.get(key, ())
        n = len(members)
        if not n:
            return [None] * len(keys)
        s = self.strategy
        if s == "round_robin":
            i = self._rr.get(key, -1)
            out: List[Optional[Tuple[str, str]]] = []
            for _ in keys:
                i = (i + 1) % n
                out.append(members[i])
            self._rr[key] = i
            return out
        if s == "sticky":
            cur = self._sticky.get(key)
            if cur is None or cur not in members:
                cur = members[self._rng.randrange(n)]
                self._sticky[key] = cur
            return [cur] * len(keys)
        if s == "random":
            rng = self._rng
            return [members[rng.randrange(n)] for _ in keys]
        if s == "local":
            locals_ = [m for m in members if m[1] == local_node]
            pool = locals_ or members
            rng = self._rng
            return [pool[rng.randrange(len(pool))] for _ in keys]
        if s == "hash_clientid":
            return [members[_hash(sender or "") % n] for _, sender in keys]
        if s == "hash_topic":
            return [members[_hash(topic) % n] for topic, _ in keys]
        raise AssertionError(s)

    def dispatch_with_ack(
        self,
        group: str,
        flt: str,
        topic: str,
        try_deliver,
        sender: Optional[str] = None,
        local_node: str = "local",
        extra: Sequence[Tuple[str, str]] = (),
        exclude: Sequence[Tuple[str, str]] = (),
    ) -> Optional[Tuple[str, str]]:
        """Pick members until ``try_deliver(member) -> bool`` accepts.

        Mirrors the reference's redispatch-on-nack loop; returns the
        member that accepted, or None if every member nacked.
        ``exclude`` seeds the tried list — the batched dispatch passes
        the member that already nacked this delivery."""
        tried: List[Tuple[str, str]] = list(exclude)
        while True:
            m = self.pick(group, flt, topic, sender, local_node,
                          exclude=tried, extra=extra)
            if m is None:
                return None
            if try_deliver(m):
                if self.strategy == "sticky":
                    self._sticky[(group, flt)] = m
                return m
            tried.append(m)
