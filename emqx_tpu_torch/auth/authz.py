"""Ordered ACL sources — the ``emqx_authz`` analog.

The port's own copy of the reference's ``emqx_tpu/auth/authz.py``
(nothing here imports the JAX package).

Behavioral reference: ``apps/emqx_authz`` [U] (SURVEY.md §2.3): an
ordered source list; each source answers **allow**, **deny**, or
**nomatch** for (client, action, topic); the first non-nomatch wins, and
an all-nomatch falls back to the ``no_match`` policy.  Topic patterns in
rules are MQTT filters with ``%c``/``%u`` placeholders and the ``eq ``
prefix for literal (non-wildcard) matching — both kept.

The device batch path: the *static* patterns of all sources compile
into one flattened-NFA table of the routing layout
(:func:`compile_acl_batch`), and :func:`batch_authorize` authorizes a
batch of topics with one walk of the port's hash kernel on the card
(``ops.match_topics``).  Patterns with placeholders are client-specific
and stay on the host path.
"""

from __future__ import annotations

import fnmatch
import ipaddress
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import topic as T

__all__ = [
    "AclRule", "FileSource", "BuiltinDbSource", "Authz", "compile_acl_batch",
    "batch_authorize", "acl_filter_matches",
]

ALLOW, DENY, NOMATCH = "allow", "deny", "nomatch"


def _unsafe_placeholder(value: Optional[str]) -> bool:
    return not value or any(c in value for c in "+#/")


def acl_filter_matches(flt: Any, topic: str, clientid: str,
                       username: Optional[str]) -> bool:
    """One ACL rule filter against a topic — the single implementation
    of the rule algebra shared by the file/built-in sources AND the
    network backends (Redis/Postgres/Mongo via auth/_backend.py):
    ``eq `` prefix for literal match, ``%c``/``%u`` substitution with
    the wildcard-injection guard (a clientid/username of ``+``/``#`` or
    containing ``/`` must never widen the pattern).  Non-string filters
    never match."""
    if not isinstance(flt, str):
        return False
    literal = flt.startswith("eq ")
    if literal:
        flt = flt[3:]
    if "%c" in flt or "%u" in flt:
        if ("%c" in flt and _unsafe_placeholder(clientid)) or (
                "%u" in flt and _unsafe_placeholder(username)):
            return False
        flt = flt.replace("%c", clientid).replace("%u", username or "")
    if literal:
        return topic == flt
    try:
        return T.match(topic, flt)
    except ValueError:
        return False


@dataclass
class AclRule:
    """One ACL rule (the acl.conf tuple analog)."""

    permission: str                   # allow | deny
    action: str = "all"               # publish | subscribe | all
    topics: Sequence[str] = ()        # filters; 'eq t' = literal match
    who: str = "all"                  # all | user:<u> | client:<c> | ip:<cidr>
    retain: Optional[bool] = None     # None = any (v5 retain-specific rules)
    qos: Optional[Sequence[int]] = None

    def __post_init__(self) -> None:
        if self.permission not in (ALLOW, DENY):
            raise ValueError(self.permission)
        if self.action not in ("publish", "subscribe", "all"):
            raise ValueError(self.action)

    def who_matches(
        self, clientid: str, username: Optional[str], peerhost: Optional[str]
    ) -> bool:
        if self.who == "all":
            return True
        kind, _, val = self.who.partition(":")
        if kind == "user":
            return username is not None and fnmatch.fnmatchcase(username, val)
        if kind == "client":
            return fnmatch.fnmatchcase(clientid, val)
        if kind == "ip":
            if peerhost is None:
                return False
            try:
                return ipaddress.ip_address(peerhost) in ipaddress.ip_network(val)
            except ValueError:
                return False
        return False

    def topic_matches(
        self, topic: str, clientid: str, username: Optional[str]
    ) -> bool:
        return any(
            acl_filter_matches(pat, topic, clientid, username)
            for pat in self.topics
        )

    def check(
        self, clientid: str, username: Optional[str], peerhost: Optional[str],
        action: str, topic: str,
        retain: Optional[bool] = None, qos: Optional[int] = None,
    ) -> str:
        if self.action != "all" and self.action != action:
            return NOMATCH
        if not self.who_matches(clientid, username, peerhost):
            return NOMATCH
        if self.retain is not None and retain is not None and self.retain != retain:
            return NOMATCH
        if self.qos is not None and qos is not None and qos not in self.qos:
            return NOMATCH
        if not self.topic_matches(topic, clientid, username):
            return NOMATCH
        return self.permission


class FileSource:
    """Ordered rule list — the acl.conf file source analog."""

    def __init__(self, rules: Optional[List[AclRule]] = None) -> None:
        self.rules = list(rules or [])

    def authorize(
        self, clientid, username, peerhost, action, topic, **kw
    ) -> str:
        for r in self.rules:
            res = r.check(clientid, username, peerhost, action, topic, **kw)
            if res != NOMATCH:
                return res
        return NOMATCH


class BuiltinDbSource:
    """Per-client / per-user rule store — the authz built-in-db analog."""

    def __init__(self) -> None:
        self._by_client: Dict[str, List[AclRule]] = {}
        self._by_user: Dict[str, List[AclRule]] = {}
        self._all: List[AclRule] = []

    def set_rules(
        self, rules: List[AclRule],
        clientid: Optional[str] = None, username: Optional[str] = None,
    ) -> None:
        if clientid is not None:
            self._by_client[clientid] = rules
        elif username is not None:
            self._by_user[username] = rules
        else:
            self._all = rules

    def authorize(self, clientid, username, peerhost, action, topic, **kw) -> str:
        for rules in (
            self._by_client.get(clientid, ()),
            self._by_user.get(username, ()) if username else (),
            self._all,
        ):
            for r in rules:
                res = r.check(clientid, username, peerhost, action, topic, **kw)
                if res != NOMATCH:
                    return res
        return NOMATCH


class Authz:
    """The source pipeline + LRU/TTL result cache (emqx_authz_cache)."""

    def __init__(
        self,
        sources: Optional[List[Any]] = None,
        no_match: str = ALLOW,
        cache_enable: bool = True,
        cache_max_size: int = 32,
        cache_ttl: float = 60.0,
    ) -> None:
        self.sources = list(sources or [])
        self.no_match = no_match
        self.cache_enable = cache_enable
        self.cache_max_size = cache_max_size
        self.cache_ttl = cache_ttl
        self._cache: "OrderedDict[Tuple, Tuple[str, float]]" = OrderedDict()
        self.metrics = {"allow": 0, "deny": 0, "nomatch": 0,
                        "cache_hit": 0, "cache_miss": 0, "superuser": 0}

    def authorize(
        self,
        clientid: str,
        action: str,
        topic: str,
        username: Optional[str] = None,
        peerhost: Optional[str] = None,
        is_superuser: bool = False,
        now: Optional[float] = None,
        **kw,
    ) -> bool:
        if is_superuser:
            self.metrics["superuser"] += 1
            return True
        now = now if now is not None else time.time()
        # key carries every input a source may condition on — a cached
        # verdict must never bypass ip-/retain-/qos-based rules
        key = (clientid, username, peerhost, action, topic,
               kw.get("retain"), kw.get("qos"))
        if self.cache_enable:
            hit = self._cache.get(key)
            if hit is not None and now - hit[1] < self.cache_ttl:
                self.metrics["cache_hit"] += 1
                self._cache.move_to_end(key)
                return hit[0] == ALLOW
            self.metrics["cache_miss"] += 1
        verdict = NOMATCH
        for src in self.sources:
            verdict = src.authorize(clientid, username, peerhost, action, topic, **kw)
            if verdict != NOMATCH:
                break
        if verdict == NOMATCH:
            self.metrics["nomatch"] += 1
            verdict = self.no_match
        self.metrics[verdict] += 1
        if self.cache_enable:
            self._cache[key] = (verdict, now)
            while len(self._cache) > self.cache_max_size:
                self._cache.popitem(last=False)
        return verdict == ALLOW

    def clear_cache(self) -> None:
        self._cache.clear()


# ---------------------------------------------------------------------------
# device batch path

def compile_acl_batch(sources: Sequence[Any], depth: int = 16):
    """Compile the sources' ACL patterns into one NFA table for batched
    on-device authorization.

    Returns ``(table, rule_index)`` where ``rule_index[filter]`` is the
    ordered list of ``(order, permission, action)`` entries for that
    pattern.  Batch check: match topics through the table (same kernel
    as routing), then fold each topic's matched filters by ``order`` —
    first hit wins, exactly like the host pipeline.

    Soundness: with first-match-wins ordering, *skipping* any rule the
    table can't express (client/user/ip-specific ``who``, retain/qos
    constraints, ``%c``/``%u`` placeholders, literal-match wildcard
    patterns) would silently change verdicts.  So compilation is
    all-or-nothing: any non-static rule ⇒ ``(None, {})`` and the caller
    stays on the host path.
    """
    from ..ops import compile_filters

    rule_index: Dict[str, List[Tuple[int, str, str]]] = {}
    order = 0
    for src in sources:
        if isinstance(src, FileSource):
            rules = list(src.rules)
        elif isinstance(src, BuiltinDbSource):
            if src._by_client or src._by_user:
                return None, {}
            rules = list(src._all)
        else:
            return None, {}   # unknown source type: host only
        for r in rules:
            if r.who != "all" or r.retain is not None or r.qos is not None:
                return None, {}
            for pat in r.topics:
                p = pat[3:] if pat.startswith("eq ") else pat
                if "%c" in p or "%u" in p:
                    return None, {}
                if pat.startswith("eq ") and T.wildcard(p):
                    return None, {}
                rule_index.setdefault(p, []).append(
                    (order, r.permission, r.action)
                )
                order += 1
    if not rule_index:
        return None, {}
    table = compile_filters(rule_index.keys(), depth=depth)
    return table, rule_index


def batch_authorize(
    table, rule_index: Dict[str, List[Tuple[int, str, str]]],
    topics: Sequence[str], action: str, no_match: str = ALLOW, *,
    device: Any = None,
) -> List[bool]:
    """Authorize a batch of topics on device in ONE kernel call: the
    port's hash walk on ``device`` (the card unless the caller names
    another; ``"cpu"`` runs the plain walk)."""
    from ..ops import match_topics

    out: List[bool] = []
    for matched in match_topics(table, topics, device=device):
        hits: List[Tuple[int, str]] = []
        for flt in matched:
            for order, perm, act in rule_index.get(flt, ()):
                if act == "all" or act == action:
                    hits.append((order, perm))
        if hits:
            out.append(min(hits)[1] == ALLOW)
        else:
            out.append(no_match == ALLOW)
    return out
