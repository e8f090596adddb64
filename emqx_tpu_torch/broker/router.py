"""Cluster route table: topic filter → destination set.

The port's own copy of the reference's ``emqx_tpu/broker/router.py``, so
that nothing here imports the JAX package.

Behavioral reference: ``apps/emqx/src/emqx_router.erl``
(``match_routes/1``, ``do_add_route/2``, ``do_delete_route/2``) and
``emqx_router_helper.erl`` nodedown cleanup [U] — reference mount empty,
see SURVEY.md.

Design mirrors the reference's split:

* **exact** (wildcard-free) filters live in a hash map — O(1) lookup per
  publish, never touch the trie;
* **wildcard** filters live in a :class:`FilterTrie` plus a map
  filter → destinations.

A *destination* is opaque to the router (the reference stores node names;
we store node ids or local subscriber group ids).  ``cleanup_routes``
implements the router-helper's purge of a dead node's routes.

The router is the **source of truth** the device NFA mirror is built from:
every mutation bumps ``epoch`` and appends to a bounded delta log that the
match service (``broker/match_service.py``) consumes.
"""

from __future__ import annotations

from collections import deque
from itertools import islice
from typing import Deque, Dict, Hashable, Iterable, List, NamedTuple, Optional, Set, Tuple

from .. import topic as T
from .trie import FilterTrie

__all__ = ["Route", "RouteDelta", "Router"]


class Route(NamedTuple):
    filter: str
    dest: Hashable


class RouteDelta(NamedTuple):
    """One mutation of the route table, for mirror delta-sync."""

    epoch: int
    op: str  # 'add' | 'del'
    filter: str
    dest: Hashable


class Router:
    def __init__(self, delta_log_cap: int = 65536) -> None:
        self._exact: Dict[str, Set[Hashable]] = {}
        self._wild: Dict[str, Set[Hashable]] = {}
        self._trie = FilterTrie()
        self._dest_filters: Dict[Hashable, Set[str]] = {}  # reverse index
        self.epoch: int = 0
        self._deltas: Deque[RouteDelta] = deque(maxlen=delta_log_cap)
        # mutation listeners (device-mirror wake-ups); called synchronously
        # after every epoch bump with the new epoch
        self.listeners: List = []

    # ------------------------------------------------------------------
    # mutation (emqx_router:do_add_route / do_delete_route)
    # ------------------------------------------------------------------

    def add_route(self, flt: str, dest: Hashable) -> bool:
        """Register ``dest`` for ``flt``.  Returns True if the (filter,
        dest) pair is new."""
        table = self._wild if T.wildcard(flt) else self._exact
        dests = table.get(flt)
        if dests is None:
            dests = table[flt] = set()
            if table is self._wild:
                self._trie.insert(flt)
        if dest in dests:
            return False
        dests.add(dest)
        self._dest_filters.setdefault(dest, set()).add(flt)
        self._bump("add", flt, dest)
        return True

    def delete_route(self, flt: str, dest: Hashable) -> bool:
        table = self._wild if T.wildcard(flt) else self._exact
        dests = table.get(flt)
        if dests is None or dest not in dests:
            return False
        dests.discard(dest)
        if not dests:
            del table[flt]
            if table is self._wild:
                self._trie.delete(flt)
        df = self._dest_filters.get(dest)
        if df is not None:
            df.discard(flt)
            if not df:
                del self._dest_filters[dest]
        self._bump("del", flt, dest)
        return True

    def cleanup_routes(self, dest: Hashable) -> int:
        """Purge every route owned by ``dest`` (nodedown handling in
        emqx_router_helper).  Returns the number purged."""
        flts = list(self._dest_filters.get(dest, ()))
        for flt in flts:
            self.delete_route(flt, dest)
        return len(flts)

    def _bump(self, op: str, flt: str, dest: Hashable) -> None:
        self.epoch += 1
        self._deltas.append(RouteDelta(self.epoch, op, flt, dest))
        for fn in self.listeners:
            fn(self.epoch)

    # ------------------------------------------------------------------
    # lookup (emqx_router:match_routes — THE hot path)
    # ------------------------------------------------------------------

    def match_routes(self, name: str) -> List[Route]:
        """All (filter, dest) routes whose filter matches concrete topic
        ``name``: exact hash hit + wildcard trie walk."""
        out: List[Route] = []
        dests = self._exact.get(name)
        if dests:
            out.extend(Route(name, d) for d in dests)
        for flt in self._trie.match(name):
            for d in self._wild[flt]:
                out.append(Route(flt, d))
        return out

    def routes_with_wild(
        self, name: str, wild_filters: Iterable[str]
    ) -> List[Route]:
        """Assemble routes from the exact map plus an externally-computed
        wildcard filter list (the device matcher's answer) — the consume
        side of the TPU publish hint (SURVEY.md §3.4 hot path)."""
        out: List[Route] = []
        dests = self._exact.get(name)
        if dests:
            out.extend(Route(name, d) for d in dests)
        for flt in wild_filters:
            for d in self._wild.get(flt, ()):
                out.append(Route(flt, d))
        return out

    def match_dests(self, name: str) -> Set[Hashable]:
        out: Set[Hashable] = set()
        dests = self._exact.get(name)
        if dests:
            out |= dests
        for flt in self._trie.match(name):
            out |= self._wild[flt]
        return out

    def has_route(self, flt: str, dest: Hashable) -> bool:
        table = self._wild if T.wildcard(flt) else self._exact
        return dest in table.get(flt, ())

    # ------------------------------------------------------------------
    # introspection / mirror sync
    # ------------------------------------------------------------------

    def topics(self) -> List[str]:
        return list(self._exact) + list(self._wild)

    def wildcard_filters(self) -> List[str]:
        return list(self._wild)

    def route_count(self) -> int:
        return sum(len(v) for v in self._exact.values()) + sum(
            len(v) for v in self._wild.values()
        )

    def routes_of(self, flt: str) -> Set[Hashable]:
        table = self._wild if T.wildcard(flt) else self._exact
        return set(table.get(flt, ()))

    def deltas_since(self, epoch: int) -> Optional[List[RouteDelta]]:
        """Deltas after ``epoch``, or None if the log no longer reaches back
        that far (caller must full-resnapshot — the mria
        bootstrap-then-replay-rlog pattern, SURVEY.md §5.4).

        O(requested span), not O(log): epochs are contiguous (every
        ``_bump`` appends exactly one delta), so the tail is the last
        ``n`` entries, taken from the right end — the per-publish
        freshness proof must never walk the whole 65k-cap deque (the
        reference's ``islice(deque, ln - n, ln)`` does: islice steps
        through the first ``ln - n`` entries to reach the tail)."""
        n = self.epoch - epoch
        if n <= 0:
            return []
        ln = len(self._deltas)
        if n > ln:
            return None
        if n == ln:
            return list(self._deltas)
        tail = list(islice(reversed(self._deltas), n))
        tail.reverse()
        return tail
