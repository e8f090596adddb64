"""Host-side wildcard filter trie, the port's own copy of the reference's
``FilterTrie`` (``emqx_tpu/broker/trie.py``).

It answers "which filters match this concrete topic?" by a depth-first
walk.  The router indexes its wildcard filters in one (the host trie
that publish walks when no device hint serves), the match service keeps
the filters that are deeper than the device table in another, and the
tests and ``chip_smoke.py`` use it as the oracle.
Refcounted: inserting a key twice needs two deletes before it goes.

:class:`FilterSet` is the oracle for tables too large for a trie of
Python objects (10M filters): a set of filter strings, matched by
enumerating the filters that could match a topic.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

from .. import topic as T

__all__ = ["FilterSet", "FilterTrie"]


class _Node:
    __slots__ = ("children", "end_count")

    def __init__(self) -> None:
        self.children: Dict[str, "_Node"] = {}
        self.end_count: int = 0  # live inserts terminating here


class FilterTrie:
    """Wildcard filters indexed; match a concrete topic against them."""

    def __init__(self) -> None:
        self._root = _Node()
        self._keys: Dict[str, int] = {}  # key -> refcount

    def insert(self, key: str) -> bool:
        """Insert one reference to ``key``; True if it is new."""
        node = self._root
        for w in T.words(key):
            nxt = node.children.get(w)
            if nxt is None:
                nxt = node.children[w] = _Node()
            node = nxt
        node.end_count += 1
        new = key not in self._keys
        self._keys[key] = self._keys.get(key, 0) + 1
        return new

    def delete(self, key: str) -> bool:
        """Drop one reference to ``key``; True if it is now gone.
        Unknown keys are a no-op."""
        if key not in self._keys:
            return False
        ws = T.words(key)
        path: List[_Node] = [self._root]
        node = self._root
        for w in ws:
            node = node.children[w]
            path.append(node)
        node.end_count -= 1
        self._keys[key] -= 1
        gone = self._keys[key] == 0
        if gone:
            del self._keys[key]
        for i in range(len(ws) - 1, -1, -1):
            child = path[i + 1]
            if child.end_count == 0 and not child.children:
                del path[i].children[ws[i]]
            else:
                break
        return gone

    def __contains__(self, key: str) -> bool:
        return key in self._keys

    def __len__(self) -> int:
        return len(self._keys)

    def node_count(self) -> int:
        """Number of trie nodes (excluding the root)."""
        n = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            n += len(node.children)
            stack.extend(node.children.values())
        return n

    def match(self, name) -> List[str]:
        """All inserted filters matching concrete topic ``name``, with the
        semantics of :func:`emqx_tpu_torch.topic.match`."""
        nw = T.words(name) if isinstance(name, str) else list(name)
        if not nw:
            return []
        out: List[str] = []
        sys_topic = nw[0].startswith("$")
        # iterative DFS: valid filters can be very deep
        stack: List[Tuple[_Node, int, Tuple[str, ...]]] = [(self._root, 0, ())]
        while stack:
            node, i, acc = stack.pop()
            hashc = node.children.get("#")
            if hashc is not None and not (i == 0 and sys_topic):
                if hashc.end_count > 0:
                    out.append(T.join(acc + ("#",)))
            if i == len(nw):
                if node.end_count > 0:
                    out.append(T.join(acc))
                continue
            w = nw[i]
            lit = node.children.get(w)
            if lit is not None:
                stack.append((lit, i + 1, acc + (w,)))
            # '+' is a distinct edge from a literal '+' level; root '+' is
            # disabled for $-topics
            if w != "+":
                plus = node.children.get("+")
                if plus is not None and not (i == 0 and sys_topic):
                    stack.append((plus, i + 1, acc + ("+",)))
        return out

    def match_many(self, names: Sequence[str]) -> Dict[str, List[str]]:
        """:meth:`match` of each distinct topic of ``names``: the match
        service's host fallback answers a whole batch here, and publish
        batches repeat topics (one walk per distinct topic, not per
        waiter)."""
        out: Dict[str, List[str]] = {}
        for name in names:
            if name not in out:
                out[name] = self.match(name)
        return out


class FilterSet:
    """A set of wildcard filter strings, matched without an index: a
    topic of n levels is matched only by filters made of its first k
    levels (k = 0..n), each kept or made ``+``, followed by ``/#`` (or
    ``#`` alone for k = 0), or with k = n ending there.  Each of those
    about 3·2ⁿ candidates is one set lookup; root wildcards skip
    ``$``-topics.  Memory is the set's, a fraction of a trie's."""

    def __init__(self, filters: Iterable[str] = ()) -> None:
        self._filters = set(filters)

    def __len__(self) -> int:
        return len(self._filters)

    def __contains__(self, flt: str) -> bool:
        return flt in self._filters

    def insert(self, flt: str) -> None:
        self._filters.add(flt)

    def delete(self, flt: str) -> None:
        self._filters.discard(flt)

    def match(self, topic: str) -> List[str]:
        """The filters of the set that match concrete topic ``topic``."""
        have = self._filters
        sys_ = topic.startswith("$")
        out = [] if sys_ or "#" not in have else ["#"]
        prefixes = [""]
        for i, w in enumerate(T.words(topic)):
            if i == 0:
                prefixes = [w] if sys_ else [w, "+"]
            else:
                prefixes = [p + s for p in prefixes
                            for s in ("/" + w, "/+")]
            out.extend(f for f in (p + "/#" for p in prefixes) if f in have)
        out.extend(p for p in prefixes if p in have)
        return out
