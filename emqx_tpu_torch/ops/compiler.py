"""Filter set → flattened NFA tables (host numpy), the port's own copy.

Same layout as the reference compiler (``emqx_tpu/ops/compiler.py``), so a
table built here and one built there from the same filters are
byte-identical:

* states are trie nodes of the wildcard filter trie, BFS-numbered with
  root = 0; ``#`` children are not states, they collapse into a per-state
  ``hash_accept`` id;
* ``node_tab`` (S, 4) int32 — per state ``[plus_child, hash_accept,
  accept, 0]`` (-1 = absent), one 16 B row;
* ``edge_tab`` (Hb, BUCKET_SLOTS·4) int32 — literal edges in a 2-choice
  bucketed cuckoo table, each bucket BUCKET_SLOTS slots of
  ``[state, word, next, 0]`` (a 32 B row);
* ``vocab`` interns literal words to ids ≥ 1; id 0 is UNKNOWN and has
  no edges, so unseen publish words still match ``+``/``#`` only.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .. import topic as T

__all__ = ["NfaTable", "compile_filters", "encode_topics", "BUCKET_SLOTS"]

BUCKET_SLOTS = 2     # slots per cuckoo bucket (row = 2 slots × 4 int32)
_MAX_KICKS = 500     # cuckoo random-walk bound before growing the table


def _bucket(n: int, minimum: int = 8) -> int:
    """Next power of two ≥ max(n, minimum)."""
    b = minimum
    while b < n:
        b <<= 1
    return b


def _bucket_hash(state, word, seed, mask):
    """Bucket index for (state, word): uint32 mixing with wraparound,
    the same function the walk kernel computes on the device."""
    with np.errstate(over="ignore"):
        h = (
            state.astype(np.uint32) * np.uint32(2654435761)
            + word.astype(np.uint32) * np.uint32(2246822519)
            + np.uint32(seed)
        )
        h ^= h >> np.uint32(16)
        h *= np.uint32(3266489917)
        h ^= h >> np.uint32(13)
        return (h & np.uint32(mask)).astype(np.int32)


@dataclass
class NfaTable:
    """Flattened NFA snapshot (host numpy)."""

    node_tab: np.ndarray   # (S, 4) int32: [plus_child, hash_accept, accept, 0]
    edge_tab: np.ndarray   # (Hb, BUCKET_SLOTS*4) int32 [state, word, next, 0]
    seeds: np.ndarray      # (2,) int32 — cuckoo bucket-hash seeds
    n_states: int
    depth: int             # max filter levels the table supports (D)
    vocab: Dict[str, int]
    accept_filters: List[str]
    epoch: int = 0

    @property
    def S(self) -> int:
        return int(self.node_tab.shape[0])

    @property
    def Hb(self) -> int:
        return int(self.edge_tab.shape[0])

    @property
    def n_accepts(self) -> int:
        return len(self.accept_filters)

    def device_arrays(self):
        """The arrays the walk consumes, in argument order."""
        return (self.node_tab, self.edge_tab, self.seeds)


class _Node:
    __slots__ = ("sid", "lit", "plus", "hash_aid", "aid")

    def __init__(self) -> None:
        self.sid = -1
        self.lit: Dict[str, "_Node"] = {}
        self.plus: Optional["_Node"] = None
        self.hash_aid = -1
        self.aid = -1


def _build_cuckoo(
    edges: List[Tuple[int, int, int]], rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Place (state, word, next) edges into a 2-choice bucketed cuckoo
    table.  Returns (edge_tab (Hb, BUCKET_SLOTS*4) int32, seeds (2,))."""
    Hb = _bucket(max(1, int(len(edges) / (BUCKET_SLOTS * 0.85))), 8)
    while True:
        seeds = rng.integers(1, 2**31 - 1, size=2, dtype=np.int32)
        mask = Hb - 1
        slots: List[List[Optional[Tuple[int, int, int]]]] = [
            [None] * BUCKET_SLOTS for _ in range(Hb)
        ]
        ok = True
        for edge in edges:
            cur = edge
            placed = False
            for _ in range(_MAX_KICKS):
                s, w, _nxt = cur
                b_opts = [
                    int(_bucket_hash(np.int32(s), np.int32(w), sd, mask))
                    for sd in seeds
                ]
                for b in b_opts:
                    row = slots[b]
                    for i in range(BUCKET_SLOTS):
                        if row[i] is None:
                            row[i] = cur
                            placed = True
                            break
                    if placed:
                        break
                if placed:
                    break
                b = b_opts[int(rng.integers(2))]
                i = int(rng.integers(BUCKET_SLOTS))
                cur, slots[b][i] = slots[b][i], cur
            if not placed:
                ok = False
                break
        if ok:
            tab = np.full((Hb, BUCKET_SLOTS, 4), -1, np.int32)
            for b in range(Hb):
                for i in range(BUCKET_SLOTS):
                    if slots[b][i] is not None:
                        s, w, nxt = slots[b][i]
                        tab[b, i] = (s, w, nxt, 0)
            return tab.reshape(Hb, BUCKET_SLOTS * 4), seeds
        Hb <<= 1  # insertion failed: grow and retry with fresh seeds


def compile_filters(
    filters: Iterable[str],
    depth: int = 16,
    state_bucket: int = 1024,
    epoch: int = 0,
    seed: int = 0xE709,
) -> NfaTable:
    """Compile a wildcard filter set into an :class:`NfaTable`.  Filters
    deeper than ``depth`` levels are rejected (the host keeps them)."""
    uniq = sorted(set(filters))
    root = _Node()
    accept_filters: List[str] = []

    for flt in uniq:
        ws = T.words(flt)
        if len(ws) > depth:
            raise ValueError(
                f"filter {flt!r} has {len(ws)} levels > table depth {depth}"
            )
        node = root
        for i, w in enumerate(ws):
            if w == "#":
                if i != len(ws) - 1:
                    raise ValueError(f"'#' not at last level: {flt!r}")
                if node.hash_aid < 0:
                    node.hash_aid = len(accept_filters)
                    accept_filters.append(flt)
                break
            if w == "+":
                if node.plus is None:
                    node.plus = _Node()
                node = node.plus
            else:
                nxt = node.lit.get(w)
                if nxt is None:
                    nxt = node.lit[w] = _Node()
                node = nxt
        else:
            if node.aid < 0:
                node.aid = len(accept_filters)
                accept_filters.append(flt)

    order: List[_Node] = []
    root.sid = 0
    order.append(root)
    q = deque([root])
    while q:
        node = q.popleft()
        for child in list(node.lit.values()) + ([node.plus] if node.plus else []):
            child.sid = len(order)
            order.append(child)
            q.append(child)

    n_states = len(order)
    S = _bucket(n_states, state_bucket)
    node_tab = np.full((S, 4), -1, np.int32)
    node_tab[:, 3] = 0

    vocab: Dict[str, int] = {}
    edges: List[Tuple[int, int, int]] = []
    for node in order:
        node_tab[node.sid, 0] = node.plus.sid if node.plus is not None else -1
        node_tab[node.sid, 1] = node.hash_aid
        node_tab[node.sid, 2] = node.aid
        for w, child in node.lit.items():
            wid = vocab.get(w)
            if wid is None:
                wid = vocab[w] = len(vocab) + 1  # 0 reserved
            edges.append((node.sid, wid, child.sid))

    rng = np.random.default_rng(seed)
    edge_tab, seeds = _build_cuckoo(edges, rng)
    return NfaTable(
        node_tab=node_tab, edge_tab=edge_tab, seeds=seeds,
        n_states=n_states, depth=depth, vocab=vocab,
        accept_filters=accept_filters, epoch=epoch,
    )


def encode_topics(
    table: NfaTable, names: Sequence[str], batch: Optional[int] = None
):
    """Tokenize concrete topics: ``(words (B, D) int32, lens (B,) int32,
    is_sys (B,) bool)`` padded to ``batch`` rows with inert rows (see
    :func:`~emqx_tpu_torch.ops.encode.encode_batch`)."""
    from .encode import encode_batch

    return encode_batch(table, names, batch=batch)
