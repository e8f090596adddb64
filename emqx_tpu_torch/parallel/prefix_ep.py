"""Expert-parallel trie partition with all-to-all topic routing (K8c).

The port of ``emqx_tpu/parallel/prefix_ep.py``: the trie sharded by
root word over an ``ep`` mesh axis, each topic of the batch routed to
the shard owning its root prefix.  One step:

1. ingest: topics arrive split over ``ep`` (B/E each);
2. each shard buckets its topics by owner (root word id % E — the host
   partition rule) into an ``(E, C)`` capacity grid by a cumsum rank;
   a topic past capacity is flagged and fails open to the host trie (its
   write goes to a spare slot, cut off, where the reference drops it);
3. :func:`~emqx_tpu_torch.parallel.collectives.all_to_all` flips
   source↔owner: each shard holds every topic it owns;
4. the shard's partition table walks them (the port's ``nfa_match``:
   the hash-walk kernel on the card, one launch a shard) — root-level
   ``+``/``#`` filters are in every partition, so one shard's answer is
   complete;
5. the results go back by a second ``all_to_all`` and land in ingest
   order (empty grid slots write a spare row, cut off).

:func:`build_partitions` builds the per-partition tables with shared
shapes and one shared vocab, so one encode serves every shard: Python
``IncrementalNfa`` tables, byte for byte the reference's, or from
:data:`NATIVE_FROM` filters on ``NativeNfa`` ones (the same rows from
every walk), whose bulk build is about ten times faster.
:func:`owner_of` and :func:`greedy_balance` are the pure host functions
the multichip serve path also uses.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import topic as T
from .collectives import all_to_all
from .mesh import Mesh
from .steps import gather_to, on, walk_match

__all__ = ["EpResult", "EpTables", "NATIVE_FROM", "build_ep_matcher",
           "build_partitions", "greedy_balance", "owner_of"]

#: from this many filters on, :func:`build_partitions` builds
#: ``NativeNfa`` tables (``scripts/torch_ep_build_time.py`` times both
#: builds of config 2's 1M filters)
NATIVE_FROM = 100_000


def owner_of(flt_or_topic: str, vocab: Dict[str, int], n_parts: int) -> int:
    """Partition rule: root word's vocab id mod E (UNKNOWN → 0)."""
    root = flt_or_topic.split("/", 1)[0]
    return vocab.get(root, 0) % n_parts


def greedy_balance(loads: Dict[str, float], owners: Dict[str, int],
                   n_parts: int, budget: int,
                   ) -> Tuple[Dict[str, int], int]:
    """Greedy hot-root reassignment: repeatedly move the hottest
    strictly-improving root from the most- to the least-loaded
    partition, at most ``budget`` times.  A root heavier than the
    hi−lo gap never moves (it would only swap which partition is hot),
    so every move shrinks the spread and the loop ends early when no
    improving move remains.  Pure: returns ``(new owners, moves made)``
    without touching the inputs."""
    owners = dict(owners)
    shard_load = np.zeros(max(1, n_parts), np.float64)
    for w, o in owners.items():
        shard_load[o] += loads.get(w, 0.0)
    moved = 0
    for _ in range(max(0, budget)):
        hi = int(np.argmax(shard_load))
        lo = int(np.argmin(shard_load))
        gap = float(shard_load[hi] - shard_load[lo])
        best = None
        best_load = 0.0
        for w, o in owners.items():
            lw = loads.get(w, 0.0)
            if o == hi and 0.0 < lw < gap and lw > best_load:
                best, best_load = w, lw
        if best is None:
            break
        owners[best] = lo
        shard_load[hi] -= best_load
        shard_load[lo] += best_load
        moved += 1
    return owners, moved


class EpTables(NamedTuple):
    node_tabs: np.ndarray     # (E, S, 4) int32
    edge_tabs: np.ndarray     # (E, Hb, 8) int32
    seeds: np.ndarray         # (E, 2) int32
    vocab: Dict[str, int]     # SHARED across partitions
    accept_filters: List[List[Optional[str]]]  # per-partition aid -> filter
    depth: int

    @property
    def n_parts(self) -> int:
        return int(self.node_tabs.shape[0])


def _shared_vocab(filters: Sequence[str]) -> Dict[str, int]:
    """Every literal word interned once, in the reference's order."""
    vocab: Dict[str, int] = {}
    for f in sorted(set(filters)):
        for w in T.words(f):
            if w not in ("+", "#") and w not in vocab:
                vocab[w] = len(vocab) + 1
    return vocab


def _native_partitions(parts: List[List[str]], vocab: Dict[str, int],
                       depth: int) -> EpTables:
    """The partitions as ``NativeNfa`` tables: the shared vocab interned
    first in its order, one ``bulk_add`` a partition (every table calls
    it, so the words of its warm probe intern alike everywhere), edge
    tables grown to the largest Hb and node tables padded to the largest
    S with empty rows."""
    from ..native.nfa import NativeNfa

    tabs = [NativeNfa(depth=depth) for _ in parts]
    words = list(vocab)
    for tbl, part in zip(tabs, parts):
        tbl.bulk_intern(words)
        tbl.bulk_add(part)
    hb = max(tbl.shape_key()[1] for tbl in tabs)
    for tbl in tabs:
        tbl.grow_edges_to(hb)
    arrays = [tbl.tables() for tbl in tabs]
    S = max(node.shape[0] for node, _e, _s in arrays)
    nodes = []
    for node, _e, _s in arrays:
        pad = np.full((S, 4), -1, np.int32)
        pad[:, 3] = 0
        pad[:node.shape[0]] = node
        nodes.append(pad)
    accept = []
    for tbl, part in zip(tabs, parts):
        names: List[Optional[str]] = [None] * tbl.n_accepts
        for f, aid in zip(part, tbl.bulk_aid_of(part).tolist()):
            names[aid] = f
        accept.append(names)
    return EpTables(
        node_tabs=np.stack(nodes),
        edge_tabs=np.stack([e for _n, e, _s in arrays]),
        seeds=np.stack([sd for _n, _e, sd in arrays]),
        vocab=dict(tabs[0].vocab), accept_filters=accept, depth=depth)


def build_partitions(filters: Sequence[str], n_parts: int, depth: int = 8
                     ) -> EpTables:
    """Partition ``filters`` by root word into ``n_parts`` NFA tables
    with uniform shapes and one shared vocab; root-level wildcards
    (``+``/``#`` first word) go into every partition.  The tables are
    ``IncrementalNfa``s, byte for byte the reference's; from
    :data:`NATIVE_FROM` filters on they are ``NativeNfa``s (a bulk build
    a partition): other bytes, the same rows from every walk."""
    from ..ops.incremental import IncrementalNfa

    vocab = _shared_vocab(filters)
    parts: List[List[str]] = [[] for _ in range(n_parts)]
    for f in sorted(set(filters)):
        root = f.split("/", 1)[0]
        if root in ("+", "#"):
            for p in parts:
                p.append(f)
        else:
            parts[owner_of(f, vocab, n_parts)].append(f)
    if len(filters) >= NATIVE_FROM:
        return _native_partitions(parts, vocab, depth)

    def table(part, **kw):
        inc = IncrementalNfa(depth=depth, **kw)
        inc.vocab = vocab  # shared interning (append-only, one thread)
        for f in part:
            inc.add(f)
        return inc

    incs = [table(p) for p in parts]
    S = max(inc.S for inc in incs)
    Hb = max(inc.Hb for inc in incs)
    # re-home any undersized table onto the common shapes
    rebuilt = []
    for inc, p in zip(incs, parts):
        if inc.S != S or inc.Hb != Hb:
            inc = table(p, state_bucket=S, edge_bucket=Hb)
            if inc.S != S or inc.Hb != Hb:
                raise RuntimeError("a partition table grew past the "
                                   "common shape")
        rebuilt.append(inc)
    return EpTables(
        node_tabs=np.stack([i.node_tab for i in rebuilt]),
        edge_tabs=np.stack([i.edge_tab for i in rebuilt]),
        seeds=np.stack([i.seeds for i in rebuilt]),
        vocab=vocab,
        accept_filters=[list(i.accept_filters) for i in rebuilt],
        depth=depth)


class EpResult(NamedTuple):
    matches: torch.Tensor     # (B, K) int32 PER-PARTITION accept ids
    owners: torch.Tensor      # (B,) int32 owning partition of each topic
    n_matches: torch.Tensor   # (B,) int32
    overflow: torch.Tensor    # (B,) int32 1 = bucket overflowed (host re-run)


def build_ep_matcher(mesh: Mesh, capacity: int, active_slots: int = 16,
                     max_matches: int = 32, plain: bool = False):
    """``step(words, lens, is_sys, node_tabs, edge_tabs, seeds) ->
    EpResult`` over the ``ep`` axis: batch rows split over ``ep``, table
    ``e`` of the ``(E, ...)`` stacks on position ``e``.  ``capacity`` is
    the per-(source, owner) bucket size.  Per dispatch: E walks (one a
    partition, each of E·capacity rows), two rounds of ``all_to_all``.
    ``plain`` runs the plain walk."""
    E = mesh.shape["ep"]
    C = int(capacity)
    K = max_matches
    match = walk_match(active_slots, plain)

    def step(words, lens, is_sys, node_tabs, edge_tabs, seeds):
        # one table per shard, or the device routing rule (% E) and the
        # host partition rule (% n_parts) silently disagree
        if node_tabs.shape[0] != E:
            raise ValueError(
                f"tables built for {node_tabs.shape[0]} partitions but the "
                f"mesh has ep={E}; build_partitions(n_parts) must match")
        B, D = words.shape
        if B % E:
            raise ValueError(f"batch {B} does not split over ep={E}")
        Bl = B // E
        devs = mesh.axis_devices("ep", (0,))
        gw, gl, gs, srcs, owners, overs = [], [], [], [], [], []
        for i, dev in enumerate(devs):
            rows = slice(i * Bl, (i + 1) * Bl)
            w, l, s = (on(x[rows], dev) for x in (words, lens, is_sys))
            owner = w[:, 0] % E                                 # (Bl,)
            onehot = owner[:, None] == torch.arange(E, device=dev)[None, :]
            rank = torch.cumsum(onehot.to(torch.int32), dim=0) - 1
            my_rank = rank.gather(1, owner[:, None].long())[:, 0]
            over = (my_rank >= C).to(torch.int32)
            # an overflowed row writes the spare slot E·C, cut off
            slot = torch.where(over == 0, owner * C + my_rank, E * C).long()
            gw.append(torch.zeros((E * C + 1, D), dtype=torch.int32,
                                  device=dev).index_copy_(0, slot, w)
                      [:E * C].view(E, C, D))
            gl.append(torch.full((E * C + 1,), D + 2, dtype=torch.int32,
                                 device=dev).index_copy_(0, slot, l)
                      [:E * C].view(E, C))
            gs.append(torch.ones((E * C + 1,), dtype=torch.bool, device=dev)
                      .index_copy_(0, slot, s)[:E * C].view(E, C))
            srcs.append(torch.full((E * C + 1,), -1, dtype=torch.int32,
                                   device=dev).index_copy_(
                0, slot, torch.arange(Bl, dtype=torch.int32, device=dev))
                [:E * C])
            owners.append(owner.to(torch.int32))
            overs.append(over)
        w2, l2, s2 = (all_to_all(g, devs) for g in (gw, gl, gs))
        ms, ns = [], []
        for o, dev in enumerate(devs):
            res = match(w2[o].reshape(E * C, D), l2[o].reshape(E * C),
                        s2[o].reshape(E * C), on(node_tabs[o], dev),
                        on(edge_tabs[o], dev), on(seeds[o], dev), K)
            ms.append(res.matches.reshape(E, C, K))
            ns.append(res.n_matches.reshape(E, C))
        m_back, n_back = all_to_all(ms, devs), all_to_all(ns, devs)
        out_m, out_n = [], []
        for i, dev in enumerate(devs):
            # an empty grid slot (-1 source) writes the spare row Bl
            at = torch.where(srcs[i] >= 0, srcs[i], Bl).long()
            out_m.append(torch.full((Bl + 1, K), -1, dtype=torch.int32,
                                    device=dev).index_copy_(
                0, at, m_back[i].reshape(E * C, K))[:Bl])
            out_n.append(torch.zeros((Bl + 1,), dtype=torch.int32,
                                     device=dev).index_copy_(
                0, at, n_back[i].reshape(E * C))[:Bl])
        lead = mesh.lead
        return EpResult(gather_to(out_m, lead), gather_to(owners, lead),
                        gather_to(out_n, lead), gather_to(overs, lead))

    return step
