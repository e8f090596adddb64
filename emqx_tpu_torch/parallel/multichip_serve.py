"""Multichip serve backend: the match table sharded by topic prefix over
a mesh of devices, serving real publish traffic.

The port of ``emqx_tpu/parallel/multichip_serve.py``.  Where the
reference runs one ``shard_map`` over ``jax.devices()``, one process
here drives a ``(dp, tp)`` grid of ``torch.device``s
(:mod:`~emqx_tpu_torch.parallel.mesh`; a device may repeat, so
``[cuda:0] * 4`` is four real shard tables on one card):

* ``dp`` — publish-batch rows (each grid row matches its slice);
* ``tp`` — table shards.  Each ``tp`` shard owns the filters whose root
  token crc32-hashes to it (:func:`shard_of_filter`).  In the default
  **replicated** mode every shard walks the row group on its own
  subtable; in **EP-routed** mode (``ep``) each row is bucketed by its
  root's owner into a ``(tp, capacity)`` grid and one ``all_to_all``
  lands it on the one shard that can match it.  Rows past capacity fail
  open (the host re-runs them);
* **wildcard-root micro-table** — ``+``/``#``-first filters have no
  single owner: they live in a small table on every device, merged into
  the owning shard's answer segment (the ``micro_owner`` shard's in
  replicated mode);
* per-shard matches map through a local→service accept-id table and
  leave the mesh as the dense compact contract
  (:class:`~emqx_tpu_torch.parallel.sharded_match.CompactFanoutResult`),
  decoded by :func:`~emqx_tpu_torch.parallel.sharded_match.
  decode_compact_rows`; with ``ep_compact`` a psum of the +1-biased ids
  collapses the routed plane to one segment (d2h ~tp× smaller);
* per-row truncation, active-set and bucket-overflow spills are summed
  over ``tp`` (the fail-open set).

**The step (K8a)** is :func:`build_multichip_step`: the batch goes up
in one copy a device; on routed dispatches one ``ep_route`` launch a
device buckets the rows into the routing grid; for each grid position
the hash walk in raw mode on the shard's table and on the micro-table
(two launches of ``ops/csrc/nfa_walk.cu`` a shard a row group); then one
``ep_merge`` launch a device (``ops/route_kernel.py``,
``ops/csrc/ep_route.cu``) compacts, translates and merges the walks'
accept slots into the step's output, one int32 buffer that leaves the
card in one copy.  On a mesh of one device (``[cuda:0] * 4``) that is
all: at most 2·tp + 4 device operations a dispatch with the copies.

**The matcher** (:class:`MultichipMatcher`) keeps per-shard host
subtables (``NativeNfa`` when ``native``, else ``IncrementalNfa`` with
one shared vocab), all interning one word sequence so that one encode
serves every shard; mutations queue on the event loop and apply in one
writer (per-shard deltas scattered into the device tables in place
under the lock, a full restack on a resize or a repartition); a
dispatch enqueues the step and the copies of its outputs to host memory
and records an event on each mesh stream, which the readback waits on.

Failure semantics are the reference's: a dead (``kill_shard``) or
fault-injected (``match.shard``; ``ep.route`` on the routed front end)
shard raises at dispatch, and a shard whose launch raises surfaces as
:class:`ShardDead` naming it; each counts as a failover.  The degraded
mesh (``degraded``) scopes that failover to one dead shard (routed rows
it owns divert to the host, replicated dispatches mask its segment and
the service fills in only its filters, the micro merge point migrates
off a dead shard 0), with a health ladder, online shard rebuilds and a
bit-parity canary before re-admission.  The load-adaptive plane
(``ep_autotune``) grows or shrinks the routed capacity class on the
overflow EWMA and stages popularity placement overrides for the next
rebuild.

Intended divergences from the reference: there is no kernel cache and
no ``CompileMiss`` (a CUDA kernel is built once for every shape, so a
cold shape dispatches at once), and a capacity-class flip happens at
the readback that triggers it, where the reference compiles the new
grid on a background thread first.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
import zlib
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import faultinject as _fi
from .. import topic as T
from ..ops import route_kernel as rk
from .collectives import all_to_all
from .mesh import Mesh, default_devices, make_mesh, pick_shape
from .sharded_match import CompactFanoutResult, decode_compact_rows
from . import steps as mesh_steps
from .steps import combine, field_views, packed, upload_batch
from .steps import raw_walk as _raw_walk

log = logging.getLogger(__name__)

__all__ = ["MeshTables", "MultichipMatcher", "ShardDead",
           "build_multichip_step", "is_micro_filter", "mesh_tables",
           "serve_mesh_shape", "shard_of_filter"]


class ShardDead(RuntimeError):
    """A mesh shard is down: the dispatch cannot produce a trustworthy
    answer for any row.  The serve plane treats it as a device failure
    (the host serves the batch).  ``shard`` names the shard when one
    shard's launch raised."""

    def __init__(self, msg: str, shard: Optional[int] = None) -> None:
        super().__init__(msg)
        self.shard = shard


def serve_mesh_shape(n_devices: int, tp: int = 0) -> Dict[str, int]:
    """Mesh factorization for the serve backend: ``tp`` table shards
    (0 = the widest pow2 ≤ 4 that divides the device count), rest
    ``dp`` batch rows."""
    return pick_shape(n_devices, tp if tp > 0 else None)


def shard_of_filter(flt: str, tp: int) -> int:
    """Topic-prefix partition: a filter lives on the shard its root
    token hashes to (the default placement; a live matcher's
    :meth:`MultichipMatcher.shard_of` consults its overrides first)."""
    root = flt.split("/", 1)[0]
    return zlib.crc32(root.encode("utf-8")) % tp


def is_micro_filter(flt: str) -> bool:
    """Wildcard-root filters (``+``/``#`` first token) match topics
    with any root: they live in the replicated micro-table."""
    return flt.split("/", 1)[0] in ("+", "#")


class MeshTables(NamedTuple):
    """The step's table operands, per grid position ``[d][t]`` on
    ``mesh.devices[d][t]``: ``shard`` holds shard ``t``'s ``(node, edge,
    seeds, amap)``, ``repl`` the replicated ``(micro_node, micro_edge,
    micro_seeds, micro_amap, word_owner)``.  Positions on one device
    share one tensor."""

    shard: List[List[Tuple[torch.Tensor, ...]]]
    repl: List[List[Tuple[torch.Tensor, ...]]]


def _put(a, dev: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``dev`` (a read-only array is copied
    first: a tensor must own writable memory)."""
    a = np.require(a, requirements=("C", "W"))
    return torch.from_numpy(a).to(dev, non_blocking=True)


def mesh_tables(mesh: Mesh, node_stk, edge_stk, seeds_stk, aid_stk,
                micro_node, micro_edge, micro_seeds, micro_amap,
                word_owner) -> MeshTables:
    """Upload the stacked host tables (the reference's ``_arrs`` layout:
    ``node_stk (tp, S, 4)``, ``edge_stk (tp, Hb, slots·4)``, ``seeds_stk
    (tp, 2)``, ``aid_stk (tp, A)``, then the replicated arrays) onto the
    mesh: shard ``t``'s arrays once on each distinct device of grid
    column ``t``, the replicated ones once on each distinct device."""
    shard_on: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, ...]] = {}
    repl_on: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
    shard, repl = [], []
    for row in mesh.devices:
        srow, rrow = [], []
        for t, dev in enumerate(row):
            if (dev, t) not in shard_on:
                shard_on[(dev, t)] = tuple(
                    _put(a[t], dev)
                    for a in (node_stk, edge_stk, seeds_stk, aid_stk))
            if dev not in repl_on:
                repl_on[dev] = tuple(
                    _put(a, dev) for a in (micro_node, micro_edge,
                                           micro_seeds, micro_amap,
                                           word_owner))
            srow.append(shard_on[(dev, t)])
            rrow.append(repl_on[dev])
        shard.append(srow)
        repl.append(rrow)
    return MeshTables(shard, repl)


def _scatter_rows(tabs: Sequence[torch.Tensor], idx: np.ndarray,
                  rows: np.ndarray) -> None:
    """``tab[idx] = rows`` in place on each distinct tensor of ``tabs``
    (the per-shard delta scatter).  The last write of a repeated index
    wins (reduced on the host first: a repeated index is not ordered on
    the card), and an index past the table is dropped."""
    if not len(idx):
        return
    idx = np.asarray(idx, np.int64)
    rows = np.asarray(rows, np.int32)
    last = len(idx) - 1 - np.unique(idx[::-1], return_index=True)[1]
    seen = set()
    for tab in tabs:
        if id(tab) in seen:
            continue
        seen.add(id(tab))
        keep = last[idx[last] < tab.shape[0]]
        tab.index_copy_(0, _put(idx[keep], tab.device),
                        _put(rows[keep], tab.device))


def _as_rows(fields: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each field as ``(rows, width)`` (a vector as one column)."""
    return [f if f.dim() == 2 else f.view(-1, 1) for f in fields]


def build_multichip_step(mesh: Mesh, active_slots: int = 16,
                         max_matches: int = 32, micro_matches: int = 8,
                         routed: bool = False, capacity: int = 0,
                         compact: bool = False, micro_owner: int = 0,
                         plain: bool = False):
    """Return ``step(words, lens, is_sys, tables) -> CompactFanoutResult``
    (the reference's step, K8a): ``words (B, D)``, ``lens (B,)``,
    ``is_sys (B,)`` on the host (numpy or CPU tensors; row group ``d``
    is rows ``[d·B/dp, (d+1)·B/dp)``), ``tables`` a :class:`MeshTables`.
    The result lives on ``mesh.lead``, its six fields views of one int32
    buffer: ``ids`` (B, tp·(K+Km)) service accept ids, -1 padded,
    per-shard segments disjoint; ``counts`` and ``overflow`` (B, tp); the
    spill vectors summed over ``tp``.

    A dispatch uploads the batch in one copy a device, walks each shard's
    table and the micro-table in raw mode at every grid position (2·tp
    walks a row group: ``ops/csrc/nfa_walk.cu`` on the card) and merges
    the walks' accept slots into the output with one ``ep_merge`` launch
    a device (``ops/route_kernel.py``: the compaction, the translation,
    ``merge_micro``, the placement and the sums).

    ``routed`` is the EP front end: one ``ep_route`` launch a device
    buckets each shard's 1/tp source slice of the row group by
    ``word_owner[root]`` into a (tp, ``capacity``) grid; on one device
    the grid is written as it lands, else one :func:`all_to_all` lands
    each row on the shard that owns its root.  The owner merges its own
    and the micro answers into its segment.  Rows past ``capacity`` fail
    open.  ``compact`` (routed only) writes the owner's segment as the
    row's one segment (the reference's psum of +1-biased segments):
    ``ids`` (B, K+Km), ``counts`` and ``overflow`` (B, 1).
    ``micro_owner`` is the shard that merges the micro answers in
    replicated mode.  ``plain`` runs the walk's and both kernels' plain
    versions in their place."""
    K = max_matches
    Km = micro_matches
    W = K + Km
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    C = int(capacity)
    compact = bool(compact) and bool(routed)
    segs = 1 if compact else tp
    walk = _raw_walk(active_slots, plain)
    route = rk.ep_route_plain if plain else rk.ep_route
    merge = rk.ep_merge_plain if plain else rk.ep_merge
    shapes = [(segs * W,), (segs,), (segs,), (), (), ()]
    lead = mesh.lead
    one = mesh_steps.one_device(mesh.distinct)

    def walk_pair(t, w, l, s, shard, repl, seg, row_base, micro, src=None):
        node, edge, seeds, amap = shard
        mnode, medge, mseeds, mamap, _wo = repl
        try:
            acc, aover = walk(w, l, s, node, edge, seeds)
            macc, maover = walk(w, l, s, mnode, medge, mseeds)
        except Exception as e:
            raise ShardDead(f"mesh shard {t}: walk failed: {e}", t) from e
        return rk.MergePair(acc, aover, macc, maover, amap, mamap, src, seg,
                            row_base, micro)

    def grids(n: int, D: int, dev: torch.device) -> rk.RouteGrid:
        return rk.RouteGrid(
            torch.empty((n, D), dtype=torch.int32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev),
            torch.empty((n,), dtype=torch.bool, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev))

    def ep_routed(inputs, tables, outs, B, D, Bl):
        """The routed front end: the grid bucketed and landed, and the
        walk pair of each grid position on its landed rows."""
        Bs = Bl // tp
        R = tp * C
        pairs = []
        if one:
            # the landed (d, owner, source, C) layout, written in place
            g = grids(dp * tp * R, D, lead)
            w, l, s = inputs[lead]
            fields = outs[lead]
            route(w, l, s, tables.repl[0][0][4], g, tp=tp, C=C, Bs=Bs,
                  sources=[(b * Bs, ((b // tp) * tp * tp + b % tp) * C)
                           for b in range(dp * tp)],
                  so=R, fill_ids=fields[0], zeros=_as_rows(fields[1:5]),
                  flag=fields[5])
            lw = g.words.view(dp, tp, R, D)
            ll, ls, lsrc = (x.view(dp, tp, R) for x in g[1:])
            for d in range(dp):
                for o in range(tp):
                    pairs.append(walk_pair(
                        o, lw[d, o], ll[d, o], ls[d, o],
                        tables.shard[d][o], tables.repl[d][o],
                        0 if compact else o, d * Bl, True, lsrc[d, o]))
            return pairs
        # each device buckets its own sources, (owner, C) a source
        src_grid = {}
        for dev in outs:
            mine = [(d, i) for d in range(dp) for i in range(tp)
                    if mesh.devices[d][i] == dev]
            g = grids(len(mine) * R, D, dev)
            w, l, s = inputs[dev]
            d0, i0 = mine[0]
            fields = outs[dev]
            route(w, l, s, tables.repl[d0][i0][4], g, tp=tp, C=C, Bs=Bs,
                  sources=[((d * tp + i) * Bs, k * R)
                           for k, (d, i) in enumerate(mine)],
                  so=C, fill_ids=fields[0], zeros=_as_rows(fields[1:5]),
                  flag=fields[5])
            for k, pos in enumerate(mine):
                src_grid[pos] = tuple(
                    x[k * R:(k + 1) * R].view(tp, C, *x.shape[1:])
                    for x in g)
        for d in range(dp):
            devs = mesh.devices[d]
            # (owner, C, ...) leaves each source, (source, C, ...) lands
            landed = [all_to_all([src_grid[(d, i)][k] for i in range(tp)],
                                 devs) for k in range(4)]
            for o in range(tp):
                lw, ll, ls, lsrc = (x[o].reshape(R, *x[o].shape[2:])
                                    for x in landed)
                pairs.append(walk_pair(
                    o, lw, ll, ls, tables.shard[d][o], tables.repl[d][o],
                    0 if compact else o, d * Bl, True, lsrc))
        return pairs

    def step(words, lens, is_sys, tables: MeshTables) -> CompactFanoutResult:
        B, D = (int(x) for x in words.shape)
        if B % dp:
            raise ValueError(f"batch {B} does not split over dp={dp}")
        Bl = B // dp
        if routed and (Bl % tp or C < 1):
            raise ValueError(f"a routed batch of {Bl} rows a row group "
                             f"does not split over tp={tp}, or capacity "
                             f"{C} < 1")
        inputs = upload_batch(words, lens, is_sys, mesh.distinct)
        bufs, outs = {}, {}
        for dev in mesh.distinct:
            bufs[dev], outs[dev] = packed(dev, B, shapes)
            if not one:
                # several devices write parts of a row: what a device
                # leaves reads as nobody's answer (-1 ids, 0 elsewhere)
                bufs[dev][:B * segs * W].fill_(-1)
                bufs[dev][B * segs * W:].zero_()
        if routed:
            placed = ep_routed(inputs, tables, outs, B, D, Bl)
        else:
            placed = []
            for d in range(dp):
                for t in range(tp):
                    w, l, s = (x[d * Bl:(d + 1) * Bl]
                               for x in inputs[mesh.devices[d][t]])
                    placed.append(walk_pair(
                        t, w, l, s, tables.shard[d][t], tables.repl[d][t],
                        t, d * Bl, t == micro_owner))
        for dev in mesh.distinct:
            pairs = [p for p in placed if p.acc.device == dev]
            merge(pairs, rk.MergeOut(*outs[dev]), routed=routed, K=K, Km=Km,
                  C=max(C, 1), Bs=Bl // tp, segs=segs)
        if one:
            return CompactFanoutResult(*outs[lead])
        buf = combine([bufs[dev] for dev in mesh.distinct], B * segs * W,
                      lead)
        return CompactFanoutResult(*field_views(buf, B, shapes))

    return step


def _host_copy(res, pin: bool) -> List[torch.Tensor]:
    """The step result's fields copied to host memory behind the step:
    one copy of the int32 buffer they are views of (the step's
    :func:`~emqx_tpu_torch.parallel.steps.packed` output), the same
    views of the copy."""
    base = res[0]._base
    h = torch.empty(base.shape, dtype=base.dtype, pin_memory=pin)
    h.copy_(base, non_blocking=True)
    at = base.storage_offset()
    return [h.as_strided(x.shape, x.stride(), x.storage_offset() - at)
            for x in res]


class McHandle:
    """One mesh dispatch in flight: the step's device result, the host
    copies of its fields enqueued behind it, the events recorded after
    them (one per mesh stream; none on the CPU), and what the readback
    needs (routed, the degraded failover's dead shards and rows)."""

    __slots__ = ("res", "host", "events", "routed", "meta")

    def __init__(self, res, host, events, routed, meta) -> None:
        self.res, self.host, self.events = res, host, events
        self.routed, self.meta = routed, meta


class MultichipMatcher:
    """Host side of the multichip serve backend: per-shard subtables
    (identical vocabs, one encode serves every shard), the wildcard
    micro-table, the mesh's device tables, and the step cache.

    Threading model (the ``MatchService`` discipline): ``note_add``,
    ``note_del`` and ``rebuild`` only append to a pending list;
    ``apply_pending`` is the single writer of the subtables and the
    device tables; ``dispatch`` reads one consistent set of tables under
    the lock."""

    # v3: the manifest's aid_maps.npz also carries the placement
    # override map; v2 manifests are refused (a repartition serves)
    MANIFEST_VERSION = 3
    #: serve-plane dispatch routing marker
    is_multichip = True
    #: smoothing factor of the per-dispatch routed overflow-rate EWMA
    EP_OVERFLOW_ALPHA = 0.1
    #: routed readbacks at the current capacity class before a shrink
    EP_SHRINK_COOLDOWN = 64

    def __init__(
        self,
        depth: int = 8,
        tp: int = 0,
        devices: Optional[Sequence[Any]] = None,
        active_slots: int = 16,
        max_matches: int = 32,
        metrics: Any = None,
        native: bool = True,
        ep: bool = False,
        ep_slack: float = 2.0,
        ep_micro_matches: int = 8,
        ep_compact: bool = False,
        degraded: bool = False,
        degraded_fail_threshold: int = 3,
        ep_overflow_warn: float = 0.5,
        ep_autotune: bool = False,
        ep_grow_threshold: float = 0.05,
        ep_shrink_threshold: float = 0.01,
        ep_max_cap_class: int = 3,
        balance_budget: int = 64,
    ) -> None:
        devs = list(devices) if devices is not None else default_devices()
        shape = serve_mesh_shape(len(devs), tp)
        self.mesh = make_mesh(shape, devs)
        self.dp = shape["dp"]
        self.tp = shape["tp"]
        self.n_devices = self.dp * self.tp
        self.depth = depth
        self.active_slots = active_slots
        self.max_matches = max_matches
        self.metrics = metrics
        self.ep = bool(ep)
        self.ep_slack = float(ep_slack)
        self.ep_micro_matches = int(ep_micro_matches)
        self.ep_compact = bool(ep_compact)
        self.degraded = bool(degraded)
        self.fail_threshold = max(1, int(degraded_fail_threshold))
        self.ep_overflow_warn = float(ep_overflow_warn)
        self.ep_autotune = bool(ep_autotune)
        self.ep_grow_threshold = float(ep_grow_threshold)
        self.ep_shrink_threshold = float(ep_shrink_threshold)
        self.ep_max_cap_class = max(0, int(ep_max_cap_class))
        self.balance_budget = max(0, int(balance_budget))
        self._cap_class = 0            # live pow2 capacity exponent
        self._class_readbacks = 0      # routed readbacks at this class
        self._ep_shapes: set = set()   # observed routed (B, D) shapes
        # popularity placement: the override map consulted before the
        # crc32 default, the staged map the next rebuild swaps in, and
        # the per-root load slab (indexed by root word id)
        self._placement: Dict[str, int] = {}
        self._placement_next: Optional[Dict[str, int]] = None
        self._root_load = np.zeros(1024, np.float64)
        self.ep_resizes = 0
        self.ep_rebalances = 0
        self.moved_roots = 0
        # the native table is built by g++ at first use: no fallback
        self.native = bool(native)

        self.vocab: Dict[str, int] = {}
        self._subs: List[Any] = []
        self._aid_maps: List[np.ndarray] = []
        self._filters: List[Dict[str, int]] = []
        self._micro: Any = None
        self._micro_amap: np.ndarray = np.full(8, -1, np.int32)
        self._micro_filters: Dict[str, int] = {}
        self._word_owner = np.zeros(1024, np.int32)
        self._word_owner_n = 0
        self._reset_subs()

        self._lock = threading.Lock()
        # serializes table maintenance (apply_pending, save_segments,
        # rebuild_shard)
        self._maint_lock = threading.Lock()
        self._pending: List[Tuple[str, str, int]] = []  # (op, flt, aid)
        self._rebuild_pairs: Optional[List[Tuple[str, int]]] = None
        self._restack_due = False      # segment restore awaiting upload
        self._arrs: Optional[MeshTables] = None
        self._stacked_shape: Optional[Tuple[int, ...]] = None
        self._steps: Dict[Tuple[int, ...], Any] = {}
        self._dead: set = set()
        # degraded mesh: per-shard consecutive-failure strikes and the
        # round-robin cursor that attributes anonymous match.shard
        # faults to a live shard
        self._fail_counts: Dict[int, int] = {}
        self._fault_rr = 0
        self.degraded_batches = 0
        self.cpu_filled_rows = 0
        self.rebuilds = 0
        self.readmit_canary_fails = 0
        # routed overflow-rate EWMA and its log-once warning latch
        self._ov_ewma = 0.0
        self._ov_warned = False
        self.gen = 0                    # bumped on every restack
        self.dispatches = 0
        self.ep_dispatches = 0
        self.failovers = 0
        self.applies = 0
        self.restacks = 0
        self.seeded_from_segments = False
        self._persist_due = False
        self._restored_words: List[str] = []
        if metrics is not None:
            metrics.set("tpu.match.shard_devices", self.n_devices)

    # ------------------------------------------------------------------
    # partition maintenance (event loop: enqueue; one writer: apply)
    # ------------------------------------------------------------------

    def _new_sub(self):
        if self.native:
            from ..native.nfa import NativeNfa

            return NativeNfa(depth=self.depth)
        from ..ops.incremental import IncrementalNfa

        sub = IncrementalNfa(depth=self.depth)
        # one vocab dict shared by every subtable: a single encode pass
        # serves all shards (interning appends consistently)
        sub.vocab = self.vocab
        return sub

    def _reset_subs(self) -> None:
        self.vocab = {}
        self._subs = []
        self._aid_maps = []
        self._filters = []
        self._word_owner = np.zeros(1024, np.int32)
        self._word_owner_n = 0
        for _ in range(self.tp):
            self._subs.append(self._new_sub())
            self._aid_maps.append(np.full(64, -1, np.int32))
            self._filters.append({})
        self._micro = self._new_sub()
        self._micro_amap = np.full(8, -1, np.int32)
        self._micro_filters = {}

    def _all_tables(self) -> List[Any]:
        return [*self._subs, self._micro]

    def shard_of(self, flt: str) -> int:
        """Placement-aware :func:`shard_of_filter`: the override map
        (root → shard) first, then the crc32 default."""
        if self._placement:
            o = self._placement.get(flt.split("/", 1)[0])
            if o is not None:
                return int(o)
        return shard_of_filter(flt, self.tp)

    def note_add(self, flt: str, service_aid: int) -> None:
        with self._lock:
            self._pending.append(("add", flt, service_aid))

    def note_del(self, flt: str) -> None:
        with self._lock:
            self._pending.append(("del", flt, -1))

    def rebuild(self, pairs: List[Tuple[str, int]]) -> None:
        """Full repartition (cold start, compaction swap: the service
        aid space was reassigned).  Cheap here: the build happens at the
        next ``apply_pending``; until then ``ready`` is False and the
        single-device path serves."""
        with self._lock:
            self._rebuild_pairs = list(pairs)
            self._pending = []
            self._restack_due = False
            self._arrs = None
            self._steps = {}

    @property
    def ready(self) -> bool:
        return self._arrs is not None

    @property
    def dirty(self) -> bool:
        return (bool(self._pending) or self._rebuild_pairs is not None
                or self._restack_due)

    @property
    def heavy(self) -> bool:
        """A repartition or a restored partition's upload is queued: the
        next apply builds every table (a worker thread's job)."""
        return self._rebuild_pairs is not None or self._restack_due

    def _intern_filter_words(self, flt: str) -> None:
        """Intern the filter's literal words into the shared encode vocab
        and every subtable (ids assign append-only, so one word sequence
        replayed everywhere keeps every vocab identical)."""
        for w in T.words(flt):
            if w in ("+", "#") or w in self.vocab:
                continue
            self.vocab[w] = len(self.vocab) + 1
            if self.native:
                for tbl in self._all_tables():
                    tbl.intern(w)

    @staticmethod
    def _grow_map(amap: np.ndarray, laid: int) -> np.ndarray:
        if laid < len(amap):
            return amap
        grown = np.full(max(2 * len(amap), laid + 1), -1, np.int32)
        grown[:len(amap)] = amap
        return grown

    def _host_add(self, flt: str, service_aid: int) -> None:
        self._intern_filter_words(flt)
        if is_micro_filter(flt):
            self._micro.add(flt)
            laid = self._micro.aid_of(flt)
            self._micro_amap = self._grow_map(self._micro_amap, laid)
            self._micro_amap[laid] = service_aid
            self._micro_filters[flt] = service_aid
            return
        t = self.shard_of(flt)
        sub = self._subs[t]
        sub.add(flt)
        laid = sub.aid_of(flt)
        self._aid_maps[t] = self._grow_map(self._aid_maps[t], laid)
        self._aid_maps[t][laid] = service_aid
        self._filters[t][flt] = service_aid

    def _host_del(self, flt: str) -> None:
        if is_micro_filter(flt):
            laid = self._micro.aid_of(flt)
            if laid < 0:
                return
            self._micro_amap[laid] = -1
            self._micro.remove(flt)
            self._micro_filters.pop(flt, None)
            return
        t = self.shard_of(flt)
        sub = self._subs[t]
        laid = sub.aid_of(flt)
        if laid < 0:
            return
        self._aid_maps[t][laid] = -1
        sub.remove(flt)
        self._filters[t].pop(flt, None)

    def _bulk_build(self, pairs: List[Tuple[str, int]]) -> None:
        """Native repartition: every table takes its share in one
        ``bulk_add`` (every table calls it, even with no filters, so the
        sentinel words of its warm probe intern in one order
        everywhere), the tail those words added joins the shared vocab,
        and the accept-id maps come from one ``bulk_aid_of`` a table."""
        words: List[str] = []
        for flt, _aid in pairs:
            for w in T.words(flt):
                if w not in ("+", "#") and w not in self.vocab:
                    self.vocab[w] = len(self.vocab) + 1
                    words.append(w)
        for tbl in self._all_tables():
            tbl.bulk_intern(words)
        parts: List[List[Tuple[str, int]]] = [[] for _ in range(self.tp + 1)]
        for flt, aid in pairs:
            parts[self.tp if is_micro_filter(flt)
                  else self.shard_of(flt)].append((flt, aid))
        for tbl, part in zip(self._all_tables(), parts):
            tbl.bulk_add([f for f, _a in part])
        vocab = self._subs[0].vocab
        if any(tbl.vocab != vocab for tbl in self._all_tables()[1:]):
            raise RuntimeError("multichip shard vocabs diverged")
        for w in list(vocab)[len(self.vocab):]:
            self.vocab[w] = len(self.vocab) + 1
        for k, (tbl, part) in enumerate(zip(self._all_tables(), parts)):
            flts = [f for f, _a in part]
            laids = tbl.bulk_aid_of(flts)
            if len(flts) and int(laids.min()) < 0:
                bad = flts[int(np.flatnonzero(laids < 0)[0])]
                raise ValueError(f"filter {bad!r} not taken by its table")
            amap = np.full(max(64 if k < self.tp else 8,
                               int(laids.max(initial=-1)) + 1), -1, np.int32)
            aids = np.fromiter((a for _f, a in part), np.int32, len(part))
            amap[laids] = aids
            if k < self.tp:
                self._aid_maps[k] = amap
                self._filters[k] = dict(part)
            else:
                self._micro_amap = amap
                self._micro_filters = dict(part)

    def _sync_word_owner(self) -> bool:
        """Fill the routing owners (the device twin of :meth:`shard_of`)
        of vocab words interned since the last sync; pow2 growth.  True
        when entries changed."""
        n = len(self.vocab)
        if self._word_owner_n >= n:
            return False
        cap = len(self._word_owner)
        if n + 1 > cap:
            while cap < n + 1:
                cap *= 2
            grown = np.zeros(cap, np.int32)
            grown[:len(self._word_owner)] = self._word_owner
            self._word_owner = grown
        place = self._placement
        for w, wid in list(self.vocab.items())[self._word_owner_n:]:
            o = place.get(w) if place else None
            self._word_owner[wid] = (
                zlib.crc32(w.encode("utf-8")) % self.tp
                if o is None else int(o))
        self._word_owner_n = n
        return True

    def apply_pending(self) -> bool:
        """The single writer: drain the queued mutations into the
        per-shard subtables, then ship them (per-shard deltas scattered
        into the device tables in place; a resize or a repartition
        restacks).  True when the device state changed."""
        with self._maint_lock:
            return self._apply_locked()

    def _apply_locked(self) -> bool:
        with self._lock:
            ops, self._pending = self._pending, []
            rebuild, self._rebuild_pairs = self._rebuild_pairs, None
            restack_due, self._restack_due = self._restack_due, False
        if rebuild is not None:
            with self._lock:
                staged, self._placement_next = self._placement_next, None
            if staged is not None:
                # the staged override map swaps in here, so the restack
                # below remaps spans and word_owner in the same pass
                self._placement = staged
                self._persist_due = True
                log.info("EP placement override map applied: %d "
                         "root(s) off their crc32 shard", len(staged))
            self._reset_subs()
            if self.native:
                self._bulk_build(rebuild)
            else:
                for flt, aid in rebuild:
                    self._host_add(flt, aid)
            # notes queued after the rebuild request apply on top
            for op, flt, aid in ops:
                if op == "add":
                    self._host_add(flt, aid)
                else:
                    self._host_del(flt)
            for tbl in self._all_tables():
                tbl.flush()     # clear dirty sets; the restack ships all
            self._restack()
            self._persist_due = True
            return True
        if not ops:
            if self._arrs is None and restack_due:
                # segment restore: the subtables are filled but the
                # device tables were never shipped
                self._restack()
                return True
            return False
        for op, flt, aid in ops:
            if op == "add":
                self._host_add(flt, aid)
            else:
                self._host_del(flt)
        deltas = [sub.flush() for sub in self._subs]
        mdelta = self._micro.flush()
        wo_changed = self._sync_word_owner()
        shape = self._required_shape()
        if (self._arrs is None or self._stacked_shape != shape
                or any(d.resized for d in deltas) or mdelta.resized):
            self._restack()
            return True
        # the lock spans the whole read-modify-publish: a dispatch never
        # runs against a half-written set of tables
        with self._lock, self.mesh.streams():
            arrs = self._arrs
            for t, dl in enumerate(deltas):
                if dl.empty:
                    continue
                col = [row[t] for row in arrs.shard]
                _scatter_rows([s[0] for s in col], dl.state_idx,
                              dl.state_rows)
                _scatter_rows([s[1] for s in col], dl.bucket_idx,
                              dl.bucket_rows)
            aid_stk = self._stacked_aid_maps(shape[2])
            amaps: Dict[Tuple[torch.device, int], torch.Tensor] = {}
            for row in arrs.shard:
                for t, s in enumerate(row):
                    key = (s[3].device, t)
                    if key not in amaps:
                        amaps[key] = _put(aid_stk[t], s[3].device)
            shard = [[(*s[:3], amaps[(s[3].device, t)])
                      for t, s in enumerate(row)] for row in arrs.shard]
            repl = arrs.repl
            if not mdelta.empty or wo_changed:
                micro = (self._table_arrays(self._micro)
                         if not mdelta.empty else None)
                fresh: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
                for r in {id(x): x for row in repl for x in row}.values():
                    dev = r[0].device
                    mn, me, ms = (r[:3] if micro is None else
                                  (_put(a, dev) for a in micro))
                    fresh[dev] = (mn, me, ms, _put(
                        self._padded_micro_amap(shape[5]), dev),
                        _put(self._word_owner, dev))
                repl = [[fresh[x[0].device] for x in row] for row in repl]
            self._arrs = MeshTables(shard, repl)
        self.applies += 1
        return True

    @staticmethod
    def _table_shape(sub) -> Tuple[int, int]:
        """(S, Hb) for either table implementation."""
        if hasattr(sub, "node_tab"):
            return int(sub.S), int(sub.Hb)
        s, hb, _depth = sub.shape_key()
        return int(s), int(hb)

    @staticmethod
    def _table_arrays(sub):
        """(node_tab, edge_tab, seeds) for either table implementation."""
        if hasattr(sub, "node_tab"):
            return sub.node_tab, sub.edge_tab, sub.seeds
        return sub.tables()

    def _required_shape(self) -> Tuple[int, int, int, int, int, int, int]:
        """Common stacked (S, Hb, A_cap) plus the replicated shapes
        (micro S, micro Hb, micro A_cap, word_owner cap): node tables
        pad (pad rows are unreachable), edge tables share one real
        bucket count (lookups hash modulo Hb), aid maps pad."""
        smax = max(self._table_shape(sub)[0] for sub in self._subs)
        hbmax = max(self._table_shape(sub)[1] for sub in self._subs)
        acap = 64
        for amap in self._aid_maps:
            while acap < len(amap):
                acap *= 2
        sm, hbm = self._table_shape(self._micro)
        am = 8
        while am < len(self._micro_amap):
            am *= 2
        return (smax, hbmax, acap, sm, hbm, am, len(self._word_owner))

    def _stacked_aid_maps(self, acap: int) -> np.ndarray:
        out = np.full((self.tp, acap), -1, np.int32)
        for t, amap in enumerate(self._aid_maps):
            out[t, :len(amap)] = amap
        return out

    def _padded_micro_amap(self, am: int) -> np.ndarray:
        out = np.full(am, -1, np.int32)
        out[:len(self._micro_amap)] = self._micro_amap
        return out

    def _stacked(self) -> Tuple[Tuple[int, ...], Tuple[np.ndarray, ...]]:
        """``(shape, arrays)``: the host tables in the reference's stacked
        ``_arrs`` layout (what :meth:`_restack` uploads), after growing
        every shard's edge table to the common Hb."""
        hbmax = max(self._table_shape(sub)[1] for sub in self._subs)
        for sub in self._subs:
            if hasattr(sub, "grow_edges_to"):
                sub.grow_edges_to(hbmax)
            else:
                while sub.Hb < hbmax:
                    sub._grow_edges()
            sub.flush()     # growth marked dirty; the restack ships all
        self._micro.flush()
        self._sync_word_owner()
        shape = self._required_shape()
        smax, hbmax, acap, _sm, _hbm, am, _wcap = shape
        nodes, edges, seeds = [], [], []
        for sub in self._subs:
            node, edge, sd = self._table_arrays(sub)
            tab = np.full((smax, 4), -1, np.int32)
            tab[:, 3] = 0
            tab[:node.shape[0]] = node
            nodes.append(tab)
            edges.append(edge)
            seeds.append(sd)
        mn, me, ms = self._table_arrays(self._micro)
        return shape, (np.stack(nodes), np.stack(edges), np.stack(seeds),
                       self._stacked_aid_maps(acap), np.asarray(mn),
                       np.asarray(me), np.asarray(ms),
                       self._padded_micro_amap(am), self._word_owner.copy())

    def _restack(self) -> None:
        """Full upload of the per-shard tables and the replicated
        micro/word_owner arrays, into new tensors on the mesh streams (a
        step in flight keeps the old ones)."""
        shape, arrays = self._stacked()
        with self.mesh.streams():
            arrs = mesh_tables(self.mesh, *arrays)
        with self._lock:
            self._arrs = arrs
            self._stacked_shape = shape
        self.gen += 1
        self.applies += 1
        self.restacks += 1
        if self.metrics is not None:
            self.metrics.set("tpu.match.shard_restacks", self.restacks)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------

    def encode(self, topics: Sequence[str], batch: int,
               depth: Optional[int] = None):
        """Encode against the shared shard vocab (one pass serves every
        shard; the service table's vocab assigns other ids)."""
        from ..ops.encode import encode_batch

        return encode_batch(self, topics, batch=batch, depth=depth)

    def kill_shard(self, t: int) -> None:
        """Chaos surface: mark shard ``t`` dead.  Flag off, every later
        dispatch raises :class:`ShardDead` until ``revive_shard``;
        degraded mode keeps serving on the survivors."""
        self._dead.add(int(t))
        self._fail_counts.pop(int(t), None)
        self._set_state_metric()

    def revive_shard(self, t: int) -> None:
        self._dead.discard(int(t))
        self._fail_counts.pop(int(t), None)
        self._set_state_metric()

    # -- health ladder -------------------------------------------------

    def mesh_state(self) -> int:
        """Health-ladder rung: 0 healthy, 1 degraded(S) (scoped failover
        around one dead shard), 2 cpu-only (every dispatch refused)."""
        if not self._dead:
            return 0
        if self.degraded_serving:
            return 1
        return 2

    @property
    def dead_shards(self) -> List[int]:
        return sorted(self._dead)

    @property
    def degraded_serving(self) -> bool:
        """True while scoped failover answers on the survivors: exactly
        one dead shard (a second drops the plane to cpu-only)."""
        return bool(self.degraded and len(self._dead) == 1
                    and self.tp > 1)

    def note_shard_failure(self, t: int) -> bool:
        """One consecutive-failure strike against shard ``t``; at
        ``fail_threshold`` strikes it is marked dead.  True when this
        strike killed it."""
        t = int(t)
        if t in self._dead:
            return False
        c = self._fail_counts.get(t, 0) + 1
        self._fail_counts[t] = c
        if c < self.fail_threshold:
            return False
        self._fail_counts.pop(t, None)
        self._dead.add(t)
        log.warning("mesh shard %d dead after %d consecutive failures",
                    t, c)
        self._set_state_metric()
        return True

    def _note_fault_failure(self) -> None:
        """An injected ``match.shard`` fault names no shard: strike the
        live shards round-robin."""
        live = [t for t in range(self.tp) if t not in self._dead]
        if not live:
            return
        t = live[self._fault_rr % len(live)]
        self._fault_rr += 1
        self.note_shard_failure(t)

    def _set_state_metric(self) -> None:
        if self.degraded and self.metrics is not None:
            self.metrics.set("tpu.mesh.state", self.mesh_state())

    def dead_aids(self, exclude: Optional[int] = None) -> frozenset:
        """Service accept ids owned by dead shards: the replicated
        scoped failover's host-fill set."""
        out: set = set()
        for t in self._dead:
            if exclude is not None and int(t) == int(exclude):
                continue
            out.update(self._filters[t].values())
        return frozenset(out)

    def _gate(self) -> None:
        if self._dead:
            if not self.degraded_serving:
                self._note_failover()
                raise ShardDead(f"mesh shard(s) {sorted(self._dead)} dead")
        if _fi._injector is not None:
            act = _fi._injector.act("match.shard")
            if act == "raise":
                self._note_failover()
                if self.degraded:
                    self._note_fault_failure()
                raise _fi.InjectedFault("match.shard")
            if act == "delay":
                time.sleep(_fi._injector.last_delay)

    def _gate_ep(self) -> None:
        """The routed front end's own seam: an injected ``ep.route``
        fault refuses the dispatch without taking the mesh down."""
        if _fi._injector is not None:
            act = _fi._injector.act("ep.route")
            if act == "raise":
                self._note_failover()
                raise _fi.InjectedFault("ep.route")
            if act == "delay":
                time.sleep(_fi._injector.last_delay)

    def _note_failover(self) -> None:
        self.failovers += 1
        if self.metrics is not None:
            self.metrics.inc("tpu.match.shard_failover")

    def _shard_failed(self, e: ShardDead) -> None:
        """A shard's launch raised: a failover, and with the degraded
        mesh a strike against that shard."""
        self._note_failover()
        if self.degraded and e.shard is not None:
            self.note_shard_failure(e.shard)

    def _capacity_at(self, batch: int, cap_class: int) -> int:
        """Per-(source, owner) bucket size of a routed batch: the uniform
        share ``Bs/tp`` with ``ep_slack`` headroom, scaled by pow2
        capacity classes up to the source-slice width."""
        bs = (batch // self.dp) // self.tp
        base = max(1, int(math.ceil(self.ep_slack * bs / self.tp)))
        if cap_class:
            base = min(max(bs, 1), base << cap_class)
        return base

    def ep_capacity(self, batch: int) -> int:
        """:meth:`_capacity_at` the live capacity class (class 0, flag
        off or never grown, is the base share)."""
        return self._capacity_at(batch, self._cap_class)

    def _routed_for(self, batch: int) -> bool:
        """EP routing serves a batch iff the row group splits evenly into
        tp source slices; other shapes take the replicated step."""
        return (self.ep and self.tp > 1
                and batch % (self.dp * self.tp) == 0
                and (batch // self.dp) >= self.tp)

    def _launch(self, words, lens, is_sys, routed: bool, owner: int,
                d: int) -> Tuple[CompactFanoutResult, list, list]:
        """Enqueue the step and its outputs' copies to the host on the
        mesh streams, under the lock; ``(device result, host copies,
        events)``."""
        step = self._step_for((int(words.shape[0]), d), routed=routed,
                              micro_owner=owner)
        pin = self.mesh.lead.type == "cuda"
        with self._lock:
            if self._arrs is None:
                raise RuntimeError("multichip mirror not synced yet")
            with self.mesh.streams():
                res = step(words, lens, is_sys, self._arrs)
                host = _host_copy(res, pin)
                events = self.mesh.record()
        return res, host, events

    def dispatch(self, enc) -> McHandle:
        """One mesh dispatch of an encoded batch: the step and the copies
        of its outputs to the host are enqueued, and the returned
        :class:`McHandle` is read by :meth:`readback`.  Raises
        :class:`ShardDead` (a dead shard, or a shard whose launch raised)
        or :class:`~emqx_tpu_torch.faultinject.InjectedFault` at the
        ``match.shard`` / ``ep.route`` seams."""
        self._gate()
        words, lens, is_sys = enc
        b, d = int(words.shape[0]), int(words.shape[1])
        routed = self._routed_for(b)
        if routed:
            self._gate_ep()
        dead = (frozenset(int(x) for x in self._dead)
                if self.degraded_serving else None)
        owner = 0
        dead_rows: List[int] = []
        if dead is not None:
            if routed:
                # rows whose root owner is dead go to the host at readback
                dead_rows = self._dead_row_indices(words, lens, d, dead)
            else:
                # the micro merge point moves to the lowest live shard
                owner = min(x for x in range(self.tp) if x not in dead)
        try:
            res, host, events = self._launch(words, lens, is_sys, routed,
                                             owner, d)
        except ShardDead as e:
            self._shard_failed(e)
            raise
        meta = (dead, dead_rows) if dead is not None else None
        if dead is not None:
            self.degraded_batches += 1
            if self.metrics is not None:
                self.metrics.inc("tpu.mesh.degraded_batches")
                self.metrics.set("tpu.mesh.state", self.mesh_state())
        if self.degraded and self._fail_counts:
            # a dispatch that made it out clears the consecutive strikes
            self._fail_counts.clear()
        self.dispatches += 1
        if self.metrics is not None:
            self.metrics.inc("tpu.match.shard_dispatches")
        if routed:
            self.ep_dispatches += 1
            if self.ep_autotune:
                self._ep_shapes.add((b, d))
                self._note_root_load(words, lens, d)
            if self.metrics is not None:
                cap = self.ep_capacity(b)
                self.metrics.inc("tpu.match.ep_dispatches")
                self.metrics.set("tpu.match.ep_shard_width", self.tp * cap)
                # the routing all_to_all's bill: each shard ships
                # (tp-1)/tp of its (tp, C) grid, words + lens + is_sys +
                # src per slot
                self.metrics.inc(
                    "tpu.match.ep_ici_bytes",
                    self.dp * self.tp * (self.tp - 1) * cap * (d + 3) * 4)
        return McHandle(res, host, events, routed, meta)

    def _host_result(self, h: McHandle):
        """Wait for the handle's copies; its fields as numpy.  A device
        error surfaces here and counts as a failover."""
        try:
            for ev in h.events:
                ev.synchronize()
        except RuntimeError:
            self._note_failover()
            raise
        return [x.numpy() for x in h.host]

    def readback(self, h: McHandle, n: int):
        """Wait for a dispatch's host copies and decode the first ``n``
        rows to service accept-id rows: per-shard segments concatenate,
        rows flagged by the summed spill vectors go back to the host.
        Degraded serving masks the dead shards' replicated segments and
        adds the dead-owned routed rows to the spill set.  Returns
        ``(rows, spilled row indices, d2h bytes)``."""
        routed, meta = h.routed, h.meta
        ids, counts, _ov, nm, ao, mo = self._host_result(h)
        if meta is not None and not routed and counts.shape[1] == self.tp:
            # replicated scoped failover: the dead shards' segments
            # decode empty; the service fills in those shards' filters
            counts = np.array(counts)
            counts[:, sorted(meta[0])] = 0
        cap_row = ids.shape[1] // counts.shape[1]
        rows = decode_compact_rows(ids, counts, cap_row)[:n]
        out = [[int(a) for a in row if a >= 0] for row in rows]
        sp = (ao > 0) | (mo > 0)
        spilled = np.flatnonzero(sp[:n]).tolist()
        if routed and spilled and self.metrics is not None:
            self.metrics.inc("tpu.match.ep_overflow_rows", len(spilled))
        if routed and n:
            frac = len(spilled) / n
            self._ov_ewma += self.EP_OVERFLOW_ALPHA * (frac - self._ov_ewma)
            if self.metrics is not None:
                self.metrics.set("tpu.match.ep_overflow_ewma",
                                 round(self._ov_ewma, 6))
            if self._ov_ewma >= self.ep_overflow_warn > 0:
                if not self._ov_warned:
                    self._ov_warned = True
                    log.warning(
                        "EP bucket overflow EWMA %.3f crossed %.3f: a hot "
                        "root is skewing one owner shard (rows fail open "
                        "to the host)", self._ov_ewma, self.ep_overflow_warn)
            else:
                self._ov_warned = False
            self._class_readbacks += 1
            if self.ep_autotune:
                self._maybe_resize()
        if meta is not None and routed:
            extra = [r for r in meta[1] if r < n and not sp[r]]
            if extra:
                self.cpu_filled_rows += len(extra)
                if self.metrics is not None:
                    self.metrics.inc("tpu.mesh.cpu_filled_rows", len(extra))
                spilled = sorted(set(spilled).union(extra))
        nbytes = 4 * int(ids.size + counts.size + nm.size + ao.size
                         + mo.size)
        return out, spilled, nbytes

    def _dead_row_indices(self, words, lens, depth: int,
                          dead: frozenset) -> List[int]:
        """Routable rows whose root owner is dead, from the host
        ``word_owner`` map (the array the device routes by)."""
        wo = self._word_owner
        roots = np.clip(np.asarray(words)[:, 0], 0, len(wo) - 1)
        owners = wo[roots]
        routable = np.asarray(lens) <= depth
        return np.flatnonzero(
            routable & np.isin(owners, sorted(dead))).tolist()

    def _step_for(self, batch_shape: Tuple[int, int], routed: bool, *,
                  micro_owner: int = 0):
        cap = self.ep_capacity(batch_shape[0]) if routed else 0
        # kind: 0 replicated, 1 routed, 2 routed with the compact output
        compact = routed and self.ep_compact
        kind = (2 if compact else 1) if routed else 0
        key: Tuple[int, ...] = (int(batch_shape[0]), int(batch_shape[1]),
                                kind)
        if self.ep_autotune:
            # a class flip selects a new grid, never the old one
            key += (cap,)
        if micro_owner:
            key += (int(micro_owner),)
        fn = self._steps.get(key)
        if fn is None:
            fn = self._steps[key] = build_multichip_step(
                self.mesh, self.active_slots, self.max_matches,
                micro_matches=self.ep_micro_matches, routed=routed,
                capacity=cap, compact=compact, micro_owner=int(micro_owner))
        return fn

    def warm(self, batches=(64,), depths=None) -> None:
        """Build and load the hash-walk and route kernels (on the card)
        and run one empty dispatch per serve shape, so that no served batch waits on
        a compiler or a first launch; a no-op until the first apply."""
        if self._arrs is None:
            return
        if self.mesh.lead.type == "cuda":
            from ..ops import cuda_build

            cuda_build.build(["nfa_walk", "ep_route"])
        for b in batches:
            for d in (depths or (self.depth,)):
                enc = self.encode([], batch=b, depth=d)
                self.readback(self.dispatch(enc), 0)

    # ------------------------------------------------------------------
    # load-adaptive plane: capacity classes + popularity placement
    # ------------------------------------------------------------------

    def _note_root_load(self, words, lens, depth: int) -> None:
        """Per-root popularity counters: every routable row of a routed
        dispatch bumps its root (aged by halving at each balance pass).
        Lock-free: a lost bump skews a statistic, never an answer."""
        w = np.asarray(words)[:, 0]
        routable = (np.asarray(lens) <= depth) & (w > 0)
        if not routable.any():
            return
        if len(self._root_load) < len(self._word_owner):
            grown = np.zeros(len(self._word_owner), np.float64)
            grown[:len(self._root_load)] = self._root_load
            self._root_load = grown
        roots = np.clip(w[routable], 0, len(self._root_load) - 1)
        np.add.at(self._root_load, roots, 1.0)

    def _maybe_resize(self) -> None:
        """Capacity-class trigger (a routed readback): grow one pow2
        class when the overflow EWMA crosses the grow threshold; shrink
        one inside the hysteresis band after ``EP_SHRINK_COOLDOWN``
        readbacks at the class.  Deferred while any shard is dead."""
        if self._dead:
            return
        target = None
        if (self._ov_ewma >= self.ep_grow_threshold
                and self._cap_class < self.ep_max_cap_class):
            target = self._cap_class + 1
            shapes = list(self._ep_shapes)
            if shapes and all(
                    self.ep_capacity(b) >= max(1, (b // self.dp) // self.tp)
                    for b, _d in shapes):
                return   # already at the source-slice ceiling
        elif (self._cap_class > 0
              and self._class_readbacks >= self.EP_SHRINK_COOLDOWN
              and self._ov_ewma <= self.ep_shrink_threshold):
            target = self._cap_class - 1
        if target is not None:
            self._resize(target)

    def _resize(self, target: int) -> None:
        """Flip the capacity class (there is nothing to compile ahead: the
        next routed dispatch builds its grid at the new class).  A grow
        zeroes the EWMA, so that it measures the new grid, and re-arms
        the overflow warning."""
        grew = target > self._cap_class
        with self._lock:
            self._cap_class = target
            self._class_readbacks = 0
            if grew:
                self._ov_ewma = 0.0
                self._ov_warned = False
        self.ep_resizes += 1
        if self.metrics is not None:
            self.metrics.set("tpu.match.ep_cap_class", target)
            self.metrics.inc("tpu.match.ep_resizes")
        log.warning("EP bucket grid %s to capacity class %d (overflow "
                    "EWMA keyed)", "grew" if grew else "shrank", target)

    def plan_rebalance(self) -> int:
        """Greedy hot-root reassignment off the popularity slab (the
        service's ``table.compact`` cadence): moves the hottest
        improving root from the most- to the least-loaded shard, at most
        ``balance_budget`` times, and stages the result as an override
        map that the next ``rebuild()`` apply swaps in.  Stages nothing
        while any shard is dead; an injected ``ep.rebalance`` fault
        raises before anything is staged.  Returns the roots moved."""
        if not self.ep_autotune or self.tp < 2 or self.balance_budget <= 0:
            return 0
        if _fi._injector is not None:
            act = _fi._injector.act("ep.rebalance")
            if act == "raise":
                raise _fi.InjectedFault("ep.rebalance")
            if act == "delay":
                time.sleep(_fi._injector.last_delay)
        if self._dead:
            return 0
        with self._lock:
            load = self._root_load.copy()
            placement = dict(self._placement)
            vocab_items = list(self.vocab.items())
        self._root_load *= 0.5   # age: an EWMA at compaction cadence
        cand = [(w, wid) for w, wid in vocab_items
                if 0 < wid < len(load) and load[wid] > 0.0]
        if not cand:
            return 0
        owners: Dict[str, int] = {}
        loads: Dict[str, float] = {}
        for w, wid in cand:
            o = placement.get(w)
            if o is None:
                o = zlib.crc32(w.encode("utf-8")) % self.tp
            owners[w] = int(o)
            loads[w] = float(load[wid])
        from .prefix_ep import greedy_balance

        owners, moved = greedy_balance(loads, owners, self.tp,
                                       self.balance_budget)
        # the map keeps only roots off their crc32 default; overrides of
        # roots with no load this round persist
        new_place = {w: o for w, o in owners.items()
                     if o != zlib.crc32(w.encode("utf-8")) % self.tp}
        for w, o in placement.items():
            if w not in owners:
                new_place.setdefault(w, o)
        if new_place == placement:
            return 0
        with self._lock:
            self._placement_next = new_place
        self.ep_rebalances += 1
        self.moved_roots = moved
        if self.metrics is not None:
            self.metrics.inc("tpu.match.ep_rebalances")
            self.metrics.set("tpu.match.ep_moved_roots", moved)
        log.info("EP balance pass staged %d root move(s) (%d override(s) "
                 "total); the next rebuild applies", moved, len(new_place))
        return moved

    # ------------------------------------------------------------------
    # online shard rebuild + canary re-admit (degraded mesh)
    # ------------------------------------------------------------------

    def canary_topics(self, t: int, cap: int = 64) -> List[str]:
        """Topics made from shard ``t``'s own filters (each wildcard
        level a literal token), so the canary batch walks exactly the
        rebuilt subtable."""
        return ["/".join(w if w not in ("+", "#") else "c"
                         for w in T.words(flt))
                for flt in list(self._filters[int(t)])[:cap]]

    def canary_rows(self, topics: Sequence[str], batch: int,
                    readmit: int) -> Tuple[List[List[int]], List[int]]:
        """Dispatch a canary batch with shard ``readmit`` treated live
        (other dead shards stay masked or diverted): the bit-parity probe
        that gates re-admission.  Counters, the ladder and the gates are
        left alone."""
        enc = self.encode(topics, batch=batch)
        words, lens, is_sys = enc
        b, d = int(words.shape[0]), int(words.shape[1])
        routed = self._routed_for(b)
        dead = frozenset(int(x) for x in self._dead
                         if int(x) != int(readmit))
        owner = 0
        dead_rows: List[int] = []
        if dead:
            if routed:
                dead_rows = self._dead_row_indices(words, lens, d, dead)
            else:
                owner = min(x for x in range(self.tp) if x not in dead)
        _res, host, events = self._launch(words, lens, is_sys, routed,
                                          owner, d)
        for ev in events:
            ev.synchronize()
        ids, counts, _ov, _nm, ao, mo = (x.numpy() for x in host)
        if dead and not routed and counts.shape[1] == self.tp:
            counts = np.array(counts)
            counts[:, sorted(dead)] = 0
        cap_row = ids.shape[1] // counts.shape[1]
        n = len(topics)
        rows = decode_compact_rows(ids, counts, cap_row)[:n]
        out = [[int(a) for a in row if a >= 0] for row in rows]
        sp = (ao > 0) | (mo > 0)
        spilled = set(np.flatnonzero(sp[:n]).tolist())
        spilled.update(r for r in dead_rows if r < n)
        return out, sorted(spilled)

    def rebuild_shard(self, t: int, pairs: List[Tuple[str, int]],
                      segments_dir: Optional[str] = None,
                      expect_epoch: Optional[int] = None) -> float:
        """Reconstruct shard ``t``'s subtable (seeded from its
        epoch-guarded segment when one matches, then a replay of the
        service's ``pairs`` converges it on the live filters) and
        restack.  Does not re-admit: the caller runs the canary first.
        Returns the wall seconds; an injected ``mesh.rebuild`` fault
        raises."""
        if _fi._injector is not None:
            act = _fi._injector.act("mesh.rebuild")
            if act == "raise":
                raise _fi.InjectedFault("mesh.rebuild")
            if act == "delay":
                time.sleep(_fi._injector.last_delay)
        t = int(t)
        t0 = time.perf_counter()
        want = {flt: aid for flt, aid in pairs
                if not is_micro_filter(flt) and self.shard_of(flt) == t}
        with self._maint_lock:
            seeded = self._seg_seed_filters(t, segments_dir, expect_epoch)
            sub = self._new_sub()
            seed_flts = list(seeded or ())
            if self.native:
                # replay the shared vocab in id order first, so the fresh
                # table assigns identical word ids
                sub.bulk_intern([w for w, _i in sorted(
                    self.vocab.items(), key=lambda kv: kv[1])])
                sub.bulk_add(seed_flts)
            else:
                for f in seed_flts:
                    sub.add(f)
            # delta-tail replay: adds since the snapshot, then removes of
            # filters the service no longer holds
            for f in want:
                if seeded is None or f not in seeded:
                    sub.add(f)
            for f in seed_flts:
                if f not in want:
                    sub.remove(f)
            if self.native:
                self._adopt_vocab_tail(sub)
            amap = np.full(max(64, sub.n_filters + 1), -1, np.int32)
            for flt, aid in want.items():
                laid = sub.aid_of(flt)
                if laid < 0:
                    raise RuntimeError(f"rebuilt filter missing: {flt!r}")
                amap = self._grow_map(amap, laid)
                amap[laid] = aid
            self._subs[t] = sub
            self._aid_maps[t] = amap
            self._filters[t] = dict(want)
            self._restack()
        dt = time.perf_counter() - t0
        self.rebuilds += 1
        if self.metrics is not None:
            self.metrics.set("tpu.mesh.rebuild_s", round(dt, 6))
        log.warning("mesh shard %d rebuilt (%d filters, %s seed) in %.3fs "
                    "— canary gates re-admission", t, len(want),
                    "segment" if seeded is not None else "full", dt)
        return dt

    def _adopt_vocab_tail(self, sub) -> None:
        """Words a table's ``bulk_add`` warm probe interned past the
        shared sequence join the shared vocab and every other table
        (ids append from one prefix, so every vocab stays identical)."""
        extra = [(w, i) for w, i in sub.vocab.items() if w not in self.vocab]
        for w, _i in sorted(extra, key=lambda kv: kv[1]):
            self.vocab[w] = len(self.vocab) + 1
            for tbl in self._all_tables():
                if tbl is not sub:
                    tbl.intern(w)

    def _manifest_ok(self, meta: dict, expect_epoch: int) -> bool:
        return (meta.get("version") == self.MANIFEST_VERSION
                and meta.get("tp") == self.tp
                and meta.get("depth") == self.depth
                and meta.get("native") == bool(self.native)
                and meta.get("epoch") == int(expect_epoch))

    def _read_manifest(self, d: str, expect_epoch: int):
        """``(meta, arrays)`` of the manifest in ``d`` when its version,
        layout, epoch and checksum hold, else None."""
        with open(os.path.join(d, "manifest.json")) as f:
            meta = json.load(f)
        if not self._manifest_ok(meta, expect_epoch):
            return None
        with np.load(os.path.join(d, "aid_maps.npz")) as npz:
            arrays = {k: npz[k] for k in npz.files}
        core = {k: meta[k] for k in
                ("version", "epoch", "tp", "depth", "native")}
        if meta.get("checksum") != self._manifest_checksum(core, arrays):
            log.warning("multichip manifest checksum mismatch; "
                        "repartition serves")
            return None
        return meta, arrays

    def _seg_seed_filters(self, t: int, segments_dir: Optional[str],
                          expect_epoch: Optional[int],
                          ) -> Optional[Dict[str, int]]:
        """Shard ``t``'s persisted (filter → service aid) snapshot iff the
        manifest's epoch, shape, checksum and placement still match (the
        rebuild seed); else None."""
        if segments_dir is None or expect_epoch is None:
            return None
        from ..storage.segments import load_segment

        d = self._seg_dir(segments_dir)
        try:
            got = self._read_manifest(d, expect_epoch)
            if got is None:
                return None
            _meta, arrays = got
            seg = load_segment(os.path.join(d, f"shard{t}.seg.npz"))
            if seg.depth != self.depth:
                return None
            if seg.meta.get("placement_crc") != self._place_crc(
                    self._placement):
                # cut under another placement: not this shard's filters
                return None
            if seg.kind == "filters":
                sa = np.asarray(arrays[f"sa{t}"], np.int32)
                if len(sa) != len(seg.filters):
                    return None
                return dict(zip(seg.filters, sa.tolist()))
            amap = np.asarray(arrays[f"m{t}"], np.int32)
            return {f: int(amap[aid]) for aid, f in
                    enumerate(seg.accept_filters or [])
                    if f is not None and aid < len(amap) and amap[aid] >= 0}
        except Exception:
            log.warning("mesh rebuild segment seed unavailable; full "
                        "rebuild from service state", exc_info=True)
            return None

    # ------------------------------------------------------------------
    # per-shard segment persistence (with match.segments.enable)
    # ------------------------------------------------------------------

    @staticmethod
    def _seg_dir(segments_dir: str) -> str:
        return os.path.join(segments_dir, "multichip")

    @staticmethod
    def _place_crc(place: Dict[str, int]) -> int:
        """crc32 of a placement override map, stamped into every
        per-shard segment's checksummed meta: a shard file cut under
        another placement than the manifest's is refused."""
        return zlib.crc32(json.dumps(
            sorted(place.items()), separators=(",", ":")).encode("utf-8"))

    def save_segments(self, segments_dir: str, epoch: int) -> None:
        """Persist every shard subtable and the micro-table (native
        tables as ``filters`` segments, Python tables as ``state``
        segments) and a checksummed manifest with the service-table
        epoch, the shared vocab in id order, the per-filter service aids,
        the local→service aid maps and the placement map."""
        with self._maint_lock:
            self._save_segments_locked(segments_dir, epoch)

    def _save_segments_locked(self, segments_dir: str, epoch: int) -> None:
        from ..storage.segments import save_segment

        d = self._seg_dir(segments_dir)
        os.makedirs(d, exist_ok=True)
        pcrc = self._place_crc(self._placement)
        arrays: Dict[str, np.ndarray] = {}
        for t, sub in enumerate(self._subs):
            flts = list(self._filters[t])
            save_segment(os.path.join(d, f"shard{t}.seg.npz"), sub,
                         deep={}, routing_aids=set(), filters=flts,
                         extra_meta={"placement_crc": pcrc})
            arrays[f"m{t}"] = np.asarray(self._aid_maps[t], np.int32)
            arrays[f"sa{t}"] = np.asarray(
                [self._filters[t][f] for f in flts], np.int32)
        mflts = list(self._micro_filters)
        save_segment(os.path.join(d, "micro.seg.npz"), self._micro,
                     deep={}, routing_aids=set(), filters=mflts,
                     extra_meta={"placement_crc": pcrc})
        arrays["mm"] = np.asarray(self._micro_amap, np.int32)
        arrays["sam"] = np.asarray(
            [self._micro_filters[f] for f in mflts], np.int32)
        # the shared vocab in id order (NUL-framed), replayed first on a
        # restore so every fresh vocab assigns the same ids
        words = [w for w, _i in sorted(self.vocab.items(),
                                       key=lambda kv: kv[1])]
        arrays["vw"] = np.frombuffer(
            "\x00".join(words).encode("utf-8"), np.uint8).copy()
        proots = sorted(self._placement)
        arrays["pr"] = (np.frombuffer(
            "\x00".join(proots).encode("utf-8"), np.uint8).copy()
            if proots else np.zeros(0, np.uint8))
        arrays["ps"] = np.asarray(
            [self._placement[w] for w in proots], np.int32)
        meta = {"version": self.MANIFEST_VERSION, "epoch": int(epoch),
                "tp": self.tp, "depth": self.depth,
                "native": bool(self.native)}
        digest = self._manifest_checksum(meta, arrays)
        np.savez(os.path.join(d, "aid_maps.npz"), **arrays)
        # the manifest lands last (an atomic replace is the commit point)
        tmp = os.path.join(d, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump({**meta, "checksum": digest}, f, sort_keys=True)
        os.replace(tmp, os.path.join(d, "manifest.json"))
        self._persist_due = False

    @staticmethod
    def _manifest_checksum(meta: dict, maps: Dict[str, np.ndarray]) -> str:
        import hashlib

        h = hashlib.sha1(json.dumps(meta, sort_keys=True).encode())
        for k in sorted(maps):
            h.update(k.encode())
            h.update(np.ascontiguousarray(maps[k]).tobytes())
        return h.hexdigest()

    def _restore_sub(self, seg, arrays, sa_key: str):
        """One subtable and its (filter → service aid) dict from a
        segment: native replays the filter list through ``bulk_add`` and
        rebuilds the aids with ``aid_of``; Python restores the state."""
        from ..storage.segments import restore_incremental

        if seg.kind == "filters":
            if not self.native:
                raise ValueError("filters-kind segment without native")
            sub = self._new_sub()
            sub.bulk_intern(self._restored_words)
            flts = list(seg.filters)
            sub.bulk_add(flts)
            sa = np.asarray(arrays[sa_key], np.int32)
            if len(sa) != len(flts):
                raise ValueError("service-aid array length mismatch")
            amap = np.full(max(64, sub.n_filters + 1), -1, np.int32)
            fdict: Dict[str, int] = {}
            for f, service_aid in zip(flts, sa.tolist()):
                laid = sub.aid_of(f)
                if laid < 0:
                    raise ValueError(f"restored filter missing: {f!r}")
                amap = self._grow_map(amap, laid)
                amap[laid] = service_aid
                fdict[f] = service_aid
            return sub, amap, fdict
        if seg.kind != "state" or self.native:
            raise ValueError(f"unexpected segment kind {seg.kind!r}")
        sub = restore_incremental(seg)
        amap_key = "m" + sa_key[2:] if sa_key.startswith("sa") else "mm"
        amap = np.asarray(arrays[amap_key], np.int32)
        fdict = {}
        for f in sub.filters():
            laid = sub.aid_of(f)
            if 0 <= laid < len(amap) and amap[laid] >= 0:
                fdict[f] = int(amap[laid])
        return sub, amap, fdict

    def load_segments(self, segments_dir: str, expect_epoch: int) -> bool:
        """Cold start: restore the partition from the per-shard segments
        iff the manifest's service epoch matches the restored main table
        (else the caller repartitions).  True when seeded."""
        from ..storage.segments import load_segment

        d = self._seg_dir(segments_dir)
        try:
            got = self._read_manifest(d, expect_epoch)
            if got is None:
                return False
            _meta, arrays = got
            self._restored_words = (
                bytes(np.asarray(arrays["vw"], np.uint8))
                .decode("utf-8").split("\x00")
                if len(arrays.get("vw", ())) else [])
            place: Dict[str, int] = {}
            if len(arrays.get("pr", ())):
                proots = (bytes(np.asarray(arrays["pr"], np.uint8))
                          .decode("utf-8").split("\x00"))
                powners = np.asarray(arrays["ps"], np.int32).tolist()
                if len(proots) != len(powners) or any(
                        not 0 <= o < self.tp for o in powners):
                    log.warning("multichip placement map malformed; "
                                "repartition serves")
                    return False
                place = dict(zip(proots, powners))
            pcrc = self._place_crc(place)
            subs, amaps, fdicts = [], [], []
            for t in range(self.tp):
                seg = load_segment(os.path.join(d, f"shard{t}.seg.npz"))
                if seg.depth != self.depth:
                    return False
                if seg.meta.get("placement_crc") != pcrc:
                    log.warning("multichip shard %d segment placement "
                                "skew; repartition serves", t)
                    return False
                sub, amap, fdict = self._restore_sub(seg, arrays, f"sa{t}")
                subs.append(sub)
                amaps.append(amap)
                fdicts.append(fdict)
            mseg = load_segment(os.path.join(d, "micro.seg.npz"))
            if mseg.depth != self.depth:
                return False
            if mseg.meta.get("placement_crc") != pcrc:
                log.warning("multichip micro segment placement skew; "
                            "repartition serves")
                return False
            micro, micro_amap, micro_fdict = self._restore_sub(
                mseg, arrays, "sam")
        except FileNotFoundError:
            return False
        except Exception:
            log.warning("multichip segment load failed; repartition "
                        "serves", exc_info=True)
            return False
        if self.native:
            # every table replayed one sequence (and the same warm-probe
            # tail): adopt one table's vocab as the shared encode vocab
            vocab = dict(subs[0].vocab)
        else:
            vocab = subs[0].vocab
        for tbl in [*subs[1:], micro]:
            if tbl.vocab != vocab:
                log.warning("multichip shard vocabs diverged; "
                            "repartition serves")
                return False
            if not self.native:
                tbl.vocab = vocab
        with self._lock:
            self.vocab = vocab
            self._subs = subs
            self._aid_maps = amaps
            self._filters = fdicts
            self._micro = micro
            self._micro_amap = micro_amap
            self._micro_filters = micro_fdict
            # the restored partition was saved under exactly this map
            self._placement = place
            self._placement_next = None
            self._word_owner = np.zeros(1024, np.int32)
            self._word_owner_n = 0
            self._pending = []
            self._rebuild_pairs = None
            self._restack_due = True
            self._arrs = None
        self.seeded_from_segments = True
        return True

    def info(self) -> dict:
        return {
            "devices": self.n_devices,
            "mesh": {"dp": self.dp, "tp": self.tp},
            "ready": self.ready,
            "native": self.native,
            "ep": self.ep,
            "ep_compact": self.ep_compact,
            "gen": self.gen,
            "dispatches": self.dispatches,
            "ep_dispatches": self.ep_dispatches,
            "failovers": self.failovers,
            "applies": self.applies,
            "restacks": self.restacks,
            "dead_shards": sorted(self._dead),
            "shard_filters": [sub.n_filters for sub in self._subs],
            "micro_filters": len(self._micro_filters),
            "seeded_from_segments": self.seeded_from_segments,
            "degraded": self.degraded,
            "mesh_state": ("healthy", "degraded",
                           "cpu-only")[self.mesh_state()],
            "fail_counts": {str(t): c for t, c in
                            sorted(self._fail_counts.items())},
            "degraded_batches": self.degraded_batches,
            "cpu_filled_rows": self.cpu_filled_rows,
            "rebuilds": self.rebuilds,
            "readmit_canary_fails": self.readmit_canary_fails,
            "ep_overflow_ewma": round(self._ov_ewma, 6),
            "ep_autotune": self.ep_autotune,
            "ep_cap_class": self._cap_class,
            "ep_resizes": self.ep_resizes,
            "ep_rebalances": self.ep_rebalances,
            "placement_overrides": len(self._placement),
        }
