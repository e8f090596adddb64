"""Device twin of a host table (``IncrementalNfa`` or ``NativeNfa``).

The port of ``emqx_tpu/ops/device_table.py``'s ``DeviceNfa``: the host
table is the authority, and this class keeps the resident device copy
fresh.  ``drain()`` flushes the host's dirty rows into a stable
:class:`PendingSync`; ``apply_pending()`` writes them into the resident
tables in place (one ``index_copy_`` per table) or, after the host table
grew, uploads the tables whole.  ``match()`` runs the walk of the
``hash`` backend, or of ``join`` / ``join-pallas`` once
:meth:`DeviceNfa.enable_join` mirrors the sorted edge relation
(``join_match.JoinRelation``) beside the tables: its upkeep rides the
same drain/apply cycle (tombstones, revivals and overlay rows written in
place per delta; the relation sorted anew on the device, from the
uploaded or updated edge table, on a table upload or when the overlay
fills).

A lock serialises the swap and the in-place writes of an apply with
dispatches, so a reader never sees a half-applied (node, edge) pair;
the sorts and whole uploads run before it, outside the lock, so they
never stall a dispatch.  :meth:`arrays` returns one consistent
tuple.

With ``dirty_regions`` (the segments mode, over a Python table in
``track_regions`` mode) a resize grows the device tables in place: the
node table is padded on the card with ``[-1, -1, -1, 0]`` rows, the
edge table and seeds are swapped for the shipped ones when the cuckoo
table rehashed, and the dirty rows are written with ``index_copy_``,
all on the current stream, into new tensors (a walk in flight keeps
the old ones); a delta dirtier than ``dirty_full_threshold`` of the
rows uploads whole.  The result is bit-equal to a whole upload of the
same host table.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .incremental import NfaDelta
from .join_match import JoinRelation, OverlayFull, join_match, relation_arrays
from .match_kernel import MatchResult, nfa_match

__all__ = ["BACKENDS", "JOIN_BACKENDS", "DeviceNfa", "PendingSync",
           "check_backend", "resolve_device"]

#: the walk backends ``DeviceNfa.match`` serves; both join names run the
#: one join kernel
JOIN_BACKENDS = ("join", "join-pallas")
BACKENDS = ("hash",) + JOIN_BACKENDS


def check_backend(backend: str) -> None:
    """Raise unless ``backend`` is one that ``DeviceNfa.match`` serves:
    NotImplementedError for ``auto`` (the measured per-shape pick, which
    ``MatchService`` resolves to a concrete backend before it calls
    ``match``), ValueError for a name it does not know."""
    if backend == "auto":
        raise NotImplementedError(
            "DeviceNfa.match takes a concrete backend: 'auto' is resolved "
            "per dispatch shape by MatchService")
    if backend not in BACKENDS:
        raise ValueError(f"unknown match backend {backend!r}")


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """The device the port runs on: CUDA unless the caller names another.
    Raises when CUDA is wanted (by default or by name) and absent."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


class PendingSync(NamedTuple):
    """Drained host state: stable copies, never views of the live table."""

    delta: Optional[NfaDelta]          # in-place row write path
    full: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]  # re-upload
    shape_key: Tuple[int, int, int]
    epoch: int
    # grow in place: a rehashed edge table ships whole, with the fresh
    # seeds it was placed with (the old pair would miss every lookup)
    edge_full: Optional[np.ndarray] = None
    seeds_full: Optional[np.ndarray] = None


class DeviceNfa:
    """Resident device mirror: ``sync()`` after host mutations,
    ``match()`` to evaluate an encoded batch."""

    def __init__(self, inc, active_slots: int = 16, max_matches: int = 32,
                 device: Union[None, str, torch.device] = None,
                 lazy: bool = False) -> None:
        self.device = resolve_device(device)
        self.inc = inc
        self.active_slots = active_slots
        self.max_matches = max_matches
        self.epoch = -1
        self.uploads = 0        # whole-table uploads (first sync / growth)
        self.delta_applies = 0  # in-place row-write batches
        # grow in place (module docstring): off unless the host table
        # tracks regions; above dirty_full_threshold (dirty rows over all
        # rows) a resize uploads whole
        self.dirty_regions = False
        self.dirty_full_threshold = 0.5
        self.grow_applies = 0           # resizes grown in place
        self.dirty_rows_uploaded = 0    # rows written by deltas and grows
        self._shape_key = None
        self._arrs: Optional[Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]] = None
        # the join relation mirror (off until enable_join)
        self.join_enabled = False
        self._join: Optional[JoinRelation] = None    # host relation
        self._jarrs: Optional[Tuple[torch.Tensor, ...]] = None  # on device
        self.join_rebuilds = 0      # whole relation uploads
        # a segment's relation: (epoch, shape key, arrays), taken at the
        # next whole upload when the epoch and shape still match
        self._join_seed = None
        # _lock: a dispatch against the swap of an apply; _apply_lock:
        # one apply at a time (its slow half runs outside _lock)
        self._lock = threading.Lock()
        self._apply_lock = threading.Lock()
        # freed accept ids stay unused until the device acks their epoch,
        # and while a batch holds them (hold_ids); _ack_lock orders an
        # ack on a worker thread against a hold on the event loop
        self._id_holds = 0
        self._ack_lock = threading.Lock()
        inc.device_epoch = -1
        if not lazy:
            self.sync(full=True)

    # -- mirror maintenance ------------------------------------------------

    def _put(self, arr: np.ndarray, staged: bool = False) -> torch.Tensor:
        """A device tensor that owns a copy of ``arr``.  ``staged`` (for
        the small operands of a batch or a delta): on the card the copy
        goes through pinned host memory and is enqueued on the current
        stream without waiting for it, where a copy from pageable memory
        waits for every launch queued before it."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if staged and self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device, copy=True)

    def arrays(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(node_tab, edge_tab, seeds) — one consistent epoch's view."""
        arrs = self._arrs
        if arrs is None:
            raise RuntimeError("DeviceNfa not synced yet (lazy init)")
        return arrs

    @property
    def table_bytes(self) -> int:
        """Device bytes of the resident tables, the join relation
        included when it is mirrored."""
        return sum(a.numel() * a.element_size()
                   for a in self.arrays() + (self._jarrs or ()))

    def drain(self, full: bool = False) -> PendingSync:
        """Flush host dirty state into a stable :class:`PendingSync`:
        O(delta), or a copy of the whole table when it must be uploaded
        (first sync, growth, ``full``)."""
        delta = self.inc.flush()
        key = self.inc.shape_key()
        if not full and delta.resized and self._grow_ok(delta):
            rehash = delta.edges_rehashed or key[1] != self._shape_key[1]
            return PendingSync(
                delta=delta, full=None, shape_key=key, epoch=delta.epoch,
                edge_full=self.inc.edge_tab.copy() if rehash else None,
                seeds_full=self.inc.seeds.copy() if rehash else None)
        if full or delta.resized or self._shape_key != key:
            if hasattr(self.inc, "tables"):     # native table: one export
                tabs = self.inc.tables()
            else:
                tabs = (self.inc.node_tab.copy(), self.inc.edge_tab.copy(),
                        self.inc.seeds.copy())
            return PendingSync(delta=None, full=tabs, shape_key=key,
                               epoch=self.inc.epoch)
        return PendingSync(delta=delta, full=None, shape_key=key,
                           epoch=delta.epoch)

    def _grow_ok(self, delta: NfaDelta) -> bool:
        """Whether a resized delta may grow the tables in place: the mode
        on, a synced twin whose node rows are the delta's valid prefix,
        the same depth, and a dirty share of the rows under
        ``dirty_full_threshold``."""
        if not self.dirty_regions or self._shape_key is None \
                or self._arrs is None:
            return False
        if delta.node_grown_from < 0 \
                or delta.node_grown_from != self._shape_key[0]:
            return False
        key = self.inc.shape_key()
        if key[2] != self._shape_key[2]:
            return False
        n_dirty = len(delta.state_idx) + len(delta.bucket_idx)
        return n_dirty <= self.dirty_full_threshold * (key[0] + key[1])

    def apply_pending(self, p: PendingSync) -> bool:
        """Ship a drained sync to the device.  The slow half runs
        outside the dispatch lock: whole tables and a rebuilt join
        relation are sorted and uploaded into new tensors while
        :meth:`match` goes on walking the old ones; under the lock the
        new tensors are swapped in and the row deltas written in place,
        so a walk sees one epoch or the next.  On any failure the mirror
        is dropped, so the next ``drain()`` uploads the tables whole and
        matches fail until then."""
        with self._apply_lock:
            try:
                staged = self._stage(p)
                with self._lock:
                    return self._commit(p, staged)
            except Exception:
                with self._lock:
                    self._arrs = None
                    self._shape_key = None
                    self._join = None       # rebuilt with the next upload
                    self._jarrs = None
                raise

    def _stage(self, p: PendingSync):
        """The device tensors of ``p``, made without the dispatch lock:
        ``(tables, relation, relation tensors)`` of a whole upload, or
        ``(row writes, relation writes, rebuilt relation tensors)`` of a
        delta.  Only the apply path touches the host relation."""
        if p.full is not None:
            arrs = tuple(self._put(a) for a in p.full)
            if not self.join_enabled:
                return arrs, None, None
            seed, self._join_seed = self._join_seed, None
            if seed is not None and seed[0] == p.epoch \
                    and tuple(seed[1]) == tuple(p.shape_key):
                try:
                    join = JoinRelation(int(p.full[0].shape[0]), p.full[1],
                                        arrays=seed[2])
                    return arrs, join, tuple(self._put(a)
                                             for a in join.arrays())
                except ValueError:
                    pass        # a malformed seed: sorted anew below
            return (arrs,) + self._relation_of(int(p.full[0].shape[0]),
                                               arrs[1], p.full[1])
        d = p.delta
        if d.empty:
            return None
        if d.resized:
            return self._stage_grow(p)
        # (position in the tensor tuple, rows, values): node and edge
        # table rows; edge_next entries and overlay rows of the relation
        rows = [(k, self._put(idx, True).long(), self._put(val, True))
                for k, idx, val in ((0, d.state_idx, d.state_rows),
                                    (1, d.bucket_idx, d.bucket_rows))
                if len(idx)]
        if not (self.join_enabled and self._join is not None):
            return rows, None, None
        try:
            mpos, mval, opos, orows = self._join.apply_bucket_delta(
                d.bucket_idx, d.bucket_rows)
        except OverlayFull:
            # rebuilt whole: sorted on the device from a copy of the edge
            # table with this delta's rows written in (the host shadow
            # is already updated, and takes the sorted arrays)
            edge = self._arrs[1].clone()
            for k, idx, val in rows:
                if k == 1:
                    edge.index_copy_(0, idx, val)
            start, word, nxt = relation_arrays(
                len(self._join.state_start) - 1, edge)
            self._join.adopt(*(a.to("cpu", copy=True).numpy()
                               for a in (start, word, nxt)))
            return rows, None, (start, word, nxt,
                                self._put(self._join.overlay))
        jrows = [(k, self._put(idx, True).long(), self._put(val, True))
                 for k, idx, val in ((2, mpos, mval), (3, opos, orows))
                 if len(idx)]
        return rows, jrows, None

    def _stage_grow(self, p: PendingSync):
        """The new tensors of a grow in place (module docstring), made
        on the current stream from the resident ones, which stay as
        they are for a walk in flight: ``(tables, relation tensors,
        whether the relation was rebuilt whole)``."""
        d = p.delta
        node, edge, seeds = self._arrs
        target_s, target_hb, _depth = p.shape_key
        if int(node.shape[0]) != d.node_grown_from:
            # a missed sync: the caller drops the mirror, and the next
            # drain uploads whole
            raise RuntimeError(
                f"grow in place: device S={int(node.shape[0])} != host "
                f"prefix {d.node_grown_from}")
        grow = target_s - int(node.shape[0])
        if grow > 0:
            pad = torch.tensor([-1, -1, -1, 0], dtype=node.dtype,
                               device=node.device).expand(grow, 4)
            node = torch.cat([node, pad])
        else:
            node = node.clone()
        if p.edge_full is not None:
            edge = self._put(p.edge_full, True)
            seeds = self._put(p.seeds_full, True)
        elif int(edge.shape[0]) != target_hb:
            raise RuntimeError(
                f"grow in place: device Hb={int(edge.shape[0])} != host "
                f"{target_hb} with no rehashed table shipped")
        else:
            edge = edge.clone()
        for k, idx, val in ((0, d.state_idx, d.state_rows),
                            (1, d.bucket_idx, d.bucket_rows)):
            if len(idx):
                (node, edge)[k].index_copy_(
                    0, self._put(idx, True).long(), self._put(val, True))
        jarrs, rebuilt = None, False
        if self.join_enabled and self._join is not None:
            if p.edge_full is not None:
                # a rehash moved the relation's capacity with Hb
                self._join.rebuild(target_s, p.edge_full)
                jarrs = tuple(self._put(a, True)
                              for a in self._join.arrays())
                rebuilt = True
            else:
                self._join.grow_states(target_s)
                ss, ew, en, ov = self._jarrs
                extra = target_s + 1 - int(ss.shape[0])
                if extra > 0:
                    # new states have no CSR segment: the offsets go on
                    # with their terminal value, padded on the card
                    ss = torch.cat([ss, ss[-1:].expand(extra)])
                en, ov = en.clone(), ov.clone()
                try:
                    mpos, mval, opos, orows = self._join.apply_bucket_delta(
                        d.bucket_idx, d.bucket_rows)
                    for t, idx, val in ((en, mpos, mval), (ov, opos, orows)):
                        if len(idx):
                            t.index_copy_(0, self._put(idx, True).long(),
                                          self._put(val, True))
                except OverlayFull:
                    self._join.rebuild(target_s)
                    ss, ew, en, ov = (self._put(a, True)
                                      for a in self._join.arrays())
                    rebuilt = True
                jarrs = (ss, ew, en, ov)
        return (node, edge, seeds), jarrs, rebuilt

    def _commit(self, p: PendingSync, staged) -> bool:
        """Under the dispatch lock: swap in or write what :meth:`_stage`
        made, and ack the epoch."""
        if p.full is not None:
            arrs, join, jarrs = staged
            self._arrs = arrs
            self._shape_key = p.shape_key
            self.uploads += 1
            if join is not None:
                self._join, self._jarrs = join, jarrs
                self.join_rebuilds += 1
            self._ack(p.epoch)
            return True
        if staged is None:
            self._ack(max(self.epoch, p.epoch))
            return False
        d = p.delta
        if d.resized:
            self._arrs, jarrs, rebuilt = staged
            self._shape_key = p.shape_key
            if jarrs is not None:
                self._jarrs = jarrs
            self.join_rebuilds += rebuilt
            self.grow_applies += 1
            self.dirty_rows_uploaded += len(d.state_idx) + len(d.bucket_idx)
            self._ack(d.epoch)
            return True
        rows, jrows, jarrs = staged
        for k, idx, val in rows:
            self._arrs[k].index_copy_(0, idx, val)
        if jarrs is not None:
            self._jarrs = jarrs
            self.join_rebuilds += 1
        for k, idx, val in jrows or ():
            self._jarrs[k].index_copy_(0, idx, val)
        self.delta_applies += 1
        self.dirty_rows_uploaded += (len(d.state_idx) + len(d.bucket_idx)
                                     + sum(len(idx) for _k, idx, _v
                                           in jrows or ()))
        self._ack(d.epoch)
        return True

    def _ack(self, epoch: int) -> None:
        with self._ack_lock:
            self.epoch = epoch
            if not self._id_holds:
                self.inc.device_epoch = epoch

    def hold_ids(self) -> None:
        """Keep every freed accept id unused until the matching
        :meth:`release_ids`: the rows of a batch walked before an id was
        freed may still name it, and a reuse would hand them the new
        filter.  New filters take fresh ids meanwhile."""
        with self._ack_lock:
            self._id_holds += 1
            self.inc.device_epoch = -1      # attached, nothing acked

    def release_ids(self) -> None:
        """Lift one :meth:`hold_ids`; after the last, the ids freed up
        to the acked epoch are reusable again."""
        with self._ack_lock:
            self._id_holds -= 1
            if not self._id_holds:
                self.inc.device_epoch = self.epoch

    def sync(self, full: bool = False) -> bool:
        """Drain + apply in one call."""
        return self.apply_pending(self.drain(full=full))

    # -- join relation mirror ----------------------------------------------

    def enable_join(self, seed: Optional[JoinRelation] = None,
                    segment_seed: Optional[tuple] = None) -> None:
        """Mirror the sorted edge relation beside the tables, so that
        ``match`` serves the join backends.  On a synced twin the
        relation is ``seed`` (one built elsewhere on the same table,
        mirrored as it is) or is built now from the device copy of the
        edge table; otherwise it is built at the first upload, and a
        ``seed`` is refused.  ``segment_seed`` (``(epoch, shape key,
        (state_start, edge_word, edge_next))`` of a segment) is taken
        at the next whole upload when its epoch and shape still match
        the table's, instead of a sort."""
        with self._apply_lock:
            self.join_enabled = True
            self._join_seed = segment_seed
            if self._arrs is None:
                if seed is not None:
                    raise ValueError("a seed relation needs a synced twin")
                return
            if seed is not None:
                jarrs = tuple(self._put(a) for a in seed.arrays())
            elif self._jarrs is not None:
                return          # already mirrored
            else:
                node, edge, _seeds = self._arrs
                seed, jarrs = self._relation_of(int(node.shape[0]), edge,
                                                edge.cpu().numpy())
            with self._lock:
                self._join, self._jarrs = seed, jarrs
                self.join_rebuilds += 1

    def _relation_of(self, s: int, edge: torch.Tensor, shadow: np.ndarray):
        """``(host relation, its device tensors)`` of device edge table
        ``edge`` over ``s`` states, sorted on the device; ``shadow`` is
        the table's host copy."""
        start, word, nxt = relation_arrays(s, edge)
        join = JoinRelation(s, shadow, arrays=tuple(
            a.cpu().numpy() for a in (start, word, nxt)))
        return join, (start, word, nxt, self._put(join.overlay))

    # -- serving -----------------------------------------------------------

    def match(self, words, lens, is_sys, *, flat_cap: int = 0,
              backend: Optional[str] = None) -> MatchResult:
        """Run the walk on already-encoded device operands: the flat
        output when ``flat_cap`` > 0, else the compact one.  ``backend``
        is ``hash`` (default: the cuckoo-probe walk) or ``join`` /
        ``join-pallas`` (both the join walk, at every batch shape and
        output mode).  A join backend without the relation mirror
        raises, where the reference quietly serves ``hash``; ``auto``
        (the measured per-shape pick, which ``MatchService`` resolves)
        raises NotImplementedError."""
        be = backend or "hash"
        check_backend(be)
        with self._lock:
            node, edge, seeds = self.arrays()
            kw = dict(active_slots=self.active_slots,
                      max_matches=self.max_matches, flat_cap=flat_cap)
            if be == "hash":
                return nfa_match(words, lens, is_sys, node, edge, seeds, **kw)
            if self._jarrs is None:
                raise RuntimeError(
                    f"backend {be!r} needs the join relation mirror: "
                    "call enable_join() first")
            return join_match(words, lens, is_sys, node, *self._jarrs, **kw)

    def put_batch(self, words: np.ndarray, lens: np.ndarray,
                  is_sys: np.ndarray):
        """Encoded host operands → device tensors (copies enqueued on
        the current stream; see :meth:`_put`)."""
        return (self._put(words, True), self._put(lens, True),
                self._put(is_sys, True))

    def match_names(self, names: Sequence[str],
                    batch: Optional[int] = None,
                    flat_cap: int = 0) -> MatchResult:
        """Encode + match a batch of topic names."""
        from .encode import encode_batch

        enc = encode_batch(self.inc, names, batch=batch)
        return self.match(*self.put_batch(*enc), flat_cap=flat_cap)
