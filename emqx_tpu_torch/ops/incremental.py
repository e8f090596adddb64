"""Incremental NFA table: O(filter) add/remove and a delta drain.

The port's copy of the reference's ``IncrementalNfa`` (``emqx_tpu/ops/
incremental.py``): the same trie bookkeeping, the same cuckoo placement
and the same fixed rng seed, so that from the same sequence of filter
adds and removes both builders hold byte-identical ``node_tab``,
``edge_tab`` and ``seeds``.  The host arrays are the authority; the
device twin (:class:`~emqx_tpu_torch.ops.device_table.DeviceNfa`)
consumes the drained deltas.

* state free-list — deleted trie nodes return their row; growth doubles S;
* in-place cuckoo mutation — inserts kick within the live table, deletes
  clear the slot; every touched bucket row is recorded as dirty;
* accept-id free-list — ``accept_filters`` may hold ``None`` holes, and a
  freed id is reused only once the device has applied the epoch that
  cleared it, and each reuse is counted in ``aid_reuses``;
* ``flush()`` drains the dirty node rows and bucket rows; ``snapshot()``
  copies the arrays out as an ``NfaTable`` (the sidecar's checkpoint);
* ``track_regions`` (the segments mode): growth keeps the dirty sets
  valid across a resize, and the delta says which region moved
  (``node_grown_from``, ``edges_rehashed``), so that the device twin can
  grow its tables in place instead of uploading them whole;
* a table restored from a segment (``storage/segments.py``) links its
  trie lazily: ``_pending_trie`` until the first walk or mutation, or
  the service's background hydrate (:meth:`IncrementalNfa._hydrate`);
* ``compact()`` rebuilds dense arrays from the live filters and forces
  the next drain to be a whole upload, even in region mode.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from .. import topic as T
from .compiler import BUCKET_SLOTS, NfaTable, _bucket

__all__ = ["IncrementalNfa", "NfaDelta"]

_MAX_KICKS = 500
_U32 = 0xFFFFFFFF


def _hash_py(state: int, word: int, seed: int, mask: int) -> int:
    """Pure-Python ``compiler._bucket_hash``: the same uint32 mixing."""
    h = (state * 2654435761 + word * 2246822519 + seed) & _U32
    h ^= h >> 16
    h = (h * 3266489917) & _U32
    h ^= h >> 13
    return h & mask


class NfaDelta(NamedTuple):
    """One drained batch of table mutations (host → device)."""

    epoch: int
    resized: bool              # shapes changed ⇒ full re-upload needed
    state_idx: np.ndarray      # (n,) int32 dirty node_tab rows
    state_rows: np.ndarray     # (n, 4) int32 current contents
    bucket_idx: np.ndarray     # (m,) int32 dirty edge_tab rows
    bucket_rows: np.ndarray    # (m, BUCKET_SLOTS*4) int32 current contents
    # region facts of a resized delta (``track_regions`` mode): the node
    # rows that are still valid on the device (the S before the first
    # growth since the last flush, S itself when the node table did not
    # grow, -1 when every row was replaced), and whether the edge table
    # was rehashed with fresh seeds (its contents ship whole).  The
    # defaults say "unknown": a consumer uploads the tables whole
    node_grown_from: int = -1
    edges_rehashed: bool = True

    @property
    def empty(self) -> bool:
        return (not self.resized and len(self.state_idx) == 0
                and len(self.bucket_idx) == 0)


class _INode:
    __slots__ = ("sid", "lit", "plus", "parent", "pword", "hash_aid", "aid")

    def __init__(self, sid: int, parent: Optional["_INode"],
                 pword: Optional[str]):
        self.sid = sid
        self.lit: Dict[str, "_INode"] = {}
        self.plus: Optional["_INode"] = None
        self.parent = parent
        self.pword = pword          # literal word of the parent edge; None ⇒ '+'
        self.hash_aid = -1
        self.aid = -1

    def prunable(self) -> bool:
        return (not self.lit and self.plus is None
                and self.hash_aid < 0 and self.aid < 0)


class IncrementalNfa:
    """Mutable flattened NFA with O(filter) add/remove and delta drain."""

    def __init__(
        self,
        depth: int = 8,
        state_bucket: int = 1024,
        edge_bucket: int = 64,
        seed: int = 0xE709,
    ) -> None:
        self.depth = depth
        self._rng = np.random.default_rng(seed)
        self.node_tab = np.full((state_bucket, 4), -1, np.int32)
        self.node_tab[:, 3] = 0
        Hb = _bucket(edge_bucket, 8)
        self.edge_tab = np.full((Hb, BUCKET_SLOTS * 4), -1, np.int32)
        self.seeds = self._rng.integers(1, 2**31 - 1, size=2, dtype=np.int32)
        self._seed_ints = (int(self.seeds[0]), int(self.seeds[1]))
        self.vocab: Dict[str, int] = {}
        self.accept_filters: List[Optional[str]] = []
        self.root = _INode(0, None, None)
        self.epoch = 0
        self.n_states = 1
        self.n_edges = 0
        self.n_filters = 0
        self._free_sids: List[int] = list(range(state_bucket - 1, 0, -1))
        # freed accept ids carry the epoch they were freed at: with a
        # device consumer attached, an id is reusable only once the device
        # has applied that epoch, or a stale device row could fire the old
        # id and be read through the new accept_filters entry
        self._free_aids: "deque[Tuple[int, int]]" = deque()  # (epoch, aid)
        self.device_epoch: Optional[int] = None  # None ⇒ no device consumer
        # times a freed id was handed out again: a decoder that turns
        # device rows into filters while a match is in flight checks
        # that it did not move (the rows may name a reused id under its
        # old filter)
        self.aid_reuses = 0
        self._alias_aids: set = set()
        self._dirty_states = {0}
        self._dirty_buckets: set = set()
        self._resized = False
        # region mode (off: flush() is the plain drain)
        self.track_regions = False
        self._node_grown_from = -1    # S before the first growth, -1: none
        self._edges_rehashed = False
        self._node_wholesale = False  # compact(): every node row replaced
        # a restored table's trie linker (storage/segments.py), None once
        # linked; every walk and mutation links first
        self._pending_trie = None

    # -- shapes ------------------------------------------------------------

    @property
    def S(self) -> int:
        return int(self.node_tab.shape[0])

    @property
    def Hb(self) -> int:
        return int(self.edge_tab.shape[0])

    def shape_key(self) -> Tuple[int, int, int]:
        return (self.S, self.Hb, self.depth)

    # -- allocation --------------------------------------------------------

    def _alloc_sid(self) -> int:
        if not self._free_sids:
            S = self.S
            grown = np.full((S * 2, 4), -1, np.int32)
            grown[:, 3] = 0
            grown[:S] = self.node_tab
            self.node_tab = grown
            self._free_sids = list(range(S * 2 - 1, S - 1, -1))
            self._resized = True
            if self.track_regions and self._node_grown_from < 0:
                # the old rows were copied as they are: the dirty set
                # stays valid, the device only pads rows [S, 2S)
                self._node_grown_from = S
        return self._free_sids.pop()

    def _alloc_aid(self, flt: str) -> int:
        if self._free_aids:
            freed_epoch, aid = self._free_aids[0]
            if self.device_epoch is None or freed_epoch <= self.device_epoch:
                self._free_aids.popleft()
                self.accept_filters[aid] = flt
                self.aid_reuses += 1
                return aid
        self.accept_filters.append(flt)
        return len(self.accept_filters) - 1

    def _free_aid(self, aid: int) -> None:
        self.accept_filters[aid] = None
        self._free_aids.append((self.epoch + 1, aid))

    def _intern(self, w: str) -> int:
        wid = self.vocab.get(w)
        if wid is None:
            wid = self.vocab[w] = len(self.vocab) + 1  # 0 = UNKNOWN
        return wid

    # -- cuckoo edge mutation ---------------------------------------------

    def _buckets_of(self, s: int, w: int) -> List[int]:
        mask = self.Hb - 1
        s0, s1 = self._seed_ints
        return [_hash_py(s, w, s0, mask), _hash_py(s, w, s1, mask)]

    def _edge_insert(self, s: int, wid: int, nxt: int) -> None:
        # grow at 3/4 load, before kick chains get long
        if self.n_edges >= (self.Hb * BUCKET_SLOTS * 3) // 4:
            self._grow_edges()
        tab = self.edge_tab
        cur = (s, wid, nxt)
        for _ in range(_MAX_KICKS):
            b_opts = self._buckets_of(cur[0], cur[1])
            for b in b_opts:
                row = tab[b].tolist()
                for i in range(0, 4 * BUCKET_SLOTS, 4):
                    if row[i] < 0:
                        tab[b, i:i + 3] = cur
                        self._dirty_buckets.add(b)
                        self.n_edges += 1
                        return
            # both buckets full: evict a random victim and carry it
            b = b_opts[int(self._rng.integers(2))]
            i = 4 * int(self._rng.integers(BUCKET_SLOTS))
            victim = tuple(tab[b, i:i + 3].tolist())
            tab[b, i:i + 3] = cur
            self._dirty_buckets.add(b)
            cur = victim
        self._grow_edges(pending=cur)
        self.n_edges += 1

    def _edge_delete(self, s: int, wid: int) -> None:
        tab = self.edge_tab
        for b in self._buckets_of(s, wid):
            row = tab[b].tolist()
            for i in range(0, 4 * BUCKET_SLOTS, 4):
                if row[i] == s and row[i + 1] == wid:
                    tab[b, i:i + 3] = (-1, -1, -1)
                    self._dirty_buckets.add(b)
                    self.n_edges -= 1
                    return
        raise AssertionError(f"edge ({s},{wid}) not in cuckoo table")

    def _live_edges(self) -> List[Tuple[int, int, int]]:
        tab = self.edge_tab.reshape(-1, 4)
        live = tab[tab[:, 0] >= 0]
        return [(int(a), int(b), int(c)) for a, b, c, _ in live]

    def _grow_edges(self,
                    pending: Optional[Tuple[int, int, int]] = None) -> None:
        """Double Hb and re-place every edge with fresh seeds."""
        edges = self._live_edges()
        if pending is not None:
            edges.append(pending)
        Hb = self.Hb
        while True:
            Hb <<= 1
            mask = Hb - 1
            for _attempt in range(4):
                seeds = self._rng.integers(1, 2**31 - 1, size=2,
                                           dtype=np.int32)
                slots = np.full((Hb, BUCKET_SLOTS, 4), -1, np.int32)
                if self._place_all(edges, slots, seeds, mask):
                    self.edge_tab = slots.reshape(Hb, BUCKET_SLOTS * 4)
                    self.seeds = seeds
                    self._seed_ints = (int(seeds[0]), int(seeds[1]))
                    self._resized = True
                    self._dirty_buckets.clear()
                    if self.track_regions:
                        # every edge moved: the table ships whole, and
                        # bucket dirt restarts against the new table
                        self._edges_rehashed = True
                    return

    def _place_all(self, edges, slots, seeds, mask) -> bool:
        s0, s1 = int(seeds[0]), int(seeds[1])
        for edge in edges:
            cur = edge
            placed = False
            for _ in range(_MAX_KICKS):
                b_opts = [
                    _hash_py(cur[0], cur[1], s0, mask),
                    _hash_py(cur[0], cur[1], s1, mask),
                ]
                for b in b_opts:
                    for i in range(BUCKET_SLOTS):
                        if slots[b, i, 0] < 0:
                            slots[b, i] = (*cur, 0)
                            placed = True
                            break
                    if placed:
                        break
                if placed:
                    break
                b = b_opts[int(self._rng.integers(2))]
                i = int(self._rng.integers(BUCKET_SLOTS))
                victim = tuple(int(x) for x in slots[b, i, :3])
                slots[b, i] = (*cur, 0)
                cur = victim
            if not placed:
                return False
        return True

    # -- filter mutation ---------------------------------------------------

    def _hydrate(self) -> None:
        """Link a restored table's trie, if it is not linked yet (the
        linker is idempotent and locked)."""
        pending = self._pending_trie
        if pending is not None:
            pending()

    def add(self, flt: str) -> bool:
        """Insert ``flt``; False if it was already present.  Raises
        ValueError when the filter is deeper than the table."""
        self._hydrate()
        ws = T.words(flt)
        if len(ws) > self.depth:
            raise ValueError(
                f"filter {flt!r} has {len(ws)} levels > table depth {self.depth}"
            )
        node = self.root
        for i, w in enumerate(ws):
            if w == "#":
                if i != len(ws) - 1:
                    raise ValueError(f"'#' not at last level: {flt!r}")
                if node.hash_aid >= 0:
                    return False
                node.hash_aid = self._alloc_aid(flt)
                self.node_tab[node.sid, 1] = node.hash_aid
                self._dirty_states.add(node.sid)
                self.n_filters += 1
                self.epoch += 1
                return True
            if w == "+":
                if node.plus is None:
                    child = _INode(self._alloc_sid(), node, None)
                    node.plus = child
                    self.node_tab[child.sid] = (-1, -1, -1, 0)
                    self.node_tab[node.sid, 0] = child.sid
                    self._dirty_states.add(node.sid)
                    self._dirty_states.add(child.sid)
                    self.n_states += 1
                node = node.plus
            else:
                child = node.lit.get(w)
                if child is None:
                    child = _INode(self._alloc_sid(), node, w)
                    node.lit[w] = child
                    self.node_tab[child.sid] = (-1, -1, -1, 0)
                    self._dirty_states.add(child.sid)
                    self._edge_insert(node.sid, self._intern(w), child.sid)
                    self.n_states += 1
                node = child
        if node.aid >= 0:
            return False
        node.aid = self._alloc_aid(flt)
        self.node_tab[node.sid, 2] = node.aid
        self._dirty_states.add(node.sid)
        self.n_filters += 1
        self.epoch += 1
        return True

    def remove(self, flt: str) -> bool:
        """Delete ``flt``; False if absent.  Prunes now-empty branches."""
        self._hydrate()
        ws = T.words(flt)
        if len(ws) > self.depth:
            return False
        node = self.root
        ends_hash = bool(ws) and ws[-1] == "#"
        for w in (ws[:-1] if ends_hash else ws):
            node = node.plus if w == "+" else node.lit.get(w)
            if node is None:
                return False
        if ends_hash:
            if node.hash_aid < 0:
                return False
            self._free_aid(node.hash_aid)
            node.hash_aid = -1
            self.node_tab[node.sid, 1] = -1
        else:
            if node.aid < 0:
                return False
            self._free_aid(node.aid)
            node.aid = -1
            self.node_tab[node.sid, 2] = -1
        self._dirty_states.add(node.sid)
        self._prune(node)
        self.n_filters -= 1
        self.epoch += 1
        return True

    def _prune(self, node: _INode) -> None:
        while node.parent is not None and node.prunable():
            parent = node.parent
            if node.pword is None:
                parent.plus = None
                self.node_tab[parent.sid, 0] = -1
            else:
                del parent.lit[node.pword]
                self._edge_delete(parent.sid, self.vocab[node.pword])
            self.node_tab[node.sid] = (-1, -1, -1, 0)
            self._dirty_states.add(node.sid)
            self._dirty_states.add(parent.sid)
            self._free_sids.append(node.sid)
            self.n_states -= 1
            node = parent

    # -- delta drain -------------------------------------------------------

    def flush(self) -> NfaDelta:
        """Drain dirty rows.  After a resize the row sets are meaningless
        (the whole table moved): the consumer must re-upload.  In
        ``track_regions`` mode growth keeps them valid (node rows are
        copied as they are; an edge rehash clears only the bucket dirt)
        and the delta carries the region facts."""
        resized = self._resized
        track = self.track_regions
        if resized and not track:
            sidx = np.zeros(0, np.int32)
            bidx = np.zeros(0, np.int32)
        else:
            sidx = np.fromiter(self._dirty_states, np.int32,
                               len(self._dirty_states))
            bidx = np.fromiter(self._dirty_buckets, np.int32,
                               len(self._dirty_buckets))
        delta = NfaDelta(
            epoch=self.epoch, resized=resized,
            state_idx=sidx, state_rows=self.node_tab[sidx].copy(),
            bucket_idx=bidx, bucket_rows=self.edge_tab[bidx].copy(),
            node_grown_from=(
                -1 if (not track or self._node_wholesale)
                else (self._node_grown_from
                      if self._node_grown_from >= 0 else self.S)),
            edges_rehashed=((self._edges_rehashed or self._node_wholesale)
                            if track else True),
        )
        self._dirty_states = set()
        self._dirty_buckets = set()
        self._resized = False
        self._node_grown_from = -1
        self._edges_rehashed = False
        self._node_wholesale = False
        return delta

    def snapshot(self) -> NfaTable:
        """An immutable copy in the ``compile_filters`` output format (the
        sidecar's checkpoint, parity tests).  Holes in ``accept_filters``
        are unreachable, so indexing by a matched id stays safe."""
        return NfaTable(
            node_tab=self.node_tab.copy(),
            edge_tab=self.edge_tab.copy(),
            seeds=self.seeds.copy(),
            n_states=self.n_states,
            depth=self.depth,
            vocab=dict(self.vocab),
            accept_filters=list(self.accept_filters),
            epoch=self.epoch,
        )

    def filters(self) -> List[str]:
        """Live table filters (aliases excluded)."""
        return [f for aid, f in enumerate(self.accept_filters)
                if f is not None and aid not in self._alias_aids]

    def aliases(self) -> Dict[str, int]:
        return {self.accept_filters[aid]: aid for aid in self._alias_aids}

    def match_host(self, topic: str) -> List[int]:
        """Authoritative host-side match of a concrete topic against the
        live trie (the answer for rows the device spilled): ``+`` one
        level, ``#`` zero or more trailing levels, root wildcards
        suppressed for ``$``-topics.  Returns accept ids."""
        self._hydrate()
        ws = T.words(topic)
        is_sys = topic.startswith("$")
        out: List[int] = []
        frontier = [self.root]
        for t, w in enumerate(ws):
            nxt: List[_INode] = []
            for node in frontier:
                if node.hash_aid >= 0 and not (t == 0 and is_sys):
                    out.append(node.hash_aid)
                child = node.lit.get(w)
                if child is not None:
                    nxt.append(child)
                if node.plus is not None and not (t == 0 and is_sys):
                    nxt.append(node.plus)
            frontier = nxt
            if not frontier:
                return out
        for node in frontier:
            if node.hash_aid >= 0:   # '#' matches zero remaining levels
                out.append(node.hash_aid)
            if node.aid >= 0:
                out.append(node.aid)
        return out

    def aid_of(self, flt: str) -> int:
        """Accept id of a present filter, -1 if absent."""
        self._hydrate()
        ws = T.words(flt)
        if len(ws) > self.depth:
            return -1
        node = self.root
        ends_hash = bool(ws) and ws[-1] == "#"
        for w in ws[:-1] if ends_hash else ws:
            node = node.plus if w == "+" else node.lit.get(w)
            if node is None:
                return -1
        return node.hash_aid if ends_hash else node.aid

    # -- alias ids: filters deeper than the table share the id space -------

    def alloc_alias(self, flt: str) -> int:
        aid = self._alloc_aid(flt)
        self._alias_aids.add(aid)
        self.epoch += 1
        return aid

    def free_alias(self, aid: int) -> None:
        self._alias_aids.discard(aid)
        self._free_aid(aid)
        self.epoch += 1

    def compact(self) -> None:
        """Rebuild dense arrays from the live filters (drops vocab
        garbage and accept holes, shrinks over-grown shapes); alias ids
        are reassigned, so holders of alias maps rebuild them from
        :meth:`aliases`.  The epoch goes on (one more), the device's ack
        position is kept, every id counts as reused, and the next drain
        is a whole upload even in region mode: no device row survives."""
        live = self.filters()
        alias_filters = sorted(self.aliases())
        old_epoch = self.epoch
        old_device_epoch = self.device_epoch
        fresh = IncrementalNfa(
            depth=self.depth,
            state_bucket=_bucket(max(2 * len(live), 8), 1024),
            seed=int(self._rng.integers(1, 2**31 - 1)))
        for f in live:
            fresh.add(f)
        for f in alias_filters:
            fresh.alloc_alias(f)
        old_reuses = self.aid_reuses
        track = self.track_regions
        self.__dict__.update(fresh.__dict__)
        self.epoch = old_epoch + 1
        self.device_epoch = old_device_epoch
        self.aid_reuses = old_reuses + 1
        self._resized = True
        self.track_regions = track
        self._node_wholesale = True
