"""The join match backend: the NFA walk over a sorted edge relation.

The port of ``emqx_tpu/ops/join_match.py``.  In place of the cuckoo
probe of the hash backend, each literal edge is found by a lower-bound
search over a relation sorted by (state, word):

* ``state_start (S+1,) int32`` — CSR offsets: state ``s``'s edges are
  rows ``[state_start[s], state_start[s+1])``;
* ``edge_word (E,) int32`` — the edge words, sorted within each segment;
* ``edge_next (E,) int32`` — the target state, ``-1`` for a tombstone
  (a removed edge whose row stays, so the order survives in place);
* ``overlay (OVERLAY_CAP, 3) int32`` — ``[state, word, next]`` rows of
  edges added since the last rebuild, sorted by (state, word) with
  ``OVERLAY_EMPTY`` sentinel rows packed at the end.

:func:`join_match` runs the walk
(:func:`~emqx_tpu_torch.ops.walk_kernel.join_walk`: the hand-written CUDA
kernel on the card, its plain version on the CPU) and the shared output
epilogue.  :class:`JoinRelation` is the host side: it builds the
relation from the cuckoo table, and diffs each drained bucket delta
against a shadow copy of that table into the few writes the device copy
needs (tombstones and revivals on ``edge_next``, a re-sorted overlay),
until the overlay fills and the relation is rebuilt.  The host side is
numpy, the same as the reference's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .compiler import BUCKET_SLOTS
from .match_kernel import MatchResult, epilogue
from .walk_kernel import OVERLAY_CAP, join_walk

__all__ = ["OVERLAY_CAP", "OVERLAY_EMPTY", "JoinRelation", "OverlayFull",
           "join_match", "relation_capacity"]

#: state and word of an unused overlay row: sorts after every live
#: (state, word) pair, so the lower bound never lands on one
OVERLAY_EMPTY = np.int32(2**31 - 1)


def relation_capacity(hb: int) -> int:
    """Relation rows for a cuckoo table of ``hb`` buckets: its slot
    count, so a rebuild always fits and the capacity doubles with Hb."""
    return hb * BUCKET_SLOTS


def join_match(words, lens, is_sys, node_tab, state_start, edge_word,
               edge_next, overlay, *, active_slots: int = 16,
               max_matches: int = 32, compact_output: bool = True,
               flat_cap: int = 0) -> MatchResult:
    """The join walk over one encoded batch, then the flat
    (``flat_cap`` > 0), compact or raw epilogue: the same outputs as
    :func:`~emqx_tpu_torch.ops.match_kernel.nfa_match` on the same
    edges."""
    acc, aover = join_walk(words, lens, is_sys, node_tab, state_start,
                           edge_word, edge_next, overlay,
                           active_slots=active_slots)
    return epilogue(acc, aover, max_matches, compact_output, flat_cap)


class OverlayFull(RuntimeError):
    """The overlay ran out of rows: the caller rebuilds the relation
    from the shadow table and uploads it whole."""


class JoinRelation:
    """Host twin of the device relation arrays, with a shadow copy of
    the cuckoo edge table.  :meth:`apply_bucket_delta` turns drained
    dirty buckets into the device writes, O(dirty buckets), until the
    overlay fills."""

    def __init__(self, s: int, edge_tab: np.ndarray,
                 arrays: Optional[Tuple[np.ndarray, ...]] = None) -> None:
        """The relation of cuckoo table ``edge_tab`` over ``s`` states:
        sorted here, or taken from ``arrays`` (``state_start,
        edge_word, edge_next`` and optionally ``overlay``) of a relation
        built elsewhere on the same table."""
        self.shadow = np.array(edge_tab, np.int32, copy=True)
        self.cap = relation_capacity(int(edge_tab.shape[0]))
        # overlay edges keyed (state, word); the array form stays sorted
        self.overlay = np.empty((OVERLAY_CAP, 3), np.int32)
        self._o_map: Dict[Tuple[int, int], int] = {}
        self._materialize_overlay()
        if arrays is not None:
            start, word, nxt = arrays[:3]
            self.state_start = np.array(start, np.int32, copy=True)
            self.edge_word = np.array(word, np.int32, copy=True)
            self.edge_next = np.array(nxt, np.int32, copy=True)
            if (len(self.state_start) != s + 1
                    or len(self.edge_word) != self.cap
                    or len(self.edge_next) != self.cap):
                raise ValueError("seed relation shape mismatch")
            if len(arrays) > 3:
                self._seed_overlay(arrays[3])
        else:
            self._build(s)

    def _seed_overlay(self, overlay: np.ndarray) -> None:
        """Take the overlay of a relation built elsewhere: the map from
        its non-sentinel rows, which must already be in sorted order."""
        ov = np.asarray(overlay, np.int32)
        if ov.shape != (OVERLAY_CAP, 3):
            raise ValueError(f"overlay shape {ov.shape}, want "
                             f"({OVERLAY_CAP}, 3)")
        live = ov[ov[:, 0] != OVERLAY_EMPTY]
        self._o_map = {(s, w): n for s, w, n in live.tolist()}
        self._materialize_overlay()
        if not np.array_equal(self.overlay, ov):
            raise ValueError("overlay rows not sorted by (state, word)")

    def _build(self, s: int) -> None:
        flat = self.shadow.reshape(-1, 4)
        live = flat[flat[:, 0] >= 0]
        order = np.lexsort((live[:, 1], live[:, 0]))
        sw = live[order]
        n = len(sw)
        if n > self.cap:  # cannot happen: cap is the slot count
            raise ValueError(f"{n} edges > relation capacity {self.cap}")
        word = np.zeros(self.cap, np.int32)
        nxt = np.full(self.cap, -1, np.int32)
        word[:n] = sw[:, 1]
        nxt[:n] = sw[:, 2]
        counts = np.bincount(sw[:, 0], minlength=s) if n else \
            np.zeros(s, np.int64)
        start = np.zeros(s + 1, np.int32)
        start[1:] = np.cumsum(counts[:s])
        self.state_start = start
        self.edge_word = word
        self.edge_next = nxt
        self._o_map = {}
        self._materialize_overlay()

    def _materialize_overlay(self) -> None:
        """Sort the overlay rows by (state, word); unused rows pack at
        the end as OVERLAY_EMPTY sentinels."""
        self.overlay[:, 0] = OVERLAY_EMPTY
        self.overlay[:, 1] = OVERLAY_EMPTY
        self.overlay[:, 2] = -1
        if self._o_map:
            rows = [(s, w, n) for (s, w), n in sorted(self._o_map.items())]
            self.overlay[:len(rows)] = np.asarray(rows, np.int32)

    # -- queries -----------------------------------------------------------

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray]:
        return (self.state_start, self.edge_word, self.edge_next,
                self.overlay)

    def lookup(self, s: int, w: int) -> int:
        """Host-side answer of the walk's literal lookup."""
        pos = self._csr_find(s, w)
        if pos is not None and self.edge_next[pos] >= 0:
            return int(self.edge_next[pos])
        return self._o_map.get((s, w), -1)

    def _csr_find(self, s: int, w: int) -> Optional[int]:
        start = self.state_start
        if s + 1 >= len(start):
            return None
        lo, hi = int(start[s]), int(start[s + 1])
        i = lo + int(np.searchsorted(self.edge_word[lo:hi], w))
        if i < hi and self.edge_word[i] == w:
            return i
        return None

    # -- maintenance -------------------------------------------------------

    @staticmethod
    def _bucket_edges(row: np.ndarray) -> Dict[Tuple[int, int], int]:
        out: Dict[Tuple[int, int], int] = {}
        r = row.tolist()
        for i in range(0, len(r), 4):
            if r[i] >= 0:
                out[(r[i], r[i + 1])] = r[i + 2]
        return out

    def apply_bucket_delta(self, bucket_idx: np.ndarray,
                           bucket_rows: np.ndarray):
        """Diff dirty buckets against the shadow into device writes:
        ``(main_pos, main_val, olay_pos, olay_rows)``, meaning
        ``edge_next[main_pos] = main_val`` and ``overlay[olay_pos] =
        olay_rows``.  Any overlay change re-sorts it and returns it
        whole.  Raises :class:`OverlayFull` when an insertion finds no
        overlay row; the shadow is already updated, so ``rebuild()``
        is enough."""
        if len(bucket_idx) and int(bucket_idx.max()) >= len(self.shadow):
            # a resize that did not go through rebuild(): rebuild
            # rather than corrupt the relation
            raise OverlayFull("dirty bucket beyond shadow shape")
        removed: Dict[Tuple[int, int], int] = {}
        added: Dict[Tuple[int, int], int] = {}
        for b, new in zip(bucket_idx.tolist(), bucket_rows):
            old_e = self._bucket_edges(self.shadow[b])
            new_e = self._bucket_edges(new)
            for k, v in old_e.items():
                if k not in new_e:
                    removed[k] = v
            for k, v in new_e.items():
                if k not in old_e or old_e[k] != v:
                    added[k] = v
            self.shadow[b] = new
        # a cuckoo kick moves an edge between buckets: removed in one,
        # added in another — no change, or a new ``next`` in place
        for k in [k for k in removed if k in added]:
            if removed[k] == added[k]:
                del added[k]
            del removed[k]
        main_pos: List[int] = []
        main_val: List[int] = []
        o_dirty = False
        for (s, w) in removed:
            if self._o_map.pop((s, w), None) is not None:
                o_dirty = True
                continue
            pos = self._csr_find(s, w)
            if pos is None:  # shadow and relation disagree: rebuild
                raise OverlayFull(f"edge ({s},{w}) missing from relation")
            self.edge_next[pos] = -1
            main_pos.append(pos)
            main_val.append(-1)
        for (s, w), nv in added.items():
            pos = self._csr_find(s, w)
            if pos is not None:   # revive the tombstone in place
                self.edge_next[pos] = nv
                main_pos.append(pos)
                main_val.append(nv)
                continue
            if (s, w) not in self._o_map and \
                    len(self._o_map) >= OVERLAY_CAP:
                raise OverlayFull(f"overlay full ({OVERLAY_CAP} rows)")
            if self._o_map.get((s, w)) != nv:
                self._o_map[(s, w)] = nv
                o_dirty = True
        if o_dirty:
            self._materialize_overlay()
            olay_pos = np.arange(OVERLAY_CAP, dtype=np.int32)
            olay_rows = self.overlay.copy()
        else:
            olay_pos = np.empty(0, np.int32)
            olay_rows = np.empty((0, 3), np.int32)
        return (np.asarray(main_pos, np.int32),
                np.asarray(main_val, np.int32), olay_pos, olay_rows)

    def grow_states(self, new_s: int) -> None:
        """Node-table growth: new states have no CSR segment (their
        edges arrive through the overlay), so the offsets extend with
        the terminal value."""
        cur = len(self.state_start) - 1
        if new_s <= cur:
            return
        self.state_start = np.concatenate([
            self.state_start,
            np.full(new_s - cur, self.state_start[-1], np.int32)])

    def rebuild(self, s: int, edge_tab: Optional[np.ndarray] = None) -> None:
        """Re-sort from ``edge_tab`` (or the current shadow): the
        overlay-full and rehash path, O(E log E)."""
        if edge_tab is not None:
            self.shadow = np.array(edge_tab, np.int32, copy=True)
            self.cap = relation_capacity(int(edge_tab.shape[0]))
        self._build(s)
