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
epilogue, or, in flat mode on the card, the walk's flat kernel in one
launch.  :class:`JoinRelation` is the host side: it builds the
relation from the cuckoo table, and diffs each drained bucket delta
against a shadow copy of that table into the few writes the device copy
needs (tombstones and revivals on ``edge_next``, a re-sorted overlay),
until the overlay fills and the relation is rebuilt.  The host side is
numpy, the same as the reference's; :func:`relation_arrays` sorts the
same arrays from a tensor of the table, on the card in milliseconds
where the host sort of a 1M-filter table takes most of a second.
:class:`BackendAutotuner` keeps the
measured hash-or-join pick of each dispatch shape for the ``auto``
backend.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .compiler import BUCKET_SLOTS
from .match_kernel import MatchResult, epilogue
from .walk_kernel import OVERLAY_CAP, _on_card, join_walk, join_walk_flat

log = logging.getLogger(__name__)

__all__ = ["OVERLAY_CAP", "OVERLAY_EMPTY", "BackendAutotuner",
           "JoinRelation", "OverlayFull", "join_match", "relation_arrays",
           "relation_capacity"]

#: state and word of an unused overlay row: sorts after every live
#: (state, word) pair, so the lower bound never lands on one
OVERLAY_EMPTY = np.int32(2**31 - 1)


def relation_capacity(hb: int) -> int:
    """Relation rows for a cuckoo table of ``hb`` buckets: its slot
    count, so a rebuild always fits and the capacity doubles with Hb."""
    return hb * BUCKET_SLOTS


def relation_arrays(s: int, edge_tab: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(state_start, edge_word, edge_next)`` of the cuckoo table
    ``edge_tab`` over ``s`` states, sorted where the tensor lies: the
    arrays :class:`JoinRelation` sorts on the host, bit for bit (the
    (state, word) pairs of a table are distinct, so one order)."""
    flat = edge_tab.reshape(-1, 4)
    live = flat[flat[:, 0] >= 0]
    # (state, word) as one int64 key; words shifted to sort signed
    key = live[:, 0].long() * 2**32 + (live[:, 1].long() + 2**31)
    sw = live[torch.sort(key, stable=True).indices]
    n = int(sw.shape[0])
    cap = relation_capacity(int(edge_tab.shape[0]))
    if n > cap:  # cannot happen: cap is the slot count
        raise ValueError(f"{n} edges > relation capacity {cap}")
    dev = edge_tab.device
    word = torch.zeros(cap, dtype=torch.int32, device=dev)
    nxt = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    word[:n] = sw[:, 1]
    nxt[:n] = sw[:, 2]
    start = torch.zeros(s + 1, dtype=torch.int32, device=dev)
    start[1:] = torch.cumsum(torch.bincount(sw[:, 0], minlength=s)[:s], 0)
    return start, word, nxt


def join_match(words, lens, is_sys, node_tab, state_start, edge_word,
               edge_next, overlay, *, active_slots: int = 16,
               max_matches: int = 32, compact_output: bool = True,
               flat_cap: int = 0) -> MatchResult:
    """The join walk over one encoded batch, then the flat
    (``flat_cap`` > 0), compact or raw epilogue: the same outputs as
    :func:`~emqx_tpu_torch.ops.match_kernel.nfa_match` on the same
    edges.  Flat mode on CUDA tensors is one launch of the join walk
    with the epilogue fused
    (:func:`~emqx_tpu_torch.ops.walk_kernel.join_walk_flat`)."""
    if flat_cap and _on_card("join_match", words):
        return MatchResult(*join_walk_flat(
            words, lens, is_sys, node_tab, state_start, edge_word,
            edge_next, overlay, active_slots=active_slots,
            max_matches=max_matches, flat_cap=flat_cap))
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

    def adopt(self, start: np.ndarray, word: np.ndarray,
              nxt: np.ndarray) -> None:
        """Take the sorted arrays of the current shadow made elsewhere
        (:func:`relation_arrays`): :meth:`rebuild` without the host
        sort.  The overlay empties."""
        self.state_start, self.edge_word, self.edge_next = start, word, nxt
        self._o_map = {}
        self._materialize_overlay()

    def rebuild(self, s: int, edge_tab: Optional[np.ndarray] = None) -> None:
        """Re-sort from ``edge_tab`` (or the current shadow): the
        overlay-full and rehash path, O(E log E)."""
        if edge_tab is not None:
            self.shadow = np.array(edge_tab, np.int32, copy=True)
            self.cap = relation_capacity(int(edge_tab.shape[0]))
        self._build(s)


class BackendAutotuner:
    """Measured hash-vs-join pick per kernel shape, persisted as
    checksummed JSON: a corrupt or tampered pick table is rejected and
    the default serves (a wrong pick is only slow, but a torn file must
    never poison routing).  The port's copy of the reference's class;
    the same file format, so either reads the other's table.

    Thread model: ``pick()`` is a dict read (serve path, GIL-atomic);
    ``record()``/``save()`` run under one lock, from whichever thread
    measures."""

    VERSION = 1

    def __init__(self, path: Optional[str] = None, reps: int = 3) -> None:
        self.path = path
        self.reps = max(1, int(reps))
        self.picks: Dict[str, str] = {}
        self.measured: Dict[str, Dict[str, float]] = {}
        self.rejected = False
        self.family_hits = 0
        self._lock = threading.Lock()
        if path:
            self._load()

    @staticmethod
    def sig(b: int, d: int, s: int, hb: int) -> str:
        return f"b{b}:d{d}:s{s}:h{hb}"

    @staticmethod
    def family(sig: str) -> str:
        """The pow2 (S, Hb) family a sig belongs to: the (batch,
        depth) prefix — table shapes are padded pow2s, so every
        growth step lands in the same family."""
        return sig.split(":s", 1)[0]

    def pick(self, sig: str) -> Optional[str]:
        return self.picks.get(sig)

    def pick_for(self, b: int, d: int, s: int, hb: int) -> Optional[str]:
        """The serving pick for a shape: the exact measured sig, else
        the (B, D)-family consensus across pow2 (S, Hb) shapes — the
        pick rarely flips within a family, so a growth step inherits
        the family's answer instead of re-measuring cold.  A split family (measured shapes disagree)
        returns None and the exact shape measures as before."""
        sig = self.sig(b, d, s, hb)
        p = self.picks.get(sig)
        if p is not None:
            return p
        fam = self.family(sig)
        seen = {v for k, v in self.picks.items()
                if self.family(k) == fam}
        if len(seen) == 1:
            self.family_hits += 1
            return next(iter(seen))
        return None

    # -- measurement -------------------------------------------------------

    def measure(self, sig: str,
                runners: Dict[str, Callable[[], Optional[float]]]) -> str:
        """Time each runner (one warmup call outside the clock — the
        first call may build a kernel), record the per-rep minimum,
        pick the fastest, persist.  Returns the winning backend name.
        Each runner must wait for its own device work to finish; one
        that returns a number has timed itself (seconds, e.g. between
        two CUDA events), and that number replaces the host clock's."""
        times: Dict[str, float] = {}
        for name, run in runners.items():
            run()                       # warmup / compile, untimed
            best = float("inf")
            for _ in range(self.reps):
                t0 = time.perf_counter()
                took = run()
                if took is None:
                    took = time.perf_counter() - t0
                best = min(best, took)
            times[name] = best
        winner = min(times, key=lambda n: times[n])
        self.record(sig, winner, times)
        return winner

    def record(self, sig: str, backend: str,
               times: Optional[Dict[str, float]] = None) -> None:
        with self._lock:
            self.picks[sig] = backend
            if times:
                self.measured[sig] = {
                    k: round(v * 1e6, 2) for k, v in times.items()}
            self._save_locked()

    # -- persistence -------------------------------------------------------

    @staticmethod
    def _checksum(picks: Dict[str, str]) -> str:
        return hashlib.sha1(
            json.dumps(picks, sort_keys=True).encode()).hexdigest()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                doc = json.load(f)
            if doc.get("version") != self.VERSION:
                raise ValueError(f"version {doc.get('version')!r}")
            picks = doc.get("picks")
            if not isinstance(picks, dict) or any(
                    v not in ("hash", "join", "join-pallas")
                    for v in picks.values()):
                raise ValueError("malformed picks")
            if doc.get("checksum") != self._checksum(picks):
                raise ValueError("checksum mismatch")
            self.picks = dict(picks)
            self.measured = dict(doc.get("measured") or {})
        except FileNotFoundError:
            pass
        except Exception as e:  # corrupt table: defaults serve
            self.rejected = True
            log.warning("autotune pick table %s rejected (%s); "
                        "measuring fresh", self.path, e)

    def _save_locked(self) -> None:
        if not self.path:
            return
        doc = {
            "version": self.VERSION,
            "checksum": self._checksum(self.picks),
            "picks": self.picks,
            "measured": self.measured,
        }
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:
            log.warning("autotune pick table %s not persisted",
                        self.path, exc_info=True)

    def info(self) -> dict:
        return {
            "picks": dict(self.picks),
            "measured_shapes": len(self.measured),
            "family_hits": self.family_hits,
            "rejected_file": self.rejected,
            "path": self.path,
        }
