"""The synchronous serve core of the match plane.

The port of the serve stages of ``emqx_tpu/broker/match_service.py``
``MatchService``: the boundary where the node hands publish topics to the
device.  One :meth:`MatchService.serve` call chains the reference's
stages, with their names:

1. ``_depth_groups`` — split the batch by topic depth: topics with at
   most ``short_depth`` levels ride a shallow walk of the same table when
   both groups hold at least ``split_min`` topics;
2. ``_encode_dispatch`` — encode each group (padded to a power-of-two
   ``_bucket``) and dispatch the walk in flat mode with
   ``flat_cap = SERVE_FLAT_MULT · B``, one walk launch per group;
3. ``_readback_rows`` — copy each group's flat buffer and counters to
   the host and split it per row;
4. ``_collect_rows`` — stitch the groups back into batch order, re-run
   spilled rows (active-set or match overflow) on the host table, and
   merge the hits of filters too deep for the device table;
5. ``_split_row`` — accept ids → routing filter strings, from a host
   map kept beside the table (no call into the table per id).

Filter upkeep goes through :meth:`add` / :meth:`remove` and
:meth:`sync`, or :meth:`load` for a start from one bulk build;
``serve`` answers against the table as of the last sync.  ``table``
picks the host table, as the reference's ``tpu.table`` does: ``auto``
(the node default) and ``native`` build the C++ ``NativeNfa``,
``python`` the Python ``IncrementalNfa`` (the debug twin).  Where the
reference's ``auto`` falls back to Python when the native build fails,
the port raises.
``backend`` picks the walk, as the reference's ``match.backend`` does:
``hash`` (the cuckoo-probe kernel) or ``join`` / ``join-pallas`` (the
join kernel over the sorted edge relation, which the device table then
mirrors).
The reference's asyncio loops, deadline scheduler, pipeline, breaker,
autotuner, segments and mesh are not part of this core.  Nothing here
stands in for a failing kernel: a kernel error propagates to the caller.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import topic as T
from ..native.nfa import NativeNfa
from ..ops.device_table import JOIN_BACKENDS, DeviceNfa, check_backend
from ..ops.encode import TopicEncoder, encode_batch, table_encoder
from ..ops.incremental import IncrementalNfa
from ..ops.match_kernel import SERVE_FLAT_MULT, decode_flat
from .trie import FilterTrie

__all__ = ["TABLES", "MatchService"]

#: the host tables ``MatchService(table=...)`` builds; ``auto`` is native
TABLES = ("auto", "native", "python")


def _validate_all(filters: Sequence[str]) -> None:
    """``topic.validate`` of every filter (raises TopicError at the first
    invalid one).  The common case runs vectorised over the joined
    bytes: with no NUL, empty, over-long or shared-subscription filter,
    a filter is valid when each '+' and '#' stands between separators
    ('/' or a filter boundary) and each '#' ends its filter; the filters
    around a byte that is not are validated one by one."""
    blob = "\n".join(filters).encode()
    nl, sep, plus, hash_ = (np.uint8(ord(c)) for c in "\n/+#")
    pad = np.concatenate(([nl], np.frombuffer(blob, np.uint8), [nl]))
    bounds = np.flatnonzero(pad == nl)
    lens = np.diff(bounds) - 1
    if (len(lens) != len(filters) or b"\x00" in blob or b"$share/" in blob
            or b"$queue/" in blob or lens.min(initial=1) == 0
            or lens.max(initial=0) > T.MAX_TOPIC_LEN):
        # also: a filter holds '\n' (legal in MQTT) or there are none
        for f in filters:
            T.validate(f, "filter")
        return
    at = np.flatnonzero((pad == plus) | (pad == hash_))
    before, here, after = pad[at - 1], pad[at], pad[at + 1]
    bad = ((before != sep) & (before != nl)) | (after != nl) & (
        (here == hash_) | (after != sep))
    for p in (at[bad] - 1).tolist():
        lo = blob.rfind(b"\n", 0, p) + 1
        hi = blob.find(b"\n", p)
        T.validate(blob[lo:len(blob) if hi < 0 else hi].decode(), "filter")


def _table_sizing(n: int) -> Tuple[int, int]:
    """Initial (S, Hb) of a native table for ``n`` filters, as the
    reference bench's ``build_table``: about 2.2 states and 1.4 buckets
    (two slots each) per filter, rounded up to powers of two."""
    n = max(2, n)
    return (max(1024, 1 << int(np.ceil(np.log2(n * 2.2)))),
            max(64, 1 << int(np.ceil(np.log2(n * 1.4)))))


def _bucket(n: int, minimum: int = 64) -> int:
    """Padded batch size: the next power of two ≥ max(n, minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


class MatchService:
    """Wildcard filters mirrored into a resident device table; topic
    batches matched on the device with host fail-open for spilled rows.
    Defaults are the node's (``tpu.max_levels`` 16, ``tpu.short_depth``
    4, ``tpu.split_min`` 256, ``tpu.active_slots`` 16,
    ``tpu.max_matches`` 128, ``tpu.batch_size`` 2048, ``match.backend``
    hash, ``tpu.table`` auto)."""

    FLAT_MULT = SERVE_FLAT_MULT

    def __init__(self, depth: int = 16, active_slots: int = 16,
                 max_matches: int = 128, short_depth: int = 4,
                 split_min: int = 256, max_batch: int = 2048,
                 device: Union[None, str, torch.device] = None,
                 backend: str = "hash", table: str = "auto") -> None:
        check_backend(backend)
        if table not in TABLES:
            raise ValueError(f"unknown host table {table!r}")
        self.backend = backend
        self.depth = depth
        self.short_depth = short_depth
        self.split_min = split_min
        self.max_batch = max_batch
        self.table_kind = "python" if table == "python" else "native"
        self.inc = (IncrementalNfa(depth=depth) if self.table_kind == "python"
                    else NativeNfa(depth=depth))
        self.dev = self._bind_device(self.inc, active_slots, max_matches,
                                     device)
        self._deep: Dict[str, int] = {}    # too-deep filter -> alias aid
        self._deep_trie = FilterTrie()     # host match for too-deep filters
        # accept id -> its routing filter (None: a free id): the split
        # stage's map, kept here so that it asks the table nothing per id.
        # A list, not a dict: an index costs fewer cache misses than a
        # hash probe that also compares the stored int key (with 1M ids
        # a dict took 1.1-1.6x the list's split time per id on an H100
        # machine's host).  The price: the cyclic GC walks the list at
        # every full collection (PERF.md).
        self._filter_of: List[Optional[str]] = []
        # counters: walk dispatches (join_dispatches: those of a join
        # backend), served batches/topics, host re-runs
        self.dispatches = 0
        self.join_dispatches = 0
        self.batches = 0
        self.topics = 0
        self.fallback_host = 0
        self.load_seconds: Dict[str, float] = {}

    def _bind_device(self, inc, active_slots: int, max_matches: int,
                     device) -> DeviceNfa:
        dev = DeviceNfa(inc, active_slots=active_slots,
                        max_matches=max_matches, device=device, lazy=True)
        if self.backend in JOIN_BACKENDS:
            dev.enable_join()
        return dev

    @property
    def encoder(self) -> TopicEncoder:
        """The topic encoder cached on the host table (its
        ``native_batches`` / ``python_batches`` count what it served)."""
        return table_encoder(self.inc)

    # -- filter upkeep -----------------------------------------------------

    def load(self, filters: Sequence[str]) -> int:
        """Start an empty, never synced service from ``filters`` in one
        build; returns the number of distinct filters it holds.  On the
        native table this is the large-table path: every filter is
        validated (``topic.validate``; raises TopicError), one
        ``bulk_add`` fills a table sized as the reference bench's
        ``build_table``, and the routing ids are derived with one bulk
        ``aid_of`` over the list, as the reference's reconcile does for
        a freshly bulk-loaded table; filters deeper than the table get
        alias ids; ``load_seconds`` keeps the three steps' seconds.  On
        the Python table it is :meth:`add` per filter."""
        if self.inc.n_filters or self._deep or self.dev.epoch != -1:
            raise RuntimeError("load() needs an empty, never synced service")
        if self.table_kind == "python":
            for f in filters:
                self.add(f)
            return self.n_routing
        t0 = time.perf_counter()
        filters = list(filters)
        _validate_all(filters)
        t1 = time.perf_counter()
        s, hb = _table_sizing(len(filters))
        inc = NativeNfa(depth=self.depth, state_bucket=s, edge_bucket=hb)
        inc.bulk_add(filters)
        self.inc = inc
        self.dev = self._bind_device(inc, self.dev.active_slots,
                                     self.dev.max_matches, self.dev.device)
        t2 = time.perf_counter()
        aids = inc.bulk_aid_of(filters)
        fo = self._filter_of = [None] * (int(aids.max(initial=-1)) + 1)
        for aid, f in zip(aids.tolist(), filters):
            if aid >= 0:
                fo[aid] = f
        for i in np.flatnonzero(aids < 0).tolist():
            # not in the table: deeper than it (validated above)
            self.add(filters[i])
        self.load_seconds = {"validate": t1 - t0, "bulk_add": t2 - t1,
                             "routing": time.perf_counter() - t2}
        return self.n_routing

    @property
    def n_routing(self) -> int:
        """Routing filters held (the table's and the too-deep ones)."""
        return len(self._filter_of) - self._filter_of.count(None)

    def add(self, flt: str) -> bool:
        """Mirror wildcard filter ``flt``; False if already present.
        Filters deeper than the table get an alias id and live in the
        host trie."""
        T.validate(flt, "filter")
        if flt in self._deep or self.inc.aid_of(flt) >= 0:
            return False
        if len(T.words(flt)) > self.depth:
            aid = self.inc.alloc_alias(flt)
            self._deep[flt] = aid
            self._deep_trie.insert(flt)
        else:
            self.inc.add(flt)
            aid = self.inc.aid_of(flt)
        fo = self._filter_of
        if aid >= len(fo):
            fo.extend([None] * (aid + 1 - len(fo)))
        fo[aid] = flt
        return True

    def remove(self, flt: str) -> bool:
        """Drop filter ``flt``; False if absent."""
        aid = self._deep.get(flt)
        if aid is None:
            aid = self.inc.aid_of(flt)
        if aid < 0:
            return False
        self._filter_of[aid] = None
        if flt in self._deep:
            del self._deep[flt]
            self._deep_trie.delete(flt)
            self.inc.free_alias(aid)
        else:
            self.inc.remove(flt)
        return True

    def sync(self) -> bool:
        """Apply the host mutations to the device table (rows written in
        place, or a whole upload after the table grew)."""
        return self.dev.sync()

    # -- serving -----------------------------------------------------------

    def serve(self, topics: Sequence[str]) -> List[List[str]]:
        """Matching routing filters for each topic, in batches of at most
        ``max_batch`` topics."""
        out: List[List[str]] = []
        for lo in range(0, len(topics), self.max_batch):
            batch = list(topics[lo:lo + self.max_batch])
            groups = self._depth_groups(batch)
            handles = self._encode_dispatch(batch, groups)
            results = [self._readback_rows(res, n, self.dev.max_matches)
                       for res, n in handles]
            rows = self._collect_rows(batch, groups, results)
            out.extend(self._split_row(row) for row in rows)
        return out

    def _depth_groups(self, topics: List[str]) -> List[Tuple[List[int], int]]:
        """Partition batch indices into (indices, walk depth) groups.
        The walk depth bounds TOPIC length, not filter depth, so short
        topics are exact through a shallow walk of the same table."""
        sd = self.short_depth
        everything = [(list(range(len(topics))), self.depth)]
        if not sd or sd >= self.depth:
            return everything
        short = [i for i, t in enumerate(topics) if t.count("/") < sd]
        if len(short) < self.split_min or \
                len(topics) - len(short) < self.split_min:
            return everything
        sset = set(short)
        long_ = [i for i in range(len(topics)) if i not in sset]
        return [(short, sd), (long_, self.depth)]

    def _encode_dispatch(self, topics: List[str], groups):
        """Encode every depth group and dispatch its walk.  Returns
        ``[(MatchResult, rows in group)]``; the results are still being
        computed on the device when this returns."""
        handles = []
        for idx, d in groups:
            enc = encode_batch(self.inc, [topics[i] for i in idx],
                               batch=_bucket(len(idx)), depth=d)
            res = self.dev.match(*self.dev.put_batch(*enc),
                                 flat_cap=self.FLAT_MULT * enc[0].shape[0],
                                 backend=self.backend)
            self.dispatches += 1
            if self.backend in JOIN_BACKENDS:
                self.join_dispatches += 1
            handles.append((res, len(idx)))
        return handles

    @staticmethod
    def _readback_rows(res, n: int, k: int):
        """Copy a flat-mode result to the host: ``(per-row id lists,
        spilled row indices)`` for the first ``n`` rows."""
        matches, counts, aover, mover = (
            t.cpu().numpy() for t in (res.matches, res.n_matches,
                                      res.active_overflow,
                                      res.match_overflow))
        sp = (aover > 0) | (mover > 0)
        rows = [seg.tolist() for seg in decode_flat(matches, counts, k)[:n]]
        return rows, np.flatnonzero(sp[:n]).tolist()

    def _deep_ids(self, topic: str) -> List[int]:
        if not self._deep:
            return []
        return [self._deep[f] for f in self._deep_trie.match(topic)]

    def _host_ids(self, topic: str) -> List[int]:
        return self.inc.match_host(topic) + self._deep_ids(topic)

    def _collect_rows(self, topics: List[str], groups, results):
        """Stitch group results back into batch order, re-run spilled
        rows on the host tables and merge too-deep filter hits."""
        rows: List[List[int]] = [[] for _ in topics]
        spilled: List[int] = []
        for (idx, _d), (grows, gspill) in zip(groups, results):
            for j, i in enumerate(idx):
                rows[i] = grows[j]
            spilled.extend(idx[j] for j in gspill)
        for r in spilled:
            rows[r] = self._host_ids(topics[r])
        self.fallback_host += len(spilled)
        if self._deep:
            spset = set(spilled)
            for r, t in enumerate(topics):
                if r not in spset:
                    rows[r].extend(self._deep_ids(t))
        self.batches += len(groups)
        self.topics += len(topics)
        return rows

    def _split_row(self, row: List[int]) -> List[str]:
        """Accept-id row → routing wildcard filters, from the host map
        (an id freed by a remove and reused by a later add maps to the
        filter that holds it now, as the reference's accept table does)."""
        return [f for f in map(self._filter_of.__getitem__, row)
                if f is not None]
