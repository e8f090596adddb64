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
5. ``_split_row`` — accept ids → routing filter strings.

Filter upkeep goes through :meth:`add` / :meth:`remove` and
:meth:`sync`; ``serve`` answers against the table as of the last sync.
``backend`` picks the walk, as the reference's ``match.backend`` does:
``hash`` (the cuckoo-probe kernel) or ``join`` / ``join-pallas`` (the
join kernel over the sorted edge relation, which the device table then
mirrors).
The reference's asyncio loops, deadline scheduler, pipeline, breaker,
autotuner, segments and mesh are not part of this core.  Nothing here
stands in for a failing kernel: a kernel error propagates to the caller.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple, Union

import numpy as np
import torch

from .. import topic as T
from ..ops.device_table import JOIN_BACKENDS, DeviceNfa, check_backend
from ..ops.encode import encode_batch
from ..ops.incremental import IncrementalNfa
from ..ops.match_kernel import SERVE_FLAT_MULT, decode_flat
from .trie import FilterTrie

__all__ = ["MatchService"]


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
    hash)."""

    FLAT_MULT = SERVE_FLAT_MULT

    def __init__(self, depth: int = 16, active_slots: int = 16,
                 max_matches: int = 128, short_depth: int = 4,
                 split_min: int = 256, max_batch: int = 2048,
                 device: Union[None, str, torch.device] = None,
                 backend: str = "hash") -> None:
        check_backend(backend)
        self.backend = backend
        self.depth = depth
        self.short_depth = short_depth
        self.split_min = split_min
        self.max_batch = max_batch
        self.inc = IncrementalNfa(depth=depth)
        self.dev = DeviceNfa(self.inc, active_slots=active_slots,
                             max_matches=max_matches, device=device,
                             lazy=True)
        if backend in JOIN_BACKENDS:
            self.dev.enable_join()
        self._deep: Dict[str, int] = {}    # too-deep filter -> alias aid
        self._deep_trie = FilterTrie()     # host match for too-deep filters
        self._routing_aids: Set[int] = set()
        # counters: walk dispatches (join_dispatches: those of a join
        # backend), served batches/topics, host re-runs
        self.dispatches = 0
        self.join_dispatches = 0
        self.batches = 0
        self.topics = 0
        self.fallback_host = 0

    # -- filter upkeep -----------------------------------------------------

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
        self._routing_aids.add(aid)
        return True

    def remove(self, flt: str) -> bool:
        """Drop filter ``flt``; False if absent."""
        aid = self._deep.get(flt)
        if aid is None:
            aid = self.inc.aid_of(flt)
        if aid < 0:
            return False
        self._routing_aids.discard(aid)
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
        """Accept-id row → routing wildcard filters."""
        table = self.inc.accept_filters
        out = []
        for aid in row:
            if aid in self._routing_aids:
                f = table[aid]
                if f is not None:
                    out.append(f)
        return out
