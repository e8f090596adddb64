"""Two-tier hot/cold match table (K7): the dense walk on a small hot table,
the hash walk on the cold one.

The port of ``emqx_tpu/ops/tiered.py``.  The filter set is partitioned by
root word:

* **hot tier** — filters under the most-published root prefixes,
  compiled into a table small enough for the dense walk
  (:mod:`~emqx_tpu_torch.ops.dense_match`, K6: exact, no active-set
  spill);
* **cold tier** — every other filter, matched by the hash walk
  (``nfa_walk.cu``).

Root-level wildcard filters (``+``/``#`` first word) replicate into both
tiers (a filter can only match a topic whose root equals its own root,
``+`` or ``#``), so each topic needs exactly one tier: per-batch routing
splits topics by root, and correctness is a partition argument.

Tier selection (:func:`pick_hot_roots`) ranks roots by published-topic
counts and admits them greedily while the projected hot table fits a
byte budget, then :func:`build_tiered` verifies by compiling.  The
reference sized that budget by a TPU core's VMEM (8 MiB, its
``pallas_match.VMEM_BUDGET_BYTES``); the port keeps the same number as
the hot table's budget, :data:`HOT_BUDGET_BYTES`, so that it picks the
same roots and builds the same tables.

:func:`fused_tiered_match` is the counterpart of the reference's single
XLA program of both tiers: the dense kernel and the hash-walk kernel go
onto the current stream back to back, with no host synchronisation
between them.

:class:`TieredMatcher` keeps the reference's engine names: ``dense`` is
K6; ``pallas`` and ``xla`` both run the hash walk in raw mode on the hot
table; ``auto`` resolves to ``dense`` when :func:`supports_dense` holds,
else to the walk; ``interpret`` is accepted and has no effect.  Rows that
spill a walk's active set (or pass the dense walk's K) fall open to the
host matcher, as in the reference.  The reference's runtime demotion of a
failing hot engine is not carried over: on the card an engine that fails
raises from ``match``, so a kernel that does not build or launch is not
hidden.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import topic as T
from .compiler import NfaTable, compile_filters, encode_topics
from .dense_match import (DENSE_STATE_CAP, _time_ms, build_dense,
                          dense_match, supports_dense)
from .device_table import resolve_device
from .match_kernel import nfa_match

__all__ = ["HOT_BUDGET_BYTES", "TieredTable", "TieredMatcher",
           "bench_tiered", "bench_tiered_workload", "build_tiered",
           "fused_tiered_match", "pick_hot_roots", "route", "split_filters",
           "supports_hot_table"]

#: byte budget of the hot tier's compiled table (node + edge table): the
#: reference's ``VMEM_BUDGET_BYTES``, kept so that both pick the same roots
HOT_BUDGET_BYTES = 8 << 20


def supports_hot_table(node_tab: np.ndarray, edge_tab: np.ndarray) -> bool:
    """The default fit of :func:`build_tiered`: the compiled hot table
    within :data:`HOT_BUDGET_BYTES` (the reference's ``supports_table``)."""
    return (node_tab.nbytes + edge_tab.nbytes) <= HOT_BUDGET_BYTES


def _root(flt: str) -> str:
    return flt.split("/", 1)[0]


def fused_tiered_match(hot_args, cold_args, active_slots: int = 8,
                       max_matches: int = 64):
    """Both tiers in one dispatch: the dense walk of ``hot_args`` and the
    raw hash walk of ``cold_args``, enqueued back to back on the current
    stream with no host synchronisation between them (on a table whose
    packed form is built, see :func:`~emqx_tpu_torch.ops.dense_match.
    dense_table`).  Returns ``(dense MatchResult, walk MatchResult)``.
    ``hot_args``/``cold_args`` are the positional tuples of
    :func:`~emqx_tpu_torch.ops.dense_match.dense_match` /
    :func:`~emqx_tpu_torch.ops.match_kernel.nfa_match`."""
    return (dense_match(*hot_args, max_matches=max_matches),
            nfa_match(*cold_args, active_slots=active_slots,
                      compact_output=False))


def split_filters(filters: Sequence[str],
                  hot_roots: Iterable[str]) -> Tuple[List[str], List[str]]:
    """(hot, cold) filter lists; root wildcards replicate into both."""
    hot_roots = set(hot_roots)
    hot: List[str] = []
    cold: List[str] = []
    for f in sorted(set(filters)):
        r = _root(f)
        if r in ("+", "#"):
            hot.append(f)
            cold.append(f)
        elif r in hot_roots:
            hot.append(f)
        else:
            cold.append(f)
    return hot, cold


def pick_hot_roots(
    filters: Sequence[str],
    topic_counts: Dict[str, int],
    vmem_budget_bytes: Optional[int] = None,
    depth: int = 8,
    state_budget: Optional[int] = None,
) -> List[str]:
    """Choose the hot root set: the roots with the most published
    traffic whose combined filter table is projected to fit the budget
    (``vmem_budget_bytes``, default :data:`HOT_BUDGET_BYTES`; or
    ``state_budget`` states for the dense tier).

    Projection: ~2.2 table rows (16 B each) per filter word; the
    builder verifies with a real compile and demotes if it was low."""
    if vmem_budget_bytes is None:
        vmem_budget_bytes = HOT_BUDGET_BYTES
    by_root: Dict[str, List[str]] = {}
    for f in set(filters):
        by_root.setdefault(_root(f), []).append(f)
    by_root.pop("+", None)
    by_root.pop("#", None)

    def score(root: str) -> Tuple[int, int]:
        # primary: observed publishes; tie-break: filter density
        return (topic_counts.get(root, 0), len(by_root[root]))

    ranked = sorted(by_root, key=score, reverse=True)
    budget_rows = vmem_budget_bytes // 16
    if state_budget is not None:
        # dense-tier mode: the budget is states; the same words-per-filter
        # estimate bounds them from above
        budget_rows = state_budget
    picked: List[str] = []
    rows = 0
    for root in ranked:
        if topic_counts and topic_counts.get(root, 0) == 0:
            break   # no observed traffic: not hot, stop admitting
        cost = int(sum(min(f.count("/") + 1, depth) for f in by_root[root])
                   * 2.2)
        if rows + cost > budget_rows:
            continue
        picked.append(root)
        rows += cost
    return picked


class TieredTable(NamedTuple):
    hot: Optional[NfaTable]     # None when no root qualified
    cold: NfaTable
    hot_roots: frozenset

    def stats(self) -> dict:
        hb = (int(self.hot.node_tab.nbytes + self.hot.edge_tab.nbytes)
              if self.hot is not None else 0)
        return {
            "hot_roots": len(self.hot_roots),
            "hot_filters": (len([f for f in self.hot.accept_filters
                                 if f is not None])
                            if self.hot is not None else 0),
            "cold_filters": len([f for f in self.cold.accept_filters
                                 if f is not None]),
            "hot_table_bytes": hb,
        }


def build_tiered(filters: Sequence[str], hot_roots: Iterable[str],
                 depth: int = 8, fit=None) -> TieredTable:
    """Compile both tiers; demote the lowest roots until the hot tier
    fits its engine's budget (the estimate of :func:`pick_hot_roots` is
    a guess, the compile decides).  ``fit(NfaTable) -> bool`` defaults
    to :func:`supports_hot_table`; pass ``supports_dense`` when building
    for the dense tier."""
    if fit is None:
        def fit(tab):
            return supports_hot_table(tab.node_tab, tab.edge_tab)

    roots = list(hot_roots)
    while roots:
        hot_f, cold_f = split_filters(filters, roots)
        hot_tab = compile_filters(hot_f, depth=depth) if hot_f else None
        if hot_tab is None or fit(hot_tab):
            return TieredTable(hot_tab, compile_filters(cold_f, depth=depth),
                               frozenset(roots))
        roots.pop()   # demote the least-hot admitted root and retry
    _, cold_f = split_filters(filters, ())
    return TieredTable(None, compile_filters(cold_f, depth=depth),
                       frozenset())


def route(topics: Sequence[str], hot_roots: frozenset) \
        -> Tuple[List[int], List[int]]:
    """Per-batch routing: topic indices → (hot, cold) by root prefix."""
    hot_idx: List[int] = []
    cold_idx: List[int] = []
    for i, t in enumerate(topics):
        if t.split("/", 1)[0] in hot_roots:
            hot_idx.append(i)
        else:
            cold_idx.append(i)
    return hot_idx, cold_idx


def _pow2(n: int, floor: int = 256) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


class TieredMatcher:
    """End-to-end two-tier matcher: ``match(topics) -> List[List[str]]``
    per-topic matched filters, on ``device`` (the card unless the caller
    names another).  Rows that spill the hot or cold walk's active set,
    or pass the dense walk's K, fall open to the host matcher."""

    def __init__(self, table: TieredTable, depth: int = 8,
                 active_slots: int = 8, interpret: bool = False,
                 hot_engine: str = "auto", *, device=None) -> None:
        self.table = table
        self.depth = depth
        self.active_slots = active_slots
        self.interpret = interpret   # accepted; no effect in the port
        if hot_engine not in ("auto", "pallas", "dense", "xla"):
            raise ValueError(f"unknown hot_engine {hot_engine!r}")
        self.hot_engine = hot_engine
        self.device = resolve_device(device)
        self._dense = None           # built on the first dense-tier batch
        self._shipped: Dict[int, List[torch.Tensor]] = {}
        self.hot_batches = 0
        self.cold_batches = 0
        self.hot_topics = 0
        self.cold_topics = 0

    def _resolved_hot_engine(self) -> str:
        if self.hot_engine == "auto":
            self.hot_engine = ("dense" if supports_dense(self.table.hot)
                               else "xla")
        return self.hot_engine

    def _ship(self, key: int, arrays) -> List[torch.Tensor]:
        """``arrays`` on the matcher's device, shipped once per table."""
        got = self._shipped.get(key)
        if got is None:
            got = self._shipped[key] = [
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in arrays]
        return got

    def _batch(self, tab: NfaTable, topics: List[str],
               batch: Optional[int] = None) -> List[torch.Tensor]:
        return [torch.from_numpy(a).to(self.device)
                for a in encode_topics(tab, topics, batch=batch)]

    def _match_hot(self, topics: List[str]) -> List[List[str]]:
        if self._resolved_hot_engine() == "dense":
            rows = self._match_hot_dense(topics)
        else:            # "pallas" and "xla": the hash walk, raw slots
            rows = self._match_gather(topics, self.table.hot)
        self.hot_batches += 1
        self.hot_topics += len(topics)
        return rows

    def _match_hot_dense(self, topics: List[str]) -> List[List[str]]:
        tab = self.table.hot
        if self._dense is None:
            self._dense = build_dense(tab)
        # a power-of-two batch, as the reference pads (its recompiles)
        res = dense_match(
            *self._batch(tab, topics, _pow2(len(topics))),
            *self._ship(id(self._dense), self._dense.device_arrays()),
            max_matches=64)
        acc = res.matches[: len(topics)].cpu().numpy()
        # the dense walk never spills; only rows past K need the host
        # matcher, and _decode's fail-open serves exactly those
        mover = res.match_overflow[: len(topics)].cpu().numpy()
        return self._decode(acc, mover, tab, topics)

    def _match_gather(self, topics: List[str],
                      tab: NfaTable) -> List[List[str]]:
        res = nfa_match(*self._batch(tab, topics),
                        *self._ship(id(tab), tab.device_arrays()),
                        active_slots=self.active_slots, compact_output=False)
        acc = res.matches[: len(topics)].cpu().numpy()
        aover = res.active_overflow[: len(topics)].cpu().numpy()
        return self._decode(acc, aover, tab, topics)

    def _match_cold(self, topics: List[str]) -> List[List[str]]:
        rows = self._match_gather(topics, self.table.cold)
        self.cold_batches += 1
        self.cold_topics += len(topics)
        return rows

    def _decode(self, acc, aover, tab: NfaTable,
                topics: List[str]) -> List[List[str]]:
        out: List[List[str]] = []
        live = tab.accept_filters
        for r, t in enumerate(topics):
            if aover[r]:
                # fail-open: this row's walk spilled; the host serves it
                out.append(sorted(
                    f for f in live
                    if f is not None and T.match(t, f)))
                continue
            row = acc[r]
            out.append([live[a] for a in row[row >= 0]])
        return out

    def match(self, topics: Sequence[str]) -> List[List[str]]:
        topics = list(topics)
        if self.table.hot is None:
            return self._match_cold(topics)
        hot_idx, cold_idx = route(topics, self.table.hot_roots)
        out: List[Optional[List[str]]] = [None] * len(topics)
        if hot_idx:
            for i, row in zip(hot_idx,
                              self._match_hot([topics[i]
                                               for i in hot_idx])):
                out[i] = row
        if cold_idx:
            for i, row in zip(cold_idx,
                              self._match_cold([topics[i]
                                                for i in cold_idx])):
                out[i] = row
        return out  # type: ignore[return-value]

    def info(self) -> dict:
        return {
            **self.table.stats(),
            "hot_engine": self.hot_engine,
            "hot_topics": self.hot_topics,
            "cold_topics": self.cold_topics,
            "hot_batches": self.hot_batches,
            "cold_batches": self.cold_batches,
        }


def bench_tiered_workload(n_filters: int = 200_000, batch: int = 8192,
                          depth: int = 8, hot_mass: float = 0.8):
    """``bench_tiered``'s seeded workload, the reference's draws in its
    order (seed 5): ``(filters, tiered, topics)``.  Traffic mass and
    filter mass are anti-correlated: 40 hot telemetry roots with 8
    filters each carry ``hot_mass`` of the topics, 5,000 command roots
    carry the bulk of the filters.  The hot tier is sized for the dense
    walk (``state_budget=DENSE_STATE_CAP``, ``fit=supports_dense``)."""
    rng = np.random.default_rng(5)
    n_hot_roots = 40
    hot_root_names = [f"h{i}" for i in range(n_hot_roots)]
    n_roots = 5000
    filters = sorted(
        {f"{r}/" + "/".join(
            ("+" if rng.random() < 0.3 else f"w{rng.integers(50)}")
            for _ in range(rng.integers(1, depth - 2)))
         + ("/#" if rng.random() < 0.2 else "")
         for r in hot_root_names for _ in range(8)}
        | {f"r{rng.integers(n_roots)}/" + "/".join(
            ("+" if rng.random() < 0.3 else f"w{rng.integers(50)}")
            for _ in range(rng.integers(1, depth - 2)))
           + ("/#" if rng.random() < 0.2 else "")
           for _ in range(n_filters)})
    counts = {r: 1_000_000 for r in hot_root_names}
    counts.update({f"r{i}": 10 for i in range(50)})
    hot_roots = pick_hot_roots(filters, counts, depth=depth,
                               state_budget=DENSE_STATE_CAP)
    tiered = build_tiered(filters, hot_roots, depth=depth,
                          fit=supports_dense)
    hot_list = sorted(tiered.hot_roots)   # entries are full roots ("h7")
    if not hot_list:
        raise ValueError("the workload seated no hot root")
    topics = []
    for _ in range(batch):
        if rng.random() < hot_mass:
            root = hot_list[rng.integers(len(hot_list))]
        else:
            root = f"r{rng.integers(n_roots)}"
        topics.append(root + "/"
                      + "/".join(f"w{rng.integers(50)}"
                                 for _ in range(rng.integers(1, depth - 2))))
    return filters, tiered, topics


def bench_tiered(n_filters: int = 200_000, batch: int = 8192,
                 iters: int = 10, depth: int = 8, hot_mass: float = 0.8, *,
                 device=None) -> dict:
    """Routed traffic through the two-tier table against everything
    through the hash walk on the whole table (device ms from CUDA events
    on the card, the host clock on the CPU): arm A the whole table's raw
    walk, arm B the hot subset's dense walk and the cold subset's walk
    called one after the other, arm C the same through
    :func:`fused_tiered_match`; then the matcher against the host
    matcher on a 128-topic slice."""
    dev = resolve_device(device)
    filters, tiered, topics = bench_tiered_workload(n_filters, batch, depth,
                                                    hot_mass)
    tm = TieredMatcher(tiered, depth=depth, device=dev)

    def put(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    out = {"device": str(dev), "n_filters": len(filters), **tiered.stats()}
    full = compile_filters(filters, depth=depth)
    args = put(encode_topics(full, topics, batch=batch)) + put(
        full.device_arrays())
    out["hbm_only_ms"] = _time_ms(
        lambda: nfa_match(*args, active_slots=8, compact_output=False),
        iters, dev)

    hot_idx, cold_idx = route(topics, tiered.hot_roots)
    out["routing"] = {"hot_topics": len(hot_idx),
                      "cold_topics": len(cold_idx)}
    dense = build_dense(tiered.hot)
    hargs = put(encode_topics(tiered.hot, [topics[i] for i in hot_idx],
                              batch=_pow2(len(hot_idx)))) + put(
        dense.device_arrays())
    cargs = put(encode_topics(tiered.cold, [topics[i] for i in cold_idx],
                              batch=_pow2(len(cold_idx)))) + put(
        tiered.cold.device_arrays())

    def routed_pass():
        return (dense_match(*hargs, max_matches=64),
                nfa_match(*cargs, active_slots=8, compact_output=False))

    out["tiered_ms"] = _time_ms(routed_pass, iters, dev)
    out["speedup"] = out["hbm_only_ms"] / out["tiered_ms"]
    out["dense_S"] = dense.S
    out["tiered_fused_ms"] = _time_ms(
        lambda: fused_tiered_match(hargs, cargs), iters, dev)
    out["speedup_fused"] = out["hbm_only_ms"] / out["tiered_fused_ms"]

    sample = topics[:128]
    t0 = time.perf_counter()
    got = tm.match(sample)
    out["match_128_s"] = time.perf_counter() - t0
    out["parity_mismatches_128"] = sum(
        1 for t, rows in zip(sample, got)
        if sorted(rows) != sorted(f for f in filters if T.match(t, f)))
    out["hot_engine"] = tm.hot_engine
    return out
