"""The port's own copy of the reference's ``emqx_tpu/observe/hist.py``, so
that nothing here imports the JAX package.

Mergeable fixed-bucket latency histograms — the stage-level
latency observatory's storage layer.

Every p50/p99 in this repo used to be an ad-hoc ``np.percentile`` over
a Python list private to one bench section; production had no latency
*distributions* at all, only EWMAs.  This module gives both sides one
definition:

* :class:`LatencyHistogram` — a preallocated integer-count array over
  **sub-bucketed log2 buckets** of nanoseconds (16 linear sub-buckets
  per octave, so a bucket is never wider than 1/16 of its value —
  percentile extraction stays within ~6% of the exact sample
  percentile, cheap enough to assert parity against ``np.percentile``
  in the bench smoke).  Recording is one ``bit_length`` + shift + one
  list-index increment — no locks, no allocation;
* **single-writer discipline**: each histogram instance is written by
  exactly one thread (the event loop, one shard loop, one match worker
  stage); cross-plane reads go through :meth:`LatencyHistogram.merged`,
  which sums count arrays at read time — writers are never paused;
* :class:`HistSet` — one plane's named histogram table over the fixed
  :data:`HIST_NAMES` registry (drift-checked by staticcheck exactly
  like ``METRIC_NAMES``: a typo'd name raises at the cold lookup site,
  never silently records into nowhere).

The stage names map the serve path end to end (see README §span map):

========================  ==================================================
``obs.stage.ingest_parse``    one ``Parser.feed`` call per transport read
``obs.stage.fanout_queue``    fanout-batch queue wait (oldest message, per
                              batch pop)
``obs.stage.match_wait``      prefetch waiter enqueue → serve-loop dispatch
``obs.stage.match_encode``    ``encode_batch`` per depth group (worker
                              thread)
``obs.stage.match_dispatch``  kernel dispatch per depth group (worker
                              thread)
``obs.stage.match_readback``  d2h readback per batch (worker thread /
                              readback child)
``obs.stage.deliver``         fanout stage 4 — grouped ``Session.deliver``
                              per chunk
``obs.stage.flush``           fanout stage 5 — coalesced ``emit`` per chunk
``obs.e2e.publish_deliver``   publish timestamp → delivery (sampled once
                              per session per chunk on the batched path;
                              per-leg via SlowSubs when enabled)
``obs.e2e.publish_deliver_leg``  per-LEG publish→deliver variant, every
                              Nth delivery leg (the per-subscriber skew
                              signal; ``obs.hist.e2e_per_leg_sample``,
                              0 = off and the site is zero-call)
========================  ==================================================

**Zero cost when off** (the ``_injector is None`` idiom): recording
sites hold a direct histogram reference that is ``None`` when
``obs.hist.enable`` is off — the hot path pays one attribute load and
an identity test, no function call (spy-asserted in
tests/test_observe.py).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

__all__ = ["LatencyHistogram", "HistSet", "HIST_NAMES"]

#: the fixed histogram registry — additions only, drift-checked by the
#: staticcheck ``registry-drift`` rule against literal ``.hist("...")``
#: call sites (the METRIC_NAMES discipline)
HIST_NAMES: List[str] = [
    "obs.stage.ingest_parse",
    "obs.stage.fanout_queue",
    "obs.stage.match_wait",
    "obs.stage.match_encode",
    "obs.stage.match_dispatch",
    "obs.stage.match_readback",
    "obs.stage.deliver",
    "obs.stage.flush",
    "obs.e2e.publish_deliver",
    "obs.e2e.publish_deliver_leg",
]

# -- bucket geometry --------------------------------------------------------
# 16 linear sub-buckets per power-of-two octave of nanoseconds: bucket
# width <= value/16, so percentile extraction is exact to ~6% relative.
# Durations below 16 ns land in 16 exact unit buckets; durations above
# ~2^45 ns (~9.7 h) clamp into the last bucket.
_SUB_BITS = 4
_SUB = 1 << _SUB_BITS                       # 16
_MAX_EXP = 45
_N_BUCKETS = (_MAX_EXP - _SUB_BITS + 1) * _SUB + _SUB   # 688


def _bucket_of(ns: int) -> int:
    if ns < _SUB:
        return ns if ns >= 0 else 0
    k = ns.bit_length() - 1                  # 2^k <= ns < 2^(k+1)
    idx = ((k - _SUB_BITS) << _SUB_BITS) + (ns >> (k - _SUB_BITS))
    return idx if idx < _N_BUCKETS else _N_BUCKETS - 1


def _bucket_bounds(idx: int) -> tuple:
    """(lower, width) in ns of bucket ``idx`` — the inverse of
    :func:`_bucket_of` up to sub-bucket resolution."""
    if idx < _SUB:
        return idx, 1
    k = (idx >> _SUB_BITS) + _SUB_BITS - 1   # octave exponent
    shift = k - _SUB_BITS
    sub = idx - ((k - _SUB_BITS) << _SUB_BITS)   # in [_SUB, 2*_SUB)
    return sub << shift, 1 << shift


class LatencyHistogram:
    """One single-writer latency histogram (durations in nanoseconds).

    ``record`` is the hot-path entry: one bucket computation + one list
    increment, no allocation.  Reads (``percentile``, ``merged``,
    ``snapshot``) copy/sum the counts and never pause the writer —
    under the GIL a concurrent reader sees each bucket either before or
    after an increment, which for a histogram is always a valid state.
    """

    __slots__ = ("counts",)

    def __init__(self) -> None:
        self.counts: List[int] = [0] * _N_BUCKETS

    # -- write side (single writer) ------------------------------------

    def record(self, dur_ns: int) -> None:
        self.counts[_bucket_of(dur_ns)] += 1

    def record_s(self, dur_s: float) -> None:
        """Seconds-flavored :meth:`record` for wall-clock deltas."""
        self.counts[_bucket_of(int(dur_s * 1e9))] += 1

    def record_many_s(self, durs_s) -> None:
        """Bulk-record an array/iterable of float seconds (the bench
        harness path: one call per batch, vectorized bucketing)."""
        try:
            import numpy as np

            ns = (np.asarray(durs_s, dtype=np.float64) * 1e9)
            ns = np.maximum(ns, 0.0).astype(np.int64)
            small = ns < _SUB
            k = np.frexp(ns.astype(np.float64))[1] - 1   # floor(log2)
            k = np.maximum(k, _SUB_BITS)
            idx = np.where(
                small, ns,
                ((k - _SUB_BITS) << _SUB_BITS) + (ns >> (k - _SUB_BITS)))
            idx = np.minimum(idx, _N_BUCKETS - 1)
            bc = np.bincount(idx.astype(np.int64),
                             minlength=_N_BUCKETS)
            c = self.counts
            for i in np.flatnonzero(bc):
                c[i] += int(bc[i])
        except ImportError:                      # pragma: no cover
            for d in durs_s:
                self.record_s(float(d))

    def reset(self) -> None:
        self.counts = [0] * _N_BUCKETS

    # -- read side ------------------------------------------------------

    @property
    def count(self) -> int:
        return sum(self.counts)

    def snapshot(self) -> List[int]:
        return list(self.counts)

    @staticmethod
    def merged(hists: Iterable["LatencyHistogram"]) -> "LatencyHistogram":
        """Sum counts across planes at read time (lock-free: each
        source keeps being written; the merge is a point-in-time sum)."""
        out = LatencyHistogram()
        oc = out.counts
        for h in hists:
            for i, c in enumerate(h.counts):
                if c:
                    oc[i] += c
        return out

    def percentile_ns(self, q: float) -> float:
        """Exact-to-bucket-resolution percentile (``q`` in [0, 100]),
        linearly interpolated inside the landing bucket the way
        ``np.percentile`` interpolates between samples."""
        counts = self.counts
        total = sum(counts)
        if total == 0:
            return 0.0
        rank = (q / 100.0) * (total - 1)
        cum = 0
        for idx, c in enumerate(counts):
            if not c:
                continue
            if cum + c > rank:
                lower, width = _bucket_bounds(idx)
                frac = (rank - cum + 0.5) / c
                return lower + width * min(max(frac, 0.0), 1.0)
            cum += c
        lower, width = _bucket_bounds(_N_BUCKETS - 1)  # pragma: no cover
        return float(lower + width)

    def percentile_ms(self, q: float) -> float:
        return self.percentile_ns(q) / 1e6

    def max_ms(self) -> float:
        for idx in range(_N_BUCKETS - 1, -1, -1):
            if self.counts[idx]:
                lower, width = _bucket_bounds(idx)
                return (lower + width) / 1e6
        return 0.0

    def to_dict(self) -> Dict[str, float]:
        """The export shape every surface ($SYS, REST, statsd, bench
        JSON) shares — one latency definition everywhere."""
        return {
            "count": self.count,
            "p50_ms": round(self.percentile_ms(50), 4),
            "p95_ms": round(self.percentile_ms(95), 4),
            "p99_ms": round(self.percentile_ms(99), 4),
            "max_ms": round(self.max_ms(), 4),
        }


class HistSet:
    """One plane's histogram table over the fixed registry.

    A plane = one writer context (the main event loop, one shard loop,
    one match worker stage).  Sites resolve their histogram ONCE at
    setup via :meth:`hist` (an unknown literal raises — the
    ``Metrics`` fixed-table discipline, backed by the staticcheck
    ``registry-drift`` rule) and keep the direct reference.
    """

    __slots__ = ("plane", "_h")

    def __init__(self, plane: str = "main",
                 names: Optional[Iterable[str]] = None) -> None:
        self.plane = plane
        self._h: Dict[str, LatencyHistogram] = {
            n: LatencyHistogram() for n in (names or HIST_NAMES)
        }

    def hist(self, name: str) -> LatencyHistogram:
        return self._h[name]

    def names(self) -> List[str]:
        return list(self._h)

    @staticmethod
    def merge_all(sets: Iterable["HistSet"]) -> Dict[str, LatencyHistogram]:
        """Read-time union across planes: name → merged histogram."""
        grouped: Dict[str, List[LatencyHistogram]] = {}
        for hs in sets:
            for name, h in hs._h.items():
                grouped.setdefault(name, []).append(h)
        return {n: LatencyHistogram.merged(hs)
                for n, hs in grouped.items()}

    @staticmethod
    def percentiles(sets: Iterable["HistSet"]) -> Dict[str, Dict[str, float]]:
        return {n: h.to_dict()
                for n, h in HistSet.merge_all(sets).items()}
