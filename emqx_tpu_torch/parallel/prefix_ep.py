"""Prefix-partition helpers of the expert-parallel front end.

The pure host functions of ``emqx_tpu/parallel/prefix_ep.py`` that the
multichip serve path uses: the dry run's partition rule and the greedy
hot-root reassignment behind ``MultichipMatcher.plan_rebalance``.  The
EP matcher over per-owner tables (``build_partitions``,
``build_ep_matcher``, K8c) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["greedy_balance", "owner_of"]


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
