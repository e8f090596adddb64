"""Seeded wildcard workload: the port's own copy of the reference
benchmark's ``build_workload`` (``bench.py``), BASELINE config 2/3 shape.

Filters and topics come from a Zipfian topic tree (hot prefixes):
``L{d}w{i}`` words with ``max(4, 2**(d+2))`` choices at level d, 45% of
filters with one ``+`` level, 30% with a ``#`` tail, the rest literal;
topics are 2..depth levels deep.  The same ``rng`` state gives the same
filters and topics as the reference: the draws are the reference's, in
its order.  The reference edits a list of words per filter in a Python
loop; here the edits run on a (rows, depth) array of word codes and only
the string joins loop, which makes the 10M table's workload about twice
as fast to build.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["build_workload"]

_PAD, _PLUS, _HASH = -1, -2, -3     # word codes past a path's end, '+', '#'


def build_workload(rng: np.random.Generator, n_filters: int, n_topics: int,
                   depth: int = 8) -> Tuple[List[str], List[str]]:
    """``(sorted filters, topics)``: ``n_filters`` distinct wildcard-heavy
    filters and ``n_topics`` concrete publish topics."""
    sizes = [max(4, 2 ** (d + 2)) for d in range(depth)]
    zipf_w = []
    for n in sizes:
        w = 1.0 / np.arange(1, n + 1)
        zipf_w.append(w / w.sum())
    words = np.array([f"L{d}w{i}" for d, n in enumerate(sizes)
                      for i in range(n)] + ["+", "#"], dtype=object)
    offset = np.cumsum([0] + sizes[:-1]).astype(np.int32)
    special = {_PLUS: len(words) - 2, _HASH: len(words) - 1}

    def rand_paths(count):
        """``(depths, codes)``: level d's word index in column d, _PAD
        past the path's depth."""
        depths = rng.integers(2, depth + 1, size=count)
        codes = np.stack([rng.choice(n, size=count, p=w)
                          for n, w in zip(sizes, zipf_w)], axis=1)
        codes = codes.astype(np.int32)
        codes[np.arange(depth) >= depths[:, None]] = _PAD
        return depths, codes

    def joined(codes) -> List[str]:
        idx = codes + offset
        for code, at in special.items():
            idx[codes == code] = at
        idx[codes == _PAD] = 0
        rows = words[idx].tolist()
        lens = (codes != _PAD).sum(axis=1).tolist()
        return ["/".join(r[:k]) for r, k in zip(rows, lens)]

    filters: set = set()
    while len(filters) < n_filters:
        need = int((n_filters - len(filters)) * 1.3) + 16
        kinds = rng.random(need)
        plus_pos = rng.random(need)
        hash_cut = rng.random(need)
        depths, codes = rand_paths(need)
        rows = np.arange(need)
        plus = kinds < 0.45                 # '+' somewhere
        at = (plus_pos * depths).astype(np.int64)
        codes[rows[plus], at[plus]] = _PLUS
        cut = ~plus & (kinds < 0.75)        # '#' tail (replaces >=1 level)
        keep = np.maximum((hash_cut * (depths - 1)).astype(np.int64), 1)
        codes[cut] = np.where(np.arange(depth) < keep[cut, None], codes[cut],
                              _PAD)
        codes[rows[cut], keep[cut]] = _HASH
        # the reference adds filters in draw order until it has enough
        fresh = [f for f in dict.fromkeys(joined(codes)) if f not in filters]
        filters.update(fresh[: n_filters - len(filters)])
    topics = joined(rand_paths(n_topics)[1])
    return sorted(filters), topics
