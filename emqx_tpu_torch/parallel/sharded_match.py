"""The result contracts of the multi-device match plane.

The part of ``emqx_tpu/parallel/sharded_match.py`` that the multichip
serve path uses: the two result tuples and the host decode of the dense
compact contract.  The library steps of that module (the replicated
walk with column-sharded accept bitmaps, K8b) are not ported yet.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

__all__ = ["CompactFanoutResult", "FanoutResult", "decode_compact_rows"]


class FanoutResult(NamedTuple):
    bitmap: torch.Tensor          # (B, W) per-topic subscriber bitmap
    n_subscribers: torch.Tensor   # (B,) int32 popcount over the full row
    n_matches: torch.Tensor       # (B,) int32 matched filter count
    active_overflow: torch.Tensor  # (B,) int32 per-row spills (fail-open)
    match_overflow: torch.Tensor   # (B,) int32 1 where count > K


class CompactFanoutResult(NamedTuple):
    """Dense-id fan-out: per-row id segments, one per ``tp`` shard, in
    disjoint per-shard order (the partition makes the union a plain
    concatenation, no dedup).  What leaves the mesh is proportional to
    matches, not table width."""

    ids: torch.Tensor             # (B, tp·cap_row) int32, -1 padded
    counts: torch.Tensor          # (B, tp) int32 ids per segment
    overflow: torch.Tensor        # (B, tp) int32 1 where a segment truncated
    n_matches: torch.Tensor       # (B,) int32
    active_overflow: torch.Tensor  # (B,) int32 (fail-open set)
    match_overflow: torch.Tensor  # (B,) int32


def decode_compact_rows(ids: np.ndarray, counts: np.ndarray,
                        cap_row: int) -> List[np.ndarray]:
    """Host decode of a :class:`CompactFanoutResult`: per row, the first
    ``min(count, cap_row)`` ids of each segment, segments concatenated.
    ``ids`` is (B, tp·cap_row), ``counts`` (B, tp).  A truncated segment
    decodes to its surviving prefix; callers re-run flagged rows."""
    B, tp = counts.shape
    out = []
    for r in range(B):
        segs = [ids[r, t * cap_row:t * cap_row
                    + min(int(counts[r, t]), cap_row)]
                for t in range(tp)]
        out.append(np.concatenate(segs) if segs else
                   np.empty(0, np.int32))
    return out
