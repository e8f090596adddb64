"""Multi-device publish step: the batch sharded over ``dp``, the
accept→subscriber bitmap sharded by columns over ``tp`` (K8b).

The port of ``emqx_tpu/parallel/sharded_match.py``.  The NFA tables are
replicated; each ``(dp, tp)`` position walks its row group (once for
each distinct device of the grid row: the inputs are the same at every
``tp`` position) and ORs its column slice of the accept bitmap over the
rows' matches (:func:`or_accept_rows`, the ``accept_or`` kernel on the
card, with the row's popcount fused); the counts are summed over
``tp`` (:func:`~emqx_tpu_torch.parallel.collectives.psum`).  The compact
twin turns each shard's slice into global subscriber ids on the card
(:func:`compact_bitmap_ids`, the ``bitmap_compact`` kernel), so what
leaves the mesh is proportional to matches.  Bitmaps are int32 tensors
holding the reference's uint32 bit patterns; a step's outputs are
assembled on ``mesh.lead``.  The result tuples and the host decode are
the contract the multichip serve path shares.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from ..ops import bitmap_kernel as bk
from .collectives import psum
from .mesh import Mesh
from .steps import bitmap_ops, gather_to, on, walk_match, walks

__all__ = ["CompactFanoutResult", "FanoutResult",
           "build_sharded_matcher", "build_sharded_matcher_compact",
           "compact_bitmap_ids", "decode_compact_rows",
           "make_accept_bitmap", "or_accept_rows"]


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


def make_accept_bitmap(table, subscribers_of: Callable, n_subs: int,
                       tp: int = 1) -> np.ndarray:
    """The accept-id → subscriber-bitmap matrix ``(F+1, W)`` uint32 of
    ``table`` (an ``NfaTable`` or ``IncrementalNfa``: ``F`` accept ids,
    holes included):
    ``subscribers_of(filter)`` gives each accept filter's subscriber ids
    in ``[0, n_subs)``; row F (last) is all-zero and is what an invalid
    match slot reads; W is padded so that ``tp`` divides it."""
    words = (n_subs + 31) // 32
    if words % tp:
        words += tp - (words % tp)
    F = len(table.accept_filters)
    bm = np.zeros((F + 1, words), np.uint32)
    for aid, flt in enumerate(table.accept_filters):
        for sub in subscribers_of(flt):
            if not 0 <= sub < n_subs:
                raise ValueError(f"subscriber id {sub} out of range")
            bm[aid, sub >> 5] |= np.uint32(1) << np.uint32(sub & 31)
    return bm


def or_accept_rows(accept_bitmap: torch.Tensor,
                   matches: torch.Tensor) -> torch.Tensor:
    """``(F+1, W)`` accept bitmap × ``(B, K)`` match ids → ``(B, W)``
    OR-assembled subscriber rows; an invalid slot (-1) reads nothing
    (the reference's reads the all-zero sentinel row F: the same OR).
    The ``accept_or`` kernel on CUDA tensors, its plain version on the
    CPU."""
    return bk.accept_or(accept_bitmap, matches)[0]


def compact_bitmap_ids(bitmap: torch.Tensor, cap_row: int, id_base: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shard-local compaction of a ``(B, W)`` bitmap: ``(ids (B,
    cap_row), counts (B,), overflow (B,))``, each row's set bits as
    ascending global ids ``id_base + bit position``, -1 padded, the full
    popcount, 1 where it exceeds ``cap_row`` (the rows the host re-runs).
    The ``bitmap_compact`` kernel on CUDA tensors, its plain version on
    the CPU."""
    return bk.bitmap_compact(bitmap, cap_row, id_base)


def _fanout_shards(mesh: Mesh, active_slots: int, max_matches: int,
                   plain: bool):
    """``shards(words, lens, is_sys, node, edge, seeds, bitmap)``: for
    each dp row group, ``(devices, walk results, bitmaps, popcounts,
    Wl)`` of its tp positions, each bitmap that position's ``(Bl, Wl)``
    column slice OR-assembled."""
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    match = walk_match(active_slots, plain)
    ops = bitmap_ops(plain)

    def shards(words, lens, is_sys, node_tab, edge_tab, seeds,
               accept_bitmap):
        B = words.shape[0]
        W = accept_bitmap.shape[1]
        if B % dp or W % tp:
            raise ValueError(f"batch {B} or bitmap width {W} does not split "
                             f"over dp={dp}, tp={tp}")
        Bl, Wl = B // dp, W // tp
        for d in range(dp):
            devs = mesh.axis_devices("tp", (d, 0))
            rows = slice(d * Bl, (d + 1) * Bl)
            res = walks(match, devs, (words[rows], lens[rows], is_sys[rows]),
                        (node_tab, edge_tab, seeds), max_matches)
            bms, pcs = [], []
            for t, dev in enumerate(devs):
                cols = on(accept_bitmap[:, t * Wl:(t + 1) * Wl], dev)
                bm, pc = ops.accept_or(cols, res[t].matches)
                bms.append(bm)
                pcs.append(pc)
            yield devs, res, bms, pcs, Wl

    return shards


def build_sharded_matcher(mesh: Mesh, active_slots: int = 16,
                          max_matches: int = 32, plain: bool = False):
    """``step(words, lens, is_sys, node_tab, edge_tab, seeds,
    accept_bitmap) -> FanoutResult`` over a ``(dp, tp)`` mesh: batch rows
    split over ``dp``, the NFA tables replicated, ``accept_bitmap (F+1,
    W)`` split by columns over ``tp``; ``n_subscribers`` the per-shard
    popcounts summed over ``tp``.  Per dispatch: one walk for each
    distinct device of each grid row, ``dp·tp`` ``accept_or`` launches.
    ``plain`` runs the plain walk and the kernels' plain versions."""
    shards = _fanout_shards(mesh, active_slots, max_matches, plain)

    def step(words, lens, is_sys, node_tab, edge_tab, seeds, accept_bitmap):
        lead = mesh.lead
        out = []
        for devs, res, bms, pcs, _Wl in shards(
                words, lens, is_sys, node_tab, edge_tab, seeds,
                accept_bitmap):
            r = res[0]
            out.append((gather_to(bms, lead, 1), psum(pcs, devs)[0],
                        r.n_matches, r.active_overflow, r.match_overflow))
        return FanoutResult(*(gather_to(x, lead) for x in zip(*out)))

    return step


def build_sharded_matcher_compact(mesh: Mesh, cap_row: int = 64,
                                  active_slots: int = 16,
                                  max_matches: int = 32,
                                  plain: bool = False):
    """The dense-id twin of :func:`build_sharded_matcher`: each ``(dp,
    tp)`` position compacts its bitmap slice on its device into global
    subscriber ids (shard ``t`` owns ids from ``t·Wl·32``), so what
    leaves the mesh is ``ids (B, tp·cap_row)``, ``counts`` and
    ``overflow`` ``(B, tp)``.  Per dispatch: the walks and
    ``accept_or`` launches of the bitmap step and ``dp·tp``
    ``bitmap_compact`` launches."""
    shards = _fanout_shards(mesh, active_slots, max_matches, plain)
    ops = bitmap_ops(plain)

    def step(words, lens, is_sys, node_tab, edge_tab, seeds, accept_bitmap):
        lead = mesh.lead
        out = []
        for devs, res, bms, _pcs, Wl in shards(
                words, lens, is_sys, node_tab, edge_tab, seeds,
                accept_bitmap):
            segs = [ops.compact(bm, cap_row, t * Wl * 32)
                    for t, bm in enumerate(bms)]
            r = res[0]
            ids, n, over = zip(*segs)
            out.append((gather_to(ids, lead, 1),
                        gather_to([x[:, None] for x in n], lead, 1),
                        gather_to([x[:, None] for x in over], lead, 1),
                        r.n_matches, r.active_overflow, r.match_overflow))
        return CompactFanoutResult(*(gather_to(x, lead) for x in zip(*out)))

    return step
