"""Config-5 device stage: ring-tiled accept-bitmap OR-reduction (K8d).

The port of ``emqx_tpu/parallel/ring_fanout.py``.  When the
accept→subscriber bitmap outgrows one device, its ROWS (accept ids) shard
over a ``ring`` mesh axis.  Each position walks its dp row group (once
for each distinct device of the ring: the inputs are the same at every
position) and ORs the rows it owns over the matches (the ``accept_or``
kernel with the shard's id window); the partial bitmaps then rotate
around the ring ``ring - 1`` times with
:func:`~emqx_tpu_torch.parallel.collectives.ppermute`, each position
ORing what arrives, so every position ends with the full reduction.  The
result is the ring's first position's (the reference's replicated
output spec returns that one).

The compact form rotates each shard's compacted id lists instead (the
``bitmap_compact`` kernel), re-expanded into a bitmap tile at each hop
by a scatter-add of single bits into a zero tile (ids are unique within
a row, so the add is an OR; a -1 pad writes a spare column, cut off).
"""

from __future__ import annotations

import numpy as np
import torch

from .collectives import ppermute, psum
from .mesh import Mesh
from .steps import bitmap_ops, gather_to, on, walk_match, walks

__all__ = ["build_ring_fanout", "build_ring_fanout_compact",
           "shard_bitmap_rows"]


def shard_bitmap_rows(bitmap: np.ndarray, ring: int) -> np.ndarray:
    """The ``(F+1, W)`` accept bitmap padded with all-zero rows so that
    ``ring`` divides its row count (a pad row ORs nothing in)."""
    rows, w = bitmap.shape
    pad = (-rows) % ring
    if pad:
        bitmap = np.concatenate([bitmap, np.zeros((pad, w), bitmap.dtype)],
                                axis=0)
    return bitmap


def _bits_of(ids: torch.Tensor, W: int) -> torch.Tensor:
    """Dense ``(Bl, cap)`` ids → ``(Bl, W)`` bitmap tile: ``1 << bit``
    added into word ``id >> 5`` of a zero tile (unique ids, so add is
    OR); a -1 pad adds 0 into the spare column W, cut off."""
    ok = ids >= 0
    word = torch.where(ok, ids >> 5, W).long()
    bit = torch.where(ok, torch.ones_like(ids) << (ids & 31), 0)
    z = torch.zeros((ids.shape[0], W + 1), dtype=torch.int32,
                    device=ids.device)
    return z.scatter_add_(1, word, bit)[:, :W]


def _ring_partials(mesh: Mesh, active_slots: int, max_matches: int,
                   plain: bool):
    """``partials(words, lens, is_sys, node, edge, seeds, rows)``: for
    each dp row group, ``(devices, walk results, partial bitmaps)`` of
    its ring positions, each partial the OR of the rows that position
    owns."""
    dp, ring = mesh.shape["dp"], mesh.shape["ring"]
    match = walk_match(active_slots, plain)
    ops = bitmap_ops(plain)

    def partials(words, lens, is_sys, node_tab, edge_tab, seeds,
                 bitmap_rows):
        B = words.shape[0]
        F_pad = bitmap_rows.shape[0]
        if B % dp or F_pad % ring:
            raise ValueError(f"batch {B} or bitmap rows {F_pad} do not "
                             f"split over dp={dp}, ring={ring}")
        Bl, f_local = B // dp, F_pad // ring
        for d in range(dp):
            devs = mesh.axis_devices("ring", (d, 0))
            rows = slice(d * Bl, (d + 1) * Bl)
            res = walks(match, devs, (words[rows], lens[rows], is_sys[rows]),
                        (node_tab, edge_tab, seeds), max_matches)
            part = [ops.accept_or(
                        on(bitmap_rows[r * f_local:(r + 1) * f_local], dev),
                        res[r].matches, r * f_local)[0]
                    for r, dev in enumerate(devs)]
            yield devs, part

    return partials


def build_ring_fanout(mesh: Mesh, active_slots: int = 16,
                      max_matches: int = 32, plain: bool = False):
    """``step(words, lens, is_sys, node, edge, seeds, bitmap_rows) -> (B,
    W)`` int32 over a ``(dp, ring)`` mesh: batch rows split over ``dp``,
    the NFA tables replicated, ``bitmap_rows (F_pad, W)`` split by rows
    over ``ring``.  Per dispatch: one walk for each distinct device of
    each grid row, ``dp·ring`` ``accept_or`` launches and ``ring - 1``
    hops."""
    partials = _ring_partials(mesh, active_slots, max_matches, plain)

    def step(words, lens, is_sys, node_tab, edge_tab, seeds, bitmap_rows):
        out = []
        for devs, part in partials(words, lens, is_sys, node_tab, edge_tab,
                                   seeds, bitmap_rows):
            acc, chunk = list(part), part
            for _ in range(len(devs) - 1):
                chunk = ppermute(chunk, devs)
                acc = [a | c for a, c in zip(acc, chunk)]
            out.append(acc[0])
        return gather_to(out, mesh.lead)

    return step


def build_ring_fanout_compact(mesh: Mesh, cap_row: int = 64,
                              active_slots: int = 16, max_matches: int = 32,
                              plain: bool = False):
    """``step(...) -> ((B, W) int32 bitmap, (B,) int32 truncated)``: as
    :func:`build_ring_fanout`, but what rotates is each shard's
    compacted ``(Bl, cap_row)`` id list; a row whose local partial holds
    more than ``cap_row`` ids is counted truncated (summed over the
    ring: the rows the host re-runs).  Per dispatch: the bitmap step's
    walks and ``accept_or`` launches and ``dp·ring`` ``bitmap_compact``
    launches."""
    partials = _ring_partials(mesh, active_slots, max_matches, plain)
    ops = bitmap_ops(plain)

    def step(words, lens, is_sys, node_tab, edge_tab, seeds, bitmap_rows):
        W = bitmap_rows.shape[1]
        out, trunc = [], []
        for devs, part in partials(words, lens, is_sys, node_tab, edge_tab,
                                   seeds, bitmap_rows):
            ids, _n, over = zip(*(ops.compact(p, cap_row) for p in part))
            acc, chunk = list(part), list(ids)
            for _ in range(len(devs) - 1):
                chunk = ppermute(chunk, devs)
                acc = [a | _bits_of(c, W) for a, c in zip(acc, chunk)]
            out.append(acc[0])
            trunc.append(psum(over, devs)[0])
        return gather_to(out, mesh.lead), gather_to(trunc, mesh.lead)

    return step
