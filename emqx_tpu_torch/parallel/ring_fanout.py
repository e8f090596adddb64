"""Config-5 device stage: ring-tiled accept-bitmap OR-reduction (K8d).

The port of ``emqx_tpu/parallel/ring_fanout.py``.  When the
accept→subscriber bitmap outgrows one device, its ROWS (accept ids) shard
over a ``ring`` mesh axis: window r of the rows lies at ring position r.
Each position ORs the rows of its window that a topic's matches name; the
partial bitmaps rotate around the ring ``ring - 1`` times, each position
ORing what arrives, so every position ends with the full reduction.  The
result is the ring's first position's (the reference's replicated
output spec returns that one).  The compact form rotates each window's
compacted id list instead (at most ``cap_row`` ids a row), re-expanded
into a bitmap tile at each hop, and counts the windows a row overflows.

On one device (every position of the mesh there,
:func:`~emqx_tpu_torch.parallel.steps.one_device`) nothing rotates: a
dispatch is one raw walk of the whole batch and one ``ring_or`` launch
(``ops/bitmap_kernel.py``), which takes each row's first K valid ids,
ORs their rows window by window and writes the ring's result, in both
forms.  On several devices each position walks its dp row group (once
for each distinct device of the ring), ORs its window's rows (the
``accept_or`` kernel), compacts them (``bitmap_compact``) in the compact
form, and the partials or lists rotate with
:func:`~emqx_tpu_torch.parallel.collectives.ppermute`, a list re-expanded
by a scatter-add of single bits into a zero tile (``bits_of_plain``).
"""

from __future__ import annotations

import numpy as np

from ..ops.bitmap_kernel import bits_of_plain
from . import steps
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


def _one_device(mesh: Mesh, active_slots: int, max_matches: int,
                plain: bool, cap_row):
    """The step on one device: the raw walk of the whole batch, then one
    ``ring_or`` (every dp group's windows are the same, so one launch
    covers the batch); ``(out, truncated)``, truncated None for the
    plain form."""
    dp, ring = mesh.shape["dp"], mesh.shape["ring"]
    walk = steps.raw_walk(active_slots, plain)
    ring_or = bitmap_ops(plain).ring_or
    dev = mesh.lead

    def step(words, lens, is_sys, node_tab, edge_tab, seeds, bitmap_rows):
        B, F_pad = words.shape[0], bitmap_rows.shape[0]
        if B % dp or F_pad % ring:
            raise ValueError(f"batch {B} or bitmap rows {F_pad} do not "
                             f"split over dp={dp}, ring={ring}")
        acc, _aover = steps.walk_on(walk, dev, (words, lens, is_sys),
                                    (node_tab, edge_tab, seeds))
        return ring_or(acc, on(bitmap_rows, dev), ring, max_matches, cap_row)

    return step


def build_ring_fanout(mesh: Mesh, active_slots: int = 16,
                      max_matches: int = 32, plain: bool = False):
    """``step(words, lens, is_sys, node, edge, seeds, bitmap_rows) -> (B,
    W)`` int32 over a ``(dp, ring)`` mesh: batch rows split over ``dp``,
    the NFA tables replicated, ``bitmap_rows (F_pad, W)`` split by rows
    over ``ring``.  Per dispatch on one device: one raw walk and one
    ``ring_or`` launch; on several, one walk for each distinct device of
    each grid row, ``dp·ring`` ``accept_or`` launches and ``ring - 1``
    hops."""
    if steps.one_device(mesh.distinct):
        one = _one_device(mesh, active_slots, max_matches, plain, None)
        return lambda *args: one(*args)[0]
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
    ring: the rows the host re-runs).  Per dispatch on one device: one
    raw walk and one ``ring_or`` launch; on several, the bitmap step's
    walks and ``accept_or`` launches and ``dp·ring`` ``bitmap_compact``
    launches."""
    if steps.one_device(mesh.distinct):
        return _one_device(mesh, active_slots, max_matches, plain, cap_row)
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
                acc = [a | bits_of_plain(c, W) for a, c in zip(acc, chunk)]
            out.append(acc[0])
            trunc.append(psum(over, devs)[0])
        return gather_to(out, mesh.lead), gather_to(trunc, mesh.lead)

    return step
