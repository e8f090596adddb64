"""Ulysses-style ingest→dispatch reshard: one tiled ``all_to_all``
flipping the sharded axis between the two layouts of the publish step
(K8f).

The port of ``emqx_tpu/parallel/ulysses.py``:

* **ingest layout** — the topic BATCH axis is sharded over ``u``: each
  position matches its B/U topics and assembles full-width subscriber
  bitmap rows for them;
* **dispatch layout** — the SUBSCRIBER axis is sharded: each position
  owns a column slice of the bitmap over the WHOLE batch, what a node
  that delivers to that range of sessions needs.

``(B/U, W)`` per position → ``all_to_all_tiled`` (split columns,
concatenate rows) → ``(B, W/U)`` per position; the inverse carries
per-subscriber outcomes back.  The dispatch bitmap and the delivery
counts stay one block a position (:class:`~emqx_tpu_torch.parallel.mesh.
Sharded`), the layout the reference asserts through
``addressable_shards``.

On one device (:func:`~emqx_tpu_torch.parallel.steps.one_device`) a
step is one raw walk of the whole batch and one ``ulysses_or`` launch
(``ops/bitmap_kernel.py``; its entry zeroes the counts first): it writes
the dispatch blocks in the landed layout, the counts, ``n_matches`` and
the spill flags into one buffer, and every field is a view of it.  On
several devices each distinct device walks its positions' row blocks
together, each position ORs its rows (the ``accept_or`` kernel), one
tiled ``all_to_all`` moves the blocks and each slice's counts are torch
ops (``deliveries_plain``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

from ..ops.bitmap_kernel import deliveries_plain
from . import steps
from .collectives import all_to_all_tiled
from .mesh import Mesh, Sharded
from .steps import bitmap_ops, gather_to, on, walk_match

__all__ = ["UlyssesResult", "build_reshard", "build_ulysses_step",
           "build_unreshard"]


class UlyssesResult(NamedTuple):
    dispatch_bitmap: Sharded     # (B, W) int32, columns split over u: each
    #                              position's subscriber slice of EVERY
    #                              message of the batch
    sub_deliveries: Sharded      # (W·32,) int32 per-subscriber message
    #                              counts, split over u like the columns
    n_matches: torch.Tensor      # (B,) int32
    active_overflow: torch.Tensor  # (B,) int32 fail-open rows


def _blocks(mesh: Mesh, axis: str, x, dim: int) -> List[torch.Tensor]:
    """``x`` (a global array, or a :class:`Sharded` split along ``dim``)
    as its blocks along ``dim`` on the devices of ``axis``."""
    devs = mesh.axis_devices(axis, (0,) * len(mesh.axes))
    if isinstance(x, Sharded):
        if x.dim != dim or len(x.parts) != len(devs):
            raise ValueError(f"want blocks along dim {dim} over "
                             f"{len(devs)} positions")
        return [on(p, dev) for p, dev in zip(x.parts, devs)]
    n = x.shape[dim] // len(devs)
    if x.shape[dim] % len(devs):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {axis}={len(devs)}")
    idx = [slice(None)] * len(x.shape)
    out = []
    for i, dev in enumerate(devs):
        idx[dim] = slice(i * n, (i + 1) * n)
        out.append(on(x[tuple(idx)], dev))
    return out


def build_reshard(mesh: Mesh, axis: str = "u"):
    """``reshard(x) -> Sharded``: ingest→dispatch, rows split over
    ``axis`` in (a global ``(B, W)`` array or a row-split
    :class:`Sharded`), columns split out.  One tiled ``all_to_all``."""
    devs = mesh.axis_devices(axis, (0,) * len(mesh.axes))

    def reshard(x) -> Sharded:
        return Sharded(all_to_all_tiled(_blocks(mesh, axis, x, 0), devs,
                                        split_dim=1, concat_dim=0), 1)

    return reshard


def build_unreshard(mesh: Mesh, axis: str = "u"):
    """``unreshard(x) -> Sharded``: dispatch→ingest, the inverse of
    :func:`build_reshard` (columns split in, rows split out)."""
    devs = mesh.axis_devices(axis, (0,) * len(mesh.axes))

    def unreshard(x) -> Sharded:
        return Sharded(all_to_all_tiled(_blocks(mesh, axis, x, 1), devs,
                                        split_dim=0, concat_dim=1), 0)

    return unreshard


def _one_device(dev: torch.device, U: int, axis: str, active_slots: int,
                max_matches: int, plain: bool):
    """The step on one device: the raw walk of the whole batch, then
    ``ulysses_or``; each position's block a view of its output."""
    walk = steps.raw_walk(active_slots, plain)
    ulysses_or = bitmap_ops(plain).ulysses_or

    def step(words, lens, is_sys, node_tab, edge_tab, seeds, accept_bitmap):
        B, W = words.shape[0], accept_bitmap.shape[1]
        if B % U or W % U:
            raise ValueError(f"batch {B} or bitmap width {W} does not split "
                             f"over {axis}={U}")
        acc, aover = steps.walk_on(walk, dev, (words, lens, is_sys),
                                   (node_tab, edge_tab, seeds))
        disp, counts, n, over = ulysses_or(acc, aover, on(accept_bitmap, dev),
                                           U, max_matches)
        slices = counts.view(U, W // U * 32)
        return UlyssesResult(
            dispatch_bitmap=Sharded(list(disp.unbind(0)), 1),
            sub_deliveries=Sharded(list(slices.unbind(0)), 0),
            n_matches=n, active_overflow=over)

    return step


def build_ulysses_step(mesh: Mesh, axis: str = "u", active_slots: int = 16,
                       max_matches: int = 32, plain: bool = False):
    """The ingest→match→reshard→dispatch step: ``step(words, lens,
    is_sys, node_tab, edge_tab, seeds, accept_bitmap) -> UlyssesResult``.
    Batch rows split over ``axis``; the NFA tables and the accept bitmap
    replicated (each position assembles full-width rows).  On one
    device: one raw walk and one ``ulysses_or`` launch (and its memset).
    On several: the row blocks of the positions on one device are walked
    together, one walk a distinct device; then ``U`` ``accept_or``
    launches (one a position), one tiled ``all_to_all`` and the
    per-subscriber counts of each dispatch slice.  ``plain`` runs the
    plain walk and the kernels' plain versions."""
    devs = mesh.axis_devices(axis, (0,) * len(mesh.axes))
    U = len(devs)
    if steps.one_device(devs):
        return _one_device(devs[0], U, axis, active_slots, max_matches,
                           plain)
    match = walk_match(active_slots, plain)
    ops = bitmap_ops(plain)

    def step(words, lens, is_sys, node_tab, edge_tab, seeds, accept_bitmap):
        B = words.shape[0]
        if B % U:
            raise ValueError(f"batch {B} does not split over {axis}={U}")
        Bl = B // U
        at: Dict[torch.device, List[int]] = {}
        for i, dev in enumerate(devs):
            at.setdefault(dev, []).append(i)
        res = [None] * U
        for dev, pos in at.items():
            rows = [slice(i * Bl, (i + 1) * Bl) for i in pos]
            w, l, s = (torch.cat([on(x[r], dev) for r in rows])
                       for x in (words, lens, is_sys))
            r = match(w, l, s, on(node_tab, dev), on(edge_tab, dev),
                      on(seeds, dev), max_matches)
            for j, i in enumerate(pos):
                res[i] = tuple(x[j * Bl:(j + 1) * Bl] for x in
                               (r.matches, r.n_matches, r.active_overflow))
        bitmap = {dev: on(accept_bitmap, dev) for dev in at}
        ingest = [ops.accept_or(bitmap[dev], res[i][0])[0]
                  for i, dev in enumerate(devs)]
        disp = all_to_all_tiled(ingest, devs, split_dim=1, concat_dim=0)
        return UlyssesResult(
            dispatch_bitmap=Sharded(disp, 1),
            sub_deliveries=Sharded([deliveries_plain(x) for x in disp], 0),
            n_matches=gather_to([x[1] for x in res], mesh.lead),
            active_overflow=gather_to([x[2] for x in res], mesh.lead))

    return step
