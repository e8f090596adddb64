"""Config-4 device stage: ``$share`` group member selection on the mesh
(K8e).

The port of ``emqx_tpu/parallel/shared_group.py``.  The per-topic
subscriber bitmap ``(B, W)`` is sharded ``(dp, tp)``, the group masks
``(G, W)`` by columns over ``tp``, the selector hash ``(B,)`` over
``dp``.  Each position counts each group's candidates in its columns
(the ``group_count`` kernel on the card); the counts are summed over
``tp`` and gathered for each shard's exclusive prefix
(:mod:`~emqx_tpu_torch.parallel.collectives`); the hash picks an ordinal
in each (topic, group), and the one shard that holds it extracts the
subscriber id (the ``group_pick`` kernel: a scan of word popcounts and
the n-th set bit), combined over ``tp`` with :func:`pmax`.  Output:
``(B, G)`` int32, -1 where the group has no member with a matching
subscription — the host strategy's pick (:func:`host_pick`).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from .collectives import all_gather, pmax, psum
from .mesh import Mesh
from .steps import bitmap_ops, gather_to, on

__all__ = ["build_shared_selector", "host_pick", "make_group_masks"]


def make_group_masks(groups: Sequence[Iterable[int]], n_subs: int,
                     words: int) -> np.ndarray:
    """``(G, words)`` uint32 membership masks of ``groups`` (each an
    iterable of subscriber ids in ``[0, n_subs)``)."""
    bm = np.zeros((len(groups), words), np.uint32)
    for gi, members in enumerate(groups):
        for sub in members:
            if not 0 <= sub < n_subs:
                raise ValueError(f"subscriber id {sub} out of range")
            bm[gi, sub >> 5] |= np.uint32(1) << np.uint32(sub & 31)
    return bm


def host_pick(row_bitmap: np.ndarray, mask: np.ndarray, sel_hash: int) -> int:
    """The parity oracle: the ``(hash % n_members)``-th live member in
    subscriber-id order, -1 when there is none (uint32 words)."""
    cand = np.asarray(row_bitmap).view(np.uint32) & \
        np.asarray(mask).view(np.uint32)
    ids = []
    for w in range(len(cand)):
        v = int(cand[w])
        while v:
            b = (v & -v).bit_length() - 1
            ids.append(w * 32 + b)
            v &= v - 1
    if not ids:
        return -1
    return ids[sel_hash % len(ids)]


def build_shared_selector(mesh: Mesh, plain: bool = False):
    """``select(bitmap (B, W), masks (G, W), sel_hash (B,)) -> (B, G)``
    int32 over a ``(dp, tp)`` mesh.  Per dispatch: ``dp·tp`` launches
    each of ``group_count`` and ``group_pick``.  ``plain`` runs their
    plain versions."""
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    ops = bitmap_ops(plain)

    def select(bitmap, masks, sel_hash):
        B, W = bitmap.shape
        if B % dp or W % tp or masks.shape[1] != W:
            raise ValueError(f"bitmap {tuple(bitmap.shape)} / masks "
                             f"{tuple(masks.shape)} do not split over "
                             f"dp={dp}, tp={tp}")
        Bl, Wl = B // dp, W // tp
        out = []
        for d in range(dp):
            devs = mesh.axis_devices("tp", (d, 0))
            rows = slice(d * Bl, (d + 1) * Bl)
            bl = [on(bitmap[rows, t * Wl:(t + 1) * Wl], dev)
                  for t, dev in enumerate(devs)]
            ml = [on(masks[:, t * Wl:(t + 1) * Wl], dev)
                  for t, dev in enumerate(devs)]
            sh = [on(sel_hash[rows], dev) for dev in devs]
            count = [ops.group_count(b, m) for b, m in zip(bl, ml)]
            total = psum(count, devs)
            every = all_gather([c[None] for c in count], devs)  # (tp, Bl, G)
            picks = [ops.group_pick(bl[t], ml[t], sh[t], total[t],
                                    every[t][:t].sum(0, dtype=torch.int32),
                                    count[t], t * Wl)
                     for t in range(tp)]
            out.append(pmax(picks, devs)[0])
        return gather_to(out, mesh.lead)

    return select
