"""Shared pieces of the mesh steps: the walk, the bitmap kernels, and
operands placed on a mesh position's device.

Every step of ``parallel/`` walks with the port's ``nfa_match`` in
compact mode (:func:`walk_match`: the hash-walk kernel on CUDA tensors)
and, in the fan-out steps, does its bitmap work with the four kernels of
``ops/bitmap_kernel.py`` (:func:`bitmap_ops`).  A ``plain`` build takes
the plain versions of both on any device: what the kernels are held to.

A step takes global operands (torch tensors on any device, or numpy
arrays; a uint32 bitmap is read as int32 bit patterns) and cuts each
position's block as the reference's ``in_specs`` do; :func:`on` puts a
block on a position's device (a view where it already lies there, so a
column slice is read in place).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Sequence

import numpy as np
import torch

__all__ = ["bitmap_ops", "gather_to", "on", "walk_match", "walks"]


def on(x, dev: torch.device) -> torch.Tensor:
    """``x`` as a tensor on ``dev``: a tensor moves (nothing is copied
    where it lies there already); a numpy array is copied in, a uint32
    one as int32 bit patterns."""
    if isinstance(x, torch.Tensor):
        return x if x.device == dev else x.to(dev, non_blocking=True)
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    a = np.require(a, requirements=("C", "W"))
    return torch.from_numpy(a).to(dev, non_blocking=True)


def gather_to(parts: Sequence[torch.Tensor], dev: torch.device,
              dim: int = 0) -> torch.Tensor:
    """``parts`` concatenated along ``dim`` on ``dev`` (a step's global
    output assembled on the mesh's lead device)."""
    return torch.cat([on(p, dev) for p in parts], dim=dim)


def walk_match(active_slots: int, plain: bool):
    """``match(w, l, s, node, edge, seeds, K) -> MatchResult`` in
    compact mode: the port's ``nfa_match`` (the hash-walk kernel on CUDA
    tensors), or with ``plain`` the walk's plain version on any device
    (what the kernel is held to)."""
    from ..ops.match_kernel import epilogue, nfa_match
    from ..ops.walk_kernel import nfa_walk_plain

    if plain:
        def match(w, l, s, node, edge, seeds, K):
            acc, aover = nfa_walk_plain(w, l, s, node, edge, seeds,
                                        active_slots=active_slots)
            return epilogue(acc, aover, K, True, 0)
    else:
        def match(w, l, s, node, edge, seeds, K):
            return nfa_match(w, l, s, node, edge, seeds,
                             active_slots=active_slots, max_matches=K)
    return match


def walks(match, devices: Sequence[torch.device], batch: Sequence,
          tables: Sequence, K: int) -> List:
    """The walk of one row block ``batch`` (words, lens, is_sys) over the
    replicated ``tables`` (node, edge, seeds) at each position of
    ``devices``: the inputs are the same at every position, so the walk
    runs once for each distinct device and positions on one device
    share its ``MatchResult``."""
    done: Dict[torch.device, object] = {}
    for dev in devices:
        if dev not in done:
            done[dev] = match(*(on(x, dev) for x in (*batch, *tables)), K)
    return [done[dev] for dev in devices]


def bitmap_ops(plain: bool) -> SimpleNamespace:
    """The four bitmap functions of ``ops/bitmap_kernel.py``: the
    wrappers (the kernels on CUDA tensors), or with ``plain`` their plain
    versions on any device."""
    from ..ops import bitmap_kernel as bk

    if plain:
        return SimpleNamespace(
            accept_or=bk.accept_or_plain, compact=bk.bitmap_compact_plain,
            group_count=bk.group_count_plain,
            group_pick=bk.group_pick_plain)
    return SimpleNamespace(accept_or=bk.accept_or, compact=bk.bitmap_compact,
                           group_count=bk.group_count,
                           group_pick=bk.group_pick)
