"""Shared pieces of the mesh steps: the walk, the bitmap kernels,
operands placed on a mesh position's device, and the packed batch and
outputs of the routed steps.

The steps walk with the hash-walk kernel on CUDA tensors: the sharded
fan-out (K8b) and, on several devices, the ring and Ulysses steps (K8d,
K8f) in compact mode (:func:`walk_match`: ``nfa_match``, its epilogue
torch ops); the multichip and prefix-EP steps (K8a, K8c) and, on one
device, the ring and Ulysses steps in raw mode (:func:`raw_walk`), their
kernels reading the raw accept slots.  The fan-out steps do their bitmap
work with the kernels of ``ops/bitmap_kernel.py`` (:func:`bitmap_ops`).
A ``plain`` build takes the plain versions of both on any device: what
the kernels are held to.

A step takes global operands (torch tensors on any device, or numpy
arrays; a uint32 bitmap is read as int32 bit patterns) and cuts each
position's block as the reference's ``in_specs`` do; :func:`on` puts a
block on a position's device (a view where it already lies there, so a
column slice is read in place).

The multichip and prefix-EP steps (K8a, K8c), and the one-device ring
and Ulysses steps (:func:`walk_on`), take their batch up in one copy a
device (:func:`upload_batch`); K8a and K8c and write every output field into
one buffer (:func:`packed`), which leaves the card in one copy; on a mesh
of several devices each device writes its own and :func:`combine` sums
them on the lead device.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["bitmap_ops", "combine", "field_views", "gather_to", "on",
           "one_device", "packed",
           "raw_walk", "upload_batch", "walk_match", "walk_on", "walks"]


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


def raw_walk(active_slots: int, plain: bool):
    """``walk(w, l, s, node, edge, seeds) -> (acc, aover)``: the hash
    walk's raw accept slots, by the kernel on CUDA tensors
    (``walk_kernel.nfa_walk``), or with ``plain`` the walk's plain
    version on any device."""
    from ..ops.walk_kernel import nfa_walk, nfa_walk_plain

    fn = nfa_walk_plain if plain else nfa_walk

    def walk(w, l, s, node, edge, seeds):
        return fn(w, l, s, node, edge, seeds, active_slots=active_slots)
    return walk


def walk_on(walk, dev: torch.device, batch: Sequence, tables: Sequence
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``walk`` (a :func:`raw_walk`) of the whole ``batch`` (words, lens,
    is_sys; up in one copy where it is not on ``dev``:
    :func:`upload_batch`) over ``tables`` (node, edge, seeds) on ``dev``:
    the one-device steps' walk, ``(acc, aover)``."""
    w, l, s = upload_batch(*batch, [dev])[dev]
    return walk(w, l, s, *(on(t, dev) for t in tables))


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def one_device(devices: Sequence[torch.device]) -> bool:
    """Whether ``devices`` are all one device: then a routed step writes
    its grid in the landed layout and its merge writes the assembled
    output itself (no collective moves anything)."""
    return len(set(devices)) == 1


def upload_batch(words, lens, is_sys, devices: Sequence[torch.device]
                 ) -> Dict[torch.device, Tuple[torch.Tensor, ...]]:
    """The batch ``(words (B, D) int32, lens (B,) int32, is_sys (B,)
    bool)`` on each distinct device of ``devices``.  Tensors that already
    lie on the one device are used as they are; otherwise the three go
    into one host buffer (pinned where a device is a card: words, lens,
    then one byte a row) and up in one copy a device, and the three are
    views of it there."""
    devs = list(dict.fromkeys(devices))
    if all(isinstance(x, torch.Tensor) and x.device == devs[0]
           for x in (words, lens, is_sys)) and len(devs) == 1:
        return {devs[0]: (words.to(torch.int32).contiguous(),
                          lens.to(torch.int32).contiguous(),
                          is_sys.to(torch.bool).contiguous())}
    w = np.ascontiguousarray(_host(words), dtype=np.int32)
    B, D = w.shape
    nw, nl = B * D * 4, B * 4
    pin = any(d.type == "cuda" for d in devs)
    host = torch.empty((nw + nl + B,), dtype=torch.uint8, pin_memory=pin)
    h = host.numpy()
    h[:nw] = w.reshape(-1).view(np.uint8)
    h[nw:nw + nl] = np.ascontiguousarray(_host(lens), dtype=np.int32) \
        .view(np.uint8)
    h[nw + nl:] = _host(is_sys).astype(np.uint8)
    out = {}
    for dev in devs:
        buf = host if dev.type == "cpu" else host.to(dev, non_blocking=True)
        out[dev] = (buf[:nw].view(torch.int32).view(B, D),
                    buf[nw:nw + nl].view(torch.int32),
                    buf[nw + nl:].view(torch.bool))
    return out


def field_views(buf: torch.Tensor, B: int,
                shapes: Sequence[Tuple[int, ...]]) -> List[torch.Tensor]:
    """The fields of a packed buffer: field ``k`` a view of shape ``(B,
    *shapes[k])``, in order."""
    out, at = [], 0
    for s in shapes:
        n = B * math.prod(s)
        out.append(buf[at:at + n].view(B, *s))
        at += n
    return out


def packed(dev: torch.device, B: int, shapes: Sequence[Tuple[int, ...]]
           ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One int32 buffer on ``dev`` for the fields of ``shapes``
    (uninitialised) and its :func:`field_views`."""
    n = sum(B * math.prod(s) for s in shapes)
    buf = torch.empty((n,), dtype=torch.int32, device=dev)
    return buf, field_views(buf, B, shapes)


def combine(bufs: Sequence[torch.Tensor], n_max: int,
            dev: torch.device) -> torch.Tensor:
    """The partial output buffers of several devices as one on ``dev``:
    the first ``n_max`` ints (ids, -1 where a device wrote none) by
    maximum, the rest (counts, flags, sums) by sum."""
    from .collectives import pmax, psum

    head = pmax([b[:n_max] for b in bufs], [dev])[0]
    tail = psum([b[n_max:] for b in bufs], [dev])[0]
    return torch.cat([head, tail])


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
    """The six bitmap functions of ``ops/bitmap_kernel.py``: the
    wrappers (the kernels on CUDA tensors), or with ``plain`` their plain
    versions on any device."""
    from ..ops import bitmap_kernel as bk

    if plain:
        return SimpleNamespace(
            accept_or=bk.accept_or_plain, compact=bk.bitmap_compact_plain,
            group_count=bk.group_count_plain,
            group_pick=bk.group_pick_plain, ring_or=bk.ring_or_plain,
            ulysses_or=bk.ulysses_or_plain)
    return SimpleNamespace(accept_or=bk.accept_or, compact=bk.bitmap_compact,
                           group_count=bk.group_count,
                           group_pick=bk.group_pick, ring_or=bk.ring_or,
                           ulysses_or=bk.ulysses_or)
