"""Collectives over a list of per-shard tensors.

The counterparts of ``jax.lax.all_to_all``, ``psum`` and ``all_gather``
inside the reference's ``shard_map``: plain functions over the tensors
of one mesh axis, ``parts[i]`` on ``devices[i]``.  Each moves data with
``.to(target, non_blocking=True)``: two distinct cards copy peer to
peer (PyTorch orders the copy on both devices' current streams, the
mesh's streams under :meth:`~emqx_tpu_torch.parallel.mesh.Mesh.streams`),
and a device that repeats in the axis copies nothing.  No process group
and no NCCL: one process drives every device.

A result that several positions of the axis share lives once for each
distinct device: positions on one device get the same tensor object.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

__all__ = ["all_gather", "all_to_all", "psum"]


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t if t.device == dev else t.to(dev, non_blocking=True)


def all_to_all(parts: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``parts[i]`` has ``n = len(devices)`` leading blocks, block ``o``
    addressed to position ``o``; returns ``out[o]`` on ``devices[o]``,
    the blocks addressed to ``o`` stacked by source: ``out[o][i] ==
    parts[i][o]`` (``jax.lax.all_to_all(x, axis, 0, 0, tiled=False)``)."""
    n = len(devices)
    if len(parts) != n or any(p.shape[0] != n for p in parts):
        raise ValueError("all_to_all: one part per device, each with one "
                         "block per device")
    return [torch.stack([_to(parts[i][o], devices[o]) for i in range(n)])
            for o in range(n)]


def psum(parts: Sequence[torch.Tensor],
         devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The elementwise sum of ``parts`` on every position of the axis
    (``jax.lax.psum``), summed once per distinct device in the axis's
    order of positions."""
    out: Dict[torch.device, torch.Tensor] = {}
    for dev in devices:
        if dev not in out:
            acc = _to(parts[0], dev).clone()
            for p in parts[1:]:
                acc += _to(p, dev)
            out[dev] = acc
    return [out[dev] for dev in devices]


def all_gather(parts: Sequence[torch.Tensor],
               devices: Sequence[torch.device],
               dim: int = 0) -> List[torch.Tensor]:
    """``parts`` concatenated along ``dim`` in position order, on every
    position of the axis (``jax.lax.all_gather(..., tiled=True)``)."""
    out: Dict[torch.device, torch.Tensor] = {}
    for dev in devices:
        if dev not in out:
            out[dev] = torch.cat([_to(p, dev) for p in parts], dim=dim)
    return [out[dev] for dev in devices]
