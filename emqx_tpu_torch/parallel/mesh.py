"""The device mesh of the multi-device match plane.

The port of ``emqx_tpu/parallel/mesh.py``.  The reference names the axes
of a ``jax.sharding.Mesh``; here a :class:`Mesh` is a small object that
holds a grid of ``torch.device``s with named axes, one process driving
them all (the reference's ``shard_map`` over ``jax.devices()``):

* ``dp`` — publish-batch rows (each grid row matches its slice);
* ``tp`` — table shards or subscriber-bitmap columns;
* ``ring`` — accept-bitmap rows, OR-reduced around a ring;
* ``ep`` — trie partitions by root word;
* ``u`` — the Ulysses reshard's batch rows, then bitmap columns.

A device may repeat in the grid: ``[cpu] * 8`` stands where the
reference's tests have eight virtual CPU devices, and ``[cuda:0] * 4``
gives four real shard tables, a real routing grid and real collectives
on one card.  Work on a CUDA device runs on the mesh's own stream for
that device (:meth:`Mesh.streams`), made when the mesh is.  A collective
runs over the devices of one axis (:meth:`Mesh.axis_devices`).
"""

from __future__ import annotations

import contextlib
import math
from typing import (Dict, Iterator, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch

__all__ = ["Mesh", "Sharded", "default_devices", "make_mesh", "pick_shape"]


class Sharded(NamedTuple):
    """A global array held as blocks along one mesh axis: ``parts[i]``
    on the axis's ``i``-th device, the blocks cut along ``dim`` (the
    reference's array with a ``PartitionSpec`` naming that axis at
    ``dim``; its ``addressable_shards``)."""

    parts: List[torch.Tensor]
    dim: int

    def full(self) -> torch.Tensor:
        """The global array, on the first block's device."""
        dev = self.parts[0].device
        return torch.cat([p.to(dev) for p in self.parts], dim=self.dim)


def pick_shape(n_devices: int, tp: Optional[int] = None) -> Dict[str, int]:
    """Default mesh factorization: widest power-of-two tp ≤ 4 that divides
    the device count, rest dp."""
    if tp is None:
        tp = 1
        for cand in (4, 2):
            if n_devices % cand == 0:
                tp = cand
                break
    if n_devices % tp:
        raise ValueError(f"tp={tp} does not divide {n_devices} devices")
    return {"dp": n_devices // tp, "tp": tp}


def default_devices() -> List[torch.device]:
    """Every visible card; raises without one (the caller names the CPU
    to run there)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass a device list (e.g. "
            "[torch.device('cpu')] * 4) to run the mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _as_device(d: Union[str, torch.device]) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A grid of devices with named axes (repeats allowed).  ``grid`` is
    nested lists, one level an axis of ``axes`` (default ``("dp",
    "tp")``); ``shape`` maps each axis to its size in order, and
    ``devices`` is the grid itself: ``devices[d][t]`` is the device of
    batch row-group ``d`` and table shard ``t`` of a ``(dp, tp)`` mesh.
    ``distinct`` lists each device once, in grid order; ``stream_of``
    maps each distinct CUDA device to the mesh's stream on it."""

    def __init__(self, grid: Sequence, axes: Sequence[str] = ("dp", "tp")
                 ) -> None:
        self.axes: Tuple[str, ...] = tuple(axes)
        sizes: List[int] = []
        level = grid
        for _ in self.axes:
            if not isinstance(level, (list, tuple)) or not level:
                raise ValueError("a mesh is a non-empty rectangular grid")
            sizes.append(len(level))
            level = level[0]
        self.devices = _nested(grid, len(self.axes))
        flat = list(_flatten(self.devices, len(self.axes)))
        if len(flat) != math.prod(sizes):
            raise ValueError("a mesh is a non-empty rectangular grid")
        self.shape: Dict[str, int] = dict(zip(self.axes, sizes))
        self.distinct: List[torch.device] = []
        for dev in flat:
            if dev not in self.distinct:
                self.distinct.append(dev)
        self.stream_of: Dict[torch.device, torch.cuda.Stream] = {
            dev: torch.cuda.Stream(dev)
            for dev in self.distinct if dev.type == "cuda"}

    def device_at(self, pos: Sequence[int]) -> torch.device:
        """The device at grid position ``pos``."""
        out = self.devices
        for i in pos:
            out = out[i]
        return out

    def axis_positions(self, axis: str, pos: Sequence[int]
                       ) -> List[Tuple[int, ...]]:
        """The positions along ``axis`` through ``pos`` (every other axis
        held at its index in ``pos``), in the axis's order."""
        k = self.axes.index(axis)
        return [tuple(pos[:k]) + (i,) + tuple(pos[k + 1:])
                for i in range(self.shape[axis])]

    def axis_devices(self, axis: str, pos: Sequence[int]
                     ) -> List[torch.device]:
        """The devices of :meth:`axis_positions`: what a collective over
        ``axis`` at ``pos`` runs on."""
        return [self.device_at(p) for p in self.axis_positions(axis, pos)]

    @property
    def lead(self) -> torch.device:
        """The device the assembled outputs of a step live on."""
        return self.device_at((0,) * len(self.axes))

    @contextlib.contextmanager
    def streams(self) -> Iterator[None]:
        """Make the mesh's stream the current stream of every distinct
        CUDA device: the scatters, uploads, steps and copies of the mesh
        run on them, so a step sees exactly the writes enqueued before
        it, and a copy between two cards is ordered on both."""
        with contextlib.ExitStack() as stack:
            for s in self.stream_of.values():
                stack.enter_context(torch.cuda.stream(s))
            yield

    def record(self) -> List[torch.cuda.Event]:
        """One event recorded now on each of the mesh's streams."""
        out = []
        for s in self.stream_of.values():
            ev = torch.cuda.Event()
            ev.record(s)
            out.append(ev)
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices})"


def _nested(grid, depth: int):
    if depth == 0:
        return _as_device(grid)
    return [_nested(g, depth - 1) for g in grid]


def _flatten(grid, depth: int):
    if depth == 0:
        yield grid
        return
    for g in grid:
        yield from _flatten(g, depth - 1)


def make_mesh(shape: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> Mesh:
    """A mesh of ``shape`` (named axes in order, e.g. ``{"dp": 2, "tp":
    4}``, ``{"dp": 1, "ring": 4}``, ``{"ep": 4}``, ``{"u": 8}``) over the
    first ``prod(shape)`` of ``devices`` in row-major order, as the
    reference reshapes its device list (default: every visible card;
    without one the caller must name the CPU)."""
    devs = [_as_device(d) for d in (devices if devices is not None
                                    else default_devices())]
    if shape is None:
        shape = pick_shape(len(devs))
    sizes = [int(n) for n in shape.values()]
    n = math.prod(sizes)
    if n > len(devs):
        raise ValueError(f"mesh {shape} needs {n} devices, have "
                         f"{len(devs)}")
    grid = devs[:n]
    for size in reversed(sizes[1:]):
        grid = [grid[i:i + size] for i in range(0, len(grid), size)]
    return Mesh(grid, tuple(shape))
