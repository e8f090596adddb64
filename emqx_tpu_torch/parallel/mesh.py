"""The device mesh of the multi-device match plane.

The port of ``emqx_tpu/parallel/mesh.py``.  The reference names the axes
of a ``jax.sharding.Mesh``; here a :class:`Mesh` is a small object that
holds a ``(dp, tp)`` grid of ``torch.device``s, one process driving
them all (the reference's ``shard_map`` over ``jax.devices()``):

* ``dp`` — publish-batch rows (each grid row matches its slice);
* ``tp`` — table shards (each grid column owns part of the table).

A device may repeat in the grid: ``[cpu] * 8`` stands where the
reference's tests have eight virtual CPU devices, and ``[cuda:0] * 4``
gives four real shard tables, a real routing grid and real collectives
on one card.  Work on a CUDA device runs on the mesh's own stream for
that device (:meth:`Mesh.streams`), made when the mesh is.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Union

import torch

__all__ = ["Mesh", "default_devices", "make_mesh", "pick_shape"]


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
    """A ``(dp, tp)`` grid of devices (repeats allowed).  ``shape`` is
    ``{"dp": dp, "tp": tp}``; ``devices[d][t]`` is the device of batch
    row-group ``d`` and table shard ``t``.  ``distinct`` lists each
    device once, in grid order; ``stream_of`` maps each distinct CUDA
    device to the mesh's stream on it."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]) -> None:
        self.devices: List[List[torch.device]] = [list(r) for r in grid]
        dp = len(self.devices)
        tp = len(self.devices[0]) if dp else 0
        if not dp or not tp or any(len(r) != tp for r in self.devices):
            raise ValueError("a mesh is a non-empty rectangular grid")
        self.shape: Dict[str, int] = {"dp": dp, "tp": tp}
        self.distinct: List[torch.device] = []
        for row in self.devices:
            for dev in row:
                if dev not in self.distinct:
                    self.distinct.append(dev)
        self.stream_of: Dict[torch.device, torch.cuda.Stream] = {
            dev: torch.cuda.Stream(dev)
            for dev in self.distinct if dev.type == "cuda"}

    @property
    def lead(self) -> torch.device:
        """The device the assembled outputs of a step live on."""
        return self.devices[0][0]

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


def make_mesh(shape: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> Mesh:
    """A mesh of ``shape`` over the first ``dp * tp`` of ``devices``
    (default: every visible card; without one the caller must name the
    CPU)."""
    devs = [_as_device(d) for d in (devices if devices is not None
                                    else default_devices())]
    if shape is None:
        shape = pick_shape(len(devs))
    dp, tp = int(shape["dp"]), int(shape["tp"])
    if dp * tp > len(devs):
        raise ValueError(f"mesh {shape} needs {dp * tp} devices, have "
                         f"{len(devs)}")
    return Mesh([devs[d * tp:(d + 1) * tp] for d in range(dp)])
