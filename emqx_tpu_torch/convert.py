"""Load a table built by the reference (numpy arrays) into the port.

:func:`from_reference` wraps the reference's ``node_tab`` / ``edge_tab`` /
``seeds`` arrays, accept-id table and vocab in a read-only host table
and uploads it as the port's :class:`~emqx_tpu_torch.ops.device_table
.DeviceNfa`, so a table compiled by the JAX package answers through the
port's walk.  With ``join``, the reference's join relation (its
``JoinRelation.arrays()``: ``state_start, edge_word, edge_next,
overlay``) is mirrored as it is, tombstones and overlay rows included,
so that a relation the reference built and churned answers through the
port's join kernel.  The layouts are the same, so nothing is converted.

:func:`multichip_arrays_from_reference` does the same for a reference
``MultichipMatcher``: its stacked arrays (``_arrs``: the per-shard
tables, aid maps, micro-table and ``word_owner``), read as numpy, become
the port's per-shard tensors on a mesh, so that both packages' steps
run on the very same tables.

The fan-out's operands carry across too: the reference's uint32 accept
bitmaps and ``$share`` group masks become the port's int32 bit patterns
(:func:`accept_bitmap_from_reference`, :func:`group_masks_from_reference`),
and its prefix partitions the port's ``EpTables``
(:func:`ep_tables_from_reference`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .ops.device_table import DeviceNfa, resolve_device
from .ops.join_match import JoinRelation
from .ops.incremental import NfaDelta
from .parallel.mesh import Mesh
from .parallel.multichip_serve import MeshTables, mesh_tables
from .parallel.prefix_ep import EpTables

__all__ = ["FrozenTable", "accept_bitmap_from_reference",
           "ep_tables_from_reference", "from_reference",
           "group_masks_from_reference", "multichip_arrays_from_reference"]


class FrozenTable:
    """A host table that never changes, with the drain surface
    :class:`DeviceNfa` consumes (``flush`` always returns an empty
    delta)."""

    def __init__(self, node_tab: np.ndarray, edge_tab: np.ndarray,
                 seeds: np.ndarray, accept_filters: List[Optional[str]],
                 vocab: Dict[str, int], depth: int, epoch: int = 0) -> None:
        self.node_tab = np.ascontiguousarray(node_tab, dtype=np.int32)
        self.edge_tab = np.ascontiguousarray(edge_tab, dtype=np.int32)
        self.seeds = np.ascontiguousarray(seeds, dtype=np.int32)
        self.accept_filters = list(accept_filters)
        self.vocab = dict(vocab)
        self.depth = depth
        self.epoch = epoch
        self.device_epoch: Optional[int] = None

    def shape_key(self):
        return (int(self.node_tab.shape[0]), int(self.edge_tab.shape[0]),
                self.depth)

    def flush(self) -> NfaDelta:
        return NfaDelta(
            epoch=self.epoch, resized=False,
            state_idx=np.zeros(0, np.int32),
            state_rows=np.zeros((0, 4), np.int32),
            bucket_idx=np.zeros(0, np.int32),
            bucket_rows=np.zeros((0, self.edge_tab.shape[1]), np.int32))


def from_reference(node_tab, edge_tab, seeds, accept_filters, vocab,
                   device: Union[None, str, torch.device] = None, *,
                   depth: int = 16, active_slots: int = 16,
                   max_matches: int = 32, join=None) -> DeviceNfa:
    """The port's resident table, uploaded from the reference's arrays;
    with ``join`` (the reference relation's four arrays), its join
    relation mirrored too.  Raises ValueError for a relation whose
    shapes do not fit the table or whose overlay is not sorted."""
    table = FrozenTable(node_tab, edge_tab, seeds, accept_filters, vocab,
                        depth)
    dev = DeviceNfa(table, active_slots=active_slots,
                    max_matches=max_matches, device=device)
    if join is not None:
        dev.enable_join(seed=JoinRelation(
            int(table.node_tab.shape[0]), table.edge_tab,
            arrays=tuple(np.asarray(a) for a in join)))
    return dev


def multichip_arrays_from_reference(mc, mesh: Mesh) -> MeshTables:
    """A reference ``MultichipMatcher``'s stacked arrays (``mc._arrs``,
    any array type numpy reads: ``node_stk``, ``edge_stk``,
    ``seeds_stk``, ``aid_stk``, the micro-table's node, edge, seeds and
    aid map, ``word_owner``) as the port's :class:`MeshTables` on
    ``mesh``, whose ``tp`` must be the reference's."""
    arrays = [np.asarray(a) for a in mc._arrs]
    if arrays[0].shape[0] != mesh.shape["tp"]:
        raise ValueError(f"reference tables hold {arrays[0].shape[0]} "
                         f"shards; the mesh has tp={mesh.shape['tp']}")
    return mesh_tables(mesh, *arrays)


def _bits(a, device) -> torch.Tensor:
    """A uint32 bitmap (numpy or any array type numpy reads) as the port's
    int32 bit patterns on ``device`` (default: the card; the caller names
    the CPU)."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype != np.uint32:
        raise ValueError(f"want a uint32 bitmap, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32).copy()).to(
        resolve_device(device))


def accept_bitmap_from_reference(bitmap, device=None) -> torch.Tensor:
    """The reference's accept→subscriber bitmap (``make_accept_bitmap``,
    ``shard_bitmap_rows``: ``(F+1, W)`` uint32) as the port's int32 bit
    patterns on ``device`` (the card unless the caller names another)."""
    return _bits(bitmap, device)


def group_masks_from_reference(masks, device=None) -> torch.Tensor:
    """The reference's ``$share`` group masks (``make_group_masks``: ``(G,
    W)`` uint32) as the port's int32 bit patterns on ``device``."""
    return _bits(masks, device)


def ep_tables_from_reference(tabs) -> EpTables:
    """The reference's ``EpTables`` (``build_partitions``) as the port's:
    the stacked tables, the shared vocab and the per-partition accept
    filters copied."""
    return EpTables(
        node_tabs=np.array(tabs.node_tabs, np.int32),
        edge_tabs=np.array(tabs.edge_tabs, np.int32),
        seeds=np.array(tabs.seeds, np.int32), vocab=dict(tabs.vocab),
        accept_filters=[list(a) for a in tabs.accept_filters],
        depth=int(tabs.depth))
