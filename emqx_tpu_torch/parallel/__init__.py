"""The multi-device match plane: the mesh of torch devices with named
axes, its collectives, the multichip serve backend (the table sharded by
topic prefix, K8a) and the library steps of the fan-out (K8b-K8f): the
column-sharded bitmap fan-out, ``$share`` selection, the ring fan-out,
the prefix-partitioned EP matcher and the Ulysses reshard."""

from .collectives import (all_gather, all_to_all, all_to_all_tiled, pmax,
                          ppermute, psum)
from .mesh import Mesh, Sharded, make_mesh, pick_shape
from .multichip_serve import (
    MeshTables,
    MultichipMatcher,
    ShardDead,
    build_multichip_step,
    is_micro_filter,
    mesh_tables,
    serve_mesh_shape,
    shard_of_filter,
)
from .prefix_ep import (EpResult, EpTables, build_ep_matcher,
                        build_partitions, greedy_balance, owner_of)
from .ring_fanout import (build_ring_fanout, build_ring_fanout_compact,
                          shard_bitmap_rows)
from .shared_group import build_shared_selector, host_pick, make_group_masks
from .sharded_match import (CompactFanoutResult, FanoutResult,
                            build_sharded_matcher,
                            build_sharded_matcher_compact,
                            compact_bitmap_ids, decode_compact_rows,
                            make_accept_bitmap, or_accept_rows)
from .ulysses import (UlyssesResult, build_reshard, build_ulysses_step,
                      build_unreshard)

__all__ = [
    "Mesh", "Sharded", "make_mesh", "pick_shape",
    "all_gather", "all_to_all", "all_to_all_tiled", "pmax", "ppermute",
    "psum",
    "MeshTables", "MultichipMatcher", "ShardDead", "build_multichip_step",
    "is_micro_filter", "mesh_tables", "serve_mesh_shape", "shard_of_filter",
    "CompactFanoutResult", "FanoutResult", "build_sharded_matcher",
    "build_sharded_matcher_compact", "compact_bitmap_ids",
    "decode_compact_rows", "make_accept_bitmap", "or_accept_rows",
    "build_shared_selector", "make_group_masks", "host_pick",
    "build_ring_fanout", "build_ring_fanout_compact", "shard_bitmap_rows",
    "EpResult", "EpTables", "build_partitions", "build_ep_matcher",
    "owner_of", "greedy_balance",
    "UlyssesResult", "build_reshard", "build_unreshard",
    "build_ulysses_step",
]
