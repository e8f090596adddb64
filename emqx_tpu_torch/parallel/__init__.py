"""The multi-device match plane: the mesh of torch devices, its
collectives, and the multichip serve backend (the table sharded by
topic prefix, K8a)."""

from .collectives import all_gather, all_to_all, psum
from .mesh import Mesh, make_mesh, pick_shape
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
from .prefix_ep import greedy_balance, owner_of
from .sharded_match import (CompactFanoutResult, FanoutResult,
                            decode_compact_rows)

__all__ = [
    "Mesh", "make_mesh", "pick_shape",
    "all_gather", "all_to_all", "psum",
    "MeshTables", "MultichipMatcher", "ShardDead", "build_multichip_step",
    "is_micro_filter", "mesh_tables", "serve_mesh_shape", "shard_of_filter",
    "greedy_balance", "owner_of",
    "CompactFanoutResult", "FanoutResult", "decode_compact_rows",
]
