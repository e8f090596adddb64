"""NFA table checkpoint: skip the cold compile on restart.

The port's copy of ``emqx_tpu/storage/checkpoint.py``, with the same
file format, so that a checkpoint written by either package loads in
the other: the arrays of a compiled :class:`NfaTable` and a JSON
``meta`` record (states, depth, epoch, vocab, accept filters) in one
``.npz``, written through a temp file and ``os.replace``.  The match
sidecar (``exhook/server.py``) writes one after each mirror sync and
re-adopts its filter set at start, so that it serves at once while the
live feed reconciles.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..ops.compiler import NfaTable

__all__ = ["save_table", "load_table"]


def save_table(table: NfaTable, path: str) -> None:
    tmp = path + ".tmp"
    meta = {
        "n_states": table.n_states,
        "depth": table.depth,
        "epoch": table.epoch,
        "vocab": table.vocab,
        "accept_filters": table.accept_filters,
    }
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f,
            node_tab=table.node_tab,
            edge_tab=table.edge_tab,
            seeds=table.seeds,
            meta=np.frombuffer(
                json.dumps(meta).encode("utf-8"), dtype=np.uint8
            ),
        )
    os.replace(tmp, path)


def load_table(path: str) -> Optional[NfaTable]:
    """The table checkpointed at ``path``, or None when there is none."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        return NfaTable(
            node_tab=z["node_tab"],
            edge_tab=z["edge_tab"],
            seeds=z["seeds"],
            n_states=int(meta["n_states"]),
            depth=int(meta["depth"]),
            vocab=dict(meta["vocab"]),
            accept_filters=list(meta["accept_filters"]),
            epoch=int(meta["epoch"]),
        )
