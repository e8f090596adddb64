"""Persistent compacted table segments: cold start without the rebuild.

The port's copy of ``emqx_tpu/storage/segments.py``, with the same file
format, so that a segment written by either package loads in the other:
one ``.npz`` written through a temp file and ``os.replace`` (a crash
leaves the old file or the new one), with a JSON meta record holding
``version`` and a sha1 ``checksum`` over every payload array and the
rest of the meta record; :func:`load_segment` hashes again and raises
:class:`SegmentError` on any mismatch, so that a torn or bit-rotten
segment is rejected and the caller rebuilds from the router.

Two kinds, by host table:

* ``state`` (the Python :class:`~emqx_tpu_torch.ops.incremental.
  IncrementalNfa`): the whole mutable state, the flat arrays as they
  are, the trie as a preorder relation ``(sid, parent_sid,
  edge_word_id, hash_aid, aid)``, the vocab, the accept, alias and
  free-list state, and (with ``join_relation``) the sorted join
  relation.  :func:`restore_incremental` rebuilds the table from the
  arrays and links the trie lazily, at its first walk or mutation or in
  the service's background hydrate;
* ``filters`` (the native table): the filter set as one NUL-framed
  blob, which a load replays through ``NativeNfa.bulk_add``.

The alias (too-deep filter) map and the routing accept ids ride in both
kinds.  ``extra_meta`` entries land inside the checksummed meta record.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..gil import PIECE, yield_lock

__all__ = ["SegmentError", "Segment", "save_segment", "load_segment",
           "restore_incremental", "SEGMENT_VERSION"]

# version 2: state segments may carry the sorted join relation
# (join_start / join_word / join_next, ops/join_match.py), so that a
# cold start seeds the device relation without the build sort; other
# versions are rejected (the full rebuild serves)
SEGMENT_VERSION = 2

_SEP = "\x00"  # MQTT strings never contain U+0000 (MQTT-1.5.4-2)


class SegmentError(RuntimeError):
    """Segment unusable: bad magic/version, checksum mismatch, or a
    structurally impossible payload.  Callers fall back to the full
    rebuild — never serve from a suspect table."""


@dataclass
class Segment:
    """Decoded segment payload (see module docstring for the kinds)."""

    kind: str                      # "state" | "filters"
    depth: int
    epoch: int
    filters: List[str]             # live NFA filters (aliases excluded)
    deep: Dict[str, int]           # too-deep filter -> alias aid
    routing_aids: List[int]        # aids that belonged to routing filters
    meta: dict = field(default_factory=dict)
    # state-kind payload (None for "filters" segments)
    node_tab: Optional[np.ndarray] = None
    edge_tab: Optional[np.ndarray] = None
    seeds: Optional[np.ndarray] = None
    trie: Optional[np.ndarray] = None       # (n, 5) int32 BFS relation
    vocab_words: Optional[List[str]] = None  # id order (1-based)
    accept_mask: Optional[np.ndarray] = None
    accept_filters: Optional[List[str]] = None  # holes as None
    alias_aids: Optional[List[int]] = None
    free_aids: Optional[np.ndarray] = None  # (k, 2) int64 (epoch, aid)
    n_filters: int = 0
    n_states: int = 0
    aid_reuses: int = 0
    # sorted join-relation arrays (v2, optional — present when the
    # writer served the join backend): CSR offsets + word/next columns
    join_start: Optional[np.ndarray] = None  # (S+1,) int32
    join_word: Optional[np.ndarray] = None   # (E_cap,) int32
    join_next: Optional[np.ndarray] = None   # (E_cap,) int32


def _blob(strings) -> np.ndarray:
    """The strings ``_SEP``-joined as bytes: a piece at a time with a
    yield point after each (:mod:`emqx_tpu_torch.gil`), as a
    compaction's build thread writes a segment beside the event loop."""
    strings = strings if isinstance(strings, list) else list(strings)
    parts = []
    for i in range(0, len(strings), PIECE):
        parts.append(_SEP.join(strings[i:i + PIECE]).encode("utf-8"))
        yield_lock()
    data = _SEP.encode("utf-8").join(parts)
    return np.frombuffer(data, dtype=np.uint8).copy()


def _unblob(arr: np.ndarray) -> List[str]:
    if arr.size == 0:
        return []
    return bytes(arr.tobytes()).decode("utf-8").split(_SEP)


def _checksum(arrays: Dict[str, np.ndarray], meta: dict) -> str:
    h = hashlib.sha1()
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a)     # the array's bytes, with no copy under the lock
    h.update(json.dumps(meta, sort_keys=True).encode())
    return h.hexdigest()


def _trie_rows(inc) -> np.ndarray:
    """Flatten the live trie into the preorder relation ``(sid,
    parent_sid, edge_word_id, hash_aid, aid)``; parents precede their
    children so the restore pass links in one forward scan.
    edge_word_id: the vocab id of the literal parent edge, -1 for a
    ``+`` edge, -2 for the root."""
    inc._hydrate()   # a restored-but-never-touched trie links here
    rows: List[Tuple[int, int, int, int, int]] = []
    stack = [inc.root]
    vocab = inc.vocab
    while stack:
        node = stack.pop()
        if node.parent is None:
            wid = -2
            parent = -1
        else:
            parent = node.parent.sid
            wid = -1 if node.pword is None else vocab[node.pword]
        rows.append((node.sid, parent, wid, node.hash_aid, node.aid))
        stack.extend(node.lit.values())
        if node.plus is not None:
            stack.append(node.plus)
    out = np.asarray(rows, dtype=np.int32).reshape(len(rows), 5)
    return out


def save_segment(path: str, inc, *, deep: Dict[str, int],
                 routing_aids, filters: Optional[List[str]] = None,
                 extra_meta: Optional[dict] = None,
                 join_relation: bool = False) -> dict:
    """Serialize ``inc`` (+ the serving layer's deep/routing id state)
    to ``path`` atomically.  ``filters`` must be supplied for native
    tables (the caller already has the list — iterating the accept view
    back out would cost one ctypes round trip per filter).

    ``join_relation`` (state segments only) additionally persists the
    sorted edge relation built fresh from the edge table — always
    overlay-free, so a restore can seed the join backend's device
    mirror verbatim (epoch-guarded by the consumer)."""
    is_state = hasattr(inc, "node_tab") and hasattr(inc, "root")
    meta: dict = {
        "version": SEGMENT_VERSION,
        "kind": "state" if is_state else "filters",
        "depth": int(inc.depth),
        "epoch": int(inc.epoch),
        "n_filters": int(inc.n_filters),
        "n_states": int(inc.n_states),
        "aid_reuses": int(inc.aid_reuses),
    }
    if extra_meta:
        meta.update(extra_meta)
    arrays: Dict[str, np.ndarray] = {
        "deep_filters": _blob(list(deep.keys())),
        "deep_aids": np.asarray(list(deep.values()), np.int32),
        "routing_aids": (np.sort(routing_aids.astype(np.int32))
                         if isinstance(routing_aids, np.ndarray)
                         else np.asarray(sorted(routing_aids), np.int32)),
    }
    if is_state:
        accepts = list(inc.accept_filters)
        mask = np.asarray([f is not None for f in accepts], bool)
        arrays.update(
            node_tab=inc.node_tab,
            edge_tab=inc.edge_tab,
            seeds=inc.seeds,
            trie=_trie_rows(inc),
            vocab=_blob(list(inc.vocab.keys())),
            accept_mask=mask,
            accepts=_blob([f for f in accepts if f is not None]),
            alias_aids=np.asarray(sorted(inc._alias_aids), np.int32),
            free_aids=np.asarray(
                [(e, a) for e, a in inc._free_aids], np.int64
            ).reshape(-1, 2),
        )
        if join_relation:
            from ..ops.join_match import JoinRelation

            rel = JoinRelation(
                int(inc.node_tab.shape[0]), inc.edge_tab)
            arrays.update(
                join_start=rel.state_start,
                join_word=rel.edge_word,
                join_next=rel.edge_next,
            )
    else:
        if filters is None:
            raise ValueError(
                "filters list required for native-table segments")
        arrays["filters"] = _blob(filters)
    meta["checksum"] = _checksum(arrays, {
        k: v for k, v in meta.items() if k != "checksum"})
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, meta=_blob([json.dumps(meta)]), **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return meta


def load_segment(path: str) -> Segment:
    """Read + verify a segment; raises :class:`SegmentError` on ANY
    defect (missing file, version skew, checksum mismatch)."""
    try:
        z = np.load(path)
    except Exception as e:  # np.load surfaces zipfile/format errors too
        raise SegmentError(f"segment unreadable: {e}") from e
    with z:
        try:
            meta = json.loads(_unblob(z["meta"])[0])
        except Exception as e:
            raise SegmentError(f"segment meta unreadable: {e}") from e
        if meta.get("version") != SEGMENT_VERSION:
            raise SegmentError(
                f"segment version {meta.get('version')!r} != "
                f"{SEGMENT_VERSION}")
        try:
            # zip CRC / npy header defects surface here, per array
            arrays = {name: z[name] for name in z.files if name != "meta"}
        except Exception as e:
            raise SegmentError(f"segment arrays unreadable: {e}") from e
        want = meta.get("checksum")
        got = _checksum(arrays, {
            k: v for k, v in meta.items() if k != "checksum"})
        if want != got:
            raise SegmentError(
                f"segment checksum mismatch ({want!r} != {got!r})")
    deep_filters = _unblob(arrays["deep_filters"])
    deep_aids = arrays["deep_aids"].tolist()
    seg = Segment(
        kind=meta["kind"], depth=int(meta["depth"]),
        epoch=int(meta["epoch"]),
        filters=[], deep=dict(zip(deep_filters, deep_aids)),
        routing_aids=arrays["routing_aids"].tolist(), meta=meta,
        n_filters=int(meta["n_filters"]), n_states=int(meta["n_states"]),
        aid_reuses=int(meta.get("aid_reuses", 0)),
    )
    if meta["kind"] == "state":
        accepts_live = _unblob(arrays["accepts"])
        mask = arrays["accept_mask"]
        accept_filters: List[Optional[str]] = [None] * len(mask)
        it = iter(accepts_live)
        for i, live in enumerate(mask):
            if live:
                accept_filters[i] = next(it)
        seg.node_tab = arrays["node_tab"]
        seg.edge_tab = arrays["edge_tab"]
        seg.seeds = arrays["seeds"]
        seg.trie = arrays["trie"]
        seg.vocab_words = _unblob(arrays["vocab"])
        seg.accept_mask = mask
        seg.accept_filters = accept_filters
        seg.alias_aids = arrays["alias_aids"].tolist()
        seg.free_aids = arrays["free_aids"]
        if "join_start" in arrays:
            seg.join_start = arrays["join_start"]
            seg.join_word = arrays["join_word"]
            seg.join_next = arrays["join_next"]
        alias = set(seg.alias_aids)
        seg.filters = [
            f for aid, f in enumerate(accept_filters)
            if f is not None and aid not in alias
        ]
    else:
        seg.filters = _unblob(arrays["filters"])
    return seg


def restore_incremental(seg: Segment, seed: int = 0xE709):
    """Rebuild a live Python :class:`IncrementalNfa` from a ``state``
    segment in one linear pass (no per-filter adds — the point)."""
    from collections import deque

    from ..ops.incremental import IncrementalNfa, _INode

    if seg.kind != "state":
        raise SegmentError(f"cannot restore from a {seg.kind!r} segment")
    inc = IncrementalNfa.__new__(IncrementalNfa)
    inc.depth = seg.depth
    inc._rng = np.random.default_rng(seed ^ (seg.epoch & 0xFFFF))
    inc.node_tab = np.ascontiguousarray(seg.node_tab, np.int32)
    inc.edge_tab = np.ascontiguousarray(seg.edge_tab, np.int32)
    inc.seeds = np.ascontiguousarray(seg.seeds, np.int32)
    inc._seed_ints = (int(inc.seeds[0]), int(inc.seeds[1]))
    words = list(seg.vocab_words or [])
    inc.vocab = {w: i + 1 for i, w in enumerate(words)}
    id2word = [None] + words   # vocab ids are 1-based, dense
    inc.accept_filters = list(seg.accept_filters or [])
    inc.epoch = seg.epoch
    inc.n_filters = seg.n_filters
    inc.n_states = seg.n_states
    inc.n_edges = int(np.count_nonzero(
        inc.edge_tab.reshape(-1, 4)[:, 0] >= 0))
    # trie relink is LAZY: the flat relation parks on the table and
    # links into _INode objects on first mutation/walk (or when the
    # serving layer's background hydrate gets there first) — the cold
    # start itself pays only the array load above.  Parents precede
    # children in the relation, so one forward scan rebuilds the tree.
    s = int(inc.node_tab.shape[0])
    trie = np.ascontiguousarray(
        seg.trie if seg.trie is not None else np.zeros((0, 5), np.int32))
    used = np.zeros(s, bool)
    used[trie[:, 0]] = True
    used[0] = True
    inc._free_sids = np.flatnonzero(~used)[::-1].tolist()
    inc.root = None   # valid only after hydration (all entry points do)
    lock = threading.Lock()

    def hydrate() -> None:
        with lock:
            if inc._pending_trie is None:
                return   # lost the race: another thread linked it
            nodes: List[Optional[_INode]] = [None] * s
            for sid, parent, wid, hash_aid, aid in trie.tolist():
                if wid == -2:
                    node = _INode(sid, None, None)
                elif wid == -1:
                    node = _INode(sid, nodes[parent], None)
                    nodes[parent].plus = node
                else:
                    word = id2word[wid]
                    node = _INode(sid, nodes[parent], word)
                    nodes[parent].lit[word] = node
                node.hash_aid = hash_aid
                node.aid = aid
                nodes[sid] = node
            inc.root = nodes[0] if nodes and nodes[0] is not None \
                else _INode(0, None, None)
            inc._pending_trie = None

    inc._pending_trie = hydrate
    inc._free_aids = deque(
        (int(e), int(a)) for e, a in
        (seg.free_aids.tolist() if seg.free_aids is not None else ()))
    inc.device_epoch = None
    inc.aid_reuses = seg.aid_reuses
    inc._alias_aids = set(seg.alias_aids or ())
    inc._dirty_states = set()
    inc._dirty_buckets = set()
    inc._resized = False
    inc.track_regions = False
    inc._node_grown_from = -1
    inc._edges_rehashed = False
    inc._node_wholesale = False
    return inc
