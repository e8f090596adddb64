"""ctypes wrapper of the native incremental NFA table (``nfa.cpp``).

The port of the reference's ``emqx_tpu/native/nfa.py`` ``NativeNfa``:
the mutation and drain surface of
:class:`~emqx_tpu_torch.ops.incremental.IncrementalNfa` at 10M-filter
scale — a bulk build in seconds, O(filter) add/remove, a dirty-row
:class:`~emqx_tpu_torch.ops.incremental.NfaDelta` drain for the device
twin and the host match for spilled rows.  From the same calls it holds
the same bytes as the reference's table (tables, seeds, vocab, accept
ids, deltas).

Where the reference falls back to the Python table when the library
cannot be built, the port raises
(:class:`~emqx_tpu_torch.native.build.NativeBuildFailed`).  The
reference's ``accept_filters`` view (one C call and a 1 KB buffer per
id) is not copied: callers that turn accept ids into filters keep their
own map (``MatchService``), and :meth:`NativeNfa.accept_get` reads one
id.
"""

from __future__ import annotations

import ctypes
import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..gil import PIECE, yield_lock
from ..ops.compiler import BUCKET_SLOTS
from ..ops.incremental import NfaDelta
from .build import load_library

__all__ = ["NativeNfa"]

# int32s per cuckoo bucket row: nfa.cpp's ROW (BUCKET_SLOTS * 4).  A
# drift would size the fill buffers wrong and let the C side write past
# them, so it is checked against ops/compiler.py at construction.
_ROW = 8

_lib: Optional[ctypes.CDLL] = None


#: handles of collected tables, freed by a thread of their own
_doomed: "queue.SimpleQueue" = queue.SimpleQueue()
_freer_started = False


def _free_later(lib: ctypes.CDLL, h: ctypes.c_void_p) -> None:
    """Free a collected table's handle on the ``nfa-free`` thread.  A
    table swapped out by a compaction loses its last reference on the
    event loop's thread, and freeing a large table (millions of trie
    nodes and map entries) takes a share of a second that the loop's
    own thread would spend stalled, lock released or not.  Safe from
    ``__del__``: ``SimpleQueue.put`` is reentrant, and two racing
    starts make two freeing threads."""
    global _freer_started
    if not _freer_started:
        _freer_started = True
        threading.Thread(target=_free_loop, name="nfa-free",
                         daemon=True).start()
    _doomed.put((lib, h))


def _free_loop() -> None:
    while True:
        lib, h = _doomed.get()
        lib.nfa_free(h)


#: a flush of more dirty rows than this consolidates the allocator
_TRIM_ROWS = 65536
_libc_trim = None


def _trim() -> None:
    """``malloc_trim(0)`` of the C library (glibc; elsewhere nothing),
    through ctypes, so with the interpreter lock released.  A large
    flush clears the table's dirty sets, which leaves the allocator
    hundreds of thousands of small free chunks; the next large free
    merges them all, and when that free is a numpy array's it holds the
    lock the whole time, stalling the event loop beside a compaction's
    build thread."""
    global _libc_trim
    if _libc_trim is None:
        try:
            _libc_trim = ctypes.CDLL(None).malloc_trim
            _libc_trim.argtypes = [ctypes.c_size_t]
        except (OSError, AttributeError):
            _libc_trim = False
    if _libc_trim:
        _libc_trim(0)


def _check_row() -> None:
    if _ROW != 4 * BUCKET_SLOTS:
        raise RuntimeError(
            f"native/nfa.py _ROW={_ROW} out of sync with "
            f"compiler.BUCKET_SLOTS={BUCKET_SLOTS} (expected "
            f"{4 * BUCKET_SLOTS}); update both and nfa.cpp")


def _load() -> ctypes.CDLL:
    """The built and typed ``nfa`` library (raises if it cannot be
    built)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = load_library("nfa")
    i32, i64, vp = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    by_name = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
    sigs = {
        "nfa_new": (vp, [i32, i32, i32, ctypes.c_uint64]),
        "nfa_free": (None, [vp]),
        "nfa_add": (i32, by_name),
        "nfa_remove": (i32, by_name),
        "nfa_bulk_add": (i64, [vp, ctypes.c_char_p, i64]),
        "nfa_intern": (i32, by_name),
        "nfa_bulk_intern": (i64, [vp, ctypes.c_char_p, i64]),
        "nfa_grow_edges_to": (i64, [vp, i64]),
        "nfa_aid_of": (i32, by_name),
        "nfa_bulk_aid_of": (i64, [vp, ctypes.c_char_p, i64, i32p]),
        "nfa_alloc_alias": (i32, by_name),
        "nfa_free_alias": (i32, [vp, i32]),
        "nfa_match_topic": (i32, [vp, ctypes.c_char_p, i32, i32p, i32]),
        "nfa_sizes": (None, [vp, i64p]),
        "nfa_fill_tables": (None, [vp, i32p, i32p, i32p]),
        "nfa_vocab_fill": (None, [vp, ctypes.c_char_p]),
        "nfa_accept_get": (i32, [vp, i32, ctypes.c_char_p, i32]),
        "nfa_set_device_epoch": (None, [vp, i64]),
        "nfa_mark_resized": (None, [vp]),
        "nfa_delta_sizes": (None, [vp, i64p]),
        "nfa_delta_fill": (None, [vp, i32p, i32p, i32p, i32p]),
    }
    for fname, (res, args) in sigs.items():
        fn = getattr(lib, fname)
        fn.restype = res
        fn.argtypes = args
    _lib = lib
    return lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _lines(filters: Sequence[str]) -> Tuple[bytes, bool]:
    """``filters`` as one newline-framed blob, and whether the framing
    holds (no filter holds '\n', legal in MQTT).  Joined a piece at a
    time with a yield point after each (:mod:`emqx_tpu_torch.gil`): a
    compaction's build thread runs this beside the event loop."""
    parts: List[bytes] = []
    framed = True
    for i in range(0, len(filters), PIECE):
        chunk = filters[i:i + PIECE]
        part = "\n".join(chunk).encode()
        framed = framed and part.count(b"\n") + 1 == len(chunk)
        parts.append(part)
        yield_lock()
    return b"\n".join(parts), framed


class NativeNfa:
    """Handle-owning wrapper; see the module docstring.  ``state_bucket``
    and ``edge_bucket`` are the initial S and Hb (each grows by doubling);
    ``seed`` seeds the cuckoo seeds' ``std::mt19937``."""

    def __init__(self, depth: int = 8, state_bucket: int = 1024,
                 edge_bucket: int = 64, seed: int = 0xE709) -> None:
        _check_row()
        self._lib = _load()
        self._h = ctypes.c_void_p(self._lib.nfa_new(depth, state_bucket,
                                                    edge_bucket, seed))
        self.depth = depth
        # live vocab view: the SAME dict object, extended in place
        # (append-only, id order), so the encoder cached on this table
        # pushes only the new words
        self._vocab: Dict[str, int] = {}
        self._device_epoch: Optional[int] = None

    def close(self) -> None:
        if self._h:
            self._lib.nfa_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - interpreter teardown order
        h, self._h = getattr(self, "_h", None), None
        if h:
            try:
                _free_later(self._lib, h)
            except Exception:
                pass

    # -- mutation ----------------------------------------------------------

    def add(self, flt: str) -> bool:
        b = flt.encode()
        r = self._lib.nfa_add(self._h, b, len(b))
        if r < 0:
            raise ValueError(
                f"filter {flt!r} invalid (deeper than table depth, or "
                "'#' not in final position)")
        return bool(r)

    def remove(self, flt: str) -> bool:
        b = flt.encode()
        return bool(self._lib.nfa_remove(self._h, b, len(b)))

    def bulk_add(self, filters: Sequence[str]) -> int:
        """Add many filters in one native call (the large-table build
        path).  Invalid lines ('#' not final, too deep) are skipped; the
        return counts the filters actually added.  Filters holding
        '\\n' (legal in MQTT) cannot ride the newline-framed blob and are
        added one at a time."""
        blob, framed = _lines(filters)
        odd: List[str] = []
        if not framed:
            # the rare case, split in Python: a per-filter pass over a
            # large list holds the interpreter lock a compaction's build
            # thread shares with the event loop
            plain = [f for f in filters if "\n" not in f]
            odd = [f for f in filters if "\n" in f]
            blob = "\n".join(plain).encode()
        n = int(self._lib.nfa_bulk_add(self._h, blob, len(blob)))
        for f in odd:
            try:
                n += 1 if self.add(f) else 0
            except ValueError:
                pass
        # warm probe: the first mutations after a large bulk absorb a
        # one-off allocator consolidation stall; pay it here, not on a
        # live subscribe
        for i in range(4):
            probe = f"\x01warm/{i}".encode()
            self._lib.nfa_add(self._h, probe, len(probe))
            self._lib.nfa_remove(self._h, probe, len(probe))
        if n > 100_000:
            # the same for the flush path and delta-sized allocations;
            # then re-flag resized, so an attached consumer still makes
            # the whole upload the bulk requires
            self.flush()
            for _ in range(4):
                np.empty((4096, _ROW), np.int32)
                np.empty((4096, 4), np.int32)
            self._lib.nfa_mark_resized(self._h)
        return n

    def intern(self, word: str) -> int:
        """Intern ``word`` into the vocab without adding a filter; its
        id.  Ids assign append-only, so replaying one word sequence into
        several tables keeps their vocabs identical."""
        b = word.encode()
        wid = int(self._lib.nfa_intern(self._h, b, len(b)))
        if word not in self._vocab:
            self._vocab[word] = wid
        return wid

    def bulk_intern(self, words: Sequence[str]) -> int:
        """Intern many words in order with one native call (NUL framing:
        words may hold '\\n', never NUL); returns the words read."""
        blob = "\x00".join(words).encode()
        n = int(self._lib.nfa_bulk_intern(self._h, blob, len(blob)))
        for w in words:
            if w not in self._vocab:
                self._vocab[w] = len(self._vocab) + 1
        return n

    def grow_edges_to(self, hb_target: int) -> int:
        """Grow the cuckoo edge table until Hb >= ``hb_target`` (lookups
        hash modulo Hb, so the shard tables of one mesh share one real
        bucket count).  Marks the table resized; returns the new Hb."""
        return int(self._lib.nfa_grow_edges_to(self._h, int(hb_target)))

    # -- introspection -----------------------------------------------------

    def _sizes(self) -> np.ndarray:
        """[S, Hb, n_states, n_edges, n_accepts, n_filters, vocab count,
        vocab bytes, epoch, resized, aid_reuses]"""
        out = np.zeros(11, np.int64)
        self._lib.nfa_sizes(self._h, out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)))
        return out

    @property
    def n_filters(self) -> int:
        return int(self._sizes()[5])

    @property
    def n_states(self) -> int:
        return int(self._sizes()[2])

    @property
    def n_edges(self) -> int:
        return int(self._sizes()[3])

    @property
    def n_accepts(self) -> int:
        """Length of the accept-id space (holes included)."""
        return int(self._sizes()[4])

    @property
    def epoch(self) -> int:
        return int(self._sizes()[8])

    @property
    def aid_reuses(self) -> int:
        return int(self._sizes()[10])

    def shape_key(self) -> Tuple[int, int, int]:
        s = self._sizes()
        return (int(s[0]), int(s[1]), self.depth)

    # -- table export ------------------------------------------------------

    def tables(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fresh copies of the arrays in kernel order: (node_tab,
        edge_tab, seeds)."""
        s = self._sizes()
        node_tab = np.empty((int(s[0]), 4), np.int32)
        edge_tab = np.empty((int(s[1]), _ROW), np.int32)
        seeds = np.empty(2, np.int32)
        self._lib.nfa_fill_tables(self._h, _i32p(node_tab), _i32p(edge_tab),
                                  _i32p(seeds))
        return node_tab, edge_tab, seeds

    @property
    def vocab(self) -> Dict[str, int]:
        """Word → id (id 0 is UNKNOWN).  The native vocab is append-only;
        this extends the SAME dict in place when it grew."""
        s = self._sizes()
        n = int(s[6])
        if len(self._vocab) != n:
            buf = ctypes.create_string_buffer(int(s[7]) + 1)
            self._lib.nfa_vocab_fill(self._h, buf)
            # NUL-separated: words may legally hold '\n' but never NUL
            words = buf.raw[: max(0, int(s[7]) - 1)].decode().split("\x00")
            for i in range(len(self._vocab), n):
                self._vocab[words[i]] = i + 1
        return self._vocab

    def accept_get(self, aid: int) -> Optional[str]:
        """The filter of accept id ``aid``; None for a hole.  One C call:
        not for a per-id loop on the serve path."""
        buf = ctypes.create_string_buffer(1024)
        n = self._lib.nfa_accept_get(self._h, aid, buf, 1024)
        return buf.raw[:n].decode() if n >= 0 else None

    def aid_of(self, flt: str) -> int:
        """Accept id of filter ``flt``; -1 if absent (aliases are not
        found: the caller keeps their ids)."""
        b = flt.encode()
        return int(self._lib.nfa_aid_of(self._h, b, len(b)))

    def bulk_aid_of(self, filters: Sequence[str]) -> np.ndarray:
        """``aid_of`` of each filter, in one native call: (n,) int32, -1
        where absent."""
        if not filters:
            return np.zeros(0, np.int32)
        blob, framed = _lines(filters)
        if not framed:
            # a filter holds '\n' (legal in MQTT): one call each
            return np.array([self.aid_of(f) for f in filters], np.int32)
        out = np.empty(len(filters), np.int32)
        self._lib.nfa_bulk_aid_of(self._h, blob, len(blob), _i32p(out))
        return out

    def alloc_alias(self, flt: str) -> int:
        """Accept id with no trie states (filters deeper than the table),
        as ``IncrementalNfa.alloc_alias``."""
        b = flt.encode()
        return int(self._lib.nfa_alloc_alias(self._h, b, len(b)))

    def free_alias(self, aid: int) -> None:
        self._lib.nfa_free_alias(self._h, aid)

    def match_host(self, topic: str, cap: int = 4096) -> List[int]:
        """Accept ids matching ``topic`` on the host table (the re-run
        of spilled rows)."""
        b = topic.encode()
        out = np.empty(cap, np.int32)
        n = self._lib.nfa_match_topic(self._h, b, len(b), _i32p(out), cap)
        if n > cap:  # a very wide match: again at the exact size
            out = np.empty(n, np.int32)
            n = self._lib.nfa_match_topic(self._h, b, len(b), _i32p(out), n)
        return out[:n].tolist()

    # -- device delta feed -------------------------------------------------

    @property
    def device_epoch(self) -> Optional[int]:
        """The epoch the device twin acked, as
        ``IncrementalNfa.device_epoch`` (freed accept ids are reused only
        once the device applied their removal)."""
        return self._device_epoch

    @device_epoch.setter
    def device_epoch(self, epoch: Optional[int]) -> None:
        # None = no consumer (-2 on the C side); -1 = attached, nothing
        # acked yet
        c_epoch = -2 if epoch is None else int(epoch)
        self._lib.nfa_set_device_epoch(self._h, c_epoch)
        self._device_epoch = c_epoch

    def flush(self) -> NfaDelta:
        """Drain the dirty rows as an :class:`NfaDelta` (after a resize
        the consumer must re-upload the tables whole)."""
        hdr = np.zeros(4, np.int64)
        self._lib.nfa_delta_sizes(self._h, hdr.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)))
        ns, nb, resized, epoch = (int(x) for x in hdr)
        state_idx = np.empty(ns, np.int32)
        state_rows = np.empty((ns, 4), np.int32)
        bucket_idx = np.empty(nb, np.int32)
        bucket_rows = np.empty((nb, _ROW), np.int32)
        self._lib.nfa_delta_fill(self._h, _i32p(state_idx), _i32p(state_rows),
                                 _i32p(bucket_idx), _i32p(bucket_rows))
        if ns + nb > _TRIM_ROWS:
            _trim()
        return NfaDelta(epoch=epoch, resized=bool(resized),
                        state_idx=state_idx, state_rows=state_rows,
                        bucket_idx=bucket_idx, bucket_rows=bucket_rows)
