"""Batch topic encoding for the walk: topic strings → word ids.

The port of the reference's ``emqx_tpu/ops/encode.py``: the C++
tokenizer (``native/encoder.cpp``, ctypes), with the same output
contract as the reference:

* ``words (B, D) int32`` — per level the vocab id, 0 for a word no filter
  has (UNKNOWN: no literal edge carries it);
* ``lens (B,) int32`` — the level count, capped at D+1 so that "deeper
  than D" means "no end accept fires";
* ``is_sys (B,) bool`` — ``$``-topics, which root wildcards do not match.

Padding rows past ``len(names)`` are inert: ``len = D+2``,
``is_sys = True`` and all-UNKNOWN words, so they match nothing.

An encoder is cached on its table object (:func:`table_encoder`) and
pushes the words the vocab gained since its last call.  One C++ object
serves every thread that encodes against the table, and ctypes drops
the GIL inside it, so a lock serialises its calls.  The Python loop
is kept only for what the reference keeps it for: a batch in which a
topic holds a NUL (MQTT forbids it; it would shift the native parse's
rows), which is encoded whole in Python and counted in
``TopicEncoder.python_batches``.  Where the reference falls back to
Python when the library cannot be built, the port raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .. import topic as T
from ..native.build import load_library

__all__ = ["TopicEncoder", "encode_batch", "table_encoder"]

_lib: Optional[ctypes.CDLL] = None


def _native() -> ctypes.CDLL:
    """The built and typed ``encoder`` library (raises if it cannot be
    built)."""
    global _lib
    if _lib is None:
        lib = load_library("encoder")
        lib.enc_new.restype = ctypes.c_void_p
        lib.enc_new.argtypes = []
        lib.enc_free.restype = None
        lib.enc_free.argtypes = [ctypes.c_void_p]
        lib.enc_add_words.restype = None
        lib.enc_add_words.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int32]
        lib.enc_vocab_size.restype = ctypes.c_int64
        lib.enc_vocab_size.argtypes = [ctypes.c_void_p]
        lib.enc_encode.restype = ctypes.c_int32
        lib.enc_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
    return _lib


class TopicEncoder:
    """Vocab-bound native encoder; new vocab entries are pushed at each
    call (the vocab only appends).  Counts the batches it encoded
    natively and those a NUL sent down the Python loop."""

    def __init__(self, vocab: Dict[str, int]) -> None:
        self.vocab = vocab
        self._pushed = 0
        self._libref = _native()
        self._h = ctypes.c_void_p(self._libref.enc_new())
        self._lock = threading.Lock()
        self.native_batches = 0
        self.python_batches = 0

    def __del__(self):  # pragma: no cover - interpreter teardown order
        if getattr(self, "_h", None):
            try:
                self._libref.enc_free(self._h)
            except Exception:
                pass

    def _push_new_words(self) -> None:
        """Ship the vocab entries added since the last call (a dict keeps
        insertion order and interning only appends)."""
        if len(self.vocab) == self._pushed:
            return
        # one atomic copy: the table's thread may append while we read
        items = list(self.vocab.items())[self._pushed:]
        buf = b"\x00".join(w.encode("utf-8") for w, _ in items)
        ids = np.fromiter((i for _, i in items), np.int32, len(items))
        self._libref.enc_add_words(self._h, buf, len(buf),
                                   ids.ctypes.data_as(ctypes.c_void_p),
                                   len(items))
        self._pushed += len(items)

    def encode(
        self, names: Sequence[str], depth: int, batch: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        D = depth
        B = batch if batch is not None else len(names)
        n = len(names)
        if n > B:
            raise ValueError(f"{n} topics > batch {B}")
        words = np.zeros((B, D), np.int32)
        lens = np.full(B, D + 2, np.int32)
        is_sys = np.ones(B, bool)
        if n == 0:
            return words, lens, is_sys
        joined = "\x00".join(names).encode("utf-8")
        sys8 = np.zeros(n, np.uint8)
        with self._lock:
            self._push_new_words()
            done = self._libref.enc_encode(
                self._h, joined, len(joined), n, D,
                words.ctypes.data_as(ctypes.c_void_p),
                lens.ctypes.data_as(ctypes.c_void_p),
                sys8.ctypes.data_as(ctypes.c_void_p))
            if done == n:
                self.native_batches += 1
            else:
                self.python_batches += 1
        if done == n:
            is_sys[:n] = sys8.astype(bool)
            return words, lens, is_sys
        # a topic held a NUL: the segment count diverged, which would
        # row-shift other topics' answers — the whole batch in Python
        words[:n] = 0
        lens[:n] = D + 2
        vocab = self.vocab
        for r, name in enumerate(names):
            ws = T.words(name)
            lens[r] = min(len(ws), D + 1)
            is_sys[r] = name.startswith("$")
            words[r, :min(len(ws), D)] = [vocab.get(w, 0) for w in ws[:D]]
        return words, lens, is_sys


def table_encoder(table) -> TopicEncoder:
    """The encoder cached on ``table`` (anything with ``.vocab``), made
    anew when the table's vocab object was swapped."""
    vocab = table.vocab
    enc = getattr(table, "_topic_encoder", None)
    if enc is None or enc.vocab is not vocab:
        enc = TopicEncoder(vocab)
        try:
            object.__setattr__(table, "_topic_encoder", enc)
        except (AttributeError, TypeError):
            pass    # slotted or frozen table: an encoder for this call
    return enc


def encode_batch(
    table, names: Sequence[str], batch: Optional[int] = None,
    depth: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode against any table with ``.vocab`` and ``.depth``
    (:class:`NfaTable`, :class:`IncrementalNfa`, ``NativeNfa``), with the
    encoder cached on the table."""
    return table_encoder(table).encode(
        names, depth if depth is not None else table.depth, batch=batch)
