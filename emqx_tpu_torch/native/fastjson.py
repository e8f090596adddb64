"""ctypes wrapper for the C++ single-field JSON extractor.

The port's own copy of the reference's ``emqx_tpu/native/fastjson.py``
(``fastjson.cpp`` is the reference's source, unchanged); the rule
runtime's ``payload.<path>`` lookups call it before decoding a payload.

``get_path(payload, ("a", "b")) -> (found, value)``: found=False means
"use json.loads" (missing key, escaped string, non-scalar result,
bignum), so the fast path never changes semantics, only skips work.
Unlike the reference, a library that does not build raises
(``NativeBuildFailed``, as for the port's other native sources) instead
of sending every lookup to ``json.loads``.
"""

from __future__ import annotations

import ctypes
from typing import Any, Sequence, Tuple

from .build import load_library

__all__ = ["get_path"]

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = load_library("fastjson")
        lib.fj_get.restype = ctypes.c_int
        lib.fj_get.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_longlong),
        ]
        _lib = lib
    return _lib


def get_path(payload: bytes, path: Sequence[str]) -> Tuple[bool, Any]:
    if not path or any(p == "" for p in path):
        # empty segments would collapse in the \x1f join and skip both
        # the lookup and the trailing-garbage check: fall back
        return False, None
    lib = _load()
    try:
        p = "\x1f".join(path).encode("utf-8")
    except UnicodeEncodeError:
        return False, None
    sptr = ctypes.c_char_p()
    slen = ctypes.c_size_t()
    dval = ctypes.c_double()
    ival = ctypes.c_longlong()
    rc = lib.fj_get(payload, len(payload), p, len(p),
                    ctypes.byref(sptr), ctypes.byref(slen),
                    ctypes.byref(dval), ctypes.byref(ival))
    if rc == 0:
        return False, None
    if rc == 1:
        raw = ctypes.string_at(sptr, slen.value)
        try:
            return True, raw.decode("utf-8")
        except UnicodeDecodeError:
            return False, None
    if rc == 2:
        return True, int(ival.value)
    if rc == 3:
        return True, float(dval.value)
    if rc == 4:
        return True, True
    if rc == 5:
        return True, False
    if rc == 6:
        return True, None
    return False, None
