"""Native (C++) host components of the port: the incremental NFA table
(``nfa.cpp``, :class:`~emqx_tpu_torch.native.nfa.NativeNfa`), the
topic encoder (``encoder.cpp``, used by ``ops/encode.py``) and the rule
runtime's single-field JSON extractor (``fastjson.cpp``,
:mod:`~emqx_tpu_torch.native.fastjson`), built with ``g++`` at first use
and bound with ctypes."""

from .build import NativeBuildFailed, load_library

__all__ = ["NativeBuildFailed", "load_library"]
