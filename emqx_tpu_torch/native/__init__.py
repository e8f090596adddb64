"""Native (C++) host components of the port: the incremental NFA table
(``nfa.cpp``, :class:`~emqx_tpu_torch.native.nfa.NativeNfa`) and the
topic encoder (``encoder.cpp``, used by ``ops/encode.py``), built with
``g++`` at first use and bound with ctypes."""

from .build import NativeBuildFailed, load_library

__all__ = ["NativeBuildFailed", "load_library"]
