"""Build a C++ source of this directory with ``g++`` and load it with
ctypes, at first use.

``<name>.cpp`` compiles into ``BUILD_DIR`` (listed in ``.gitignore``) as
``lib<name>-<digest>.so``: the digest covers the flags and the source, so
an edited source is rebuilt and a stale build is never loaded.  The
compiler writes a temporary file that is renamed into place, so
processes that build the same source at once (test workers) race
safely.  A failed build or load raises :class:`NativeBuildFailed`: the
port has no Python stand-in for its native table and encoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

__all__ = ["BUILD_DIR", "NativeBuildFailed", "load_library"]

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++20")

_libs: Dict[str, ctypes.CDLL] = {}


class NativeBuildFailed(RuntimeError):
    """A native source did not build or its library did not load."""


def _lib_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cpp"
    try:
        text = src.read_bytes()
    except OSError as e:
        raise NativeBuildFailed(f"native source {src.name}: {e}") from e
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + text)
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(src: Path, out: Path) -> None:
    """g++ into a temporary file, then an atomic rename onto ``out``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", tmp],
                              stdin=subprocess.DEVNULL, capture_output=True,
                              text=True, timeout=300)
        if proc.returncode != 0:
            raise NativeBuildFailed(
                f"g++ {src.name}: exit {proc.returncode}\n{proc.stderr}")
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildFailed(f"g++ {src.name}: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``<name>.cpp``, built first if needed.
    Raises :class:`NativeBuildFailed` when it cannot be built or
    loaded."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            _compile(SRC_DIR / f"{name}.cpp", path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeBuildFailed(f"load {path.name}: {e}") from e
        _libs[name] = lib
    return lib
