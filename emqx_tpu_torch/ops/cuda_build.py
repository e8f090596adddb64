"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``csrc/`` compiles, at first use, into a shared
library with a plain C interface in ``BUILD_DIR`` (listed in
``.gitignore``).  The library's name carries a digest of the flags, the
source and every ``csrc/`` header it includes, so an edited source or
header is rebuilt and a stale build is never loaded.  Sources include no PyTorch header: ``nvcc`` takes seconds for
them, where a PyTorch extension build takes minutes.  :func:`build`
starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

__all__ = ["BUILD_DIR", "SOURCES", "build", "load", "ptxas_log"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: kernel name → source file under csrc/
SOURCES = {"nfa_walk": "nfa_walk.cu", "nfa_join_walk": "nfa_join_walk.cu",
           "dense_walk": "dense_walk.cu", "bitmap_fanout": "bitmap_fanout.cu",
           "ep_route": "ep_route.cu"}

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources(name: str) -> List[str]:
    """The source of kernel ``name`` and every ``csrc/`` file it
    includes with ``#include "..."``, directly or through another."""
    seen: List[str] = []
    todo = [SOURCES[name]]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.append(f)
        text = (CSRC / f).read_text()
        todo.extend(m for m in _INCLUDE.findall(text)
                    if (CSRC / m).is_file())
    return seen


def _lib_path(name: str) -> Path:
    """The library of kernel ``name``: its name carries a digest of the
    flags and of every file the source is built from, headers included,
    so an edit of any of them builds a new library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(_sources(name)):
        h.update(f.encode() + b"\0" + (CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` process per source, started together.  Returns the seconds
    each build took (0.0 for one that was already built).  Raises
    RuntimeError with the compiler's output when a build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    took = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            took[name] = 0.0
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        _ptxas_path(out).write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def _ptxas_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def ptxas_log(name: str) -> str:
    """The compiler's output of the current build of ``name`` (register
    and spill counts from ``-Xptxas -v``), kept beside its library; ''
    if it is not built."""
    path = _ptxas_path(_lib_path(name))
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib
