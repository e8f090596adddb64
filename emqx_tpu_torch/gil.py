"""Yield points for long host work on a thread beside the event loop.

A thread that runs a long series of short calls holding the interpreter
lock (string joins, numpy over object arrays) makes the event loop wait
up to a switch interval (5 ms) each time the loop lets the lock go: at
every ctypes or torch call and every poll of its selector.  A loop
round of many such calls then stretches by tens of milliseconds per
piece of the other thread's work (the convoy effect).  A thread that
sleeps between its pieces hands the lock over at once, so the loop
waits at most one piece.  Code that works in pieces calls
:func:`yield_lock` after each; it sleeps only inside :func:`yielding`
on the calling thread, so the same code run on the loop (a bootstrap)
never sleeps.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterator

__all__ = ["PAUSE_S", "PIECE", "yield_lock", "yielding"]

#: items handled between two yield points (a join of 4096 filters holds
#: the lock for well under a millisecond)
PIECE = 4096
#: the sleep at each yield point of a thread inside :func:`yielding`
PAUSE_S = 0.0002

_local = threading.local()


@contextmanager
def yielding() -> Iterator[None]:
    """Make :func:`yield_lock` sleep on this thread while inside."""
    prev = getattr(_local, "on", False)
    _local.on = True
    try:
        yield
    finally:
        _local.on = prev


def yield_lock() -> None:
    """Sleep ``PAUSE_S`` when this thread is inside :func:`yielding`."""
    if getattr(_local, "on", False):
        time.sleep(PAUSE_S)
