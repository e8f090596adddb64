"""Global ordered hook registry — the extension bus.

The port's own copy of the reference's ``emqx_tpu/broker/hooks.py``, so
that nothing here imports the JAX package.

Behavioral reference: ``apps/emqx/src/emqx_hooks.erl`` [U] (SURVEY.md
§2.1, L6): named hook points with priority-ordered callback chains and
two run modes:

* :meth:`Hooks.run` — chain of ``fn(*args) -> HookResult``; ``STOP``
  short-circuits the chain (e.g. an authz deny).
* :meth:`Hooks.run_fold` — additionally threads an accumulator (e.g. the
  message being mutated by ``'message.publish'`` handlers).

Callbacks return:

* ``None`` / ``OK``            — continue, accumulator unchanged
* ``(OK, acc')``               — continue with new accumulator
* ``STOP``                     — stop, accumulator unchanged
* ``(STOP, acc')``             — stop with new accumulator

Higher priority runs first (emqx orders by priority then insertion seq).
The standard hook-point names (``'client.connect'``,
``'message.publish'``, ...) are listed in :data:`HOOK_POINTS` to mirror
the reference's ~25 points.
"""

from __future__ import annotations

import bisect
import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["OK", "STOP", "Hooks", "HOOK_POINTS"]

OK = "ok"
STOP = "stop"

HOOK_POINTS = [
    "client.connect", "client.connack", "client.connected",
    "client.disconnected", "client.authenticate", "client.authorize",
    "client.enhanced_authenticate", "client.enhanced_authenticated",
    "client.subscribe", "client.unsubscribe",
    "session.created", "session.subscribed", "session.unsubscribed",
    "session.resumed", "session.discarded", "session.takenover",
    "session.terminated",
    "message.publish", "message.delivered", "message.acked",
    "message.dropped",
    "delivery.dropped", "delivery.completed",
]


class _Callback:
    __slots__ = ("priority", "seq", "fn", "name")

    def __init__(self, priority: int, seq: int, fn: Callable, name: str):
        self.priority = priority
        self.seq = seq
        self.fn = fn
        self.name = name

    def sort_key(self):
        # higher priority first; ties broken by insertion order
        return (-self.priority, self.seq)


class Hooks:
    def __init__(self) -> None:
        self._points: Dict[str, List[_Callback]] = {}
        self._seq = itertools.count()

    def add(
        self,
        point: str,
        fn: Callable,
        priority: int = 0,
        name: Optional[str] = None,
    ) -> None:
        # copy-on-write: mutations install a NEW list, so run()/run_fold()
        # iterate the chain they started with without a per-call copy —
        # the delivered/dropped hooks fire once per fan-out leg, and the
        # defensive list() showed up in wide-fanout profiles
        cbs = list(self._points.get(point, ()))
        cb = _Callback(priority, next(self._seq), fn, name or getattr(fn, "__name__", "fn"))
        keys = [c.sort_key() for c in cbs]
        cbs.insert(bisect.bisect_right(keys, cb.sort_key()), cb)
        self._points[point] = cbs

    def delete(self, point: str, fn_or_name) -> bool:
        cbs = self._points.get(point, [])
        for i, cb in enumerate(cbs):
            if cb.fn is fn_or_name or cb.name == fn_or_name:
                self._points[point] = cbs[:i] + cbs[i + 1:]
                return True
        return False

    def callbacks(self, point: str) -> List[str]:
        return [cb.name for cb in self._points.get(point, [])]

    def has(self, point: str) -> bool:
        """True iff any callback is registered — lets per-item hot loops
        skip the dispatch (and its args tuple) entirely when idle."""
        return bool(self._points.get(point))

    # ------------------------------------------------------------------

    def run(self, point: str, args: Tuple = ()) -> str:
        """Run the chain; returns OK or STOP (whichever ended it)."""
        cbs = self._points.get(point)
        if not cbs:
            return OK          # empty chains are the hot-path common case
        for cb in cbs:         # safe: mutations replace the list (CoW)
            res = cb.fn(*args)
            if res is None:
                continue
            verdict, _ = _normalize(res, None)
            if verdict == STOP:
                return STOP
        return OK

    def run_fold(self, point: str, args: Tuple, acc: Any) -> Any:
        """Run the chain threading ``acc``; returns the final accumulator."""
        cbs = self._points.get(point)
        if not cbs:
            return acc
        for cb in cbs:         # safe: mutations replace the list (CoW)
            res = cb.fn(*args, acc)
            if res is None:
                continue
            verdict, acc = _normalize(res, acc)
            if verdict == STOP:
                break
        return acc


def _normalize(res: Any, acc: Any) -> Tuple[str, Any]:
    if res is None or res == OK:
        return OK, acc
    if res == STOP:
        return STOP, acc
    if isinstance(res, tuple) and len(res) == 2 and res[0] in (OK, STOP):
        return res[0], res[1]
    # bare return value = new accumulator, continue (convenience)
    return OK, res
