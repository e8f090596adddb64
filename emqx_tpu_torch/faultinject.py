"""Deterministic fault injection at the serve path's seams.

The port's own copy of the reference's ``emqx_tpu/faultinject.py``,
limited to the injection points that the port's modules call.  Rule
schedules count *passes* through a named point (no wall clock),
probabilistic rules draw from one seeded ``random.Random``, and delays
go through an injectable async sleep, so a scenario fires the same way
on every run.

Zero-cost when disabled: the module-level ``_injector`` is ``None``
until :func:`install` is called, and every call site guards with::

    from .. import faultinject as _fi
    ...
    if _fi._injector is not None:        # one attr load + identity test
        ...

Named injection points:

==================  =====================================================
``transport.write``  MqttProtocol's socket write of a delivery or a
                     coalesced flush (drop: the bytes are lost; dup:
                     written twice; raise)
``frame.parse``      Parser.feed, per read (raise: a ``FrameError``, the
                     malformed-packet path)
``match.dispatch``   MatchService device dispatch and the breaker's
                     recovery probe (raise / delay / hang; in deadline
                     mode a hang is rescued by the per-dispatch timeout)
``match.compile``    MatchService warm step: kernel builds and the first
                     walks before ``ready`` (raise / delay)
``match.readback``   MatchService d2h readback boundary (raise / delay /
                     hang; a hang parks until the waiters' prefetch
                     timeout, or in deadline mode the per-dispatch one)
``match.shard``      MultichipMatcher dispatch gate (raise: the batch
                     fails over to the host like a dead shard; delay)
``table.load``       MatchService segment cold-start load (raise: treated
                     like a corrupt segment, the full rebuild serves)
``table.swap``       MatchService compacted-table swap, fired before any
                     state mutates (raise: the ``table.compact`` child
                     dies mid-swap as a no-op; the next cycle compacts
                     again)
``fanout.drain``     FanoutPipeline drain loop, before a batch pops
                     (raise: the drain task dies with nothing popped;
                     delay)
``inflight.insert``  Inflight.insert / insert_many (raise)
``inflight.retry``   Inflight.older_than retry scan (raise)
``exhook.call``      ExHookManager advisory gRPC call (raise: the
                     server's failure_action path; delay)
``ep.route``         MultichipMatcher routed front end (raise: the
                     routed dispatch is refused; delay)
``mesh.rebuild``     MultichipMatcher.rebuild_shard (raise: the
                     supervised rebuild child restarts; delay)
``ep.rebalance``     MultichipMatcher.plan_rebalance, before anything is
                     staged (raise: the pass is a no-op; delay)
==================  =====================================================

Rule fields: ``point`` (required), ``action`` (``raise`` | ``drop`` |
``delay`` | ``dup`` | ``hang``), ``skip`` (eligible passes let through
before the first fire, default 0), ``every`` (fire each Nth eligible
pass, default 1), ``times`` (max fires; default 1, ``0``/``None`` =
unlimited), ``prob`` (fire probability, seeded RNG), ``delay_s`` (used
by ``delay``).  Call sites interpret only the actions that make sense at
their seam; ``raise`` raises :class:`InjectedFault`.
"""

from __future__ import annotations

import asyncio
import random
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "FaultInjector", "InjectedFault", "POINTS",
    "install", "uninstall", "get",
]

POINTS = ("transport.write", "frame.parse", "match.dispatch",
          "match.compile", "match.readback", "match.shard", "table.load",
          "table.swap", "fanout.drain", "inflight.insert",
          "inflight.retry", "exhook.call", "ep.route", "mesh.rebuild",
          "ep.rebalance")

_ACTIONS = ("raise", "drop", "delay", "dup", "hang")


class InjectedFault(Exception):
    """Raised at an injection point by a ``raise`` rule."""


class _Rule:
    __slots__ = ("point", "action", "skip", "every", "times", "prob",
                 "delay_s", "passes", "fired")

    def __init__(self, spec: Dict[str, Any]) -> None:
        self.point = spec["point"]
        self.action = spec["action"]
        if self.point not in POINTS:
            raise ValueError(f"unknown injection point {self.point!r}")
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown action {self.action!r}")
        self.skip = int(spec.get("skip", 0))
        self.every = max(1, int(spec.get("every", 1)))
        t = spec.get("times", 1)
        self.times: Optional[int] = None if t in (None, 0) else int(t)
        self.prob: Optional[float] = spec.get("prob")
        self.delay_s = float(spec.get("delay_s", 0.0))
        self.passes = 0
        self.fired = 0


class FaultInjector:
    """One scenario table; single-threaded (event-loop) use assumed."""

    def __init__(
        self,
        rules: List[Dict[str, Any]],
        seed: int = 0,
        sleep: Optional[Callable[[float], Any]] = None,
    ) -> None:
        self._rules: Dict[str, List[_Rule]] = {}
        for spec in rules:
            r = _Rule(spec)
            self._rules.setdefault(r.point, []).append(r)
        self._rng = random.Random(seed)
        self._sleep = sleep if sleep is not None else asyncio.sleep
        self._last_delay = 0.0
        self.fired: Dict[str, int] = {}

    def act(self, point: str) -> Optional[str]:
        """One pass through ``point``: returns the triggered action or
        ``None``.  Counts the pass on every rule for the point (so
        ``skip``/``every`` schedules stay aligned across rules)."""
        rules = self._rules.get(point)
        if not rules:
            return None
        hit: Optional[_Rule] = None
        for r in rules:
            if r.times is not None and r.fired >= r.times:
                continue
            r.passes += 1
            if hit is not None:
                continue  # keep counting passes; first trigger wins
            if r.passes <= r.skip:
                continue
            if (r.passes - r.skip - 1) % r.every:
                continue
            if r.prob is not None and self._rng.random() >= r.prob:
                continue
            hit = r
        if hit is None:
            return None
        hit.fired += 1
        self.fired[point] = self.fired.get(point, 0) + 1
        self._last_delay = hit.delay_s
        return hit.action

    def check(self, point: str) -> Optional[str]:
        """Like :meth:`act` but raises :class:`InjectedFault` for a
        ``raise`` action — the one-liner for raise-only seams."""
        action = self.act(point)
        if action == "raise":
            raise InjectedFault(point)
        return action

    async def pause(self) -> None:
        """Serve the most recent ``delay`` action (async seams only)."""
        await self._sleep(self._last_delay)

    async def hang(self) -> None:
        """Serve a ``hang`` action: never returns on its own — the seam's
        own timeout or cancellation must rescue the caller."""
        await asyncio.Event().wait()

    @property
    def last_delay(self) -> float:
        """Most recent ``delay`` rule's delay_s (sync seams sleep this
        themselves — ``pause`` needs a running loop)."""
        return self._last_delay

    def info(self) -> Dict[str, Any]:
        return {
            "fired": dict(self.fired),
            "rules": [
                {"point": r.point, "action": r.action,
                 "passes": r.passes, "fired": r.fired}
                for rs in self._rules.values() for r in rs
            ],
        }


#: process-global injector; ``None`` (the default) keeps every seam at
#: literally zero function-call overhead
_injector: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> FaultInjector:
    global _injector
    _injector = injector
    return injector


def uninstall() -> None:
    global _injector
    _injector = None


def get() -> Optional[FaultInjector]:
    return _injector
