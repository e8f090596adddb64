"""The port's own copy of the reference's ``emqx_tpu/supervise.py``, so
that nothing here imports the JAX package.

Supervision tree for long-lived background tasks — the ``emqx_sup``
analog.

Behavioral reference: ``emqx_sup.erl`` / OTP supervisor semantics [U]
(SURVEY.md §2.1): every long-lived process sits under a supervisor with
a per-child restart policy, exponential backoff, and a restart-intensity
window.  Before this module, the broker's delivery stack ran on ad-hoc
``asyncio.create_task`` loops — a crashed fanout drain, cluster sync or
bridge worker silently stopped delivering until node restart.

Differences from OTP, deliberate:

* **escalation degrades, never dies**: exceeding the restart-intensity
  window does NOT kill the supervisor (there is no parent to restart
  *us*); the child enters *degraded* mode — an :class:`Alarms` alarm
  activates, ``broker.supervisor.degraded`` reflects the degraded-child
  count, and restarts continue at the maximum backoff so an external
  fix (network back, config change) still heals the node without a
  restart;
* **determinism is injectable**: the clock, the sleep primitive and the
  jitter RNG are constructor parameters, so tests drive backoff and
  intensity windows with a fake clock and a seeded RNG — no wall-clock
  flakiness;
* **shutdown is reverse-registration-order**: children register in
  dependency order (boot order) and stop in reverse, matching the
  reference's ``emqx_app`` stop discipline; a child may carry a
  ``drain`` callback that runs after its task is down (the fanout
  pipeline re-publishes its un-drained queue there, preserving the
  "accepted publishes never drop" guarantee across supervised
  shutdown).

Restart policies (OTP names):

* ``permanent`` — always restarted (crash, kill, or normal return);
* ``transient`` — restarted only on abnormal exit (exception or an
  externally cancelled run); a clean return ends supervision;
* ``temporary`` — never restarted.

A :class:`Child` handle mimics enough of the ``asyncio.Task`` surface
(``cancel()`` / ``done()`` / ``await``) that converted call sites treat
it exactly like the raw task they used to hold; ``kill()`` is the chaos
surface — it cancels only the *current run*, which the supervisor then
restarts.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

log = logging.getLogger(__name__)

__all__ = ["Supervisor", "Child", "PERMANENT", "TRANSIENT", "TEMPORARY"]

PERMANENT = "permanent"
TRANSIENT = "transient"
TEMPORARY = "temporary"


class Child:
    """One supervised task: a factory (callable returning a coroutine)
    plus its restart policy and backoff parameters."""

    def __init__(
        self,
        sup: "Supervisor",
        name: str,
        factory: Callable[[], Any],
        restart: str,
        backoff_base: float,
        backoff_max: float,
        reset_after: float,
        drain: Optional[Callable[[], Any]] = None,
    ) -> None:
        self.sup = sup
        self.name = name
        self.factory = factory
        self.restart = restart
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.reset_after = reset_after
        self.drain = drain
        self.task: Optional[asyncio.Task] = None     # current run
        self.runner: Optional[asyncio.Task] = None   # supervision wrapper
        self.restarts = 0
        self.degraded = False
        self.stopping = False
        self.state = "starting"  # running|backoff|degraded|done|stopped
        self._restart_times: Deque[float] = deque()

    # -- task-like surface (drop-in for converted call sites) ----------

    def cancel(self) -> None:
        """Stop supervising AND cancel the current run (no restart)."""
        self.stopping = True
        if self.runner is not None and not self.runner.done():
            self.runner.cancel()

    def done(self) -> bool:
        return self.runner is None or self.runner.done()

    def __await__(self):
        return self.runner.__await__()

    # -- supervision surface -------------------------------------------

    def kill(self) -> bool:
        """Chaos/fault surface: cancel the CURRENT run only.  The
        supervisor treats it as an abnormal exit and restarts per
        policy.  Returns False when no run is active to kill."""
        t = self.task
        if t is not None and not t.done():
            t.cancel()
            return True
        return False

    async def stop(self) -> None:
        """Graceful stop: cancel, await the wrapper, then run ``drain``."""
        await self.sup._stop_child(self)

    def alive(self) -> bool:
        return self.task is not None and not self.task.done()

    def info(self) -> Dict[str, Any]:
        return {
            "name": self.name, "restart": self.restart,
            "state": self.state, "restarts": self.restarts,
            "degraded": self.degraded,
        }


class Supervisor:
    """Owns the background tasks of one node (see module docstring)."""

    def __init__(
        self,
        metrics: Any = None,
        alarms: Any = None,
        *,
        max_restarts: int = 5,
        window_s: float = 10.0,
        backoff_base: float = 0.05,
        backoff_max: float = 5.0,
        jitter: float = 0.1,
        seed: Optional[int] = None,
        clock: Optional[Callable[[], float]] = None,
        sleep: Optional[Callable[[float], Any]] = None,
    ) -> None:
        self.metrics = metrics
        self.alarms = alarms
        # always-on flight recorder (observe/flightrec.py): set by the
        # node; a degraded-mode escalation dumps the last few hundred
        # batch events so the forensics survive the restart storm
        self.flightrec = None
        self.max_restarts = max_restarts
        self.window_s = window_s
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.jitter = jitter
        self._rng = random.Random(seed)
        self._clock = clock if clock is not None else time.monotonic
        self._sleep = sleep if sleep is not None else asyncio.sleep
        self.children: List[Child] = []
        self.restarts = 0          # lifetime total across children
        self._stopping = False

    # ------------------------------------------------------------------

    def start_child(
        self,
        name: str,
        factory: Callable[[], Any],
        restart: str = PERMANENT,
        *,
        backoff_base: Optional[float] = None,
        backoff_max: Optional[float] = None,
        reset_after: Optional[float] = None,
        drain: Optional[Callable[[], Any]] = None,
    ) -> Child:
        if restart not in (PERMANENT, TRANSIENT, TEMPORARY):
            raise ValueError(f"unknown restart policy {restart!r}")
        # reap finished same-name children: transient loops that end and
        # re-register per activity cycle (quic.timer) must not grow the
        # child table across cycles
        self.children = [
            c for c in self.children
            if not (c.name == name and c.done())
        ]
        child = Child(
            self, name, factory, restart,
            backoff_base if backoff_base is not None else self.backoff_base,
            backoff_max if backoff_max is not None else self.backoff_max,
            reset_after if reset_after is not None else self.window_s,
            drain=drain,
        )
        child.runner = asyncio.ensure_future(self._supervise(child))
        self.children.append(child)
        return child

    def lookup(self, name: str) -> Optional[Child]:
        """Latest child registered under ``name`` (chaos tooling)."""
        for child in reversed(self.children):
            if child.name == name:
                return child
        return None

    async def stop(self) -> None:
        """Stop every child, reverse registration (dependency) order."""
        self._stopping = True
        try:
            for child in reversed(list(self.children)):
                await self._stop_child(child)
            self.children.clear()
        finally:
            self._stopping = False

    async def _stop_child(self, child: Child) -> None:
        child.stopping = True
        runner = child.runner
        if runner is not None:
            if not runner.done():
                runner.cancel()
            try:
                await runner
            except (asyncio.CancelledError, Exception):
                log.debug("supervised child %r runner exit", child.name,
                          exc_info=True)
        child.state = "stopped"
        if child.degraded:
            self._clear_degraded(child)
        if child.drain is not None:
            try:
                r = child.drain()
                if asyncio.iscoroutine(r):
                    await r
            except Exception:
                log.exception("supervised child %r drain failed", child.name)

    # ------------------------------------------------------------------

    async def _supervise(self, child: Child) -> None:
        backoff_n = 0
        while True:
            started = self._clock()
            child.state = "running"
            inner: Optional[asyncio.Task] = None
            try:
                inner = asyncio.ensure_future(child.factory())
            except Exception:
                log.exception("supervised child %r factory failed",
                              child.name)
            if inner is not None:
                child.task = inner
                try:
                    # wait() shields: an inner crash/kill completes the
                    # wait; only OUR cancellation (stop) raises here
                    await asyncio.wait([inner])
                except asyncio.CancelledError:
                    inner.cancel()
                    try:
                        await inner
                    except BaseException:
                        log.debug("supervised child %r run exit on stop",
                                  child.name, exc_info=True)
                    child.task = None
                    raise
                child.task = None
                if inner.cancelled():
                    kind = "killed"
                    log.warning("supervised child %r was cancelled "
                                "externally", child.name)
                else:
                    exc = inner.exception()
                    if exc is None:
                        kind = "normal"
                    else:
                        kind = "error"
                        log.error("supervised child %r crashed",
                                  child.name, exc_info=exc)
            else:
                kind = "error"
            now = self._clock()
            if now - started >= child.reset_after:
                # ran long enough: the failure is fresh, not a loop
                backoff_n = 0
                if child.degraded:
                    self._clear_degraded(child)
            if kind == "normal" and child.restart != PERMANENT:
                child.state = "done"
                return
            if child.restart == TEMPORARY:
                child.state = "done"
                return
            self._note_restart(child, now)
            delay = (child.backoff_max if child.degraded
                     else min(child.backoff_max,
                              child.backoff_base * (2 ** backoff_n)))
            backoff_n += 1
            delay *= 1.0 + self.jitter * self._rng.random()
            child.state = "degraded" if child.degraded else "backoff"
            await self._sleep(delay)

    def _note_restart(self, child: Child, now: float) -> None:
        child.restarts += 1
        self.restarts += 1
        if self.metrics is not None:
            self.metrics.inc("broker.supervisor.restarts")
        rt = child._restart_times
        rt.append(now)
        while rt and now - rt[0] > self.window_s:
            rt.popleft()
        if len(rt) > self.max_restarts and not child.degraded:
            self._degrade(child)

    def _degrade(self, child: Child) -> None:
        child.degraded = True
        log.error(
            "supervised child %r exceeded restart intensity (%d in %.1fs); "
            "degraded mode — restarting at max backoff",
            child.name, len(child._restart_times), self.window_s,
        )
        if self.alarms is not None:
            self.alarms.activate(
                f"supervisor_degraded:{child.name}",
                {"child": child.name, "restarts": child.restarts},
                f"supervised child {child.name} restarting too fast",
            )
        if self.flightrec is not None:
            self.flightrec.dump("supervisor_degraded", note=child.name)
        self._sync_degraded_metric()

    def _clear_degraded(self, child: Child) -> None:
        child.degraded = False
        child._restart_times.clear()
        if self.alarms is not None:
            self.alarms.deactivate(f"supervisor_degraded:{child.name}")
        self._sync_degraded_metric()

    def _sync_degraded_metric(self) -> None:
        if self.metrics is not None:
            self.metrics.set(
                "broker.supervisor.degraded",
                sum(1 for c in self.children if c.degraded),
            )

    @property
    def degraded(self) -> bool:
        """Node-level degraded-mode flag: any child over intensity."""
        return any(c.degraded for c in self.children)

    def info(self) -> Dict[str, Any]:
        return {
            "children": [c.info() for c in self.children],
            "restarts": self.restarts,
            "degraded": self.degraded,
        }
