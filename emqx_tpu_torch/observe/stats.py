"""The port's own copy of the reference's ``emqx_tpu/observe/stats.py``, so
that nothing here imports the JAX package.

Gauges with high-water marks — the ``emqx_stats`` analog.

Behavioral reference: ``apps/emqx/src/emqx_stats.erl`` [U] (SURVEY.md
§5.5): ``setstat/2`` for gauges, with paired ``<name>.max`` watermarks
updated monotonically.  Names kept 1:1.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

__all__ = ["Stats", "STAT_NAMES"]

# gauge -> paired max watermark (None = no watermark in the reference)
STAT_NAMES: Dict[str, Optional[str]] = {
    "connections.count": "connections.max",
    "live_connections.count": "live_connections.max",
    "sessions.count": "sessions.max",
    "topics.count": "topics.max",
    "suboptions.count": "suboptions.max",
    "subscribers.count": "subscribers.max",
    "subscriptions.count": "subscriptions.max",
    "subscriptions.shared.count": "subscriptions.shared.max",
    "retained.count": "retained.max",
    "delayed.count": "delayed.max",
}


class Stats:
    def __init__(self) -> None:
        self._g: Dict[str, int] = {}
        for name, mx in STAT_NAMES.items():
            self._g[name] = 0
            if mx:
                self._g[mx] = 0
        # pull-based providers: gauge name -> () -> value, polled at read
        self._providers: Dict[str, Callable[[], int]] = {}

    def setstat(self, name: str, value: int) -> None:
        self._g[name] = value
        mx = STAT_NAMES.get(name)
        if mx and value > self._g.get(mx, 0):
            self._g[mx] = value

    def provide(self, name: str, fn: Callable[[], int]) -> None:
        """Register a pull provider (e.g. routes.count from the Router)."""
        self._providers[name] = fn

    def get(self, name: str) -> int:
        if name in self._providers:
            v = int(self._providers[name]())
            self.setstat(name, v) if name in STAT_NAMES else None
            return v
        return self._g.get(name, 0)

    def all(self) -> Dict[str, int]:
        for name, fn in self._providers.items():
            v = int(fn())
            if name in STAT_NAMES:
                self.setstat(name, v)  # persists the .max watermark too
            else:
                self._g[name] = v
        return dict(self._g)
