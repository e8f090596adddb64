"""The port's own copy of the reference's ``emqx_tpu/observe/alarm.py``, so
that nothing here imports the JAX package.

Active alarm table + deactivation history — the ``emqx_alarm`` analog.

Behavioral reference: ``apps/emqx/src/emqx_alarm.erl`` [U] (SURVEY.md
§2.1): ``activate/2`` is idempotent per name, ``deactivate/1`` moves the
alarm to a size-bounded history, and both transitions publish to
``$SYS/brokers/<node>/alarms/{activate,deactivate}`` (wired by SysBroker
via the ``on_change`` callback).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Alarm", "Alarms"]


@dataclass
class Alarm:
    name: str
    details: Dict[str, Any] = field(default_factory=dict)
    message: str = ""
    activate_at: float = field(default_factory=time.time)
    deactivate_at: Optional[float] = None

    @property
    def activated(self) -> bool:
        return self.deactivate_at is None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "details": self.details,
            "message": self.message, "activate_at": self.activate_at,
            "deactivate_at": self.deactivate_at, "activated": self.activated,
        }


class Alarms:
    def __init__(self, history_size: int = 1000) -> None:
        self.active: Dict[str, Alarm] = {}
        self.history: List[Alarm] = []
        self.history_size = history_size
        # on_change('activate'|'deactivate', alarm) — SysBroker publishes
        self.on_change: Optional[Callable[[str, Alarm], None]] = None

    def activate(
        self, name: str, details: Optional[Dict[str, Any]] = None,
        message: str = "",
    ) -> bool:
        """Returns False if already active (idempotent, like the ref)."""
        if name in self.active:
            return False
        alarm = Alarm(name, details or {}, message or name)
        self.active[name] = alarm
        if self.on_change:
            self.on_change("activate", alarm)
        return True

    def deactivate(self, name: str) -> bool:
        alarm = self.active.pop(name, None)
        if alarm is None:
            return False
        alarm.deactivate_at = time.time()
        self.history.append(alarm)
        if len(self.history) > self.history_size:
            del self.history[: len(self.history) - self.history_size]
        if self.on_change:
            self.on_change("deactivate", alarm)
        return True

    def is_active(self, name: str) -> bool:
        return name in self.active

    def list(self, activated: Optional[bool] = None) -> List[Alarm]:
        if activated is True:
            return list(self.active.values())
        if activated is False:
            return list(self.history)
        return list(self.active.values()) + list(self.history)
