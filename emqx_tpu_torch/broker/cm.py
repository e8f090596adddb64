"""The port's own copy of the reference's ``emqx_tpu/broker/cm.py``, so
that nothing here imports the JAX package.

Connection manager: clientid registry + session takeover protocol.

Behavioral reference: ``apps/emqx/src/emqx_cm.erl``, ``emqx_cm_registry``,
``emqx_cm_locker`` [U] (SURVEY.md §2.1, §3.2):

* one live channel per clientid; a new CONNECT with the same clientid
  either **discards** (clean_start) or **takes over** (resume) the old
  session, and the old channel is told to close with
  ``SESSION_TAKEN_OVER``;
* per-clientid critical section (the locker) — single-threaded here, but
  the API shape (``open_session`` returning the displaced channel) is
  what the cluster layer serializes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from .broker import Broker
from .session import Session

__all__ = ["ConnectionManager"]


class ConnectionManager:
    def __init__(self, broker: Broker) -> None:
        self.broker = broker
        self._channels: Dict[str, Any] = {}  # clientid -> channel handle

    def open_session(
        self, clientid: str, clean_start: bool, channel: Any, **session_kw
    ) -> Tuple[Session, bool, Optional[Any]]:
        """Returns (session, session_present, displaced_channel)."""
        old_chan = self._channels.get(clientid)
        if old_chan is not None and not clean_start:
            # clean_start discards instead — broker fires session.discarded;
            # takeover and discard are mutually exclusive outcomes
            self.broker.hooks.run("session.takenover", (clientid,))
        sess, present = self.broker.open_session(
            clientid, clean_start=clean_start, **session_kw
        )
        self._channels[clientid] = channel
        return sess, present, old_chan

    def register_channel(self, clientid: str, channel: Any) -> None:
        self._channels[clientid] = channel

    def unregister_channel(self, clientid: str, channel: Any) -> None:
        """Only the owning channel may unregister (a displaced channel
        closing late must not evict its successor)."""
        if self._channels.get(clientid) is channel:
            del self._channels[clientid]

    def lookup_channel(self, clientid: str) -> Optional[Any]:
        return self._channels.get(clientid)

    def kick(self, clientid: str) -> Optional[Any]:
        """Forcibly displace a client (mgmt API / banned)."""
        chan = self._channels.pop(clientid, None)
        self.broker.close_session(clientid, discard=True)
        return chan

    def connection_count(self) -> int:
        """Live (currently connected) channels only."""
        return len(self._channels)

    def total_connection_count(self) -> int:
        """Live channels plus disconnected persistent sessions — the
        reference's ``connections.count`` includes sessions whose
        transport dropped but whose state is retained, while
        ``live_connections.count`` is connected-only."""
        ids = set(self._channels)
        ids.update(self.broker.sessions)
        return len(ids)

    def all_clientids(self):
        return list(self._channels)
