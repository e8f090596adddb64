"""The port's own copy of the reference's ``emqx_tpu/broker/limiter.py``, so
that nothing here imports the JAX package.

Token-bucket rate limiters.

Behavioral reference: the esockd/``emqx_limiter`` token buckets [U]
(SURVEY.md §2.1): per-listener connection rate, per-connection message
and byte rates.  ``consume`` is non-blocking (returns whether the tokens
were granted plus the wait needed) — the asyncio connection layer sleeps
the returned interval, mirroring the reference's pause/resume of the
receive loop.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

__all__ = ["TokenBucket", "LimiterGroup"]


class TokenBucket:
    """rate tokens/second, bursting to ``burst`` (defaults to rate)."""

    __slots__ = ("rate", "burst", "_tokens", "_last")

    def __init__(self, rate: float, burst: Optional[float] = None) -> None:
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(rate, 1.0))
        self._tokens = self.burst
        self._last: Optional[float] = None

    @property
    def unlimited(self) -> bool:
        return self.rate <= 0

    def _refill(self, now: float) -> None:
        if self._last is None:
            self._last = now
            return
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
        self._last = now

    def consume(self, n: float = 1.0, now: Optional[float] = None) -> Tuple[bool, float]:
        """Try to take ``n`` tokens.  Returns (granted, wait_seconds) —
        wait_seconds > 0 tells the caller how long to pause before retry."""
        if self.unlimited:
            return True, 0.0
        now = now if now is not None else time.time()
        self._refill(now)
        if self._tokens >= n:
            self._tokens -= n
            return True, 0.0
        deficit = n - self._tokens
        return False, deficit / self.rate

    def tokens(self, now: Optional[float] = None) -> float:
        if self.unlimited:
            return float("inf")
        self._refill(now if now is not None else time.time())
        return self._tokens

    def retune(self, rate: float, burst: Optional[float] = None) -> None:
        """Re-rate this bucket IN PLACE (admission throttle / restore):
        call sites hold direct references to the bucket object, so a
        swap would silently detach them.  Coming from unlimited the
        bucket starts full (a fresh bucket's semantics); tightening a
        limited one clamps, so the throttle bites on the next consume."""
        was_unlimited = self.unlimited
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(rate, 1.0))
        self._tokens = self.burst if was_unlimited \
            else min(self._tokens, self.burst)


class LimiterGroup:
    """The three reference limiter dimensions, from config keys
    ``limiter.max_conn_rate`` / ``max_messages_rate`` / ``max_bytes_rate``
    (0 = unlimited)."""

    def __init__(
        self,
        max_conn_rate: float = 0.0,
        max_messages_rate: float = 0.0,
        max_bytes_rate: float = 0.0,
    ) -> None:
        self.conn = TokenBucket(max_conn_rate)
        self._msg_rate = max_messages_rate
        self._bytes_rate = max_bytes_rate
        self._per_conn: Dict[str, Tuple[TokenBucket, TokenBucket]] = {}

    def reconfigure(
        self,
        max_conn_rate: Optional[float] = None,
        max_messages_rate: Optional[float] = None,
        max_bytes_rate: Optional[float] = None,
    ) -> None:
        """Hot update (emqx_config_handler): new connections pick up the
        new per-conn rates; the shared connect-rate bucket swaps now."""
        if max_conn_rate is not None:
            self.conn = TokenBucket(max_conn_rate)
        if max_messages_rate is not None:
            self._msg_rate = max_messages_rate
        if max_bytes_rate is not None:
            self._bytes_rate = max_bytes_rate

    def allow_connect(self, now: Optional[float] = None) -> Tuple[bool, float]:
        return self.conn.consume(1.0, now)

    def conn_buckets(self, connid: str) -> Tuple[TokenBucket, TokenBucket]:
        """(messages, bytes) buckets for one connection."""
        b = self._per_conn.get(connid)
        if b is None:
            b = self._per_conn[connid] = (
                TokenBucket(self._msg_rate), TokenBucket(self._bytes_rate)
            )
        return b

    def drop_conn(self, connid: str) -> None:
        self._per_conn.pop(connid, None)

    def tracked(self) -> int:
        return len(self._per_conn)

    def sweep_idle(self, idle_s: float, now: Optional[float] = None) -> int:
        """Evict bucket pairs idle past ``idle_s`` (per-client-state
        growth audit: every close path calls drop_conn, but a handler
        that dies between accept and close would leak its pair forever;
        this is the belt-and-braces bound).  A live-but-idle connection
        whose entry is evicted just gets a fresh pair on its next
        allow_publish — unlimited buckets identically, limited ones
        with a reset burst, both harmless."""
        now = now if now is not None else time.time()
        stale = [
            cid for cid, (msgs, byts) in self._per_conn.items()
            if (msgs._last or 0.0) < now - idle_s
            and (byts._last or 0.0) < now - idle_s
        ]
        for cid in stale:
            del self._per_conn[cid]
        return len(stale)

    def allow_publish(
        self, connid: str, nbytes: int, now: Optional[float] = None
    ) -> Tuple[bool, float]:
        # all-or-nothing: a deny by either dimension must not drain the
        # other bucket, or retry loops starve the connection
        msgs, byts = self.conn_buckets(connid)
        if msgs.tokens(now) < 1.0:
            return False, (1.0 - msgs.tokens(now)) / msgs.rate
        if byts.tokens(now) < float(nbytes):
            return False, (float(nbytes) - byts.tokens(now)) / byts.rate
        msgs.consume(1.0, now)
        byts.consume(float(nbytes), now)
        return True, 0.0
