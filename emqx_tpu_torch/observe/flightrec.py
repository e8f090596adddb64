"""The port's own copy of the reference's ``emqx_tpu/observe/flightrec.py``, so
that nothing here imports the JAX package.

Always-on flight recorder: per-plane event rings + Perfetto dumps.

When the breaker trips or the brownout ladder escalates, a counter
tells you *that* it happened; what operators need is *what the last few
hundred batches were doing* when it happened.  This module keeps that
history for free:

* every plane (the main loop's fanout stages, the match encode worker,
  the match readback child, ...) writes stage events into its own
  preallocated **ring buffer** (:class:`Ring`, default depth 4096,
  ``obs.flightrec.depth``) — an event is a packed
  ``(stage id, start ns, duration ns, batch size, slot gen)`` tuple
  slot-assigned into the ring, single writer per ring, no locks, no
  growth;
* on a trigger — breaker trip, brownout escalation,
  ``supervisor_degraded``, or the mgmt REST/CLI manual trigger — the
  recorder **snapshots every ring without pausing writers** and writes
  a Chrome trace-event JSON file (``trace/flightrec-<reason>-<ts>.json``
  in the TraceManager dir) that opens directly in Perfetto
  (https://ui.perfetto.dev): one named track per plane, one duration
  slice per event, batch size + slot gen in the args;
* the write is **atomic** (temp file + ``os.replace`` in the same
  directory): a kill mid-dump leaves the previous state on disk and no
  torn file — asserted in tests/test_chaos_delivery.py;
* dump failures are contained: :meth:`FlightRecorder.dump` logs and
  returns ``None`` — a trigger site (the breaker trip path!) must
  never die because the disk did.

Dump *reasons* are a fixed vocabulary (:data:`DUMP_REASONS`) checked
by the staticcheck ``registry-drift`` rule against literal
``.dump("...")`` call sites, exactly like faultinject's ``POINTS``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

__all__ = ["FlightRecorder", "Ring", "DUMP_REASONS", "STAGES"]

#: the fixed dump-reason vocabulary — drift-checked like POINTS
DUMP_REASONS = (
    "breaker_trip", "brownout", "supervisor_degraded", "manual",
    "admission_escalation", "mesh_degraded",
)

#: packed stage ids: index into this tuple == the event's stage id
STAGES = (
    "ingest_parse", "fanout_queue", "match_wait", "match_encode",
    "match_dispatch", "match_readback", "deliver", "flush",
)


class Ring:
    """One plane's preallocated event ring — single writer, lock-free.

    ``push`` is the always-on hot entry (per *batch*, not per message):
    one tuple pack + one slot assignment + one add.  Readers snapshot
    by copying the buffer (a C-level list copy) and reading the write
    cursor once; a slot raced mid-copy shows either the old or the new
    event — both valid histories.
    """

    __slots__ = ("plane", "buf", "idx", "_mask")

    def __init__(self, plane: str, depth: int = 4096) -> None:
        d = 64
        while d < depth:
            d <<= 1
        self.plane = plane
        self.buf: List[Optional[Tuple]] = [None] * d
        self._mask = d - 1
        self.idx = 0

    def push(self, sid: int, start_ns: int, dur_ns: int,
             batch: int = 0, gen: int = 0) -> None:
        i = self.idx
        self.buf[i & self._mask] = (sid, start_ns, dur_ns, batch, gen)
        self.idx = i + 1

    def snapshot(self) -> List[Tuple]:
        """Events oldest→newest at this instant; never blocks push."""
        idx = self.idx
        buf = list(self.buf)
        n = len(buf)
        if idx <= n:
            return [e for e in buf[:idx] if e is not None]
        cut = idx & self._mask
        return [e for e in buf[cut:] + buf[:cut] if e is not None]


class FlightRecorder:
    """The per-node recorder: ring registry + trigger-driven dumps."""

    def __init__(self, out_dir: str, depth: int = 4096,
                 metrics: Any = None) -> None:
        self.out_dir = out_dir
        self.depth = depth
        self.metrics = metrics
        self._rings: Dict[str, Ring] = {}
        self.dumps = 0
        self.last_dump: Optional[str] = None
        self.last_reason: Optional[str] = None

    def ring(self, plane: str) -> Ring:
        """Get-or-create the plane's ring.  Called once at setup by
        each writer; the returned ring is the hot-path handle."""
        r = self._rings.get(plane)
        if r is None:
            r = self._rings[plane] = Ring(plane, self.depth)
        return r

    # ------------------------------------------------------------------

    def _payload(self, reason: str, note: Optional[str]) -> Dict[str, Any]:
        events: List[Dict[str, Any]] = []
        for tid, (plane, ring) in enumerate(
                sorted(self._rings.items()), start=1):
            events.append({
                "ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                "args": {"name": plane},
            })
            for sid, start_ns, dur_ns, batch, gen in ring.snapshot():
                events.append({
                    "name": (STAGES[sid] if 0 <= sid < len(STAGES)
                             else f"stage{sid}"),
                    "cat": plane, "ph": "X", "pid": 1, "tid": tid,
                    "ts": start_ns / 1e3,      # trace-event µs
                    "dur": dur_ns / 1e3,
                    "args": {"batch": batch, "gen": gen},
                })
        # metadata events (ph M) first, then slices in ts order — the
        # chaos tests assert the ordering, and Perfetto renders faster
        events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "reason": reason,
            "note": note,
            "wall_time": time.time(),
        }

    def dump(self, reason: str, note: Optional[str] = None) -> Optional[str]:
        """Snapshot every ring and write one Perfetto-openable trace
        file.  Returns the path, or ``None`` when the write failed
        (logged, never raised — trigger sites include the breaker trip
        path).  Unknown reasons raise: the vocabulary is fixed."""
        if reason not in DUMP_REASONS:
            raise ValueError(f"unknown flight-recorder dump reason "
                             f"{reason!r} (declared: {DUMP_REASONS})")
        path = os.path.join(
            self.out_dir, f"flightrec-{reason}-{time.time_ns()}.json")
        tmp = path + ".tmp"
        try:
            payload = self._payload(reason, note)
            os.makedirs(self.out_dir, exist_ok=True)
            # temp-file + same-dir atomic rename: a kill at ANY point
            # leaves either no file or the complete file, never a torn
            # JSON half
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f, separators=(",", ":"))
            os.replace(tmp, path)
        except Exception:
            log.exception("flight-recorder dump (%s) failed", reason)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        self.dumps += 1
        self.last_dump = path
        self.last_reason = reason
        if self.metrics is not None:
            self.metrics.inc("obs.flightrec.dumps")
        log.warning("flight recorder dumped %d event(s) to %s (%s)",
                    sum(r.idx if r.idx < len(r.buf) else len(r.buf)
                        for r in self._rings.values()), path, reason)
        return path

    def info(self) -> Dict[str, Any]:
        return {
            "dir": self.out_dir,
            "depth": self.depth,
            "dumps": self.dumps,
            "last_dump": self.last_dump,
            "last_reason": self.last_reason,
            "planes": {p: r.idx for p, r in sorted(self._rings.items())},
        }
