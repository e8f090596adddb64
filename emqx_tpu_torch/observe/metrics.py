"""Fixed counter set — the ``emqx_metrics`` analog.

The port's own copy of the reference's ``emqx_tpu/observe/metrics.py``:
the reference's fixed counter names, its ``tpu.*`` group for the device
match path, and the broker and serve-loop counters that the port's
modules increment.  Unknown names raise, so a typo at a call site fails
at once.  Python ints under a single writer (the asyncio event loop, or
the one in-flight serve worker) play the role of atomics.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

__all__ = ["Metrics", "METRIC_NAMES", "TPU_METRIC_NAMES",
           "BROKER_METRIC_NAMES", "FANOUT_METRIC_NAMES",
           "CONNPLANE_METRIC_NAMES", "ROBUSTNESS_METRIC_NAMES",
           "MATCH_SERVE_METRIC_NAMES", "TABLE_METRIC_NAMES",
           "MULTICHIP_METRIC_NAMES", "MESH_METRIC_NAMES"]

# -- the reference's fixed counter names, grouped as in emqx_metrics.erl [U]
METRIC_NAMES: List[str] = [
    # bytes
    "bytes.received", "bytes.sent",
    # packets
    "packets.received", "packets.sent",
    "packets.connect.received", "packets.connack.sent",
    "packets.publish.received", "packets.publish.sent",
    "packets.publish.error", "packets.publish.auth_error",
    "packets.publish.dropped",
    "packets.puback.received", "packets.puback.sent",
    "packets.puback.inuse", "packets.puback.missed",
    "packets.pubrec.received", "packets.pubrec.sent",
    "packets.pubrec.inuse", "packets.pubrec.missed",
    "packets.pubrel.received", "packets.pubrel.sent",
    "packets.pubrel.missed",
    "packets.pubcomp.received", "packets.pubcomp.sent",
    "packets.pubcomp.inuse", "packets.pubcomp.missed",
    "packets.subscribe.received", "packets.suback.sent",
    "packets.subscribe.error", "packets.subscribe.auth_error",
    "packets.unsubscribe.received", "packets.unsuback.sent",
    "packets.unsubscribe.error",
    "packets.pingreq.received", "packets.pingresp.sent",
    "packets.disconnect.received", "packets.disconnect.sent",
    "packets.auth.received", "packets.auth.sent",
    "packets.connack.error", "packets.connack.auth_error",
    # messages
    "messages.received", "messages.sent",
    "messages.qos0.received", "messages.qos0.sent",
    "messages.qos1.received", "messages.qos1.sent",
    "messages.qos2.received", "messages.qos2.sent",
    "messages.publish", "messages.dropped",
    "messages.dropped.no_subscribers", "messages.dropped.await_pubrel_timeout",
    "messages.dropped.receive_maximum", "messages.dropped.expired",
    "messages.dropped.queue_full", "messages.dropped.too_large",
    # detail counters for drop reasons our delivery stack emits beyond
    # the reference set (registry-drift: inc_msg_dropped silently skips
    # unregistered detail keys — these two under-counted before PR 4)
    "messages.dropped.olp_shed", "messages.dropped.forward_no_peer",
    "messages.forward", "messages.delayed", "messages.delivered",
    "messages.acked", "messages.retained",
    # delivery
    "delivery.dropped", "delivery.dropped.no_local",
    "delivery.dropped.too_large", "delivery.dropped.qos0_msg",
    "delivery.dropped.queue_full", "delivery.dropped.expired",
    # client lifecycle
    "client.connect", "client.connack", "client.connected",
    "client.authenticate", "client.auth.anonymous", "client.authorize",
    "client.subscribe", "client.unsubscribe", "client.disconnected",
    # session lifecycle
    "session.created", "session.resumed", "session.takenover",
    "session.discarded", "session.terminated",
    # authorization
    "authorization.allow", "authorization.deny",
    "authorization.cache_hit", "authorization.cache_miss",
    "authorization.superuser", "authorization.nomatch",
    # overload protection
    "olp.delay.ok", "olp.delay.timeout", "olp.hbn", "olp.gc",
    "olp.new_conn",
]

# -- the device match path: served batches and topics, spills re-run on
# the host, mirror syncs, hint cache outcomes, bypasses
TPU_METRIC_NAMES: List[str] = [
    "tpu.match.batches", "tpu.match.topics",
    "tpu.match.active_overflow", "tpu.match.match_overflow",
    "tpu.match.fallback_host", "tpu.mirror.refresh",
    "tpu.mirror.delta_applied", "tpu.mirror.recompile",
    "tpu.match.hint_served", "tpu.match.hint_stale", "tpu.match.bypass",
    "tpu.match.hint_evicted",
    # the served hints that the host tables answered (a failed or stale
    # pipelined slot's, through _cpu_serve); the port's own counter
    "tpu.match.hint_served_host",
]

# -- broker drop accounting (outbox overflow) and the session's batched
# QoS1/2 window admissions and QoS2 state transitions
BROKER_METRIC_NAMES: List[str] = [
    "broker.outbox.dropped", "broker.inflight.batch_admitted",
    "broker.qos2.batch",
]

# -- the batched fanout pipeline (broker/fanout.py): batches and messages
# drained (inc; mean batch = msgs / batches), the last batch's size and
# the queue depth after it (set), the drain's microseconds (inc), and the
# offers refused (low-rate bypass, overflow, shape gate) or fallen back to
# the per-message path (fallback, errors)
FANOUT_METRIC_NAMES: List[str] = [
    "broker.fanout.batches", "broker.fanout.msgs",
    "broker.fanout.batch_size", "broker.fanout.flush_us",
    "broker.fanout.depth", "broker.fanout.bypass",
    "broker.fanout.overflow", "broker.fanout.fallback",
    "broker.fanout.errors", "broker.fanout.shape_bypass",
]

# -- the connection plane: ack or write flushes that merged more than one
# packet (inc), ack runs the parser's fast path packed (inc), the timers
# resident in the batched stack's wheel (set, by housekeeping)
CONNPLANE_METRIC_NAMES: List[str] = [
    "broker.ack.coalesced_writes", "broker.ack.run_parsed",
    "broker.ingest.publish_runs", "broker.timer.wheel_conns",
]

# -- the supervision tree (supervise.py: restarts accumulate, degraded is
# the current degraded-child count) and overload protection (broker/olp.py:
# the fanout's QoS0 shed and deferrals, the loop-lag probe's last drift in
# microseconds), and the flight recorder's dumps (observe/flightrec.py)
ROBUSTNESS_METRIC_NAMES: List[str] = [
    "broker.supervisor.restarts", "broker.supervisor.degraded",
    "broker.olp.shed_qos0", "broker.olp.deferred",
    "broker.olp.loop_lag_us", "obs.flightrec.dumps",
]

# -- the serve loop: cpu_fallback counts waiters answered from the host
# tables (a dying serve loop's, a failed or stale pipelined slot's);
# pipeline_inflight is the live count of pipelined slots past dispatch
# (set); deadline_miss counts waiters answered past their deadline;
# readback_bytes / readback_roundtrips accumulate the d2h bytes and the
# waits of the readback stage;
# backend_join_dispatches counts walk dispatches served by the join
# backend (one per depth group) and autotune_picks the shapes the
# autotuner measured
MATCH_SERVE_METRIC_NAMES: List[str] = [
    "broker.match.cpu_fallback", "broker.match.pipeline_inflight",
    "broker.match.deadline_miss", "tpu.match.readback_bytes",
    "tpu.match.readback_roundtrips",
    "tpu.match.backend_join_dispatches", "tpu.match.autotune_picks",
    # the deadline serve plane: partial batches the budget forced out
    # (inc), the breaker (set: 0 closed, 1 open, 2 probing) and the
    # brownout stage (set)
    "broker.match.deadline_dispatch", "broker.match.breaker_state",
    "broker.match.brownout_level",
]

# -- segments and compaction: the last cold start's segment load and
# reconcile in seconds (set), the compaction swaps (inc), the rows the
# device table took by row writes and grows in place (set each sync)
TABLE_METRIC_NAMES: List[str] = [
    "tpu.table.segment_load_s", "tpu.table.compact_runs",
    "tpu.table.dirty_rows_uploaded",
]


# -- the multichip serve backend (parallel/multichip_serve.py, with
# match.multichip.enable): shard_devices the mesh size dp·tp (set),
# shard_dispatches the batches served from the sharded table (one a
# depth group), shard_failover the dispatches refused (a dead or
# fault-injected shard, a shard whose launch raised, an ep.route fault),
# shard_restacks the full uploads of the shard tables (set).  The EP
# routed front end: ep_dispatches, ep_overflow_rows (rows it failed open
# to the host), ep_shard_width (tp·C of the last routed dispatch, set),
# ep_ici_bytes (the routing all_to_all's bytes, by formula),
# ep_overflow_ewma (set, 0..1); the load-adaptive plane: ep_cap_class
# (set), ep_resizes, ep_rebalances, ep_moved_roots (set)
MULTICHIP_METRIC_NAMES: List[str] = [
    "tpu.match.shard_devices", "tpu.match.shard_dispatches",
    "tpu.match.shard_failover", "tpu.match.shard_restacks",
    "tpu.match.ep_dispatches", "tpu.match.ep_overflow_rows",
    "tpu.match.ep_shard_width", "tpu.match.ep_ici_bytes",
    "tpu.match.ep_overflow_ewma",
    "tpu.match.ep_cap_class", "tpu.match.ep_resizes",
    "tpu.match.ep_rebalances", "tpu.match.ep_moved_roots",
]

# -- the degraded mesh (match.multichip.degraded.enable): state the
# ladder's rung (set: 0 healthy, 1 degraded, 2 cpu-only),
# degraded_batches the dispatches served with a dead shard,
# cpu_filled_rows the rows the host filled in or answered under the
# scoped failover, rebuild_s the last shard rebuild's seconds (set),
# readmit_canary_fails the re-admissions a canary refused
MESH_METRIC_NAMES: List[str] = [
    "tpu.mesh.state", "tpu.mesh.degraded_batches",
    "tpu.mesh.cpu_filled_rows", "tpu.mesh.rebuild_s",
    "tpu.mesh.readmit_canary_fails",
]


class Metrics:
    """A counter table with the fixed name set.

    ``inc``/``get``/``all``; unknown names raise (mirroring the
    reference's fixed-at-boot table, which catches typos at call sites).
    """

    __slots__ = ("_c",)

    def __init__(self, extra: Optional[Iterable[str]] = None) -> None:
        self._c: Dict[str, int] = {}
        for names in (METRIC_NAMES, TPU_METRIC_NAMES, BROKER_METRIC_NAMES,
                      FANOUT_METRIC_NAMES, CONNPLANE_METRIC_NAMES,
                      ROBUSTNESS_METRIC_NAMES, MATCH_SERVE_METRIC_NAMES,
                      TABLE_METRIC_NAMES, MULTICHIP_METRIC_NAMES,
                      MESH_METRIC_NAMES, extra or ()):
            self._c.update({n: 0 for n in names})

    def inc(self, name: str, n: int = 1) -> None:
        self._c[name] += n

    def dec(self, name: str, n: int = 1) -> None:
        self._c[name] -= n

    def set(self, name: str, v: int) -> None:
        """Last-observed-value metrics share the fixed table; unknown
        names still raise like inc."""
        if name not in self._c:
            raise KeyError(name)
        self._c[name] = v

    def get(self, name: str) -> int:
        return self._c[name]

    def all(self) -> Dict[str, int]:
        return dict(self._c)

    def reset(self) -> None:
        for k in self._c:
            self._c[k] = 0

    # -- convenience aggregations used by the v3-compat REST shape --------
    def received_msgs(self) -> int:
        return self._c["messages.received"]

    def sent_msgs(self) -> int:
        return self._c["messages.sent"]

    def inc_recv_packet(self, ptype: str, nbytes: int = 0) -> None:
        """Bump the packets.<type>.received family (+ totals + bytes)."""
        self._c["packets.received"] += 1
        if nbytes:
            self._c["bytes.received"] += nbytes
        key = f"packets.{ptype}.received"
        if key in self._c:
            self._c[key] += 1

    def inc_sent_packet(self, ptype: str, nbytes: int = 0) -> None:
        self._c["packets.sent"] += 1
        if nbytes:
            self._c["bytes.sent"] += nbytes
        key = f"packets.{ptype}.sent"
        if key in self._c:
            self._c[key] += 1

    def inc_msg_received(self, qos: int) -> None:
        self._c["messages.received"] += 1
        self._c[f"messages.qos{min(qos, 2)}.received"] += 1

    def inc_msg_sent(self, qos: int) -> None:
        self._c["messages.sent"] += 1
        self._c[f"messages.qos{min(qos, 2)}.sent"] += 1

    def inc_msg_dropped(self, reason: str) -> None:
        self._c["messages.dropped"] += 1
        key = f"messages.dropped.{reason}"
        if key in self._c:
            self._c[key] += 1
