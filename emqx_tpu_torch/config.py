"""The port's own copy of the reference's ``emqx_tpu/config.py``, so
that nothing here imports the JAX package.

Typed, layered configuration — the ``emqx_config``/``emqx_schema``/
``hocon`` analog.

Behavioral reference (SURVEY.md §5.6): HOCON config files checked against
a typed schema, layered **defaults → file → environment → runtime API**,
with zone override sets and a change handler that validates before
applying (hot update).  Environment overrides use the reference's naming:
``EMQX_MQTT__MAX_PACKET_SIZE=2MB`` ⇒ ``mqtt.max_packet_size``.

The file syntax is a HOCON subset (the part emqx.conf actually uses):
``a.b = v`` and ``a { b = v }`` nesting, ``#``/``//`` comments, strings
(quoted or bare), numbers, booleans, durations (``15s``, ``2m``, ``1h``),
byte sizes (``1MB``, ``64KB``), and ``[a, b]`` arrays.

Schema entries are :class:`Field` records (type, default, validator);
unknown keys are rejected at load, exactly like the reference's
schema-checked boot.
"""

from __future__ import annotations

import copy
import os
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["Field", "Config", "SCHEMA", "parse_hocon", "duration", "bytesize"]


# ---------------------------------------------------------------------------
# value parsers

_DUR = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}
_SIZE = {"b": 1, "kb": 1 << 10, "mb": 1 << 20, "gb": 1 << 30}


def duration(v: Any) -> float:
    """'15s' → 15.0 (seconds). Numbers pass through as seconds."""
    if isinstance(v, (int, float)):
        return float(v)
    m = re.fullmatch(r"\s*([\d.]+)\s*(ms|s|m|h|d)\s*", str(v))
    if not m:
        raise ValueError(f"bad duration {v!r}")
    return float(m.group(1)) * _DUR[m.group(2)]


def bytesize(v: Any) -> int:
    """'1MB' → 1048576. Numbers pass through as bytes."""
    if isinstance(v, (int, float)):
        return int(v)
    m = re.fullmatch(r"\s*([\d.]+)\s*(b|kb|mb|gb)?\s*", str(v), re.I)
    if not m:
        raise ValueError(f"bad size {v!r}")
    return int(float(m.group(1)) * _SIZE[(m.group(2) or "b").lower()])


def _bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).lower()
    if s in ("true", "1", "on", "yes"):
        return True
    if s in ("false", "0", "off", "no"):
        return False
    raise ValueError(f"bad bool {v!r}")


# ---------------------------------------------------------------------------
# schema

@dataclass(frozen=True)
class Field:
    """One schema leaf: parse/validate + default."""

    default: Any
    parse: Callable[[Any], Any] = lambda v: v
    check: Optional[Callable[[Any], bool]] = None
    doc: str = ""

    def coerce(self, path: str, v: Any) -> Any:
        try:
            out = self.parse(v)
        except (TypeError, ValueError) as e:
            raise ValueError(f"{path}: {e}") from None
        if self.check is not None and not self.check(out):
            raise ValueError(f"{path}: value {out!r} out of range")
        return out


def _enum(*allowed: str) -> Callable[[Any], Any]:
    def parse(v):
        if v not in allowed:
            raise ValueError(f"must be one of {allowed}, got {v!r}")
        return v
    return parse


def _strlist(v: Any) -> List[str]:
    if isinstance(v, str):
        return [s.strip() for s in v.split(",") if s.strip()]
    return [str(x) for x in v]


# The schema tree: dotted path -> Field.  Zone-overridable keys live under
# "mqtt."/"force_shutdown." like the reference's zone mechanism.
SCHEMA: Dict[str, Field] = {
    "node.name": Field("emqx_tpu@127.0.0.1", str),
    "node.cookie": Field("emqxsecretcookie", str),
    "node.data_dir": Field("data", str),

    "mqtt.max_packet_size": Field(1 << 20, bytesize, lambda v: v > 0),
    "mqtt.max_clientid_len": Field(65535, int, lambda v: v >= 23),
    "mqtt.max_topic_levels": Field(128, int, lambda v: 1 <= v <= 128),
    "mqtt.max_topic_alias": Field(65535, int, lambda v: 0 <= v <= 65535),
    "mqtt.max_qos_allowed": Field(2, int, lambda v: v in (0, 1, 2)),
    "mqtt.retain_available": Field(True, _bool),
    "mqtt.wildcard_subscription": Field(True, _bool),
    "mqtt.shared_subscription": Field(True, _bool),
    "mqtt.ignore_loop_deliver": Field(False, _bool),
    "mqtt.session_expiry_interval": Field(7200.0, duration),
    "mqtt.max_inflight": Field(32, int, lambda v: 1 <= v <= 65535),
    "mqtt.max_mqueue_len": Field(1000, int, lambda v: v >= 0),
    "mqtt.mqueue_priorities": Field("disabled", str),
    "mqtt.mqueue_default_priority": Field("lowest", _enum("lowest", "highest")),
    "mqtt.mqueue_store_qos0": Field(True, _bool),
    "mqtt.max_awaiting_rel": Field(100, int),
    "mqtt.await_rel_timeout": Field(300.0, duration),
    "mqtt.keepalive_backoff": Field(0.75, float, lambda v: 0.5 <= v <= 1.0),
    "mqtt.upgrade_qos": Field(False, _bool),
    "mqtt.server_keepalive": Field(0, int),

    "broker.shared_subscription_strategy": Field(
        "random",
        _enum("random", "round_robin", "sticky", "hash_clientid",
              "hash_topic", "local"),
    ),
    "broker.shared_dispatch_ack_enabled": Field(False, _bool),
    # batched publish→deliver fanout pipeline (broker/fanout.py) —
    # opt-in; the per-message path stays the default-on fallback
    "broker.fanout.enable": Field(False, _bool),
    "broker.fanout.max_batch": Field(2048, int, lambda v: v >= 1),
    "broker.fanout.min_batch": Field(8, int, lambda v: v >= 1),
    "broker.fanout.window": Field(0.0005, duration),
    # adaptive sizing: one batch covers at most this much arrival time
    "broker.fanout.adapt_window": Field(0.05, duration),
    # publishes/s below which offers bypass to the per-message path
    # (0 disables bypassing — batch even single publishes)
    "broker.fanout.bypass_rate": Field(0.0, float, lambda v: v >= 0),
    "broker.fanout.queue_cap": Field(65536, int, lambda v: v >= 1),
    # shape-aware gate: observed fan-out legs/message at or below this
    # bypasses to the per-message path while idle (1:1 paired-client
    # shapes have nothing for batching to amortize); 0 disables
    "broker.fanout.shape_routes": Field(1.25, float, lambda v: v >= 0),
    # while shape-bypassing, admit one probe message per interval so
    # the routes/message estimate tracks workload changes
    "broker.fanout.shape_probe": Field(0.25, duration),
    # connection-plane sharding (transport/shards.py): N worker event
    # loops with SO_REUSEPORT listeners on the default TCP port; 0 =
    # single-loop.  Requires broker.fanout.enable (the shard fast path
    # acks with the pipeline's semantics) and the plain-TCP fast_path
    # listener; incompatible with the async advisory stage.
    "broker.conn.shards": Field(0, int, lambda v: v >= 0),
    # supervision tree (supervise.py): restart-intensity window and
    # backoff for the node's long-lived background tasks.  Exceeding
    # max_restarts within the window escalates to an alarm + degraded
    # mode (restarts continue at backoff_max) instead of dying.
    "supervisor.max_restarts": Field(5, int, lambda v: v >= 1),
    "supervisor.window": Field(10.0, duration),
    "supervisor.backoff_base": Field(0.05, duration),
    "supervisor.backoff_max": Field(5.0, duration),
    # overload protection (broker/olp.py, emqx_olp analog) wired into
    # the fanout pipeline: sustained overload sheds QoS0 first and
    # defers retained/delayed publishes instead of growing queues
    "overload_protection.max_loop_lag": Field(0.5, duration),
    "overload_protection.max_queue_depth": Field(
        100_000, int, lambda v: v >= 1),
    "overload_protection.cooloff": Field(5.0, duration),
    # event-loop lag sampler (LoopLagProbe): sleep-drift sampling tick;
    # 0 disables the probe (queue depth stays the only overload signal)
    "overload_protection.lag_probe_interval": Field(0.1, duration),
    "broker.sys_msg_interval": Field(60.0, duration),
    "broker.sys_heartbeat_interval": Field(30.0, duration),
    "broker.enable_session_registry": Field(True, _bool),

    "retainer.enable": Field(True, _bool),
    "retainer.msg_expiry_interval": Field(0.0, duration),
    "retainer.max_payload_size": Field(1 << 20, bytesize),
    "retainer.max_retained_messages": Field(0, int),  # 0 = unlimited
    "retainer.use_device_match": Field(True, _bool),

    "delayed.enable": Field(True, _bool),
    "delayed.max_delayed_messages": Field(0, int),

    "flapping_detect.enable": Field(False, _bool),
    "flapping_detect.max_count": Field(15, int),
    "flapping_detect.window_time": Field(60.0, duration),
    "flapping_detect.ban_time": Field(300.0, duration),

    # -- batched admission plane (broker/admission.py) --------------------
    # opt-in: per-client EWMA behavior features accumulated O(1) at the
    # ingest seams, scored in one vectorized pass per tick by the
    # supervised admission.score child, feeding the quarantine ladder
    # observe → throttle → QoS0-shed → temp-ban.  Off = broker.admission
    # stays None and every seam is one attr load + identity test.
    "admission.enable": Field(False, _bool),
    "admission.tick": Field(1.0, duration, lambda v: v > 0),
    # distinct-topic sketch window: the fan feature folds once per this
    # interval (clamped to >= tick) so "distinct topics per second"
    # counts NEW topics, not one topic re-counted every short tick
    "admission.fan_window": Field(1.0, duration, lambda v: v > 0),
    # EWMA fold factor per tick for the feature rows
    "admission.alpha": Field(0.3, float, lambda v: 0 < v <= 1),
    # composite score (sum of feature/threshold ratios) at or above
    # which a client is "hot"; hysteresis below decides transitions
    "admission.threshold": Field(1.0, float, lambda v: v > 0),
    # fraction of the (possibly brownout-tightened) threshold below
    # which a tick counts as calm
    "admission.clear_ratio": Field(0.5, float, lambda v: 0 < v < 1),
    # consecutive hot ticks before escalating one ladder level /
    # consecutive calm ticks before de-escalating one
    "admission.hold_ticks": Field(2, int, lambda v: v >= 1),
    "admission.decay_ticks": Field(5, int, lambda v: v >= 1),
    # level-1 throttle: the client's message TokenBucket is retuned to
    # this rate (msgs/s); de-escalation restores limiter.max_messages_rate
    "admission.throttle_rate": Field(50.0, float, lambda v: v > 0),
    # level-3 temp-ban duration (Banned, by="admission")
    "admission.ban_time": Field(60.0, duration, lambda v: v > 0),
    # feature rows idle this long with no standing decision are evicted
    # (reconnect-churn memory bound; broker.admission.tracked_clients)
    "admission.idle_expiry": Field(300.0, duration, lambda v: v > 0),
    # per-feature rate thresholds (per second); the score saturates at
    # 1.0 when ONE dimension hits its threshold, so defaults are "an
    # order of magnitude past honest" for each behavior
    "admission.max_connect_rate": Field(2.0, float, lambda v: v > 0),
    "admission.max_malformed_rate": Field(1.0, float, lambda v: v > 0),
    "admission.max_auth_fail_rate": Field(1.0, float, lambda v: v > 0),
    "admission.max_publish_rate": Field(500.0, float, lambda v: v > 0),
    "admission.max_publish_bytes_rate": Field(
        4 << 20, bytesize, lambda v: v > 0),
    "admission.max_topic_fan": Field(50.0, float, lambda v: v > 0),

    "force_shutdown.max_mailbox_size": Field(1000, int),
    "force_shutdown.max_heap_size": Field(32 << 20, bytesize),

    "limiter.max_conn_rate": Field(0.0, float),      # 0 = unlimited
    "limiter.max_messages_rate": Field(0.0, float),
    "limiter.max_bytes_rate": Field(0.0, float),

    "authn.enable": Field(True, _bool),
    # tri-state: unset (None) = auto — open while the chain is empty,
    # deny-on-exhaustion once any authenticator exists; an explicit
    # true/false overrides (wired into AuthChain at node build)
    "authn.allow_anonymous": Field(
        None, lambda v: None if v is None else _bool(v)),
    "authz.no_match": Field("allow", _enum("allow", "deny")),
    "authz.deny_action": Field("ignore", _enum("ignore", "disconnect")),
    "authz.cache.enable": Field(True, _bool),
    "authz.cache.max_size": Field(32, int),
    "authz.cache.ttl": Field(60.0, duration),

    "listeners.tcp.default.bind": Field("0.0.0.0:1883", str),
    "listeners.tcp.default.max_connections": Field(1 << 20, int),
    "listeners.tcp.default.enable": Field(True, _bool),
    # protocol-mode datapath (no per-connection tasks); stream path
    # remains for ws/ssl and as a fallback switch
    "listeners.tcp.default.fast_path": Field(True, _bool),
    # bind with SO_REUSEPORT so several broker processes share the port
    # (kernel-balanced multi-acceptor scale-out; cluster them as usual)
    "listeners.tcp.default.reuse_port": Field(False, _bool),
    # TLS listener (certfile/keyfile PEM paths; psk.enable attaches the
    # PSK store to the handshake where the runtime supports it)
    "listeners.ssl.default.enable": Field(False, _bool),
    "listeners.ssl.default.bind": Field("0.0.0.0:8883", str),
    "listeners.ssl.default.certfile": Field("", str),
    "listeners.ssl.default.keyfile": Field("", str),
    "listeners.ssl.default.cacertfile": Field("", str),
    "listeners.ssl.default.verify": Field(False, _bool),
    # SNI: per-hostname cert chains, "host=cert.pem;key.pem" comma list
    # (emqx_tls_lib SNI analog); unmatched names fall to the default cert
    "listeners.ssl.default.sni": Field("", str),
    # OCSP stapling cache (emqx_ocsp_cache analog); responder_url
    # overrides the certificate's AIA entry
    # MQTT-over-QUIC listener (quicer analog; in-repo RFC 9000/9001
    # stack).  Reuses the ssl listener's cert pair when its own are
    # blank.
    "listeners.quic.default.enable": Field(False, _bool),
    "listeners.quic.default.bind": Field("0.0.0.0:14567", str),
    "listeners.quic.default.certfile": Field("", str),
    "listeners.quic.default.keyfile": Field("", str),
    "listeners.quic.default.max_connections": Field(4096, int),
    "listeners.ssl.default.ocsp.enable": Field(False, _bool),
    "listeners.ssl.default.ocsp.responder_url": Field("", str),
    "listeners.ssl.default.ocsp.refresh_interval": Field(3600.0, duration),
    "listeners.ssl.default.ocsp.refresh_http_timeout": Field(10.0, duration),
    # revocation: CRL PEM path + check scope ("leaf" | "chain")
    "listeners.ssl.default.crlfile": Field("", str),
    "listeners.ssl.default.crl_check": Field("leaf", str),
    "listeners.ws.default.bind": Field("0.0.0.0:8083", str),
    "listeners.ws.default.enable": Field(False, _bool),

    "sysmon.os.cpu_high_watermark": Field(0.80, float),
    "sysmon.os.cpu_low_watermark": Field(0.60, float),
    "sysmon.os.mem_high_watermark": Field(0.70, float),

    # -- durable storage (SURVEY.md §5.4: emqx_ds / mnesia disc) ----------
    # empty = in-memory only (no persistence)
    "node.data_dir": Field("", str),
    "durable_storage.sync_interval": Field(5.0, duration),
    # 0 = fsync every WAL append (lose at most a torn tail line);
    # t > 0 = fsync at most once per t seconds (bounded loss window)
    "durable_storage.fsync_interval": Field(0.0, duration),

    # -- management API (SURVEY.md §2.3: emqx_management/minirest) --------
    # off by default: embedded/multi-node-on-one-host uses must opt in
    # (the reference's standalone release enables it in its dist config)
    "dashboard.enable": Field(False, _bool),
    # loopback by default: binding wider without auth would expose
    # kick/publish/config mutation to the network
    "dashboard.listen": Field("127.0.0.1:18083", str),
    # bearer-token (login) auth for every endpoint except /status and
    # /login; disable only for loopback tooling/tests
    "dashboard.auth": Field(True, _bool),
    "api_key.enable": Field(False, _bool),
    "api_key.key": Field("admin", str),
    "api_key.secret": Field("public", str),

    # -- cluster substrate (SURVEY.md §2.2: ekka/mria/gen_rpc layer) ------
    "cluster.enable": Field(False, _bool),
    "cluster.name": Field("emqx_tpu", str),
    "cluster.listen": Field("127.0.0.1:4370", str),
    # static discovery: comma-separated host:port seed list
    "cluster.seeds": Field("", str),
    "cluster.heartbeat_interval": Field(1.0, duration),
    "cluster.node_timeout": Field(5.0, duration),

    # -- observability extras (emqx_slow_subs / statsd / telemetry) -------
    "topic_metrics.max_topics": Field(512, int,
                                      lambda v: 1 <= v <= 65536),
    "slow_subs.enable": Field(False, _bool),
    "slow_subs.threshold": Field(0.5, duration),
    "slow_subs.top_k": Field(10, int, lambda v: 1 <= v <= 1000),
    "slow_subs.window_time": Field(300.0, duration),
    "slow_subs.latency_ceiling": Field(10.0, duration),
    "statsd.enable": Field(False, _bool),
    "statsd.server": Field("127.0.0.1:8125", str),
    "statsd.flush_interval": Field(30.0, duration),
    # stage-level latency observatory (observe/hist.py): per-stage
    # log2-bucket histograms on every plane.  Off = recording sites are
    # zero-call (the faultinject idiom); on costs one subtract + one
    # index per record.  The flight recorder (observe/flightrec.py) is
    # ALWAYS on — depth bounds each plane's preallocated event ring.
    "obs.hist.enable": Field(True, _bool),
    # per-leg e2e latency sampling (broker/fanout.py): record the
    # publish→deliver span of every Nth DELIVERY LEG (not just the
    # first leg of a chunk) into obs.e2e.publish_deliver_leg, making
    # per-subscriber skew visible.  0 = off (zero-call, spy-asserted);
    # N records ~1/N of legs.
    "obs.hist.e2e_per_leg_sample": Field(0, int, lambda v: v >= 0),
    "obs.flightrec.depth": Field(4096, int, lambda v: 64 <= v <= 1 << 20),
    "telemetry.enable": Field(False, _bool),
    "telemetry.url": Field("", str),
    "telemetry.interval": Field(604800.0, duration),

    # -- TLS-PSK identity store (emqx_psk analog) -------------------------
    "psk.enable": Field(False, _bool),
    # inline "identity:hexpsk" entries, comma-separated (file-free envs)
    "psk.entries": Field("", str),

    # -- gateways (emqx_gateway analog, SURVEY.md §2.3) -------------------
    "gateway.stomp.enable": Field(False, _bool),
    "gateway.stomp.bind": Field("127.0.0.1:61613", str),
    "gateway.mqttsn.enable": Field(False, _bool),
    "gateway.mqttsn.bind": Field("127.0.0.1:1884", str),
    "gateway.mqttsn.gateway_id": Field(1, int),
    "gateway.coap.enable": Field(False, _bool),
    "gateway.coap.bind": Field("127.0.0.1:5683", str),
    "gateway.coap.dtls.enable": Field(False, _bool),
    # comma list of identity:hexkey PSK entries (emqx_psk table analog)
    "gateway.coap.dtls.psk": Field("", str),
    "gateway.exproto.enable": Field(False, _bool),
    "gateway.exproto.bind": Field("127.0.0.1:7993", str),
    # the user's ConnectionHandler gRPC endpoint
    "gateway.exproto.handler": Field("", str),
    "gateway.exproto.adapter_listen": Field("127.0.0.1:0", str),
    "gateway.lwm2m.enable": Field(False, _bool),
    "gateway.lwm2m.bind": Field("127.0.0.1:5783", str),
    "gateway.lwm2m.dtls.enable": Field(False, _bool),
    "gateway.lwm2m.dtls.psk": Field("", str),

    # -- exhook (gRPC extension boundary, SURVEY.md §2.3) -----------------
    # comma-separated "name=url" pairs, e.g. "default=127.0.0.1:9000"
    "exhook.servers": Field("", str),
    "exhook.request_timeout": Field(5.0, duration),
    "exhook.failure_action": Field("ignore", _enum("ignore", "deny")),

    # -- TPU data plane (ours) --------------------------------------------
    "tpu.enable": Field(True, _bool),
    "tpu.max_levels": Field(16, int, lambda v: 1 <= v <= 64),
    # the reference's measured serving sweet spot: 2048
    "tpu.batch_size": Field(2048, int, lambda v: v >= 1),
    "tpu.batch_deadline": Field(0.0002, duration),
    "tpu.active_slots": Field(16, int),
    # 128 keeps the 10M fan-out tail on device (the reference's
    # measurement in BASELINE.md: 32 spilled 11-12% of topics to host
    # re-runs)
    "tpu.max_matches": Field(128, int),
    "tpu.mirror_refresh_interval": Field(0.05, duration),
    # bound on device bring-up (first XLA compile is ~20-40s; a WEDGED
    # device tunnel would otherwise hang node start forever — on timeout
    # the node serves from the host trie)
    "tpu.start_timeout": Field(180.0, duration),
    # host-table implementation behind the device mirror: the C++
    # incremental NFA scales to 10M filters; python is the debug twin
    "tpu.table": Field("auto", _enum("auto", "native", "python")),
    # depth bucketing: topics with <= this many levels ride a shallower
    # kernel; 0 disables.  split_min gates the second dispatch
    "tpu.short_depth": Field(4, int, lambda v: 0 <= v <= 64),
    "tpu.split_min": Field(256, int, lambda v: v >= 1),
    "tpu.mesh_shape": Field("dp=1,tp=1", str),
    "tpu.fail_open": Field(True, _bool),
    # serving tolerates up to this many un-synced router deltas before
    # prefetch skips the device (hints prove freshness per-topic)
    "tpu.max_stale_deltas": Field(256, int, lambda v: v >= 0),
    # publishes/s below which prefetch bypasses the device batching
    # window (host trie is faster at low concurrency); 0 disables
    "tpu.bypass_rate": Field(500.0, float, lambda v: v >= 0),
    "tpu.prefetch_timeout": Field(0.5, duration),

    # -- deadline-aware serve plane (broker/match_service.py) -------------
    # opt-in: replaces the fixed-window batch loop with the continuous-
    # batching deadline loop (partial dispatch when the oldest waiter's
    # budget nears expiry, arrival-rate-adaptive per-lane batch caps,
    # per-dispatch timeout with CPU-trie fallback, circuit breaker +
    # brownout ladder).  Off = the pre-deadline loop, byte-identical.
    "match.deadline.enable": Field(False, _bool),
    # per-prefetch latency budget in MILLISECONDS; default 41 = the
    # measured CPU-iso serve p99 (the reference's serve_cpu_iso.p99_ms) — the
    # device must beat the host path's tail to earn the traffic
    "match.deadline_ms": Field(41.0, float, lambda v: v > 0),
    # circuit breaker: consecutive device-dispatch failures (timeout or
    # raise) before the service trips into CPU-serve mode with the
    # match_degraded alarm; a supervised probe child closes it again
    "match.breaker.threshold": Field(5, int, lambda v: v >= 1),
    # cadence of the recovery probe while the breaker is open
    "match.breaker.probe_interval": Field(1.0, duration),
    # overlapped serve pipeline (broker/match_service.py): encode batch
    # N+1 in a worker thread while batch N computes on device (donated
    # input buffers), readback as a supervised match.readback child with
    # match-proportional two-phase d2h (counts vector first, then
    # exactly sum(counts) ids).  Off = the serial serve path,
    # byte-identical.
    "match.pipeline.enable": Field(False, _bool),
    # max device batches past dispatch awaiting readback (2 = classic
    # double buffering: one queued while one reads back)
    "match.pipeline.depth": Field(2, int, lambda v: v >= 1),
    # kernel backend for the device match (ops/join_match.py): "hash"
    # keeps the cuckoo-probe kernel (byte-identical default), "join"
    # serves every dispatch from the sorted-relation kernel (TrieJax
    # recast: searchsorted intersections, no bucket padding), "auto"
    # routes per shape from the measured autotuner pick table
    # "join-pallas" walks the same sorted relation with the fused
    # Pallas kernel (ops/pallas_match.py) — identical answer bits,
    # VMEM-resident tables; auto measures it alongside hash/join
    "match.backend": Field(
        "hash", _enum("hash", "join", "join-pallas", "auto")),
    # phase-2 readback transfer shape (broker/match_service.py):
    # "chunked" = pow2 binary decomposition (1+popcount(total) d2h
    # trips, zero padding bytes), "ragged" = ONE padded-to-capacity-
    # class transfer (exactly TWO trips per batch: meta + payload),
    # "auto" = ragged exactly when the total is not a power of two.
    # Capacity classes reuse the chunked (buffer, pow2) executables,
    # so flipping modes never grows the executable set.
    "match.readback.mode": Field(
        "chunked", _enum("chunked", "ragged", "auto")),
    # auto-mode crossover (effective only with match.readback.mode =
    # auto): ragged serves a non-pow2 total only when its padding slack
    # (capacity - total) stays <= auto_slack * total — 1.0 admits every
    # pow2-capacity class (the earlier heuristic, byte-identical); r06
    # tunes this down from measured link numbers without a code change
    # a slack is a padding FRACTION: values past 1.0 would admit every
    # capacity class and negative ones none — both misbehave only at
    # serve time, so reject them at load time instead
    "match.readback.auto_slack": Field(
        1.0, float, lambda v: 0.0 <= v <= 1.0),
    # autotuner (effective only with match.backend=auto): measure
    # hash-vs-join per (B, D, S, Hb) shape on recently served topics;
    # the pick table persists as checksummed JSON next to the XLA disk
    # cache when match.segments.enable is on (corrupt files rejected)
    "match.autotune.enable": Field(True, _bool),
    # timing repetitions per backend per shape (min is taken)
    "match.autotune.reps": Field(3, int, lambda v: 1 <= v <= 64),
    # multichip serve backend (parallel/multichip_serve.py): shard the
    # match table by topic-prefix over the dp×tp device mesh and serve
    # publish traffic from EVERY chip (8 chips hold 8x the filters;
    # bitmapless dense compact results ride the ring).  Off = the
    # single-chip serve path, byte-identical.
    "match.multichip.enable": Field(False, _bool),
    # tp (table-shard) axis width; 0 = auto — the widest pow2 <= 4 that
    # divides the device count; the remaining factor becomes dp
    "match.multichip.tp": Field(0, int, lambda v: v >= 0),
    # native (C++) shard subtables — per-shard capacity matches the
    # single-chip native table (10M filters); falls back to the Python
    # IncrementalNfa when the toolchain didn't build the .so
    "match.multichip.native": Field(True, _bool),
    # prefix-EP routed front end (parallel/prefix_ep.py promoted to
    # serving): publish rows all_to_all-route to the one shard owning
    # their root token, cutting per-shard batch width ~tp× on
    # literal-rooted tables.  Bucket overflow fails open to the CPU
    # trie.  Off = every shard walks the full batch (replicated fan).
    "match.multichip.ep.enable": Field(False, _bool),
    # per-(source, owner) bucket headroom over the uniform share
    # Bs/tp; per-shard processed width stays <= ceil(slack * B / tp)
    "match.multichip.ep.capacity_slack": Field(
        2.0, float, lambda v: v >= 1.0),
    # answer-segment slots reserved for the replicated wildcard-root
    # micro-table (merged behind the owning shard's own matches)
    "match.multichip.ep.micro_matches": Field(
        8, int, lambda v: 1 <= v <= 256),
    # count-compact the routed output on-mesh before d2h: the disjoint
    # per-shard segments psum-collapse from (B, tp·W) to (B, W), so
    # routed readback bytes drop ~tp× on literal-rooted tables.
    # Identical decoded rows (parity-gated); off = the earlier routed
    # segment layout, byte-identical.
    "match.multichip.ep.compact": Field(False, _bool),
    # routed overflow-rate EWMA threshold: a log-once warning (and the
    # tpu.match.ep_overflow_ewma gauge crossing it) flags a hot root
    # skewing one owner shard; 0 disables the warning
    "match.multichip.ep.overflow_warn": Field(
        0.5, float, lambda v: 0.0 <= v <= 1.0),
    # load-adaptive EP plane: capacity auto-resize keyed on
    # the overflow EWMA + popularity-aware shard placement staged at
    # compaction cadence.  Off = static crc32 placement and the fixed
    # capacity_slack grid, byte-identical.
    "match.multichip.ep.autotune.enable": Field(False, _bool),
    # overflow-EWMA level at which the bucket grid grows one pow2
    # capacity class (background compile first — no dispatch parks)
    "match.multichip.ep.autotune.grow_threshold": Field(
        0.05, float, lambda v: 0.0 < v <= 1.0),
    # hysteresis floor: the grid shrinks a class only after the EWMA
    # settles at/below this (and a cooldown of routed readbacks at the
    # current class passes); must sit below grow_threshold
    "match.multichip.ep.autotune.shrink_threshold": Field(
        0.01, float, lambda v: 0.0 <= v <= 1.0),
    # pow2 growth ceiling: capacity tops out at base << max_cap_class
    # (and never past the full source-slice width)
    "match.multichip.ep.autotune.max_cap_class": Field(
        3, int, lambda v: 0 <= v <= 8),
    # per-balance-pass budget of hot roots the greedy reassignment may
    # move off their crc32 shard (0 disables placement, resize only)
    "match.multichip.ep.autotune.max_moved_roots": Field(
        64, int, lambda v: 0 <= v <= 4096),
    # degraded-mesh serving: on shard death keep serving on
    # the survivors — EP-routed rows owned by the dead shard (and the
    # dead shard's replicated answer segment) divert to the CPU trie,
    # the micro-merge owner migrates off a dead shard 0, a supervised
    # mesh.rebuild child reconstructs the lost subtable and re-admits
    # it only after a bit-parity canary passes.  Off = ANY dead shard
    # fails the whole plane over (the earlier path, byte-identical).
    "match.multichip.degraded.enable": Field(False, _bool),
    # consecutive injected/observed match.shard failures before the
    # health ladder marks a shard dead (healthy → degraded(S))
    "match.multichip.degraded.fail_threshold": Field(
        3, int, lambda v: v >= 1),

    # -- streaming table lifecycle (broker/match_service.py) --------------
    # opt-in: cold start from persistent compacted segments + background
    # delta compaction with atomic swap + dirty-region device upload +
    # padded-shape kernel compile cache.  Off = the rebuild lifecycle,
    # byte-identical to the pre-segments path.
    "match.segments.enable": Field(False, _bool),
    # segment directory; empty = "<node.data_dir or data>/segments"
    "match.segments.dir": Field("", str),
    # background compaction cadence and the mutation count below which a
    # cycle is skipped (as long as a segment already exists on disk)
    "match.segments.compact_interval": Field(30.0, duration),
    "match.segments.compact_min_mutations": Field(
        1024, int, lambda v: v >= 1),
    # dirty fraction (dirty rows / total rows) above which one
    # contiguous full upload beats the scatter path on a resize
    "match.segments.dirty_threshold": Field(
        0.5, float, lambda v: 0.0 < v <= 1.0),
    # pre-compile the next pow2 table shapes in the background before
    # growth reaches them (the resize then serves from the cache)
    "match.segments.prewarm": Field(True, _bool),
    # persistent XLA compilation cache under "<segments dir>/xla_cache"
    # (effective only with match.segments.enable): even the FIRST
    # cold-start compile after a process restart is a disk hit
    "match.segments.xla_cache": Field(True, _bool),
}


# ---------------------------------------------------------------------------
# HOCON-subset parser

_TOKEN = re.compile(
    r"""
    (?P<ws>[ \t\r,]+)
  | (?P<comment>(\#|//)[^\n]*)
  | (?P<nl>\n)
  | (?P<lbrace>\{) | (?P<rbrace>\})
  | (?P<lbrack>\[) | (?P<rbrack>\])
  | (?P<eq>=|:)
  | (?P<str>"(?:[^"\\]|\\.)*")
  | (?P<bare>[^\s=:{}\[\],\#]+)
    """,
    re.X,
)


def _tokens(text: str):
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise ValueError(f"hocon: bad char at offset {pos}: {text[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        yield kind, m.group()
    yield "eof", ""


def _scalar(tok: str) -> Any:
    if tok.startswith('"'):
        return tok[1:-1].encode().decode("unicode_escape")
    low = tok.lower()
    if low in ("true", "on"):
        return True
    if low in ("false", "off"):
        return False
    if low in ("null", "undefined"):
        return None
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok  # bare string (incl. durations/sizes — coerced by schema)


def parse_hocon(text: str) -> Dict[str, Any]:
    """Parse the HOCON subset into a nested dict."""
    toks = list(_tokens(text))
    i = 0

    def peek():
        return toks[i]

    def take(kind=None):
        nonlocal i
        k, v = toks[i]
        if kind is not None and k != kind:
            raise ValueError(f"hocon: expected {kind}, got {k} {v!r}")
        i += 1
        return v

    def skip_nl():
        nonlocal i
        while toks[i][0] == "nl":
            i += 1

    def parse_value():
        skip_nl()
        k, v = peek()
        if k == "lbrace":
            return parse_obj(braced=True)
        if k == "lbrack":
            take("lbrack")
            items = []
            while True:
                skip_nl()
                if peek()[0] == "rbrack":
                    take("rbrack")
                    return items
                items.append(parse_value())
        if k in ("str", "bare"):
            return _scalar(take())
        raise ValueError(f"hocon: unexpected {k} {v!r}")

    def parse_obj(braced: bool) -> Dict[str, Any]:
        if braced:
            take("lbrace")
        out: Dict[str, Any] = {}
        while True:
            skip_nl()
            k, v = peek()
            if braced and k == "rbrace":
                take("rbrace")
                return out
            if k == "eof":
                if braced:
                    raise ValueError("hocon: unclosed '{'")
                return out
            if k not in ("str", "bare"):
                raise ValueError(f"hocon: expected key, got {k} {v!r}")
            key = take()
            if key.startswith('"'):
                key = key[1:-1]
            skip_nl() if peek()[0] == "nl" else None
            if peek()[0] == "eq":
                take("eq")
                val = parse_value()
            elif peek()[0] == "lbrace":
                val = parse_obj(braced=True)
            else:
                raise ValueError(f"hocon: key {key!r} missing value")
            # dotted keys nest; later keys deep-merge over earlier ones
            node = out
            parts = key.split(".")
            for p in parts[:-1]:
                nxt = node.get(p)
                if not isinstance(nxt, dict):
                    nxt = node[p] = {}
                node = nxt
            leaf = parts[-1]
            if isinstance(val, dict) and isinstance(node.get(leaf), dict):
                _deep_merge(node[leaf], val)
            else:
                node[leaf] = val

    return parse_obj(braced=False)


def _deep_merge(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v


def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        p = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, p + "."))
        else:
            out[p] = v
    return out


# ---------------------------------------------------------------------------
# the layered config store

class Config:
    """Layered typed config with zones and hot-update handlers.

    Layers (low → high precedence): schema defaults, file, environment
    (``EMQX_A__B__C``), runtime ``put`` calls.  ``zone(name)`` returns a
    view where ``zones.<name>.<key>`` overrides the global ``<key>`` — the
    reference's per-listener zone mechanism.
    """

    ENV_PREFIX = "EMQX_"

    def __init__(
        self,
        file_text: Optional[str] = None,
        env: Optional[Dict[str, str]] = None,
        schema: Optional[Dict[str, Field]] = None,
        strict: bool = True,
    ) -> None:
        self.schema = schema if schema is not None else SCHEMA
        self._values: Dict[str, Any] = {
            p: copy.deepcopy(f.default) for p, f in self.schema.items()
        }
        self._zones: Dict[str, Dict[str, Any]] = {}
        self._handlers: List[Tuple[str, Callable[[str, Any, Any], None]]] = []
        # runtime (hot-update) layer: what `put` changed since boot — the
        # part of config that cluster sync replicates and joiners adopt
        self._runtime: Dict[str, Any] = {}
        if file_text:
            self.load_dict(parse_hocon(file_text), strict=strict)
        self.load_env(env if env is not None else dict(os.environ))

    # -- loading -----------------------------------------------------------

    def load_dict(self, data: Dict[str, Any], strict: bool = True) -> None:
        for path, raw in _flatten(data).items():
            if path.startswith("zones."):
                _, zone, key = path.split(".", 2)
                self._set_zone(zone, key, raw, strict)
                continue
            if path not in self.schema:
                if strict:
                    raise ValueError(f"unknown config key {path!r}")
                continue
            self._values[path] = self.schema[path].coerce(path, raw)

    def load_env(self, env: Dict[str, str]) -> None:
        for name, raw in env.items():
            if not name.startswith(self.ENV_PREFIX):
                continue
            path = name[len(self.ENV_PREFIX):].lower().replace("__", ".")
            if path in self.schema:
                self._values[path] = self.schema[path].coerce(path, _scalar(raw))

    def _set_zone(self, zone: str, key: str, raw: Any, strict: bool) -> None:
        if key not in self.schema:
            if strict:
                raise ValueError(f"unknown zone key {key!r}")
            return
        self._zones.setdefault(zone, {})[key] = self.schema[key].coerce(
            f"zones.{zone}.{key}", raw
        )

    # -- reads -------------------------------------------------------------

    def get(self, path: str, default: Any = None) -> Any:
        if path in self._values:
            return self._values[path]
        if default is not None or path not in self.schema:
            return default
        return self.schema[path].default

    def __getitem__(self, path: str) -> Any:
        return self._values[path]

    def zone(self, name: Optional[str]) -> "ZoneView":
        return ZoneView(self, self._zones.get(name or "", {}))

    def all(self) -> Dict[str, Any]:
        return dict(self._values)

    # -- hot update (emqx_config_handler analog) ---------------------------

    def on_update(
        self, prefix: str, fn: Callable[[str, Any, Any], None]
    ) -> None:
        """Register ``fn(path, old, new)`` for keys under ``prefix``."""
        self._handlers.append((prefix, fn))

    def remove_handler(self, fn: Callable[[str, Any, Any], None]) -> bool:
        """Unregister a hot-update handler (all prefixes).  Equality, not
        identity: bound methods are fresh objects per attribute access,
        and ``==`` compares (__self__, __func__)."""
        before = len(self._handlers)
        self._handlers = [(p, f) for p, f in self._handlers if f != fn]
        return len(self._handlers) != before

    def put(self, path: str, raw: Any) -> Any:
        """Validated runtime update; handlers run after the value lands.
        A handler raising rolls the value back (two-phase, like the
        reference's pre-config-update checks)."""
        if path not in self.schema:
            raise ValueError(f"unknown config key {path!r}")
        new = self.schema[path].coerce(path, raw)
        old = self._values[path]
        self._values[path] = new
        try:
            for prefix, fn in self._handlers:
                if path.startswith(prefix):
                    fn(path, old, new)
        except Exception:
            self._values[path] = old
            raise
        self._runtime[path] = new
        return new

    def runtime_overrides(self) -> Dict[str, Any]:
        """Hot-updated keys and their current values (cluster sync)."""
        return dict(self._runtime)


class ZoneView:
    """Read view with zone overrides applied (reference: zone config)."""

    __slots__ = ("_cfg", "_over")

    def __init__(self, cfg: Config, over: Dict[str, Any]) -> None:
        self._cfg = cfg
        self._over = over

    def get(self, path: str, default: Any = None) -> Any:
        if path in self._over:
            return self._over[path]
        return self._cfg.get(path, default)
