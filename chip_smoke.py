#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``emqx_tpu_torch``) on one GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``emqx_tpu_torch/ops/csrc`` and
its native host libraries from ``emqx_tpu_torch/native``, and runs these
phases, one JSON line each; any failure exits non-zero:

1. device  — the card's name and power limit;
2. build   — ``nvcc`` of every kernel source (all started together),
   with each one's register and spill report, and ``g++`` of the native
   table and encoder beside them;
3. kernel  — each walk kernel (hash: ``nfa_walk``; join:
   ``nfa_join_walk``) against its plain PyTorch version on the card, bit
   for bit on the raw accept slots and the spill counts, for D in
   {4, 8, 16} at A=16, D=8 at A in {1, 2, 32} and D=16 at A=12 (one
   lane per slot: a single lane a row, a power of two not filled, a
   whole warp a row), B in {64, 1000, 2048} (1000 fills no whole number
   of blocks); the A=1, 2 and 12 cases must spill.  The join relation
   is first churned through a ``DeviceNfa`` with its mirror on, so it
   holds tombstones and overlay rows.  Then ``nfa_match`` and
   ``join_match`` in flat mode on the card against the same calls on the
   CPU, all five ``MatchResult`` fields equal; the flat mode of both
   walks (the flat epilogue, K3, fused into the walk kernels: one launch
   a flat match) against the plain walk and ``flat_epilogue_plain`` on
   the same card tensors, all five fields bit for bit, at (D, A) =
   (16, 16), (8, 16), (4, 16), (8, 32) and (8, 1) with K 4, 32 and 128,
   B 2048, 1000 and 1, each at a roomy cap, a cap at every id, a cap that
   cuts a row and drops the later ones, and a cap of one id (360
   calls); one batch of B = 65,536 (8,192 blocks, more than the card
   holds at once, so later tiles' look-backs wait) with a join and a
   hash match on a second stream at the same time; then dense_kernel: the
   frontier-sparse dense walk (``dense_walk.cu``, K6) against
   ``dense_match_plain``,
   every field bit for bit, on ``bench_dense``'s table (B = 4096, D = 8,
   K = 64; timed rotating over four batches, L2 flushed and warm, the
   plain twin from a CUDA graph replay, with its bound), random 0/1
   tables at S = 128, 512 and 4096 (several parents a column) and a
   batch of ``$`` topics with rows past K;
4. slice   — the serve core (``MatchService``, ``table="native"``: the
   C++ host table started with one ``load``) over 1M wildcard filters
   of the BASELINE config-2 workload: 16 batches of 2048 topics through
   ``serve()``, each answer equal to the ``FilterTrie`` oracle; then
   1,000 removes and 1,000 adds written into the resident tables in place,
   and 4 more batches re-checked.  The kernel's launch count over this
   main path must equal the walk dispatches, and the native encoder
   must have encoded every dispatch;
5. times   — kernel device ms at (B=2048, D=16) and (B=2048, D=4) from
   CUDA events, three ways: rotating over the distinct batches of the
   served topics (``ms``, as the serve path walks them), the same with
   the L2 flushed before each launch (``ms_cold``), and one batch
   repeated (``ms_warm``, tables' rows L2-resident); the plain version's
   device ms from a CUDA graph replay; the kernel's bytes bound on this
   run's data; the same readings of the flat match (the walk's flat
   kernel, K3 fused; K = 128, flat_cap = 8·B) on those batches, the raw
   walk in turns with it on the same batches (K3's own cost is the
   difference), its plain version (the plain walk and the torch-ops
   epilogue) from a CUDA graph replay, and on the hash path also at the
   exhook sidecar's D = 8; the serve stage breakdown (with
   the ids the split stage turned into filters); serve throughput with p50/p99 over 100 timed
   ``serve()`` calls of 2048 topics (``TIMED_BATCHES``); the card's busy and idle share over
   20 ``serve()`` calls from a ``torch.profiler`` trace; table bytes and
   the spill share of the main path;
6. slice_join — the hash service is dropped, and a native-table
   ``MatchService`` on the ``join`` backend serves the same 1M filters:
   16 batches against the oracle; a churn whose new edges fit the
   relation's overlay (written in place, no relation rebuild) and 2
   batches; 1,000 removes and 1,000 adds, which overflow the overlay
   (one relation rebuild, no table re-upload without growth) and 4
   batches.  Join-kernel launches over this path must equal its join
   dispatches, and the hash kernel must not launch on it;
   multichip — after times, on phase 4's service: its 1M filters and
   accept ids sharded into a ``MultichipMatcher`` on ``[cuda:0] * 4``
   (tp = 4, dp = 1, native shard tables); 20 batches of 2048 served
   topics in each form (replicated, routed, routed+compact; default
   slack), every row (spilled rows re-run on the host) equal to the
   oracle (with phase 4's churn) and to the single-card flat path, each
   row the mesh answered equal to the flat path's; the step with the
   kernels (the hash walk in raw mode and the routing grid and merge of
   ``ep_route.cu``) equal to the step with their plain versions on every
   field for 2 batches a form; 2·tp walk launches, one ``ep_route`` on a
   routed dispatch and one ``ep_merge`` on every dispatch; at most 2·tp
   + 8 device operations a dispatch (a ``torch.profiler`` trace); the
   step's device ms (CUDA events on the mesh stream), the dispatch's
   host ms, readback bytes a batch, spilled rows, the bytes bound (the
   walks' gathered table rows, the batch, the grid, the outputs), each
   route kernel alone on the form's own operands against its plain
   version and bound, the shards' filters and states;
   multichip_fanout — the fan-out library (K8b-K8f) on that service's
   table: its 1M filters as 1M subscriptions of 10,000 clients (filter
   i to client i % 10,000), the ``(F+1, 316)`` accept bitmap built on
   the card; on ``[cuda:0] * 4`` meshes, 5 batches of 2048 through the
   sharded matcher and its compact twin (tp 4, cap 64), the ``$share``
   selector (16 groups of seed 7, the last empty), the ring and its
   compact twin (ring 4), the EP matcher (ep 4 over native partitions of
   the filters: its grid and merge the kernels of ``ep_route.cu``, one
   launch each a dispatch, at most 2·E + 8 device operations a dispatch,
   the kernel step against the plain step in turns, each route kernel
   alone) and the Ulysses step with the unreshard: each step's
   launches of the walk and of the four bitmap kernels
   (``bitmap_fanout.cu``: ``accept_or``, ``bitmap_compact``,
   ``group_count``, ``group_pick``) as it states them, each equal to its
   plain build on every field for 2 batches, every unflagged row equal
   to the trie oracle; each step's device and host ms a dispatch, each
   kernel alone at the served shape (rotating, L2 flushed) with its
   bound and its plain version's ms; then dryrun_multichip — the
   reference's dry run of every step on ``[cuda:0] * 4``;
7. times_join — phase 5's readings for the join kernel and service
   (phases 4 and 6 and multichip share one 1M workload and its trie
   oracle, built once: each phase undoes its churn in the oracle);

then the exhook boundary, each sidecar in a spawned child
process that calls ``serve()``, as in a deployment, its counters and
walk launches read over a pipe:

* exhook_sidecar — the first 250k of BASELINE config 2's 1M filters
  (with their own trie oracle) through the sidecar's
  defaults (depth 8, A = 16, K = ``tpu.max_matches``, ``annotate``):
  ``OnProviderLoaded``, ``InstallSnapshot`` in chunks of 1,024 (the
  seconds to the ack and to a synced mirror; filters, aliases, states,
  table bytes); 20 ``MatchBatch`` calls of 2048 topics (topics/s, the
  RPC's p50/p99, the sidecar's batch p50/p99, every row against the
  oracle, the rows re-run on spill); 8,192 ``OnMessagePublish`` calls
  at 256 in flight, each ``matched_filters`` header against the
  oracle's count (calls/s, the mean micro-batch); ``ApplyDeltas`` of
  1,000 removes and 1,000 adds (seconds until a ``MatchBatch`` answers
  with them, 0 mismatches, no whole upload without growth).  No row
  served by the host beside spills, no failed sync, and walk launches
  equal to the device batches plus the warm-up;
* exhook_node — the port's ``BrokerNode`` (``tpu.enable=false``,
  ``exhook.servers`` naming a sidecar that is not up yet); 100 MQTT
  clients (one fleet process) subscribe 100 filters each at QoS 1;
  then the sidecar starts, the reconnect loop loads it and pushes the
  snapshot, and its mirror must equal the node's filter set; 100
  subscribes and 100 unsubscribes follow through the hooks; 3 × 2048
  QoS 1 publishes, each riding an ``OnMessagePublish`` round trip: every
  delivery owed arrives once, the sidecar matched every publish with
  no host row; PUBACKed publishes/s and publish → PUBACK p50/p99;
* exhook_checkpoint — a sidecar with ``checkpoint_path`` installs the
  Python table's 50k filters and writes its checkpoint; a new sidecar
  process restores it at start: the seconds to the first
  ``MatchBatch`` served by the card after each, 0 mismatches;
8. slice_python — phase 4 on the Python ``IncrementalNfa`` table (the
   reference's debug twin) at 100k filters (its serve stages and
   ``split_per_id`` were cut to fit the later phases); then
   python_segments: a
   ``state`` segment of that table written, loaded and restored (the
   seconds against the table's build, the arrays equal), and the
   restored table, in region mode on a ``DeviceNfa`` of its own, grown
   through a cuckoo rehash: ``grow_applies`` ≥ 1, no whole upload, the
   node, edge and seed tensors bit-equal to a whole upload of the same
   host table, and a walk on each equal;
9. slice_10m_build — BASELINE config 3: 10M filters (seed 0, depth-8
   Zipfian; generated in a spawned child process started before phase
   4, while the earlier phases run) started with ``load`` on
   ``table="auto"`` (native), the join mirror enabled on the same
   ``DeviceNfa``, and the ``FilterSet`` oracle built after the table;
   seconds of each step and the sizes;
10. slice_10m — 16 batches served on ``hash`` and on ``join`` from the
   one table, each topic equal to the oracle; 1,000 removes (synced),
   then 1,000 adds that reuse freed accept ids (synced); 4 more batches
   on both.  Launches of each kernel must equal its dispatches, and the
   native encoder must have encoded every batch;
11. times_10m — phase 5's readings at 10M, once for each kernel (a
   fifth of the timed ``serve()`` calls).

Every phase that counts walk launches also reads the flat epilogue's
(zeroed with them): on a serve path they equal the walk launches of
both backends, on a compact or raw path (``acl_batch``, ``tiered``,
``retained_replay``) they are 0.

Between phases 8 and 9 it drives the broker's own publish path
(after ``slice_node``, the table lifecycle and the deadline plane:
``segments_1m``, ``slice_node_deadline``, ``deadline_faults``, below):

* slice_node_build — BASELINE config 2 through ``Broker.subscribe``:
  the 1M filters (seed 0) shared out to 10,000 clients, a
  ``MatchService`` with the node defaults (``table=auto``, ``hash``,
  window 0.2 ms, batch 2048, ``bypass_rate`` 500, ``hint_cap`` 65536)
  started on the broker, ``broker.device_match = ms.hint_routes`` and a
  counting ``on_deliver``; the subscribe seconds, the router trie's
  nodes, the seconds from ``start()`` to ready (bootstrap, upload and
  the warm-up that builds the kernels) and the table sizes;
* slice_node — 2048 publisher tasks take the workload's Zipfian topic
  stream in turn, each ``await ms.prefetch(topic)`` then
  ``broker.publish``: 4 × 2048 publishes of warm-up, then 5 × 2048
  timed while a churn subscribes 1,000 fresh filters and unsubscribes
  1,000 others through the broker, 100 of each a second whatever the
  service's state (the relation rebuilds it causes are counted).  Every route list a hint gave equals
  ``router.match_routes`` of that moment; no device batch failed (a
  batch refused for an accept id reused in flight is counted apart), no
  prefetch timed out, launches equal dispatches, hints served at least
  half the timed publishes.  Publishes/s, p50/p99 (each less its route
  check), the shares of the publishes, batch sizes and rate, the
  collector's pauses, the card's busy share over 5 × 2048 more
  publishes (``torch.profiler``), and the same timed publishes on the
  host trie alone (``device_match = None``, no prefetch);
* segments_1m — the slice_node service stopped; a service with
  ``segments`` (native table, so a ``filters`` segment, pipelined so
  that slots are in flight) started with no segment yet, then one
  ``_compact_once`` under storms of 2048 publishers and a churn of 100
  subscribes and 100 unsubscribes a second for as long as the build
  runs, two storms after: the build seconds, the segment's bytes, the
  swap step's ms on the loop, the loop's largest gap (a heartbeat
  task), each build step's seconds with the largest gap overlapping
  it, the collections on the build thread, 0 prefetch timeouts, the
  slots in flight at the swap and those the table
  generation discarded, the accept-id high-water mark before and after,
  the fresh twin holding no freed id, 0 route mismatches, launches
  equal dispatches; then 1,000 more mutations and a new service that
  cold-starts from the segment (seconds to ready, ``segment_load_s``,
  0 mismatches over 2 × 2048 publishes) beside a rebuild from the same
  router (the next phase's service: seconds to ready);
* slice_node_deadline — that service with ``deadline=True`` (node
  defaults: 41 ms budget, dispatch timeout 0.164 s, breaker 5, probe 1
  s; ``alarms``, a flight recorder writing to
  ``trace/chip_smoke_flightrec/`` and a supervisor), the
  slice_node storm (2 × 2048 warm-up, the timed batches, the churn):
  publishes/s, each prefetch's wait p50/p99 against the budget,
  ``deadline_dispatch``, the batch sizes, 0 route mismatches, and with
  no fault 0 breaker trips, dispatch timeouts, failed and host-served
  batches; slice_node's numbers of the same run beside;
* deadline_faults — (a) ``match.dispatch`` raising for 5 batches of
  storms of new topics: the breaker opens once with ``match_degraded`` raised, one
  ``breaker_trip`` dump, the host serving with 0 mismatches, and the
  probe closing it within 2 probe intervals (+ the timeout) of the
  faults' end, the seconds printed; (b) ``torch.cuda._sleep`` of ~0.6 s
  enqueued on the serving stream, then a batch of 512 new topics: it is
  answered by the host within the timeout + the budget + 0.15 s, a
  batch behind it times out too, a heartbeat task keeps beating (the
  largest gap under 50 ms); once the sleep ends, the next batches are
  answered by the card with the router's routes, and none of them was
  handed a buffer of a timed-out batch (kept referenced meanwhile);
  launches equal dispatches plus the probes' walks;
* slice_node_auto — the service stopped and freed, a ``backend="auto"``
  one started on the same broker, the same storm with another churn:
  the tuner's picks per shape with each backend's measured µs (each
  the device time of one flat match, under 1 ms), the join dispatches, and the same checks (launches equal the
  dispatches plus the tuner's measurement walks);
* slice_node_multichip — a node-default service with
  ``match.multichip.enable`` (tp = 4, ``device = [cuda:0] * 4``) on the
  same broker: 2 × 2048 warm-up and 5 × 2048 timed publishes with a
  churn beside, the same checks with 2·tp launches a dispatch and
  ``tpu.match.shard_dispatches`` equal to the dispatches; then one
  batch with shard 1 killed: it fails over to the host trie (a
  failover, no dispatch through the mesh) and every route owed is
  delivered;
* slice_node_fanout, slice_node_pipeline, slice_node_fanout_host — the
  batched fanout (``FanoutPipeline`` at the reference node's
  ``broker.fanout.*`` defaults) on the same broker, each with its own
  churn of 100 subscribes and 100 unsubscribes a second: fed by a fresh
  node-default hash ``MatchService`` (``chunked``, pipeline off); by one
  with ``pipeline=True``, depth 2 and ``readback_mode="auto"``; and by
  none (the host trie alone).  2048 publisher tasks each offer one
  message and await its delivery (the chunk that emitted its last leg,
  or dropped it, has run), or publish it through ``Broker.publish``
  when the pipeline refuses; the same warm-up and timed counts as
  slice_node.  Publishes/s, deliveries/s, p50/p99 offer to delivered,
  fanout batches, ``prefetch_many`` calls, device batches, the hint
  share of the route lookups (all hints, and those the card answered),
  readback bytes a batch beside 4·(B + Σcounts), the round trips, the
  most pipelined slots in flight, the accept ids reused and grown, the
  card's busy share (profiled storm) and the collector.  Each fails
  on a route that differs from the router's, a failed batch or timed
  out prefetch, a batch refused as stale or any waiter answered by the
  host tables, a message neither delivered nor dropped, launches other
  than the dispatches, fewer than half the route lookups answered by
  the card's hints, or a readback other than its byte contract (the
  slab on the fixed-window ``chunked`` path, else 4·(B + the ids the
  reference's rule copies), each copy's size checked too).

Last on that broker, BASELINE config 3's co-batched rules:

* slice_node_rules — 1,000 rules from the port's
  ``RuleEngine.create_rule`` (``_rule_set``: FROM filters of the
  workload generator with their own seed, about half of them routing
  filters too, every tenth rule two; ``WHERE payload.temp >
  <threshold>``; each records its outputs, ten also republish to one
  subscriber), the engine attached to a fresh node-default hash service
  (the rule filters co-batched into the walk's table), then the
  slice_node storm with a JSON payload of seeded ``temp`` on every
  publish and a churn beside it.  Every rule-id list ``hint_rules``
  gave equals the host trie of the rule filters, every republished
  message reaches the subscriber once, 0 route mismatches, failed
  batches and timeouts, launches equal dispatches, ``hint_rules``
  serves at least half the publishes; publishes/s, p50/p99, the
  ``hint_rules`` shares and the card's busy share are printed;
* slice_node_rules_host — the engine detached from the service (the
  rules found in the engine's host trie of the rule filters), the same timed
  publishes with no warm-up and no churn: every rule's counters, the
  outputs it recorded and the republished messages equal
  slice_node_rules'.

Then ``acl_batch``: 1,000 static ACL rules (a ``FileSource`` and a
``BuiltinDbSource``'s global rows) compiled by ``compile_acl_batch``;
``batch_authorize`` walks 4 × 2048 Zipfian topics on the card for
``publish`` and for ``subscribe``, every verdict equal to the host
``Authz`` pipeline's, one launch a batch.  Phase 10 registers the same
rules in the 10M table before its churn, and ``slice_10m_rules`` holds
the rule ids of 4 × 2048 topics (``serve_split``) to the host trie of
the rule filters.

After ``acl_batch``, the hot tier and the retained replay (PR 10):

* tiered — ``bench_tiered``'s workload at half its cold size (seed 5:
  100,000 cold draws + 320 hot filters, 5,000 cold and 40 hot roots, B = 8192,
  D = 8, hot_mass 0.8): ``TieredMatcher(hot_engine="auto")`` on the card
  (one dense and one hash launch a batch) against a host
  ``FilterTrie``, 0 mismatches; the rows the host served; the hot
  tier's roots, states, S and filters; the whole table's hash walk
  timed beside the tiered pair; ``fused_tiered_match`` equal, field for
  field, to the two calls made apart, with ``torch.cuda``'s sync debug
  mode set to raise inside it; the dense kernel timed at the matcher's
  hot shape (four batches of the same stream), as dense_kernel;
* retained_replay — BASELINE config 5 cut to 50,000 retained names
  (the first distinct topics of the workload generator, seed 0) and
  50,000 new filters: ``Retainer.replay_batch`` on the card, one walk,
  no filter served by the host walk, each filter's topics equal to the
  inverse of a host ``FilterTrie``'s per-name matches.

Then it drives the port's MQTT front door over TCP:

* slice_mqtt_fleet — 7,500 MQTT clients (the port's client) in
  ``MQTT_PROCS`` child processes (spawned), and 100 churn clients; each
  process raises its RLIMIT_NOFILE soft limit to the hard one;
* slice_mqtt — the port's ``BrokerNode`` at the reference's node
  defaults (``tpu.enable``, ``tpu.table=auto``, ``match.backend=hash``,
  the fast-path TCP listener, fanout off) on 127.0.0.1:0, started
  empty; the fleet connects and each client subscribes its 100 of the 750k
  filters in one SUBSCRIBE at QoS 1; the seconds from the last
  SUBACK until the mirror routes all of them (the service freezes the
  heap as the mirror grows); then ``MQTT_PUBLISHERS``
  of the clients publish the Zipfian stream at QoS 1, each awaiting its
  PUBACK, with the time of sending in the payload: ``MQTT_WARM`` × 2048
  warm-up, the timed storm (``MQTT_STORM`` × 2048) with a churn of 100 subscribes and 100 unsubscribes a second
  from the churn clients, a profiled storm, and the timed storm again
  through the host trie (the match service stopped,
  ``device_match = None``).  Each storm prints PUBACKed publishes/s,
  p50/p99 of publish → PUBACK and publish → delivered, the deliveries
  checked against ``Router.match_routes`` (every message once per
  matching filter of each fleet client, delivered or dropped by a full
  mqueue: 0 missing, duplicate or extra), the ``tpu.match.*`` and drop
  counters (the ``queue_full`` drops, each recorded with its client; 0
  other drops beside no_subscribers), the device-hint share of the
  route lookups (≥ 1/2), walk launches against the service's dispatches (equal), the batches,
  the collector, the broker's and each client process's CPU;
* slice_mqtt_fanout — the same on a second node with
  ``broker.fanout.enable`` (the batched stack: fanout, ack and write
  coalescing, timer wheel), with its own host-trie storm.

Each phase's line carries its wall seconds.
The line before the last names every kernel with its numbers (and its
launch shape, ``ptxas`` register count, launches on each path, the
exhook paths' among them, and its 10M readings; the dense walk's at the
tiered hot shape, with ``bench_dense``'s beside; the flat epilogue's on
the 1M hash walks at D = 16, its other shapes beside; the four bitmap
kernels' at multichip_fanout's served shape; ``ep_route`` and
``ep_merge`` at multichip's routed form, each other form's and EP's
beside); the last line is
``{"ok": true, "device": {...}}``.
With no CUDA device the script prints no result and exits 2.
``--rehearse-cpu`` runs phases 4-11, the slice_node, tiered,
retained_replay and slice_mqtt phases on the CPU with the plain versions
(give it small ``--filters``, ``--python-filters``, ``--large-filters``,
``--timed-batches``, ``--storm-batches``, ``--mqtt-clients``,
``--tiered-filters`` and ``--replay-size``) and prints no result either
(a dry run of the control flow).
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import logging
import os
import re
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List

import numpy as np

BATCH = 2048
SERVE_BATCHES = 16          # batches served before the churn
CHURN = 1000                # filters removed, then added
AFTER_BATCHES = 4           # batches served after the churn
TIMED_BATCHES = 100         # serve() calls timed for p50/p99 (phase 5)
PYTHON_FILTERS = 100_000    # slice_python: the Python table's size
LARGE_FILTERS = 10_000_000  # slice_10m: BASELINE config 3
BATCHES_10M = 20            # 10M batches served on each backend ...
AFTER_BATCHES_10M = 4       # ... the last of them after the churn
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
SMALL_CHURN = (100, 40)     # join path: removes, adds within the overlay
JOIN_SMALL_BATCHES = 2      # join path: batches served after SMALL_CHURN
SESSIONS = 10_000           # slice_node: clients, each with an equal share
STORM_TASKS = 2048          # slice_node: concurrent publishers (one batch)
WARM_STORM = 4              # slice_node: warm-up publishes, in batches ...
STORM_BATCHES = 5           # ... and timed publishes, in batches of 2048
BUSY_BATCHES = 5            # slice_node: publishes under torch.profiler
NODE_CHURN = 1000           # slice_node: subscribes and unsubscribes ...
NODE_CHURN_RATE = 100.0     # ... of each a second, on the wall clock
CHURN_CLIENTS = 100         # slice_mqtt: the churn's own clients
#: slice_mqtt: the QoS of the fleet's subscriptions.  At QoS 1 the
#: hottest client (L0w0/#, 48% of the stream) overflows the node
#: default mqueue of 1,000 behind its inflight window of 32, which
#: refills once a round of the loop: those queue_full drops are the
#: reference's semantics, recorded with their clients (``_DropTap``)
#: and held out of the deliveries owed.
SUB_QOS = 1
#: slice_mqtt: the closed-loop QoS 1 publishers (one batch of topics)
MQTT_PUBLISHERS = 2048
#: slice_mqtt: warm-up, timed and profiled publishes, in batches of
#: 2048 (the node's loop runs ~1k publishes/s: fewer than slice_node's,
#: to fit the call's limit)
MQTT_WARM = 2
#: the longest wait for a storm's trailing deliveries, and the bound on
#: the seconds from its last PUBACK to its last delivery: the fanout
#: node acks at the offer, and its deliveries have trailed by up to
#: 28.4 s on a slow host (7-20 s on others); a backlog that keeps
#: growing fails here
DRAIN_MAX_S = 40.0
DELIVERY_TRAIL_MAX_S = 40.0
MQTT_STORM = 5
MQTT_BUSY = 2
#: slice_mqtt: the fleet's clients and the workload's filters they hold,
#: 100 a client (cut from 10,000 x 1M to fit the call's limit)
MQTT_CLIENTS = 7_500
MQTT_FILTERS = 750_000
MQTT_PROCS = 6              # slice_mqtt: the fleet's child processes
NODE_LOGGER = "emqx_tpu_torch.broker.match_service"
FANOUT_LOGGER = "emqx_tpu_torch.broker.fanout"
#: the reference node's broker.fanout.* defaults (emqx_tpu/config.py:141-157)
FANOUT_KW = dict(max_batch=2048, min_batch=8, window_s=0.0005,
                 adapt_window_s=0.05, bypass_rate=0.0, queue_cap=65536,
                 shape_routes=1.25, shape_probe_s=0.25)
#: the fanout phases: name, the match service's arguments (None: no
#: service, the host trie alone) and the seed of the churn beside them
FANOUT_PHASES = (
    ("slice_node_fanout", {}, 13),
    ("slice_node_pipeline", {"pipeline": True, "pipeline_depth": 2,
                             "readback_mode": "auto"}, 14),
    ("slice_node_fanout_host", None, 15),
)
#: slice_node_rules: BASELINE config 3's co-batched rule set on the 1M
#: broker: RULES rules from RuleEngine.create_rule, each with one FROM
#: filter drawn by the workload generator with its own seed (every tenth
#: a second one), a WHERE on the payload's temp against a seeded
#: threshold and a recording action; RULE_REPUBLISH of them also
#: republish to RULE_SINK's subscription: those ranked from
#: RULE_REPUBLISH_RANK on by their matches in the timed stream (hot
#: rules: ~1,500 republishes a storm).  A republished message is never
#: prefetched, so the engine finds its rules in its host trie of the
#: rule filters.
RULES = 1000
RULE_SEED = 21
RULE_REPUBLISH = 10
RULE_REPUBLISH_RANK = 40
RULE_SINK = "rule_sink"
RULE_CHURN_SEED = 16            # the device storm's churn
RULE_HOST_BUSY = 1              # host storm: profiled batches of 2048
RULE_BATCHES_10M = 4            # slice_10m_rules: batches of 2048 checked
#: acl_batch: static ACL rules (a FileSource, and a BuiltinDbSource with
#: global rows only) over ACL_BATCHES batches of 2048 topics
ACL_RULES = 1000
ACL_DB_RULES = 100
ACL_BATCHES = 4
ACL_SEED = 31
#: name, source and replaced TPU kernel of each walk kernel
KERNELS = {
    "hash": ("nfa_walk", "emqx_tpu_torch/ops/csrc/nfa_walk.cu",
             "emqx_tpu/ops/pallas_match.py:119"),
    "join": ("nfa_join_walk", "emqx_tpu_torch/ops/csrc/nfa_join_walk.cu",
             "emqx_tpu/ops/pallas_match.py:146"),
}
#: the dense walk (K6): its source and the reference function it replaces
DENSE_KERNEL = ("dense_walk", "emqx_tpu_torch/ops/csrc/dense_walk.cu",
                "emqx_tpu/ops/dense_match.py:116")
DENSE_K = 64                # bench_dense's and the tiered matcher's K
DENSE_BATCHES = 4           # distinct batches a dense timing rotates over
#: (S, parents a column) of the random 0/1 tables of dense_kernel
DENSE_RANDOM = ((128, 3), (512, 1), (4096, 2))
#: scalar 32-bit operations a second of one H100 outside the tensor
#: cores (67 TFLOP/s of float32 counts a fused multiply-add as two; one
#: compare is one operation here, so this bounds from below)
SCALAR_OPS_PER_S = 67e12
TIERED_FILTERS = 100_000    # tiered: half bench_tiered's default
TIERED_BATCH = 8192
REPLAY_SIZE = 50_000        # retained_replay: retained names and filters
REPLAY_SEED = 0
#: a fan of 64 filters, each level of w/a/b/c/d/e/f literal or '+': the
#: topic w/a/b/c/d/e/f has 2**k live states after k levels, so its walk
#: spills at every A of the kernel cases
FAN_FILTERS = ["w/" + "/".join("+" if m >> k & 1 else c
                               for k, c in enumerate("abcdef"))
               for m in range(64)]
EDGE_FILTERS = ["#", "+", "+/+", "$SYS/#", "$SYS/+/x", "x//y", "/", "//#",
                "a/+/c/#", "d/" + "/".join(["+"] * 14)] + FAN_FILTERS
EDGE_TOPICS = ["$SYS/a/x", "$SYS", "x//y", "/", "//", "a/b/c/d",
               "d/" + "/".join(["q"] * 14), "d/" + "/".join(["q"] * 30),
               "w/a/b/c/d/e/f"]
#: (D, A) of the kernel cases, each at B = 64, 1000 and 2048
WALK_CASES = ((4, 16), (8, 16), (16, 16), (8, 2), (8, 1), (16, 12), (8, 32))
#: the flat epilogue (K3), fused into the flat mode of both walk kernels:
#: its source (``flat_finish`` and the look-back) and the reference
#: function it replaces
FLAT_KERNEL = ("flat_epilogue", "emqx_tpu_torch/ops/csrc/walk_common.cuh",
               "emqx_tpu/ops/match_kernel.py:217")
#: the walk kernels it is fused into (nfa_walk_flat_kernel and
#: nfa_join_walk_flat_kernel)
FLAT_FUSED_INTO = {
    "hash": "nfa_walk_flat_kernel, emqx_tpu_torch/ops/csrc/nfa_walk.cu",
    "join": ("nfa_join_walk_flat_kernel, "
             "emqx_tpu_torch/ops/csrc/nfa_join_walk.cu")}
#: (D, A) of the flat kernel cases (C = 446, 190, 62, 190, 18 accept slots
#: a row; A = 1: 128 rows a block, 64 KB of row lists at K = 128), each at
#: K 4, 32 and 128 and B 2048, 1000 (no whole number of tiles) and 1
FLAT_CASES = ((16, 16), (8, 16), (4, 16), (8, 32), (8, 1))
#: rows of the flat kernel's wide batch: 8,192 blocks at A = 16
FLAT_WIDE = 65536


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


#: flat-mode walk launches (the flat epilogue fused) on each path, as
#: :func:`_flat_launches` read them (the kernels line's
#: ``launches_by_path`` of ``flat_epilogue``)
FLAT_LAUNCHES: Dict[str, int] = {}


def _reset_launches() -> None:
    """Zero the launch counts of both walk kernels and of their flat
    mode, and of the routing grid and merge kernels, just before a main
    path is driven."""
    from emqx_tpu_torch.ops import route_kernel, walk_kernel

    walk_kernel.launches = 0
    walk_kernel.join_launches = 0
    walk_kernel.flat_launches = 0
    route_kernel.reset_launches()


def _flat_launches(device, path: str, flat_walks: int) -> int:
    """The flat-mode walk launches (K3 fused) since
    :func:`_reset_launches`, kept as ``FLAT_LAUNCHES[path]``.  On the
    card they must equal ``flat_walks``: the walk launches of the path
    that ran in flat mode (every walk of a serve path of either backend;
    none of a compact or raw one)."""
    from emqx_tpu_torch.ops import walk_kernel

    flat = FLAT_LAUNCHES[path] = walk_kernel.flat_launches
    if device.type == "cuda":
        _check(flat == flat_walks, f"{path}: flat-mode launches {flat} "
               f"!= flat walk launches {flat_walks}")
    return flat


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timer(torch, device) -> Callable[..., Dict[str, float]]:
    """Times ``reps`` calls of ``fn`` after two warm-up calls.  On the
    card: ``ms`` is device time per call from CUDA events, taken while a
    ``torch.cuda._sleep`` issued first keeps the card busy until the host
    has enqueued every call, so host-side launch cost does not enter it
    (``covered`` says the sleep outlasted the enqueue); ``call_ms`` is
    the same loop without the sleep, which a slow host can bound.  With
    ``before``, each call is preceded by ``before()`` (an L2 flush) and
    ``ms`` sums one event pair around each call, so the flush is not
    counted.  On the CPU (rehearsal) both are host-clock times."""
    if device.type != "cuda":
        def time_cpu(fn, reps: int, before=None) -> Dict[str, float]:
            fn()
            fn()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            ms = (time.perf_counter() - t0) * 1e3 / reps
            return {"ms": ms, "call_ms": ms, "covered": False}
        return time_cpu

    def events(fn, reps: int, sleep_cycles: int, before=None):
        torch.cuda.synchronize()
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(2 * reps if before else 2)]
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)
        t0 = time.perf_counter()
        if before:
            for i in range(reps):
                before()
                marks[2 * i].record()
                fn()
                marks[2 * i + 1].record()
        else:
            marks[0].record()
            for _ in range(reps):
                fn()
            marks[1].record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        ms = sum(marks[i].elapsed_time(marks[i + 1])
                 for i in range(0, len(marks), 2))
        return ms / reps, enqueue_ms

    # the card's _sleep rate: cycles per ms
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    torch.cuda._sleep(50_000_000)
    e.record()
    torch.cuda.synchronize()
    cycles_per_ms = 50_000_000 / s.elapsed_time(e)

    def time_cuda(fn, reps: int, before=None) -> Dict[str, float]:
        fn()
        fn()
        call_ms, enqueue_ms = events(fn, reps, 0, before)
        cover_ms = 2 * enqueue_ms + 5
        ms, enqueue2_ms = events(fn, reps, int(cover_ms * cycles_per_ms),
                                 before)
        return {"ms": ms, "call_ms": call_ms,
                "covered": enqueue2_ms < cover_ms}
    return time_cuda


class GcPauses:
    """Collections of Python's cyclic garbage collector while active:
    their count and pause ms per generation (``gc.callbacks``), and
    ``ms``, the running total of pause ms; those run on another thread
    than the one that made this (a compaction's build) are also counted
    apart, with their largest pause."""

    def __init__(self) -> None:
        self.count = [0, 0, 0]
        self.pause_ms = [0.0, 0.0, 0.0]
        self.max_ms = 0.0
        self.ms = 0.0
        self.other_thread = {"collections": 0, "max_pause_ms": 0.0}
        self._t0: Dict[int, float] = {}
        self._thread = threading.get_ident()

    def _cb(self, phase: str, info: Dict) -> None:
        tid = threading.get_ident()
        if phase == "start":
            self._t0[tid] = time.perf_counter()
            return
        t0 = self._t0.pop(tid, None)
        if t0 is None:
            return
        dt = (time.perf_counter() - t0) * 1e3
        gen = info["generation"]
        self.count[gen] += 1
        self.pause_ms[gen] += dt
        self.max_ms = max(self.max_ms, dt)
        self.ms += dt
        if tid != self._thread:
            o = self.other_thread
            o["collections"] += 1
            o["max_pause_ms"] = max(o["max_pause_ms"], dt)

    def __enter__(self) -> "GcPauses":
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._cb)

    def summary(self) -> Dict:
        return {"collections_by_gen": self.count,
                "pause_ms_by_gen": self.pause_ms, "max_pause_ms": self.max_ms}


def graph_replay(torch, fn) -> Callable[[], None]:
    """``fn`` captured once into a CUDA graph; the returned callable
    replays it with one launch, so a function of many small launches is
    timed on the card without the host's launch rate (or the driver's
    pending-launch limit) entering the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def device_busy(torch, fn) -> Dict[str, object]:
    """Device busy and idle share of the card while ``fn()`` runs, from a
    ``torch.profiler`` trace of the card's activity (kernels and copies;
    the union of their spans over the host-clock window)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return _busy_share(torch, prof, wall_us)


def _busy_share(torch, prof, wall_us: float) -> Dict[str, object]:
    """The union of the device spans of profile ``prof`` over a window of
    ``wall_us`` host µs."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return {"busy_share": "not measured", "idle_share": "not measured",
                "why": "the profiler trace held no device activity"}
    busy, lo, hi = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return {"busy_share": busy / wall_us, "idle_share": 1 - busy / wall_us,
            "device_busy_ms": busy / 1e3, "window_ms": wall_us / 1e3,
            "device_spans": len(spans)}


def _encoded(torch, inc, topics, depth, B, device):
    """The first ``B`` topics encoded against host table ``inc``, on
    ``device``: words, lens, is_sys."""
    from emqx_tpu_torch.ops import encode_batch

    enc = encode_batch(inc, topics[:B], batch=B, depth=depth)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in enc]


def _operands(torch, inc, topics, depth, B, device):
    """``_encoded`` and the Python table's arrays: the walk's inputs."""
    return _encoded(torch, inc, topics, depth, B, device) + [
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (inc.node_tab, inc.edge_tab, inc.seeds)]


def _join_operands(torch, dev, topics, depth, B):
    """Encoded batch + the device table's node table and join relation:
    the operands of ``join_walk`` / ``join_match``."""
    from emqx_tpu_torch.ops import encode_batch

    enc = encode_batch(dev.inc, topics[:B], batch=B, depth=depth)
    batch = [torch.from_numpy(np.ascontiguousarray(a)).to(dev.device)
             for a in enc]
    return batch + [dev.arrays()[0], *dev._jarrs]


def _relation_state(dev) -> Dict[str, int]:
    """Tombstones and overlay rows of a device table's join relation."""
    from emqx_tpu_torch.ops.join_match import OVERLAY_EMPTY

    start, _word, nxt, overlay = dev._jarrs
    return {"tombstones": int((nxt[:int(start[-1])] == -1).sum()),
            "overlay_rows": int((overlay[:, 0] != int(OVERLAY_EMPTY)).sum()),
            "relation_rows": int(nxt.shape[0])}


def _walk_cases(torch, walk, plain, operands) -> List[Dict]:
    """``walk`` (the kernel) against ``plain`` on the card, bit for bit,
    at each listed shape; ``operands(depth, B)`` gives the inputs."""
    cases = []
    for depth, A in WALK_CASES:
        for B in (64, 1000, BATCH):
            args = operands(depth, B)
            acc, aover = walk(*args, active_slots=A)
            acc_p, aover_p = plain(*args, active_slots=A)
            torch.cuda.synchronize()
            err = max(int((acc.long() - acc_p.long()).abs().max()),
                      int((aover.long() - aover_p.long()).abs().max()))
            cases.append({"D": depth, "A": A, "B": B, "equal": err == 0,
                          "max_abs_err": err,
                          "spilled_rows": int((aover_p > 0).sum()),
                          "accepts": int((acc_p >= 0).sum())})
            _check(err == 0, f"{walk.__name__} != plain at D={depth} A={A} "
                   f"B={B}")
    for A in (1, 2, 12):
        _check(any(c["spilled_rows"] for c in cases if c["A"] == A),
               f"the A={A} case did not spill")
    return cases


def _flat_cases(torch, match, operands) -> List[Dict]:
    """``match`` in flat mode on the card against the same call on the
    CPU: all five ``MatchResult`` fields equal."""
    flat = []
    for depth, A, K, cap in ((16, 16, 128, 8 * BATCH),
                             (4, 16, 128, 8 * BATCH), (8, 2, 4, BATCH)):
        args = operands(depth, BATCH)
        kw = dict(active_slots=A, max_matches=K, flat_cap=cap)
        got = match(*args, **kw)
        want = match(*[a.cpu() for a in args], **kw)
        for f in ("matches", "n_matches", "active_overflow",
                  "match_overflow", "row_meta"):
            _check(torch.equal(getattr(got, f).cpu(), getattr(want, f)),
                   f"flat {match.__name__} field {f} differs at D={depth} "
                   f"A={A}")
        flat.append({"D": depth, "A": A, "K": K, "flat_cap": cap,
                     "equal": True,
                     "truncated_rows": int(want.match_overflow.sum())})
    return flat


def _flat_caps(torch, n, K: int, B: int) -> List[int]:
    """A roomy cap, one at every id, one that ends inside a row's segment
    (that row cut, the later ones dropped) and a cap of one id."""
    nk = torch.clamp(n, max=K)
    offs = torch.cumsum(nk, 0) - nk
    caps = [8 * max(B, 1), max(1, int(nk.sum())), 1]
    inside = torch.nonzero(nk >= 2).flatten()
    if len(inside):
        caps.append(int(offs[inside[len(inside) // 3]]) + 1)
    return caps


def _flat_err(got, want) -> int:
    """Largest |difference| over the five fields of two flat matches."""
    err = 0
    for g, w in zip(got, want):
        _check(g.shape == w.shape, "flat outputs differ in shape")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err




def phase_flat_kernel(torch, device, inc, topics, dev, jtopics) -> int:
    """The flat mode of both walks (K3 fused into ``nfa_walk.cu`` and
    ``nfa_join_walk.cu``) against the plain walk and
    ``flat_epilogue_plain`` on the same card tensors, all five fields bit
    for bit, at ``FLAT_CASES`` with K 4, 32 and 128 and B 2048, 1000 and
    1, each at the caps of :func:`_flat_caps`; one launch a call.  Then a
    batch of ``FLAT_WIDE`` rows on one stream while a join and a hash
    match run on another, three times.  Returns the largest
    |difference|."""
    from emqx_tpu_torch.ops import join_match, nfa_match, walk_kernel
    from emqx_tpu_torch.ops.walk_kernel import (
        accept_cols, join_walk_flat_plain, join_walk_plain,
        nfa_walk_flat_plain, nfa_walk_plain)

    t0 = time.perf_counter()
    def cycled(pool, rows):
        return (pool * (rows // len(pool) + 1))[:rows]

    backends = {
        "hash": (nfa_match, nfa_walk_plain, nfa_walk_flat_plain,
                 lambda d, b: _operands(torch, inc, cycled(topics, b), d, b,
                                        device)),
        "join": (join_match, join_walk_plain, join_walk_flat_plain,
                 lambda d, b: _join_operands(torch, dev, cycled(jtopics, b),
                                             d, b))}
    cases, worst, calls = [], 0, 0
    walk_kernel.flat_launches = 0
    for backend, (match, plain, _flat, operands) in backends.items():
        for depth, A in FLAT_CASES:
            for B in (BATCH, 1000, 1):
                args = operands(depth, B)
                acc, aover = plain(*args, active_slots=A)
                n = (acc >= 0).sum(dim=1, dtype=torch.int32)
                for K in (4, 32, 128):
                    err = cut = dropped = 0
                    for cap in _flat_caps(torch, n, K, B):
                        got = match(*args, active_slots=A, max_matches=K,
                                    flat_cap=cap)
                        want = _flat_epilogue(acc, aover, K, cap)
                        calls += 1
                        err = max(err, _flat_err(got, want))
                        nk = torch.clamp(n, max=K)
                        offs = torch.cumsum(nk, 0) - nk
                        dropped = max(dropped, int(((offs >= cap)
                                                    & (nk > 0)).sum()))
                        cut = max(cut, int(((offs < cap)
                                            & (offs + nk > cap)).sum()))
                    _check(err == 0, f"flat {backend} walk != plain at "
                           f"D={depth} A={A} K={K} B={B}")
                    worst = max(worst, err)
                    cases.append({
                        "backend": backend, "D": depth, "A": A,
                        "C": accept_cols(depth, A), "K": K, "B": B,
                        "equal": True, "max_abs_err": err,
                        "rows_past_k": int((n > K).sum()),
                        "rows_cut": cut, "rows_dropped_max": dropped,
                        "spilled_rows": int((aover > 0).sum())})
                if B == BATCH:
                    _check(int((n > 4).sum()) > 0 and any(
                        c["rows_cut"] and c["rows_dropped_max"]
                        for c in cases[-3:]),
                        f"the flat {backend} case D={depth} A={A} lacks rows "
                        "past K, a cut row or dropped rows")
    _check(walk_kernel.flat_launches == calls,
           f"{walk_kernel.flat_launches} flat launches for {calls} calls")
    wide = _flat_wide(torch, device, backends)
    worst = max(worst, wide["max_abs_err"])
    emit({"phase": "kernel", "kernel": "flat_epilogue", "ok": True,
          "fused_into": FLAT_FUSED_INTO, "cases": cases, "calls": calls,
          "wide": wide, "tolerance": "exact", "max_abs_err": worst,
          "wall_s": time.perf_counter() - t0})
    return worst


def _flat_epilogue(acc, aover, K: int, cap: int):
    """``flat_epilogue_plain`` on raw slots, in ``MatchResult`` order."""
    from emqx_tpu_torch.ops.match_kernel import flat_epilogue_plain

    matches, n, mover, meta = flat_epilogue_plain(acc, aover, K, cap)
    return matches, n, aover, mover, meta


def _flat_wide(torch, device, backends) -> Dict:
    """A hash batch of ``FLAT_WIDE`` rows (D = 16) on one stream while a
    2048-row join match (D = 16) and hash match (D = 4) run on a second,
    three rounds, each equal to its plain version; the two streams have
    their own look-back state."""
    from emqx_tpu_torch.ops import walk_kernel

    K = 128
    runs = {"wide": ("hash", 16, FLAT_WIDE), "join": ("join", 16, BATCH),
            "hash": ("hash", 4, BATCH)}
    args = {k: backends[b][3](d, rows) for k, (b, d, rows) in runs.items()}
    wants = {k: backends[b][2](*args[k], active_slots=16, max_matches=K,
                               flat_cap=8 * rows)
             for k, (b, _d, rows) in runs.items()}
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    err = 0
    torch.cuda.synchronize()
    for _ in range(3):
        got = {}
        for k, stream in (("wide", s1), ("join", s2), ("hash", s2)):
            b, _d, rows = runs[k]
            with torch.cuda.stream(stream):
                got[k] = backends[b][0](*args[k], active_slots=16,
                                        max_matches=K, flat_cap=8 * rows)
        torch.cuda.synchronize()
        for k in runs:
            err = max(err, _flat_err(got[k], wants[k]))
    _check(err == 0, "a flat match on two streams at once != plain")
    own = (walk_kernel.flat_scratch(device, s1.cuda_stream)
           is not walk_kernel.flat_scratch(device, s2.cuda_stream))
    _check(own, "two streams share the flat look-back state")
    return {"B": FLAT_WIDE, "blocks": FLAT_WIDE // 8, "K": K,
            "flat_cap": 8 * FLAT_WIDE, "rounds": 3,
            "second_stream": ["join D=16 B=2048", "hash D=4 B=2048"],
            "ids": int(torch.clamp(wants["wide"][1], max=K).sum()),
            "equal": True, "max_abs_err": err}


def phase_kernel(torch, device) -> Dict[str, int]:
    """Each kernel against its plain version on the card; returns the
    largest |difference| of each kernel."""
    from emqx_tpu_torch.ops import (DeviceNfa, IncrementalNfa, join_match,
                                    nfa_match)
    from emqx_tpu_torch.ops.walk_kernel import (
        join_walk, join_walk_plain, nfa_walk, nfa_walk_plain)
    from emqx_tpu_torch.workload import build_workload

    filters, topics = build_workload(np.random.default_rng(1), 40000, BATCH)
    deep, deep_topics = build_workload(np.random.default_rng(2), 10000,
                                       BATCH, depth=16)
    inc = IncrementalNfa(depth=16)
    for f in filters + deep + EDGE_FILTERS:
        inc.add(f)
    mixed = EDGE_TOPICS + [t for pair in zip(topics, deep_topics)
                           for t in pair]
    cases = _walk_cases(torch, nfa_walk, nfa_walk_plain,
                        lambda d, b: _operands(torch, inc, mixed, d, b,
                                               device))
    flat = _flat_cases(torch, nfa_match,
                       lambda d, b: _operands(torch, inc, mixed, d, b,
                                              device))
    worst = {"hash": max(c["max_abs_err"] for c in cases)}
    emit({"phase": "kernel", "kernel": "nfa_walk", "ok": True,
          "states": inc.n_states, "walk_cases": cases, "flat_cases": flat,
          "tolerance": "exact", "max_abs_err": worst["hash"]})

    # the join relation of the same table, churned through the mirror:
    # removes leave tombstones, re-adds revive them, fresh filters land
    # in the overlay
    dev = DeviceNfa(inc, device=device)
    dev.enable_join()
    rng = np.random.default_rng(3)
    live = [f for f in inc.accept_filters if f is not None]
    gone = [live[i] for i in rng.choice(len(live), 300, replace=False)]
    for f in gone:
        _check(inc.remove(f), f"remove {f!r}")
    for f in gone[:20] + [f"zz{i}/new/+" for i in range(40)]:
        inc.add(f)
    rebuilds = dev.join_rebuilds
    dev.sync()
    rel = _relation_state(dev)
    _check(dev.join_rebuilds == rebuilds, "the churn rebuilt the relation")
    _check(rel["tombstones"] > 0 and rel["overlay_rows"] > 0,
           f"the churned relation lacks tombstones or overlay rows: {rel}")
    jtopics = [f"zz{i}/new/x" for i in range(0, 40, 3)] + mixed
    cases = _walk_cases(torch, join_walk, join_walk_plain,
                        lambda d, b: _join_operands(torch, dev, jtopics, d,
                                                    b))
    flat = _flat_cases(torch, join_match,
                       lambda d, b: _join_operands(torch, dev, jtopics, d,
                                                   b))
    worst["join"] = max(c["max_abs_err"] for c in cases)
    emit({"phase": "kernel", "kernel": "nfa_join_walk", "ok": True,
          "relation": rel, "walk_cases": cases, "flat_cases": flat,
          "tolerance": "exact", "max_abs_err": worst["join"]})
    worst["flat"] = phase_flat_kernel(torch, device, inc, mixed, dev,
                                      jtopics)
    return worst


def _serve_checked(svc, trie, batch) -> int:
    got = svc.serve(batch)
    _check(len(got) == len(batch), "serve() lost rows")
    return sum(set(row) != set(trie.match(t)) for t, row in zip(batch, got))


def _sync(torch, device, svc) -> float:
    t0 = time.perf_counter()
    svc.sync()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def _table_info(svc) -> Dict:
    """Sizes of a service's host and device tables, from the arrays it
    really built."""
    node, edge, _seeds = svc.dev.arrays()
    info = {"table_kind": svc.table_kind, "states": svc.inc.n_states,
            "edges": svc.inc.n_edges, "S": int(node.shape[0]),
            "Hb": int(edge.shape[0]), "node_bytes": node.numel() * 4,
            "edge_bytes": edge.numel() * 4,
            "table_bytes": svc.dev.table_bytes}
    if svc.dev._jarrs is not None:
        info["relation_bytes"] = sum(a.numel() * 4 for a in svc.dev._jarrs)
        info["relation"] = _relation_state(svc.dev)
    return info


def shared_workload(n_filters: int, n_batches: int) -> Dict:
    """BASELINE config 2's filters (seed 0) with ``n_batches`` batches of
    topics and the trie oracle, built once for the phases that share
    them (slice, slice_join, exhook_sidecar); each phase undoes its
    churn in the oracle."""
    from emqx_tpu_torch.broker.trie import FilterTrie
    from emqx_tpu_torch.workload import build_workload

    t0 = time.perf_counter()
    filters, topics = build_workload(np.random.default_rng(0), n_filters,
                                     n_batches * BATCH)
    t1 = time.perf_counter()
    trie = FilterTrie()
    for f in filters:
        trie.insert(f)
    return {"filters": filters, "topics": topics, "trie": trie,
            "workload_s": t1 - t0, "oracle_build_s": time.perf_counter() - t1}


def _undo_churn(trie, gone, fresh) -> None:
    """Put the oracle back as it was before :func:`_churn`."""
    for f in fresh:
        trie.delete(f)
    for f in gone:
        trie.insert(f)


def _build_service(torch, device, n_filters: int, n_batches: int,
                   backend: str, table: str, phase: str, shared=None):
    """A ``MatchService`` on ``backend`` and host ``table`` over the
    BASELINE config-2 filters (seed 0), started with ``load``, and its
    trie oracle (``shared``'s when given: :func:`shared_workload`, whose
    build has a line of its own); emits the build line ``phase``."""
    from emqx_tpu_torch.broker.match_service import MatchService

    t0 = time.perf_counter()
    own = {}
    if shared is None:
        shared = shared_workload(n_filters, n_batches)
        own = {"workload_s": shared["workload_s"],
               "oracle_build_s": shared["oracle_build_s"]}
    filters, topics, trie = (shared["filters"], shared["topics"],
                             shared["trie"])
    t1 = time.perf_counter()
    svc = MatchService(device=device, backend=backend, table=table)
    _check(svc.load(filters) == len(filters), "load() lost filters")
    t2 = time.perf_counter()
    upload_s = _sync(torch, device, svc)
    emit({"phase": phase, "ok": True, "backend": backend,
          "filters": len(filters), **_table_info(svc), **own,
          "host_build_s": t2 - t1,
          "load_seconds": svc.load_seconds, "upload_s": upload_s,
          "shared_workload": not own,
          "wall_s": time.perf_counter() - t0})
    svc.host_build_s = t2 - t1
    return svc, trie, filters, topics[:n_batches * BATCH]


def _fresh_filters(have, n: int, seed: int) -> List[str]:
    """``n`` workload filters that ``have`` (a container) does not
    hold."""
    from emqx_tpu_torch.workload import build_workload

    extra, _ = build_workload(np.random.default_rng(seed), 4 * n, 0)
    fresh = list(dict.fromkeys(f for f in extra if f not in have))[:n]
    _check(len(fresh) == n, "churn workload too small")
    return fresh


def _churn(torch, device, svc, trie, gone, fresh) -> float:
    """Remove ``gone`` and add ``fresh`` in the service and the oracle,
    then sync; returns the sync seconds."""
    for f in gone:
        _check(svc.remove(f), f"remove {f!r}")
        trie.delete(f)
    for f in fresh:
        _check(svc.add(f), f"add {f!r}")
        trie.insert(f)
    return _sync(torch, device, svc)


def _serve_batches(svc, trie, topics, first: int, count: int) -> int:
    bad = 0
    for i in range(first, first + count):
        bad += _serve_checked(svc, trie, topics[i * BATCH:(i + 1) * BATCH])
    return bad


def phase_slice(torch, device, n_filters: int, table: str = "native",
                name: str = "slice", shared=None) -> Dict:
    """The hash backend's serve path on host ``table``: served batches
    against the oracle, a churn written in place, more batches."""
    from emqx_tpu_torch.ops import walk_kernel

    t_start = time.perf_counter()
    svc, trie, filters, topics = _build_service(
        torch, device, n_filters, SERVE_BATCHES + AFTER_BATCHES, "hash",
        table, name + "_build", shared)
    encoded0 = svc.encoder.native_batches

    # -- the main path: counts zeroed just before, read just after -------
    _reset_launches()
    d0 = svc.dispatches
    bad = _serve_batches(svc, trie, topics, 0, SERVE_BATCHES)
    rng = np.random.default_rng(1)
    gone = [filters[i] for i in rng.choice(len(filters), CHURN,
                                           replace=False)]
    fresh = _fresh_filters(set(filters), CHURN, 2)
    uploads0, key0 = svc.dev.uploads, svc.inc.shape_key()
    sync_s = _churn(torch, device, svc, trie, gone, fresh)
    grew = svc.inc.shape_key() != key0
    _check(grew or svc.dev.uploads == uploads0,
           "churn re-uploaded the tables without growth")
    bad += _serve_batches(svc, trie, topics, SERVE_BATCHES, AFTER_BATCHES)
    launches = walk_kernel.launches
    join_launches = walk_kernel.join_launches
    flat = _flat_launches(device, name, launches + join_launches)
    dispatches = svc.dispatches - d0
    # ---------------------------------------------------------------------
    _undo_churn(trie, gone, fresh)
    _check(bad == 0, f"{bad} served answers differ from the trie oracle")
    _check(svc.table_kind == ("python" if table == "python" else "native"),
           f"table {table!r} built a {svc.table_kind} table")
    _check(svc.encoder.native_batches - encoded0 == dispatches
           and svc.encoder.python_batches == 0,
           "the native encoder did not encode every dispatch")
    if device.type == "cuda":
        _check(launches == dispatches > 0,
               f"kernel launches {launches} != walk dispatches {dispatches}")
        _check(join_launches == 0, "the join kernel ran on the hash path")
    info = {"phase": name, "ok": bad == 0, "table_kind": svc.table_kind,
            "served_topics": svc.topics,
            "batches": SERVE_BATCHES + AFTER_BATCHES,
            "mismatches": bad, "walk_dispatches": dispatches,
            "kernel_launches": launches,
            "join_kernel_launches": join_launches,
            "flat_epilogue_launches": flat,
            "churn_removed": len(gone),
            "churn_added": len(fresh), "churn_sync_s": sync_s,
            "churn_grew_table": grew, "uploads": svc.dev.uploads,
            "delta_applies": svc.dev.delta_applies,
            "host_reruns": svc.fallback_host,
            "native_encodes": svc.encoder.native_batches - encoded0,
            "wall_s": time.perf_counter() - t_start}
    emit(info)
    return {"svc": svc, "topics": topics, "launches": launches,
            "spill_share": svc.fallback_host / svc.topics,
            "build_s": svc.host_build_s, "churn": (gone, fresh)}


#: multichip: the mesh's table shards, all on the one card ([cuda:0] *
#: MC_TP: dp = 1), the batches served in each form and the batches that
#: also run the step with the walk's plain version
MC_TP = 4
MC_BATCHES = 20
MC_PLAIN_BATCHES = 2
#: multichip: the forms of the step, as the matcher's flags
MC_FORMS = (("replicated", False, False), ("routed", True, False),
            ("routed_compact", True, True))
#: slice_node_multichip: warm-up and timed publishes, in batches of 2048
MC_WARM = 2
MC_STORM = 5


#: the routing grid and merge kernels (csrc/ep_route.cu): the reference
#: code each replaces
ROUTE_SOURCE = "emqx_tpu_torch/ops/csrc/ep_route.cu"
ROUTE_KERNELS = {
    "ep_route": "emqx_tpu/parallel/multichip_serve.py:327",
    "ep_merge": "emqx_tpu/parallel/multichip_serve.py:230"}
#: dispatches a torch.profiler pass counts device operations over
DEVICE_OPS_DISPATCHES = 3


def _walk_traffic_bytes(torch, rows, tables, A: int) -> int:
    """Table bytes the hash-walk kernel gathers walking ``rows`` (words,
    lens, is_sys) over each of ``tables`` (node, edge, seeds), counted
    by the plain walk on these inputs: 16 B a node row, 32 B a bucket
    row, the seeds."""
    from emqx_tpu_torch.ops.walk_kernel import nfa_walk_plain

    total = 0
    for node, edge, seeds in tables:
        tr: Dict[str, int] = {}
        nfa_walk_plain(*rows, node, edge, seeds, active_slots=A, traffic=tr)
        total += tr["node_rows"] * 16 + tr["bucket_rows"] * 32 + 8
    return total


def _landed(torch, w, l, s, word_owner, tp: int, C: int):
    """The routed grid of one row group on one device, as the step lands
    it (``ep_route_plain``): per owner its ``(tp·C)`` rows' words, lens
    and is_sys."""
    from emqx_tpu_torch.ops import route_kernel as rk

    B, D = w.shape
    R = tp * C
    dev = w.device
    g = rk.RouteGrid(torch.empty((tp * R, D), dtype=torch.int32, device=dev),
                     torch.empty((tp * R,), dtype=torch.int32, device=dev),
                     torch.empty((tp * R,), dtype=torch.bool, device=dev),
                     torch.empty((tp * R,), dtype=torch.int32, device=dev))
    Bs = B // tp
    rk.ep_route_plain(w, l, s, word_owner, g, tp=tp, C=C, Bs=Bs,
                      sources=[(i * Bs, i * C) for i in range(tp)], so=R)
    return [tuple(x.view(tp, R, *x.shape[1:])[o] for x in g[:3])
            for o in range(tp)]


def _mc_bytes(torch, mc, enc, routed: bool, compact: bool) -> Dict:
    """The bytes a K8a step must move on ``enc`` (one row group, dp 1):
    the table rows its 2·tp walks gather (each shard's table and the
    micro-table, counted by the plain walk on the rows each walk sees,
    as K1's own bound counts them), the batch read once (words, lens,
    is_sys), with ``routed`` the (tp, tp·C) grid written once (words,
    lens, is_sys, src), and the outputs written once."""
    dev = mc.mesh.lead
    w, l, s = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
               for x in enc)
    B, D = (int(x) for x in w.shape)
    tp = mc.tp
    shard, repl = mc._arrs.shard[0], mc._arrs.repl[0][0]
    micro = tuple(repl[:3])
    grid = 0
    if routed:
        C = mc.ep_capacity(B)
        rows = _landed(torch, w, l, s, repl[4], tp, C)
        grid = tp * tp * C * (4 * D + 9)
    else:
        rows = [(w, l, s)] * tp
    walks = sum(_walk_traffic_bytes(torch, rows[t],
                                    (tuple(shard[t][:3]), micro),
                                    mc.active_slots) for t in range(tp))
    W = mc.max_matches + mc.ep_micro_matches
    segs = 1 if compact else tp
    batch = B * (4 * D + 5)
    out = B * (segs * W + 2 * segs + 3) * 4
    total = walks + batch + grid + out
    return {"walks": walks, "batch": batch, "grid": grid, "outputs": out,
            "total": total}


def _device_ops(torch, fn, n: int = DEVICE_OPS_DISPATCHES) -> Dict:
    """Device operations (kernels, copies, memsets) a call of ``fn``,
    from a ``torch.profiler`` trace of ``n`` calls, each in its own
    ``record_function`` range that ends in a synchronize: the device
    events inside each range, their count a call (the largest: a trace
    can miss a call's events, never add any) and names."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    for _ in range(2):      # the first trace may miss its first launches
        with profile(activities=acts) as prof:
            for i in range(n):
                with record_function(f"device_ops_call{i}"):
                    fn()
                    torch.cuda.synchronize()
    events = list(prof.events())
    calls = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name.startswith("device_ops_call")
                   and e.device_type != cuda)
    ops = [(e.time_range.start, e.name) for e in events
           if e.device_type == cuda
           and not e.name.startswith("device_ops_call")]
    each = [[name for t, name in ops if a <= t <= b] for a, b in calls]
    if not any(each):
        return {"per_dispatch": "not measured",
                "why": "the profiler trace held no device activity"}
    most = max(each, key=len)
    names: Dict[str, int] = {}
    for name in most:
        names[name] = names.get(name, 0) + 1
    return {"per_dispatch": len(most), "each_call": [len(x) for x in each],
            "by_name": dict(sorted(names.items()))}


class _Capture:
    """While active, records the arguments of every call of the route
    kernels' wrappers (``ep_route``, ``ep_merge``) in steps built
    meanwhile, so that each kernel can be timed alone, and held to its
    plain version, on the main path's own operands."""

    def __init__(self) -> None:
        from emqx_tpu_torch.ops import route_kernel as rk

        self.rk = rk
        self.calls: Dict[str, List] = {"ep_route": [], "ep_merge": []}
        self.real = {k: getattr(rk, k) for k in self.calls}

    def __enter__(self) -> "_Capture":
        for name, fn in self.real.items():
            def rec(*args, _name=name, _fn=fn, **kw):
                self.calls[_name].append((args, kw))
                return _fn(*args, **kw)
            setattr(self.rk, name, rec)
        return self

    def __exit__(self, *exc) -> None:
        for name, fn in self.real.items():
            setattr(self.rk, name, fn)


def _route_out_tensors(name: str, args, kw) -> List:
    """The tensors a captured call writes: the grid and the per-row
    outputs (``ep_route``), or the merge's outputs."""
    if name == "ep_route":
        outs = list(args[4]) + [kw.get(k) for k in ("fill_ids", "flag",
                                                    "owner_out")]
        return [t for t in outs + list(kw.get("zeros", ())) if t is not None]
    return [t for t in args[1] if t is not None]


def _swap_outputs(rk, name: str, args, kw):
    """A captured call with each output tensor replaced by a clone (the
    plain version writes there)."""
    if name == "ep_route":
        kw2 = dict(kw)
        for k in ("fill_ids", "flag", "owner_out"):
            if kw.get(k) is not None:
                kw2[k] = kw[k].clone()
        kw2["zeros"] = [z.clone() for z in kw.get("zeros", ())]
        grid = rk.RouteGrid(*(x.clone() for x in args[4]))
        return (*args[:4], grid, *args[5:]), kw2
    out = rk.MergeOut(*(None if t is None else t.clone() for t in args[1]))
    return (args[0], out, *args[2:]), kw


def _route_kernel_timing(torch, device, calls: Dict[str, List],
                         bound: Dict[str, float]) -> Dict:
    """Each route kernel alone on its captured main-path operands:
    device ms rotating over the calls and with the L2 flushed before
    each, against its plain version (max abs err over every output, ms
    as events over a host loop) and ``bound`` ms."""
    from emqx_tpu_torch.ops import route_kernel as rk

    time_ms = timer(torch, device)
    flush = (torch.empty(64 << 20, dtype=torch.int32, device=device).zero_
             if device.type == "cuda" else None)
    out = {}
    for name, cs in calls.items():
        if not cs:
            continue
        kern = getattr(rk, name)
        plain = getattr(rk, f"{name}_plain")
        err = 0
        for args, kw in cs:
            p_args, p_kw = _swap_outputs(rk, name, args, kw)
            plain(*p_args, **p_kw)
            kern(*args, **kw)
            for g, w in zip(_route_out_tensors(name, args, kw),
                            _route_out_tensors(name, p_args, p_kw)):
                if g.numel():
                    err = max(err, int((g.long() - w.long()).abs().max()))
        turn = [0]

        def rotate(cs=cs, kern=kern):
            turn[0] += 1
            args, kw = cs[turn[0] % len(cs)]
            kern(*args, **kw)

        card = device.type == "cuda"
        rot = time_ms(rotate, 20 * len(cs) if card else 1)
        cold = time_ms(rotate, 4 * len(cs) if card else 1,
                       before=flush if card else None)
        pt = time_ms(lambda cs=cs, plain=plain: plain(*cs[0][0], **cs[0][1]),
                     3 if card else 1)
        out[name] = {"ms": rot["ms"], "ms_cold": cold["ms"],
                     "covered": rot["covered"] and cold["covered"],
                     "plain_ms": pt["ms"],
                     "plain_timing": "events over a host loop",
                     "max_abs_err": err, "calls_timed": len(cs),
                     "bound_ms": bound[name], "bound_by": "bytes"}
    return out


def _route_bounds(torch, calls: Dict[str, List]) -> Dict[str, float]:
    """Each route kernel's least time on its first captured call: the
    bytes it must move over 3.35 TB/s.  ``ep_route``: the batch rows of
    its sources read once (words, lens, is_sys and, with an owner map, a
    4 B owner a row), the grid slots and every per-row output written
    once.  ``ep_merge``: the raw accept rows of each landed slot (routed)
    or row (replicated) read once, the shard walk's and, where the pair
    merges them, the micro walk's, with their spills and sources, the
    aid-map entries of the valid ids, and the outputs written once."""
    out = {}
    if calls["ep_route"]:
        args, kw = calls["ep_route"][0]
        words, grid = args[0], args[4]
        D = int(words.shape[1])
        rows = len(kw["sources"]) * kw["Bs"]
        slots = len(kw["sources"]) * kw["tp"] * kw["C"]
        per_row = sum(t[0].numel() * 4 for t in
                      [kw.get("fill_ids"), kw.get("flag"),
                       kw.get("owner_out"), *kw.get("zeros", ())]
                      if t is not None)
        nbytes = (rows * (4 * D + 5 + (4 if args[3] is not None else 0))
                  + slots * (4 * D + 9) + rows * per_row)
        out["ep_route"] = nbytes / HBM_BYTES_PER_S * 1e3
    if calls["ep_merge"]:
        args, kw = calls["ep_merge"][0]
        pairs, mo = args[0], args[1]
        nbytes = sum(t.numel() * 4 for t in mo if t is not None)
        for p in pairs:
            cols = int(p.acc.shape[1])
            live = (p.src >= 0) if kw["routed"] else torch.ones_like(
                p.aover, dtype=torch.bool)
            n = int(live.sum())
            walks = [(p.acc, p.amap)]
            if p.micro and p.macc is not None:
                walks.append((p.macc, p.mamap))
            for acc, amap in walks:
                valid = int((acc[live] >= 0).sum())
                nbytes += n * (cols + 1) * 4 + (valid * 4 if amap is not None
                                                else 0)
            if kw["routed"]:
                nbytes += int(p.src.numel()) * 4
        out["ep_merge"] = nbytes / HBM_BYTES_PER_S * 1e3
    return out


def phase_multichip(torch, device, s: Dict, shared: Dict, card: str):
    """The multichip serve path (K8a around the hash walk, K1) at 1M
    filters: config 2's table, with the accept ids of the hash service
    of ``slice`` (``s["svc"]``), sharded into a ``MultichipMatcher`` on
    ``MC_TP`` shards of the one card, native subtables; ``MC_BATCHES``
    batches of 2048 served topics in each form of ``MC_FORMS`` at the
    default capacity slack.  Each decoded row (spilled rows re-run on the
    host, as the service does) equals the oracle's filters and the
    single-device flat path's accept ids, and each row the mesh answered
    equals the flat path's; the step with the kernel equals the step
    with the plain walk on every field for ``MC_PLAIN_BATCHES`` batches;
    the walk's launches on the served batches are 2·tp a dispatch,
    ``ep_route``'s one a routed dispatch and ``ep_merge``'s one a
    dispatch (a device each), at most 2·tp + 8 device operations a
    dispatch.  Reports each form's step device ms (CUDA events on the
    mesh stream) and host ms a dispatch, readback bytes a batch, spilled
    rows, device operations a dispatch, each route kernel alone on the
    form's own operands and the bytes bound; the shards' filters and
    states.  Returns the walk's and the route kernels' launches on the
    main path, the plain comparison's largest difference and the route
    kernels' timings."""
    from emqx_tpu_torch.ops import route_kernel as rk
    from emqx_tpu_torch.ops import walk_kernel
    from emqx_tpu_torch.parallel import MultichipMatcher, build_multichip_step

    t_start = time.perf_counter()
    svc, trie, topics = s["svc"], shared["trie"], shared["topics"]
    batches = [topics[i * BATCH:(i + 1) * BATCH] for i in
               range(min(MC_BATCHES, len(topics) // BATCH))]
    # the oracle's filters (with the table's churn of ``slice``) and the
    # single-device flat path's rows
    gone, fresh = s["churn"]
    for f in gone:
        trie.delete(f)
    for f in fresh:
        trie.insert(f)
    want = [[sorted(trie.match(t)) for t in b] for b in batches]
    _undo_churn(trie, gone, fresh)
    single = []
    for b in batches:
        groups = svc._depth_groups(b)
        res, _nb, _trips = svc._readback_groups(svc._encode_dispatch(b,
                                                                     groups))
        rows = [None] * len(b)
        spilled = set()
        for (idx, _d), (grows, gsp) in zip(groups, res):
            for j, i in enumerate(idx):
                rows[i] = grows[j]
            spilled.update(idx[j] for j in gsp)
        single.append((rows, spilled))
    t1 = time.perf_counter()
    pairs = svc._mc_pairs()
    mc = MultichipMatcher(depth=svc.depth, tp=MC_TP,
                          devices=[device] * MC_TP,
                          active_slots=svc.dev.active_slots,
                          max_matches=svc.dev.max_matches, native=True)
    mc.rebuild(pairs)
    _check(mc.apply_pending(), "the partition did not apply")
    mc.warm(batches=(BATCH,), depths=(svc.depth,))
    if device.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    fo = svc._filter_of
    line = {"phase": "multichip", "ok": True, "card": card,
            "filters": len(pairs), "mesh": {"dp": mc.dp, "tp": mc.tp},
            "devices": [str(d) for row in mc.mesh.devices for d in row],
            "build_s": build_s,
            "shard_filters": [x.n_filters for x in mc._subs],
            "shard_states": [x.n_states for x in mc._subs],
            "micro_filters": len(mc._micro_filters),
            "micro_states": mc._micro.n_states,
            "stacked_shape": dict(zip(
                ("S", "Hb", "A", "micro_S", "micro_Hb", "micro_A",
                 "word_owner"), mc._stacked_shape)),
            "forms": {}}
    failed: List[str] = []
    launches_total = 0
    max_err = 0
    route_total = {k: 0 for k in rk.launches}
    route_timing: Dict[str, Dict] = {}
    n_dev = len(mc.mesh.distinct)
    stream = mc.mesh.stream_of.get(device)
    for form, ep, compact in MC_FORMS:
        mc.ep, mc.ep_compact = ep, compact
        # -- the main path: counts zeroed just before, read just after --
        _reset_launches()
        d0 = mc.dispatches
        bad_oracle = bad_single = bad_device = spilled = 0
        nbytes = []
        host_ms = []
        for b, w, (srows, _ssp) in zip(batches, want, single):
            enc = mc.encode(b, batch=BATCH)
            t2 = time.perf_counter()
            h = mc.dispatch(enc)
            host_ms.append((time.perf_counter() - t2) * 1e3)
            rows, sp, nb = mc.readback(h, len(b))
            nbytes.append(nb)
            spilled += len(sp)
            spset = set(sp)
            for i, t in enumerate(b):
                row = rows[i]
                if i in spset:
                    row = svc._host_ids(t)
                else:
                    bad_device += sorted(row) != sorted(srows[i])
                bad_single += sorted(row) != sorted(srows[i])
                bad_oracle += sorted(fo[a] for a in row) != w[i]
        launches = walk_kernel.launches
        route_n = dict(rk.launches)
        dispatches = mc.dispatches - d0
        # ----------------------------------------------------------------
        launches_total += launches
        routed = mc._routed_for(BATCH)
        for k, n in route_n.items():
            route_total[k] += n
        if device.type == "cuda":
            if launches != 2 * mc.tp * mc.dp * dispatches:
                failed.append(f"{form}: {launches} walk launches for "
                              f"{dispatches} dispatches, want 2·tp each")
            want_route = {"ep_route": dispatches * n_dev if routed else 0,
                          "ep_merge": dispatches * n_dev}
            if route_n != want_route:
                failed.append(f"{form}: route kernel launches {route_n}, "
                              f"want {want_route}")
        # the step alone, device ms from events on the mesh stream
        step = mc._step_for((BATCH, svc.depth), routed=mc._routed_for(BATCH))
        dev_ms = []
        for b in batches:
            enc = mc.encode(b, batch=BATCH)
            if stream is not None:
                with mc.mesh.streams():
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record(stream)
                    step(*enc, mc._arrs)
                    e1.record(stream)
                dev_ms.append((e0, e1))
        if stream is not None:
            torch.cuda.synchronize()
            dev_ms = [e0.elapsed_time(e1) for e0, e1 in dev_ms]
        # the kernel against the plain walk, field by field
        plain = build_multichip_step(
            mc.mesh, mc.active_slots, mc.max_matches,
            micro_matches=mc.ep_micro_matches, routed=mc._routed_for(BATCH),
            capacity=mc.ep_capacity(BATCH) if ep else 0, compact=compact,
            plain=True)
        err = 0
        plain_ms = []
        for b in batches[:MC_PLAIN_BATCHES]:
            enc = mc.encode(b, batch=BATCH)
            with mc.mesh.streams():
                got = step(*enc, mc._arrs)
                if stream is not None:
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record(stream)
                ref = plain(*enc, mc._arrs)
                if stream is not None:
                    e1.record(stream)
                    plain_ms.append((e0, e1))
            for x, y in zip(got, ref):
                err = max(err, int((x.long() - y.long()).abs().max()))
        if stream is not None:
            torch.cuda.synchronize()
            plain_ms = [e0.elapsed_time(e1) for e0, e1 in plain_ms]
        max_err = max(max_err, err)
        # device operations a dispatch (upload, grid, walks, merge,
        # readback), from a profiler trace of a few dispatches
        ops: Dict = {"per_dispatch": "not measured"}
        if device.type == "cuda":
            enc0 = mc.encode(batches[0], batch=BATCH)
            ops = _device_ops(torch, lambda: mc.readback(
                mc.dispatch(enc0), len(batches[0])))
            if isinstance(ops["per_dispatch"], int) and \
                    ops["per_dispatch"] > 2 * mc.tp + 8:
                failed.append(f"{form}: {ops['per_dispatch']} device "
                              f"operations a dispatch, want <= 2·tp + 8")
        # each route kernel alone on the main path's own operands
        with _Capture() as cap:
            fresh = build_multichip_step(
                mc.mesh, mc.active_slots, mc.max_matches,
                micro_matches=mc.ep_micro_matches, routed=routed,
                capacity=mc.ep_capacity(BATCH) if routed else 0,
                compact=compact)
            with mc.mesh.streams():
                for b in batches[:MC_PLAIN_BATCHES]:
                    fresh(*mc.encode(b, batch=BATCH), mc._arrs)
        route_t = _route_kernel_timing(torch, device, cap.calls,
                                       _route_bounds(torch, cap.calls))
        route_timing[form] = route_t
        for name, t in route_t.items():
            if t["max_abs_err"]:
                failed.append(f"{form}: {name} differs from its plain "
                              f"version by {t['max_abs_err']}")
        bounds = _mc_bytes(torch, mc, mc.encode(batches[0], batch=BATCH),
                           routed, compact)
        line["forms"][form] = {
            "routed": mc._routed_for(BATCH), "compact": compact,
            "capacity": mc.ep_capacity(BATCH) if ep else None,
            "dispatches": dispatches, "kernel_launches": launches,
            "launches_per_dispatch": launches / max(1, dispatches),
            "step_device_ms": (float(np.mean(dev_ms)) if dev_ms
                               else "not measured"),
            "step_device_ms_p99": (_pct(dev_ms, 99) if dev_ms
                                   else "not measured"),
            "dispatch_host_ms": float(np.mean(host_ms)),
            "readback_bytes_per_batch": float(np.mean(nbytes)),
            "spilled_rows": spilled,
            "rows_checked": len(batches) * BATCH,
            "mismatches_oracle": bad_oracle,
            "mismatches_single_device": bad_single,
            "device_rows_differing_from_single_device": bad_device,
            "plain_batches": MC_PLAIN_BATCHES, "max_abs_err": err,
            "plain_step_device_ms": (float(np.mean(plain_ms)) if plain_ms
                                     else "not measured"),
            "route_kernel_launches": route_n,
            "route_launches_per_dispatch": {
                k: n / max(1, dispatches) for k, n in route_n.items()},
            "device_ops": ops, "route_kernels": route_t,
            "bound_bytes": bounds,
            "bound_ms": bounds["total"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}
        for what, n in (("oracle", bad_oracle),
                        ("single-device flat path", bad_single),
                        ("single-device rows (device-served)", bad_device)):
            if n:
                failed.append(f"{form}: {n} rows differ from the {what}")
        if err:
            failed.append(f"{form}: the kernel's step differs from the "
                          f"plain walk's by {err}")
    rep = line["forms"]["replicated"]["readback_bytes_per_batch"]
    line["compact_readback_over_replicated"] = (
        line["forms"]["routed_compact"]["readback_bytes_per_batch"] / rep)
    line["route_kernel_launches"] = route_total
    line["wall_s"] = time.perf_counter() - t_start
    _emit_checked(line, failed)
    return {"launches": launches_total, "max_abs_err": max_err,
            "route_launches": route_total, "route_timing": route_timing}


#: multichip_fanout: config 2's 1M filters as 1M subscriptions of
#: FANOUT_CLIENTS clients (filter i of the workload, and the churn's
#: j-th new filter as 1M + j, to client i % FANOUT_CLIENTS), on
#: [cuda:0] * 4 meshes; each step serves FANOUT_BATCHES batches of
#: 2048, of which FANOUT_PLAIN also run with the plain versions
FANOUT_CLIENTS = SESSIONS
FANOUT_BATCHES = 5
FANOUT_PLAIN = 2
FANOUT_CAP = 64             # cap_row of the compact forms
FANOUT_GROUPS = 16          # $share groups of 2-4,000 members, the last empty
FANOUT_SEED = 7             # the groups and the selector hashes
FANOUT_PICK_STRIDE = 97     # rows whose picks are held to host_pick
#: the bitmap kernels: the reference function each replaces
BITMAP_SOURCE = "emqx_tpu_torch/ops/csrc/bitmap_fanout.cu"
BITMAP_KERNELS = {
    "accept_or": "emqx_tpu/parallel/sharded_match.py:88",
    "bitmap_compact": "emqx_tpu/parallel/sharded_match.py:100",
    "group_count": "emqx_tpu/parallel/shared_group.py:92",
    "group_pick": "emqx_tpu/parallel/shared_group.py:105"}


def _fields(out) -> List:
    """A step's outputs as a list of tensors (a ``Sharded`` whole)."""
    from emqx_tpu_torch.parallel import Sharded

    if isinstance(out, Sharded):
        return [out.full()]
    if isinstance(out, tuple):
        return [t for x in out for t in _fields(x)]
    return [out]


def _max_err(got, want) -> int:
    err = 0
    for x, y in zip(_fields(got), _fields(want)):
        _check(x.shape == y.shape, f"field shapes {x.shape} != {y.shape}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def _fanout_oracle(trie, topics, client_of, W: int) -> np.ndarray:
    """``(len(topics), W)`` uint32: each topic's OR of the clients of the
    oracle's matching filters."""
    out = np.zeros((len(topics), W), np.uint32)
    for r, t in enumerate(topics):
        for f in trie.match(t):
            c = client_of[f]
            out[r, c >> 5] |= np.uint32(1 << (c & 31))
    return out


def _bitmap_bound(in_bytes: List[float], out_bytes: int, ops: float) -> Dict:
    """A bitmap kernel's bound: each input it needs read once and each
    output written once over the memory rate, against ``ops`` 32-bit
    operations over the scalar rate; the larger."""
    nbytes = sum(in_bytes) + out_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return {"bound_bytes": nbytes, "bound_ops": ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _time_bitmap(torch, device, calls, plain, flush) -> Dict:
    """One bitmap kernel alone: device ms rotating over ``calls`` (one a
    served batch), the same with the L2 flushed before each launch, and
    ``plain()`` (its plain version on the first batch's inputs) as a host
    loop of events."""
    time_ms = timer(torch, device)
    turn = [0]

    def rotate():
        turn[0] += 1
        calls[turn[0] % len(calls)]()

    card = device.type == "cuda"
    rot = time_ms(rotate, 20 * len(calls) if card else 1)
    cold = time_ms(rotate, 4 * len(calls) if card else 1,
                   before=flush if card else None)
    pt = time_ms(plain, 3 if card else 1)
    return {"ms": rot["ms"], "ms_cold": cold["ms"],
            "call_ms": rot["call_ms"], "covered": rot["covered"]
            and cold["covered"], "plain_ms": pt["ms"],
            "plain_covered": pt["covered"],
            "plain_timing": "events over a host loop"}


def phase_multichip_fanout(torch, device, s: Dict, shared: Dict,
                           card: str) -> Dict:
    """The fan-out library (K8b-K8f) at config 2's 1M subscriptions: the
    ``slice`` service's table (with its churn) and accept ids, each
    filter one client's subscription (``FANOUT_CLIENTS`` clients), the
    accept bitmap ``(F+1, W)`` built on the card (W = 313 words padded to
    316 for four shards).  On ``[cuda:0] * 4`` meshes, each of
    ``FANOUT_BATCHES`` served batches of 2048 (D = 16, A = 16, K = 128)
    goes through ``build_sharded_matcher`` and its compact twin (dp 1, tp
    4, cap 64), ``build_shared_selector`` (tp 4, 16 groups of seed 7, the
    last empty), ``build_ring_fanout`` and its compact twin (dp 1, ring
    4), ``build_ep_matcher`` (ep 4, capacity max(32, B / E² · 4), over
    ``build_partitions`` of the service's filters as native tables) and
    ``build_ulysses_step`` (u 4) with ``build_unreshard``.  Checks: each
    step's kernel launches a dispatch as the step states; each step equal
    to its plain build (the plain walk and the plain bitmap functions) on
    every field for ``FANOUT_PLAIN`` batches; every row not flagged
    (active or match overflow, compact or ring truncation, EP overflow)
    equal to the trie oracle (the OR of its filters' clients; EP: the
    filters; the pick: ``host_pick`` on every 97th row); the Ulysses
    dispatch equal to the sharded bitmap and ``unreshard(reshard(x)) ==
    x``.  Readings: each step's device ms (CUDA events on the mesh
    stream) and host ms a dispatch and its bytes bound (the walk's
    gathered table rows and the batch, the bitmap rows its valid ids
    name, the outputs; the selector's bitmap, masks and hashes; EP's in
    :func:`_ep_readings`); each kernel alone at the served shape
    (rotating, L2 flushed), its bound and its plain version's ms; the
    bitmap's bytes.  Returns each kernel's line entry numbers."""
    from emqx_tpu_torch import parallel as P
    from emqx_tpu_torch.ops import bitmap_kernel as bk
    from emqx_tpu_torch.ops import encode_batch, nfa_match, walk_kernel
    from emqx_tpu_torch.ops import route_kernel as rk
    from emqx_tpu_torch.ops.encode import TopicEncoder

    t_start = time.perf_counter()
    svc, trie, topics = s["svc"], shared["trie"], shared["topics"]
    depth, A, K = svc.depth, svc.dev.active_slots, svc.dev.max_matches
    n_subs = FANOUT_CLIENTS
    gone, fresh = s["churn"]
    client_of = {f: i % n_subs for i, f in enumerate(shared["filters"])}
    for j, f in enumerate(fresh):
        client_of[f] = (len(shared["filters"]) + j) % n_subs
    batches = [topics[i * BATCH:(i + 1) * BATCH]
               for i in range(FANOUT_BATCHES)]
    # the oracle with the table's churn, as the service holds it
    for f in gone:
        trie.delete(f)
    for f in fresh:
        trie.insert(f)
    t0 = time.perf_counter()
    W = (n_subs + 31) // 32
    W += (-W) % 4
    want_bm = [_fanout_oracle(trie, b, client_of, W) for b in batches]
    want_f = [[sorted(trie.match(t)) for t in b] for b in batches]
    _undo_churn(trie, gone, fresh)
    oracle_s = time.perf_counter() - t0

    # -- the accept bitmap on the card: one client's bit a filter --------
    t0 = time.perf_counter()
    fo = svc._filter_of
    F = max(len(fo), int(svc.inc.n_accepts))
    aids = np.array([a for a, f in enumerate(fo) if f is not None], np.int64)
    live = [fo[a] for a in aids.tolist()]
    subs = np.array([client_of[f] for f in live], np.int64)
    rows_pad = F + 1 + (-(F + 1)) % 4
    bm = torch.zeros((rows_pad, W), dtype=torch.int32, device=device)
    bit = (np.int64(1) << (subs & 31))
    bit = np.where(bit >= 1 << 31, bit - (1 << 32), bit).astype(np.int32)
    bm[torch.from_numpy(aids).to(device),
       torch.from_numpy(subs >> 5).to(device)] = torch.from_numpy(bit).to(
        device)
    bm_main = bm[:F + 1]            # (F+1, W): row F the zero sentinel
    tabs = svc.dev.arrays()
    enc = [[torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in encode_batch(svc.inc, b, batch=BATCH, depth=depth)]
           for b in batches]
    rng = np.random.default_rng(FANOUT_SEED)
    groups = [rng.choice(n_subs, size=int(rng.integers(2, 4000)),
                         replace=False)
              for _ in range(FANOUT_GROUPS - 1)] + [[]]
    masks = P.make_group_masks(groups, n_subs, W)
    masks_t = torch.from_numpy(masks.view(np.int32)).to(device)
    sel = rng.integers(0, 2**31 - 1, (FANOUT_BATCHES, BATCH)).astype(
        np.int32)
    sel_t = [torch.from_numpy(x).to(device) for x in sel]
    bitmap_s = time.perf_counter() - t0
    # the EP partitions of the service's filters (native tables at 1M)
    t0 = time.perf_counter()
    E = 4
    ep_tabs = P.build_partitions(live, E, depth=depth)
    ep_t = [torch.from_numpy(a).to(device) for a in (
        ep_tabs.node_tabs, ep_tabs.edge_tabs, ep_tabs.seeds)]
    ep_enc = [[torch.from_numpy(np.ascontiguousarray(a)).to(device)
               for a in TopicEncoder(ep_tabs.vocab).encode(
                   b, depth, batch=BATCH)] for b in batches]
    ep_build_s = time.perf_counter() - t0
    capacity = max(32, BATCH // (E * E) * 4)
    if device.type == "cuda":
        torch.cuda.synchronize()

    devs = [device] * 4
    mesh = {k: P.make_mesh(shape, devs) for k, shape in (
        ("tp", {"dp": 1, "tp": 4}), ("ring", {"dp": 1, "ring": 4}),
        ("ep", {"ep": E}), ("u", {"u": 4}))}
    kw = dict(active_slots=A, max_matches=K)
    built = {}
    for plain in (False, True):
        built[plain] = {
            "sharded": P.build_sharded_matcher(mesh["tp"], plain=plain, **kw),
            "sharded_compact": P.build_sharded_matcher_compact(
                mesh["tp"], cap_row=FANOUT_CAP, plain=plain, **kw),
            "selector": P.build_shared_selector(mesh["tp"], plain=plain),
            "ring": P.build_ring_fanout(mesh["ring"], plain=plain, **kw),
            "ring_compact": P.build_ring_fanout_compact(
                mesh["ring"], cap_row=FANOUT_CAP, plain=plain, **kw),
            "ep": P.build_ep_matcher(mesh["ep"], capacity, plain=plain,
                                     **kw),
            "ulysses": P.build_ulysses_step(mesh["u"], plain=plain, **kw)}
    bitmaps: List = []      # the sharded step's bitmaps, the selector's input

    def call(step, i, plain):
        fn = built[plain][step]
        if step == "selector":
            return fn(bitmaps[i], masks_t, sel_t[i])
        if step == "ep":
            return fn(*ep_enc[i], *ep_t)
        return fn(*enc[i], *tabs, bm if step.startswith("ring") else bm_main)

    # (walks, accept_or, bitmap_compact, group_count, group_pick) a
    # dispatch, as each step states them for four positions on one card
    per_dispatch = {
        "sharded": (1, 4, 0, 0, 0), "sharded_compact": (1, 4, 4, 0, 0),
        "selector": (0, 0, 0, 4, 4), "ring": (1, 4, 0, 0, 0),
        "ring_compact": (1, 4, 4, 0, 0), "ep": (E, 0, 0, 0, 0),
        "ulysses": (1, 4, 0, 0, 0)}
    names = ("accept_or", "bitmap_compact", "group_count", "group_pick")
    launches = {k: 0 for k in names}
    walks = 0
    failed: List[str] = []
    steps: Dict[str, Dict] = {}
    outs: Dict[str, List] = {}
    for step, want_n in per_dispatch.items():
        m = mesh["u" if step == "ulysses" else "ep" if step == "ep" else
                 "ring" if step.startswith("ring") else "tp"]
        stream = m.stream_of.get(device)
        host_ms, marks, res = [], [], []
        with m.streams():
            call(step, 0, False)        # warm-up: first-call costs
        if device.type == "cuda":
            torch.cuda.synchronize()
        # -- the main path: counts zeroed just before, read just after --
        _reset_launches()
        bk.reset_launches()
        with m.streams():
            for i in range(FANOUT_BATCHES):
                if stream is not None:
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record(stream)
                t1 = time.perf_counter()
                res.append(call(step, i, False))
                host_ms.append((time.perf_counter() - t1) * 1e3)
                if stream is not None:
                    e1.record(stream)
                    marks.append((e0, e1))
        if device.type == "cuda":
            torch.cuda.synchronize()
        got_n = (walk_kernel.launches, *(bk.launches[k] for k in names))
        route_n = dict(rk.launches)
        # ----------------------------------------------------------------
        dev_ms = [a.elapsed_time(b) for a, b in marks]
        walks += got_n[0]
        for k, n in zip(names, got_n[1:]):
            launches[k] += n
        if device.type == "cuda" and got_n != tuple(
                FANOUT_BATCHES * x for x in want_n):
            failed.append(f"{step}: launches (walk, accept_or, compact, "
                          f"count, pick) {got_n}, want "
                          f"{FANOUT_BATCHES} x {want_n}")
        want_route = {"ep_route": FANOUT_BATCHES if step == "ep" else 0,
                      "ep_merge": FANOUT_BATCHES if step == "ep" else 0}
        if device.type == "cuda" and route_n != want_route:
            failed.append(f"{step}: route kernel launches {route_n}, want "
                          f"{want_route}")
        if step == "sharded":
            bitmaps[:] = [r.bitmap for r in res]
        err = 0
        with m.streams():
            for i in range(FANOUT_PLAIN):
                err = max(err, _max_err(call(step, i, False),
                                        call(step, i, True)))
        if device.type == "cuda":
            torch.cuda.synchronize()
        if err:
            failed.append(f"{step}: kernels differ from the plain versions "
                          f"by {err}")
        outs[step] = res
        steps[step] = {
            "launches_per_dispatch": dict(zip(("walk",) + names, want_n)),
            "step_device_ms": (float(np.mean(dev_ms)) if dev_ms
                               else "not measured"),
            "step_device_ms_p99": (_pct(dev_ms, 99) if dev_ms
                                   else "not measured"),
            "dispatch_host_ms": float(np.mean(host_ms)),
            "plain_batches": FANOUT_PLAIN, "max_abs_err": err}
        if step == "ep":
            steps[step].update(_ep_readings(
                torch, device, m, lambda i, plain: call("ep", i, plain),
                route_n, ep_enc, ep_t, E, capacity, A, K, failed))

    # -- every unflagged row against the oracle ---------------------------
    bad = {k: 0 for k in steps}
    flagged = 0
    picks = 0
    for i in range(FANOUT_BATCHES):
        sh = outs["sharded"][i]
        flag = ((sh.active_overflow > 0) | (sh.match_overflow > 0)).cpu() \
            .numpy()
        flagged += int(flag.sum())
        ok = ~flag
        want = want_bm[i]
        got = sh.bitmap.cpu().numpy().view(np.uint32)
        bad["sharded"] += int((got != want).any(axis=1)[ok].sum())
        popc = np.unpackbits(want.view(np.uint8), axis=1).sum(1)
        bad["sharded"] += int((sh.n_subscribers.cpu().numpy() != popc)[ok]
                              .sum())
        cres = outs["sharded_compact"][i]
        cover = cres.overflow.cpu().numpy().any(axis=1)
        rows = P.decode_compact_rows(cres.ids.cpu().numpy(),
                                     cres.counts.cpu().numpy(), FANOUT_CAP)
        wbits = np.unpackbits(want.view(np.uint8), axis=1, bitorder="little")
        for r in np.flatnonzero(ok & ~cover):
            bad["sharded_compact"] += sorted(rows[r].tolist()) != \
                np.flatnonzero(wbits[r]).tolist()
        picked = outs["selector"][i].cpu().numpy()
        for r in range(0, BATCH, FANOUT_PICK_STRIDE):
            if flag[r]:
                continue
            for g in range(FANOUT_GROUPS):
                picks += 1
                bad["selector"] += int(picked[r, g]) != P.host_pick(
                    want[r], masks[g], int(sel[i, r]))
        bad["selector"] += int((picked[:, -1] != -1).sum())
        ring = outs["ring"][i].cpu().numpy().view(np.uint32)
        bad["ring"] += int((ring != want).any(axis=1)[ok].sum())
        racc, rtr = (x.cpu().numpy() for x in outs["ring_compact"][i])
        rok = ok & (rtr == 0)
        bad["ring_compact"] += int(
            (racc.view(np.uint32) != want).any(axis=1)[rok].sum())
        ep = outs["ep"][i]
        em, en, eo, eov = (x.cpu().numpy() for x in (
            ep.matches, ep.n_matches, ep.owners, ep.overflow))
        for r in np.flatnonzero(ok & (eov == 0)):
            gotf = sorted(ep_tabs.accept_filters[eo[r]][a]
                          for a in em[r][:en[r]])
            bad["ep"] += gotf != want_f[i][r]
        uly = outs["ulysses"][i]
        disp = uly.dispatch_bitmap.full()
        bad["ulysses"] += int((disp != sh.bitmap).any(dim=1).sum())
        dbits = np.unpackbits(disp.cpu().numpy().view(np.uint8), axis=1,
                              bitorder="little").sum(0)
        bad["ulysses"] += int((uly.sub_deliveries.full().cpu().numpy()
                               != dbits).sum())
        back = P.build_unreshard(mesh["u"])(P.build_reshard(mesh["u"])(
            sh.bitmap))
        bad["ulysses"] += int((back.full() != sh.bitmap).any(dim=1).sum())
        steps["ep"].setdefault("overflow_rows", 0)
        steps["ep"]["overflow_rows"] += int(eov.sum())
        steps["sharded_compact"].setdefault("overflow_rows", 0)
        steps["sharded_compact"]["overflow_rows"] += int(cover.sum())
        steps["ring_compact"].setdefault("truncated_rows", 0)
        steps["ring_compact"]["truncated_rows"] += int((rtr > 0).sum())
    for step, n in bad.items():
        steps[step]["rows_differing_from_oracle"] = n
        if n:
            failed.append(f"{step}: {n} rows differ from the oracle")

    # -- each step's bound on the first batch -----------------------------
    first = nfa_match(*enc[0], *tabs, active_slots=A, max_matches=K).matches
    walk_b = (_walk_traffic_bytes(torch, enc[0], [tabs], A)
              + BATCH * (4 * depth + 5))
    rows_b = int(torch.unique(first[first >= 0]).numel()) * W * 4
    for step, st in steps.items():
        if step == "ep":
            continue                    # _ep_readings wrote EP's
        out_b = sum(x.numel() * x.element_size()
                    for x in _fields(outs[step][0]))
        if step == "selector":          # the bitmap, masks and hashes in
            in_b = {"bitmap": BATCH * W * 4, "masks": FANOUT_GROUPS * W * 4,
                    "hashes": BATCH * 4}
        else:                           # one walk, the rows its ids name
            in_b = {"walk": walk_b, "bitmap_rows": rows_b}
        nbytes = {**in_b, "outputs": out_b}
        nbytes["total"] = sum(nbytes.values())
        st.update(bound_bytes=nbytes,
                  bound_ms=nbytes["total"] / HBM_BYTES_PER_S * 1e3,
                  bound_by="bytes")

    # -- each kernel alone at the served shape ----------------------------
    flush = (torch.empty(64 << 20, dtype=torch.int32, device=device).zero_
             if device.type == "cuda" else None)
    Wl = W // 4
    cols = bm_main[:, :Wl]
    ms = [nfa_match(*e, *tabs, active_slots=A, max_matches=K).matches
          for e in enc]
    ors = [bk.accept_or(cols, m_)[0] for m_ in ms]
    bl = [b[:, :Wl] for b in bitmaps]
    ml = masks_t[:, :Wl]
    counts = [bk.group_count_plain(b, masks_t) for b in bitmaps]
    loc = [bk.group_count(b, ml) for b in bl]
    zero = torch.zeros_like(loc[0])
    G = FANOUT_GROUPS
    valid = [int(torch.unique(m_[m_ >= 0]).numel()) for m_ in ms]
    n_valid = [int((m_ >= 0).sum()) for m_ in ms]
    kern = {
        "accept_or": (
            [lambda m_=m_: bk.accept_or(cols, m_) for m_ in ms],
            lambda: bk.accept_or_plain(cols, ms[0]),
            _bitmap_bound([BATCH * K * 4,
                                        float(np.mean(valid)) * Wl * 4],
                          BATCH * (Wl + 1) * 4,
                          float(np.mean(n_valid)) * Wl + BATCH * Wl)),
        "bitmap_compact": (
            [lambda o=o: bk.bitmap_compact(o, FANOUT_CAP) for o in ors],
            lambda: bk.bitmap_compact_plain(ors[0], FANOUT_CAP),
            _bitmap_bound([BATCH * Wl * 4],
                          BATCH * (FANOUT_CAP + 2) * 4, 3.0 * BATCH * Wl)),
        "group_count": (
            [lambda b=b: bk.group_count(b, ml) for b in bl],
            lambda: bk.group_count_plain(bl[0], ml),
            _bitmap_bound([BATCH * Wl * 4, G * Wl * 4],
                          BATCH * G * 4, 3.0 * BATCH * G * Wl)),
        "group_pick": (
            [lambda i=i: bk.group_pick(bl[i], ml, sel_t[i], counts[i], zero,
                                       loc[i], 0)
             for i in range(FANOUT_BATCHES)],
            lambda: bk.group_pick_plain(bl[0], ml, sel_t[0], counts[0],
                                        zero, loc[0], 0),
            _bitmap_bound([BATCH * Wl * 4, G * Wl * 4,
                                         BATCH * 4, 3 * BATCH * G * 4],
                          BATCH * G * 4, 3.0 * BATCH * G * Wl))}
    timing = {}
    for name, (calls, plain, bound) in kern.items():
        timing[name] = {**_time_bitmap(torch, device, calls, plain, flush),
                        **bound}
    if device.type == "cuda":
        _check(all(t["covered"] for t in timing.values()),
               "a bitmap kernel's time was not covered by the sleep")
    line = {"phase": "multichip_fanout", "card": card,
            "subscriptions": len(live), "clients": n_subs,
            "accept_ids": F, "bitmap_shape": [F + 1, W],
            "bitmap_bytes": (F + 1) * W * 4, "batch": BATCH, "D": depth,
            "A": A, "K": K, "batches": FANOUT_BATCHES,
            "mesh": "[cuda:0] * 4" if device.type == "cuda" else "[cpu] * 4",
            "flagged_rows": flagged, "picks_checked": picks,
            "ep": {"parts": E, "capacity": capacity,
                   "partition_filters": [sum(f is not None for f in a)
                                         for a in ep_tabs.accept_filters],
                   "S": int(ep_tabs.node_tabs.shape[1]),
                   "Hb": int(ep_tabs.edge_tabs.shape[1]),
                   "native": len(live) >= P.prefix_ep.NATIVE_FROM,
                   "build_s": ep_build_s},
            "oracle_s": oracle_s, "bitmap_build_s": bitmap_s,
            "steps": steps, "kernels": timing, "launches": launches,
            "walk_launches": walks}
    line["wall_s"] = time.perf_counter() - t_start
    _emit_checked(line, failed)
    return {"launches": launches, "walk_launches": walks, "timing": timing,
            "max_abs_err": max(x["max_abs_err"] for x in steps.values()),
            "route_launches": steps["ep"]["route_kernel_launches"],
            "route_timing": steps["ep"]["route_kernels"]}


def _ep_readings(torch, device, mesh, call, route_n, ep_enc, ep_t, E: int,
                 capacity: int, A: int, K: int, failed: List[str]) -> Dict:
    """The EP step's (K8c) readings beside the other fan-out steps': the
    route kernels' launches a dispatch, device operations a dispatch
    from a profiler trace, the plain step's device ms in turns with the
    kernel step's, each route kernel alone on the main path's operands
    against its plain version, and the step's bytes bound (the walks'
    gathered table rows on the landed grids, the batch, the grid and the
    outputs, each once)."""
    from emqx_tpu_torch import parallel as P

    out: Dict = {"route_kernel_launches": route_n,
                 "route_launches_per_dispatch": {
                     k: n / FANOUT_BATCHES for k, n in route_n.items()}}
    stream = mesh.stream_of.get(device)
    ops: Dict = {"per_dispatch": "not measured"}
    turns: Dict[bool, List[float]] = {False: [], True: []}
    if device.type == "cuda":
        with mesh.streams():
            ops = _device_ops(torch, lambda: call(0, False))
            for plain in (True, False, False, True):   # in turns
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record(stream)
                call(1, plain)
                e1.record(stream)
                torch.cuda.synchronize()
                turns[plain].append(e0.elapsed_time(e1))
        if isinstance(ops["per_dispatch"], int) and \
                ops["per_dispatch"] > 2 * E + 8:
            failed.append(f"ep: {ops['per_dispatch']} device operations a "
                          f"dispatch, want <= 2·E + 8")
    out["device_ops"] = ops
    out["kernel_step_ms_in_turns"] = turns[False] or "not measured"
    out["plain_step_ms_in_turns"] = turns[True] or "not measured"
    with _Capture() as cap:
        fresh = P.build_ep_matcher(mesh, capacity, active_slots=A,
                                   max_matches=K)
        with mesh.streams():
            for enc in ep_enc[:FANOUT_PLAIN]:
                fresh(*enc, *ep_t)
    route_t = _route_kernel_timing(torch, device, cap.calls,
                                   _route_bounds(torch, cap.calls))
    for name, t in route_t.items():
        if t["max_abs_err"]:
            failed.append(f"ep: {name} differs from its plain version by "
                          f"{t['max_abs_err']}")
    out["route_kernels"] = route_t
    w, l, s = ep_enc[0]
    B, D = (int(x) for x in w.shape)
    rows = _landed(torch, w, l, s, None, E, capacity)
    walks = sum(_walk_traffic_bytes(torch, rows[o],
                                    [(ep_t[0][o], ep_t[1][o], ep_t[2][o])],
                                    A) for o in range(E))
    nbytes = {"walks": walks, "batch": B * (4 * D + 5),
              "grid": E * E * capacity * (4 * D + 9),
              "outputs": B * (K + 3) * 4}
    nbytes["total"] = sum(nbytes.values())
    out.update(bound_bytes=nbytes,
               bound_ms=nbytes["total"] / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes")
    return out


def phase_dryrun_multichip(torch, device, card: str) -> Dict:
    """``dryrun_multichip([device] * 4)``: the reference's dry run of
    every fan-out step (4,096 topics, 65,536 subscribers, K = 16), each
    checked against the single-device walk and the host oracles."""
    from emqx_tpu_torch.ops import bitmap_kernel as bk
    from emqx_tpu_torch.ops import walk_kernel
    from emqx_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    _reset_launches()
    bk.reset_launches()
    out = dryrun_multichip([device] * 4, verbose=False)
    line = {"phase": "dryrun_multichip", "ok": True, "card": card,
            "devices": [str(device)] * 4, **out,
            "walk_launches": walk_kernel.launches,
            "bitmap_launches": dict(bk.launches),
            "wall_s": time.perf_counter() - t0}
    if device.type == "cuda":
        # no compact form in the dry run: every other kernel launches
        _check(walk_kernel.launches > 0 and bk.launches["bitmap_compact"]
               == 0 and all(n for k, n in bk.launches.items()
                            if k != "bitmap_compact"),
               f"dryrun_multichip launched {dict(bk.launches)}")
    emit(line)
    return {"launches": dict(bk.launches),
            "walk_launches": walk_kernel.launches}


def _route_entries(mc: Dict, fan: Dict) -> List[Dict]:
    """The route kernels' entries of the kernels line: launches on the
    multichip, multichip_fanout (EP) and slice_node_multichip main
    paths; times at the routed form's shape (each form's and EP's
    beside), bounds and plain versions' times, from their captured
    main-path operands."""
    out = []
    for name, replaces in ROUTE_KERNELS.items():
        by_form = {form: t[name] for form, t in mc["route_timing"].items()
                   if name in t}
        if name in fan["route_timing"]:
            by_form["ep"] = fan["route_timing"][name]
        t = by_form["routed"]
        by_path = {"multichip": mc["route_launches"][name],
                   "multichip_fanout": fan["route_launches"][name],
                   "node_multichip": NODE_ROUTE_LAUNCHES.get(name, 0)}
        out.append({
            "name": name, "route": "cuda", "source": ROUTE_SOURCE,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "registers": _registers("ep_route", f"{name}_kernel"),
            "max_abs_err": max(x["max_abs_err"] for x in by_form.values()),
            "ms": t["ms"], "ms_cold": t["ms_cold"],
            "plain_ms": t["plain_ms"], "plain_timing": t["plain_timing"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "shape": "routed",
            "by_form": {form: {k: x[k] for k in ("ms", "ms_cold",
                                                  "plain_ms", "bound_ms")}
                        for form, x in by_form.items()}})
    return out


def _bitmap_entries(fan: Dict, dry: Dict) -> List[Dict]:
    """The four bitmap kernels' entries of the kernels line: launches on
    the multichip_fanout main path (and the dry run's), their times at
    the served shape, bounds and plain versions' times."""
    out = []
    for name, replaces in BITMAP_KERNELS.items():
        t = fan["timing"][name]
        out.append({
            "name": name, "route": "cuda", "source": BITMAP_SOURCE,
            "replaces": replaces, "launches": fan["launches"][name],
            "launches_by_path": {"multichip_fanout": fan["launches"][name],
                                 "dryrun_multichip": dry["launches"][name]},
            "registers": _registers("bitmap_fanout", f"{name}_kernel"),
            "max_abs_err": fan["max_abs_err"], "ms": t["ms"],
            "ms_cold": t["ms_cold"], "plain_ms": t["plain_ms"],
            "plain_timing": t["plain_timing"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    return out


def phase_slice_join(torch, device, n_filters: int, shared=None) -> Dict:
    """The join backend's serve path at 1M filters, through a churn that
    fits the overlay and one that overflows it."""
    from emqx_tpu_torch.ops import walk_kernel

    n_small = JOIN_SMALL_BATCHES
    t_start = time.perf_counter()
    svc, trie, filters, topics = _build_service(
        torch, device, n_filters, SERVE_BATCHES + n_small + AFTER_BATCHES,
        "join", "native", "slice_join_build", shared)
    dev = svc.dev
    encoded0 = svc.encoder.native_batches

    # -- the main path: counts zeroed just before, read just after -------
    _reset_launches()
    d0, j0 = svc.dispatches, svc.join_dispatches
    bad = _serve_batches(svc, trie, topics, 0, SERVE_BATCHES)
    rng = np.random.default_rng(4)
    order = rng.permutation(len(filters))
    n_rm, n_add = SMALL_CHURN
    gone_small = [filters[i] for i in order[:n_rm]]
    gone_big = [filters[i] for i in order[n_rm:n_rm + CHURN]]
    fresh = _fresh_filters(set(filters), n_add + CHURN, 5)
    # 1. new edges that fit the overlay: written in place
    rebuilds0, uploads0 = dev.join_rebuilds, dev.uploads
    small_s = _churn(torch, device, svc, trie, gone_small, fresh[:n_add])
    rel_small = _relation_state(dev)
    _check(dev.join_rebuilds == rebuilds0 and dev.uploads == uploads0,
           "the in-overlay churn rebuilt the relation or the tables")
    _check(rel_small["overlay_rows"] > 0 and rel_small["tombstones"] > 0,
           f"the in-overlay churn left no overlay rows or tombstones: "
           f"{rel_small}")
    bad += _serve_batches(svc, trie, topics, SERVE_BATCHES, n_small)
    # 2. 1000 removes + 1000 adds: the overlay overflows, one rebuild
    key1 = svc.inc.shape_key()
    big_s = _churn(torch, device, svc, trie, gone_big, fresh[n_add:])
    grew = svc.inc.shape_key() != key1
    rel_big = _relation_state(dev)
    _check(dev.join_rebuilds > rebuilds0,
           "the overflowing churn did not rebuild the relation")
    _check(grew or dev.uploads == uploads0,
           "the overflowing churn re-uploaded the tables without growth")
    bad += _serve_batches(svc, trie, topics, SERVE_BATCHES + n_small,
                          AFTER_BATCHES)
    launches = walk_kernel.join_launches
    hash_launches = walk_kernel.launches
    flat = _flat_launches(device, "slice_join", launches + hash_launches)
    dispatches = svc.dispatches - d0
    join_dispatches = svc.join_dispatches - j0
    # ---------------------------------------------------------------------
    _undo_churn(trie, gone_small + gone_big, fresh)
    _check(bad == 0, f"{bad} served answers differ from the trie oracle")
    _check(join_dispatches == dispatches, "a dispatch left the join backend")
    _check(svc.table_kind == "native", "the join slice is not native")
    _check(svc.encoder.native_batches - encoded0 == dispatches
           and svc.encoder.python_batches == 0,
           "the native encoder did not encode every dispatch")
    if device.type == "cuda":
        _check(launches == join_dispatches > 0,
               f"join kernel launches {launches} != join dispatches "
               f"{join_dispatches}")
        _check(hash_launches == 0, "the hash kernel ran on the join path")
    emit({"phase": "slice_join", "ok": True, "table_kind": svc.table_kind,
          "served_topics": svc.topics,
          "batches": SERVE_BATCHES + n_small + AFTER_BATCHES,
          "mismatches": bad, "join_dispatches": join_dispatches,
          "join_kernel_launches": launches,
          "hash_kernel_launches": hash_launches,
          "flat_epilogue_launches": flat,
          "small_churn": {"removed": n_rm, "added": n_add, "sync_s": small_s,
                          "relation": rel_small},
          "big_churn": {"removed": len(gone_big), "added": CHURN,
                        "sync_s": big_s, "grew_table": grew,
                        "relation": rel_big},
          "join_rebuilds": dev.join_rebuilds, "uploads": dev.uploads,
          "delta_applies": dev.delta_applies,
          "host_reruns": svc.fallback_host,
          "native_encodes": svc.encoder.native_batches - encoded0,
          "wall_s": time.perf_counter() - t_start})
    return {"svc": svc, "topics": topics, "launches": launches,
            "spill_share": svc.fallback_host / svc.topics}


def phase_slice_python(torch, device, n_filters: int) -> Dict:
    """The hash serve path on the Python ``IncrementalNfa`` table (the
    reference's debug twin) at a smaller size: phase 4's checks."""
    return phase_slice(torch, device, n_filters, table="python",
                       name="slice_python")


def phase_python_segments(torch, device, svc, build_s: float,
                          card: str) -> Dict:
    """``python_segments`` on the 100k Python table of slice_python: a
    ``state`` segment written and restored (its seconds against the
    table's build, the arrays and the walk on the card equal), then the
    restored table in region mode grown in place through a cuckoo rehash
    on the card: ``grow_applies`` ≥ 1, no whole upload, and node, edge
    and seed tensors bit-equal to a whole upload of the same host table
    (the walks on both equal too)."""
    import shutil

    from emqx_tpu_torch.ops import DeviceNfa, encode_batch, walk_kernel
    from emqx_tpu_torch.storage.segments import (load_segment,
                                                 restore_incremental,
                                                 save_segment)
    from emqx_tpu_torch.workload import build_workload

    t_start = time.perf_counter()
    seg_dir = os.path.join(ROOT, "data", "chip_smoke_segments")
    os.makedirs(seg_dir, exist_ok=True)
    path = os.path.join(seg_dir, "python.seg.npz")
    inc = svc.inc
    t0 = time.perf_counter()
    save_segment(path, inc, deep=svc._deep, routing_aids={
        aid for aid, f in enumerate(svc._filter_of) if f is not None})
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seg = load_segment(path)
    inc2 = restore_incremental(seg)
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    inc2._hydrate()
    hydrate_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    shutil.rmtree(seg_dir, ignore_errors=True)
    same = (np.array_equal(inc.node_tab, inc2.node_tab)
            and np.array_equal(inc.edge_tab, inc2.edge_tab)
            and np.array_equal(inc.seeds, inc2.seeds)
            and inc.vocab == inc2.vocab
            and list(inc.accept_filters) == list(inc2.accept_filters))
    _check(same, "the restored table differs from the saved one")
    kw = dict(active_slots=svc.dev.active_slots,
              max_matches=svc.dev.max_matches, device=device)
    inc2.track_regions = True
    dev = DeviceNfa(inc2, **kw)
    dev.dirty_regions = True
    dev.dirty_full_threshold = 0.5
    uploads0, key0 = dev.uploads, inc2.shape_key()
    have = set(inc2.filters())
    added = 0
    for f in _fresh_filters(have, 20_000, 41):
        inc2.add(f)
        added += 1
        if added % 500 == 0 or inc2.shape_key() != key0:
            dev.sync()
            if inc2.shape_key() != key0:
                break
    grew = inc2.shape_key() != key0
    full = DeviceNfa(inc2, **kw)
    bit_equal = [bool(torch.equal(a, b))
                 for a, b in zip(dev.arrays(), full.arrays())]
    _, topics = build_workload(np.random.default_rng(43), 16, BATCH)
    enc = encode_batch(inc2, topics, batch=BATCH, depth=inc2.depth)
    # -- the main path: counts zeroed just before, read just after -------
    _reset_launches()
    got = dev.match(*dev.put_batch(*enc), flat_cap=8 * BATCH)
    launches = walk_kernel.launches
    flat = _flat_launches(device, "python_segments", launches)
    # ---------------------------------------------------------------------
    want = full.match(*full.put_batch(*enc), flat_cap=8 * BATCH)
    walks_equal = all(bool(torch.equal(a, b)) for a, b in zip(got, want)
                      if a is not None)
    line = {"phase": "python_segments", "ok": True, "card": card,
            "filters": inc.n_filters, "segment_bytes": size,
            "build_s": build_s, "save_s": save_s, "restore_s": restore_s,
            "hydrate_s": hydrate_s, "restore_over_build":
                (restore_s + hydrate_s) / build_s,
            "grow": {"filters_added": added, "shape_before": key0,
                     "shape_after": inc2.shape_key(), "grew": grew,
                     "grow_applies": dev.grow_applies,
                     "whole_uploads_after_first": dev.uploads - uploads0,
                     "dirty_rows_uploaded": dev.dirty_rows_uploaded,
                     "node_edge_seeds_bit_equal": bit_equal,
                     "walks_equal": walks_equal},
            "kernel_launches": launches, "flat_epilogue_launches": flat,
            "wall_s": time.perf_counter() - t_start}
    failed = [what for ok, what in (
        (grew and dev.grow_applies >= 1, "the table never grew in place"),
        (dev.uploads == uploads0, "the grow uploaded the tables whole"),
        (all(bit_equal), f"grown tables differ from a whole upload: "
         f"{bit_equal}"),
        (walks_equal, "the walk on the grown table differs"))
        if not ok]
    if device.type == "cuda":
        failed += [what for ok, what in (
            (launches == 1, f"{launches} launches for one walk"),)
            if not ok]
    _emit_checked(line, failed)
    return {"launches": launches}


def _workload_proc(conn, n_filters: int, n_topics: int) -> None:
    """A spawned child: the workload generator's ``(filters, topics)``
    (seed 0) and its seconds, sent back over ``conn``."""
    from emqx_tpu_torch.workload import build_workload

    t0 = time.perf_counter()
    out = build_workload(np.random.default_rng(0), n_filters, n_topics)
    conn.send((time.perf_counter() - t0, out))
    conn.close()


class _BackgroundWorkload:
    """BASELINE config 3's workload generated in a spawned child process
    while the earlier phases run (it took 90 s inline on the H100's
    host)."""

    def __init__(self, n_filters: int, n_topics: int) -> None:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.conn, child = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_workload_proc,
                                args=(child, n_filters, n_topics),
                                daemon=True)
        self.proc.start()
        child.close()

    def result(self):
        """``(seconds in the child, filters, topics)``."""
        try:
            gen_s, (filters, topics) = self.conn.recv()
        except EOFError:
            raise PhaseError("the workload process died") from None
        self.proc.join(30)
        self.close()
        return gen_s, filters, topics

    def close(self) -> None:
        """Stop the child (at once, if its result was not taken)."""
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(5)
        self.conn.close()


def phase_10m_build(torch, device, n_filters: int, pending=None) -> Dict:
    """BASELINE config 3's table: ``n_filters`` workload filters (seed 0,
    depth-8 Zipfian; ``pending``'s, a :class:`_BackgroundWorkload`, when
    given) started with ``load`` on the native table, the join mirror
    enabled on the same ``DeviceNfa``, and the filter-set oracle built
    after the table."""
    from emqx_tpu_torch.broker.match_service import MatchService
    from emqx_tpu_torch.broker.trie import FilterSet
    from emqx_tpu_torch.workload import build_workload

    t0 = time.perf_counter()
    if pending is not None:
        gen_s, filters, topics = pending.result()
    else:
        filters, topics = build_workload(np.random.default_rng(0), n_filters,
                                         BATCHES_10M * BATCH)
        gen_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    svc = MatchService(device=device, table="auto")
    _check(svc.table_kind == "native", "table 'auto' is not native")
    _check(svc.load(filters) == len(filters), "load() lost filters")
    t2 = time.perf_counter()
    upload_s = _sync(torch, device, svc)
    t3 = time.perf_counter()
    svc.dev.enable_join()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t4 = time.perf_counter()
    oracle = FilterSet(filters)
    t5 = time.perf_counter()
    emit({"phase": "slice_10m_build", "ok": True, "filters": len(filters),
          **_table_info(svc), "workload_s": gen_s,
          "workload_in_background": pending is not None,
          "workload_wait_s": t1 - t0,
          "host_build_s": t2 - t1, "load_seconds": svc.load_seconds,
          "upload_s": upload_s, "join_mirror_s": t4 - t3,
          "oracle_build_s": t5 - t4, "wall_s": t5 - t0})
    return {"svc": svc, "oracle": oracle, "filters": filters,
            "topics": topics}


def phase_10m(torch, device, b: Dict, rules) -> Dict:
    """The 10M table served on ``hash`` and on ``join`` (one table, one
    device twin): every served topic against the filter-set oracle,
    before and after 1,000 removes and 1,000 adds.  The removes are
    synced before the adds, so that the adds reuse freed accept ids.
    Before the churn, ``rules`` (slice_node_rules' set) are co-batched
    into the table (``register_rule``); after it, ``slice_10m_rules``
    holds the rule ids of ``RULE_BATCHES_10M`` batches of 2048 topics
    (``serve_split``: the same walks as ``serve()``, the rule half of
    each row) to the host trie of the rule filters."""
    from emqx_tpu_torch.ops import walk_kernel

    t_start = time.perf_counter()
    svc, oracle, filters, topics = (b["svc"], b["oracle"], b["filters"],
                                    b["topics"])
    before = BATCHES_10M - AFTER_BATCHES_10M
    rng = np.random.default_rng(6)
    gone = [filters[i] for i in rng.choice(len(filters), CHURN,
                                           replace=False)]
    fresh = _fresh_filters(oracle, CHURN, 7)

    def serve_both(first: int, count: int) -> int:
        bad = 0
        for i in range(first, first + count):
            batch = topics[i * BATCH:(i + 1) * BATCH]
            want = [set(oracle.match(t)) for t in batch]
            for be in ("hash", "join"):
                svc.backend = be     # one table, both walks
                got = svc.serve(batch)
                _check(len(got) == len(batch), "serve() lost rows")
                bad += sum(set(r) != w for r, w in zip(got, want))
        return bad

    # -- the main path: counts zeroed just before, read just after -------
    _reset_launches()
    d0, j0 = svc.dispatches, svc.join_dispatches
    enc0 = (svc.encoder.native_batches, svc.encoder.python_batches)
    reuses0, uploads0, key0 = (svc.inc.aid_reuses, svc.dev.uploads,
                               svc.inc.shape_key())
    rebuilds0 = svc.dev.join_rebuilds
    bad = serve_both(0, before)
    n_filters0 = svc.inc.n_filters
    for rid, froms, _thr in rules:
        svc.register_rule(rid, froms)
    rule_sync_s = _sync(torch, device, svc)
    rule_filters = svc.inc.n_filters - n_filters0
    for f in gone:
        _check(svc.remove(f), f"remove {f!r}")
        oracle.delete(f)
    remove_s = _sync(torch, device, svc)
    rel_removed = _relation_state(svc.dev)
    for f in fresh:
        _check(svc.add(f), f"add {f!r}")
        oracle.insert(f)
    add_s = _sync(torch, device, svc)
    rel_added = _relation_state(svc.dev)
    reuses = svc.inc.aid_reuses - reuses0
    bad += serve_both(before, AFTER_BATCHES_10M)
    launches = walk_kernel.launches
    join_launches = walk_kernel.join_launches
    flat = _flat_launches(device, "slice_10m", launches + join_launches)
    join_dispatches = svc.join_dispatches - j0
    hash_dispatches = svc.dispatches - d0 - join_dispatches
    native_encodes = svc.encoder.native_batches - enc0[0]
    python_encodes = svc.encoder.python_batches - enc0[1]
    # ---------------------------------------------------------------------
    svc.backend = "hash"
    grew = svc.inc.shape_key() != key0
    _check(bad == 0, f"{bad} served answers differ from the filter-set "
           "oracle")
    _check(reuses > 0, "no add reused a freed accept id")
    _check(grew or svc.dev.uploads == uploads0,
           "the churn re-uploaded the tables without growth")
    _check(native_encodes == hash_dispatches + join_dispatches
           and python_encodes == 0,
           "the native encoder did not encode every 10M batch")
    if device.type == "cuda":
        _check(launches == hash_dispatches > 0,
               f"hash launches {launches} != dispatches {hash_dispatches}")
        _check(join_launches == join_dispatches > 0,
               f"join launches {join_launches} != dispatches "
               f"{join_dispatches}")
    emit({"phase": "slice_10m", "ok": True, "table_kind": svc.table_kind,
          "served_topics_per_backend": BATCHES_10M * BATCH,
          "mismatches": bad, "hash_dispatches": hash_dispatches,
          "join_dispatches": join_dispatches,
          "hash_kernel_launches": launches,
          "join_kernel_launches": join_launches,
          "flat_epilogue_launches": flat,
          "native_encodes": native_encodes,
          "python_encodes": python_encodes,
          "churn": {"removed": len(gone), "added": len(fresh),
                    "remove_sync_ms": remove_s * 1e3,
                    "add_sync_ms": add_s * 1e3, "aid_reuses": reuses,
                    "grew_table": grew,
                    "relation_after_removes": rel_removed,
                    "relation_after_adds": rel_added,
                    "join_rebuilds": svc.dev.join_rebuilds - rebuilds0},
          "uploads": svc.dev.uploads, "delta_applies": svc.dev.delta_applies,
          "host_reruns": svc.fallback_host,
          "wall_s": time.perf_counter() - t_start})
    # -- the rule path: counts zeroed just before, read just after -------
    t0 = time.perf_counter()
    oracle_rules = _RuleOracle(rules)
    _reset_launches()
    d0 = svc.dispatches
    rule_bad = matched = 0
    for i in range(RULE_BATCHES_10M):
        batch = topics[i * BATCH:(i + 1) * BATCH]
        for t, (_f, rids) in zip(batch, svc.serve_split(batch)):
            rule_bad += rids != oracle_rules(t)
            matched += len(rids)
    rule_launches = walk_kernel.launches
    rule_dispatches = svc.dispatches - d0
    rule_join_launches = walk_kernel.join_launches
    rule_flat = _flat_launches(device, "slice_10m_rules",
                               rule_launches + rule_join_launches)
    # ---------------------------------------------------------------------
    _check(rule_bad == 0, f"{rule_bad} rule-id lists at 10M differ from "
           "the host trie of the rule filters")
    _check(matched > 0, "no topic matched a rule at 10M")
    if device.type == "cuda":
        _check(rule_launches == rule_dispatches > 0
               and rule_join_launches == 0,
               f"rule path launches {rule_launches} != dispatches "
               f"{rule_dispatches}")
    emit({"phase": "slice_10m_rules", "ok": True, "rules": len(rules),
          "rule_filters_added_to_table": rule_filters,
          "rule_filters": len(oracle_rules.by_filter),
          "rule_sync_ms": rule_sync_s * 1e3,
          "topics_checked": RULE_BATCHES_10M * BATCH,
          "rule_id_mismatches": rule_bad,
          "rules_matched_per_topic": matched / (RULE_BATCHES_10M * BATCH),
          "walk_dispatches": rule_dispatches,
          "kernel_launches": rule_launches,
          "join_kernel_launches": rule_join_launches,
          "flat_epilogue_launches": rule_flat,
          "wall_s": time.perf_counter() - t0})
    # the timing phases' distinct batches: every served topic
    return {"svc": svc, "topics": topics, "launches": launches,
            "join_launches": join_launches, "rule_launches": rule_launches,
            "rule_join_launches": rule_join_launches,
            "spill_share": svc.fallback_host / svc.topics}


def _routes_key(routes) -> str:
    """A route list as one string (untracked by the collector)."""
    return "\n".join(sorted(f"{f}\t{d}" for f, d in routes))


class _RouteLog:
    """``Broker.device_match`` for the storms: the service's
    ``hint_routes``, logging each route list it returns with the router
    epoch of that moment, for :func:`_verify_routes` after the storm (an
    inline oracle walk would add its cost to every other publisher's
    wait on the shared event loop).  The log is three lists of strings
    and ints, so that it adds no objects for the collector to walk."""

    def __init__(self, ms, router) -> None:
        self.ms, self.router = ms, router
        self.topics: List[str] = []
        self.keys: List[str] = []
        self.epochs: List[int] = []
        self.calls = 0

    def __call__(self, topic: str):
        self.calls += 1
        routes = self.ms.hint_routes(topic)
        if routes is not None:
            self.topics.append(topic)
            self.keys.append(_routes_key(routes))
            self.epochs.append(self.router.epoch)
        return routes


def _verify_routes(router, log: _RouteLog) -> int:
    """Mismatches of the logged route lists against
    ``router.match_routes(topic)`` as it stood at the logged epoch: the
    routes of now, with every route mutation after that epoch on a
    filter that matches the topic undone, newest first (the router's
    delta log holds them all)."""
    from emqx_tpu_torch import topic as T
    from emqx_tpu_torch.broker.router import Route
    from emqx_tpu_torch.broker.trie import FilterTrie

    if not log.topics:
        return 0
    deltas = router.deltas_since(min(log.epochs))
    _check(deltas is not None, "the router's delta log no longer reaches "
           "the storm's first epoch")
    by_filter: Dict[str, List] = {}
    wild = FilterTrie()
    for d in deltas:
        if d.filter not in by_filter and T.wildcard(d.filter):
            wild.insert(d.filter)
        by_filter.setdefault(d.filter, []).append(d)
    now: Dict[str, tuple] = {}
    bad = 0
    for topic, key, epoch in zip(log.topics, log.keys, log.epochs):
        if topic not in now:
            touched = [d for f in wild.match(topic) + [topic]
                       for d in by_filter.get(f, ())]
            now[topic] = (set(router.match_routes(topic)),
                          sorted(touched, key=lambda d: -d.epoch))
        want, touched = now[topic]
        want = set(want)
        for d in touched:
            if d.epoch <= epoch:
                break
            (want.discard if d.op == "add" else want.add)(
                Route(d.filter, d.dest))
        bad += key != _routes_key(want)
    return bad


class _LogCount(logging.Handler):
    """Counts the service's records of failed device batches and of
    prefetches that timed out (both logged at debug).  A batch refused
    because an accept id was reused while it was in flight (the service's
    ``_StaleRace``) is counted apart: the fixed-window phases report it,
    the fanout phases fail on it."""

    def __init__(self) -> None:
        super().__init__(logging.DEBUG)
        self.reset()

    def reset(self) -> None:
        self.failed = self.timeouts = self.stale_races = self.errors = 0
        self.first = None

    def emit(self, record) -> None:
        from emqx_tpu_torch.broker.match_service import _StaleRace

        msg = record.getMessage()
        if record.levelno >= logging.ERROR:     # the fanout's failures
            self.errors += 1
        elif msg.startswith("device batch failed"):
            if record.exc_info and isinstance(record.exc_info[1],
                                              _StaleRace):
                self.stale_races += 1
                return
            self.failed += 1
        elif "timed out" in msg:
            self.timeouts += 1
        else:
            return
        if self.first is None:
            self.first = msg + " " + repr(record.exc_info and
                                          record.exc_info[1])


async def _storm(ms, broker, topics, lo: int, hi: int,
                 lat: List[float], payloads=None,
                 waits: List[float] = None) -> Dict[str, float]:
    """``STORM_TASKS`` publisher tasks, each taking the next topic of
    ``topics[lo:hi]``: ``await ms.prefetch(topic)`` (none when ``ms`` is
    None, the host trie), then ``broker.publish``, then one yield to the
    event loop, as a connection's read of its next packet yields.
    Appends each publish's seconds (prefetch and publish) to ``lat``.
    With ``payloads`` the i-th publish carries ``payloads[i]`` from
    sender ``pub<i % STORM_TASKS>`` (what a rule sees of it depends on
    the message alone), else ``b"x"`` from its task's sender.  With
    ``waits`` each prefetch's own seconds are appended there too."""
    from emqx_tpu_torch.broker.message import make_message

    nxt = [lo]
    delivered = [0]

    async def publisher(k: int) -> None:
        sender = f"pub{k}"
        payload = b"x"
        while nxt[0] < hi:
            i = nxt[0]
            topic = topics[i]
            nxt[0] += 1
            if payloads is not None:
                payload = payloads[i]
                sender = f"pub{i % STORM_TASKS}"
            t0 = time.perf_counter()
            if ms is not None:
                await ms.prefetch(topic, qos=0)
                if waits is not None:
                    waits.append(time.perf_counter() - t0)
            # the result is not held across the yield, as a connection
            # does not hold it: 2048 of them would outlive the young
            # collections and load the full ones
            matched = broker.publish(
                make_message(sender, topic, payload)).matched
            lat.append(time.perf_counter() - t0)
            delivered[0] += matched
            await asyncio.sleep(0)

    t0 = time.perf_counter()
    await asyncio.gather(*[publisher(k) for k in range(STORM_TASKS)])
    return {"wall_s": time.perf_counter() - t0, "delivered": delivered[0]}


async def _broker_churn(ms, broker, add, remove,
                        rate: float = NODE_CHURN_RATE) -> Dict:
    """Subscribe ``add`` and unsubscribe ``remove`` ((client, filter)
    pairs) through the broker, ``rate`` of each a second on the wall
    clock (a late wake of the busy loop does at once what fell due
    meanwhile), whatever the service's state; then wait until the
    device table reflects the last of them.  ``max_lag`` is the most
    router mutations the device table trailed by at a churn step, and
    ``steps_past_stale_bound`` counts the steps at which it trailed by
    more than the service serves with.  With ``ms`` None (the host trie
    alone) there is no device table to trail."""
    n = max(len(add), len(remove))
    done = max_lag = past = 0
    t0 = time.perf_counter()
    while done < n:
        due = min(n, int((time.perf_counter() - t0) * rate) + 1)
        for cid, flt in add[done:due]:
            broker.subscribe(cid, flt)
        for cid, flt in remove[done:due]:
            _check(broker.unsubscribe(cid, flt), f"unsubscribe {flt!r}")
        done = due
        if ms is not None:
            lag = broker.router.epoch - ms._synced_epoch
            max_lag = max(max_lag, lag)
            past += lag > ms.max_stale_deltas
        await asyncio.sleep(max(0.0, t0 + done / rate - time.perf_counter()))
    epoch = broker.router.epoch
    t1 = time.perf_counter()
    while ms is not None and ms._synced_epoch < epoch:
        await asyncio.sleep(0.001)
    return {"subscribed": len(add), "unsubscribed": len(remove),
            "rate_per_s": rate, "churn_s": t1 - t0, "max_lag": max_lag,
            "steps_past_stale_bound": past,
            "last_subscribe_to_synced_ms": (time.perf_counter() - t1) * 1e3}


def _node_churn(broker, filters, rng_seed: int, topics) -> tuple:
    """``NODE_CHURN`` fresh workload filters for existing clients, and
    ``NODE_CHURN`` subscribed (client, filter) pairs to drop; with the
    number of ``topics`` a fresh filter matches."""
    from emqx_tpu_torch.broker.trie import FilterTrie

    rng = np.random.default_rng(rng_seed)
    held = set(broker.router.wildcard_filters())
    fresh = _fresh_filters(held, NODE_CHURN, rng_seed)
    cids = sorted(broker.sessions)
    add = [(cids[int(i)], f) for i, f in
           zip(rng.integers(len(cids), size=len(fresh)), fresh)]
    # clients that still hold a subscription (all of them at 1M; a
    # rehearsal's few per client run out after the earlier churns)
    holders = [c for c in cids if broker.sessions[c].subscriptions]
    drop = []
    for i in rng.choice(len(holders), NODE_CHURN, replace=False):
        subs = sorted(broker.sessions[holders[int(i)]].subscriptions)
        drop.append((holders[int(i)], subs[int(rng.integers(len(subs)))]))
    trie = FilterTrie()
    for f in fresh:
        trie.insert(f)
    hit = sum(1 for t in topics if trie.match(t))
    return add, drop, hit


def _storm_line(res: Dict, lat: List[float], n: int, gcp, ms, m0, m1,
                card: str) -> Dict:
    """The numbers of one storm: rates, latency, the publishes' shares,
    the batches, the collector."""
    served = m1["tpu.match.hint_served"] - m0["tpu.match.hint_served"]
    rode = m1["tpu.match.topics"] - m0["tpu.match.topics"]
    bypass = m1["tpu.match.bypass"] - m0["tpu.match.bypass"]
    batch_ms = ms._batch_ms[ms._batch_ms_at:] or [0.0]
    batches = len(ms._batch_ms) - ms._batch_ms_at
    return {
        "card": card, "publishes": n,
        "publishes_per_s": n / res["wall_s"],
        "p50_ms": _pct(lat, 50) * 1e3, "p99_ms": _pct(lat, 99) * 1e3,
        "max_ms": max(lat) * 1e3,
        "share": {"device_hint": served / n,
                  "rode_a_batch": rode / n,
                  "fresh_hint_at_prefetch": (served - rode) / n,
                  "bypassed": bypass / n, "host_trie": 1 - served / n},
        "hint_served": served, "hint_stale":
            m1["tpu.match.hint_stale"] - m0["tpu.match.hint_stale"],
        "hint_evicted":
            m1["tpu.match.hint_evicted"] - m0["tpu.match.hint_evicted"],
        "host_reruns": (m1["tpu.match.fallback_host"]
                        - m0["tpu.match.fallback_host"]),
        "device_batches": batches,
        "mean_batch_topics": rode / max(1, batches),
        "batch_ms": {"mean": float(np.mean(batch_ms)),
                     "p99": _pct(batch_ms, 99), "max": max(batch_ms)},
        "batches_per_s": batches / res["wall_s"],
        "deliveries_per_publish": res["delivered"] / n,
        "gc": {**gcp.summary(), "full_collections": gcp.count[2],
               "full_ms": gcp.pause_ms[2]}}


async def _busy_storm(torch, device, ms, broker, topics, lo, hi,
                      payloads=None) -> Dict:
    """Device busy share of the card over a storm of ``topics[lo:hi]``
    (``torch.profiler``); not measured on the CPU."""
    out = await _busy(torch, device, lambda: _storm(
        ms, broker, topics, lo, hi, [], payloads))
    out["publishes"] = hi - lo
    return out


def _count_batches(ms) -> None:
    """Count and time the serve loop's batches (``ms._batch_ms``, one
    entry a batch: dispatch to hints minted; ``ms._batch_sizes``, its
    waiters) by wrapping its batch stage (the deadline loop's own with
    ``deadline``)."""
    name = "_serve_batch_deadline" if ms.deadline else "_serve_batch"
    inner = getattr(ms, name)
    ms._batch_ms = []
    ms._batch_sizes = []
    ms._batch_ms_at = 0

    async def counted(pending):
        t0 = time.perf_counter()
        await inner(pending)
        ms._batch_ms.append((time.perf_counter() - t0) * 1e3)
        ms._batch_sizes.append(len(pending))
    setattr(ms, name, counted)


async def _start_node_service(torch, device, broker, metrics, backend,
                              devices=None, **kw):
    """A node-default ``MatchService`` on ``broker`` (with ``kw``) on
    ``device`` (the mesh ``devices`` when given), started; returns it
    with the seconds from ``start()`` to ready and synced (with the
    multichip backend, its partition built and applied too)."""
    from emqx_tpu_torch.broker.match_service import MatchService

    # the plain walks on the CPU (rehearsal) take longer than the node's
    # 0.5 s prefetch timeout allows a queue of batches
    if device.type != "cuda":
        kw["prefetch_timeout_s"] = 60.0
        if kw.get("deadline"):
            kw["dispatch_timeout_s"] = 60.0
    sup = kw.pop("supervisor", None)
    ms = MatchService(broker, metrics, backend=backend,
                      device=device if devices is None else devices, **kw)
    ms.supervisor = sup
    t0 = time.perf_counter()
    await ms.start()
    while not (ms.ready and ms._synced_epoch == broker.router.epoch
               and (ms.mc is None or (ms.mc.ready and not ms.mc.dirty))):
        _check(time.perf_counter() - t0 < 600, "the service never got ready")
        await asyncio.sleep(0.005)
    ready_s = time.perf_counter() - t0
    _check(ms.dev.epoch == ms.inc.epoch, "the device table lags the host")
    _count_batches(ms)
    return ms, ready_s


async def _node_storms(torch, device, ms, broker, metrics, topics, card,
                       churn, storm_batches: int, name: str,
                       payloads=None, warm: bool = True,
                       before_timed=None, waits=None, warm_batches=None,
                       mesh_tp: int = 0):
    """Warm-up (unless ``warm`` is false) and the timed storm (with
    ``churn`` running beside it) through ``ms``, with ``payloads`` (see
    :func:`_storm`); ``before_timed()`` runs just before the timed
    storm's counts are zeroed.  Returns its line and the checks of
    ``slice_node`` that failed.  ``join_rebuilds`` counts the relation
    rebuilds the churn caused (each sorted and uploaded on the sync
    thread while the loop serves; ``batch_ms.max`` would show a
    stall).  With ``mesh_tp`` the service serves through its multichip
    backend: each dispatch launches the hash walk twice a shard (compact
    mode: no flat launch), and ``tpu.match.shard_dispatches`` counts
    every dispatch."""
    from emqx_tpu_torch.ops import route_kernel, walk_kernel

    check = _RouteLog(ms, broker.router)
    broker.device_match = check
    warm_hi = (WARM_STORM if warm_batches is None else warm_batches) * BATCH
    hi = warm_hi + storm_batches * BATCH
    if warm:
        await _storm(ms, broker, topics, 0, warm_hi, [], payloads)
    if before_timed is not None:
        before_timed()
    # -- the main path: counts zeroed just before, read just after -------
    _reset_launches()
    d0, j0, a0 = ms.dispatches, ms.join_dispatches, ms.autotune_launches
    r0 = ms.dev.join_rebuilds
    ep0 = ms.mc.ep_dispatches if mesh_tp else 0
    m0 = metrics.all()
    ms._batch_ms_at = len(ms._batch_ms)
    lat: List[float] = []
    gc.collect()
    with GcPauses() as pauses:
        storm = asyncio.ensure_future(
            _storm(ms, broker, topics, warm_hi, hi, lat, payloads, waits))
        churned = await _broker_churn(ms, broker, *churn) if churn else None
        res = await storm
    m1 = metrics.all()
    launches = walk_kernel.launches
    join_launches = walk_kernel.join_launches
    route_n = dict(route_kernel.launches)
    ep_n = ms.mc.ep_dispatches - ep0 if mesh_tp else 0
    flat = _flat_launches(device, name,
                          0 if mesh_tp else launches + join_launches)
    dispatches = ms.dispatches - d0
    join_dispatches = ms.join_dispatches - j0
    measure_launches = ms.autotune_launches - a0
    rebuilds = ms.dev.join_rebuilds - r0
    # ---------------------------------------------------------------------
    n = hi - warm_hi
    line = _storm_line(res, lat, n, pauses, ms, m0, m1, card)
    t0 = time.perf_counter()
    line.update({"phase": name, "ok": True, "backend": ms.backend,
                 "mismatches": _verify_routes(broker.router, check),
                 "checked": len(check.topics),
                 "check_s": time.perf_counter() - t0,
                 "walk_dispatches": dispatches,
                 "join_dispatches": join_dispatches,
                 "kernel_launches": launches,
                 "join_kernel_launches": join_launches,
                 "flat_epilogue_launches": flat,
                 "autotune_launches": measure_launches,
                 "join_rebuilds": rebuilds, "churn": churned})
    failed = [what for ok, what in (
        (line["mismatches"] == 0,
         f"{line['mismatches']} device routes differ from the router"),
        (line["checked"] >= line["hint_served"],
         "a device route list escaped the check"))
        if not ok]
    if mesh_tp:
        shard = (m1["tpu.match.shard_dispatches"]
                 - m0["tpu.match.shard_dispatches"])
        line["shard_dispatches"] = shard
        line["route_kernel_launches"] = route_n
        n_dev = len(ms.mc.mesh.distinct)
        want_route = {"ep_route": ep_n * n_dev, "ep_merge": shard * n_dev}
        failed += [what for ok, what in (
            (shard == dispatches,
             f"shard dispatches {shard} != dispatches {dispatches}"),
            (device.type != "cuda" or route_n == want_route,
             f"route kernel launches {route_n}, want {want_route}"))
            if not ok]
    if device.type == "cuda":
        # on the CPU (rehearsal) the plain walks are slow enough that a
        # churn overlaps nearly every batch: no duty-cycle bound there
        joins = (join_dispatches + measure_launches // 2
                 if ms.backend == "auto" else 0)
        per = 2 * mesh_tp if mesh_tp else 1
        failed += [what for ok, what in (
            (line["hint_served"] >= n / 2,
             f"hints served {line['hint_served']} of {n} publishes"),
            (launches + join_launches
             == per * dispatches + measure_launches,
             f"launches {launches}+{join_launches} != {per} x dispatches "
             f"{dispatches} + measurement walks {measure_launches}"),
            (join_launches == joins,
             f"join launches {join_launches}, want {joins}"))
            if not ok]
    return line, failed


def _emit_checked(line: Dict, failed: List[str]) -> None:
    """Emit ``line``, then fail the phase on its first failed check (so
    that the numbers behind a failure are printed)."""
    line["ok"] = not failed
    if failed:
        line["failed_checks"] = failed
    emit(line)
    _check(not failed, "; ".join(failed))


class _Deliveries:
    """What the fanout storms deliver: ``on_deliver`` and the
    ``message.dropped`` tap of the broker (the ids of the messages with a
    leg emitted, or dropped, and the legs), and the completion of each
    offered message: a publisher parks its future on the message, and it
    is resolved once the fanout chunk that holds the message has run, so
    after the emit of its last leg or its drop (the chunk's stages are
    synchronous)."""

    def __init__(self, broker, fan) -> None:
        self.legs = 0
        self.seen = set()
        broker.on_deliver = self.on_deliver
        broker.hooks.add("message.dropped", self.on_dropped,
                         name="chip_smoke.fanout")
        self.broker = broker
        inner = fan._process_chunk

        def chunk(batch) -> None:
            try:
                inner(batch)
            finally:
                for m in batch:
                    fut = m.__dict__.pop("_done", None)
                    if fut is not None and not fut.done():
                        fut.set_result(None)
        fan._process_chunk = chunk

    def on_deliver(self, _cid, pubs) -> None:
        self.legs += len(pubs)
        seen = self.seen
        for p in pubs:
            seen.add(p.msg.id)

    def on_dropped(self, msg, _reason) -> None:
        self.seen.add(msg.id)

    def close(self) -> None:
        self.broker.hooks.delete("message.dropped", "chip_smoke.fanout")


async def _fanout_storm(fan, broker, topics, lo: int, hi: int,
                        lat: List[float], ids: List[int]) -> Dict:
    """``STORM_TASKS`` publisher tasks, each taking the next topic of
    ``topics[lo:hi]``: offer one message to the fanout and await its
    delivery (or, refused, ``broker.publish`` it as a channel would),
    then one yield, as a connection's read of its next packet yields.
    Appends each message's seconds from offer to delivered to ``lat`` and
    its id to ``ids``."""
    from emqx_tpu_torch.broker.message import make_message

    loop = asyncio.get_running_loop()
    nxt = [lo]
    refused = [0]

    async def publisher(k: int) -> None:
        sender = f"pub{k}"
        while nxt[0] < hi:
            topic = topics[nxt[0]]
            nxt[0] += 1
            msg = make_message(sender, topic, b"x")
            ids.append(msg.id)
            t0 = time.perf_counter()
            fut = msg._done = loop.create_future()
            if fan.offer(msg):
                await fut
            else:
                del msg._done
                refused[0] += 1
                broker.publish(msg)
            lat.append(time.perf_counter() - t0)
            msg = fut = None
            await asyncio.sleep(0)

    t0 = time.perf_counter()
    await asyncio.wait_for(
        asyncio.gather(*[publisher(k) for k in range(STORM_TASKS)]), 600)
    return {"wall_s": time.perf_counter() - t0, "refused": refused[0]}


def _readback_contract(total: int, flat_cap: int, mode: str) -> int:
    """The ids phase 2 of the two-phase readback must copy (the
    reference's ``_readback_rows_twophase`` rule, auto slack 1.0): the
    total, or for ``ragged`` (and ``auto`` off the powers of two) its
    power-of-two capacity class, clipped to the flat buffer."""
    cap = 0 if total <= 0 else min(1 << (total - 1).bit_length(), flat_cap)
    if mode == "ragged" or (mode == "auto" and total & (total - 1)):
        return cap
    return min(total, flat_cap)


class _ReadbackCheck:
    """Each readback of a service against its byte contract: the slab
    (4·(FLAT_MULT·B + 3·B) a group) on the fixed-window ``chunked`` path,
    else 4·(B + the ids of :func:`_readback_contract`), the ids the
    two-phase path really copied held to that count.  Sums the bytes
    due, the padded rows B and the matched ids Σcounts."""

    def __init__(self, ms) -> None:
        self.due = self.rows = self.counts = self.reads = self.bad = 0
        mult, mode = ms.FLAT_MULT, ms.readback_mode
        slab, twophase = ms._readback_rows, ms._rows_from_twophase

        def slab_read(res, n, k):
            out = slab(res, n, k)
            B = int(res.n_matches.numel())
            self.bad += int(res.matches.numel()) != mult * B
            self.note(B, sum(len(r) for r in out[0]), 4 * (mult + 3) * B)
            return out

        def twophase_read(meta, ids, n, k):
            total = int(np.minimum(meta & 0xFFFF, k)[:n].sum())
            B = int(meta.size)
            want = _readback_contract(total, mult * B, mode)
            self.bad += int(ids.size) != want
            self.note(B, total, 4 * (B + want))
            return twophase(meta, ids, n, k)

        ms._readback_rows = slab_read
        ms._rows_from_twophase = twophase_read

    def note(self, rows: int, counts: int, due: int) -> None:
        self.rows += rows
        self.counts += counts
        self.due += due
        self.reads += 1


def _watch_inflight(ms) -> Dict[str, int]:
    """The most pipelined slots past dispatch at once."""
    seen = {"max": 0}
    inner = ms._set_inflight_metric

    def note() -> None:
        seen["max"] = max(seen["max"], ms._inflight_n)
        inner()
    ms._set_inflight_metric = note
    return seen


async def _fanout_phase(torch, device, broker, metrics, filters, topics,
                        card, storm_batches: int, logs, name: str,
                        service_kw, churn_seed: int) -> Dict:
    """One fanout storm on the 1M broker: a ``FanoutPipeline`` at the
    reference node's defaults, fed by a fresh node-default hash
    ``MatchService`` with ``service_kw`` (or, with None, by no service:
    the host trie alone); the warm-up, then the timed storm with a
    churn beside it, then (with a service) a profiled one.  Emits the
    line and fails the phase on a failed check."""
    from emqx_tpu_torch.broker.fanout import FanoutPipeline
    from emqx_tpu_torch.ops import walk_kernel

    t_start = time.perf_counter()
    logs.reset()
    ms = ready_s = check = None
    if service_kw is not None:
        ms, ready_s = await _start_node_service(torch, device, broker,
                                                metrics, "hash", **service_kw)
        check = _RouteLog(ms, broker.router)
        readback = _ReadbackCheck(ms)
        inflight = _watch_inflight(ms)
        inner = ms.prefetch_many
        prefetches = [0]

        async def prefetch_many(topic_qos, qos_of=None):
            prefetches[0] += 1
            await inner(topic_qos, qos_of)
        ms.prefetch_many = prefetch_many
    broker.device_match = check
    fan = FanoutPipeline(broker, metrics, ms, **FANOUT_KW)
    await fan.start()
    broker.fanout = fan
    track = _Deliveries(broker, fan)
    warm_hi = WARM_STORM * BATCH
    hi = warm_hi + storm_batches * BATCH
    add, drop, _hit = _node_churn(broker, filters, churn_seed, ())
    try:
        await _fanout_storm(fan, broker, topics, 0, warm_hi, [], [])
        # -- the main path: counts zeroed just before, read just after ---
        _reset_launches()
        m0 = metrics.all()
        f0 = (fan.batches, fan.msgs)
        if ms is not None:
            d0 = ms.dispatches
            b0 = len(ms._batch_ms)
            ids0 = (ms.inc.aid_reuses, len(ms._filter_of))
            calls0, served0 = check.calls, len(check.topics)
            r0 = (readback.due, readback.rows, readback.counts,
                  readback.reads, readback.bad)
            prefetches[0] = 0
            inflight["max"] = 0
        legs0 = track.legs
        lat: List[float] = []
        ids: List[int] = []
        gc.collect()
        with GcPauses() as pauses:
            storm = asyncio.ensure_future(
                _fanout_storm(fan, broker, topics, warm_hi, hi, lat, ids))
            churned = await _broker_churn(ms, broker, add, drop)
            res = await storm
        m1 = metrics.all()
        launches = walk_kernel.launches
        join_launches = walk_kernel.join_launches
        flat = _flat_launches(device, name, launches + join_launches)
        # -----------------------------------------------------------------
        n = hi - warm_hi
        delta = {k: m1[k] - m0[k] for k in m1}
        batches = fan.batches - f0[0]
        line = {
            "phase": name, "ok": True, "card": card, "publishes": n,
            "publishes_per_s": n / res["wall_s"],
            "deliveries_per_s": (track.legs - legs0) / res["wall_s"],
            "deliveries_per_publish": (track.legs - legs0) / n,
            "p50_ms": _pct(lat, 50) * 1e3, "p99_ms": _pct(lat, 99) * 1e3,
            "max_ms": max(lat) * 1e3,
            "latency": "offer to delivered (the emit of the last leg, or "
                       "the drop)",
            "refused_to_per_message_path": res["refused"],
            "undelivered": sum(1 for i in ids if i not in track.seen),
            "fanout_batches": batches,
            "mean_fanout_batch": (fan.msgs - f0[1]) / max(1, batches),
            "fanout_fallback": delta["broker.fanout.fallback"],
            "fanout_errors": delta["broker.fanout.errors"],
            "gc": {**pauses.summary(), "full_collections": pauses.count[2],
                   "full_ms": pauses.pause_ms[2]},
            "churn": churned, "fanout": fan.info(),
            "wall_s": res["wall_s"]}
        failed = []
        if ms is not None:
            device_batches = len(ms._batch_ms) - b0
            dispatches = ms.dispatches - d0
            calls = check.calls - calls0
            due, rows, counts, reads, bad = (
                a - b for a, b in zip((readback.due, readback.rows,
                                       readback.counts, readback.reads,
                                       readback.bad), r0))
            nbytes = delta["tpu.match.readback_bytes"]
            line.update({
                "start_to_ready_s": ready_s, "backend": ms.backend,
                "pipeline": ms.pipeline, "readback_mode": ms.readback_mode,
                "prefetch_many_calls": prefetches[0],
                "device_batches": device_batches,
                "topics_per_device_batch":
                    delta["tpu.match.topics"] / max(1, device_batches),
                "route_lookups": calls,
                "hint_share": delta["tpu.match.hint_served"] / max(1, calls),
                "hint_share_device": (delta["tpu.match.hint_served"]
                                      - delta["tpu.match.hint_served_host"])
                / max(1, calls),
                "hint_served": delta["tpu.match.hint_served"],
                "hint_served_host": delta["tpu.match.hint_served_host"],
                "hint_stale": delta["tpu.match.hint_stale"],
                "host_reruns": delta["tpu.match.fallback_host"],
                "cpu_fallback": delta["broker.match.cpu_fallback"],
                "readback_bytes_per_batch": nbytes / max(1, device_batches),
                "proportional_bytes_per_batch":
                    4 * (rows + counts) / max(1, device_batches),
                "readback_contract_bytes": due, "readback_bytes": nbytes,
                "readback_reads": reads,
                "readback_roundtrips_per_batch":
                    delta["tpu.match.readback_roundtrips"]
                    / max(1, device_batches),
                "pipeline_inflight_max": inflight["max"],
                "walk_dispatches": dispatches, "kernel_launches": launches,
                "join_kernel_launches": join_launches,
                "flat_epilogue_launches": flat,
                "stale_race_batches": logs.stale_races,
                "aid_reuses": ms.inc.aid_reuses - ids0[0],
                "accept_ids_grown": len(ms._filter_of) - ids0[1]})
            t0 = time.perf_counter()
            line["mismatches"] = _verify_routes(broker.router, check)
            line["checked"] = len(check.topics) - served0
            line["check_s"] = time.perf_counter() - t0
            failed += [what for ok, what in (
                (line["mismatches"] == 0,
                 f"{line['mismatches']} device routes differ from the "
                 "router"),
                (line["checked"] >= line["hint_served"],
                 "a device route list escaped the check"),
                (bad == 0, f"{bad} readbacks copied other than the "
                 "contract's ids"),
                (nbytes == due, f"readback bytes {nbytes} != the "
                 f"contract's {due}"),
                # the host tables answer a slot only when it failed or
                # its table changed under it: neither may happen here
                (line["cpu_fallback"] == 0 and logs.stale_races == 0,
                 f"{line['cpu_fallback']} waiters answered by the host "
                 f"tables, {logs.stale_races} batches refused as stale"))
                if not ok]
            if device.type == "cuda":
                # on the CPU (rehearsal) the plain walks launch nothing
                failed += [what for ok, what in (
                    (launches == dispatches and join_launches == 0,
                     f"launches {launches}+{join_launches} != dispatches "
                     f"{dispatches}"),
                    (prefetches[0] > 0 and device_batches > 0,
                     "the storm never reached the device"),
                    (line["hint_served"] - line["hint_served_host"]
                     >= calls / 2,
                     f"device hints served {line['hint_served']} - "
                     f"{line['hint_served_host']} of {calls} route "
                     "lookups"))
                    if not ok]
        failed += [what for ok, what in (
            (line["undelivered"] == 0,
             f"{line['undelivered']} messages neither delivered nor "
             "dropped"),
            (line["fanout_fallback"] == 0 and line["fanout_errors"] == 0,
             f"the fanout fell back {line['fanout_fallback']} messages, "
             f"{line['fanout_errors']} batch errors"))
            if not ok]
        failed += _log_checks(logs)
        if ms is not None:
            # the card's busy share over more publishes, under the profiler
            busy = slice(hi, hi + BUSY_BATCHES * BATCH)
            check = _RouteLog(ms, broker.router)
            broker.device_match = check
            line["device_busy"] = await _busy(
                torch, device, lambda: _fanout_storm(
                    fan, broker, topics, busy.start, busy.stop, [], []))
            line["device_busy"]["publishes"] = busy.stop - busy.start
            if _verify_routes(broker.router, check):
                failed.append("device routes differ from the router in the "
                              "profiled storm")
            line["service"] = ms.info()
        else:
            line["device_busy"] = {"busy_share": "not measured",
                                   "why": "no device path"}
        line["phase_wall_s"] = time.perf_counter() - t_start
        _emit_checked(line, failed)
        return {"launches": (launches, join_launches), "line": line}
    finally:
        track.close()
        await fan.stop()
        broker.fanout = broker.device_match = None
        if ms is not None:
            await ms.stop()


async def _busy(torch, device, storm) -> Dict:
    """Device busy share of the card over ``await storm()``
    (``torch.profiler``); not measured on the CPU."""
    if device.type != "cuda":
        return {"busy_share": "not measured", "idle_share": "not measured"}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        await storm()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return _busy_share(torch, prof, wall_us)


def phase_slice_node(torch, device, n_filters: int, card: str,
                     storm_batches: int) -> Dict:
    """The broker's own publish path at 1M subscriptions (BASELINE config
    2) with the node defaults: ``Broker.subscribe`` of every filter by
    ``SESSIONS`` clients, a ``MatchService`` started on the broker
    (bootstrap, upload, warm-up), then storms of ``STORM_TASKS``
    concurrent publishers (prefetch, then ``Broker.publish``) on the
    hash backend with a churn beside it, on the host trie alone, and on
    a fresh ``auto`` service with another churn."""
    return asyncio.run(_slice_node(torch, device, n_filters, card,
                                   storm_batches))


def _log_checks(logs: "_LogCount") -> List[str]:
    """The service's logged failures since ``logs.reset()``."""
    out = []
    if logs.failed:
        out.append(f"{logs.failed} device batches failed: {logs.first}")
    if logs.timeouts:
        out.append(f"{logs.timeouts} prefetches timed out: {logs.first}")
    if logs.errors:
        out.append(f"{logs.errors} errors logged: {logs.first}")
    return out


#: the route kernels' launches on slice_node_multichip's timed storm
NODE_ROUTE_LAUNCHES: Dict[str, int] = {}


async def _node_multichip(torch, device, broker, metrics, filters, topics,
                          card, logs) -> tuple:
    """slice_node_multichip: a node-default service with
    ``match.multichip.enable`` (tp = ``MC_TP``, ``device = [card] *
    MC_TP``) on the 1M broker; ``MC_WARM`` warm-up and ``MC_STORM``
    timed batches of publishes with a churn beside (0 route mismatches,
    hints on at least half the publishes, every dispatch through the
    mesh: ``tpu.match.shard_dispatches`` equal to the dispatches and
    2·tp walk launches each); then one batch with shard 1 killed: it
    fails over to the host trie, and every route owed is delivered.
    Returns the walk launches of the timed storm."""
    t0 = time.perf_counter()
    ms, ready_s = await _start_node_service(
        torch, device, broker, metrics, "hash", multichip=True,
        multichip_tp=MC_TP, devices=[device] * MC_TP)
    try:
        add, drop, _hit = _node_churn(broker, filters, 17, ())
        line, failed = await _node_storms(
            torch, device, ms, broker, metrics, topics, card, (add, drop),
            MC_STORM, "slice_node_multichip", warm_batches=MC_WARM,
            mesh_tp=MC_TP)
        failed += _log_checks(logs)
        # one batch with a shard dead: the whole plane fails over
        lo = (MC_WARM + MC_STORM) * BATCH
        batch = topics[lo:lo + BATCH]
        check = _RouteLog(ms, broker.router)
        broker.device_match = check
        f0 = metrics.get("tpu.match.shard_failover")
        d0 = ms.mc.dispatches
        ms.mc.kill_shard(1)
        try:
            res = await _storm(ms, broker, topics, lo, lo + BATCH, [])
        finally:
            ms.mc.revive_shard(1)
        subs = broker.subscribers
        owed = sum(len(subs.get(r.filter, ()))
                   for t in batch for r in broker.router.match_routes(t))
        kill = {"publishes": len(batch), "delivered": res["delivered"],
                "owed": owed, "undelivered": owed - res["delivered"],
                "failovers": metrics.get("tpu.match.shard_failover") - f0,
                "mesh_dispatches": ms.mc.dispatches - d0,
                "hints_served": len(check.topics),
                "mismatches": _verify_routes(broker.router, check)}
        line["shard_kill"] = kill
        failed += [what for ok, what in (
            (kill["failovers"] >= 1, "the killed shard failed no batch over"),
            (kill["mesh_dispatches"] == 0,
             "a dispatch went through the mesh with a shard dead"),
            (kill["undelivered"] == 0,
             f"{kill['undelivered']} routes undelivered across the kill"),
            (kill["mismatches"] == 0,
             f"{kill['mismatches']} hinted routes differ across the kill"))
            if not ok]
        line.update(start_to_ready_s=ready_s,
                    stale_race_batches=logs.stale_races,
                    multichip=ms.mc.info(),
                    wall_s=time.perf_counter() - t0)
        _emit_checked(line, failed)
        NODE_ROUTE_LAUNCHES.update(line["route_kernel_launches"])
        return line["kernel_launches"], line["join_kernel_launches"]
    finally:
        broker.device_match = None
        await ms.stop()


async def _slice_node(torch, device, n_filters, card, storm_batches):
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.observe import Metrics
    from emqx_tpu_torch.workload import build_workload

    t_start = time.perf_counter()
    n_topics = (WARM_STORM + storm_batches + BUSY_BATCHES) * BATCH
    filters, topics = build_workload(np.random.default_rng(0), n_filters,
                                     n_topics)
    t1 = time.perf_counter()
    order = np.random.default_rng(1).permutation(len(filters))
    per = -(-len(filters) // SESSIONS)
    metrics = Metrics()
    broker = Broker()
    broker.metrics = metrics
    for k in range(SESSIONS):
        cid = f"dev{k}"
        broker.open_session(cid)
        for i in order[k * per:(k + 1) * per].tolist():
            broker.subscribe(cid, filters[i])
    t2 = time.perf_counter()
    nodes = broker.router._trie.node_count()
    delivered = [0]

    def on_deliver(_cid, pubs) -> None:
        delivered[0] += len(pubs)
    broker.on_deliver = on_deliver
    logs = _LogCount()
    svc_log = logging.getLogger(NODE_LOGGER)
    svc_log.setLevel(logging.DEBUG)
    svc_log.addHandler(logs)
    try:
        ms, ready_s = await _start_node_service(torch, device, broker,
                                                metrics, "hash")
        emit({"phase": "slice_node_build", "ok": True,
              "filters": len(filters), "sessions": SESSIONS,
              "routes": broker.router.route_count(),
              "router_trie_nodes": nodes, "workload_s": t1 - t_start,
              "subscribe_s": t2 - t1, "start_to_ready_s": ready_s,
              "load_seconds": ms.load_seconds, **_table_info(ms),
              "gc_frozen_objects": gc.get_freeze_count(),
              "wall_s": time.perf_counter() - t_start})
        timed = slice(WARM_STORM * BATCH,
                      (WARM_STORM + storm_batches) * BATCH)
        add, drop, hit = _node_churn(broker, filters, 11, topics[timed])
        line, failed = await _node_storms(
            torch, device, ms, broker, metrics, topics, card, (add, drop),
            storm_batches, "slice_node")
        line["churn"]["storm_topics_a_fresh_filter_matches"] = hit
        line["stale_race_batches"] = logs.stale_races
        failed += _log_checks(logs)
        # the card's busy share over more publishes, under the profiler
        hi = timed.stop
        check = _RouteLog(ms, broker.router)
        broker.device_match = check
        line["device_busy"] = await _busy_storm(
            torch, device, ms, broker, topics, hi, hi + BUSY_BATCHES * BATCH)
        if _verify_routes(broker.router, check):
            failed.append("device routes differ from the router in the "
                          "profiled storm")
        # the host trie alone: what tpu.enable = false serves
        broker.device_match = None
        lat: List[float] = []
        m0 = metrics.all()
        gc.collect()
        with GcPauses() as pauses:
            res = await _storm(None, broker, topics, timed.start, hi, lat)
        host = _storm_line(res, lat, hi - timed.start, pauses, ms, m0,
                           metrics.all(), card)
        for k in ("share", "hint_served", "hint_stale", "hint_evicted",
                  "host_reruns", "device_batches", "mean_batch_topics",
                  "batch_ms", "batches_per_s"):
            host.pop(k)
        line.update(host_trie=host, service=ms.info(),
                    deliveries_total=delivered[0],
                    wall_s=time.perf_counter() - t_start)
        _emit_checked(line, failed)
        node_launches = (line["kernel_launches"],
                         line["join_kernel_launches"])
        await ms.stop()
        ms = check = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        # the table lifecycle, then the deadline plane, on the same broker
        logs.reset()
        ms, ready_s, lifecycle = await _segments_1m(
            torch, device, broker, metrics, filters, topics, card, logs)
        lifecycle.update(await _deadline_phases(
            torch, device, ms, ready_s, broker, metrics, filters, topics,
            card, storm_batches, logs, line))
        # auto: the service stopped and freed, a fresh one on the broker
        await ms.stop()
        ms = line = check = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t3 = time.perf_counter()
        logs.reset()
        ms, ready_s = await _start_node_service(torch, device, broker,
                                                metrics, "auto")
        add, drop, _hit = _node_churn(broker, filters, 12, ())
        auto, failed = await _node_storms(
            torch, device, ms, broker, metrics, topics, card, (add, drop),
            storm_batches, "slice_node_auto")
        failed += _log_checks(logs)
        if device.type == "cuda":
            # device time of a flat match (the walk and the flat
            # epilogue kernel's two launches; the times line has its
            # flat_match_ms), not a wait on the host (a worker thread's
            # clock read ~100 ms of GIL waits)
            failed += [f"tuner time {us} us of {be} at {sig} is over 1 ms"
                       for sig, took in ms.tuner.measured.items()
                       for be, us in took.items() if us > 1000]
        auto.update(start_to_ready_s=ready_s,
                    stale_race_batches=logs.stale_races,
                    tuner={"picks": dict(ms.tuner.picks),
                           "measured_us": dict(ms.tuner.measured),
                           "family_hits": ms.tuner.family_hits},
                    wall_s=time.perf_counter() - t3)
        await ms.stop()
        broker.device_match = None
        _emit_checked(auto, failed)
        out = {"launches": node_launches,
               "auto_launches": (auto["kernel_launches"],
                                 auto["join_kernel_launches"]),
               **lifecycle}
        # the multichip serve backend on the same broker: the table
        # sharded over MC_TP shards of the card
        ms = auto = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        logs.reset()
        out["node_multichip"] = await _node_multichip(
            torch, device, broker, metrics, filters, topics, card, logs)
        # the batched fanout, on the card and on the host trie alone
        ms = auto = None
        fan_log = logging.getLogger(FANOUT_LOGGER)
        fan_log.addHandler(logs)
        try:
            for name, kw, seed in FANOUT_PHASES:
                gc.collect()
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                got = await _fanout_phase(
                    torch, device, broker, metrics, filters, topics, card,
                    storm_batches, logs, name,
                    None if kw is None else dict(kw), seed)
                out[name] = got["launches"]
        finally:
            fan_log.removeHandler(logs)
        # the rule engine co-batched on the card, then on the host; last,
        # since its hooks stay on the broker
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out["rules"] = _rule_set()
        out.update(await _rule_storms(torch, device, broker, metrics, topics,
                                      card, storm_batches, logs,
                                      out["rules"]))
        return out
    finally:
        svc_log.removeHandler(logs)
        gc.unfreeze()       # the services froze the started heap


# -- the deadline serve plane and the table lifecycle on the 1M broker ---------

#: the checkout's root: chip_smoke writes only under it (the git-ignored
#: data/ for segments and trace/ for the flight recorder)
ROOT = os.path.dirname(os.path.abspath(__file__))
DEADLINE_WARM = 2            # slice_node_deadline: warm-up batches
HANG_CYCLES = 1_200_000_000  # deadline_faults: ~0.6 s of torch.cuda._sleep
HANG_SLACK_S = 0.15          # a hung batch is answered within its dispatch
                             # timeout + its budget + this
HANG_BATCH = 512             # the hung batch's topics (the host answers
                             # them on the loop: ~5 us each)
SEG_CHURN = 1000             # segments_1m: mutations between the segment
                             # and the cold start
SEG_SEED = 27                # segments_1m: the churn's filters


class _Ladder:
    """What the failure ladder did, counted by wrapping the service's
    steps: the batches the host tables answered (and their waiters), the
    dispatch failures (of them timeouts), the breaker's trips and closes
    with their clock, the alarm at the trip, the probes."""

    def __init__(self, ms) -> None:
        self.reset()
        cpu, fail = ms._cpu_serve, ms._breaker_note_failure
        trip, close, probe = (ms._trip_breaker, ms._close_breaker,
                              ms._probe_dispatch)

        def cpu_serve(pending):
            if pending:
                self.host_batches += 1
                self.host_waiters += len(pending)
            cpu(pending)

        def note_failure():
            self.failures += 1
            self.timeouts += isinstance(sys.exc_info()[1], TimeoutError)
            fail()

        def trip_breaker():
            self.trips += 1
            self.trip_t = time.perf_counter()
            trip()
            self.alarm_at_trip = (ms.alarms is not None and
                                  ms.alarms.is_active("match_degraded"))

        def close_breaker():
            self.closes += 1
            self.close_t = time.perf_counter()
            close()

        async def probe_dispatch():
            self.probes += 1
            await probe()
            self.probes_through += 1

        ms._cpu_serve, ms._breaker_note_failure = cpu_serve, note_failure
        ms._trip_breaker, ms._close_breaker = trip_breaker, close_breaker
        ms._probe_dispatch = probe_dispatch

    def reset(self) -> None:
        self.host_batches = self.host_waiters = self.failures = 0
        self.timeouts = self.trips = self.closes = 0
        self.probes = self.probes_through = 0
        self.trip_t = self.close_t = None
        self.alarm_at_trip = None

    def counts(self) -> Dict:
        return {"host_served_batches": self.host_batches,
                "host_served_waiters": self.host_waiters,
                "dispatch_failures": self.failures,
                "dispatch_timeouts": self.timeouts,
                "breaker_trips": self.trips, "breaker_closes": self.closes,
                "probes": self.probes, "probes_through": self.probes_through}


class _Heartbeat:
    """A task on the loop that wakes every millisecond: the largest gap
    between two wakes, and their count; ``ends`` holds each gap's end on
    the loop's clock (``time.monotonic``)."""

    def __init__(self) -> None:
        self.gaps: List[float] = []
        self.ends: List[float] = []
        self._stop = False
        self._task = asyncio.ensure_future(self._run())

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        last = loop.time()
        while not self._stop:
            await asyncio.sleep(0.001)
            now = loop.time()
            self.gaps.append(now - last)
            self.ends.append(now)
            last = now

    def largest_within(self, start: float, end: float) -> float:
        """The largest gap (ms) that overlaps ``[start, end]``."""
        return max((g for g, e in zip(self.gaps, self.ends)
                    if e > start and e - g < end), default=0.0) * 1e3

    async def stop(self) -> Dict:
        self._stop = True
        await self._task
        return {"beats": len(self.gaps),
                "max_gap_ms": max(self.gaps, default=0.0) * 1e3,
                "p99_gap_ms": _pct(self.gaps or [0.0], 99) * 1e3}


def _pin_bound(ms, on: bool) -> None:
    """Hold the service's rate window shut with the rate high and the
    short share at one half (each ``prefetch_many`` below is one batch,
    forced out by its budget), or let the window run again."""
    if on:
        ms._pinned = ms._short_frac
        ms._rate_ewma, ms._win_start = 1e9, float("inf")
        ms._short_frac = 0.5
    else:
        ms._rate_ewma, ms._win_start = None, time.monotonic()
        ms._short_frac = ms._pinned


def _hint_checks(ms, router, topics) -> Dict[str, int]:
    """Each topic's hint: answered by the card or by the host tables,
    missing, and how many route lists differ from the router's (no
    churn runs meanwhile: the router's answer is the one of now)."""
    out = {"card": 0, "host": 0, "missing": 0, "mismatches": 0}
    for t in dict.fromkeys(topics):
        hint = ms._hints.get(t)
        if hint is None:
            out["missing"] += 1
            continue
        out["host" if hint[4] else "card"] += 1
        routes = ms.hint_routes(t)
        out["mismatches"] += (routes is None or _routes_key(routes)
                              != _routes_key(router.match_routes(t)))
    return out


def _slot_ptrs(slot) -> set:
    """Addresses of what a slot owns: its pinned slab or buffers and
    its walks' outputs on the card."""
    ptrs = set()
    for host in slot.slab or ():
        ptrs.update(t.data_ptr() for t in host)
    for t in slot.bufs or ():
        ptrs.add(t.data_ptr())
    for res, _n in slot.handles:
        ptrs.update(t.data_ptr() for t in res[:4])
    return ptrs


async def _segments_1m(torch, device, broker, metrics, filters, topics,
                       card, logs):
    """``segments_1m`` (module docstring).  Returns the deadline service
    (started last, as the rebuild from the router) and its ready
    seconds."""
    import shutil

    from emqx_tpu_torch.ops import walk_kernel

    t_start = time.perf_counter()
    seg_dir = os.path.join(ROOT, "data", "chip_smoke_segments")
    shutil.rmtree(seg_dir, ignore_errors=True)
    failed: List[str] = []
    # A: no segment yet, so a rebuild from the router; pipelined, so
    # that slots are in flight when the swap lands
    ms, ready_a = await _start_node_service(
        torch, device, broker, metrics, "hash", segments=True,
        segments_dir=seg_dir, compact_interval_s=1e9, pipeline=True)
    _check(not ms._segment_loaded, "a segment was there before the first")
    add, drop, _hit = _node_churn(broker, filters, SEG_SEED, ())
    logs.reset()
    check = _RouteLog(ms, broker.router)
    broker.device_match = check
    swap = {}
    inner_swap = ms._swap_in

    def timed_swap(built):
        t0 = time.perf_counter()
        swap["accepts_before"] = ms.inc.n_accepts
        swap["inflight_at_swap"] = ms._inflight_n
        inner_swap(built)
        swap["swap_ms"] = (time.perf_counter() - t0) * 1e3
        swap["held_ids_after"] = ms.dev._id_holds
    ms._swap_in = timed_swap
    # -- the main path: counts zeroed just before, read just after -------
    _reset_launches()
    d0 = ms.dispatches
    beat = _Heartbeat()
    lat: List[float] = []
    t0 = time.perf_counter()
    pauses = GcPauses()
    gc.callbacks.append(pauses._cb)
    compact = asyncio.ensure_future(ms._compact_once())
    done = lo = after = churned = 0
    while after < 2:
        # the churn at NODE_CHURN_RATE of each, as long as the build runs
        due = min(len(add), int((time.perf_counter() - t0)
                                * NODE_CHURN_RATE) + 1)
        if not compact.done():
            for (ca, fa), (cd, fd) in zip(add[done:due], drop[done:due]):
                broker.subscribe(ca, fa)
                _check(broker.unsubscribe(cd, fd), f"unsubscribe {fd!r}")
            churned += max(0, due - done)
            done = max(done, due)
        else:
            after += 1
        hi = lo + BATCH
        if hi > len(topics):
            lo, hi = 0, BATCH
        await _storm(ms, broker, topics, lo, hi, lat)
        lo = hi
    compacted = await compact
    compact_s = time.perf_counter() - t0
    while ms._synced_epoch < broker.router.epoch:
        await asyncio.sleep(0.001)
    gc.callbacks.remove(pauses._cb)
    gaps = await beat.stop()
    # each step of the build with the largest loop gap that overlaps it
    build_steps = [{"step": name, "s": end - start,
                    "largest_loop_gap_ms": beat.largest_within(start, end)}
                   for name, start, end in ms.compact_steps]
    if ms.compact_steps:
        b0, b1 = ms.compact_steps[0][1], ms.compact_steps[-1][2]
        gaps["outside_build_max_gap_ms"] = max(
            (g for g, e in zip(beat.gaps, beat.ends)
             if e - g >= b1 or e <= b0), default=0.0) * 1e3
    launches = walk_kernel.launches
    join_launches = walk_kernel.join_launches
    flat = _flat_launches(device, "segments_1m", launches + join_launches)
    dispatches = ms.dispatches - d0
    # ---------------------------------------------------------------------
    mismatches = _verify_routes(broker.router, check)
    line = {"phase": "segments_1m", "ok": True, "card": card,
            "table_kind": ms.table_kind, "segment_kind": "filters",
            "pipeline": ms.pipeline,
            "rebuild_from_router_s_before_segment": ready_a,
            "compaction": {
                "ok": compacted, "seconds": compact_s,
                "segment_bytes": os.path.getsize(ms._segment_path),
                "churn_during": 2 * churned, "swap_ms": swap.get("swap_ms"),
                "loop_gap_ms": gaps, "build_steps": build_steps,
                "gc": {**pauses.summary(),
                       "build_thread": pauses.other_thread},
                "slots_in_flight_at_swap": swap.get("inflight_at_swap"),
                "slots_discarded_by_gen_guard": logs.stale_races,
                "accept_ids_before": swap.get("accepts_before"),
                "accept_ids_after": ms.inc.n_accepts,
                "fresh_table_held_ids": swap.get("held_ids_after"),
                "abandoned": ms._compact_abandoned,
                "table_gen": ms._table_gen},
            "publishes": len(lat), "publish_p99_ms": _pct(lat, 99) * 1e3,
            "prefetch_timeouts": logs.timeouts,
            "hint_served": len(check.topics),
            "mismatches_after_swap": mismatches,
            "walk_dispatches": dispatches, "kernel_launches": launches,
            "join_kernel_launches": join_launches}
    failed += [what for ok, what in (
        (compacted, "the compaction was abandoned"),
        (mismatches == 0, f"{mismatches} routes differ after the swap"),
        (swap.get("accepts_before") is not None, "no swap landed"),
        (swap.get("held_ids_after") == 0,
         "the swapped-in table holds freed ids"))
        if not ok]
    failed += _log_checks(logs)
    if device.type == "cuda":
        failed += [what for ok, what in (
            (launches == dispatches > 0,
             f"launches {launches} != dispatches {dispatches}"),
            (join_launches == 0, "the join walk ran"),
            (len(check.topics) >= len(lat) / 2,
             f"hints served {len(check.topics)} of {len(lat)}"))
            if not ok]
    await ms.stop()
    broker.device_match = None
    ms = check = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # SEG_CHURN further mutations, then B: the cold start from the segment
    half = SEG_CHURN // 2
    more_add, more_drop, _hit = _node_churn(broker, filters, SEG_SEED + 1, ())
    for (ca, fa), (cd, fd) in zip(more_add[:half], more_drop[:half]):
        broker.subscribe(ca, fa)
        _check(broker.unsubscribe(cd, fd), f"unsubscribe {fd!r}")
    ms, ready_b = await _start_node_service(
        torch, device, broker, metrics, "hash", segments=True,
        segments_dir=seg_dir, compact_interval_s=1e9)
    _reset_launches()
    d0 = ms.dispatches
    check = _RouteLog(ms, broker.router)
    broker.device_match = check
    lat = []
    await _storm(ms, broker, topics, 0, 2 * BATCH, lat)
    cold_launches = walk_kernel.launches
    cold_join_launches = walk_kernel.join_launches
    cold_flat = _flat_launches(device, "segments_1m.cold_start",
                               cold_launches + cold_join_launches)
    cold_dispatches = ms.dispatches - d0
    cold_bad = _verify_routes(broker.router, check)
    line["cold_start"] = {
        "segment_loaded": ms._segment_loaded,
        "mutations_since_segment": SEG_CHURN,
        "from_segment_to_ready_s": ready_b,
        "segment_load_s": metrics.get("tpu.table.segment_load_s"),
        "check_publishes": len(lat), "hint_served": len(check.topics),
        "mismatches": cold_bad, "walk_dispatches": cold_dispatches,
        "kernel_launches": cold_launches,
        "join_kernel_launches": cold_join_launches}
    failed += [what for ok, what in (
        (ms._segment_loaded, "the cold start did not load the segment"),
        (cold_bad == 0, f"{cold_bad} routes differ after the cold start"))
        if not ok]
    if device.type == "cuda":
        failed += [what for ok, what in (
            (cold_launches == cold_dispatches > 0,
             f"cold-start launches {cold_launches} != dispatches "
             f"{cold_dispatches}"),
            (join_launches + cold_join_launches == 0,
             f"the join walk ran {join_launches} + {cold_join_launches} "
             "times")) if not ok]
    await ms.stop()
    broker.device_match = None
    ms = check = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(seg_dir, ignore_errors=True)
    # C: the deadline service, a rebuild from the same router
    from emqx_tpu_torch.observe.alarm import Alarms
    from emqx_tpu_torch.observe.flightrec import FlightRecorder
    from emqx_tpu_torch.supervise import Supervisor

    fr_dir = os.path.join(ROOT, "trace", "chip_smoke_flightrec")
    shutil.rmtree(fr_dir, ignore_errors=True)
    alarms = Alarms()
    ms, ready_c = await _start_node_service(
        torch, device, broker, metrics, "hash", deadline=True,
        alarms=alarms, flightrec=FlightRecorder(fr_dir),
        supervisor=Supervisor(metrics=metrics, alarms=alarms))
    line["cold_start"]["rebuild_from_router_s"] = ready_c
    line["cold_start"]["segment_over_rebuild"] = ready_b / ready_c
    line["wall_s"] = time.perf_counter() - t_start
    _emit_checked(line, failed)
    return ms, ready_c, {"segments_1m": (launches + cold_launches,
                                         join_launches + cold_join_launches)}


async def _deadline_phases(torch, device, ms, ready_s, broker, metrics,
                           filters, topics, card, storm_batches, logs,
                           node_line):
    """``slice_node_deadline`` and ``deadline_faults`` on the deadline
    service ``ms`` (module docstring)."""
    from emqx_tpu_torch import faultinject as fi
    from emqx_tpu_torch.ops import walk_kernel
    from emqx_tpu_torch.workload import build_workload

    t_start = time.perf_counter()
    out = {}
    ladder = _Ladder(ms)
    add, drop, _hit = _node_churn(broker, filters, 13, ())
    waits: List[float] = []
    snap: Dict[str, int] = {}

    def before_timed() -> None:
        snap.update(metrics.all())
        ladder.reset()
    logs.reset()
    line, failed = await _node_storms(
        torch, device, ms, broker, metrics, topics, card, (add, drop),
        storm_batches, "slice_node_deadline", waits=waits,
        warm_batches=DEADLINE_WARM, before_timed=before_timed)
    sizes = ms._batch_sizes[ms._batch_ms_at:] or [0]
    budget = ms.deadline_s
    line.update({
        "deadline_s": budget, "dispatch_timeout_s": ms.dispatch_timeout_s,
        "start_to_ready_s": ready_s,
        "prefetch_wait_ms": {
            "waiters": len(waits), "p50": _pct(waits, 50) * 1e3,
            "p99": _pct(waits, 99) * 1e3, "max": max(waits) * 1e3,
            "budget_ms": budget * 1e3,
            "within_budget_share": sum(w <= budget for w in waits)
            / len(waits)},
        "deadline_dispatch": metrics.get("broker.match.deadline_dispatch")
        - snap["broker.match.deadline_dispatch"],
        "deadline_miss": metrics.get("broker.match.deadline_miss")
        - snap["broker.match.deadline_miss"],
        "batch_sizes": {"batches": len(sizes),
                        "p10": _pct(sizes, 10), "p50": _pct(sizes, 50),
                        "p90": _pct(sizes, 90), "max": max(sizes),
                        "mean": float(np.mean(sizes))},
        **ladder.counts(),
        "slice_node": {k: node_line[k] for k in (
            "publishes_per_s", "p50_ms", "p99_ms", "batch_ms",
            "mean_batch_topics")},
        "stale_race_batches": logs.stale_races})
    failed += [what for ok, what in (
        (ladder.trips == 0, f"{ladder.trips} breaker trips"),
        (ladder.timeouts == 0, f"{ladder.timeouts} dispatch timeouts"),
        (ladder.failures == 0, f"{ladder.failures} failed batches"),
        (ladder.host_batches == 0,
         f"{ladder.host_batches} batches answered by the host"))
        if not ok]
    failed += _log_checks(logs)
    line["wall_s"] = time.perf_counter() - t_start
    _emit_checked(line, failed)
    out["node_deadline"] = (line["kernel_launches"],
                            line["join_kernel_launches"])
    # -- deadline_faults: (a) match.dispatch faults, (b) a real hang ------
    t1 = time.perf_counter()
    _, fault_topics = build_workload(np.random.default_rng(29), 16,
                                     6 * BATCH)
    failed = []
    check = _RouteLog(ms, broker.router)
    broker.device_match = check
    fr = ms.flightrec
    # -- the main path: counts zeroed just before, read just after -------
    _reset_launches()
    d0 = ms.dispatches
    ladder.reset()
    dumps0 = fr.dumps
    fi.install(fi.FaultInjector([{"point": "match.dispatch",
                                  "action": "raise",
                                  "times": ms.breaker_threshold}]))
    try:
        lat: List[float] = []
        # storms of new topics (each prefetch a waiter) until the breaker
        # opens: how many batches a storm makes depends on the walk's speed
        faulty = [f"{t}/fault{i}" for i, t in enumerate(fault_topics)]
        lo = 0
        while not (ms._breaker_open or ladder.trips) and lo < len(faulty):
            await _storm(ms, broker, faulty, lo, lo + BATCH, lat)
            lo += BATCH
        opened = ms._breaker_open or ladder.trips > 0
        fired = fi.get().fired.get("match.dispatch", 0)
    finally:
        fi.uninstall()      # exhausted at the trip: cleared from there
    t0 = time.perf_counter()
    while ms._breaker_open and time.perf_counter() - t0 < 30:
        await asyncio.sleep(0.005)
    recovery_s = (ladder.close_t - ladder.trip_t
                  if ladder.close_t and ladder.trip_t else None)
    dumps = sorted(f for f in (os.listdir(fr.out_dir)
                               if os.path.isdir(fr.out_dir) else ())
                   if f.startswith("flightrec-breaker_trip-"))
    await _storm(ms, broker, fault_topics, 2 * BATCH, 3 * BATCH, lat)
    fault_bad = _verify_routes(broker.router, check)
    interval = ms.breaker_probe_interval_s
    a = {"faults_injected": fired, "breaker_opened": opened,
         "alarm_at_trip": ladder.alarm_at_trip,
         "alarm_after_close": ms.alarms.is_active("match_degraded"),
         "breaker_trip_dumps": len(dumps), "dumps": fr.dumps - dumps0,
         "probe_interval_s": interval, "recovery_s": recovery_s,
         "publishes": len(lat), "mismatches": fault_bad,
         "hint_served_after_close": len(check.topics), **ladder.counts()}
    failed += [what for ok, what in (
        (opened and ladder.trips == 1, f"{ladder.trips} trips, want 1"),
        (ladder.alarm_at_trip, "no match_degraded alarm at the trip"),
        (not a["alarm_after_close"], "the alarm outlived the breaker"),
        (len(dumps) == 1, f"{len(dumps)} breaker_trip dumps, want 1"),
        (recovery_s is not None and recovery_s <= 2 * interval
         + ms.dispatch_timeout_s,
         f"the probe closed the breaker after {recovery_s} s"),
        (fault_bad == 0, f"{fault_bad} routes differ under the faults"))
        if not ok]
    # (b) a real hang: the walk queued behind a sleep on the card
    ladder.reset()
    _pin_bound(ms, True)
    beat = _Heartbeat()
    hang = {}
    loop = asyncio.get_running_loop()
    held = []
    if device.type == "cuda":
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        torch.cuda._sleep(HANG_CYCLES)
        ev1.record()
    # topics no hint holds yet: each of their prefetches is a waiter
    fresh = [f"{t}/hang{i}" for i, t in enumerate(fault_topics)]
    t0 = loop.time()
    hung = fresh[3 * BATCH:3 * BATCH + HANG_BATCH]
    await ms.prefetch_many(hung)
    hang["first_batch_answered_s"] = loop.time() - t0
    behind = fresh[4 * BATCH:4 * BATCH + HANG_BATCH // 2]
    t0 = loop.time()
    await ms.prefetch_many(behind)
    hang["batch_behind_answered_s"] = loop.time() - t0
    # the harness keeps the timed-out batches' buffers referenced, so
    # that a later batch can only get them if the service handed them
    held = [slot for _ev, slot in ms._timed_out]
    hang["timed_out_batches"] = len(held)
    held_ptrs = set()
    for slot in held:
        held_ptrs |= _slot_ptrs(slot)
    overlaps = 0
    if device.type == "cuda":
        while not ev1.query():
            await asyncio.sleep(0.001)
        hang["sleep_ms"] = ev0.elapsed_time(ev1)
    hang["loop_during_hang"] = await beat.stop()
    hang["hung_hints"] = _hint_checks(ms, broker.router, hung + behind)
    new_slots = []
    inner_make = ms._make_slot

    def make_slot(*a, **kw):
        slot = inner_make(*a, **kw)
        new_slots.append(slot)
        return slot
    ms._make_slot = make_slot
    after = fresh[5 * BATCH:6 * BATCH]
    await ms.prefetch_many(after[:BATCH // 2])
    await ms.prefetch_many(after[BATCH // 2:])
    ms._make_slot = inner_make
    overlaps = sum(bool(_slot_ptrs(s) & held_ptrs) for s in new_slots)
    hang["after_hints"] = _hint_checks(ms, broker.router, after)
    hang["batches_after"] = len(new_slots)
    hang["buffer_overlaps_with_timed_out"] = overlaps
    held = None
    _pin_bound(ms, False)
    hang.update(ladder.counts())
    launches = walk_kernel.launches
    join_launches = walk_kernel.join_launches
    flat = _flat_launches(device, "deadline_faults", launches + join_launches)
    dispatches = ms.dispatches - d0
    # ---------------------------------------------------------------------
    limit = ms.dispatch_timeout_s + ms.deadline_s + HANG_SLACK_S
    hh, ah = hang["hung_hints"], hang["after_hints"]
    if device.type == "cuda":
        failed += [what for ok, what in (
            (hang["first_batch_answered_s"] <= limit,
             f"the hung batch was answered after "
             f"{hang['first_batch_answered_s']} s (limit {limit} s)"),
            (hang["timed_out_batches"] >= 1 and ladder.timeouts >= 1,
             "no batch timed out behind the sleep"),
            (hh["card"] == 0 and hh["missing"] == 0 and hh["mismatches"] == 0,
             f"the hung batches' hints: {hh}"),
            (ah["host"] == 0 and ah["missing"] == 0 and ah["mismatches"] == 0,
             f"the batches after the hang: {ah}"),
            (overlaps == 0, f"{overlaps} batches after the hang used a "
             "timed-out batch's buffers"),
            (hang["loop_during_hang"]["max_gap_ms"] < 50,
             f"the loop stalled {hang['loop_during_hang']['max_gap_ms']} ms "
             "during the hang"),
            (not ms._breaker_open, "the hang opened the breaker"),
            (launches == dispatches + a["probes_through"],
             f"launches {launches} != dispatches {dispatches} + probes "
             f"{a['probes_through']}"))
            if not ok]
    line = {"phase": "deadline_faults", "ok": True, "card": card,
            "dispatch_faults": a, "hang": hang, "hang_limit_s": limit,
            "walk_dispatches": dispatches, "kernel_launches": launches,
            "join_kernel_launches": join_launches,
            "wall_s": time.perf_counter() - t1}
    _emit_checked(line, failed)
    out["deadline_faults"] = (launches, join_launches)
    broker.device_match = None
    return out


# -- the rule engine on the card: BASELINE config 3's co-batched rules ---------

def _rule_set() -> List[tuple]:
    """``RULES`` rules ``(id, FROM filters, WHERE threshold)``.  The
    filters are the workload generator's (45% ``+``, 30% ``#``, 2-8
    levels) with ``RULE_SEED``: its hot filters are the 1M broker's too,
    so about half are also routing filters and share their accept id."""
    from emqx_tpu_torch.workload import build_workload

    rng = np.random.default_rng(RULE_SEED)
    pool, _ = build_workload(np.random.default_rng(RULE_SEED),
                             RULES + RULES // 10, 0)
    pool = [pool[int(i)] for i in rng.permutation(len(pool))]
    rules, k = [], 0
    for i in range(RULES):
        n = 2 if i % 10 == 9 else 1
        rules.append((f"r{i:04d}", pool[k:k + n],
                      int(rng.integers(10, 40))))
        k += n
    return rules


def _rule_sql(froms: List[str], threshold: int) -> str:
    """The EMQX documentation's form.  The WHERE reads the payload's
    field: the reference's runtime evaluates WHERE over the event's
    columns, where a SELECT alias is not bound."""
    src = ", ".join(json.dumps(f) for f in froms)
    return (f"SELECT clientid, topic, payload.temp AS t FROM {src} "
            f"WHERE payload.temp > {threshold}")


def _rule_payloads(n: int) -> List[bytes]:
    """A JSON object with a seeded ``temp`` for each publish of the
    stream: the WHERE thresholds (10-39) pass and fail."""
    temps = np.random.default_rng(RULE_SEED + 1).integers(0, 50, size=n)
    return [b'{"temp": %d, "unit": "C"}' % t for t in temps.tolist()]


class _RuleOracle:
    """The rule ids whose FROM filters match a topic, by the host trie."""

    def __init__(self, rules) -> None:
        from emqx_tpu_torch.broker.trie import FilterTrie

        self.trie = FilterTrie()
        self.by_filter: Dict[str, List[str]] = {}
        for rid, froms, _thr in rules:
            for f in froms:
                if f not in self.by_filter:
                    self.trie.insert(f)
                self.by_filter.setdefault(f, []).append(rid)

    def __call__(self, topic: str) -> List[str]:
        return sorted({rid for f in self.trie.match(topic)
                       for rid in self.by_filter[f]})


class _RuleHintLog:
    """The service's ``hint_rules`` for the rule engine, logging each
    rule-id list it returns (as one string) for the check after the
    storm, and counting the publishes it left to the host."""

    def __init__(self, ms) -> None:
        self.inner = ms.hint_rules
        self.reset()

    def reset(self) -> None:
        self.topics: List[str] = []
        self.keys: List[str] = []
        self.calls = self.none = 0

    def __call__(self, topic: str):
        self.calls += 1
        ids = self.inner(topic)
        if ids is None:
            self.none += 1
        else:
            self.topics.append(topic)
            self.keys.append("\n".join(sorted(ids)))
        return ids


async def _rule_storms(torch, device, broker, metrics, topics, card,
                       storm_batches: int, logs, rules) -> Dict:
    """``slice_node_rules`` and ``slice_node_rules_host`` on the 1M
    broker: the port's ``RuleEngine`` with ``rules`` attached to a fresh
    node-default hash service (``attach_match_service`` co-batches the
    FROM filters into the walk's table), the slice_node storm with JSON
    payloads (rule ids from ``hint_rules``), then the engine detached
    from the service (rule ids from the engine's host trie of the rule
    filters) over the same timed publishes.  Every hinted rule-id list is held to
    the host trie of the rule filters, and each rule's counters, the
    outputs its action recorded and the republished messages the sink
    received must be equal on both storms."""
    from collections import Counter

    from emqx_tpu_torch.rule_engine import RuleEngine

    t_start = time.perf_counter()
    payloads = _rule_payloads(len(topics))
    outs: List[tuple] = []
    sink: Counter = Counter()
    broker.open_session(RULE_SINK)
    broker.subscribe(RULE_SINK, "rules/alert/#")
    inner_deliver = broker.on_deliver

    def on_deliver(cid, pubs) -> None:
        if cid == RULE_SINK:
            for p in pubs:
                sink[(p.msg.topic, p.msg.payload)] += 1
        inner_deliver(cid, pubs)
    broker.on_deliver = on_deliver
    engine = RuleEngine(broker)
    timed = slice(WARM_STORM * BATCH, (WARM_STORM + storm_batches) * BATCH)
    n = timed.stop - timed.start
    oracle = _RuleOracle(rules)
    hits = Counter(rid for t in topics[timed] for rid in oracle(t))
    ranked = sorted((rid for rid, _f, _t in rules),
                    key=lambda rid: (-hits[rid], rid))
    republishers = set(ranked[RULE_REPUBLISH_RANK:
                              RULE_REPUBLISH_RANK + RULE_REPUBLISH])
    t0 = time.perf_counter()
    for rid, froms, thr in rules:
        acts = [lambda out, cols, rid=rid: outs.append(
            (rid, out["clientid"], out["topic"], out["t"]))]
        if rid in republishers:
            acts.insert(0, {"function": "republish", "args": {
                "topic": f"rules/alert/{rid}", "payload": "${t}"}})
        engine.create_rule(rid, _rule_sql(froms, thr), actions=acts)
    create_s = time.perf_counter() - t0
    logs.reset()
    ms, ready_s = await _start_node_service(torch, device, broker, metrics,
                                            "hash")
    n_filters0 = ms.inc.n_filters
    t0 = time.perf_counter()
    engine.attach_match_service(ms)
    while not (ms._synced_rule_gen == ms._rule_gen
               and ms._synced_epoch == broker.router.epoch):
        _check(time.perf_counter() - t0 < 120, "the rules never synced")
        await asyncio.sleep(0.005)
    register_s = time.perf_counter() - t0
    hint_log = _RuleHintLog(ms)
    ms.hint_rules = hint_log

    def reset() -> None:
        outs.clear()
        sink.clear()
        hint_log.reset()
        for r in engine.rules.values():
            for k in r.metrics:
                r.metrics[k] = 0

    def snapshot() -> Dict:
        return {"metrics": {rid: dict(r.metrics)
                            for rid, r in engine.rules.items()},
                "outs": Counter(outs), "sink": Counter(sink)}

    def rule_numbers(n: int) -> Dict:
        tot = Counter()
        for r in engine.rules.values():
            tot.update(r.metrics)
        return {"rules_matched_per_publish": tot["matched"] / n,
                "rules_passed_per_publish": tot["passed"] / n,
                "outputs": len(outs), "republished_delivered":
                    sum(sink.values()), "counters": dict(tot)}

    out = {}
    try:
        # -- device: rule ids from the walk's hints -----------------------
        add, drop, _hit = _node_churn(broker, (), RULE_CHURN_SEED, ())
        line, failed = await _node_storms(
            torch, device, ms, broker, metrics, topics, card, (add, drop),
            storm_batches, "slice_node_rules", payloads=payloads,
            before_timed=reset)
        dev = snapshot()
        t0 = time.perf_counter()
        bad = sum(key != "\n".join(oracle(t))
                  for t, key in zip(hint_log.topics, hint_log.keys))
        want_sink = Counter((f"rules/alert/{rid}", str(t).encode())
                            for rid, _c, _t, t in outs
                            if rid in republishers)
        line.update({
            "rules": len(engine.rules), "rule_filters": len(oracle.by_filter),
            "rule_filters_routing_too": sum(
                ms._filter_of[ms._aid(f)] is not None
                for f in oracle.by_filter),
            "table_filters_before_rules": n_filters0,
            "table_filters_with_rules": ms.inc.n_filters,
            "create_s": create_s, "register_and_sync_s": register_s,
            "start_to_ready_s": ready_s,
            "hint_rules": {"calls": hint_log.calls,
                           "served": len(hint_log.topics),
                           "host_matched": hint_log.none,
                           "served_share": len(hint_log.topics)
                           / max(1, hint_log.calls),
                           "host_share": hint_log.none
                           / max(1, hint_log.calls)},
            "rule_id_mismatches": bad,
            "rule_ids_checked": len(hint_log.topics),
            "rule_check_s": time.perf_counter() - t0,
            "republish_rules": {rid: hits[rid]
                                for rid in sorted(republishers)},
            **rule_numbers(n)})
        failed += [what for ok, what in (
            (bad == 0, f"{bad} hinted rule-id lists differ from the host "
             "trie of the rule filters"),
            (sink == want_sink, "the sink did not receive every "
             "republished message exactly once"),
            (line["outputs"] > 0 and line["republished_delivered"] > 0,
             "no rule passed or no republish reached the sink"))
            if not ok]
        if device.type == "cuda":
            failed += [what for ok, what in (
                (len(hint_log.topics) >= n / 2,
                 f"hint_rules served {len(hint_log.topics)} of {n} "
                 "publishes"),) if not ok]
        failed += _log_checks(logs)
        busy = slice(timed.stop, timed.stop + BUSY_BATCHES * BATCH)
        check = _RouteLog(ms, broker.router)
        broker.device_match = check
        line["device_busy"] = await _busy_storm(
            torch, device, ms, broker, topics, busy.start, busy.stop,
            payloads)
        if _verify_routes(broker.router, check):
            failed.append("device routes differ from the router in the "
                          "profiled storm")
        line["wall_s"] = time.perf_counter() - t_start
        _emit_checked(line, failed)
        out["node_rules"] = (line["kernel_launches"],
                             line["join_kernel_launches"])
        # -- host: the engine detached, its rules found on the host.  No
        # churn beside it: it compares the rules' matching alone, and the
        # routes' half is slice_node_rules' ----------------------------
        t1 = time.perf_counter()
        logs.reset()
        engine._match_service = None
        host, failed = await _node_storms(
            torch, device, ms, broker, metrics, topics, card, None,
            storm_batches, "slice_node_rules_host", payloads=payloads,
            warm=False, before_timed=reset)
        got = snapshot()
        diff = [rid for rid in engine.rules
                if got["metrics"][rid] != dev["metrics"][rid]]
        host.update({
            "warm_up": "none (the routes' hints are warm from "
                       "slice_node_rules; the rules run on the host)",
            "churn": "none: the rules' matching alone is compared",
            "hint_rules": {"calls": hint_log.calls},
            "rules_with_other_counters": len(diff),
            "outputs_equal": got["outs"] == dev["outs"],
            "sink_equal": got["sink"] == dev["sink"],
            "publishes_per_s_vs_device": host["publishes_per_s"]
            / line["publishes_per_s"], **rule_numbers(n)})
        failed += [what for ok, what in (
            (not diff, f"{len(diff)} rules' counters differ from "
             f"slice_node_rules' (first {diff[:3]})"),
            (host["outputs_equal"], "the recorded outputs differ from "
             "slice_node_rules'"),
            (host["sink_equal"], "the republished messages differ from "
             "slice_node_rules'"),
            (hint_log.calls == 0, "the detached engine asked the service"))
            if not ok]
        failed += _log_checks(logs)
        busy = slice(timed.stop, timed.stop + RULE_HOST_BUSY * BATCH)
        check = _RouteLog(ms, broker.router)
        broker.device_match = check
        host["device_busy"] = await _busy_storm(
            torch, device, ms, broker, topics, busy.start, busy.stop,
            payloads)
        if _verify_routes(broker.router, check):
            failed.append("device routes differ from the router in the "
                          "profiled storm")
        host["wall_s"] = time.perf_counter() - t1
        _emit_checked(host, failed)
        out["node_rules_host"] = (host["kernel_launches"],
                                  host["join_kernel_launches"])
        return out
    finally:
        await ms.stop()
        broker.device_match = None
        broker.on_deliver = inner_deliver


def phase_acl_batch(torch, device, card: str) -> Dict:
    """``acl_batch``: ``ACL_RULES`` static ACL rules (the workload
    generator's filters with ``ACL_SEED``, a seeded permission and
    action each, a tenth of them ``eq`` literals; the first
    ``ACL_RULES - ACL_DB_RULES`` in a ``FileSource``, the rest as the
    global rows of a ``BuiltinDbSource`` with no per-client rows),
    compiled by ``compile_acl_batch``; ``batch_authorize`` walks
    ``ACL_BATCHES`` batches of 2048 Zipfian topics on the card for
    ``publish`` and for ``subscribe``, and every verdict must equal the
    host ``Authz`` pipeline's."""
    from emqx_tpu_torch.auth import (AclRule, Authz, BuiltinDbSource,
                                     FileSource, batch_authorize,
                                     compile_acl_batch)
    from emqx_tpu_torch.ops import walk_kernel
    from emqx_tpu_torch.workload import build_workload

    t_start = time.perf_counter()
    filters, topics = build_workload(np.random.default_rng(ACL_SEED),
                                     ACL_RULES, ACL_BATCHES * BATCH)
    rng = np.random.default_rng(ACL_SEED + 1)
    rules = []
    for k, f in enumerate(filters):
        pat = f
        if k % 10 == 5:     # a literal: one of the stream's topics
            pat = "eq " + topics[int(rng.integers(len(topics)))]
        rules.append(AclRule(("allow", "deny")[int(rng.integers(2))],
                             ("publish", "subscribe", "all")[
                                 int(rng.integers(3))], [pat]))
    rng.shuffle(rules)
    db = BuiltinDbSource()
    db.set_rules(rules[ACL_RULES - ACL_DB_RULES:])
    sources = [FileSource(rules[:ACL_RULES - ACL_DB_RULES]), db]
    t0 = time.perf_counter()
    table, index = compile_acl_batch(sources)
    compile_s = time.perf_counter() - t0
    _check(table is not None, "the static ACL did not compile")
    line = {"phase": "acl_batch", "ok": True, "card": card,
            "acl_rules": len(rules), "patterns": len(index),
            "table_states": table.n_states, "table_S": table.S,
            "table_Hb": table.Hb, "compile_s": compile_s, "actions": {}}
    total_launches = total_join = total_bad = 0
    for action in ("publish", "subscribe"):
        no_match = "deny" if action == "publish" else "allow"
        gc.collect()    # no pause of the earlier phases' garbage in it
        # -- the main path: counts zeroed just before, read just after ---
        _reset_launches()
        got: List[bool] = []
        t0 = time.perf_counter()
        for i in range(ACL_BATCHES):
            got += batch_authorize(table, index,
                                   topics[i * BATCH:(i + 1) * BATCH],
                                   action, no_match=no_match, device=device)
        card_s = time.perf_counter() - t0
        launches = walk_kernel.launches
        join_launches = walk_kernel.join_launches
        flat = _flat_launches(device, f"acl_batch.{action}", 0)
        # -----------------------------------------------------------------
        az = Authz(sources, no_match=no_match, cache_max_size=1 << 16)
        t0 = time.perf_counter()
        want = [az.authorize("c", action, t) for t in topics]
        host_s = time.perf_counter() - t0
        bad = sum(g != w for g, w in zip(got, want))
        total_bad += bad
        total_launches += launches
        total_join += join_launches
        line["actions"][action] = {
            "no_match": no_match, "topics": len(topics),
            "allowed": sum(got), "denied": len(got) - sum(got),
            "verdict_mismatches": bad, "kernel_launches": launches,
            "join_kernel_launches": join_launches,
            "flat_epilogue_launches": flat,
            "batch_authorize_ms_per_batch": card_s / ACL_BATCHES * 1e3,
            "host_authz_us_per_topic": host_s / len(topics) * 1e6,
            "host_authz_metrics": dict(az.metrics)}
        _check(bad == 0, f"{bad} {action} verdicts differ from host Authz")
        _check(0 < sum(got) < len(got), f"{action}: one verdict for all")
        if device.type == "cuda":
            _check(launches == ACL_BATCHES and join_launches == 0,
                   f"{action}: {launches} walk launches for "
                   f"{ACL_BATCHES} batches")
    line.update(kernel_launches=total_launches,
                join_kernel_launches=total_join,
                verdict_mismatches=total_bad,
                wall_s=time.perf_counter() - t_start)
    emit(line)
    return {"launches": total_launches, "join_launches": total_join}


# -- the dense walk (K6), the two-tier table (K7), the retained replay --------

def _dense_mod():
    """The module ``emqx_tpu_torch.ops.dense_match`` (the package's
    attribute of that name is the function), for its launch count."""
    import importlib

    return importlib.import_module("emqx_tpu_torch.ops.dense_match")


def _dense_err(torch, got, want) -> int:
    """Largest |difference| over the four fields of two results."""
    err = 0
    for f in ("matches", "n_matches", "active_overflow", "match_overflow"):
        a, b = getattr(got, f), getattr(want, f)
        _check(a.shape == b.shape, f"dense field {f}: shapes differ")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def _dense_bound(batch, dense, traffic: Dict[str, float],
                 K: int) -> Dict[str, object]:
    """The least time of one dense walk on these inputs: the bytes it
    must move (the batch, the table in the kernel's packed form, the
    four outputs; each once) over 3.35 TB/s, and its operations (one
    for each active state a step expands and each state it makes
    active, from ``dense_match_plain``'s ``traffic``) over
    ``SCALAR_OPS_PER_S``; the larger."""
    dm = _dense_mod()
    words, lens, _ = batch
    B, D = words.shape
    table, _nl, _np = dm.dense_table(*dense)
    nbytes = (B * D * 4 + B * 4 + B + 4 * int(table.shape[0])
              + B * K * 4 + 3 * B * 4)
    ops = traffic["states"] + traffic["children"]
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / SCALAR_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": nbytes, "bound_ops": ops,
            "row_steps": traffic["steps"],
            "states_expanded": traffic["states"]}


def _time_dense(torch, device, batches, dense, K: int, flush) -> Dict:
    """The kernel against ``dense_match_plain`` on every batch (every
    field bit for bit), then its device ms three ways as the walks are
    timed (``timer``): rotating over the distinct ``batches``, the same
    with the L2 flushed before each launch, one batch repeated; the plain
    version's ms from a CUDA graph replay; the bound on these inputs."""
    dm = _dense_mod()
    time_ms = timer(torch, device)
    err, traffics = 0, []
    for b in batches:
        traffic: Dict[str, int] = {}
        want = dm.dense_match_plain(*b, *dense, max_matches=K,
                                    traffic=traffic)
        err = max(err, _dense_err(torch, dm.dense_match(
            *b, *dense, max_matches=K), want))
        traffics.append(traffic)
    _check(err == 0, f"dense_walk != plain (max |diff| {err})")
    turn = [0]

    def rotate():
        turn[0] += 1
        dm.dense_match(*batches[turn[0] % len(batches)], *dense,
                       max_matches=K)

    card = device.type == "cuda"
    n = 1 if card else 0        # the CPU rehearsal times one call each
    warm = time_ms(lambda: dm.dense_match(*batches[0], *dense,
                                          max_matches=K), 200 * n or 1)
    rot = time_ms(rotate, 20 * len(batches) * n or 1)
    cold = time_ms(rotate, 4 * len(batches) * n or 1, before=flush)
    _check(not card or all(x["covered"] for x in (warm, rot, cold)),
           "a dense_walk time was not covered by the sleep")

    def plain_call():
        dm.dense_match_plain(*batches[0], *dense, max_matches=K)

    call_ms = time_ms(plain_call, 2 if card else 1)["call_ms"]
    pt = (time_ms(graph_replay(torch, plain_call), 20) if card
          else {"ms": call_ms, "covered": False})
    words = batches[0][0]
    bound = _dense_bound(batches[0], dense, {
        k: float(np.mean([t[k] for t in traffics])) for k in traffics[0]}, K)
    return {"B": int(words.shape[0]), "D": int(words.shape[1]),
            "S": int(dense[2].shape[0]), "K": K,
            "distinct_batches": len(batches), "ms": rot["ms"],
            "ms_cold": cold["ms"], "ms_warm": warm["ms"],
            "call_ms": warm["call_ms"], "plain_ms": pt["ms"],
            "plain_call_ms": call_ms, "plain_covered": pt["covered"],
            "plain_timing": "cuda graph replay" if card else "host loop",
            **bound,
            "max_abs_err": err}


def phase_dense_kernel(torch, device, card: str) -> Dict:
    """``dense_kernel``: the dense walk (``dense_walk.cu``) against
    ``dense_match_plain`` on the card, every ``MatchResult`` field bit
    for bit, on ``bench_dense``'s table (420 filters, B = 4096, D = 8,
    K = 64: its own batch and three more of its topic stream, timed),
    random 0/1 tables at S = 128, 512 and 4096 (several parents a column
    at 128 and 4096; each timed warm), and a batch of ``$`` topics, root
    wildcards and the 64-filter fan with K = 8 (rows past K)."""
    from emqx_tpu_torch.ops import compile_filters, encode_topics

    dm = _dense_mod()
    t_start = time.perf_counter()
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device).zero_
    B = 4096

    def put(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in arrays]

    filters, table, dense_np, topics = dm.bench_dense_workload(
        batch=DENSE_BATCHES * B)
    dense = put(dense_np.device_arrays())
    batches = [put(encode_topics(table, topics[i * B:(i + 1) * B], batch=B))
               for i in range(DENSE_BATCHES)]
    bench = _time_dense(torch, device, batches, dense, DENSE_K, flush)
    bench.update(filters=len(filters), states=table.n_states)
    time_ms = timer(torch, device)
    cases = []
    for S, parents in DENSE_RANDOM:
        rdense = put(dm.random_dense(S * 10 + parents, S, parents))
        rbatch = put(dm.random_dense_batch(S + parents, B, 8))
        want = dm.dense_match_plain(*rbatch, *rdense, max_matches=DENSE_K)
        err = _dense_err(torch, dm.dense_match(*rbatch, *rdense,
                                               max_matches=DENSE_K), want)
        _check(err == 0, f"dense_walk != plain on the random S={S} table")
        multi = int((rdense[0].sum(dim=0) > 1).sum())
        cases.append({
            "S": S, "parents_max": parents, "multi_parent_columns": multi,
            "B": B, "K": DENSE_K, "equal": True, "max_abs_err": err,
            "accepts": int(want.n_matches.sum()),
            "rows_past_k": int(want.match_overflow.sum()),
            "ms_warm": time_ms(lambda: dm.dense_match(
                *rbatch, *rdense, max_matches=DENSE_K), 50)["ms"]})
    _check(any(c["multi_parent_columns"] for c in cases),
           "no random table has several parents a column")
    sys_filters = EDGE_FILTERS + ["+/status", "$SYS/broker/+"]
    sys_topics = EDGE_TOPICS + ["$SYS/status", "node/status",
                                "$SYS/broker/uptime", "a/x/c/d"]
    sys_tab = compile_filters(sys_filters, depth=16)
    sb = put(encode_topics(sys_tab, sys_topics, batch=64))
    sd = put(dm.build_dense(sys_tab).device_arrays())
    want = dm.dense_match_plain(*sb, *sd, max_matches=8)
    err = _dense_err(torch, dm.dense_match(*sb, *sd, max_matches=8), want)
    _check(err == 0, "dense_walk != plain on the $-topic batch")
    _check(bool(sb[2].any()) and int(want.match_overflow.sum()) > 0,
           "the $-topic batch has no $ topic or no row past K")
    worst = max([bench["max_abs_err"], err]
                + [c["max_abs_err"] for c in cases])
    emit({"phase": "dense_kernel", "ok": True, "card": card,
          "kernel": "dense_walk", "tolerance": "exact", "bench_dense": bench,
          "random_tables": cases,
          "sys_batch": {"topics": len(sys_topics), "B": 64, "K": 8,
                        "S": int(sd[2].shape[0]), "equal": True,
                        "sys_rows": int(sb[2].sum()),
                        "rows_past_k": int(want.match_overflow.sum())},
          "max_abs_err": worst, "wall_s": time.perf_counter() - t_start})
    return {"max_abs_err": worst, "bench_dense": bench}


class _HostRows:
    """Counts the rows a ``TieredMatcher`` serves from the host matcher
    (its ``_decode`` fail-open: a spilled walk or a dense row past K)."""

    def __init__(self, tm) -> None:
        self.rows = 0
        inner = tm._decode

        def decode(acc, flags, tab, topics):
            self.rows += int(np.count_nonzero(flags[: len(topics)]))
            return inner(acc, flags, tab, topics)

        tm._decode = decode


def phase_tiered(torch, device, card: str, n_filters: int) -> Dict:
    """``tiered``: ``bench_tiered``'s workload at its defaults (200,000 +
    320 filters, 5,000 cold roots, 40 hot roots, hot_mass 0.8, seed 5;
    B = 8192, D = 8) through ``TieredMatcher(hot_engine="auto")`` on the
    card, every topic against a host ``FilterTrie`` (0 mismatches), the
    rows the host served, the hot tier's states, S and filters; the
    whole table's hash walk timed beside the tiered pair; the fused pair
    equal field for field to the two calls made apart, with no host
    synchronisation inside it; the dense kernel timed at the matcher's
    hot shape (the batch and three more of the same stream)."""
    from emqx_tpu_torch.broker.trie import FilterTrie
    from emqx_tpu_torch.ops import compile_filters, encode_topics, walk_kernel
    from emqx_tpu_torch.ops.match_kernel import epilogue, nfa_match
    from emqx_tpu_torch.ops.walk_kernel import accept_cols, nfa_walk_plain
    from emqx_tpu_torch.ops.tiered import (TieredMatcher, _pow2,
                                           bench_tiered_workload,
                                           fused_tiered_match, route)

    dm = _dense_mod()
    t_start = time.perf_counter()
    B = TIERED_BATCH
    filters, tiered, topics = bench_tiered_workload(
        n_filters, batch=DENSE_BATCHES * B)
    build_s = time.perf_counter() - t_start
    main = topics[:B]            # bench_tiered's own batch
    dense_np = dm.build_dense(tiered.hot)
    line = {"phase": "tiered", "ok": True, "card": card,
            "n_filters": len(filters), **tiered.stats(),
            "hot_states": tiered.hot.n_states, "dense_S": dense_np.S,
            "build_s": build_s}
    tm = TieredMatcher(tiered, depth=8, hot_engine="auto", device=device)
    tm.match(main[:256])         # ships the tables and the packed table
    host = _HostRows(tm)
    gc.collect()
    # -- the main path: counts zeroed just before, read just after -------
    dm.launches = 0
    _reset_launches()
    t0 = time.perf_counter()
    got = tm.match(main)
    match_s = time.perf_counter() - t0
    launches = {"dense": dm.launches, "hash": walk_kernel.launches}
    _flat_launches(device, "tiered", 0)
    # ---------------------------------------------------------------------
    _check(tm.hot_engine == "dense", f"auto resolved to {tm.hot_engine}")
    _check(device.type != "cuda" or launches == {"dense": 1, "hash": 1},
           f"one batch launched {launches}")
    t0 = time.perf_counter()
    trie = FilterTrie()
    for f in filters:
        trie.insert(f)
    mism = sum(sorted(g) != sorted(trie.match(t))
               for t, g in zip(main, got))
    oracle_s = time.perf_counter() - t0
    _check(mism == 0, f"{mism} of {B} tiered topics differ from the trie")
    hot_idx, cold_idx = route(main, tiered.hot_roots)

    def put(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in arrays]

    dense = put(dense_np.device_arrays())
    cold_tab = put(tiered.cold.device_arrays())
    hargs = put(encode_topics(tiered.hot, [main[i] for i in hot_idx],
                              batch=_pow2(len(hot_idx)))) + dense
    cargs = put(encode_topics(tiered.cold, [main[i] for i in cold_idx],
                              batch=_pow2(len(cold_idx)))) + cold_tab
    dm.dense_match(*hargs, max_matches=DENSE_K)   # packed table built
    dm.launches = 0
    _reset_launches()
    card_run = device.type == "cuda"
    if card_run:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")   # a host sync raises
    try:
        d, c = fused_tiered_match(hargs, cargs)
    finally:
        if card_run:
            torch.cuda.set_sync_debug_mode("default")
    fused_launches = {"dense": dm.launches, "hash": walk_kernel.launches}
    _flat_launches(device, "tiered_fused", 0)
    d2 = dm.dense_match(*hargs, max_matches=DENSE_K)
    c2 = nfa_match(*cargs, active_slots=8, compact_output=False)
    for f in ("matches", "n_matches", "active_overflow", "match_overflow"):
        for a, b in ((d, d2), (c, c2)):
            _check(torch.equal(getattr(a, f), getattr(b, f)),
                   f"fused_tiered_match field {f} differs from the call")
    time_ms = timer(torch, device)
    full = compile_filters(filters, depth=8)
    full_args = put(encode_topics(full, main, batch=B)) + put(
        full.device_arrays())
    reps = 50 if card_run else 1
    whole = time_ms(lambda: nfa_match(*full_args, active_slots=8,
                                      compact_output=False), reps)
    pair = time_ms(lambda: fused_tiered_match(hargs, cargs), reps)
    cold_ms = time_ms(lambda: nfa_match(*cargs, active_slots=8,
                                        compact_output=False), reps)

    def plain_pair():       # the pair's plain versions, raw epilogue
        dm.dense_match_plain(*hargs, max_matches=DENSE_K)
        epilogue(*nfa_walk_plain(*cargs, active_slots=8), DENSE_K, False, 0)

    pair_plain = time_ms(graph_replay(torch, plain_pair) if card_run
                         else plain_pair, 20 if card_run else 1)
    # the pair's bound: the dense walk's on the hot batch plus the bytes
    # the cold walk must move (its gathered rows and its row I/O)
    dense_traffic: Dict[str, int] = {}
    dm.dense_match_plain(*hargs, max_matches=DENSE_K, traffic=dense_traffic)
    walk_traffic: Dict[str, int] = {}
    nfa_walk_plain(*cargs, active_slots=8, traffic=walk_traffic)
    Bc, Dc = cargs[0].shape
    cold_bytes = (walk_traffic["node_rows"] * 16
                  + walk_traffic["bucket_rows"] * 32 + 8 + Bc * Dc * 4
                  + 5 * Bc + Bc * accept_cols(Dc, 8) * 4 + 4 * Bc)
    pair_bound = (_dense_bound(hargs[:3], hargs[3:], dense_traffic,
                               DENSE_K)["bound_ms"]
                  + cold_bytes / HBM_BYTES_PER_S * 1e3)
    t0 = time.perf_counter()
    whole_rows = nfa_match(*full_args, active_slots=8, compact_output=False)
    whole_acc = whole_rows.matches.cpu().numpy()
    whole_rows_s = time.perf_counter() - t0
    flush = (torch.empty(64 << 20, dtype=torch.int32, device=device).zero_
             if card_run else None)
    hot_batches = []
    for i in range(DENSE_BATCHES):
        part = topics[i * B:(i + 1) * B]
        hi, _ = route(part, tiered.hot_roots)
        hot_batches.append(put(encode_topics(
            tiered.hot, [part[j] for j in hi], batch=_pow2(len(hi)))))
    shape = _time_dense(torch, device, hot_batches, dense, DENSE_K, flush)
    line.update(
        topics=B, hot_topics=len(hot_idx), cold_topics=len(cold_idx),
        hot_engine=tm.hot_engine, launches=launches,
        fused_launches=fused_launches, fused_equal=True,
        fused_host_syncs=0, host_rows=host.rows, mismatches=mism,
        matcher_match_s=match_s, oracle_s=oracle_s,
        whole_table={"states": full.n_states, "table_bytes": int(
            full.node_tab.nbytes + full.edge_tab.nbytes),
            "walk_ms": whole["ms"],
            "spilled_rows": int((whole_rows.active_overflow > 0).sum()),
            "walk_and_readback_s": whole_rows_s,
            "accept_slots": int((whole_acc >= 0).sum())},
        tiered_pair_ms=pair["ms"], tiered_pair_plain_ms=pair_plain["ms"],
        tiered_pair_bound_ms=pair_bound, cold_walk_ms=cold_ms["ms"],
        dense_ms=shape["ms_warm"], hot_shape=shape,
        wall_s=time.perf_counter() - t_start)
    emit(line)
    return {"launches": launches, "fused_launches": fused_launches,
            "shape": shape}


def phase_retained_replay(torch, device, card: str, size: int) -> Dict:
    """``retained_replay``: BASELINE config 5 on one card, cut to
    ``size`` (100,000) retained names and as many new filters (the
    workload generator, seed 0; the names its first ``size`` distinct
    topics): ``Retainer.replay_batch`` compiles the filters and walks
    every stored name in one hash walk on the card; each filter's topics
    must equal the inverse of a host ``FilterTrie``'s per-name matches,
    and no filter may be served by the host walk."""
    from emqx_tpu_torch.broker.message import make_message
    from emqx_tpu_torch.broker.trie import FilterTrie
    from emqx_tpu_torch.ops import walk_kernel
    from emqx_tpu_torch.services.retainer import Retainer
    from emqx_tpu_torch.workload import build_workload

    t_start = time.perf_counter()
    filters, stream = build_workload(np.random.default_rng(REPLAY_SEED),
                                     size, 3 * size)
    names = list(dict.fromkeys(stream))[:size]
    _check(len(names) == size, f"only {len(names)} distinct names")
    r = Retainer()
    for t in names:
        r.insert(make_message("retainer", t, b"v", retain=True))
    host_calls = [0]
    inner = r.match

    def counted(flt, now=None):
        host_calls[0] += 1
        return inner(flt, now)

    r.match = counted
    setup_s = time.perf_counter() - t_start
    gc.collect()
    # -- the main path: counts zeroed just before, read just after -------
    _reset_launches()
    t0 = time.perf_counter()
    out = r.replay_batch(filters, device=device)
    replay_s = time.perf_counter() - t0
    launches = walk_kernel.launches
    _flat_launches(device, "retained_replay", 0)
    # ---------------------------------------------------------------------
    _check(device.type != "cuda" or launches == 1,
           f"the replay launched the walk {launches} times")
    _check(host_calls[0] == 0, f"{host_calls[0]} filters served by the host")
    t0 = time.perf_counter()
    trie = FilterTrie()
    for f in filters:
        trie.insert(f)
    want: Dict[str, List[str]] = {f: [] for f in filters}
    for t in names:
        for f in trie.match(t):
            want[f].append(t)
    oracle_s = time.perf_counter() - t0
    mism = sum([m.topic for m in out[f]] != sorted(want[f])
               for f in filters)
    _check(mism == 0, f"{mism} filters replayed other topics than the trie")
    pairs = sum(map(len, want.values()))
    emit({"phase": "retained_replay", "ok": True, "card": card,
          "retained": len(names), "filters": len(filters), "depth": 16,
          "replay_s": replay_s, "launches": launches,
          "host_served_filters": host_calls[0], "mismatches": mism,
          "matched_pairs": pairs,
          "filters_with_a_match": sum(1 for v in want.values() if v),
          "setup_s": setup_s, "oracle_s": oracle_s,
          "wall_s": time.perf_counter() - t_start})
    return {"launches": launches}


# -- the MQTT front door: BrokerNode over TCP ---------------------------------
#
# The fleet lives in child processes (spawned: forking after CUDA is
# initialised is unsafe), so that the broker's event loop is alone in
# its process, as in a deployment.  Each child runs MQTT clients of the
# port's client on its own loop and obeys commands from the broker's
# process over a pipe.  Payloads carry the message's index in the topic
# stream and time.monotonic_ns() at send (system-wide on Linux).


def _raise_nofile(need: int) -> Dict[str, int]:
    """Raise this process's RLIMIT_NOFILE soft limit to its hard limit;
    fail with the numbers when that is fewer than ``need`` descriptors."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    _check(soft == resource.RLIM_INFINITY or soft >= need,
           f"RLIMIT_NOFILE: {soft} descriptors (hard limit {hard}), "
           f"{need} needed")
    return {"soft": soft, "hard": hard, "need": need}


class _Fleet:
    """One child process's clients: fleet clients (each subscribing its
    filters in one SUBSCRIBE at ``SUB_QOS``, recording every delivery),
    the publishers among them, and the churn clients (recording
    nothing)."""

    CONNECT_CONCURRENCY = 32

    def __init__(self, spec: Dict) -> None:
        self.spec = spec
        self.clients = {}          # client id -> Client
        self.recv_client = []      # per delivery: the fleet client's index
        self.recv_msg = []         # ... the message's index
        self.recv_lat_us = []      # ... publish -> delivered, microseconds
        self.last_recv = 0.0
        self.last_recv_ns = 0
        self.churn_task = None
        self.churn_reqs = []
        self.churn_done = {"subscribed": 0, "unsubscribed": 0}

    def _on_message(self, idx: int):
        def on_message(m) -> None:
            now = time.monotonic_ns()
            i, t = m.payload.split(b" ")
            self.recv_client.append(idx)
            self.recv_msg.append(int(i))
            self.recv_lat_us.append((now - int(t)) // 1000)
            self.last_recv = time.monotonic()
            self.last_recv_ns = now
        return on_message

    async def connect(self, port: int) -> Dict:
        from emqx_tpu_torch.client import Client

        sem = asyncio.Semaphore(self.CONNECT_CONCURRENCY)
        last = [0]

        async def one(cid, idx, filters):
            async with sem:
                c = Client(clientid=cid, port=port, keepalive=600,
                           on_message=(self._on_message(idx)
                                       if idx >= 0 else (lambda m: None)))
                await c.connect(timeout=60)
                self.clients[cid] = c
            if filters:
                codes = await c.subscribe([(f, SUB_QOS) for f in filters],
                                          timeout=600)
                _check(all(x == SUB_QOS for x in codes),
                       f"{cid}: SUBACK codes {set(codes)}")
                last[0] = max(last[0], time.monotonic_ns())

        t0 = time.perf_counter()
        c0 = time.process_time()
        await asyncio.gather(
            *[one(cid, idx, flts) for cid, idx, flts in self.spec["fleet"]],
            *[one(cid, -1, flts) for cid, flts in self.spec["churn"]])
        return {"clients": len(self.clients), "last_suback_ns": last[0],
                "wall_s": time.perf_counter() - t0,
                "cpu_s": time.process_time() - c0}

    async def storm(self, topics: List[str], lo: int, hi: int) -> Dict:
        """Each publisher of this process publishes, at QoS 1 and each
        awaiting its PUBACK before the next, the stream indices ``i`` in
        ``[lo, hi)`` with ``i`` modulo the publisher count its publisher
        index."""
        lat = []
        stride = self.spec["n_publishers"]

        async def publisher(cid: str, g: int) -> None:
            c = self.clients[cid]
            first = lo + (g - lo) % stride
            for i in range(first, hi, stride):
                t0 = time.perf_counter_ns()
                rc = await c.publish(
                    topics[i], b"%d %d" % (i, time.monotonic_ns()), qos=1,
                    timeout=120)
                lat.append((time.perf_counter_ns() - t0) // 1000)
                _check(not rc, f"PUBACK reason {rc}")

        c0 = time.process_time()
        t0 = time.perf_counter()
        await asyncio.gather(*[publisher(cid, g)
                               for cid, g in self.spec["publishers"]])
        return {"published": len(lat), "puback_us": lat,
                "wall_s": time.perf_counter() - t0,
                "cpu_s": time.process_time() - c0}

    async def drain(self, quiet_s: float = 0.5) -> Dict:
        """Wait until no delivery arrived for ``quiet_s``; hand over what
        arrived since the last drain."""
        c0 = time.process_time()
        while time.monotonic() - self.last_recv < quiet_s:
            await asyncio.sleep(0.05)
        out = {"client": np.asarray(self.recv_client, np.int64),
               "msg": np.asarray(self.recv_msg, np.int64),
               "lat_us": np.asarray(self.recv_lat_us, np.int64),
               "last_ns": self.last_recv_ns,
               "cpu_s": time.process_time() - c0}
        self.recv_client, self.recv_msg, self.recv_lat_us = [], [], []
        return out

    def churn_start(self, add: List, drop: List, rate: float) -> None:
        """Send SUBSCRIBEs of ``add`` and UNSUBSCRIBEs of ``drop``
        ((client, filter) pairs), ``rate`` of each a second on the wall
        clock (each request its own task: the rate does not wait on the
        broker's answers), until :meth:`churn_stop`."""
        done = self.churn_done = {"subscribed": 0, "unsubscribed": 0,
                                  "sent": 0}
        reqs = self.churn_reqs = []

        async def one(kind, call):
            await call
            done[kind] += 1

        async def run():
            n = max(len(add), len(drop))
            sent = 0
            t0 = time.perf_counter()
            while sent < n:
                due = min(n, int((time.perf_counter() - t0) * rate) + 1)
                for cid, flt in add[sent:due]:
                    reqs.append(asyncio.ensure_future(one(
                        "subscribed", self.clients[cid].subscribe(
                            flt, qos=SUB_QOS, timeout=300))))
                for cid, flt in drop[sent:due]:
                    reqs.append(asyncio.ensure_future(one(
                        "unsubscribed", self.clients[cid].unsubscribe(
                            flt, timeout=300))))
                done["sent"] = sent = due
                await asyncio.sleep(max(0.0, t0 + sent / rate
                                        - time.perf_counter()))
        self.churn_task = asyncio.ensure_future(run())

    async def churn_stop(self) -> Dict:
        """Stop sending; wait for the answers to what was sent."""
        t = self.churn_task
        self.churn_task = None
        if t is not None:
            if not t.done():
                t.cancel()
            try:
                await t
            except asyncio.CancelledError:
                pass
            await asyncio.gather(*self.churn_reqs)
        return dict(self.churn_done)

    async def disconnect(self) -> Dict:
        for c in self.clients.values():
            try:
                await c.disconnect()
            except Exception:  # noqa: BLE001 - a node may have closed it
                pass
            await c.close()
        self.clients = {}
        return {"disconnected": True}


def _fleet_proc(conn, spec: Dict) -> None:
    """A fleet child process: obey (command, args) messages from the
    broker's process until ``exit``; answer each with ("ok", result) or
    ("error", text)."""
    try:
        _raise_nofile(len(spec["fleet"]) + len(spec["churn"]) + 64)
    except Exception as e:  # noqa: BLE001 - reported to the parent
        conn.send(("error", f"{type(e).__name__}: {e}"))
        return
    asyncio.run(_fleet_loop(conn, spec))


async def _fleet_loop(conn, spec: Dict) -> None:
    fleet = _Fleet(spec)
    topics = spec["topics"]
    loop = asyncio.get_running_loop()
    conn.send(("ok", {"pid": __import__("os").getpid()}))
    while True:
        cmd, args = await loop.run_in_executor(None, conn.recv)
        try:
            if cmd == "exit":
                await fleet.churn_stop()
                await fleet.disconnect()
                conn.send(("ok", {}))
                return
            if cmd == "connect":
                out = await fleet.connect(*args)
            elif cmd == "storm":
                out = await fleet.storm(topics, *args)
            elif cmd == "drain":
                out = await fleet.drain(*args)
            elif cmd == "churn_start":
                fleet.churn_start(*args)
                out = {}
            elif cmd == "churn_stop":
                out = await fleet.churn_stop()
            elif cmd == "disconnect":
                out = await fleet.disconnect()
            else:
                raise ValueError(f"unknown command {cmd!r}")
            conn.send(("ok", out))
        except Exception as e:  # noqa: BLE001 - reported to the parent
            conn.send(("error", f"{cmd}: {type(e).__name__}: {e}"))


class _FleetProcs:
    """The fleet's child processes, and the commands to all of them."""

    def __init__(self, specs: List[Dict]) -> None:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.conns, self.procs = [], []
        for spec in specs:
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_fleet_proc, args=(child, spec),
                            daemon=True)
            p.start()
            child.close()
            self.conns.append(parent)
            self.procs.append(p)

    async def _recv(self, conn):
        status, out = await asyncio.to_thread(conn.recv)
        _check(status == "ok", f"fleet process: {out}")
        return out

    async def ready(self) -> List[int]:
        return [(await self._recv(c))["pid"] for c in self.conns]

    async def all(self, cmd: str, *args, only=None) -> List[Dict]:
        """Send ``cmd`` to every process (or those in ``only``), then
        gather their answers."""
        picked = [c for i, c in enumerate(self.conns)
                  if only is None or i in only]
        for c in picked:
            c.send((cmd, args))
        return list(await asyncio.gather(*[self._recv(c) for c in picked]))

    def close(self) -> None:
        for c in self.conns:
            try:
                c.send(("exit", ()))
            except OSError:
                pass
        for p in self.procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
                p.join(5)
        for c in self.conns:
            c.close()


def _fleet_specs(filters: List[str], topics: List[str], n_clients: int,
                 n_procs: int, churn: List[tuple]) -> List[Dict]:
    """The fleet shared out to ``n_procs`` processes: client ``dev{k}``
    holds its equal share of the filters (the slice_node assignment),
    the first ``MQTT_PUBLISHERS`` clients publish (all, if fewer),
    and the churn clients (with their initial filters) sit in the last
    process."""
    order = np.random.default_rng(1).permutation(len(filters))
    per = -(-len(filters) // n_clients)
    n_pub = min(MQTT_PUBLISHERS, n_clients)
    specs = [{"fleet": [], "churn": [], "publishers": [], "topics": topics,
              "n_publishers": n_pub} for _ in range(n_procs)]
    for k in range(n_clients):
        spec = specs[k % n_procs]
        cid = f"dev{k}"
        spec["fleet"].append(
            (cid, k, [filters[i] for i in order[k * per:(k + 1) * per]]))
        if k < n_pub:
            spec["publishers"].append((cid, k))
    specs[-1]["churn"] = churn
    return specs


def _expected_keys(broker, topics: List[str], lo: int, hi: int,
                   client_idx: Dict[str, int], n_msgs: int) -> np.ndarray:
    """``client * n_msgs + message`` of every delivery that messages
    ``lo..hi`` owe the fleet: one for each subscription of a fleet client
    whose filter matches the topic (``Router.match_routes`` of the
    node's router, the churn stopped)."""
    per_topic = {}
    router, subs = broker.router, broker.subscribers
    parts = []
    for i in range(lo, hi):
        t = topics[i]
        got = per_topic.get(t)
        if got is None:
            cl = [client_idx[c] for flt, _dest in router.match_routes(t)
                  for c in subs.get(flt, ()) if c in client_idx]
            got = per_topic[t] = np.asarray(cl, np.int64) * n_msgs
        parts.append(got + i)
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def _diff_keys(want: np.ndarray, got: np.ndarray) -> Dict[str, int]:
    """Missing, duplicate and extra deliveries of ``got`` against
    ``want`` (multisets of keys)."""
    want, got = np.sort(want), np.sort(got)
    if len(want) == len(got) and np.array_equal(want, got):
        return {"missing": 0, "duplicate": 0, "extra": 0}
    uw, cw = np.unique(want, return_counts=True)
    ug, cg = np.unique(got, return_counts=True)
    at = np.searchsorted(uw, ug)
    known = (at < len(uw)) & (uw[np.minimum(at, len(uw) - 1)] == ug)
    extra = int(cg[~known].sum())
    have = np.zeros(len(uw), np.int64)
    have[at[known]] = cg[known]
    d = have - cw
    return {"missing": int(-d[d < 0].sum()), "duplicate": int(d[d > 0].sum()),
            "extra": extra}


class _DropTap:
    """While active, every message a session's full mqueue dropped,
    with the session's client: ``Session.deliver`` returns its victims
    beside its sends (the ``message.dropped`` hook is told the message
    alone).  ``keys(client_idx, n_msgs)`` gives ``client * n_msgs +
    message`` of the fleet clients' drops."""

    def __init__(self) -> None:
        self.pairs = []            # (client id, payload)

    def __enter__(self):
        from emqx_tpu_torch.broker.session import Session

        orig = self._orig = Session.deliver
        pairs = self.pairs

        def deliver(sess, msgs):
            out, dropped = orig(sess, msgs)
            for m in dropped:
                pairs.append((sess.clientid, m.payload))
            return out, dropped
        Session.deliver = deliver
        return self

    def __exit__(self, *exc) -> None:
        from emqx_tpu_torch.broker.session import Session

        Session.deliver = self._orig

    def keys(self, client_idx: Dict[str, int], n_msgs: int) -> np.ndarray:
        return np.asarray([client_idx[c] * n_msgs + int(p.split(b" ")[0])
                           for c, p in self.pairs if c in client_idx],
                          np.int64)


class _LookupCount:
    """``Broker.device_match`` counting its calls (the route lookups)."""

    def __init__(self, fn) -> None:
        self.fn, self.calls = fn, 0

    def __call__(self, topic: str):
        self.calls += 1
        return self.fn(topic)


async def _mqtt_storm(fleet, node, topics, lo: int, hi: int, card: str,
                      churn=None, profile=None) -> Dict:
    """One storm over TCP: the publishers publish ``topics[lo:hi]``
    (their PUBACKs awaited), the churn (if any) beside, under the
    profiler when ``profile`` wraps the storm; then each child drains its
    deliveries, which are held against the node's routes.  Returns the
    storm's line."""
    broker = node.broker
    metrics = node.observed.metrics
    m0 = metrics.all()
    gc.collect()
    t_cpu = time.process_time()
    churn_done = None
    tap = _DropTap()
    with GcPauses() as pauses, tap:
        if churn is not None:
            await fleet.all("churn_start", *churn, only=[len(fleet.conns) - 1])
        t0 = time.perf_counter()
        t0_ns = time.monotonic_ns()
        if profile is not None:
            busy = await profile(lambda: fleet.all("storm", lo, hi))
            done = busy.pop("result")
        else:
            busy = None
            done = await fleet.all("storm", lo, hi)
        wall = time.perf_counter() - t0
        if churn is not None:
            churn_done = (await fleet.all("churn_stop",
                                          only=[len(fleet.conns) - 1]))[0]
        broker_cpu = time.process_time() - t_cpu
        # the fanout's deliveries (and its drops) may trail the PUBACKs
        # by seconds, with pauses longer than one quiet drain: drain
        # again while deliveries owed are neither delivered nor dropped
        # (at most DRAIN_MAX_S); a missing one still fails the storm
        drained = await fleet.all("drain", 0.5)
        want = _expected_keys(broker, topics, lo, hi, fleet.client_idx,
                              len(topics))
        t_drain = time.perf_counter()
        while (sum(len(d["msg"]) for d in drained)
               + len(tap.keys(fleet.client_idx, len(topics))) < len(want)
               and time.perf_counter() - t_drain < DRAIN_MAX_S):
            more = await fleet.all("drain", 0.5)
            drained = [{"client": np.concatenate([d["client"], m["client"]]),
                        "msg": np.concatenate([d["msg"], m["msg"]]),
                        "lat_us": np.concatenate([d["lat_us"], m["lat_us"]]),
                        "last_ns": max(d["last_ns"], m["last_ns"]),
                        "cpu_s": d["cpu_s"] + m["cpu_s"]}
                       for d, m in zip(drained, more)]
    m1 = metrics.all()
    delta = {k: m1[k] - m0[k] for k in m1 if m1[k] != m0[k]}
    n = sum(d["published"] for d in done)
    puback = np.concatenate([np.asarray(d["puback_us"], np.int64)
                             for d in done])
    lat = np.concatenate([d["lat_us"] for d in drained])
    # until the last delivery (the fanout acks a publish at its offer, so
    # its deliveries may trail the last PUBACK)
    delivered_wall = max(wall, (max(d["last_ns"] for d in drained)
                                - t0_ns) / 1e9)
    line = {"card": card, "publishes": n, "publishes_per_s": n / wall,
            "wall_s": wall, "delivered_wall_s": delivered_wall,
            "delivery_trail_s": delivered_wall - wall,
            "delivered_publishes_per_s": n / delivered_wall,
            "puback_ms": {"p50": _pct(puback, 50) / 1e3,
                          "p99": _pct(puback, 99) / 1e3,
                          "max": float(puback.max()) / 1e3},
            "delivered_ms": ({"p50": _pct(lat, 50) / 1e3,
                              "p99": _pct(lat, 99) / 1e3,
                              "max": float(lat.max()) / 1e3}
                             if len(lat) else None),
            "deliveries": int(len(lat)),
            "deliveries_per_s": len(lat) / delivered_wall,
            "gc": {**pauses.summary(), "full_collections": pauses.count[2],
                   "full_ms": pauses.pause_ms[2]},
            "broker_cpu_s": broker_cpu,
            "client_cpu_s": [round(d["cpu_s"], 3) for d in done],
            "churn": churn_done,
            "counters": {k: v for k, v in delta.items()
                         if k.startswith(("tpu.", "broker.match.",
                                          "messages.dropped",
                                          "delivery.dropped",
                                          "broker.outbox", "broker.fanout.",
                                          "broker.olp."))}}
    if busy is not None:
        line["device_busy"] = busy
    n_msgs = len(topics)
    got = np.concatenate([d["client"] * n_msgs + d["msg"] for d in drained])
    dropped = tap.keys(fleet.client_idx, n_msgs)
    line["checked"] = int(len(want))
    # each delivery owed arrived once, or a full mqueue dropped it once
    line["queue_full"] = len(tap.pairs)
    line["queue_full_fleet"] = int(len(dropped))
    line["queue_full_clients"] = len({c for c, _p in tap.pairs})
    line.update(_diff_keys(want, np.concatenate([got, dropped])))
    return line


def _storm_checks(line: Dict, device_path: bool, on_card: bool) -> List[str]:
    """The checks of an MQTT storm's line."""
    c = line["counters"]
    queue_full = c.get("messages.dropped.queue_full", 0)
    dropped = (c.get("messages.dropped", 0) - queue_full
               - c.get("messages.dropped.no_subscribers", 0))
    failed = [what for ok, what in (
        (line["missing"] == line["duplicate"] == line["extra"] == 0,
         f"deliveries: {line['missing']} missing, {line['duplicate']} "
         f"duplicate, {line['extra']} extra of {line['checked']} "
         f"({line['queue_full_fleet']} dropped queue_full)"),
        (queue_full == line["queue_full"],
         f"{queue_full} queue_full drops counted, {line['queue_full']} "
         "recorded by the sessions"),
        (dropped == 0 and c.get("delivery.dropped", 0) == 0
         and c.get("broker.outbox.dropped", 0) == 0,
         f"{dropped} messages dropped (beside no_subscribers and "
         f"queue_full), {c.get('delivery.dropped', 0)} deliveries "
         f"dropped, {c.get('broker.outbox.dropped', 0)} outbox drops"),
        (line["delivery_trail_s"] <= DELIVERY_TRAIL_MAX_S,
         f"the last delivery trailed the last PUBACK by "
         f"{line['delivery_trail_s']:.2f} s (bound "
         f"{DELIVERY_TRAIL_MAX_S} s)"))
        if not ok]
    if device_path:
        failed += [what for ok, what in (
            (line["prefetch_timeouts"] == 0 and line["failed_batches"] == 0,
             f"{line['prefetch_timeouts']} prefetches timed out, "
             f"{line['failed_batches']} device batches failed"),)
            if not ok]
        if on_card:
            failed += [what for ok, what in (
                (line["kernel_launches"] == line["walk_dispatches"],
                 f"walk launches {line['kernel_launches']} != dispatches "
                 f"{line['walk_dispatches']}"),
                (line["walk_dispatches"] > 0,
                 "the storm never reached the card"),
                (line["hint_share_device"] >= 0.5,
                 f"device hint share {line['hint_share_device']:.3f} "
                 "< 0.5"))
                if not ok]
    return failed


async def _mqtt_device_storm(fleet, node, topics, lo, hi, card, churn,
                             logs, device, path: str) -> Dict:
    """A storm through the node's match service: launches counted from
    just before to just after, the hint share of the route lookups, and
    the service's logged failures."""
    from emqx_tpu_torch.ops import walk_kernel

    ms = node.match_service
    lookups = _LookupCount(ms.hint_routes)
    node.broker.device_match = lookups
    logs.reset()
    d0, b0 = ms.dispatches, len(ms._batch_ms)
    # -- the main path: counts zeroed just before, read just after -------
    _reset_launches()
    line = await _mqtt_storm(fleet, node, topics, lo, hi, card, churn)
    launches = walk_kernel.launches
    join_launches = walk_kernel.join_launches
    flat = _flat_launches(device, path, launches + join_launches)
    # ---------------------------------------------------------------------
    c = line["counters"]
    served = c.get("tpu.match.hint_served", 0)
    host = c.get("tpu.match.hint_served_host", 0)
    batches = len(ms._batch_ms) - b0
    batch_ms = ms._batch_ms[b0:] or [0.0]
    line.update({
        "walk_dispatches": ms.dispatches - d0, "kernel_launches": launches,
        "join_kernel_launches": join_launches, "route_lookups":
        lookups.calls, "hint_share": served / max(1, lookups.calls),
        "hint_share_device": (served - host) / max(1, lookups.calls),
        "device_batches": batches,
        "topics_per_device_batch":
            c.get("tpu.match.topics", 0) / max(1, batches),
        "batch_ms": {"mean": float(np.mean(batch_ms)),
                     "p99": _pct(batch_ms, 99), "max": max(batch_ms)},
        "prefetch_timeouts": logs.timeouts, "failed_batches": logs.failed,
        "stale_race_batches": logs.stale_races,
        "logged_errors": logs.errors})
    node.broker.device_match = ms.hint_routes
    return line


async def _mqtt_node_phase(torch, device, name: str, fleet, filters, topics,
                           card, storm_batches: int, fanout: bool,
                           churn_seed: int, logs) -> Dict:
    """One node at the reference's defaults (fanout per ``fanout``) on
    127.0.0.1:0: the fleet connects and subscribes after ``start()``,
    the time to route all of it, the warm-up and the timed storm with a
    churn beside, a profiled storm, then the match service stopped and
    the timed storm again through the host trie.  Emits the phase's
    line; returns the walk launches of its main path."""
    from emqx_tpu_torch.config import Config
    from emqx_tpu_torch.node import BrokerNode

    t_start = time.perf_counter()
    fleet.churn_held = list(fleet.churn_start)
    cfg = Config(env={})
    cfg.put("listeners.tcp.default.bind", "127.0.0.1:0")
    cfg.put("broker.fanout.enable", fanout)
    if device.type != "cuda":
        # the plain walks on the CPU (rehearsal) outlast the 0.5 s timeout
        cfg.put("tpu.prefetch_timeout", 60.0)
    node = BrokerNode(cfg, device=device)
    try:
        t0 = time.perf_counter()
        await node.start()
        start_s = time.perf_counter() - t0
        ms = node.match_service
        _count_batches(ms)
        port = node.listeners.all()[0].port
        connected = await fleet.all("connect", port)
        last_suback = max(c["last_suback_ns"] for c in connected)
        subscribed_s = time.perf_counter() - t0 - start_s
        router = node.broker.router
        wild = len(router.wildcard_filters())
        while not (ms.ready and ms._synced_epoch == router.epoch
                   and ms.dev.epoch == ms.inc.epoch
                   and ms.inc.n_filters >= wild):
            _check(time.perf_counter() - t0 < 1800,
                   "the mirror never routed the fleet")
            await asyncio.sleep(0.002)
        routed_s = (time.monotonic_ns() - last_suback) / 1e9
        line = {"phase": name, "ok": True, "card": card,
                "fanout": fanout, "start_s": start_s,
                "clients": sum(c["clients"] for c in connected),
                "subscribe_s": subscribed_s,
                "fleet_connect_cpu_s": [round(c["cpu_s"], 3)
                                        for c in connected],
                "routes": router.route_count(), "wildcard_filters": wild,
                "table_filters": ms.inc.n_filters,
                "last_suback_to_routed_s": routed_s,
                "mirror": {"uploads": ms.dev.uploads,
                           "delta_applies": ms.dev.delta_applies,
                           "refresh": node.observed.metrics.get(
                               "tpu.mirror.refresh"),
                           "recompile": node.observed.metrics.get(
                               "tpu.mirror.recompile")},
                "service_freezes": ms.freezes,
                "gc_frozen_objects": gc.get_freeze_count()}
        warm_hi = MQTT_WARM * BATCH
        hi = warm_hi + storm_batches * BATCH
        busy_hi = hi + MQTT_BUSY * BATCH
        held = set(router.wildcard_filters())
        add = _fresh_filters(held, NODE_CHURN, churn_seed)
        churners = fleet.churn_ids
        adds = [(churners[i % len(churners)], f) for i, f in enumerate(add)]
        drops = fleet.churn_held[:NODE_CHURN]
        failed = []
        warm = await _mqtt_device_storm(fleet, node, topics, 0, warm_hi,
                                        card, None, logs, device,
                                        f"{name}.warmup")
        failed += [f"warm-up: {f}" for f in
                   _storm_checks(warm, True, device.type == "cuda")]
        line["warmup"] = {k: warm[k] for k in (
            "publishes", "publishes_per_s", "checked", "missing",
            "duplicate", "extra", "hint_share_device")}
        dev = await _mqtt_device_storm(fleet, node, topics, warm_hi, hi,
                                       card, (adds, drops, NODE_CHURN_RATE),
                                       logs, device, name)
        dev_failed = _storm_checks(dev, True, device.type == "cuda")
        # the churn's filters stay; the next churn unsubscribes them
        fleet.churn_held = fleet.churn_held[NODE_CHURN:] + adds
        # the card's busy share over more publishes, under the profiler
        profiled = await _mqtt_storm(
            fleet, node, topics, hi, busy_hi, card,
            profile=lambda storm: _busy_result(torch, device, storm))
        dev_failed += [f"profiled storm: {f}" for f in
                       _storm_checks(profiled, False, False)]
        dev["device_busy"] = profiled.pop("device_busy")
        dev["device_busy"]["publishes"] = profiled["publishes"]
        dev["service"] = ms.info()
        _emit_storm(f"{name}.device", dev, dev_failed)
        failed += dev_failed
        # the host trie alone, on the same node: the service stopped
        await ms.stop()
        node.match_service = None
        node.broker.device_match = None
        if node.fanout_pipeline is not None:
            node.fanout_pipeline.match_service = None
        add2 = _fresh_filters(set(router.wildcard_filters()), NODE_CHURN,
                              churn_seed + 100)
        adds2 = [(churners[i % len(churners)], f)
                 for i, f in enumerate(add2)]
        drops2 = fleet.churn_held[:NODE_CHURN]
        host = await _mqtt_storm(fleet, node, topics, warm_hi, hi, card,
                                 (adds2, drops2, NODE_CHURN_RATE))
        fleet.churn_held = fleet.churn_held[NODE_CHURN:] + adds2
        host["device_busy"] = {"busy_share": "not measured",
                               "why": "no device path"}
        host_failed = _storm_checks(host, False, False)
        _emit_storm(f"{name}.host_trie", host, host_failed)
        failed += [f"host trie: {f}" for f in host_failed]
        line["queue_full"] = {"device": dev["queue_full"],
                              "host_trie": host["queue_full"]}
        line["device_over_host"] = (dev["publishes_per_s"]
                                    / host["publishes_per_s"])
        line["delivered_device_over_host"] = (
            dev["delivered_publishes_per_s"]
            / host["delivered_publishes_per_s"])
        await fleet.all("disconnect")
        line["phase_wall_s"] = time.perf_counter() - t_start
        _emit_checked(line, failed)
        return {"launches": (dev["kernel_launches"],
                             dev["join_kernel_launches"])}
    finally:
        await node.stop()


def _emit_storm(phase: str, line: Dict, failed: List[str]) -> None:
    """One storm's line, with the checks it failed (the phase fails on
    them after its last storm)."""
    out = {"phase": phase, "ok": not failed, **line}
    if failed:
        out["failed_checks"] = failed
    emit(out)


async def _busy_result(torch, device, storm) -> Dict:
    """``_busy`` over ``storm()``, with the storm's result kept (on the
    CPU the storm runs unprofiled)."""
    box = {}

    async def run():
        box["result"] = await storm()
    out = await _busy(torch, device, run)
    out["result"] = box["result"] if box else await storm()
    return out


def phase_slice_mqtt(torch, device, n_filters: int, card: str,
                     storm_batches: int, n_clients: int) -> Dict:
    """The MQTT front door at ``n_filters`` subscriptions of BASELINE
    config 2's workload (``MQTT_FILTERS``, 750k, by default): the
    port's ``BrokerNode`` at the reference's node defaults over TCP,
    driven by a fleet of ``n_clients`` MQTT clients in ``MQTT_PROCS``
    child processes and ``CHURN_CLIENTS`` churn clients
    (``slice_mqtt``), then the same on a second node with
    ``broker.fanout.enable`` (``slice_mqtt_fanout``)."""
    return asyncio.run(_slice_mqtt(torch, device, n_filters, card,
                                   storm_batches, n_clients))


async def _slice_mqtt(torch, device, n_filters, card, storm_batches,
                      n_clients):
    from emqx_tpu_torch.workload import build_workload

    t0 = time.perf_counter()
    n_topics = (MQTT_WARM + storm_batches + MQTT_BUSY) * BATCH
    filters, topics = build_workload(np.random.default_rng(0), n_filters,
                                     n_topics)
    held = set(filters)
    # the churn clients' own filters: their first unsubscribes drop these
    start = _fresh_filters(held, NODE_CHURN, 21)
    churn_ids = [f"churn{k}" for k in range(CHURN_CLIENTS)]
    per = -(-len(start) // CHURN_CLIENTS)
    churn = [(cid, start[k * per:(k + 1) * per])
             for k, cid in enumerate(churn_ids)]
    # the broker's side of every client's socket, and a margin
    nofile = _raise_nofile(n_clients + CHURN_CLIENTS + 256)
    specs = _fleet_specs(filters, topics, n_clients, MQTT_PROCS, churn)
    fleet = _FleetProcs(specs)
    fleet.client_idx = {f"dev{k}": k for k in range(n_clients)}
    fleet.churn_ids = churn_ids
    fleet.churn_start = [(cid, f) for cid, flts in churn for f in flts]
    logs = _LogCount()
    svc_log = logging.getLogger(NODE_LOGGER)
    svc_log.setLevel(logging.DEBUG)
    svc_log.addHandler(logs)
    node_log = logging.getLogger("emqx_tpu_torch.node")
    node_log.addHandler(logs)
    out = {}
    try:
        pids = await fleet.ready()
        emit({"phase": "slice_mqtt_fleet", "ok": True,
              "clients": n_clients, "churn_clients": CHURN_CLIENTS,
              "processes": len(pids), "nofile": nofile,
              "workload_s": time.perf_counter() - t0,
              "wall_s": time.perf_counter() - t0})
        for name, fanout, seed in (("slice_mqtt", False, 31),
                                   ("slice_mqtt_fanout", True, 41)):
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            got = await _mqtt_node_phase(
                torch, device, name, fleet, filters, topics, card,
                storm_batches, fanout, seed, logs)
            out[name] = got["launches"]
        return out
    finally:
        fleet.close()
        svc_log.removeHandler(logs)
        node_log.removeHandler(logs)
        gc.unfreeze()       # the services froze the started heap


# ---------------------------------------------------------------------------
# The exhook boundary: the match sidecar in a child process of its
# own (spawned, as in a deployment: ``serve()`` on its own loop), driven
# over gRPC from this process or from the port's BrokerNode.  The child
# obeys commands over a pipe, as the MQTT fleet's processes do, and
# answers ``counters`` with the sidecar's counters and its process's walk
# launches.

EXHOOK_MATCH_CALLS = 20      # exhook_sidecar: MatchBatch calls of BATCH
EXHOOK_PUBLISHES = 8192      # exhook_sidecar: OnMessagePublish burst ...
EXHOOK_INFLIGHT = 256        # ... calls in flight
EXHOOK_CHUNK = 1024          # InstallSnapshot chunk (the manager's)
EXHOOK_CHURN = 1000          # exhook_sidecar: ApplyDeltas adds and removes
EXHOOK_NODE_CLIENTS = 100    # exhook_node: MQTT clients ...
EXHOOK_NODE_FILTERS = 100    # ... with this many filters each
EXHOOK_NODE_CHURN = 100      # exhook_node: subscribes and unsubscribes
EXHOOK_NODE_STORM = 3        # exhook_node: QoS 1 publishes, in BATCHes
EXHOOK_FILTERS = 250_000     # exhook_sidecar: the shared workload's first
CHECKPOINT_FILTERS = 50_000  # exhook_checkpoint: the Python table's size
EXHOOK_WAIT_S = 900.0        # the longest wait for a mirror to sync
EXHOOK_DIR = os.path.join("trace", "chip_smoke_exhook")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sidecar_proc(conn, spec: Dict) -> None:
    """The sidecar's child process: obey (command, args) messages until
    ``exit``; answer each with ("ok", result) or ("error", text)."""
    asyncio.run(_sidecar_loop(conn, spec))


def _sidecar_counters(sc) -> Dict:
    from emqx_tpu_torch.ops import walk_kernel

    eng = sc._eng
    ready = sc._engine is not None
    return {
        "launches": walk_kernel.launches,
        "join_launches": walk_kernel.join_launches,
        "flat_launches": walk_kernel.flat_launches,
        "device_batches": sc.device_batches, "warms": sc.warms,
        "host_rows": sc.host_rows, "not_ready_rows": sc.not_ready_rows,
        "aid_reuse_rows": sc.aid_reuse_rows,
        "queue_timeouts": sc.queue_timeouts,
        "spill_fallbacks": sc.spill_fallbacks,
        "sync_failures": sc.sync_failures,
        "sync_error": repr(sc.sync_error) if sc.sync_error else None,
        "syncs": sc.syncs, "batches": sc.batches,
        "topics_matched": sc.topics_matched,
        "uploads": eng.dev.uploads, "delta_applies": eng.dev.delta_applies,
        "synced": (ready and not sc._dirty.is_set()
                   and eng.dev.epoch == eng.inc.epoch),
        "filters": len(sc._ref), "table_filters": eng.inc.n_filters,
        "aliases": len(eng.deep_aid), "states": eng.inc.n_states,
        "shape_key": list(eng.inc.shape_key()),
        "table_bytes": eng.dev.table_bytes if ready else 0,
        "batch_ms": sorted(sc._lat_ms),
    }


async def _sidecar_loop(conn, spec: Dict) -> None:
    from emqx_tpu_torch.exhook.server import TpuMatchSidecar, serve

    loop = asyncio.get_running_loop()
    conn.send(("ok", {"pid": os.getpid()}))
    server = sc = None
    while True:
        cmd, args = await loop.run_in_executor(None, conn.recv)
        try:
            if cmd == "exit":
                if sc is not None:
                    await sc.stop()
                if server is not None:
                    await server.stop(None)
                conn.send(("ok", {}))
                return
            if cmd == "serve":
                t0 = time.perf_counter()
                server, sc = await serve(
                    port=spec["port"], sidecar=TpuMatchSidecar(**spec["kw"]))
                out = {"serve_s": time.perf_counter() - t0,
                       "ready": sc._engine is not None}
            elif cmd == "counters":
                out = _sidecar_counters(sc)
            else:
                raise ValueError(f"unknown command {cmd!r}")
            conn.send(("ok", out))
        except Exception as e:  # noqa: BLE001 - reported to the parent
            conn.send(("error", f"{cmd}: {type(e).__name__}: {e}"))


class _SidecarProc:
    """One sidecar child process (``serve()`` on ``port``, the sidecar
    built with ``kw``), and the commands to it."""

    def __init__(self, port: int, device, **kw) -> None:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.port = port
        kw["device"] = str(device)
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_sidecar_proc,
                                args=(child, {"port": port, "kw": kw}),
                                daemon=True)
        self.proc.start()
        child.close()

    async def call(self, cmd: str, *args):
        self.conn.send((cmd, args))
        status, out = await asyncio.to_thread(self.conn.recv)
        _check(status == "ok", f"sidecar process: {out}")
        return out

    async def ready(self) -> int:
        status, out = await asyncio.to_thread(self.conn.recv)
        _check(status == "ok", f"sidecar process: {out}")
        return out["pid"]

    async def synced(self, timeout: float = EXHOOK_WAIT_S) -> Dict:
        """Poll until the mirror serves and holds every mutation; the
        counters then.  Fails on a failed sync."""
        t0 = time.perf_counter()
        while True:
            c = await self.call("counters")
            _check(c["sync_failures"] == 0,
                   f"the sidecar's mirror sync failed: {c['sync_error']}")
            if c["synced"]:
                return c
            _check(time.perf_counter() - t0 < timeout,
                   f"the sidecar did not sync in {timeout} s")
            await asyncio.sleep(0.02)

    def close(self) -> None:
        try:
            self.conn.send(("exit", ()))
            if self.conn.poll(60):
                self.conn.recv()
        except (OSError, EOFError):
            pass
        self.proc.join(30)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(5)
        self.conn.close()


def _exhook_stubs(port: int):
    """(channel, HookProvider stub, MirrorSync stub) to the sidecar on
    ``port``: the channel takes messages of any size (a 1M-filter
    FilterTable is tens of MB)."""
    import grpc.aio

    from emqx_tpu_torch.exhook.rpc import HookProviderStub, MirrorSyncStub

    chan = grpc.aio.insecure_channel(
        f"127.0.0.1:{port}",
        options=[("grpc.max_receive_message_length", -1),
                 ("grpc.max_send_message_length", -1)])
    return chan, HookProviderStub(chan), MirrorSyncStub(chan)


async def _install(mirror, filters: List[str], epoch: int = 1):
    """InstallSnapshot of ``filters`` (refcount 1 each) in chunks of
    ``EXHOOK_CHUNK``, as the manager sends them; returns the ack."""
    from emqx_tpu_torch.exhook.rpc import pb

    items = sorted(filters)

    async def chunks():
        for i in range(0, len(items), EXHOOK_CHUNK):
            part = items[i:i + EXHOOK_CHUNK]
            yield pb.SnapshotChunk(epoch=epoch, filters=part,
                                   refcounts=[1] * len(part),
                                   last=i + EXHOOK_CHUNK >= len(items))

    return await mirror.InstallSnapshot(chunks())


async def _match_checked(mirror, topics: List[str], trie, table=None):
    """One MatchBatch of ``topics``: ``(rows as filters, the RPC's ms,
    mismatches against the trie oracle)``; ``table`` is the FilterTable
    to resolve ids through (fetched when None)."""
    from emqx_tpu_torch.exhook.rpc import pb

    t0 = time.perf_counter()
    resp = await mirror.MatchBatch(pb.MatchBatchRequest(topics=topics))
    ms = (time.perf_counter() - t0) * 1e3
    if table is None:
        table = list((await mirror.FilterTable(
            pb.FilterTableRequest())).filters)
    rows = [sorted(table[i] for i in r.filter_ids) for r in resp.results]
    bad = sum(row != sorted(trie.match(t)) for t, row in zip(topics, rows))
    return rows, ms, bad


def _probe_topics(filters: List[str]) -> List[str]:
    """A concrete topic each of ``filters`` matches (``+`` → ``p``,
    ``#`` → ``p/q``)."""
    return ["/".join("p/q" if w == "#" else "p" if w == "+" else w
                     for w in f.split("/")) for f in filters]


def _launch_check(c: Dict, what: str) -> None:
    _check(c["launches"] == c["device_batches"] + c["warms"],
           f"{what}: walk launches {c['launches']} != device batches "
           f"{c['device_batches']} + warm-ups {c['warms']}")
    _check(c["join_launches"] == 0, f"{what}: the join kernel ran")
    _check(c["flat_launches"] == c["launches"] + c["join_launches"],
           f"{what}: flat epilogue launches {c['flat_launches']} != flat "
           f"walk launches {c['launches']} + {c['join_launches']}")


def phase_exhook_sidecar(torch, device, shared, card: str) -> Dict:
    return asyncio.run(_exhook_sidecar(torch, device, shared, card))


async def _exhook_sidecar(torch, device, shared, card: str) -> Dict:
    """The first ``EXHOOK_FILTERS`` of BASELINE config 2's 1M filters
    through the sidecar at its defaults (depth 8, A = 16, K = ``tpu.max_matches``): the snapshot
    install, MatchBatch calls, an OnMessagePublish burst and an
    ApplyDeltas churn, every answer against the trie oracle."""
    from emqx_tpu_torch.exhook.rpc import pb

    from emqx_tpu_torch.broker.trie import FilterTrie

    t_start = time.perf_counter()
    # the first EXHOOK_FILTERS of the shared workload (the install of
    # the sidecar's Python table is the phase's cost), with their oracle
    filters, topics = shared["filters"][:EXHOOK_FILTERS], shared["topics"]
    trie = FilterTrie()
    for f in filters:
        trie.insert(f)
    oracle_s = time.perf_counter() - t_start
    proc = _SidecarProc(_free_port(), device, annotate=True)
    chan = None
    try:
        await proc.ready()
        await proc.call("serve")
        chan, hooks, mirror = _exhook_stubs(proc.port)
        await hooks.OnProviderLoaded(pb.ProviderLoadedRequest(
            meta=pb.RequestMeta(node="chip_smoke")))
        t0 = time.perf_counter()
        ack = await _install(mirror, filters)
        ack_s = time.perf_counter() - t0
        _check(ack.n_filters == len(filters),
               f"snapshot ack {ack.n_filters} != {len(filters)} filters")
        c_ready = await proc.synced()
        ready_s = time.perf_counter() - t0
        table = list((await mirror.FilterTable(
            pb.FilterTableRequest())).filters)
        line = {"phase": "exhook_sidecar", "ok": True, "card": card,
                "filters": len(filters), "oracle_build_s": oracle_s,
                "snapshot_ack_s": ack_s,
                "snapshot_to_ready_s": ready_s,
                "aliases": c_ready["aliases"], "states": c_ready["states"],
                "table_filters": c_ready["table_filters"],
                "table_bytes": c_ready["table_bytes"],
                "shape_key": c_ready["shape_key"]}
        failed = []
        # -- MatchBatch: EXHOOK_MATCH_CALLS calls of BATCH topics ---------
        rpc_ms, bad = [], 0
        replies = []
        for i in range(EXHOOK_MATCH_CALLS):
            batch = topics[(i * BATCH) % len(topics):][:BATCH]
            t1 = time.perf_counter()
            replies.append((batch, await mirror.MatchBatch(
                pb.MatchBatchRequest(topics=batch))))
            rpc_ms.append((time.perf_counter() - t1) * 1e3)
        for batch, resp in replies:
            bad += sum(sorted(table[a] for a in r.filter_ids)
                       != sorted(trie.match(t))
                       for t, r in zip(batch, resp.results))
        replies = None
        st = await mirror.Stats(pb.StatsRequest())
        c1 = await proc.call("counters")
        line["match_batch"] = {
            "calls": EXHOOK_MATCH_CALLS, "topics": EXHOOK_MATCH_CALLS * BATCH,
            "topics_per_s": EXHOOK_MATCH_CALLS * BATCH / (sum(rpc_ms) / 1e3),
            "rpc_ms": {"p50": _pct(rpc_ms, 50), "p99": _pct(rpc_ms, 99)},
            "sidecar_batch_ms": {"p50": st.p50_batch_ms,
                                 "p99": st.p99_batch_ms},
            "mismatches": bad,
            "spill_reruns": c1["spill_fallbacks"] - c_ready["spill_fallbacks"],
            "host_rows": c1["host_rows"]}
        if bad:
            failed.append(f"MatchBatch: {bad} rows differ from the oracle")
        # -- OnMessagePublish: a burst at EXHOOK_INFLIGHT in flight -------
        sem = asyncio.Semaphore(EXHOOK_INFLIGHT)
        pub_topics = [topics[i % len(topics)]
                      for i in range(EXHOOK_PUBLISHES)]

        async def publish(t):
            async with sem:
                resp = await hooks.OnMessagePublish(pb.MessagePublishRequest(
                    message=pb.Message(topic=t, payload=b"x")))
            return int(resp.message.headers["matched_filters"])

        t1 = time.perf_counter()
        counts = await asyncio.gather(*(publish(t) for t in pub_topics))
        pub_s = time.perf_counter() - t1
        c2 = await proc.call("counters")
        pub_bad = sum(n != len(trie.match(t))
                      for t, n in zip(pub_topics, counts))
        line["publish_burst"] = {
            "calls": EXHOOK_PUBLISHES, "in_flight": EXHOOK_INFLIGHT,
            "calls_per_s": EXHOOK_PUBLISHES / pub_s,
            "micro_batches": c2["batches"] - c1["batches"],
            "mean_micro_batch": ((c2["topics_matched"] - c1["topics_matched"])
                                 / max(1, c2["batches"] - c1["batches"])),
            "mismatches": pub_bad}
        if pub_bad:
            failed.append(f"OnMessagePublish: {pub_bad} counts differ")
        # -- ApplyDeltas: EXHOOK_CHURN removes, then as many adds ---------
        rng = np.random.default_rng(3)
        gone = [filters[i] for i in rng.choice(len(filters), EXHOOK_CHURN,
                                               replace=False)]
        fresh = _fresh_filters(set(filters), EXHOOK_CHURN, 33)
        req = pb.DeltaBatch(from_epoch=1, to_epoch=2)
        for f in gone:
            req.deltas.add(op=pb.DeltaBatch.Delta.DEL, filter=f)
        for f in fresh:
            req.deltas.add(op=pb.DeltaBatch.Delta.ADD, filter=f)
        for f in gone:
            trie.delete(f)
        for f in fresh:
            trie.insert(f)
        probes = (_probe_topics(fresh[:BATCH // 4])
                  + _probe_topics(gone[:BATCH // 4]))
        probes += topics[:BATCH - len(probes)]
        t1 = time.perf_counter()
        await mirror.ApplyDeltas(req)
        c3 = await proc.synced()
        _rows, _ms, churn_bad = await _match_checked(mirror, probes, trie)
        churn_s = time.perf_counter() - t1
        grew = c3["shape_key"] != c_ready["shape_key"]
        line["apply_deltas"] = {
            "removed": len(gone), "added": len(fresh),
            "seconds_to_answer": churn_s, "mismatches": churn_bad,
            "uploads": [c_ready["uploads"], c3["uploads"]],
            "delta_applies": c3["delta_applies"] - c_ready["delta_applies"],
            "grew_table": grew}
        if churn_bad:
            failed.append(f"after ApplyDeltas: {churn_bad} rows differ")
        if not grew and c3["uploads"] != c_ready["uploads"]:
            failed.append("ApplyDeltas re-uploaded the table without growth")
        c = await proc.call("counters")
        line["sidecar"] = {k: c[k] for k in (
            "launches", "join_launches", "flat_launches", "device_batches",
            "warms", "host_rows", "not_ready_rows", "aid_reuse_rows",
            "queue_timeouts", "spill_fallbacks", "sync_failures", "syncs",
            "batches", "topics_matched", "uploads", "delta_applies")}
        if c["host_rows"]:
            failed.append(f"{c['host_rows']} rows served by the host "
                          "beside spills")
        if c["queue_timeouts"]:
            failed.append(f"{c['queue_timeouts']} publishes timed out "
                          "waiting for their micro-batch")
        if device.type == "cuda":
            _launch_check(c, "exhook_sidecar")
        line["wall_s"] = time.perf_counter() - t_start
        _emit_checked(line, failed)
        FLAT_LAUNCHES["exhook_sidecar"] = c["flat_launches"]
        return {"launches": c["launches"], "join_launches": c["join_launches"]}
    finally:
        if chan is not None:
            await chan.close()
        proc.close()


def phase_exhook_node(torch, device, card: str) -> Dict:
    return asyncio.run(_exhook_node(torch, device, card))


def _node_filters(broker) -> Dict[str, int]:
    """The routing filters of the broker's sessions ($share stripped),
    with their counts: what the manager's snapshot sends."""
    from emqx_tpu_torch import topic as T

    ref: Dict[str, int] = {}
    for sess in broker.sessions.values():
        for flt in sess.subscriptions:
            share = T.parse_share(flt)
            f = share[1] if share is not None else flt
            ref[f] = ref.get(f, 0) + 1
    return ref


async def _mirror_filters(mirror) -> set:
    from emqx_tpu_torch.exhook.rpc import pb

    ft = await mirror.FilterTable(pb.FilterTableRequest())
    return {f for f in ft.filters if f}


async def _mirror_equal(proc, mirror, broker, what: str) -> float:
    """Wait until the sidecar's mirror holds exactly the node's filters
    and is synced; returns the seconds it took."""
    t0 = time.perf_counter()
    while True:
        want = set(_node_filters(broker))
        if await _mirror_filters(mirror) == want:
            c = await proc.call("counters")
            if c["synced"]:
                return time.perf_counter() - t0
        _check(time.perf_counter() - t0 < 120,
               f"{what}: the mirror never equalled the node's filters")
        await asyncio.sleep(0.05)


async def _exhook_node(torch, device, card: str) -> Dict:
    """The deployment's path end to end: the port's BrokerNode with its
    match service off and ``exhook.servers`` naming a sidecar that
    starts after the node; MQTT clients subscribe, the reconnect loop
    loads the sidecar and pushes the snapshot, subscribes and
    unsubscribes follow through the hooks, and QoS 1 publishes each ride
    an OnMessagePublish round trip."""
    from emqx_tpu_torch.config import Config
    from emqx_tpu_torch.node import BrokerNode
    from emqx_tpu_torch.workload import build_workload

    t_start = time.perf_counter()
    n = EXHOOK_NODE_CLIENTS * EXHOOK_NODE_FILTERS
    filters, topics = build_workload(np.random.default_rng(0), n,
                                     EXHOOK_NODE_STORM * BATCH)
    held = set(filters)
    start = _fresh_filters(held, EXHOOK_NODE_CHURN, 51)
    held.update(start)
    add = _fresh_filters(held, EXHOOK_NODE_CHURN, 52)
    churn_ids = [f"churn{k}" for k in range(10)]
    per = -(-len(start) // len(churn_ids))
    churn = [(cid, start[k * per:(k + 1) * per])
             for k, cid in enumerate(churn_ids)]
    specs = _fleet_specs(filters, topics, EXHOOK_NODE_CLIENTS, 1, churn)
    fleet = _FleetProcs(specs)
    fleet.client_idx = {f"dev{k}": k for k in range(EXHOOK_NODE_CLIENTS)}
    port = _free_port()
    cfg = Config(env={})
    cfg.put("listeners.tcp.default.bind", "127.0.0.1:0")
    cfg.put("tpu.enable", False)      # the sidecar is the card's only user
    cfg.put("exhook.servers", f"tpu=127.0.0.1:{port}")
    node = BrokerNode(cfg, device=device)
    # the sidecar's process starts (imports) now and serves only later
    proc = _SidecarProc(port, device)
    chan = None
    try:
        await fleet.ready()
        await proc.ready()
        await node.start()
        mgr = node.exhook
        _check(mgr is not None and mgr.servers[0].stub is None,
               "the exhook server loaded before the sidecar started")
        await fleet.all("connect", node.listeners.all()[0].port)
        t0 = time.perf_counter()
        await proc.call("serve")
        chan, _hooks, mirror = _exhook_stubs(port)
        while mgr.servers[0].stub is None:
            _check(time.perf_counter() - t0 < 60,
                   "the reconnect loop never loaded the sidecar")
            await asyncio.sleep(0.02)
        loaded_s = time.perf_counter() - t0
        snapshot_s = await _mirror_equal(proc, mirror, node.broker,
                                         "after the snapshot")
        mirror_n = len(await _mirror_filters(mirror))
        drops = [(cid, f) for cid, flts in churn for f in flts]
        adds = [(churn_ids[i % len(churn_ids)], f)
                for i, f in enumerate(add)]
        t1 = time.perf_counter()
        await fleet.all("churn_start", adds, drops, NODE_CHURN_RATE,
                        only=[len(fleet.conns) - 1])
        await asyncio.sleep(EXHOOK_NODE_CHURN / NODE_CHURN_RATE + 0.5)
        churned = (await fleet.all("churn_stop",
                                   only=[len(fleet.conns) - 1]))[0]
        churn_s = time.perf_counter() - t1
        _check(churned["subscribed"] == churned["unsubscribed"]
               == EXHOOK_NODE_CHURN, f"the churn sent {churned}")
        follow_s = await _mirror_equal(proc, mirror, node.broker,
                                       "after the churn")
        c0 = await proc.call("counters")
        storm = await _mqtt_storm(fleet, node, topics, 0,
                                  EXHOOK_NODE_STORM * BATCH, card)
        failed = _storm_checks(storm, False, False)
        c = await proc.call("counters")
        matched = c["topics_matched"] - c0["topics_matched"]
        if matched < storm["publishes"]:
            failed.append(f"the sidecar matched {matched} topics for "
                          f"{storm['publishes']} publishes")
        if c["host_rows"]:
            failed.append(f"{c['host_rows']} rows served by the host "
                          "beside spills")
        if device.type == "cuda":
            _launch_check(c, "exhook_node")
        st = mgr.stats()[0]
        line = {"phase": "exhook_node", "ok": True, "card": card,
                "clients": EXHOOK_NODE_CLIENTS,
                "filters": len(_node_filters(node.broker)),
                "mirror_filters_after_snapshot": mirror_n,
                "sidecar_serve_to_loaded_s": loaded_s,
                "loaded_to_mirror_equal_s": snapshot_s,
                "churn": churned, "churn_s": churn_s,
                "churn_to_mirror_equal_s": follow_s,
                "publishes": storm["publishes"],
                "puback_publishes_per_s": storm["publishes_per_s"],
                "puback_ms": storm["puback_ms"],
                "delivered_ms": storm["delivered_ms"],
                "checked": storm["checked"], "missing": storm["missing"],
                "duplicate": storm["duplicate"], "extra": storm["extra"],
                "queue_full": storm["queue_full"],
                "sidecar_topics_matched": matched,
                "sidecar_micro_batches": c["batches"] - c0["batches"],
                "exhook": {k: st[k] for k in ("hooks", "ok", "failed",
                                              "dropped")},
                "sidecar": {k: c[k] for k in (
                    "launches", "join_launches", "flat_launches",
                    "device_batches", "warms", "host_rows",
                    "spill_fallbacks", "sync_failures", "syncs", "uploads",
                    "delta_applies")},
                "broker_cpu_s": storm["broker_cpu_s"]}
        if st["failed"] or st["dropped"]:
            failed.append(f"exhook calls failed {st['failed']}, "
                          f"dropped {st['dropped']}")
        await fleet.all("disconnect")
        line["wall_s"] = time.perf_counter() - t_start
        _emit_checked(line, failed)
        FLAT_LAUNCHES["exhook_node"] = c["flat_launches"]
        return {"launches": c["launches"], "join_launches": c["join_launches"]}
    finally:
        if chan is not None:
            await chan.close()
        await node.stop()
        proc.close()
        fleet.close()


async def _checkpoint_steps(procs, filters, topics, trie, path, device,
                            line, failed, launches) -> None:
    """exhook_checkpoint's two steps: the first process installs the
    filters and writes the checkpoint, the second restores it."""
    for step, proc in zip(("install", "restore"), procs):
        chan = None
        try:
            await proc.ready()
            t0 = time.perf_counter()
            served = await proc.call("serve")
            chan, _hooks, mirror = _exhook_stubs(proc.port)
            if step == "install":
                await _install(mirror, filters)
            c = await proc.synced()
            _rows, ms, bad = await _match_checked(mirror, topics, trie)
            first_s = time.perf_counter() - t0
            c = await proc.call("counters")
            if step == "install":
                while not os.path.exists(path):
                    _check(time.perf_counter() - t0 < EXHOOK_WAIT_S,
                           "the sidecar wrote no checkpoint")
                    await asyncio.sleep(0.05)
            line[step] = {"to_first_device_match_s": first_s,
                          "serve_s": served["serve_s"],
                          "ready_at_serve": served["ready"],
                          "match_ms": ms, "mismatches": bad,
                          "device_batches": c["device_batches"],
                          "not_ready_rows": c["not_ready_rows"],
                          "uploads": c["uploads"], "syncs": c["syncs"],
                          "launches": c["launches"]}
            if bad:
                failed.append(f"{step}: {bad} rows differ from the oracle")
            if c["host_rows"] or c["device_batches"] != 1:
                failed.append(f"{step}: the first MatchBatch was not served "
                              f"by the card ({c['host_rows']} host rows, "
                              f"{c['device_batches']} device batches)")
            if device.type == "cuda":
                _launch_check(c, f"exhook_checkpoint {step}")
            launches[0] += c["launches"]
            launches[1] += c["join_launches"]
            FLAT_LAUNCHES[f"exhook_checkpoint.{step}"] = c["flat_launches"]
        finally:
            if chan is not None:
                await chan.close()
            proc.close()


def phase_exhook_checkpoint(torch, device, card: str,
                            n_filters: int = PYTHON_FILTERS) -> Dict:
    return asyncio.run(_exhook_checkpoint(torch, device, card, n_filters))


async def _exhook_checkpoint(torch, device, card: str,
                             n_filters: int) -> Dict:
    """A sidecar with ``checkpoint_path`` installs ``n_filters`` workload
    filters (the Python table's size) and writes its checkpoint; a new
    sidecar process restores it at start.  The seconds from the install,
    and from the restoring start, to the first MatchBatch served by the
    card."""
    from emqx_tpu_torch.broker.trie import FilterTrie
    from emqx_tpu_torch.workload import build_workload

    t_start = time.perf_counter()
    filters, topics = build_workload(np.random.default_rng(0), n_filters,
                                     BATCH)
    trie = FilterTrie()
    for f in filters:
        trie.insert(f)
    os.makedirs(os.path.join(ROOT, EXHOOK_DIR), exist_ok=True)
    path = os.path.join(ROOT, EXHOOK_DIR, "sidecar.npz")
    if os.path.exists(path):
        os.remove(path)
    line = {"phase": "exhook_checkpoint", "ok": True, "card": card,
            "filters": len(filters)}
    failed = []
    launches = [0, 0]
    # both processes start (import) now; each serves in its turn
    procs = [_SidecarProc(_free_port(), device, checkpoint_path=path)
             for _ in range(2)]
    try:
        await _checkpoint_steps(procs, filters, topics, trie, path, device,
                                line, failed, launches)
    finally:
        for proc in procs:
            proc.close()
    line["checkpoint_bytes"] = os.path.getsize(path)
    line["restore_over_install"] = (
        line["restore"]["to_first_device_match_s"]
        / line["install"]["to_first_device_match_s"])
    if not line["restore"]["ready_at_serve"]:
        failed.append("the restoring sidecar was not serving at start")
    line["wall_s"] = time.perf_counter() - t_start
    _emit_checked(line, failed)
    return {"launches": launches[0], "join_launches": launches[1]}


def _pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs), q))


def _io_bytes(depth: int, A: int) -> int:
    """Row I/O of one 2048-row walk: words, lens, is_sys in; acc, aover
    out."""
    from emqx_tpu_torch.ops.walk_kernel import accept_cols

    return (BATCH * depth * 4 + BATCH * 4 + BATCH
            + BATCH * accept_cols(depth, A) * 4 + BATCH * 4)


def _walk_bytes(traffic: Dict[str, int], depth: int, A: int) -> int:
    """Bytes the hash walk must move on one 2048-row batch: the table
    rows its valid slots gather (16 B node row, 32 B bucket row), the
    two seeds and the row I/O."""
    return (traffic["node_rows"] * 16 + traffic["bucket_rows"] * 32 + 8
            + _io_bytes(depth, A))


def _join_bytes(traffic: Dict[str, int], depth: int, A: int) -> int:
    """Bytes the join walk must move on one 2048-row batch: per valid
    slot and step a 16 B node row; per lookup an 8 B CSR bound pair,
    4 B per ``edge_word`` probe and 4 B of ``edge_next`` on a hit; the
    3 KB overlay once; and the row I/O."""
    from emqx_tpu_torch.ops.walk_kernel import OVERLAY_CAP

    return (traffic["node_rows"] * 16 + traffic["csr_pairs"] * 8
            + traffic["word_probes"] * 4 + traffic["next_reads"] * 4
            + OVERLAY_CAP * 12 + _io_bytes(depth, A))


def _flat_bound(walk_bytes: float, B: int, C: int,
                cap: int) -> Dict[str, object]:
    """The least time of one flat match (the walk with K3 fused): the
    walk's own bytes less the raw accept plane it no longer writes (B·C
    ints), plus the flat outputs written once (the buffer and three ints
    a row; the spills are the walk's), over 3.35 TB/s; ``k3_bound_ms``
    is those flat outputs alone, what K3 adds to the walk's bound."""
    flat_out = 4 * (cap + 3 * B)
    nbytes = walk_bytes - 4 * B * C + flat_out
    return {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bound_bytes": nbytes,
            "k3_bound_ms": flat_out / HBM_BYTES_PER_S * 1e3}


def _time_flat(torch, device, batches, backend: str, A: int, K: int,
               cap: int, depth: int, flush) -> Dict:
    """The flat match (one launch of the walk's flat kernel, K3 fused) on
    the distinct served ``batches`` at the serve shape (K, ``cap``):
    equal to the plain walk and ``flat_epilogue_plain`` bit for bit on
    each, then its device ms as the walks are timed (rotating, L2
    flushed, one batch repeated) with the raw walk in turns on the same
    batches (flat, raw, raw, flat: K3's own cost is the difference of
    their means), the plain version (the plain walk and the torch-ops
    epilogue; the epilogue alone beside) from a CUDA graph replay, and
    its bound on this run's data."""
    from emqx_tpu_torch.ops import join_match, nfa_match
    from emqx_tpu_torch.ops.match_kernel import flat_epilogue_plain
    from emqx_tpu_torch.ops.walk_kernel import (
        accept_cols, join_walk, join_walk_plain, nfa_walk, nfa_walk_plain)

    if backend == "hash":
        walk, plain, match, nbytes_of = (nfa_walk, nfa_walk_plain, nfa_match,
                                         _walk_bytes)
    else:
        walk, plain, match, nbytes_of = (join_walk, join_walk_plain,
                                         join_match, _join_bytes)
    time_ms = timer(torch, device)
    err, walks, nbytes, ids = 0, [], [], []
    for args in batches:
        traffic: Dict[str, int] = {}
        acc, aover = plain(*args, active_slots=A, traffic=traffic)
        got = match(*args, active_slots=A, max_matches=K, flat_cap=cap)
        err = max(err, _flat_err(got, _flat_epilogue(acc, aover, K, cap)))
        walks.append((acc, aover))
        nbytes.append(nbytes_of(traffic, depth, A))
        ids.append(int(torch.clamp((acc >= 0).sum(1), max=K).sum()))
    _check(err == 0, f"the flat {backend} match != plain on the served "
           f"batches (max |diff| {err})")
    n = len(batches)
    turn = [0]

    def flat():
        turn[0] += 1
        match(*batches[turn[0] % n], active_slots=A, max_matches=K,
              flat_cap=cap)

    def raw():
        turn[0] += 1
        walk(*batches[turn[0] % n], active_slots=A)

    card = device.type == "cuda"
    warm = time_ms(lambda: match(*batches[0], active_slots=A, max_matches=K,
                                 flat_cap=cap), 200)
    turns = [time_ms(fn, 20 * n) for fn in (flat, raw, raw, flat)]
    cold = time_ms(flat, 4 * n, before=flush)
    flat_ms = (turns[0]["ms"] + turns[3]["ms"]) / 2
    raw_ms = (turns[1]["ms"] + turns[2]["ms"]) / 2

    def plain_call():
        _flat_epilogue(*plain(*batches[0], active_slots=A), K, cap)

    def plain_epilogue():
        flat_epilogue_plain(*walks[0], K, cap)

    graph = graph_replay if card else (lambda _torch, fn: fn)
    pt = time_ms(graph(torch, plain_call), 20)
    pe = time_ms(graph(torch, plain_epilogue), 20)
    _check(not card or all(x["covered"] for x in (warm, cold, *turns)),
           "a flat match time was not covered by the sleep")
    B = int(walks[0][0].shape[0])
    C = accept_cols(depth, A)
    return {"B": B, "C": C, "K": K, "flat_cap": cap, "distinct_batches": n,
            "ms": flat_ms, "ms_cold": cold["ms"], "ms_warm": warm["ms"],
            "call_ms": warm["call_ms"], "raw_walk_ms": raw_ms,
            "k3_ms": flat_ms - raw_ms,
            "turns_ms": [t["ms"] for t in turns],
            "turns": "flat, raw, raw, flat",
            "plain_ms": pt["ms"], "plain_epilogue_ms": pe["ms"],
            "plain_covered": pt["covered"] and pe["covered"],
            "plain_timing": "cuda graph replay" if card else "host loop",
            "ids_per_batch": float(np.mean(ids)),
            **_flat_bound(float(np.mean(nbytes)), B, C, cap),
            "max_abs_err": err}


def phase_times(torch, device, s: Dict, card: str, backend: str = "hash",
                name: str = "", timed: int = TIMED_BATCHES) -> List[Dict]:
    """Kernel and serve readings of the service ``s["svc"]`` on
    ``backend``; emits line ``name`` (``times`` / ``times_join`` by
    default)."""
    from emqx_tpu_torch.ops.walk_kernel import (
        join_walk, join_walk_plain, nfa_walk, nfa_walk_plain)

    t_start = time.perf_counter()
    svc, topics = s["svc"], s["topics"]
    _check(svc.backend == backend, f"the service serves {svc.backend}")
    time_ms = timer(torch, device)
    node, edge, seeds = svc.dev.arrays()
    if backend == "hash":
        walk, plain, nbytes_of = nfa_walk, nfa_walk_plain, _walk_bytes
        tables = (node, edge, seeds)
    else:
        walk, plain, nbytes_of = join_walk, join_walk_plain, _join_bytes
        tables = (node, *svc.dev._jarrs)
    A = svc.dev.active_slots
    K, cap = svc.dev.max_matches, svc.FLAT_MULT * BATCH

    def flat_readings(batches, depth):
        return _time_flat(torch, device, batches, backend, A, K, cap, depth,
                          flush)
    long_t = [t for t in topics if t.count("/") >= svc.short_depth]
    short_t = [t for t in topics if t.count("/") < svc.short_depth]
    # more than twice the card's 50 MB L2: writing it evicts the tables
    flush = (torch.empty(64 << 20, dtype=torch.int32, device=device).zero_
             if device.type == "cuda" else None)
    shapes = []
    for depth, pool in ((svc.depth, long_t), (svc.short_depth, short_t)):
        # the distinct batches of this depth group among the served topics:
        # the serve path walks a new batch each call
        n_dist = len(pool) // BATCH
        _check(n_dist >= 2, f"fewer than 2 distinct batches at D={depth}")
        batches, nbytes, traffics = [], [], []
        for i in range(n_dist):
            w, ln, sy = _encoded(torch, svc.inc, pool[i * BATCH:], depth,
                                 BATCH, device)
            args = (w, ln, sy, *tables)
            traffic: Dict[str, int] = {}
            acc_p, aover_p = plain(*args, active_slots=A, traffic=traffic)
            acc, aover = walk(*args, active_slots=A)
            # the main path's own shapes and 1M-filter table: exact
            err = max(int((acc.long() - acc_p.long()).abs().max()),
                      int((aover.long() - aover_p.long()).abs().max()))
            _check(err == 0,
                   f"{walk.__name__} != plain on the served table at "
                   f"D={depth}, batch {i}")
            batches.append(args)
            traffics.append(traffic)
            nbytes.append(nbytes_of(traffic, depth, A))
        turn = [0]

        def rotate():
            turn[0] += 1
            walk(*batches[turn[0] % n_dist], active_slots=A)

        warm = time_ms(lambda: walk(*batches[0], active_slots=A), 200)
        rot = time_ms(rotate, 20 * n_dist)
        cold = time_ms(rotate, 4 * n_dist, before=flush)

        def plain_call():
            plain(*batches[0], active_slots=A)

        pt = time_ms(plain_call, 2)
        plain_timing = "host loop"
        if device.type == "cuda":
            # over a thousand small launches per call at D=16, more than
            # the driver queues ahead of a sleep: replayed from a CUDA
            # graph instead, so the host's launch rate stays out of it
            call_ms = pt["call_ms"]
            pt = time_ms(graph_replay(torch, plain_call), 20)
            pt["call_ms"] = call_ms
            plain_timing = "cuda graph replay"
        _check(device.type != "cuda" or all(
            x["covered"] for x in (warm, rot, cold)),
            "a kernel time was not covered by the sleep")
        shapes.append({
            "B": BATCH, "D": depth, "A": A, "distinct_batches": n_dist,
            "ms": rot["ms"], "ms_cold": cold["ms"], "ms_warm": warm["ms"],
            "call_ms": warm["call_ms"], "plain_ms": pt["ms"],
            "plain_call_ms": pt["call_ms"], "plain_covered": pt["covered"],
            "plain_timing": plain_timing,
            "bound_ms": float(np.mean(nbytes)) / HBM_BYTES_PER_S * 1e3,
            "bound_bytes": float(np.mean(nbytes)),
            "warm_bound_ms": nbytes[0] / HBM_BYTES_PER_S * 1e3,
            "traffic_mean": {k: float(np.mean([t[k] for t in traffics]))
                             for k in traffics[0]},
            "max_abs_err": 0, "flat": flat_readings(batches, depth)})
    flat_d8 = None
    if backend == "hash" and svc.depth > 8:
        # the exhook sidecar's shape: depth 8 (C = 190) at its defaults
        flat_d8 = flat_readings([
            (*_encoded(torch, svc.inc, long_t[i * BATCH:], 8, BATCH, device),
             *tables) for i in range(min(4, len(long_t) // BATCH))], 8)
    flush = None
    stages = _stage_breakdown(torch, device, svc, topics)
    n_batches = len(topics) // BATCH
    lat, gc_ms = [], []
    with GcPauses() as pauses:
        for i in range(timed):
            lo = (i % n_batches) * BATCH
            g0 = pauses.ms
            t0 = time.perf_counter()
            svc.serve(topics[lo:lo + BATCH])
            lat.append(time.perf_counter() - t0)
            gc_ms.append(pauses.ms - g0)
    busy = {"busy_share": "not measured", "idle_share": "not measured"}
    if device.type == "cuda":
        busy = device_busy(torch, lambda: [
            svc.serve(topics[i * BATCH:(i + 1) * BATCH])
            for i in range(n_batches)])
    emit({"phase": name or ("times" if backend == "hash" else "times_join"),
          "ok": True, "card": card, "backend": backend, "walk": shapes,
          "serve_topics_per_s": len(lat) * BATCH / sum(lat),
          "serve_p50_ms": _pct(lat, 50) * 1e3,
          "serve_p99_ms": _pct(lat, 99) * 1e3, "serve_samples": len(lat),
          "serve_gc": {**pauses.summary(),
                       "p99_ms_less_gc": _pct(
                           [t * 1e3 - g for t, g in zip(lat, gc_ms)], 99)},
          "serve_stage_ms": stages, "serve_device": busy,
          "flat_d8": flat_d8,
          "table_bytes": svc.dev.table_bytes,
          "spill_share": s["spill_share"],
          "wall_s": time.perf_counter() - t_start})
    return shapes, flat_d8


def _stage_breakdown(torch, device, svc, topics) -> Dict[str, float]:
    """Mean ms per 2048-topic batch of each serve stage, over every batch
    of ``topics`` run stage by stage with a device sync after the
    dispatch; with the accept ids the split stage turned into filters
    (``split_ids``, all batches) and its µs per id."""
    acc = {"depth_groups": 0.0, "encode_dispatch": 0.0, "device_wait": 0.0,
           "readback": 0.0, "collect": 0.0, "split": 0.0}
    ids = 0
    n = len(topics) // BATCH
    for i in range(n):
        batch = topics[i * BATCH:(i + 1) * BATCH]
        t0 = time.perf_counter()
        groups = svc._depth_groups(batch)
        t1 = time.perf_counter()
        handles = svc._encode_dispatch(batch, groups)
        t2 = time.perf_counter()
        if device.type == "cuda":
            torch.cuda.synchronize()
        t3 = time.perf_counter()
        results = [svc._readback_rows(res, m, svc.dev.max_matches)
                   for res, m in handles]
        t4 = time.perf_counter()
        rows = svc._collect_rows(batch, groups, results)
        t5 = time.perf_counter()
        [svc._split_row(r) for r in rows]
        t6 = time.perf_counter()
        ids += sum(map(len, rows))
        for k, a, b in (("depth_groups", t0, t1), ("encode_dispatch", t1, t2),
                        ("device_wait", t2, t3), ("readback", t3, t4),
                        ("collect", t4, t5), ("split", t5, t6)):
            acc[k] += (b - a) * 1e3 / n
    acc["split_ids"] = ids
    acc["split_us_per_id"] = acc["split"] * n * 1e3 / max(1, ids)
    return acc


def _registers(name: str, kernel: str = ""):
    """Registers a thread of ``kernel`` (by default the first) in the
    library of kernel source ``name``, from its build's ``ptxas``
    report; None if the report holds no count."""
    from emqx_tpu_torch.ops import cuda_build

    for entry in cuda_build.ptxas_log(name).split("Compiling entry")[1:]:
        mangled = re.match(r"[^']*'([^']+)'", entry)
        if kernel and not (mangled and f"{len(kernel)}{kernel}E"
                           in mangled.group(1)):
            continue
        found = re.search(r"Used (\d+) registers", entry)
        return int(found.group(1)) if found else None
    return None


def _kernel_entry(backend: str, launches: Dict[str, int], max_err: int,
                  shapes: List[Dict], shapes_10m: List[Dict]) -> Dict:
    """One kernel's entry of the kernels line: the 1M main path's
    launches (and every path's), the serve shape's (B=2048, D=16) times
    and bound at 1M and at 10M filters, its launch shape and registers,
    every shape."""
    from emqx_tpu_torch.ops.walk_kernel import launch_shape

    name, source, replaces = KERNELS[backend]
    main_shape = shapes[0]
    threads, lanes = launch_shape(main_shape["A"])
    big = shapes_10m[0]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches["1m"],
        "launches_by_path": launches,
        "threads_per_block": threads, "lanes_per_row": lanes,
        "registers": _registers(name, f"{name}_kernel"),
        "max_abs_err": max(max_err, *(x["max_abs_err"]
                                      for x in shapes + shapes_10m)),
        "ms": main_shape["ms"], "ms_cold": main_shape["ms_cold"],
        "ms_warm": main_shape["ms_warm"],
        "plain_ms": main_shape["plain_ms"],
        "plain_covered": main_shape["plain_covered"],
        "plain_timing": main_shape["plain_timing"],
        "bound_ms": main_shape["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "at_10m": {k: big[k] for k in ("D", "ms", "ms_cold", "ms_warm",
                                       "plain_ms", "bound_ms")},
        "shapes": shapes, "shapes_10m": shapes_10m}


def _dense_entry(launches: Dict[str, int], check: Dict, shape: Dict) -> Dict:
    """The dense walk's entry of the kernels line: its launches on the
    tiered main path (and the fused pair's), the times and bound at the
    tiered matcher's hot shape, ``bench_dense``'s shape beside."""
    name, source, replaces = DENSE_KERNEL
    threads, lanes = _dense_mod().launch_shape(shape["S"])
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches["tiered"],
        "launches_by_path": launches,
        "threads_per_block": threads, "lanes_per_row": lanes,
        "registers": _registers(name),
        "max_abs_err": max(check["max_abs_err"], shape["max_abs_err"]),
        **{k: shape[k] for k in ("ms", "ms_cold", "ms_warm", "plain_ms",
                                 "plain_covered", "plain_timing",
                                 "bound_ms", "bound_by")},
        "library_ms": None, "shape": shape,
        "bench_dense": check["bench_dense"]}


def _flat_entry(max_err: int, groups: Dict[str, List[Dict]],
                flat_d8: Dict) -> Dict:
    """The flat epilogue's entry of the kernels line: K3 fused into the
    flat mode of both walk kernels, its launches (the flat-mode walk
    launches) on the 1M hash serve path and every path's, the flat
    match's times on that path's batches at (B = 2048, D = 16) with the
    raw walk's and K3's own cost beside, its bound, the other shapes of
    ``groups`` (D = 4; the join walk; at 10M) and the sidecar's D = 8."""
    from emqx_tpu_torch.ops.walk_kernel import launch_shape

    name, source, replaces = FLAT_KERNEL
    main = groups["1m_hash"][0]["flat"]
    threads, lanes = launch_shape(16)
    keys = ("C", "ms", "ms_cold", "ms_warm", "raw_walk_ms", "k3_ms",
            "plain_ms", "plain_epilogue_ms", "bound_ms", "k3_bound_ms",
            "ids_per_batch")
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "fused_into": FLAT_FUSED_INTO,
        "launches": FLAT_LAUNCHES["slice"],
        "launches_by_path": dict(FLAT_LAUNCHES),
        "threads_per_block": threads, "rows_per_block": threads // lanes,
        "registers": {"hash": _registers("nfa_walk", "nfa_walk_flat_kernel"),
                      "join": _registers("nfa_join_walk",
                                         "nfa_join_walk_flat_kernel")},
        "max_abs_err": max(max_err, *(x["flat"]["max_abs_err"]
                                      for g in groups.values() for x in g)),
        **{k: main[k] for k in ("ms", "ms_cold", "ms_warm", "raw_walk_ms",
                                "k3_ms", "plain_ms", "plain_epilogue_ms",
                                "plain_covered", "plain_timing", "bound_ms",
                                "bound_by", "k3_bound_ms")},
        "library_ms": None,
        "shape": {k: main[k] for k in ("B", "C", "K", "flat_cap",
                                       "ids_per_batch")},
        "by_shape": {
            f"{tag}_D{x['D']}": {k: x["flat"][k] for k in keys}
            for tag, group in groups.items() for x in group},
        "sidecar_D8": {k: flat_d8[k] for k in keys}}


def _native_build() -> Dict[str, float]:
    """``g++`` of the native table, the encoder and the rule runtime's
    JSON extractor (seconds each; 0.0 when already built)."""
    from emqx_tpu_torch.native import build

    took = {}
    for name in ("nfa", "encoder", "fastjson"):
        t0 = time.perf_counter()
        fresh = not build._lib_path(name).exists()
        build.load_library(name)
        took[name] = time.perf_counter() - t0 if fresh else 0.0
    return took


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--filters", type=int, default=1_000_000)
    ap.add_argument("--python-filters", type=int, default=PYTHON_FILTERS)
    ap.add_argument("--large-filters", type=int, default=LARGE_FILTERS)
    ap.add_argument("--timed-batches", type=int, default=TIMED_BATCHES,
                    help="serve() calls timed at 1M filters (a fifth of "
                    "them at 10M)")
    ap.add_argument("--storm-batches", type=int, default=STORM_BATCHES,
                    help="slice_node: timed publishes, in batches of 2048")
    ap.add_argument("--mqtt-clients", type=int, default=MQTT_CLIENTS,
                    help="slice_mqtt: the fleet's MQTT clients")
    ap.add_argument("--tiered-filters", type=int, default=TIERED_FILTERS,
                    help="tiered: bench_tiered's cold filters")
    ap.add_argument("--replay-size", type=int, default=REPLAY_SIZE,
                    help="retained_replay: retained names and new filters")
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="dry run of the serve phases on the CPU; prints "
                    "no result")
    args = ap.parse_args(argv)

    import torch

    if args.rehearse_cpu:
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    else:
        device = torch.device("cuda", 0)
    from concurrent.futures import ThreadPoolExecutor

    from emqx_tpu_torch.ops import cuda_build

    phase = "device"
    big_gen = None
    try:
        card = "not measured (CPU rehearsal)"
        kind = "cpu"
        max_err = {"hash": 0, "join": 0, "flat": 0}
        dense_check = None
        if device.type == "cuda":
            card = nvidia_smi()
            kind = torch.cuda.get_device_name(0)
            emit({"phase": "device", "ok": True, "nvidia_smi": card,
                  "name": kind, "count": torch.cuda.device_count(),
                  "torch": torch.__version__, "cuda": torch.version.cuda})
            phase = "build"
            t0 = time.perf_counter()
            with ThreadPoolExecutor(1) as pool:   # g++ beside the nvcc's
                native = pool.submit(_native_build)
                took = cuda_build.build()
                native_took = native.result()
            emit({"phase": "build", "ok": True,
                  "seconds": time.perf_counter() - t0, "per_source_s": took,
                  "native_s": native_took,
                  "built": sorted(took) + sorted(native_took),
                  "ptxas": {name: [
                      ln.strip()
                      for ln in cuda_build.ptxas_log(name).splitlines()
                      if "registers" in ln or "spill" in ln]
                      for name in took}})
            phase = "kernel"
            t0 = time.perf_counter()
            max_err = phase_kernel(torch, device)
            emit({"phase": "kernel_wall", "ok": True,
                  "wall_s": time.perf_counter() - t0})
            phase = "dense_kernel"
            dense_check = phase_dense_kernel(torch, device, card)
        launches = {"hash": {}, "join": {}}
        # BASELINE config 3's 10M workload, generated meanwhile
        big_gen = _BackgroundWorkload(args.large_filters,
                                      BATCHES_10M * BATCH)
        phase = "slice"
        # one 1M workload and oracle for slice, slice_join, exhook_sidecar
        t0 = time.perf_counter()
        shared = shared_workload(
            args.filters, SERVE_BATCHES + JOIN_SMALL_BATCHES + AFTER_BATCHES)
        emit({"phase": "shared_workload", "ok": True,
              "filters": len(shared["filters"]),
              "topics": len(shared["topics"]),
              "workload_s": shared["workload_s"],
              "oracle_build_s": shared["oracle_build_s"],
              "wall_s": time.perf_counter() - t0})
        s = phase_slice(torch, device, args.filters, shared=shared)
        phase = "times"
        shapes, flat_d8 = phase_times(torch, device, s, card,
                                      timed=args.timed_batches)
        launches["hash"]["1m"] = s["launches"]
        phase = "multichip"
        mc = mc_kernels = phase_multichip(torch, device, s, shared, card)
        launches["hash"]["multichip"] = mc["launches"]
        launches["join"]["multichip"] = 0
        max_err["hash"] = max(max_err["hash"], mc["max_abs_err"])
        phase = "multichip_fanout"
        fan = phase_multichip_fanout(torch, device, s, shared, card)
        phase = "dryrun_multichip"
        dry = phase_dryrun_multichip(torch, device, card)
        launches["hash"]["multichip_fanout"] = fan["walk_launches"]
        launches["hash"]["dryrun_multichip"] = dry["walk_launches"]
        # one table in host memory at a time
        s = mc = None
        gc.collect()
        phase = "slice_join"
        s = phase_slice_join(torch, device, args.filters, shared=shared)
        phase = "times_join"
        join_shapes, _ = phase_times(torch, device, s, card, backend="join",
                                     timed=args.timed_batches)
        launches["join"]["1m"] = s["launches"]
        s = None
        gc.collect()
        phase = "exhook_sidecar"
        ex = phase_exhook_sidecar(torch, device, shared, card)
        launches["hash"]["exhook_sidecar"] = ex["launches"]
        launches["join"]["exhook_sidecar"] = ex["join_launches"]
        shared = None
        gc.collect()
        phase = "exhook_node"
        ex = phase_exhook_node(torch, device, card)
        launches["hash"]["exhook_node"] = ex["launches"]
        launches["join"]["exhook_node"] = ex["join_launches"]
        phase = "exhook_checkpoint"
        ex = phase_exhook_checkpoint(torch, device, card,
                                     CHECKPOINT_FILTERS)
        launches["hash"]["exhook_checkpoint"] = ex["launches"]
        launches["join"]["exhook_checkpoint"] = ex["join_launches"]
        phase = "slice_python"
        s = phase_slice_python(torch, device, args.python_filters)
        launches["hash"]["python"] = s["launches"]
        phase = "python_segments"
        launches["hash"]["python_segments"] = phase_python_segments(
            torch, device, s["svc"], s["build_s"], card)["launches"]
        launches["join"]["python_segments"] = 0
        s = None
        gc.collect()
        phase = "slice_node"
        node = phase_slice_node(torch, device, args.filters, card,
                                args.storm_batches)
        launches["hash"]["node"], launches["join"]["node"] = node["launches"]
        (launches["hash"]["node_auto"],
         launches["join"]["node_auto"]) = node["auto_launches"]
        for name in ("slice_node_fanout", "slice_node_pipeline"):
            path = name[len("slice_"):]
            launches["hash"][path], launches["join"][path] = node[name]
        for path in ("node_rules", "node_rules_host", "segments_1m",
                     "node_deadline", "deadline_faults", "node_multichip"):
            launches["hash"][path], launches["join"][path] = node[path]
        rules = node["rules"]
        node = None
        gc.collect()
        phase = "acl_batch"
        acl = phase_acl_batch(torch, device, card)
        launches["hash"]["acl_batch"] = acl["launches"]
        launches["join"]["acl_batch"] = acl["join_launches"]
        phase = "tiered"
        tiered = phase_tiered(torch, device, card, args.tiered_filters)
        launches["dense"] = {"tiered": tiered["launches"]["dense"],
                             "tiered_fused": tiered["fused_launches"]["dense"]}
        launches["hash"]["tiered"] = tiered["launches"]["hash"]
        launches["hash"]["tiered_fused"] = tiered["fused_launches"]["hash"]
        phase = "retained_replay"
        launches["hash"]["retained_replay"] = phase_retained_replay(
            torch, device, card, args.replay_size)["launches"]
        phase = "slice_mqtt"
        mqtt = phase_slice_mqtt(torch, device,
                                min(args.filters, MQTT_FILTERS), card,
                                MQTT_STORM, args.mqtt_clients)
        for name in ("slice_mqtt", "slice_mqtt_fanout"):
            path = name[len("slice_"):]
            launches["hash"][path], launches["join"][path] = mqtt[name]
        mqtt = None
        gc.collect()
        phase = "slice_10m_build"
        big = phase_10m_build(torch, device, args.large_filters, big_gen)
        phase = "slice_10m"
        s = phase_10m(torch, device, big, rules)
        big = None      # the filter list and the oracle go
        launches["hash"]["10m"] = s["launches"]
        launches["join"]["10m"] = s["join_launches"]
        launches["hash"]["10m_rules"] = s["rule_launches"]
        launches["join"]["10m_rules"] = s["rule_join_launches"]
        phase = "times_10m"
        shapes_10m, _ = phase_times(torch, device, s, card, name="times_10m",
                                    timed=args.timed_batches // 5)
        s["svc"].backend = "join"   # the same table's join mirror
        join_shapes_10m, _ = phase_times(
            torch, device, s, card, backend="join", name="times_10m",
            timed=args.timed_batches // 5)
        s = None
        gc.collect()
    except Exception as e:  # any failed phase: report it and fail the run
        emit({"phase": phase, "ok": False,
              "error": f"{type(e).__name__}: {e}"})
        if big_gen is not None:
            big_gen.close()
        raise
    if device.type != "cuda":
        print("chip_smoke: CPU rehearsal finished; no result", file=sys.stderr)
        return 3
    print(card, flush=True)
    emit({"kernels": [
        _kernel_entry("hash", launches["hash"], max_err["hash"], shapes,
                      shapes_10m),
        _kernel_entry("join", launches["join"], max_err["join"], join_shapes,
                      join_shapes_10m),
        _dense_entry(launches["dense"], dense_check, tiered["shape"]),
        _flat_entry(max_err["flat"], {
            "1m_hash": shapes, "1m_join": join_shapes,
            "10m_hash": shapes_10m, "10m_join": join_shapes_10m}, flat_d8),
        *_bitmap_entries(fan, dry), *_route_entries(mc_kernels, fan)]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
