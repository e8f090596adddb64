"""The match plane of the broker's own publish path.

The port of ``emqx_tpu/broker/match_service.py`` ``MatchService``: the
router's wildcard filters are mirrored into a host table and its
resident device twin, concurrent publishes are micro-batched into walk
dispatches, and the answers are parked in a hint cache that
``Broker.publish`` consumes through ``Broker.device_match``.

**The serve loop** (``MatchService(broker, ...)``; :meth:`start`):

* the mirror consumes the router's delta log (``deltas_since``): a
  bootstrap from the live router at start, then ``_sync_loop`` drains
  the log when ``Router.listeners`` wake it, keeps each filter
  refcounted by its routes, writes the host table's deltas into the
  device table (row writes on the event loop, a whole upload on a
  worker thread) and, before ``ready``, runs
  ``_warm``: the build and load of every CUDA kernel the backend can
  pick and one walk per serve depth, so that no served batch waits on a
  compiler;
* the connection layer awaits :meth:`prefetch` per publish; the
  fixed-window ``_batch_loop`` lets ``batch_window_s`` run out from the
  oldest waiter's arrival, pops up to ``max_batch`` waiters and serves
  them in one dispatch:
  ``_encode_dispatch`` (encode, h2d, one walk per depth group),
  ``_readback_groups`` (d2h, per-row ids), then ``_collect_rows``
  re-runs spilled rows on the host table and refuses the batch
  (``_StaleRace``) when a freed accept id was handed out again while it
  was in flight.  Where the reference runs the first two on worker
  threads, the port runs them on the event loop: on the card they take
  a few ms a batch, while on a worker thread each of their many GIL
  hand-offs waits out a busy loop's switch interval (1.5–3 s a batch
  under a 2048-publisher storm at 1M filters on an H100 host);
* ``_mint_hints`` parks each answer, stamped with the router epoch and
  rule generation the device table reflected, in an LRU cache of
  ``hint_cap`` topics; :meth:`hint_routes` proves a hint fresh against
  the router's delta log before it returns its routes (only a wildcard
  filter added since the stamp and matching the topic can make it
  wrong), else publish walks the host trie; a hint proven fresh is
  re-stamped, so that the next proof starts from there;
* below ``bypass_rate`` publishes/s, prefetch skips the device (the
  batching window would cost more than the host trie);
* rules co-batch their FROM filters into the same table
  (:meth:`register_rule`); :meth:`hint_rules` returns the matched rule
  ids of a fresh hint;
* with ``pipeline=True`` (the reference's ``match.pipeline.enable``) the
  batch loop only encodes and dispatches (``_pipeline_dispatch``): each
  batch past dispatch is an in-flight slot, whose ``row_meta`` copy to
  pinned host memory is enqueued behind its walk with a CUDA event; at
  most ``pipeline_depth`` slots wait, and the ``_readback_loop`` task
  finishes them in order (``_finish_slot``): it waits on each slot's
  event by polling it between rounds of the loop, copies exactly the
  matched ids (phase 2 of the two-phase readback), decodes and mints.
  Everything runs on one CUDA stream, the stream that the row deltas
  are written on: a walk sees exactly the deltas written before it was
  enqueued, and the overlap is the host encoding batch N+1 while the
  card walks batch N.  No copy of the pipeline waits on the card on the
  loop.  While a slot is in flight the table reuses no freed accept id
  (``DeviceNfa.hold_ids``: new filters take fresh ids), so that churn
  cannot rename an id its rows hold.  A slot whose table changed under
  it anyway (an accept id reused, the table replaced) or whose readback
  failed is answered from the host tables at the mirror's epoch
  (``_cpu_serve``), as is a batch whose dispatch failed; its hints are
  marked as the host's, and :meth:`hint_routes` counts them apart
  (``tpu.match.hint_served_host``);
* ``readback_mode`` picks the readback's shape (the reference's
  ``match.readback.mode``): ``chunked`` (the default) reads the whole
  flat slab on the fixed-window path, as the reference does; the
  pipeline, and ``ragged`` or ``auto`` on either path, read in two
  phases through a slot (``_readback_slot``; the fixed-window path
  awaits it in place): the packed ``row_meta`` (4·B bytes), then exactly the
  Σcounts matched ids (``chunked``), or the reference's power-of-two
  capacity class of them (``ragged``; ``auto`` takes it when the total
  is not a power of two and the padding stays within
  ``readback_auto_slack`` times the total).  ``tpu.match.readback_bytes``
  counts what the reference's counts; each phase is one copy, so
  ``tpu.match.readback_roundtrips`` counts two waits for a batch with
  matches where the reference's ``chunked`` counts one per power-of-two
  chunk;
* ``backend="auto"`` serves each (batch, depth) shape on the hash or the
  join walk as a :class:`~emqx_tpu_torch.ops.join_match.BackendAutotuner`
  measured it: an unmeasured shape serves ``hash`` and queues one
  measurement, which runs on the event loop once that batch's waiters
  are resolved and times each backend's match with CUDA events (the
  reference measures on a worker thread, where a busy loop's GIL waits
  swamp a match of a tenth of a millisecond).  The port measures ``hash`` against ``join``
  (its ``join-pallas`` is the same kernel);
* at :meth:`start`, after the bootstrap, the started heap (the
  broker's subscriptions, the router's trie, the mirror) goes to the
  collector's permanent generation (``gc.freeze``): a
  full collection over a 1M-subscription heap pauses the event loop
  for seconds, past ``prefetch_timeout_s``.  A sync that leaves the
  mirror ``FREEZE_GROWTH`` filters above its size at the last freeze
  freezes again (no collection first: that would be the pause), so a
  fleet that subscribes after ``start()`` is frozen as it arrives.  The
  reference does not freeze;
* on a saturated loop the service keeps the round of the loop as its
  unit of delay: the sync's debounce and the batching window both run
  from the first event that needs them (a router mutation, the oldest
  waiter), not from the wake that comes a round later, and a waiter's
  ``prefetch_timeout_s`` expires only the answers the batch loop had
  not given when the timer ran (the reference's ``wait_for`` also drops
  an answer given in the round before its waiter resumes).

**The synchronous core** (a service without a broker): :meth:`load`,
:meth:`add`, :meth:`remove`, :meth:`sync` and :meth:`serve` chain the
same stages in the caller's thread.  With a broker attached the router
is the only source of filters, and those mutators raise.

``table`` picks the host table as the reference's ``tpu.table`` does:
``auto`` (the node default) and ``native`` build the C++ ``NativeNfa``,
``python`` the ``IncrementalNfa`` (the debug twin); where the
reference's ``auto`` falls back to Python when the native build fails,
the port raises.  Nothing here stands in for a failing kernel: a failed
batch resolves its waiters without a hint (publish walks the host trie
and the failure is logged), a failed ``_warm`` keeps ``ready`` false.

**The deadline serve plane** (``deadline=True``, the reference's
``match.deadline.enable``; off, the fixed-window loop serves as above):

* every waiter carries a budget of ``deadline_s``; ``_deadline_loop``
  dispatches when the adaptive bound fills, or as a partial batch
  (``broker.match.deadline_dispatch``) when the oldest waiter's budget
  no longer covers the estimated dispatch time; the bound follows an
  EWMA of the arrival rate, and per-lane caps from the short-topic
  fraction keep a deep-topic flood from starving the short lane;
* every dispatch runs under ``dispatch_timeout_s``; a batch that fails
  or times out is answered from the host tables at once
  (``_cpu_serve``) and counts toward the breaker, which opens after
  ``breaker_threshold`` consecutive failures (the ``match_degraded``
  alarm, one ``breaker_trip`` flight-recorder dump; the host serves
  every prefetch) until the supervised ``match.probe`` child gets a
  probe batch through, every ``breaker_probe_interval_s``;
* the ``olp`` brownout ladder: stage 1 halves the bound, stage 2 also
  sheds QoS0 prefetches to the host, stage 3 serves everything there;
  each escalation dumps the flight recorder once.

Where the reference dispatches on a worker thread, so that its timeout
fires whatever the walk does, the port dispatches on the loop, and a
timeout can only fire at an await: on the deadline path the readback
waits on the batch's CUDA event by polling it between rounds of the
loop (the fixed-window path's ``chunked`` slab is copied into pinned
buffers behind the walks and read once the event completes), never in
a synchronous copy.  A kernel cannot be cancelled: a batch that timed
out keeps its output and pinned buffers (``_timed_out``) until its
event completes, so that no later batch is handed them; later batches
queue behind it on the stream and time out too, which is the way to
the breaker; the probe refuses to enqueue behind a batch that still
runs.  A CUDA kernel takes every shape, so the reference's
``CompileMiss`` (a shape not compiled yet, served by the host with no
breaker strike) has no counterpart; ``_StaleRace`` earns no strike.

**Segments and compaction** (``segments=True`` with a ``segments_dir``,
the reference's ``match.segments.*``): the first bootstrap loads the
table from ``<segments_dir>/match_table.seg.npz``
(``storage/segments.py``; the ``table.load`` seam; a ``state`` segment
for the Python table, a ``filters`` one for the native table) and
replays only the difference against the live router, where a missing
or rejected segment leaves the full rebuild; a restored Python table
links its trie in the background (``table.hydrate``).  The supervised
``table.compact`` child builds, every ``compact_interval_s`` once
``compact_min_mutations`` mutations piled up, a compacted table and its
device twin on a worker thread (the upload on a CUDA stream of its own,
whose event the serving stream waits on before it reads the new
tensors), writes the next segment, and swaps both in on the loop
(``_swap_in``: the ``table.swap`` seam first, then the filters changed
during the build are fixed up and written to the new device table,
the rule ids remapped and the table generation bumped, so that a slot
in flight across the swap is answered by the host).  A build during
which more than 4,096 filters changed is abandoned.  On the Python
table the device twin grows in place on a resize (``DeviceNfa.
dirty_regions``, over ``dirty_threshold``: a whole upload).  The
reference's ``prewarm`` and ``match.segments.xla_cache`` pre-pay XLA
compiles of the next table shapes; a CUDA kernel is built once for
every shape, so both are accepted and do nothing.

The node's seams are the reference's: ``hists`` (a ``HistSet``: the
``obs.stage.match_wait`` / ``match_encode`` / ``match_dispatch`` /
``match_readback`` histograms), ``flightrec`` (the ``match.serve``,
``match.encode`` and ``match.readback`` rings, and the dumps), ``alarms``
and ``olp``, and a ``supervisor`` attribute set before :meth:`start`,
under which the loops run as restartable children.

**The multichip serve backend** (``multichip=True``, the reference's
``match.multichip.*``; off, ``self.mc`` stays None and every seam below
is one None test): the table shards by topic prefix over a mesh of
devices (``parallel/multichip_serve.py``: ``device`` may be a list of
devices, the mesh's; a single device is a list of one, and no device
every visible card).  The router's mutations are noted into the
per-shard host tables by ``_table_add``/``_table_del`` and applied by
the sync loop (on the loop for deltas, on a worker thread for a
repartition, which the start, a compaction swap and a restored segment
set); a batch serves through the mesh once its tables are up
(``_mc_active``), encoded against the shards' shared vocab, its readback
waiting on the dispatch's events between rounds of the loop; a shard
failure fails the batch over to the host like any device failure.  With
``multichip_degraded`` the ladder's alarm, the supervised
``mesh.rebuild`` child and the canary gate re-admission
(``_mesh_watch``); with ``segments`` the per-shard segments persist
beside the table's; with ``multichip_ep_autotune`` the compaction
stages the popularity placement that its swap applies.  Where the
reference logs a matcher that cannot be built and serves the single
device, the port raises.
"""

from __future__ import annotations

import asyncio
import gc
import logging
import os
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from .. import faultinject as _fi
from .. import topic as T
from ..gil import PIECE, yield_lock, yielding
from ..native.nfa import NativeNfa
from ..observe.flightrec import STAGES as _FR_STAGES
from ..ops import cuda_build
from ..ops.compiler import _bucket as _pow2
from ..ops.device_table import BACKENDS, JOIN_BACKENDS, DeviceNfa, check_backend
from ..ops.encode import TopicEncoder, encode_batch, table_encoder
from ..ops.incremental import IncrementalNfa
from ..ops.join_match import BackendAutotuner
from ..ops.match_kernel import (SERVE_FLAT_MULT, decode_flat,
                                decode_row_meta, fetch_flat_prefix,
                                fetch_flat_ragged, ragged_capacity)
from ..parallel.multichip_serve import McHandle, MultichipMatcher
from ..storage.segments import (SegmentError, load_segment,
                                restore_incremental, save_segment)
from .trie import FilterTrie

log = logging.getLogger(__name__)

__all__ = ["BACKEND_KERNELS", "SERVICE_BACKENDS", "TABLES", "MatchService"]

#: the host tables ``MatchService(table=...)`` builds; ``auto`` is native
TABLES = ("auto", "native", "python")
#: the backends a service serves: the walks, and their measured pick
SERVICE_BACKENDS = BACKENDS + ("auto",)
#: the CUDA kernel (``ops/cuda_build.py`` name) each walk backend launches
BACKEND_KERNELS = {"hash": "nfa_walk", "join": "nfa_join_walk",
                   "join-pallas": "nfa_join_walk"}

# packed flight-recorder stage ids (observe/flightrec.py STAGES)
_SID_WAIT = _FR_STAGES.index("match_wait")
_SID_ENCODE = _FR_STAGES.index("match_encode")
_SID_DISPATCH = _FR_STAGES.index("match_dispatch")
_SID_READBACK = _FR_STAGES.index("match_readback")

class _StaleRace(RuntimeError):
    """A benign serving race (an accept id reused while the batch was in
    flight, or the table swapped): the batch answer cannot be trusted,
    the device is healthy; no breaker strike."""

#: the segment file in a service's ``segments_dir``
SEGMENT_FILE = "match_table.seg.npz"
#: a compaction during which more filters than this changed is abandoned
COMPACT_DIRTY_MAX = 4096


def _validate_all(filters: Sequence[str]) -> None:
    """``topic.validate`` of every filter (raises TopicError at the first
    invalid one).  The common case runs vectorised over the joined
    bytes: with no NUL, empty, over-long or shared-subscription filter,
    a filter is valid when each '+' and '#' stands between separators
    ('/' or a filter boundary) and each '#' ends its filter; the filters
    around a byte that is not are validated one by one."""
    blob = "\n".join(filters).encode()
    nl, sep, plus, hash_ = (np.uint8(ord(c)) for c in "\n/+#")
    pad = np.concatenate(([nl], np.frombuffer(blob, np.uint8), [nl]))
    bounds = np.flatnonzero(pad == nl)
    lens = np.diff(bounds) - 1
    if (len(lens) != len(filters) or b"\x00" in blob or b"$share/" in blob
            or b"$queue/" in blob or lens.min(initial=1) == 0
            or lens.max(initial=0) > T.MAX_TOPIC_LEN):
        # also: a filter holds '\n' (legal in MQTT) or there are none
        for f in filters:
            T.validate(f, "filter")
        return
    at = np.flatnonzero((pad == plus) | (pad == hash_))
    before, here, after = pad[at - 1], pad[at], pad[at + 1]
    bad = ((before != sep) & (before != nl)) | (after != nl) & (
        (here == hash_) | (after != sep))
    for p in (at[bad] - 1).tolist():
        lo = blob.rfind(b"\n", 0, p) + 1
        hi = blob.find(b"\n", p)
        T.validate(blob[lo:len(blob) if hi < 0 else hi].decode(), "filter")


def _table_sizing(n: int) -> Tuple[int, int]:
    """Initial (S, Hb) of a native table for ``n`` filters, as the
    reference bench's ``build_table``: about 2.2 states and 1.4 buckets
    (two slots each) per filter, rounded up to powers of two."""
    n = max(2, n)
    return (max(1024, 1 << int(np.ceil(np.log2(n * 2.2)))),
            max(64, 1 << int(np.ceil(np.log2(n * 1.4)))))


#: the phase-2 shapes of the two-phase readback
READBACK_MODES = ("chunked", "ragged", "auto")

#: GPU cycles of the spin that covers the enqueue of a timed match
#: (about 1 ms at an H100's boost clock)
_SPIN_CYCLES = 2_000_000


def _bucket(n: int, minimum: int = 64) -> int:
    """Padded batch size: the next power of two ≥ max(n, minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


class _RecentAdds:
    """The wildcard filters the router added in its last ``window``
    mutations, in a trie, each with the epoch of its latest add: the
    index of the freshness proof.  A hint of epoch ``e`` (inside the
    window) is stale for a topic exactly when a filter added after ``e``
    matches it: one trie walk, where a scan of the delta log costs a
    ``topic.match`` per logged add (hundreds per publish under a steady
    churn, when each batch's hints lag the router by its sync)."""

    def __init__(self, router: Any, window: int) -> None:
        self.router = router
        self.window = window
        self.trie = FilterTrie()
        self.last: Dict[str, int] = {}     # filter -> epoch of latest add
        self.count: Dict[str, int] = {}    # filter -> its adds in the log
        self.log: Deque[Tuple[int, str]] = deque()
        self.epoch = router.epoch          # the router epoch caught up to
        self.floor = 0                     # no proof for an older epoch

    def _catch_up(self) -> None:
        now = self.router.epoch
        if now == self.epoch:
            return
        deltas = self.router.deltas_since(max(self.epoch, now - self.window))
        if deltas is None:                 # the log no longer reaches
            deltas = []
            self.floor = now
        for d in deltas:
            if d.op == "add" and T.wildcard(d.filter):
                f = d.filter
                self.log.append((d.epoch, f))
                self.last[f] = d.epoch
                n = self.count.get(f, 0)
                self.count[f] = n + 1
                if n == 0:
                    self.trie.insert(f)
        log = self.log
        while log and log[0][0] <= now - self.window:
            f = log.popleft()[1]
            n = self.count[f] - 1
            if n:
                self.count[f] = n
            else:
                del self.count[f], self.last[f]
                self.trie.delete(f)
        self.epoch = now

    def stale(self, topic: str, epoch: int) -> bool:
        """Whether a filter added after ``epoch`` (at most ``window``
        mutations ago) matches ``topic``."""
        self._catch_up()
        if epoch < self.floor:
            return True
        last = self.last
        return any(last[f] > epoch for f in self.trie.match(topic))


class _Slot:
    """A batch past dispatch: its waiters and groups, the walk results,
    the guards it was dispatched against (the table's ``aid_reuses`` and
    the service's table generation), the epochs its hints will carry,
    and its readback state: one pinned host buffer for the groups'
    ``row_meta`` and one for their ids (both the service's, lent until
    the rows are decoded), or the pinned copies of each group's whole
    slab (``slab``: the ``chunked`` readback on the deadline path), the
    event after the last copy enqueued (None on the CPU, where copies
    are done on return), and the device table whose freed accept ids it
    holds.  ``t0`` is its dispatch time (monotonic) and ``deadline``
    whether the deadline loop dispatched it (its readback is then timed
    and feeds the breaker)."""

    __slots__ = ("pending", "topics", "groups", "handles", "reuses0",
                 "gen0", "epoch", "rule_gen", "dispatch_s", "bufs",
                 "metas", "slab", "event", "held", "t0", "deadline")

    def __init__(self, pending, topics, groups, handles, reuses0, gen0,
                 epoch, rule_gen, dispatch_s=0.0, bufs=None, metas=(),
                 event=None, held=None, slab=None) -> None:
        self.pending, self.topics, self.groups = pending, topics, groups
        self.handles, self.reuses0, self.gen0 = handles, reuses0, gen0
        self.epoch, self.rule_gen = epoch, rule_gen
        self.dispatch_s = dispatch_s
        self.bufs, self.metas, self.event = bufs, metas, event
        self.slab = slab
        # the DeviceNfa whose freed ids the slot holds until released
        self.held = held
        self.t0 = time.monotonic()
        self.deadline = False


def _record_event(device: torch.device):
    """A CUDA event recorded now on the current stream of ``device``
    (None on the CPU)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


async def _await_answers(futs: Sequence[asyncio.Future], timeout: float,
                         msg: str, arg: Any) -> None:
    """Wait for the batch loop to answer the waiters ``futs``, at most
    ``timeout`` seconds: the timer then answers those still open with
    None (their publishes walk the host trie) and logs ``msg % arg``.
    An answer given before the timer runs is kept, even when the loop
    has not yet resumed this waiter: on a saturated loop the batch loop
    answers at the start of a round and its waiters resume in the next,
    after the round's due timers (``asyncio.wait_for`` would cancel the
    answered waiter then)."""
    def expire() -> None:
        late = [f for f in futs if not f.done()]
        for f in late:
            f.set_result(None)
        if late:
            log.debug(msg, arg)

    timer = asyncio.get_running_loop().call_later(timeout, expire)
    try:
        for f in futs:
            await f
    finally:
        timer.cancel()


async def _events_done(events: Sequence[Any]) -> None:
    """:func:`_event_done` of each of ``events``."""
    for ev in events:
        await _event_done(ev)


async def _event_done(ev) -> None:
    """Wait for ``ev`` without blocking the event loop: poll it between
    rounds of the loop (a busy loop polls once a round; an idle one
    sleeps 0.2 ms between polls after the first 64)."""
    if ev is None:
        return
    polls = 0
    while not ev.query():
        polls += 1
        await asyncio.sleep(0 if polls < 64 else 0.0002)


def _yielding_call(fn, *args):
    """``fn(*args)`` with the yield points of :mod:`emqx_tpu_torch.gil`
    on: the compaction's build thread hands the interpreter lock to the
    event loop between its pieces of work."""
    with yielding():
        return fn(*args)


def _build_compacted(table_kind: str, depth: int, routing: List[str],
                     ruled: Set[str], deep_filters: List[str],
                     active_slots: int, max_matches: int,
                     device: torch.device, stream, serving,
                     dirty_threshold: float, segment_path: str, join: bool,
                     steps: Optional[List[Tuple[str, float, float]]] = None):
    """The worker-thread half of a compaction: a fresh table of the
    ``routing`` and ``ruled`` filters (aliases for ``deep_filters``),
    the next segment written, and the fresh device twin uploaded.  The
    set algebra runs here, not on the loop (at 1M filters a sort there
    paused the loop for a second); what runs here shares the
    interpreter lock with the loop, so the per-filter work is left to
    the native table and numpy, and no list is sorted: a table's answers
    do not depend on its build order.  On the card the upload runs on
    ``stream``, and its tensors are marked as used on the ``serving``
    stream, which must wait for the returned event before it reads
    them.  Writes only objects made here; ``steps``, when given, gets
    ``(step, start, end)`` on the ``time.monotonic`` clock for each step.
    Returns ``(table, device twin, aliases, routing filter of each accept
    id, event)``."""
    marks = [time.monotonic()]

    def step(name: str) -> None:
        marks.append(time.monotonic())
        if steps is not None:
            steps.append((name, marks[-2], marks[-1]))

    deep = set(deep_filters)
    filters = routing
    if deep:
        filters = []
        for i in range(0, len(routing), PIECE):
            filters += [f for f in routing[i:i + PIECE] if f not in deep]
            yield_lock()
    if ruled:
        routed: Set[str] = set()
        for i in range(0, len(routing), PIECE):
            routed.update(routing[i:i + PIECE])
            yield_lock()
        filters = filters + [f for f in ruled
                             if f not in routed and f not in deep]
    step("filters")
    if table_kind == "native":
        s, hb = _table_sizing(len(filters))
        fresh = NativeNfa(depth=depth, state_bucket=s, edge_bucket=hb)
        fresh.bulk_add(filters)
    else:
        # about half the edge slots in use after the build, so that the
        # churn after a swap does not grow the table at once
        fresh = IncrementalNfa(
            depth=depth, state_bucket=_pow2(max(2 * len(filters), 8), 1024),
            edge_bucket=_pow2(max(len(filters), 8), 64))
        for flt in filters:
            fresh.add(flt)
        fresh.track_regions = True
    step("table")
    new_deep = {flt: fresh.alloc_alias(flt) for flt in deep_filters}
    if table_kind == "native":
        aids = fresh.bulk_aid_of(routing)
    else:
        aids = np.array([fresh.aid_of(f) for f in routing], np.int32)
    if new_deep:
        # a too-deep filter is not in the table: look at those ids alone
        aids = aids.copy()
        for i in np.flatnonzero(aids < 0).tolist():
            aids[i] = new_deep.get(routing[i], -1)
    step("aids")
    # one entry per accept id, rule-only filters' too; a piece at a time,
    # as each numpy call over object arrays holds the interpreter lock
    fo = np.full(fresh.n_accepts if table_kind == "native"
                 else len(fresh.accept_filters), None, object)
    for i in range(0, len(routing), PIECE):
        part = aids[i:i + PIECE]
        held = part >= 0
        fo[part[held]] = np.array(routing[i:i + PIECE], object)[held]
        yield_lock()
    filter_of: List[Optional[str]] = []
    for i in range(0, len(fo), PIECE):
        filter_of.extend(fo[i:i + PIECE].tolist())
        yield_lock()
    step("filter_of")
    # the segment lands before the swap: a crash after this leaves a
    # valid segment and the old table serving
    save_segment(segment_path, fresh, deep=new_deep,
                 routing_aids=aids[aids >= 0], filters=filters,
                 join_relation=join)
    step("segment")
    newdev = DeviceNfa(fresh, active_slots=active_slots,
                       max_matches=max_matches, device=device, lazy=True)
    newdev.dirty_full_threshold = dirty_threshold
    newdev.dirty_regions = table_kind == "python"
    if join:
        newdev.enable_join()
    event = None
    if device.type == "cuda":
        with torch.cuda.stream(stream):
            newdev.sync(full=True)
            event = torch.cuda.Event()
            event.record(stream)
        for t in newdev.arrays() + (newdev._jarrs or ()):
            t.record_stream(serving)
    else:
        newdev.sync(full=True)
    step("upload")
    return fresh, newdev, new_deep, filter_of, event


class MatchService:
    """Wildcard filters mirrored into a resident device table; topic
    batches matched on the device with host fail-open for spilled rows.
    Defaults are the node's (``tpu.max_levels`` 16, ``tpu.batch_deadline``
    0.2 ms, ``tpu.batch_size`` 2048, ``tpu.mirror_refresh_interval``
    50 ms, ``tpu.active_slots`` 16, ``tpu.max_matches`` 128,
    ``tpu.max_stale_deltas`` 256, ``tpu.bypass_rate`` 500/s,
    ``tpu.prefetch_timeout`` 0.5 s, ``tpu.table`` auto,
    ``tpu.short_depth`` 4, ``tpu.split_min`` 256, ``match.backend``
    hash, ``match.autotune`` on with 3 reps)."""

    FLAT_MULT = SERVE_FLAT_MULT

    def __init__(self, broker: Any = None, metrics: Any = None, *,
                 depth: int = 16, batch_window_s: float = 0.0002,
                 max_batch: int = 2048, debounce_s: float = 0.05,
                 active_slots: int = 16, max_matches: int = 128,
                 hint_cap: int = 65536, max_stale_deltas: int = 256,
                 bypass_rate: float = 500.0,
                 prefetch_timeout_s: float = 0.5, table: str = "auto",
                 short_depth: int = 4, split_min: int = 256,
                 backend: str = "hash", autotune: bool = True,
                 autotune_reps: int = 3, pipeline: bool = False,
                 pipeline_depth: int = 2, readback_mode: str = "chunked",
                 readback_auto_slack: float = 1.0,
                 deadline: bool = False, deadline_s: float = 0.041,
                 breaker_threshold: int = 5,
                 breaker_probe_interval_s: float = 1.0,
                 dispatch_timeout_s: Optional[float] = None,
                 segments: bool = False, segments_dir: str = "",
                 compact_interval_s: float = 30.0,
                 compact_min_mutations: int = 1024,
                 dirty_threshold: float = 0.5, prewarm: bool = True,
                 alarms: Any = None, olp: Any = None, hists: Any = None,
                 flightrec: Any = None,
                 multichip: bool = False, multichip_tp: int = 0,
                 multichip_native: bool = True, multichip_ep: bool = False,
                 multichip_ep_slack: float = 2.0, multichip_ep_micro: int = 8,
                 multichip_ep_compact: bool = False,
                 multichip_degraded: bool = False,
                 multichip_degraded_threshold: int = 3,
                 multichip_ep_overflow_warn: float = 0.5,
                 multichip_ep_autotune: bool = False,
                 multichip_ep_grow_threshold: float = 0.05,
                 multichip_ep_shrink_threshold: float = 0.01,
                 multichip_ep_max_cap_class: int = 3,
                 multichip_balance_budget: int = 64,
                 device: Union[None, str, torch.device,
                               Sequence[Union[str, torch.device]]] = None
                 ) -> None:
        if backend not in SERVICE_BACKENDS:
            check_backend(backend)      # raises ValueError
        if table not in TABLES:
            raise ValueError(f"unknown host table {table!r}")
        if readback_mode not in READBACK_MODES:
            raise ValueError(f"unknown readback mode {readback_mode!r}")
        self.broker = broker
        self.router = broker.router if broker is not None else None
        self.metrics = metrics
        # the breaker's alarm and the brownout ladder's level
        self.alarms = alarms
        self.olp = olp
        # set by the node before start(): the loops run as its children
        self.supervisor = None
        # stage histograms (None: every recording site is one attribute
        # test); the serve loop on the event loop is their one writer
        self.hists = hists
        self._h_wait = self._h_encode = None
        self._h_dispatch = self._h_readback = None
        if hists is not None:
            self._h_wait = hists.hist("obs.stage.match_wait")
            self._h_encode = hists.hist("obs.stage.match_encode")
            self._h_dispatch = hists.hist("obs.stage.match_dispatch")
            self._h_readback = hists.hist("obs.stage.match_readback")
        # the flight recorder's rings: one a batch for its queue wait,
        # its encode and dispatch, and its readback
        self.flightrec = flightrec
        self._ring_loop = self._ring_disp = self._ring_rb = None
        if flightrec is not None:
            self._ring_loop = flightrec.ring("match.serve")
            self._ring_disp = flightrec.ring("match.encode")
            self._ring_rb = flightrec.ring("match.readback")
        self.backend = backend
        self.depth = depth
        self.batch_window_s = batch_window_s
        self.max_batch = max_batch
        self.debounce_s = debounce_s
        self.hint_cap = hint_cap
        # serving tolerates up to this many un-synced router deltas; the
        # per-topic freshness proof scans at most this many log entries
        self.max_stale_deltas = max_stale_deltas
        # publishes/s below which prefetch skips the device (0: never)
        self.bypass_rate = bypass_rate
        self.prefetch_timeout_s = prefetch_timeout_s
        self.short_depth = short_depth
        self.split_min = split_min
        # the overlapped pipeline (module docstring); off, the batch loop
        # dispatches and reads back each batch before the next
        self.pipeline = bool(pipeline)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._inflight_q: Optional[asyncio.Queue] = None
        self._inflight_n = 0
        # pinned (meta, ids) host buffer pairs free for a slot to borrow
        self._rb_free: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.readback_mode = readback_mode
        self.readback_auto_slack = float(readback_auto_slack)
        # bumped when the host table is replaced: a batch in flight
        # across the swap named its accept ids in the old table
        self._table_gen = 0
        # the deadline serve plane (module docstring)
        self.deadline = bool(deadline)
        self.deadline_s = deadline_s
        self.breaker_threshold = breaker_threshold
        self.breaker_probe_interval_s = breaker_probe_interval_s
        # well under the waiter timeout, so that a hung walk costs one
        # batch answered by the host, not a stalled queue
        self.dispatch_timeout_s = (
            dispatch_timeout_s if dispatch_timeout_s is not None
            else min(max(4.0 * deadline_s, 0.1),
                     max(prefetch_timeout_s * 0.8, 0.05)))
        # EWMAs of the arrival rate and of the short-lane share (per
        # 50 ms window), of a batch's dispatch to hints (the combined
        # estimate), and of its encode + dispatch and its readback (the
        # split estimate, which serves once SPLIT_WARM batches fed it)
        self._rate_ewma: Optional[float] = None
        self._short_frac: Optional[float] = None
        self._win_short = 0
        self._est_dispatch_s = 0.005
        self._est_disp_s = 0.004
        self._est_rb_s = 0.001
        self._est_split_samples = 0
        self._breaker_failures = 0
        self._breaker_open = False
        self._probe_child: Any = None
        self._last_brownout = 0
        self._running = False
        # batches that timed out on the card, each (event, what it owns:
        # pinned buffers, outputs), kept until the event completes
        self._timed_out: List[Tuple[Any, Any]] = []
        # segments and compaction (module docstring); off, all inert
        self.segments = bool(segments) and bool(segments_dir)
        self.segments_dir = segments_dir
        self.compact_interval_s = compact_interval_s
        self.compact_min_mutations = compact_min_mutations
        self.dirty_threshold = dirty_threshold
        # accepted, and nothing to do: a CUDA kernel serves every shape
        self.prewarm = bool(prewarm)
        self._mut_count = 0            # table mutations since the segment
        self._compact_dirty: Set[str] = set()   # filters changed mid-build
        self._compact_recording = False
        self._compact_abandoned = 0
        #: the last build's ``(step, start, end)`` (``_build_compacted``)
        self.compact_steps: List[Tuple[str, float, float]] = []
        self._segment_loaded = False
        self._segment_tried = False
        self._seg_join_seed = None     # a state segment's join relation
        self._build_stream = None      # the compaction's upload stream
        self.table_kind = "python" if table == "python" else "native"
        self.inc = (IncrementalNfa(depth=depth) if self.table_kind == "python"
                    else NativeNfa(depth=depth))
        # a device list is the mesh's; the single-device table takes its
        # first
        mesh_devices = (list(device) if isinstance(device, (list, tuple))
                        else None if device is None else [device])
        self.dev = self._bind_device(
            self.inc, active_slots, max_matches,
            mesh_devices[0] if mesh_devices else device)
        # the multichip serve backend (module docstring)
        self.mc: Optional[MultichipMatcher] = None
        if multichip:
            self.mc = MultichipMatcher(
                depth=depth, tp=multichip_tp, devices=mesh_devices,
                active_slots=active_slots, max_matches=max_matches,
                metrics=metrics, native=multichip_native, ep=multichip_ep,
                ep_slack=multichip_ep_slack,
                ep_micro_matches=multichip_ep_micro,
                ep_compact=multichip_ep_compact,
                degraded=multichip_degraded,
                degraded_fail_threshold=multichip_degraded_threshold,
                ep_overflow_warn=multichip_ep_overflow_warn,
                ep_autotune=multichip_ep_autotune,
                ep_grow_threshold=multichip_ep_grow_threshold,
                ep_shrink_threshold=multichip_ep_shrink_threshold,
                ep_max_cap_class=multichip_ep_max_cap_class,
                balance_budget=multichip_balance_budget)
        # the degraded mesh's alarm latch and its rebuild child's flag
        self._mesh_alarmed = False
        self._mesh_rebuilding = False
        self._deep: Dict[str, int] = {}    # too-deep filter -> alias aid
        self._deep_trie = FilterTrie()     # host match for too-deep filters
        # accept id -> its routing filter (None: a free id, or one that
        # only rules hold): the split stage's map, kept here so that it
        # asks the table nothing per id.  A list, not a dict: an index
        # costs fewer cache misses than a hash probe that also compares
        # the stored int key (with 1M ids a dict took 1.1-1.6x the
        # list's split time per id on an H100 machine's host).  The
        # price: the cyclic GC walks the list at every full collection.
        self._filter_of: List[Optional[str]] = []
        self._ref: Dict[str, int] = {}    # routed wildcard filter -> routes
        # rule filters are real table filters tagged by aid; a filter
        # used by routing and by rules shares one aid
        self._aid_rules: Dict[int, Set[str]] = {}         # aid -> rule ids
        self._rule_refs: Dict[str, Dict[str, int]] = {}   # rule -> {flt: 1}
        # rule mutation log: (gen, filters added); unregisters append an
        # empty entry so that the generations stay contiguous
        self._rule_gen = 0
        self._rule_log: Deque[Tuple[int, Tuple[str, ...]]] = deque(
            maxlen=512)
        # backend="auto": the measured per-shape picks
        self.tuner = (BackendAutotuner(reps=autotune_reps)
                      if backend == "auto" and autotune else None)
        self._tuning: Set[str] = set()     # queued or measured sigs
        self._tune_queue: List[Tuple[str, int, int]] = []
        # recently served topics: what the autotuner measures with
        self._topic_sample: Deque[str] = deque(maxlen=256)
        # counters: walk dispatches (join_dispatches: those of a join
        # backend), served batches/topics, host re-runs, walks the
        # autotuner launched
        self.dispatches = 0
        self.join_dispatches = 0
        self.batches = 0
        self.topics = 0
        self.fallback_host = 0
        self.autotune_launches = 0
        self.load_seconds: Dict[str, float] = {}
        # the serve loop's state; sync_error is the last sync's failure
        # (a failed upload or warm-up), None once a sync lands
        self.ready = False
        self.sync_error: Optional[BaseException] = None
        self._seen_epoch = 0          # router delta-log position (drained)
        self._synced_epoch = 0        # router epoch the DEVICE table reflects
        self._synced_rule_gen = 0     # rule gen the device table reflects
        self._dirty = asyncio.Event()
        self._dirty_since = 0.0       # the first mutation not yet synced
        # the live wildcard filters at the last gc.freeze, and the
        # freezes since start()
        self._frozen_filters = 0
        self.freezes = 0
        self._pending: List[Tuple[str, asyncio.Future]] = []
        self._pending_since = 0.0     # arrival of the oldest waiter
        self._batch_wake = asyncio.Event()
        # topic -> (router epoch, rule gen, wild filters, rule ids,
        # answered by the host tables)
        self._hints: Dict[str, Tuple[int, int, Tuple[str, ...],
                                     Tuple[str, ...], bool]] = {}
        self._tasks: List[asyncio.Task] = []
        # arrival-rate window of the adaptive bypass
        self._win_start = time.monotonic()
        self._win_count = 0
        self._last_rate = 0.0
        if broker is not None:
            self._recent = _RecentAdds(self.router, max_stale_deltas)
            self.router.listeners.append(self._on_router_mutation)

    def _bind_device(self, inc, active_slots: int, max_matches: int,
                     device) -> DeviceNfa:
        dev = DeviceNfa(inc, active_slots=active_slots,
                        max_matches=max_matches, device=device, lazy=True)
        if self.segments:
            dev.dirty_full_threshold = self.dirty_threshold
            if isinstance(inc, IncrementalNfa):
                inc.track_regions = True
                dev.dirty_regions = True
        if self.backend in JOIN_BACKENDS or self.backend == "auto":
            seed, self._seg_join_seed = self._seg_join_seed, None
            dev.enable_join(segment_seed=seed)
        return dev

    @property
    def encoder(self) -> TopicEncoder:
        """The topic encoder cached on the host table (its
        ``native_batches`` / ``python_batches`` count what it served)."""
        return table_encoder(self.inc)

    def _inc(self, name: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.inc(name, n)

    # -- the host table and the id maps ------------------------------------

    def _aid(self, flt: str) -> int:
        """Accept id of ``flt`` (an alias for a too-deep one), -1 if
        absent."""
        aid = self._deep.get(flt)
        return self.inc.aid_of(flt) if aid is None else aid

    def _table_add(self, flt: str, routing: bool) -> int:
        """Put ``flt`` in the table (or give a filter the table cannot
        hold an alias id and the host trie); mark it routing.  Returns
        its accept id."""
        aid = self._deep.get(flt)
        if aid is None:
            try:
                self.inc.add(flt)
                aid = self.inc.aid_of(flt)
                if self.mc is not None:
                    # too-deep aliases stay with the host trie
                    self.mc.note_add(flt, aid)
            except ValueError:   # deeper than the table
                aid = self.inc.alloc_alias(flt)
                self._deep[flt] = aid
                self._deep_trie.insert(flt)
        fo = self._filter_of
        if aid >= len(fo):
            fo.extend([None] * (aid + 1 - len(fo)))
        if routing:
            fo[aid] = flt
        self._note_mutation(flt)
        return aid

    def _table_del(self, flt: str, routing: bool) -> None:
        """Unmark ``flt`` routing (with ``routing``); drop it from the
        table once neither routing nor a rule holds it."""
        aid = self._aid(flt)
        if aid < 0:
            return
        if routing:
            self._filter_of[aid] = None
        if self._filter_of[aid] is not None or self._aid_rules.get(aid):
            return
        if flt in self._deep:
            del self._deep[flt]
            self._deep_trie.delete(flt)
            self.inc.free_alias(aid)
        else:
            self.inc.remove(flt)
            if self.mc is not None:
                self.mc.note_del(flt)
        self._note_mutation(flt)

    def _note_mutation(self, flt: str) -> None:
        """Count a table mutation toward the next compaction; while a
        compaction builds, remember the filter for the swap's fix-up."""
        if not self.segments:
            return
        self._mut_count += 1
        if self._compact_recording:
            self._compact_dirty.add(flt)

    def _bulk_start(self, filters: List[str]) -> None:
        """Fill an empty native table from ``filters`` in one build: one
        ``bulk_add`` into a table sized as the reference bench's
        ``build_table``, the routing ids from one bulk ``aid_of`` (as the
        reference's reconcile does for a freshly bulk-loaded table), and
        filters the table cannot hold through :meth:`_table_add`;
        ``load_seconds`` keeps the two steps' seconds."""
        t0 = time.perf_counter()
        s, hb = _table_sizing(len(filters))
        inc = NativeNfa(depth=self.depth, state_bucket=s, edge_bucket=hb)
        inc.bulk_add(filters)
        self.inc = inc
        self._table_gen += 1
        self.dev = self._bind_device(inc, self.dev.active_slots,
                                     self.dev.max_matches, self.dev.device)
        t1 = time.perf_counter()
        aids = inc.bulk_aid_of(filters)
        fo = self._filter_of = [None] * (int(aids.max(initial=-1)) + 1)
        for aid, f in zip(aids.tolist(), filters):
            if aid >= 0:
                fo[aid] = f
        for i in np.flatnonzero(aids < 0).tolist():
            self._table_add(filters[i], routing=True)
        self.load_seconds.update(bulk_add=t1 - t0,
                                 routing=time.perf_counter() - t1)

    def _fresh(self) -> bool:
        return not (self.inc.n_filters or self._deep
                    or self.dev.epoch != -1)

    # -- the synchronous core: filter upkeep ---------------------------------

    def _no_broker(self, what: str) -> None:
        if self.broker is not None:
            raise RuntimeError(
                f"{what}(): with a broker attached the router is the only "
                "source of filters")

    def load(self, filters: Sequence[str]) -> int:
        """Start an empty, never synced service from ``filters`` in one
        build; returns the number of distinct filters it holds.  On the
        native table this is the large-table path: every filter is
        validated (``topic.validate``; raises TopicError), then
        :meth:`_bulk_start`; ``load_seconds`` keeps the steps' seconds.
        On the Python table it is :meth:`add` per filter."""
        self._no_broker("load")
        if not self._fresh():
            raise RuntimeError("load() needs an empty, never synced service")
        if self.table_kind == "python":
            for f in filters:
                self.add(f)
            return self.n_routing
        t0 = time.perf_counter()
        filters = list(filters)
        _validate_all(filters)
        self.load_seconds = {"validate": time.perf_counter() - t0}
        self._bulk_start(filters)
        return self.n_routing

    @property
    def n_routing(self) -> int:
        """Routing filters held (the table's and the too-deep ones)."""
        return len(self._filter_of) - self._filter_of.count(None)

    def add(self, flt: str) -> bool:
        """Mirror wildcard filter ``flt``; False if already present.
        Filters deeper than the table get an alias id and live in the
        host trie."""
        self._no_broker("add")
        T.validate(flt, "filter")
        aid = self._aid(flt)
        if aid >= 0 and self._filter_of[aid] is not None:
            return False
        self._table_add(flt, routing=True)
        return True

    def remove(self, flt: str) -> bool:
        """Drop filter ``flt``; False if absent."""
        self._no_broker("remove")
        aid = self._aid(flt)
        if aid < 0 or self._filter_of[aid] is None:
            return False
        self._table_del(flt, routing=True)
        return True

    def sync(self) -> bool:
        """Apply the host mutations to the device table (rows written in
        place, or a whole upload after the table grew)."""
        self._no_broker("sync")
        changed = self.dev.sync()
        mc = self.mc
        if mc is not None:
            if not mc.ready and not mc.heavy:
                # the first sync partitions the whole table (notes
                # queued before it are in the table too)
                mc.rebuild(self._mc_pairs())
            if mc.dirty:
                self._mc_apply()
                changed = True
        return changed

    # -- the synchronous core: serving ---------------------------------------

    def serve(self, topics: Sequence[str]) -> List[List[str]]:
        """Matching routing filters for each topic, in batches of at most
        ``max_batch`` topics."""
        return [filters for filters, _rules in self.serve_split(topics)]

    def serve_split(self, topics: Sequence[str]
                    ) -> List[Tuple[List[str], List[str]]]:
        """:meth:`serve` with the co-batched rules: ``(routing filters,
        sorted rule ids)`` for each topic, from the same walks."""
        out: List[Tuple[List[str], List[str]]] = []
        for lo in range(0, len(topics), self.max_batch):
            batch = list(topics[lo:lo + self.max_batch])
            self._topic_sample.extend(batch[:8])
            groups = self._depth_groups(batch)
            results, _nbytes, _trips = self._readback_groups(
                self._encode_dispatch(batch, groups, self._mc_active()))
            rows = self._collect_rows(batch, groups, results)
            out.extend(map(self._split_row, rows))
            self._autotune_queued()
        return out

    def _depth_groups(self, topics: List[str]) -> List[Tuple[List[int], int]]:
        """Partition batch indices into (indices, walk depth) groups.
        The walk depth bounds TOPIC length, not filter depth, so short
        topics are exact through a shallow walk of the same table."""
        sd = self.short_depth
        everything = [(list(range(len(topics))), self.depth)]
        if not sd or sd >= self.depth:
            return everything
        short = [i for i, t in enumerate(topics) if t.count("/") < sd]
        if len(short) < self.split_min or \
                len(topics) - len(short) < self.split_min:
            return everything
        sset = set(short)
        long_ = [i for i in range(len(topics)) if i not in sset]
        return [(short, sd), (long_, self.depth)]

    def _encode_dispatch(self, topics: List[str], groups,
                         mc: Optional[MultichipMatcher] = None):
        """Encode every depth group and dispatch its walk on the backend
        :meth:`_backend_for` picks, or with ``mc`` through the mesh
        (encoded against the shards' shared vocab; the rows come back as
        service accept ids).  Returns ``[(MatchResult or McHandle, rows
        in group)]``; the results are still being computed on the device
        when this returns."""
        handles = []
        dev = self.dev
        gen = self._table_gen
        for idx, d in groups:
            B = _bucket(len(idx))
            be = "hash" if mc is not None else self._backend_for(B, d)
            t0 = time.perf_counter_ns()
            names = [topics[i] for i in idx]
            if mc is not None:
                enc = mc.encode(names, batch=B, depth=d)
                t1 = time.perf_counter_ns()
                res = mc.dispatch(enc)
            else:
                enc = encode_batch(self.inc, names, batch=B, depth=d)
                t1 = time.perf_counter_ns()
                res = dev.match(*dev.put_batch(*enc),
                                flat_cap=self.FLAT_MULT * B, backend=be)
            t2 = time.perf_counter_ns()
            self.dispatches += 1
            if be in JOIN_BACKENDS:
                self.join_dispatches += 1
                self._inc("tpu.match.backend_join_dispatches")
            if self._h_encode is not None:
                self._h_encode.record(t1 - t0)
                self._h_dispatch.record(t2 - t1)
            if self._ring_disp is not None:
                self._ring_disp.push(_SID_ENCODE, t0, t1 - t0, len(idx), gen)
                self._ring_disp.push(_SID_DISPATCH, t1, t2 - t1, len(idx),
                                     gen)
            handles.append((res, len(idx)))
        return handles

    @staticmethod
    def _readback_rows(res, n: int, k: int):
        """Copy a flat-mode result to the host: ``(per-row id lists,
        spilled row indices)`` for the first ``n`` rows."""
        return MatchService._slab_rows(
            *(t.cpu().numpy() for t in (res.matches, res.n_matches,
                                        res.active_overflow,
                                        res.match_overflow)), n, k)

    @staticmethod
    def _slab_rows(matches, counts, aover, mover, n: int, k: int):
        """:meth:`_readback_rows` of a slab already on the host."""
        sp = (aover > 0) | (mover > 0)
        rows = [seg.tolist() for seg in decode_flat(matches, counts, k)[:n]]
        return rows, np.flatnonzero(sp[:n]).tolist()

    @staticmethod
    def _phase2_count(total: int, flat_cap: int, mode: str,
                      auto_slack: float) -> int:
        """Ids that phase 2 of the two-phase readback copies for
        ``total`` matched ids: ``total`` (``chunked``), or its
        power-of-two capacity class (``ragged``, and ``auto`` when
        ``total`` is not a power of two and the padding is at most
        ``auto_slack``·total: the reference's rule).  At most
        ``flat_cap``: rows past the flat buffer are spilled and re-run
        on the host whatever the copy holds (the reference's chunked
        copy re-reads clamped chunks there and counts ``total``)."""
        cap = ragged_capacity(total, flat_cap)
        if mode == "ragged" or (mode == "auto" and total & (total - 1)
                                and cap - total <= auto_slack * total):
            return cap
        return min(total, flat_cap)

    @staticmethod
    def _rows_from_twophase(meta: np.ndarray, ids: np.ndarray, n: int,
                            k: int):
        """``(per-row id lists, spilled row indices)`` of the first
        ``n`` rows from a ``row_meta`` vector and the head of the flat
        buffer copied after it (at least the first Σcounts ids; the
        real rows precede the padding rows by the cumsum-offset
        construction)."""
        nk, sp = decode_row_meta(meta)
        nk = np.minimum(nk, k)[:n].tolist()
        flat = ids[:sum(nk)].tolist()
        rows = []
        o = 0
        for c in nk:
            rows.append(flat[o:o + c])
            o += c
        return rows, np.flatnonzero(sp[:n]).tolist()

    def _readback_groups(self, handles, t0: Optional[int] = None):
        """Every group's slab readback (the flat buffer, the counts and
        both overflow vectors, as the reference reads them on its
        fixed-window ``chunked`` path; a mesh dispatch's dense compact
        result, in one wait): ``([(rows, spilled)...], bytes copied,
        copies waited on)``.  ``t0`` (ns) starts the readback span."""
        out = []
        nbytes = 0
        k = self.dev.max_matches
        t0 = time.perf_counter_ns() if t0 is None else t0
        for res, n in handles:
            if isinstance(res, McHandle):
                rows, sp, b = self.mc.readback(res, n)
                out.append((rows, sp))
                nbytes += b
                continue
            out.append(self._readback_rows(res, n, k))
            nbytes += 4 * (res.matches.numel() + 3 * res.n_matches.numel())
        self._rec_readback(t0, handles)
        return out, nbytes, len(handles)

    async def _mc_readback(self, handles):
        """The readback of mesh dispatches: each handle's events polled
        between rounds of the loop, then :meth:`_readback_groups`.
        Returns ``([(rows, spilled)...], bytes, seconds, waits)``."""
        t0 = time.perf_counter_ns()
        for h, _n in handles:
            await _events_done(h.events)
        out, nbytes, trips = self._readback_groups(handles, t0)
        return out, nbytes, (time.perf_counter_ns() - t0) * 1e-9, trips

    def _rec_readback(self, t0: int, handles) -> None:
        """Record a batch's readback span, from ``t0`` (ns) to now."""
        if self._h_readback is None and self._ring_rb is None:
            return
        rb_ns = time.perf_counter_ns() - t0
        if self._h_readback is not None:
            self._h_readback.record(rb_ns)
        if self._ring_rb is not None:
            self._ring_rb.push(_SID_READBACK, t0, rb_ns,
                               sum(n for _res, n in handles),
                               self._table_gen)

    def _deep_ids(self, topic: str) -> List[int]:
        if not self._deep:
            return []
        return [self._deep[f] for f in self._deep_trie.match(topic)]

    def _host_ids(self, topic: str) -> List[int]:
        return self.inc.match_host(topic) + self._deep_ids(topic)

    def _collect_rows(self, topics: List[str], groups, results,
                      reuses0: Optional[int] = None, gen0: int = 0):
        """Stitch group results back into batch order, re-run spilled
        rows on the host tables and merge too-deep filter hits.  With
        ``reuses0`` and ``gen0`` (the table's ``aid_reuses`` and the
        service's table generation when the batch was dispatched), raise
        :class:`_StaleRace` when an id was reused or the table replaced
        since."""
        rows: List[List[int]] = [[] for _ in topics]
        spilled: List[int] = []
        for (idx, _d), (grows, gspill) in zip(groups, results):
            for j, i in enumerate(idx):
                rows[i] = grows[j]
            spilled.extend(idx[j] for j in gspill)
        if reuses0 is not None and (self._table_gen != gen0
                                    or self.inc.aid_reuses != reuses0):
            raise _StaleRace("accept id reused or table replaced mid-flight")
        self._inc("tpu.match.batches", len(groups))
        for r in spilled:
            rows[r] = self._host_ids(topics[r])
        self._inc("tpu.match.fallback_host", len(spilled))
        spset = set(spilled)
        mc = self.mc
        if mc is not None and mc.degraded_serving:
            # replicated rows lost the dead shard's segment: add exactly
            # its filters from the host (a routed row never holds one:
            # the dead owner's rows were spilled)
            fill = mc.dead_aids()
            if fill:
                filled = 0
                for r, t in enumerate(topics):
                    if r in spset:
                        continue
                    add = [a for a in self._host_ids(t) if a in fill]
                    if add:
                        rows[r].extend(add)
                        filled += 1
                if filled:
                    mc.cpu_filled_rows += filled
                    self._inc("tpu.mesh.cpu_filled_rows", filled)
            self._mesh_watch()
        if self._deep:
            for r, t in enumerate(topics):
                if r not in spset:
                    rows[r].extend(self._deep_ids(t))
        self._inc("tpu.match.topics", len(topics))
        if spilled:
            self._inc("tpu.match.active_overflow", len(spilled))
        self.batches += len(groups)
        self.topics += len(topics)
        self.fallback_host += len(spilled)
        return rows

    def _split_row(self, row: List[int]) -> Tuple[List[str], List[str]]:
        """Accept-id row → (routing wildcard filters, rule ids), from the
        host maps (an id freed by a remove and reused by a later add maps
        to the filter that holds it now, as the reference's accept table
        does)."""
        filters = [f for f in map(self._filter_of.__getitem__, row)
                   if f is not None]
        if not self._aid_rules:
            return filters, []
        rules: Set[str] = set()
        for aid in row:
            r = self._aid_rules.get(aid)
            if r:
                rules.update(r)
        return filters, sorted(rules)

    # -- backend routing (backend="auto") ----------------------------------

    def _backend_for(self, b: int, d: int) -> str:
        """The walk that serves a (batch, depth) group: the pinned
        backend, or under ``auto`` the autotuner's measured pick for the
        current table shape (exact, else its pow2 family's consensus).
        An unmeasured shape serves hash and queues one measurement
        (:meth:`_autotune_queued`, after the batch)."""
        if self.backend != "auto":
            return self.backend
        t = self.tuner
        if t is None:
            return "hash"
        s, hb, _depth = self.inc.shape_key()
        pick = t.pick_for(b, d, s, hb)
        if pick is not None:
            return pick
        sig = t.sig(b, d, s, hb)
        if sig not in self._tuning and self._topic_sample:
            self._tuning.add(sig)
            self._tune_queue.append((sig, b, d))
        return "hash"

    def _autotune_queued(self) -> None:
        """Run the queued measurements (after a batch: its waiters are
        already resolved)."""
        while self._tune_queue:
            self._autotune_measure(*self._tune_queue.pop(0))

    def _autotune_measure(self, sig: str, b: int, d: int) -> None:
        """Time hash against join on recently served topics at exactly
        the dispatch shape, and record the pick.  Each time is the
        device time of one flat match (:meth:`_timed_match`): the topics
        are encoded and copied to the device once, before the clock.  A
        failure leaves
        the default routing; the shape is measured again at a later
        dispatch."""
        try:
            topics = list(self._topic_sample)
            names = (topics * (b // len(topics) + 1))[:b]
            dev = self.dev
            ops = dev.put_batch(*encode_batch(self.inc, names, batch=b,
                                              depth=d))
            self.tuner.measure(sig, {
                be: (lambda be=be: self._timed_match(ops, b, be))
                for be in ("hash", "join")})
            self._inc("tpu.match.autotune_picks")
        except Exception:
            log.debug("autotune measurement for %s failed", sig,
                      exc_info=True)
            self._tuning.discard(sig)

    def _timed_match(self, ops, b: int, backend: str) -> float:
        """Seconds of one flat match of ``ops`` on ``backend`` (the walk
        and its epilogue).  On the card: between two CUDA events,
        enqueued behind a spin of about a millisecond
        (``torch.cuda._sleep``) that keeps the card busy while the host
        enqueues them, so the host's launch cost stays out; on the CPU
        the host clock around the plain version."""
        dev = self.dev
        kw = dict(flat_cap=self.FLAT_MULT * b, backend=backend)
        self.autotune_launches += 1
        if dev.device.type != "cuda":
            t0 = time.perf_counter()
            dev.match(*ops, **kw).n_matches.numpy()
            return time.perf_counter() - t0
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(_SPIN_CYCLES)
        t0.record()
        dev.match(*ops, **kw)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / 1e3

    # -- the serve loop: lifecycle -------------------------------------------

    async def start(self) -> None:
        """Bootstrap the mirror from the router (from a segment first,
        with ``segments``), freeze the started heap and start the sync
        loop, the serve loop (``_deadline_loop`` with ``deadline``, else
        ``_batch_loop``) and, as configured, the readback and compaction
        loops; ``ready`` turns true after the first sync and ``_warm``."""
        if self.broker is None:
            raise RuntimeError("start() needs MatchService(broker, ...)")
        self._running = True
        self._bootstrap()
        if self.mc is not None:
            # seed the partition: the per-shard segments when the table
            # cold-started from its segment and the epochs agree, else a
            # repartition from the live accept ids
            if not (self.segments and self._segment_loaded
                    and self.mc.load_segments(self.segments_dir,
                                              self.inc.epoch)):
                self.mc.rebuild(self._mc_pairs())
        # what is live now stays live for the node's life: spare the
        # full collections the walk over it (objects made later are
        # collected as usual; stop() leaves the heap frozen)
        gc.collect()
        gc.freeze()
        self._frozen_filters = len(self._ref)
        loops = [("match.sync", self._sync_loop),
                 ("match.batch", self._deadline_loop if self.deadline
                  else self._batch_loop)]
        if self.pipeline:
            # the queue bounds the slots waiting for the readback task;
            # with the one it holds, at most pipeline_depth batches sit
            # past dispatch (2: double buffering)
            self._inflight_q = asyncio.Queue(
                maxsize=max(1, self.pipeline_depth - 1))
            loops.append(("match.readback", self._readback_loop))
        if self.segments:
            loops.append(("table.compact", self._compact_loop))
            if self.dev.device.type == "cuda":
                # the compaction's upload stream, made before serving: a
                # process's first CUDA stream waits for the work queued
                # on the card, which would hold a build behind a hang
                self._build_stream = torch.cuda.Stream(self.dev.device)
        sup = self.supervisor
        # supervised (the node's): a crashed loop restarts instead of
        # freezing hint freshness or the waiters until the node restarts
        self._tasks = [sup.start_child(name, fn) if sup is not None
                       else asyncio.ensure_future(fn())
                       for name, fn in loops]
        if self._segment_loaded and getattr(
                self.inc, "_pending_trie", None) is not None:
            # link the restored trie in the background, so that the
            # first mutation does not pay for it on the loop
            self._tasks.append(
                sup.start_child("table.hydrate", self._hydrate_loop,
                                restart="temporary") if sup is not None
                else asyncio.ensure_future(self._hydrate_loop()))
        self._mark_dirty()

    async def _hydrate_loop(self) -> None:
        await asyncio.to_thread(self.inc._hydrate)

    async def stop(self) -> None:
        """Stop the loops (waiters in flight, those of pipelined slots
        too, fail over to the host trie at once) and unhook from the
        router."""
        self.ready = False
        self._running = False
        tasks = self._tasks
        if self._probe_child is not None:
            tasks = tasks + [self._probe_child]
            self._probe_child = None
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        self._tasks = []
        try:
            self.router.listeners.remove(self._on_router_mutation)
        except ValueError:
            pass  # already unhooked (double stop is legal)

    # -- the serve loop: mirror maintenance (event loop) ---------------------

    def _mark_dirty(self) -> None:
        if not self._dirty.is_set():
            self._dirty_since = time.monotonic()
        self._dirty.set()

    def _on_router_mutation(self, epoch: int) -> None:
        # no hint invalidation here: freshness is proven per topic at
        # consume time against the delta log (_hint_fresh)
        self._mark_dirty()

    def _add(self, flt: str) -> None:
        n = self._ref.get(flt, 0)
        self._ref[flt] = n + 1
        if n == 0:
            self._table_add(flt, routing=True)

    def _del(self, flt: str) -> None:
        n = self._ref.get(flt, 0)
        if n <= 1:
            self._ref.pop(flt, None)
            if n == 1:
                self._table_del(flt, routing=True)
        else:
            self._ref[flt] = n - 1

    def _bootstrap(self) -> None:
        """Full resnapshot from the router (cold start, delta-log gap).
        Refcounts seed from the router's live destination count, so a
        filter restored with several routes survives the deletion of all
        but one of them.  An empty, never synced native table takes the
        router's filters in one bulk build.  With ``segments`` the first
        bootstrap tries the segment (:meth:`_load_segment`) first."""
        if self.segments and not self._segment_tried:
            self._segment_tried = True
            if self._load_segment():
                return
        wild = self.router.wildcard_filters()
        self._ref = {flt: max(1, len(self.router.routes_of(flt)))
                     for flt in wild}
        if self.table_kind == "native" and self._fresh() and wild:
            self._bulk_start(wild)
        else:
            for flt in wild:
                self._table_add(flt, routing=True)
        self._seen_epoch = self.router.epoch

    # -- segments and compaction (segments=True) ----------------------------

    @property
    def _segment_path(self) -> str:
        return os.path.join(self.segments_dir, SEGMENT_FILE)

    def _load_segment(self) -> bool:
        """Cold start from the segment: restore the table and its id
        bookkeeping, then :meth:`_reconcile_with_router`.  False (the
        full rebuild serves, from a fresh table) on any defect: no file,
        a rejected checksum or version, another depth, an injected
        ``table.load`` fault."""
        path = self._segment_path
        if not os.path.exists(path):
            return False
        t0 = time.perf_counter()
        saved = (self.inc, self.dev, self._deep, self._deep_trie,
                 self._filter_of)
        try:
            if _fi._injector is not None and \
                    _fi._injector.act("table.load") == "raise":
                raise SegmentError("injected table.load fault")
            seg = load_segment(path)
            if seg.depth != self.depth:
                raise SegmentError(f"segment depth {seg.depth} != table "
                                   f"depth {self.depth}")
            self._deep, self._deep_trie = {}, FilterTrie()
            state = seg.kind == "state" and self.table_kind == "python"
            if state:
                inc = restore_incremental(seg)
                self._deep = dict(seg.deep)
                for flt in self._deep:
                    self._deep_trie.insert(flt)
                fo = self._filter_of = [None] * len(inc.accept_filters)
                for aid in seg.routing_aids:
                    fo[aid] = inc.accept_filters[aid]
                if seg.join_start is not None:
                    # seeds the join relation at the first upload, when
                    # no mutation moved the table since the segment
                    self._seg_join_seed = (
                        seg.epoch, (int(seg.node_tab.shape[0]),
                                    int(seg.edge_tab.shape[0]), seg.depth),
                        (seg.join_start, seg.join_word, seg.join_next))
                self._install_table(inc)
            elif self.table_kind == "native":
                # the filter blob through one bulk build
                self._filter_of = []
                self._bulk_start(seg.filters)
            else:
                self._filter_of = []
                self._install_table(IncrementalNfa(depth=self.depth))
                for flt in seg.filters:
                    self._table_add(flt, routing=True)
            if not state:
                for flt in seg.deep:
                    self._table_add(flt, routing=True)
            self._reconcile_with_router(set(seg.filters) | set(seg.deep))
        except Exception as exc:
            (self.inc, self.dev, self._deep, self._deep_trie,
             self._filter_of) = saved
            self._seg_join_seed = None
            if isinstance(exc, SegmentError):
                log.warning("segment %s rejected; the full rebuild serves",
                            path, exc_info=True)
            else:
                log.exception("segment load failed; the full rebuild "
                              "serves")
            return False
        self._segment_loaded = True
        self._mut_count = 0
        took = time.perf_counter() - t0
        if self.metrics is not None:
            self.metrics.set("tpu.table.segment_load_s", round(took, 4))
        log.info("match table cold-started from segment %s (%d filters, "
                 "%.1f ms)", path, self.inc.n_filters, took * 1e3)
        return True

    def _install_table(self, inc) -> None:
        """Serve from host table ``inc`` with a fresh device twin."""
        self.inc = inc
        self._table_gen += 1
        self.dev = self._bind_device(inc, self.dev.active_slots,
                                     self.dev.max_matches, self.dev.device)

    def _reconcile_with_router(self, table_set: Set[str]) -> None:
        """Replay the difference between a restored table and the live
        router: only the filters that changed since the segment pay a
        table mutation.  The table's routing marks are the segment's
        (for a filter the router still routes), the router's filters it
        lacks are added, and the filters it no longer routes go (no rule
        is registered at a cold start)."""
        routed = self.router.wildcard_filters()
        routed_set = set(routed)
        self._ref = {flt: max(1, len(self.router.routes_of(flt)))
                     for flt in routed}
        for flt in routed_set - table_set:
            self._table_add(flt, routing=True)
        for flt in table_set - routed_set:
            self._table_del(flt, routing=True)
        self._seen_epoch = self.router.epoch

    async def _compact_loop(self) -> None:
        """The ``table.compact`` child: every ``compact_interval_s``, once
        ``compact_min_mutations`` mutations piled up (or there is no
        segment yet), one :meth:`_compact_once`; a failed cycle leaves
        the live table serving and is tried again next interval."""
        while True:
            await asyncio.sleep(self.compact_interval_s)
            if not self.ready:
                continue
            if self._mut_count < self.compact_min_mutations \
                    and os.path.exists(self._segment_path):
                continue
            try:
                await self._compact_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("table compaction failed; tried again next "
                              "interval")

    def _snapshot_filters(self) -> Tuple[List[str], Set[str], List[str]]:
        """(routing filters, rule filters, too-deep filters): copies of
        the service's own maps, cheap enough for the loop."""
        ruled = {f for refs in self._rule_refs.values() for f in refs}
        return list(self._ref), ruled, list(self._deep)

    async def _compact_once(self) -> bool:
        """One compaction: the snapshot, the build and the segment on a
        worker thread (:func:`_build_compacted`), then :meth:`_swap_in`
        on the loop.  False when abandoned (more than
        ``COMPACT_DIRTY_MAX`` filters changed during the build)."""
        routing, ruled, deep_filters = self._snapshot_filters()
        self.compact_steps = []
        self._compact_dirty = set()
        self._compact_recording = True
        dev = self.dev
        serving = (torch.cuda.current_stream(dev.device)
                   if dev.device.type == "cuda" else None)
        try:
            built = await asyncio.to_thread(
                _yielding_call, _build_compacted, self.table_kind,
                self.depth, routing, ruled, deep_filters, dev.active_slots,
                dev.max_matches, dev.device, self._build_stream, serving,
                self.dirty_threshold, self._segment_path,
                self.backend in JOIN_BACKENDS or self.backend == "auto",
                self.compact_steps)
        finally:
            self._compact_recording = False
        if len(self._compact_dirty) > COMPACT_DIRTY_MAX:
            # the live table is right, only the compaction is stale
            self._compact_abandoned += 1
            log.warning("table compaction abandoned: %d filters changed "
                        "during the build", len(self._compact_dirty))
            return False
        mc = self.mc
        if mc is not None and mc.ep_autotune:
            # the popularity pass stages a placement that the swap's
            # repartition applies; a failure (an injected ep.rebalance
            # fault too) keeps the old placement
            try:
                await asyncio.to_thread(mc.plan_rebalance)
            except Exception:
                log.warning("EP balance pass failed; placement unchanged",
                            exc_info=True)
        self._swap_in(built)
        return True

    def _swap_in(self, built) -> None:
        """Swap the compacted table and its device twin in, in one step
        of the loop.  The ``table.swap`` seam fires before anything
        changes, so that a kill there leaves the old table serving.
        Then the filters changed during the build are fixed up in the
        fresh table and written to its device twin (on the serving
        stream, after the build's upload event), the rule ids are
        remapped into the fresh accept ids, and the table generation is
        bumped: a slot in flight named ids of the old table and is
        answered by the host (``_StaleRace``).  Hints survive: they hold
        router epochs and filter strings.  The fresh twin holds no freed
        id for a slot."""
        if _fi._injector is not None and \
                _fi._injector.act("table.swap") == "raise":
            raise _fi.InjectedFault("table.swap")
        fresh, newdev, new_deep, filter_of, event = built
        ruled = {f for refs in self._rule_refs.values() for f in refs}
        for flt in self._compact_dirty:
            routed = flt in self._ref
            aid = new_deep.get(flt, fresh.aid_of(flt))
            if (routed or flt in ruled) and aid < 0:
                try:
                    fresh.add(flt)
                    aid = fresh.aid_of(flt)
                except ValueError:      # deeper than the table
                    aid = new_deep[flt] = fresh.alloc_alias(flt)
            elif not (routed or flt in ruled):
                if aid >= 0:
                    if flt in new_deep:
                        fresh.free_alias(new_deep.pop(flt))
                    else:
                        fresh.remove(flt)
                    if aid < len(filter_of):
                        filter_of[aid] = None
                continue
            if aid >= len(filter_of):
                filter_of.extend([None] * (aid + 1 - len(filter_of)))
            filter_of[aid] = flt if routed else None
        if event is not None:
            torch.cuda.current_stream(newdev.device).wait_event(event)
        if self._compact_dirty:
            newdev.apply_pending(newdev.drain())
        new_aid_rules: Dict[int, Set[str]] = {}
        for rule_id, refs in self._rule_refs.items():
            for flt in refs:
                aid = new_deep.get(flt, fresh.aid_of(flt))
                if aid >= 0:
                    new_aid_rules.setdefault(aid, set()).add(rule_id)
        trie = FilterTrie()
        for flt in new_deep:
            trie.insert(flt)
        self.inc, self.dev = fresh, newdev
        self._deep, self._deep_trie = new_deep, trie
        self._filter_of = filter_of
        self._aid_rules = new_aid_rules
        self._table_gen += 1
        self._synced_epoch = self._seen_epoch
        self._synced_rule_gen = self._rule_gen
        self._mut_count = len(self._compact_dirty)
        self._compact_dirty = set()
        self.ready = True
        if self.mc is not None:
            # every accept id was reassigned: repartition from the fresh
            # space (the single device serves until it applies)
            self.mc.rebuild(self._mc_pairs())
            self._mark_dirty()
        self._inc("tpu.table.compact_runs")
        log.info("compacted table swapped in (gen %d, %d filters)",
                 self._table_gen, fresh.n_filters)

    def _drain_router(self) -> None:
        deltas = self.router.deltas_since(self._seen_epoch)
        if deltas is None:
            log.info("router delta log gap: full mirror resnapshot")
            for flt in list(self._ref):
                self._table_del(flt, routing=True)
            self._bootstrap()
            return
        for d in deltas:
            if not T.wildcard(d.filter):
                continue  # exact filters stay in the router's hash map
            if d.op == "add":
                self._add(d.filter)
            else:
                self._del(d.filter)
        self._seen_epoch = self.router.epoch

    async def _sync_loop(self) -> None:
        while True:
            await self._dirty.wait()
            wait = self.debounce_s - (time.monotonic() - self._dirty_since)
            if wait > 0 and self.router.epoch - self._synced_epoch \
                    < self.max_stale_deltas // 4:
                # coalesce a burst, counted from its first mutation; a
                # mirror already this far behind syncs at once.  On a
                # busy loop the wake comes a round late and the debounce
                # has run out: a sleep would cost one more round, while
                # the churn goes on past max_stale_deltas
                await asyncio.sleep(wait)
            self._dirty.clear()
            try:
                first = not self.ready
                self._drain_router()
                # epochs the device table reflects once this sync lands
                router_epoch = self._seen_epoch
                rule_gen = self._rule_gen
                pending = self.dev.drain(full=first)
                if pending.full is not None:
                    # a whole upload: publishes take the host path until
                    # the new tables are resident and walked once
                    self.ready = False
                    await asyncio.to_thread(self.dev.apply_pending, pending)
                    await asyncio.to_thread(self._warm)
                else:
                    # row writes, or a relation sorted anew on the
                    # device: milliseconds, on the loop (on a worker
                    # thread each GIL hand-off waits out a busy loop's
                    # switch interval, and the mirror fell past
                    # max_stale_deltas under a steady churn)
                    self.dev.apply_pending(pending)
                if self.mc is not None:
                    if self.mc.dirty:
                        # the partition applies in step with the table;
                        # a repartition builds every table: off the loop
                        if self.mc.heavy:
                            await asyncio.to_thread(self._mc_apply)
                        else:
                            self._mc_apply()
                    self._mesh_watch()
                self.ready = True
                self._synced_epoch = router_epoch
                self._synced_rule_gen = rule_gen
                self._inc("tpu.mirror.refresh")
                if pending.full is not None:
                    self._inc("tpu.mirror.recompile")
                elif pending.delta is not None and not pending.delta.empty:
                    self._inc("tpu.mirror.delta_applied")
                if self.segments and self.metrics is not None:
                    self.metrics.set("tpu.table.dirty_rows_uploaded",
                                     self.dev.dirty_rows_uploaded)
                self.sync_error = None
                self._freeze_growth()
            except Exception as exc:
                # kept for the node, whose start() raises on it
                self.sync_error = exc
                log.exception("match-service sync failed; host path serves")
                await asyncio.sleep(1.0)
                self._mark_dirty()

    #: a sync that leaves this many more live wildcard filters than the
    #: last freeze freezes the heap again
    FREEZE_GROWTH = 65536

    def _freeze_growth(self) -> None:
        """After a sync: once the mirror has grown ``FREEZE_GROWTH``
        filters past the last freeze, what the growth made (sessions,
        routes, trie nodes, table entries) joins the collector's
        permanent generation.  No collection first: over a heap that
        grew by a fleet it would be the seconds-long pause that the
        freeze spares the loop; what is garbage now merely stays."""
        n = len(self._ref)
        if n - self._frozen_filters >= self.FREEZE_GROWTH:
            gc.freeze()
            self._frozen_filters = n
            self.freezes += 1

    def _warm(self) -> None:
        """Before ``ready``: build and load the CUDA kernel of every walk
        the backend can pick (one ``nvcc`` each, started together), then
        run one flat walk at batch 64 for each serve depth, so that no
        served batch waits on a compiler or a first launch.  On the CPU
        the plain walks run.  A failure keeps ``ready`` false."""
        if _fi._injector is not None:
            act = _fi._injector.act("match.compile")
            if act == "raise":
                raise _fi.InjectedFault("match.compile")
            if act == "delay":
                time.sleep(_fi._injector.last_delay)
        backends = (("hash", "join") if self.backend == "auto"
                    else (self.backend,))
        dev = self.dev
        if dev.device.type == "cuda":
            cuda_build.build(sorted({BACKEND_KERNELS[be] for be in backends}))
        depths = [self.depth]
        if self.short_depth and self.short_depth < self.depth:
            depths.append(self.short_depth)
        for be in backends:
            for d in depths:
                # an empty batch of 64 rows, as encode_batch pads it
                words = np.zeros((64, d), np.int32)
                lens = np.full(64, d + 2, np.int32)
                is_sys = np.ones(64, bool)
                res = dev.match(*dev.put_batch(words, lens, is_sys),
                                flat_cap=self.FLAT_MULT * 64, backend=be)
                res.n_matches.cpu()

    # -- the multichip serve backend (multichip=True) ---------------------------

    def _mc_pairs(self) -> List[Tuple[str, int]]:
        """``(filter, accept id)`` of every filter the table holds
        (routing and rules; too-deep aliases stay with the host trie):
        the repartition's input."""
        out = [(f, aid) for aid, f in enumerate(self._filter_of)
               if f is not None and f not in self._deep]
        ruled = {f for refs in self._rule_refs.values() for f in refs}
        for f in ruled:
            aid = self.inc.aid_of(f)
            if aid >= 0 and f not in self._deep and \
                    self._filter_of[aid] is None:
                out.append((f, aid))
        return out

    def _mc_apply(self) -> None:
        """Fold the noted mutations (or a queued repartition) into the
        shard tables; after the first, warm the mesh's serve shapes;
        with segments, persist the partition when it changed.  A failure
        leaves the single device serving; the next sync tries again."""
        mc = self.mc
        try:
            first = not mc.ready
            if mc.apply_pending() and first:
                depths = ((self.short_depth, self.depth)
                          if self.short_depth
                          and self.short_depth < self.depth
                          else (self.depth,))
                mc.warm(batches=(64,), depths=depths)
            if self.segments and mc._persist_due:
                mc.save_segments(self.segments_dir, self.inc.epoch)
        except Exception:
            log.exception("multichip apply failed; the single device "
                          "serves")

    def _mc_active(self) -> Optional[MultichipMatcher]:
        """The matcher when it may serve the next dispatch, else None."""
        mc = self.mc
        return mc if mc is not None and mc.ready else None

    def _mesh_watch(self) -> None:
        """Reconcile the degraded mesh's ladder with the alarm, the
        flight recorder and the rebuild child: called after a shard
        failure surfaces and from the sync loop; one attribute walk when
        healthy."""
        mc = self.mc
        if mc is None or not mc.degraded:
            return
        dead = mc.dead_shards
        if self.metrics is not None:
            self.metrics.set("tpu.mesh.state", mc.mesh_state())
        if dead and not self._mesh_alarmed:
            self._mesh_alarmed = True
            if self.alarms is not None:
                self.alarms.activate(
                    "mesh_degraded", {"dead_shards": list(dead),
                                      "tp": mc.tp},
                    "mesh shard(s) dead; degraded serving with host fill")
            if self.flightrec is not None:
                self.flightrec.dump("mesh_degraded")
        elif not dead and self._mesh_alarmed:
            self._mesh_alarmed = False
            if self.alarms is not None:
                self.alarms.deactivate("mesh_degraded")
        if dead and not self._mesh_rebuilding:
            self._mesh_rebuilding = True
            sup = self.supervisor
            if sup is not None:
                # a crashing rebuild restarts instead of leaving the
                # shard out for good
                sup.start_child("mesh.rebuild", self._mesh_rebuild_loop,
                                restart="transient")
            else:
                try:
                    self._tasks.append(
                        asyncio.ensure_future(self._mesh_rebuild_loop()))
                except RuntimeError:
                    # no running loop: the next watch on the loop starts it
                    self._mesh_rebuilding = False

    async def _mesh_rebuild_loop(self) -> None:
        """Online shard rebuild (a transient supervised child): lowest
        dead shard first, rebuilt off the serve path, canaried against
        the host tables and re-admitted only on bit parity.  A crash (an
        injected ``mesh.rebuild`` fault too) restarts the child, and the
        rebuild starts over; a clean return means every shard is live."""
        mc = self.mc
        while self._running and mc is not None and mc.dead_shards:
            t = mc.dead_shards[0]
            await asyncio.to_thread(
                mc.rebuild_shard, t, self._mc_pairs(),
                self.segments_dir if self.segments else None,
                self.inc.epoch)
            if not await self._mesh_canary(t):
                mc.readmit_canary_fails += 1
                self._inc("tpu.mesh.readmit_canary_fails")
                log.error("mesh shard %d rebuild canary failed; the shard "
                          "stays out", t)
                await asyncio.sleep(0.05)
                continue
            mc.revive_shard(t)
            # slots dispatched on the degraded plane are answered by the
            # host (the table-generation guard), with no breaker strike
            self._table_gen += 1
            log.warning("mesh shard %d rebuilt and re-admitted (canary "
                        "passed)", t)
        self._mesh_rebuilding = False
        self._mesh_watch()

    async def _mesh_canary(self, t: int) -> bool:
        """The bit-parity canary of shard ``t``'s re-admission: topics
        of its own filters through the mesh with ``t`` live, each row
        against the host tables (the other dead shards' filters, which
        the degraded plane fills in from the host, credited).  True only
        when at least one row was checked and every checked row
        matched."""
        mc = self.mc
        topics = mc.canary_topics(t)
        if not topics:
            return True     # the shard owns nothing
        try:
            rows, spilled = await asyncio.to_thread(
                mc.canary_rows, topics, _bucket(len(topics)), t)
        except Exception:
            log.exception("mesh canary dispatch for shard %d failed", t)
            return False
        fill = mc.dead_aids(exclude=t)
        sp = set(spilled)
        checked = 0
        for i, topic in enumerate(topics):
            if i in sp:
                continue
            host = set(self._host_ids(topic))
            if set(rows[i]) | (host & fill) != host:
                log.error("mesh canary mismatch on %r (shard %d)", topic, t)
                return False
            checked += 1
        return checked > 0

    def mesh_info(self) -> Optional[Dict[str, Any]]:
        """The mesh's health snapshot; None without the backend."""
        mc = self.mc
        if mc is None:
            return None
        out = mc.info()
        out["alarmed"] = self._mesh_alarmed
        out["rebuilding"] = self._mesh_rebuilding
        return out

    # -- rule co-batching ------------------------------------------------------

    def register_rule(self, rule_id: str, from_filters: List[str]) -> None:
        """Co-batch a rule's FROM filters into the device table."""
        self.unregister_rule(rule_id)
        refs: Dict[str, int] = {}
        for flt in from_filters:
            refs[flt] = 1
            aid = self._table_add(flt, routing=False)
            self._aid_rules.setdefault(aid, set()).add(rule_id)
        self._rule_refs[rule_id] = refs
        self._rule_gen += 1
        self._rule_log.append((self._rule_gen, tuple(from_filters)))
        self._mark_dirty()

    def unregister_rule(self, rule_id: str) -> None:
        refs = self._rule_refs.pop(rule_id, None)
        if not refs:
            return
        for flt in refs:
            aid = self._aid(flt)
            if aid < 0:
                continue
            rules = self._aid_rules.get(aid)
            if rules is not None:
                rules.discard(rule_id)
                if not rules:
                    del self._aid_rules[aid]
            self._table_del(flt, routing=False)
        # removal-only entry: stale hints that still name the rule are
        # harmless (the engine skips ids not in its live rule map)
        self._rule_gen += 1
        self._rule_log.append((self._rule_gen, ()))
        self._mark_dirty()

    # -- the serve loop: hints -------------------------------------------------

    def _usable(self) -> bool:
        return (self.ready and self.router.epoch - self._synced_epoch
                <= self.max_stale_deltas)

    def _hint_fresh(self, topic: str, hint_epoch: int) -> bool:
        """Prove a hint still answers correctly for ``topic``: deletions
        never need invalidation (destinations resolve live in
        ``routes_with_wild``); only a wildcard filter ADDED after the
        hint's table epoch can make the answer incomplete.  The port
        asks a trie of the recent adds (:class:`_RecentAdds`) where the
        reference scans the delta log."""
        if hint_epoch == self.router.epoch:
            return True
        if self.router.epoch - hint_epoch > self.max_stale_deltas:
            return False  # the proof reaches this many mutations back
        return not self._recent.stale(topic, hint_epoch)

    def _proven(self, topic: str, hint) -> bool:
        """:meth:`_hint_fresh` of a cached hint.  A hint proven fresh
        through the delta log is re-stamped with the router's epoch: the
        proof holds up to now, so the next proof starts from here (the
        reference re-proves from the mint epoch on every use, up to
        ``max_stale_deltas`` matches per call, which under a steady
        churn cost more than the publish itself)."""
        epoch = self.router.epoch
        if hint[0] == epoch:
            return True
        if not self._hint_fresh(topic, hint[0]):
            return False
        self._hints[topic] = (epoch,) + hint[1:]
        return True

    def _rules_fresh(self, topic: str, hint_gen: int) -> bool:
        """Rule-side freshness: a rule registered after the hint whose
        FROM filter matches the topic invalidates it (rule changes do not
        bump the router epoch)."""
        if hint_gen == self._rule_gen:
            return True
        if self._rule_log and self._rule_log[0][0] > hint_gen + 1:
            return False  # log trimmed past the hint's gen
        for gen, filters in self._rule_log:
            if gen > hint_gen and any(T.match(topic, f) for f in filters):
                return False
        return True

    def _note_arrival(self, topic: Optional[str] = None) -> None:
        """Count an arrival in the rate window (50 ms); with
        ``deadline``, a closed window also feeds the EWMAs of the rate
        and of the share of short topics (``topic`` given)."""
        now = time.monotonic()
        dt = now - self._win_start
        if dt >= 0.05:
            self._last_rate = self._win_count / dt
            if self.deadline:
                a = 0.5
                self._rate_ewma = (
                    self._last_rate if self._rate_ewma is None
                    else self._rate_ewma * (1.0 - a) + self._last_rate * a)
                frac = self._win_short / max(1, self._win_count)
                self._short_frac = (
                    frac if self._short_frac is None
                    else self._short_frac * (1.0 - a) + frac * a)
                self._win_short = 0
            self._win_start = now
            self._win_count = 0
        self._win_count += 1
        if topic is not None and self._is_short(topic):
            self._win_short += 1

    def _is_short(self, topic: str) -> bool:
        return topic.count("/") < self.short_depth

    def _should_bypass(self) -> bool:
        if self.bypass_rate <= 0:
            return False
        return not self._pending and self._last_rate < self.bypass_rate

    async def prefetch(self, topic: str, qos: int = 0) -> None:
        """Async stage (connection intercept): micro-batch this topic
        through the walk and park the answer in the hint cache.  Bounded
        by ``prefetch_timeout_s``: a stalled device degrades to the host
        path, never blocks publishes indefinitely.  With ``deadline`` the
        waiter carries its budget, and an open breaker or the brownout
        (stage 3, or stage 2 for ``qos`` 0) leaves the topic to the host
        trie at once."""
        self._note_arrival(topic if self.deadline else None)
        if not self._usable():
            return
        hint = self._hints.get(topic)
        if hint is not None and self._proven(topic, hint) \
                and self._rules_fresh(topic, hint[1]):
            return
        if self._should_bypass():
            self._inc("tpu.match.bypass")
            return
        loop = asyncio.get_running_loop()
        if self.deadline:
            lvl = self._brownout()
            if self._breaker_open or lvl >= 3 or (lvl >= 2 and qos == 0):
                self._inc("broker.match.cpu_fallback")
                return
        fut: asyncio.Future = loop.create_future()
        self._enqueue(topic, fut, loop.time() + self.deadline_s
                      if self.deadline else None)
        self._batch_wake.set()
        await _await_answers((fut,), self.prefetch_timeout_s,
                             "prefetch for %r timed out", topic)

    async def prefetch_many(self, topics, qos_of=None) -> None:
        """Batched prefetch (the fanout pipeline's): every topic missing
        a fresh hint is enqueued in the same event-loop tick, so the
        whole set rides one batching window.  Bounded by
        ``prefetch_timeout_s`` like :meth:`prefetch`.  ``topics`` may be
        a ``{topic: max qos}`` mapping, as the fanout passes it, which
        is then also ``qos_of``: with ``deadline`` the brownout's stage 2
        sheds the QoS0 topics to the host trie by it, and an open breaker
        or stage 3 sheds them all."""
        if not self._usable():
            return
        if qos_of is None and isinstance(topics, dict):
            qos_of = topics
        deadline = self.deadline
        lvl = self._brownout() if deadline else 0
        if deadline and (self._breaker_open or lvl >= 3):
            self._inc("broker.match.cpu_fallback", len(topics))
            return
        waits: List[asyncio.Future] = []
        loop = asyncio.get_running_loop()
        due = loop.time() + self.deadline_s if deadline else None
        shed = 0
        for topic in topics:
            self._note_arrival(topic if deadline else None)
            hint = self._hints.get(topic)
            if hint is not None and self._proven(topic, hint) \
                    and self._rules_fresh(topic, hint[1]):
                continue
            if deadline and lvl >= 2 and qos_of is not None \
                    and qos_of.get(topic, 1) == 0:
                shed += 1
                continue
            fut = loop.create_future()
            self._enqueue(topic, fut, due)
            waits.append(fut)
        if shed:
            self._inc("broker.match.cpu_fallback", shed)
        if not waits:
            return
        self._batch_wake.set()
        await _await_answers(waits, self.prefetch_timeout_s,
                             "prefetch_many (%d topics) timed out",
                             len(waits))

    def hint_available(self, topic: str) -> bool:
        """Non-consuming freshness peek: True iff a device hint would
        serve this topic right now.  No metrics, no cache mutation."""
        hint = self._hints.get(topic)
        return hint is not None and self._hint_fresh(topic, hint[0])

    def hint_routes(self, topic: str):
        """Sync stage (``Broker.device_match``): a provably fresh hint →
        its routes, else None (the host trie serves).  A hint that
        ``_cpu_serve`` minted also counts in ``hint_served_host``."""
        hint = self._hints.get(topic)
        if hint is None:
            return None
        if not self._proven(topic, hint):
            self._hints.pop(topic, None)
            self._inc("tpu.match.hint_stale")
            return None
        self._inc("tpu.match.hint_served")
        if hint[4]:
            self._inc("tpu.match.hint_served_host")
        # move to the end: dict order is the LRU order
        self._hints[topic] = self._hints.pop(topic)
        return self.router.routes_with_wild(topic, hint[2])

    def hint_rules(self, topic: str) -> Optional[List[str]]:
        """Matched rule ids of a fresh hint, else None (the rule engine
        then matches its rules on the host)."""
        hint = self._hints.get(topic)
        if hint is None:
            return None
        if not self._rules_fresh(topic, hint[1]):
            self._hints.pop(topic, None)
            self._inc("tpu.match.hint_stale")
            return None
        # a rules-only working set is as hot as a routing one
        self._hints[topic] = self._hints.pop(topic)
        return list(hint[3])

    # -- the serve loop: batches -----------------------------------------------

    def _enqueue(self, topic: str, fut: asyncio.Future,
                 due: Optional[float] = None) -> None:
        """Queue a waiter: ``(topic, future)``, then its budget's end
        (loop time, a float) on the deadline path, then, with histograms
        on, its match_wait stamp (an int; consumers index from the
        front)."""
        if not self._pending:
            self._pending_since = time.monotonic()
        entry = (topic, fut) if due is None else (topic, fut, due)
        if self._h_wait is not None:
            entry += (time.perf_counter_ns(),)
        self._pending.append(entry)

    async def _batch_loop(self) -> None:
        """The fixed-window serve loop: wake, let the batching window run
        out, pop up to ``max_batch`` waiters, one dispatch.  The window
        runs from the oldest waiter's arrival, where the reference sleeps
        it after the wake: on a busy loop the wake itself comes a whole
        round of ready tasks late, and a sleep after it costs another.
        However the loop ends, the waiters in flight fail over to the
        host path at once."""
        try:
            if self._pending:
                self._batch_wake.set()
            while True:
                await self._batch_wake.wait()
                self._batch_wake.clear()
                if not self._pending:
                    continue
                wait = self.batch_window_s - (time.monotonic()
                                              - self._pending_since)
                if wait > 0:
                    await asyncio.sleep(wait)
                pending, self._pending = self._pending[: self.max_batch], \
                    self._pending[self.max_batch:]
                if self._pending:
                    self._pending_since = time.monotonic()
                    self._batch_wake.set()
                await self._serve_batch(pending)
                self._autotune_queued()
        finally:
            self._fail_over_waiters()

    # -- the deadline serve plane (deadline=True) ------------------------------

    async def _deadline_loop(self) -> None:
        """Continuous batching under a budget: dispatch when the adaptive
        bound fills, or when the oldest waiter's remaining budget no
        longer covers the estimated dispatch time, whichever comes
        first; with the device out (breaker, brownout stage 3, a stale
        mirror) the host answers the queue at once.  However the loop
        ends, the waiters in flight fail over to the host path."""
        loop = asyncio.get_running_loop()
        try:
            if self._pending:
                self._batch_wake.set()
            while True:
                await self._batch_wake.wait()
                self._batch_wake.clear()
                while self._pending:
                    if not self._device_ok():
                        self._cpu_serve(self._pop_batch(len(self._pending)))
                        continue
                    bound = self._deadline_bound()
                    slack = (self._pending[0][2] - loop.time()
                             - self._dispatch_est())
                    if len(self._pending) < bound and slack > 0:
                        # admit more arrivals, never past the oldest
                        # budget; a geometric re-check keeps idle wakes
                        # few while a wake still ends the wait
                        wait = min(slack, max(self.batch_window_s,
                                              slack / 4))
                        try:
                            await asyncio.wait_for(self._batch_wake.wait(),
                                                   wait)
                        except asyncio.TimeoutError:
                            pass
                        self._batch_wake.clear()
                        continue
                    if len(self._pending) < bound:
                        # a partial batch the budget forced out
                        self._inc("broker.match.deadline_dispatch")
                    await self._serve_batch_deadline(self._pop_batch(bound))
                    self._autotune_queued()
        finally:
            self._fail_over_waiters()

    def _deadline_bound(self) -> int:
        """The batch bound: the arrivals of the budget left after the
        estimated dispatch, at least those of one dispatch (else the loop
        falls behind by construction) and at most ``max_batch``; the
        brownout's stage 1 halves it, stage 2 and up quarter it."""
        rate = (self._rate_ewma if self._rate_ewma is not None
                else self._last_rate)
        est = self._dispatch_est()
        headroom = max(self.deadline_s - est, self.deadline_s * 0.25)
        bound = max(1, min(self.max_batch,
                           max(int(rate * headroom), int(rate * est * 1.2))))
        lvl = self._brownout()
        if lvl:
            bound = max(1, bound >> min(lvl, 2))
        return bound

    def _lane_caps(self, bound: int) -> Tuple[int, int]:
        """(short-topic, long-topic) caps of a batch of ``bound`` from the
        observed short share, each with 25% slack, so that a deep-topic
        flood cannot take the whole bound."""
        if not self.short_depth or self.short_depth >= self.depth:
            return bound, bound
        frac = self._short_frac if self._short_frac is not None else 0.5
        short = min(bound, max(1, int(bound * frac * 1.25) + 1))
        long_ = min(bound, max(1, int(bound * (1.0 - frac) * 1.25) + 1))
        return short, long_

    def _pop_batch(self, bound: int) -> List[Any]:
        """Pop up to ``bound`` waiters from the head of the queue within
        the lane caps; a waiter whose lane is full stays queued, in order.
        The scan stops at ``4 * bound`` waiters."""
        short_cap, long_cap = self._lane_caps(bound)
        pend = self._pending
        take: List[Any] = []
        rest: List[Any] = []
        limit = min(len(pend), 4 * bound)
        pos = 0
        while pos < limit and len(take) < bound:
            entry = pend[pos]
            pos += 1
            if self._is_short(entry[0]):
                if short_cap > 0:
                    short_cap -= 1
                    take.append(entry)
                else:
                    rest.append(entry)
            elif long_cap > 0:
                long_cap -= 1
                take.append(entry)
            else:
                rest.append(entry)
        rest.extend(pend[pos:])
        self._pending = rest
        return take

    async def _serve_batch_deadline(self, pending: List[Any]) -> None:
        """One deadline dispatch: the chaos seam, encode, dispatch and
        readback under ``dispatch_timeout_s``; a failure or a timeout
        answers the batch from the host tables at once and counts toward
        the breaker (a ``_StaleRace`` does not)."""
        if not pending:
            return
        self._rec_wait(pending)
        if self._timed_out:
            self._reclaim()
        if self.pipeline:
            await self._pipeline_dispatch(pending)
            return
        topics = [p[0] for p in pending]
        epoch = self._synced_epoch
        rule_gen = self._synced_rule_gen
        t0 = time.monotonic()
        try:
            rows = await asyncio.wait_for(self._dispatch_guarded(topics),
                                          self.dispatch_timeout_s)
        except asyncio.CancelledError:
            # the loop is dying: its exit fails these waiters over
            self._pending = pending + self._pending
            raise
        except _StaleRace:
            self._cpu_serve(pending)
            return
        except Exception:
            log.debug("deadline dispatch failed; the host tables serve "
                      "the batch", exc_info=True)
            self._breaker_note_failure()
            self._cpu_serve(pending)
            return
        self._breaker_note_ok()
        self._est_dispatch_s = (self._est_dispatch_s * 0.7
                                + (time.monotonic() - t0) * 0.3)
        self._mint_hints(pending, rows, epoch, rule_gen)

    # -- the breaker and the brownout ------------------------------------------

    def _brownout(self) -> int:
        """The olp's brownout stage (0 without one); an escalation dumps
        the flight recorder once."""
        olp = self.olp
        lvl = 0 if olp is None else olp.brownout_level()
        if lvl != self._last_brownout:
            if lvl > self._last_brownout and self.flightrec is not None:
                self.flightrec.dump("brownout")
            self._last_brownout = lvl
            if self.metrics is not None:
                self.metrics.set("broker.match.brownout_level", lvl)
        return lvl

    def _device_ok(self) -> bool:
        """Whether the next dispatch may go to the device."""
        if self._breaker_open or not self._usable():
            return False
        return self._brownout() < 3

    def _breaker_note_ok(self) -> None:
        self._breaker_failures = 0

    def _breaker_note_failure(self) -> None:
        self._breaker_failures += 1
        if (not self._breaker_open
                and self._breaker_failures >= self.breaker_threshold):
            self._trip_breaker()

    def _trip_breaker(self) -> None:
        """Open the breaker: the host serves, the ``match_degraded`` alarm
        is raised, the flight recorder dumps, and the ``match.probe``
        child starts."""
        self._breaker_open = True
        self._set_breaker_metric(1)
        log.error("match-service breaker open after %d consecutive "
                  "dispatch failures; the host tables serve",
                  self._breaker_failures)
        if self.alarms is not None:
            self.alarms.activate(
                "match_degraded", {"failures": self._breaker_failures},
                "device match dispatch failing; serving from CPU trie")
        if self.flightrec is not None:
            self.flightrec.dump("breaker_trip")
        sup = self.supervisor
        self._probe_child = (
            sup.start_child("match.probe", self._probe_loop,
                            restart="transient") if sup is not None
            else asyncio.ensure_future(self._probe_loop()))

    def _close_breaker(self) -> None:
        self._breaker_open = False
        self._breaker_failures = 0
        self._set_breaker_metric(0)
        log.warning("match-service breaker closed: device dispatch "
                    "healthy again")
        if self.alarms is not None:
            self.alarms.deactivate("match_degraded")

    def _set_breaker_metric(self, state: int) -> None:
        if self.metrics is not None:
            self.metrics.set("broker.match.breaker_state", state)

    async def _probe_loop(self) -> None:
        """Breaker recovery: every ``breaker_probe_interval_s`` one probe
        batch through the dispatch seam, under the dispatch timeout; the
        first that gets through closes the breaker and ends the child."""
        while self._running and self._breaker_open:
            await asyncio.sleep(self.breaker_probe_interval_s)
            if not self._running:
                return
            self._set_breaker_metric(2)
            try:
                await asyncio.wait_for(self._probe_guarded(),
                                       self.dispatch_timeout_s)
            except asyncio.CancelledError:
                raise
            except Exception:
                log.debug("match breaker probe failed; staying open",
                          exc_info=True)
                self._set_breaker_metric(1)
                continue
            self._close_breaker()
            return

    async def _probe_guarded(self) -> None:
        await self._fault_gate()
        await self._probe_dispatch()

    async def _probe_dispatch(self) -> None:
        """One topic through the warmed shape, encode to readback, with
        no serving counter touched.  Refused, without a launch, while a
        batch that timed out still runs on the card: a probe behind it
        would time out too, and the probes would pile up on the
        stream."""
        self._reclaim()
        if self._timed_out:
            raise RuntimeError("a timed-out batch still runs on the card")
        mc = self._mc_active()
        if mc is not None:
            # through the mesh: a dead shard keeps the breaker open
            h = mc.dispatch(mc.encode(["probe/health"], batch=64))
            await _events_done(h.events)
            mc.readback(h, 1)
            return
        dev = self.dev
        res = dev.match(*dev.put_batch(*encode_batch(
            self.inc, ["probe/health"], batch=64, depth=self.depth)),
            flat_cap=self.FLAT_MULT * 64)
        ev = _record_event(dev.device)
        try:
            await _event_done(ev)
        except asyncio.CancelledError:
            if ev is not None and not ev.query():
                self._timed_out.append((ev, res))
            raise
        self._readback_rows(res, 1, dev.max_matches)

    def _reclaim(self) -> None:
        """Give back what the timed-out batches whose events completed
        held: their pinned buffer pairs return to the free list."""
        keep = []
        for ev, held in self._timed_out:
            if not ev.query():
                keep.append((ev, held))
            elif isinstance(held, _Slot) and held.bufs is not None:
                self._rb_free.append(held.bufs)
        self._timed_out = keep

    async def _serve_batch(self, pending: List[Any]) -> None:
        """Device rows → hints; any failure, or the loop's cancellation,
        resolves the waiters without a hint (the host trie serves them);
        a failure is logged here."""
        self._rec_wait(pending)
        if self.pipeline:
            await self._pipeline_dispatch(pending)
            return
        topics = [p[0] for p in pending]
        # the hint's provenance is the epoch the DEVICE table reflects;
        # freshness is proven forward from here at consume time
        epoch = self._synced_epoch
        rule_gen = self._synced_rule_gen
        try:
            if not self._usable():
                raise RuntimeError("mirror stale")
            rows = await self._dispatch_guarded(topics)
            self._mint_hints(pending, rows, epoch, rule_gen)
        except Exception:
            log.debug("device batch failed; publishes fall back",
                      exc_info=True)
        finally:
            for p in pending:
                if not p[1].done():
                    p[1].set_result(None)

    def _rec_wait(self, pending: List[Any]) -> None:
        """Record each popped waiter's queue wait (enqueue to dispatch
        start) and one flight-recorder event a batch."""
        h = self._h_wait
        if h is None or not pending:
            return
        now_ns = time.perf_counter_ns()
        oldest = now_ns
        n = 0
        for p in pending:
            ts = p[-1]
            # a waiter queued before the histograms were on (or injected
            # bare) ends in its future: no stamp to record
            if type(ts) is not int:
                continue
            h.record(now_ns - ts)
            n += 1
            oldest = min(oldest, ts)
        if n and self._ring_loop is not None:
            self._ring_loop.push(_SID_WAIT, oldest, now_ns - oldest, n,
                                 self._table_gen)

    async def _fault_gate(self) -> None:
        """The ``match.dispatch`` chaos seam."""
        if _fi._injector is not None:
            act = _fi._injector.act("match.dispatch")
            if act == "raise":
                raise _fi.InjectedFault("match.dispatch")
            if act == "delay":
                await _fi._injector.pause()
            elif act == "hang":
                await _fi._injector.hang()

    async def _readback_gate(self) -> None:
        """The ``match.readback`` chaos seam at the d2h boundary."""
        if _fi._injector is not None:
            act = _fi._injector.act("match.readback")
            if act == "raise":
                raise _fi.InjectedFault("match.readback")
            if act == "delay":
                await _fi._injector.pause()
            elif act == "hang":
                await _fi._injector.hang()

    async def _dispatch_guarded(self, topics: List[str]) -> List[Any]:
        await self._fault_gate()
        return await self._device_serve(topics)

    async def _device_serve(self, topics: List[str]) -> List[Any]:
        """One batch: encode + dispatch, the readback (the slab in
        ``chunked`` mode, else the two phases of :meth:`_readback_slot`),
        the spill re-run and deep merge; one id row per topic.  Only the
        chaos seam between dispatch and readback can let the table
        change while a slab batch is in flight; the reuse guard covers
        it.  On the deadline path the slab too is read through a slot,
        whose event is polled between rounds of the loop, so that the
        dispatch timeout can fire while the walk runs."""
        reuses0, gen0 = self.inc.aid_reuses, self._table_gen
        groups = self._depth_groups(topics)
        self._topic_sample.extend(topics[:8])
        mc = self._mc_active()
        t0 = time.perf_counter()
        handles = self._encode_dispatch(topics, groups, mc)
        t1 = time.perf_counter()
        await self._readback_gate()
        if mc is not None:
            results, nbytes, rb_s, trips = await self._mc_readback(handles)
        elif self.readback_mode == "chunked" and not self.deadline:
            t2 = time.perf_counter()
            results, nbytes, trips = self._readback_groups(handles)
            rb_s = time.perf_counter() - t2
        else:
            slot = self._make_slot([], topics, groups, handles, reuses0,
                                   gen0, 0, 0,
                                   slab=self.readback_mode == "chunked")
            try:
                results, nbytes, rb_s, trips = await self._readback_slot(
                    slot)
            finally:
                self._release_slot(slot)
        self._note_split(t1 - t0, rb_s)
        self._inc("tpu.match.readback_bytes", nbytes)
        self._inc("tpu.match.readback_roundtrips", trips)
        return self._collect_rows(topics, groups, results, reuses0, gen0)

    def _mint_hints(self, pending: List[Any], rows: List[Any],
                    epoch: int, rule_gen: int) -> None:
        for p, row in zip(pending, rows):
            topic, fut = p[0], p[1]
            # pop-then-insert: a refreshed hint is the most recent.  The
            # filters and rule ids are kept as tuples of strings, which
            # the cyclic GC stops tracking: the cache then adds nothing
            # to its full collections
            filters, rules = self._split_row(row)
            self._hints.pop(topic, None)
            self._hints[topic] = (epoch, rule_gen, tuple(filters),
                                  tuple(rules), False)
            if not fut.done():
                fut.set_result(None)
        self._evict()
        if self.deadline:
            self._count_misses(pending)

    def _evict(self) -> None:
        """Evict after insert, least recently served first (dict order
        is recency: a served hint is re-appended), so the cap holds even
        when one batch exceeds it."""
        excess = len(self._hints) - self.hint_cap
        if excess > 0:
            it = iter(self._hints)
            for k in [next(it) for _ in range(excess)]:
                del self._hints[k]
            self._inc("tpu.match.hint_evicted", excess)

    def _cpu_serve(self, pending: List[Any]) -> None:
        """Answer a batch from the host tables (the table's own walk and
        the too-deep filters' trie, once per distinct topic), minting its
        hints at the epoch and rule generation the host tables reflect,
        and resolve its waiters: what a failed or stale pipelined slot
        falls back to, so that the failure stays invisible to
        publishes."""
        if not pending:
            return
        epoch = self._seen_epoch
        rule_gen = self._rule_gen
        deep = (self._deep_trie.match_many([p[0] for p in pending])
                if self._deep else None)
        rows_of: Dict[str, List[int]] = {}
        for p in pending:
            topic, fut = p[0], p[1]
            row = rows_of.get(topic)
            if row is None:
                row = list(self.inc.match_host(topic))
                if deep is not None:
                    row.extend(self._deep[f] for f in deep[topic])
                rows_of[topic] = row
            filters, rules = self._split_row(row)
            self._hints.pop(topic, None)
            self._hints[topic] = (epoch, rule_gen, tuple(filters),
                                  tuple(rules), True)
            if not fut.done():
                fut.set_result(None)
        self._evict()
        self._inc("broker.match.cpu_fallback", len(pending))
        self._count_misses(pending)
        # a shard failure lands here: reconcile the mesh ladder
        self._mesh_watch()

    def _count_misses(self, pending: List[Any]) -> None:
        """Count the waiters answered past their deadline (a deadline
        waiter carries it third, a float; the fixed-window loop's waiters
        carry none, at most an int match_wait stamp)."""
        if self.metrics is None:
            return
        try:
            now = asyncio.get_running_loop().time()
        except RuntimeError:
            return      # no running loop: nothing is timed by it
        late = sum(1 for p in pending
                   if len(p) > 2 and type(p[2]) is float and now > p[2])
        if late:
            self.metrics.inc("broker.match.deadline_miss", late)

    def _note_split(self, disp_s: float, rb_s: float) -> None:
        """Feed the split estimate: ``disp_s`` the encode and dispatch of
        a batch, ``rb_s`` its readback (the queue wait of a pipelined
        slot in neither)."""
        self._est_disp_s = self._est_disp_s * 0.7 + disp_s * 0.3
        self._est_rb_s = self._est_rb_s * 0.7 + rb_s * 0.3
        if self._est_split_samples < 1 << 30:
            self._est_split_samples += 1

    #: split-estimate samples below which the combined estimate serves
    SPLIT_WARM = 8

    def _dispatch_est(self) -> float:
        """The dispatch time the deadline loop subtracts from a budget:
        the split components' sum once warm (no queue wait in it), else
        the combined EWMA."""
        if self._est_split_samples >= self.SPLIT_WARM:
            return self._est_disp_s + self._est_rb_s
        return self._est_dispatch_s

    # -- the overlapped pipeline (pipeline=True) -------------------------------

    def _take_bufs(self, rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """A (meta, ids) host buffer pair for ``rows`` padded batch rows
        (``FLAT_MULT`` ids a row), pinned on the card: a free one, or a
        new one sized for two depth groups of ``max_batch``.  A pair a
        timed-out batch holds is free again only once its copies are
        done."""
        if self._timed_out:
            self._reclaim()
        free = self._rb_free
        for i, (meta, _ids) in enumerate(free):
            if meta.numel() >= rows:
                return free.pop(i)
        rows = max(rows, 2 * _bucket(self.max_batch))
        pin = self.dev.device.type == "cuda"
        return (torch.empty(rows, dtype=torch.int32, pin_memory=pin),
                torch.empty(self.FLAT_MULT * rows, dtype=torch.int32,
                            pin_memory=pin))

    async def _pipeline_dispatch(self, pending: List[Any]) -> None:
        """The front half of a pipelined batch: encode and dispatch its
        walks, enqueue each group's ``row_meta`` copy into the slot's
        pinned buffer behind them, record the slot's event and hand the
        slot to the readback task; then the batch loop goes back to
        batching.  The slot carries the guards it was dispatched against,
        so that a table change landing while it is in flight discards
        exactly that slot.  A failure answers the batch from the host
        tables (and, from the deadline loop, counts toward the breaker;
        the chaos seam then runs under the dispatch timeout: encode and
        launch run on the loop and cannot hang)."""
        if not pending:
            return
        topics = [p[0] for p in pending]
        epoch = self._synced_epoch
        rule_gen = self._synced_rule_gen
        reuses0, gen0 = self.inc.aid_reuses, self._table_gen
        try:
            if not self._usable():
                raise RuntimeError("mirror stale")
            if self.deadline:
                await asyncio.wait_for(self._fault_gate(),
                                       self.dispatch_timeout_s)
            else:
                await self._fault_gate()
            groups = self._depth_groups(topics)
            self._topic_sample.extend(topics[:8])
            mc = self._mc_active()
            t0 = time.perf_counter()
            handles = self._encode_dispatch(topics, groups, mc)
            slot = self._make_slot(pending, topics, groups, handles,
                                   reuses0, gen0, epoch, rule_gen,
                                   mesh=mc is not None)
            slot.dispatch_s = time.perf_counter() - t0
            slot.deadline = self.deadline
            await self._inflight_q.put(slot)   # backpressure at the depth
            self._inflight_n += 1
            self._set_inflight_metric()
        except asyncio.CancelledError:
            # the loop is dying: its exit fails these waiters over
            self._pending = pending + self._pending
            raise
        except Exception:
            log.debug("device batch failed (pipelined dispatch); the host "
                      "tables serve it", exc_info=True)
            if self.deadline:
                self._breaker_note_failure()
            self._cpu_serve(pending)

    def _make_slot(self, pending, topics, groups, handles, reuses0: int,
                   gen0: int, epoch: int, rule_gen: int,
                   slab: bool = False, mesh: bool = False) -> _Slot:
        """The slot of dispatched ``handles``: phase 1 of its readback
        (each group's ``row_meta`` into a borrowed pinned buffer; with
        ``slab``, each group's whole slab into pinned buffers of its own)
        is enqueued behind the walks, and the event after it recorded;
        mesh dispatches (``mesh``) carry their own copies and events.
        The slot holds the table's freed accept ids until
        :meth:`_release_slot`."""
        if mesh:
            self.dev.hold_ids()
            return _Slot(pending, topics, groups, handles, reuses0, gen0,
                         epoch, rule_gen, held=self.dev)
        if slab:
            pin = self.dev.device.type == "cuda"
            copies = []
            for res, _n in handles:
                outs = (res.matches, res.n_matches, res.active_overflow,
                        res.match_overflow)
                host = tuple(torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=pin) for t in outs)
                for h, t in zip(host, outs):
                    h.copy_(t, non_blocking=True)
                copies.append(host)
            self.dev.hold_ids()
            return _Slot(pending, topics, groups, handles, reuses0, gen0,
                         epoch, rule_gen, slab=copies,
                         event=_record_event(self.dev.device), held=self.dev)
        bufs = self._take_bufs(sum(int(res.row_meta.numel())
                                   for res, _n in handles))
        metas = []
        off = 0
        for res, _n in handles:
            B = int(res.row_meta.numel())
            meta = bufs[0][off:off + B]
            meta.copy_(res.row_meta, non_blocking=True)
            metas.append(meta)
            off += B
        self.dev.hold_ids()
        return _Slot(pending, topics, groups, handles, reuses0, gen0, epoch,
                     rule_gen, bufs=bufs, metas=metas,
                     event=_record_event(self.dev.device), held=self.dev)

    def _release_slot(self, slot: _Slot) -> None:
        """A slot is done with: its buffers go back to the free list
        once their copies are done, and its hold on the freed accept ids
        is lifted.  A slot whose copies still run (its walk timed out,
        or the loop was cancelled) is kept whole in ``_timed_out`` until
        its event completes: no later batch is handed its buffers."""
        if slot.event is not None and not slot.event.query():
            self._timed_out.append((slot.event, slot))
        elif slot.bufs is not None:
            self._rb_free.append(slot.bufs)
            slot.bufs = None
        if slot.held is not None:
            slot.held.release_ids()
            slot.held = None

    async def _readback_loop(self) -> None:
        """The back half: finish the in-flight slots in dispatch order.
        However the task ends, the waiters of the queued slots fail over
        to the host path at once."""
        try:
            while True:
                slot = await self._inflight_q.get()
                try:
                    await self._finish_slot(slot)
                finally:
                    self._inflight_n -= 1
                    self._set_inflight_metric()
        finally:
            self._fail_over_slots()

    async def _finish_slot(self, slot: _Slot) -> None:
        """Readback, guard check and hint mint of one slot; any failure
        (the ``match.readback`` seam, a stale guard) answers its batch
        from the host tables.  Its waiters are resolved and the slot
        released however it ends."""
        try:
            try:
                if slot.deadline:
                    results, nbytes, rb_s, trips = await asyncio.wait_for(
                        self._gated_readback(slot), self.dispatch_timeout_s)
                else:
                    results, nbytes, rb_s, trips = \
                        await self._gated_readback(slot)
                self._note_split(slot.dispatch_s, rb_s)
                self._inc("tpu.match.readback_bytes", nbytes)
                self._inc("tpu.match.readback_roundtrips", trips)
                rows = self._collect_rows(slot.topics, slot.groups, results,
                                          slot.reuses0, slot.gen0)
            except asyncio.CancelledError:
                raise
            except _StaleRace:
                # the table changed under this slot: the device is fine
                log.debug("device batch failed (pipelined readback, stale "
                          "slot); the host tables serve it", exc_info=True)
                self._cpu_serve(slot.pending)
                return
            except Exception:
                log.debug("device batch failed (pipelined readback); the "
                          "host tables serve it", exc_info=True)
                if slot.deadline:
                    self._breaker_note_failure()
                self._cpu_serve(slot.pending)
                return
            if slot.deadline:
                self._breaker_note_ok()
                self._est_dispatch_s = (self._est_dispatch_s * 0.7
                                        + (time.monotonic() - slot.t0) * 0.3)
            self._mint_hints(slot.pending, rows, slot.epoch, slot.rule_gen)
        finally:
            self._release_slot(slot)
            for p in slot.pending:
                if not p[1].done():
                    p[1].set_result(None)

    async def _gated_readback(self, slot: _Slot):
        await self._readback_gate()
        return await self._readback_slot(slot)

    async def _readback_slot(self, slot: _Slot):
        """The two phases of a slot's readback, each one wait on an
        event polled between rounds of the loop: the ``row_meta`` copies
        that rode behind the walks, then one copy per group of the ids
        :meth:`_phase2_count` asks for into the slot's ids buffer; or,
        for a ``slab`` slot, one wait for the slabs (the bytes and the
        one trip a group of the reference's ``chunked`` slab read).
        Returns ``([(rows, spilled)...], bytes, seconds, waits)``."""
        if slot.handles and isinstance(slot.handles[0][0], McHandle):
            return await self._mc_readback(slot.handles)
        t0 = time.perf_counter_ns()
        await _event_done(slot.event)
        k = self.dev.max_matches
        if slot.slab is not None:
            out = [self._slab_rows(*(h.numpy() for h in host), n, k)
                   for host, (_res, n) in zip(slot.slab, slot.handles)]
            nbytes = sum(4 * (res.matches.numel() + 3 * res.n_matches.numel())
                         for res, _n in slot.handles)
            self._rec_readback(t0, slot.handles)
            return (out, nbytes, (time.perf_counter_ns() - t0) * 1e-9,
                    len(slot.handles))
        metas = [m.numpy() for m in slot.metas]
        ids_buf = slot.bufs[1]
        views = []
        nbytes = copied = off = 0
        for (res, n), meta in zip(slot.handles, metas):
            nk, _sp = decode_row_meta(meta)
            total = int(np.minimum(nk, k)[:n].sum())
            count = self._phase2_count(total, int(res.matches.shape[0]),
                                       self.readback_mode,
                                       self.readback_auto_slack)
            fetch = fetch_flat_ragged if count > total else fetch_flat_prefix
            views.append(fetch(res.matches, total, ids_buf[off:]))
            nbytes += 4 * (meta.size + count)
            copied += count
            off += count
        trips = 1
        if copied:
            slot.event = _record_event(self.dev.device)
            await _event_done(slot.event)
            trips = 2
        out = [self._rows_from_twophase(meta, view.numpy(), n, k)
               for (_res, n), meta, view in zip(slot.handles, metas, views)]
        self._rec_readback(t0, slot.handles)
        return out, nbytes, (time.perf_counter_ns() - t0) * 1e-9, trips

    def _fail_over_slots(self) -> None:
        """Readback task exit: resolve the waiters of every queued slot,
        so that their publishes take the host path at once (the twin of
        :meth:`_fail_over_waiters` for slots past dispatch)."""
        q = self._inflight_q
        n = 0
        while q is not None and not q.empty():
            slot = q.get_nowait()
            self._release_slot(slot)
            for p in slot.pending:
                if not p[1].done():
                    p[1].set_result(None)
                    n += 1
        self._inflight_n = 0
        self._set_inflight_metric()
        if n:
            self._inc("broker.match.cpu_fallback", n)
            log.warning("match readback loop exited with %d waiter(s) in "
                        "flight; failed over to the host path", n)

    def _set_inflight_metric(self) -> None:
        if self.metrics is not None:
            self.metrics.set("broker.match.pipeline_inflight",
                             self._inflight_n)

    def _fail_over_waiters(self) -> None:
        """Serve-loop exit (stop, crash): resolve every waiter in flight
        now, so each blocked prefetch falls to the host path at once
        instead of waiting out ``prefetch_timeout_s``."""
        pending, self._pending = self._pending, []
        if not pending:
            return
        for p in pending:
            if not p[1].done():
                p[1].set_result(None)
        self._inc("broker.match.cpu_fallback", len(pending))
        log.warning("match serve loop exited with %d waiter(s) in "
                    "flight; failed over to the host path", len(pending))

    def info(self) -> dict:
        return {
            "ready": self.ready,
            "table_kind": self.table_kind,
            "filters": self.inc.n_filters,
            "states": self.inc.n_states,
            "rules": len(self._rule_refs),
            "device_epoch": self.dev.epoch,
            "router_epoch": (self.router.epoch if self.router is not None
                             else None),
            "synced_epoch": self._synced_epoch,
            "uploads": self.dev.uploads,
            "delta_applies": self.dev.delta_applies,
            "pending": len(self._pending),
            "hints": len(self._hints),
            "backend": self.backend,
            "pipeline": self.pipeline,
            "pipeline_depth": self.pipeline_depth,
            "pipeline_inflight": self._inflight_n,
            "readback_mode": self.readback_mode,
            "readback_auto_slack": self.readback_auto_slack,
            "deadline": self.deadline,
            "breaker": "open" if self._breaker_open else "closed",
            "breaker_failures": self._breaker_failures,
            "brownout": self._last_brownout,
            "timed_out_batches": len(self._timed_out),
            "est_dispatch_ms": round(self._est_dispatch_s * 1e3, 3),
            "est_disp_ms": round(self._est_disp_s * 1e3, 3),
            "est_readback_ms": round(self._est_rb_s * 1e3, 3),
            "est_split_warm": self._est_split_samples >= self.SPLIT_WARM,
            "dispatches": self.dispatches,
            "join_dispatches": self.join_dispatches,
            "join_rebuilds": self.dev.join_rebuilds,
            "autotune": (self.tuner.info()
                         if self.tuner is not None else None),
            "multichip": (self.mc.info() if self.mc is not None else None),
            "segments": ({
                "dir": self.segments_dir,
                "loaded": self._segment_loaded,
                "table_gen": self._table_gen,
                "mutations": self._mut_count,
                "abandoned": self._compact_abandoned,
                "grow_applies": self.dev.grow_applies,
                "dirty_rows_uploaded": self.dev.dirty_rows_uploaded,
            } if self.segments else None),
        }
