"""The match sidecar: a HookProvider + MirrorSync gRPC server on the card.

The port of ``emqx_tpu/exhook/server.py``.  An external broker (a stock
EMQX, or this package's ``BrokerNode``) points its exhook at this
server; the sidecar

* negotiates the hook set at ``OnProviderLoaded``: the session
  subscribe/unsubscribe events are the delta feed its filter mirror
  needs;
* keeps the mirror incrementally: every filter add or remove is an
  O(filter) mutation of the live :class:`IncrementalNfa`, drained to the
  card as row deltas by a debounced sync loop (no whole re-upload on the
  steady-state path);
* serves ``OnMessagePublish`` through a micro-batching loop, so that
  concurrent publishes ride one walk, and ``MirrorSync.MatchBatch`` for
  bulk queries, one walk a call;
* re-runs on the host trie each row whose device answer spilled
  (active-set or match-count overflow), so that answers stay exact;
* serves filters deeper than the device table from a host trie, under
  *alias* ids in the same accept-id space, merged into device rows.

The device work of a batch (:meth:`TpuMatchSidecar._device_rows`) is the
port's ``DeviceNfa.match`` (the hash walk, ``csrc/nfa_walk.cu`` on the
card, with the flat epilogue at ``flat_cap = SERVE_FLAT_MULT·B``), then
one copy of the matches, the counts and both spill flags into pinned
host memory, awaited on the batch's own CUDA event.  The mirror's
applies, the warm-up and every batch's dispatch and readback run on
worker threads (``asyncio.to_thread``), all on one CUDA stream that
:meth:`TpuMatchSidecar.start` makes (a process's first stream waits for
the work queued on the card, so it is made before any is queued).

Intended divergences from the reference, which answers from the host
trie whenever the device path fails:

* a device error propagates: ``MatchBatch`` returns an RPC error, and
  the micro-batch loop sets it on its waiters, so ``OnMessagePublish``
  errors and the broker's ``failure_action`` decides;
* a failed mirror sync is logged and counted (``sync_failures``, the
  last error in ``sync_error``) before it is retried;
* a publish that waits over ``QUEUE_WAIT_S`` for its micro-batch (a
  stalled walk) is logged, counted (``queue_timeouts``) and answered
  with ``DEADLINE_EXCEEDED``;
* the host answers that stay are exactness rules, each counted as a
  plain attribute: the spill re-run (``spill_fallbacks``), a batch
  whose accept ids were reused while it walked (``aid_reuse_rows``),
  and the rows matched before the first sync or during a whole upload
  (``not_ready_rows``); ``host_rows`` sums all but the spills;
* a checkpoint that does not load is a cold start, as in the reference,
  but one whose upload or warm-up fails makes ``start()`` raise.

The ``Stats`` RPC keeps the reference's fields and ``extra`` keys.

Run standalone: ``python -m emqx_tpu_torch.exhook.server --port 9000``
(on the card; ``--device cpu`` runs the walk's plain version).
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import grpc
import numpy as np
import torch

from ..broker.trie import FilterTrie
from .rpc import (
    add_hook_provider_to_server,
    add_mirror_sync_to_server,
    pb,
)

log = logging.getLogger(__name__)

__all__ = ["TpuMatchSidecar", "serve"]

# the longest a publish waits for its micro-batch before its RPC fails
QUEUE_WAIT_S = 2.0


def _bucket_batch(n: int, minimum: int = 64) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class _IncEngine:
    """The serving engine: host-authoritative incremental NFA + device
    mirror + deep-filter (alias) host path.

    Threading: all mutations and encodes happen on the event loop; the
    mirror's applies and the match dispatches run on worker threads
    (DeviceNfa serializes device ops internally)."""

    def __init__(
        self, depth: int, active_slots: int = 16,
        max_matches: Optional[int] = None,
        device: Union[None, str, torch.device] = None,
    ) -> None:
        from ..ops import IncrementalNfa
        from ..ops.device_table import DeviceNfa

        self.depth = depth
        self.inc = IncrementalNfa(depth=depth)
        if max_matches is None:
            # the shipped serving K (one source of truth in config.py)
            from ..config import SCHEMA

            max_matches = SCHEMA["tpu.max_matches"].default
        self.dev = DeviceNfa(
            self.inc, active_slots=active_slots, max_matches=max_matches,
            device=device, lazy=True,
        )
        self.deep_aid: Dict[str, int] = {}   # deep filter -> alias aid
        self.deep_trie = FilterTrie()

    # -- mutation (event loop) --------------------------------------------

    def add(self, flt: str) -> None:
        try:
            self.inc.add(flt)
        except ValueError:
            if flt not in self.deep_aid:
                self.deep_aid[flt] = self.inc.alloc_alias(flt)
                self.deep_trie.insert(flt)

    def remove(self, flt: str) -> None:
        aid = self.deep_aid.pop(flt, None)
        if aid is not None:
            self.inc.free_alias(aid)
            self.deep_trie.delete(flt)
        else:
            self.inc.remove(flt)

    def live_filters(self) -> List[str]:
        return self.inc.filters() + sorted(self.deep_aid)

    def aid_of(self, flt: str) -> int:
        aid = self.deep_aid.get(flt)
        return aid if aid is not None else self.inc.aid_of(flt)

    def encode(self, topics: List[str], batch: int):
        from ..ops import encode_batch

        return encode_batch(self.inc, topics, batch=batch)

    def deep_matches(self, topic: str) -> List[int]:
        if not self.deep_aid:
            return []
        return [self.deep_aid[f] for f in self.deep_trie.match(topic)]


class TpuMatchSidecar:
    """HookProvider + MirrorSync servicer (grpc.aio, async methods).

    ``device`` is the card unless the caller names another (``"cpu"``
    runs the walk's plain version); without CUDA the default raises."""

    def __init__(
        self,
        depth: int = 8,
        batch_window_ms: float = 0.2,
        max_batch: int = 4096,
        rebuild_debounce_s: float = 0.1,
        annotate: bool = False,
        node: str = "tpu-sidecar",
        checkpoint_path: str = "",
        active_slots: int = 16,
        max_matches: Optional[int] = None,
        device: Union[None, str, torch.device] = None,
    ) -> None:
        self.depth = depth
        self.batch_window_s = batch_window_ms / 1000.0
        self.max_batch = max_batch
        self.rebuild_debounce_s = rebuild_debounce_s
        self.annotate = annotate
        self.node = node
        self.checkpoint_path = checkpoint_path

        self._ref: Dict[str, int] = {}        # filter -> refcount
        self._epoch = 0
        self._eng = _IncEngine(
            depth, active_slots=active_slots, max_matches=max_matches,
            device=device,
        )
        self.device = self._eng.dev.device
        self._stream: Optional[torch.cuda.Stream] = None  # made at start
        self._eng_ready = False               # device mirror serveable
        self._dirty = asyncio.Event()
        self._pending: List[Tuple[str, asyncio.Future]] = []
        self._batch_wake = asyncio.Event()
        self._tasks: List[asyncio.Task] = []
        self._running = False
        # stats
        self.batches = 0
        self.topics_matched = 0
        self.spill_fallbacks = 0   # rows re-run on the host trie
        self.syncs = 0
        self._lat_ms: List[float] = []   # rolling batch latency samples
        # the port's counters (plain attributes; Stats keeps the
        # reference's keys): walks dispatched, warm-up walks, the host
        # answers other than spills, failed syncs
        self.device_batches = 0
        self.warms = 0
        self.not_ready_rows = 0
        self.aid_reuse_rows = 0
        self.queue_timeouts = 0
        self.sync_failures = 0
        self.sync_error: Optional[BaseException] = None

    # engine visible only once the device mirror can serve (tests gate on
    # `sidecar._engine is not None`)
    @property
    def _engine(self) -> Optional[_IncEngine]:
        return self._eng if self._eng_ready else None

    @property
    def _table_version(self) -> int:
        return self._eng.inc.epoch

    @property
    def host_rows(self) -> int:
        """Rows answered by the host trie other than spill re-runs."""
        return self.not_ready_rows + self.aid_reuse_rows

    def _on_stream(self):
        """The sidecar's CUDA stream as the current one (a no-op off the
        card): every device call of the sidecar runs inside it."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self) -> None:
        self._running = True
        if self.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if self.checkpoint_path:
            self._restore_checkpoint()
        self._tasks = [
            asyncio.ensure_future(self._sync_loop()),
            asyncio.ensure_future(self._batch_loop()),
        ]

    def _restore_checkpoint(self) -> None:
        """Re-adopt the checkpointed filter set so the mirror serves
        immediately; the live feed (hooks / InstallSnapshot) reconciles
        afterwards (InstallSnapshot diffs against engine contents, which
        drops filters whose subscribers vanished while we were down).  A
        checkpoint that does not load is a cold start, as in the
        reference; an upload or warm-up that fails raises."""
        from ..storage.checkpoint import load_table

        try:
            table = load_table(self.checkpoint_path)
        except Exception:
            log.exception("checkpoint load failed; cold start")
            return
        if table is None:
            return
        t0 = time.perf_counter()
        for flt in table.accept_filters:
            if flt is not None:
                self._eng.add(flt)
        with self._on_stream():
            self._eng.dev.sync(full=True)
        self._warm(self._eng)
        self._eng_ready = True
        log.info(
            "checkpoint restored: %d filters, %d states, %.1f ms "
            "(stale until first sync)",
            self._eng.inc.n_filters + len(self._eng.deep_aid),
            self._eng.inc.n_states,
            (time.perf_counter() - t0) * 1e3,
        )

    async def stop(self) -> None:
        self._running = False
        for t in self._tasks:
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []

    # ------------------------------------------------------------------
    # mirror mutation (event loop only)
    # ------------------------------------------------------------------

    def _add_filter(self, flt: str) -> None:
        n = self._ref.get(flt, 0)
        self._ref[flt] = n + 1
        if n == 0:
            self._eng.add(flt)
            self._epoch += 1
            self._dirty.set()

    def _del_filter(self, flt: str) -> None:
        n = self._ref.get(flt, 0)
        if n <= 1:
            if n == 1:
                del self._ref[flt]
                self._eng.remove(flt)
                self._epoch += 1
                self._dirty.set()
        else:
            self._ref[flt] = n - 1

    def _apply(self, eng: _IncEngine, pending) -> None:
        """WORKER THREAD: ship a drained sync on the sidecar's stream."""
        with self._on_stream():
            eng.dev.apply_pending(pending)

    async def _sync_loop(self) -> None:
        """Debounced host→device delta shipping.  Steady state is
        O(delta): a few rows written in place, no table re-upload."""
        while True:
            await self._dirty.wait()
            await asyncio.sleep(self.rebuild_debounce_s)  # debounce bursts
            self._dirty.clear()
            eng = self._eng
            t0 = time.perf_counter()
            try:
                first = not self._eng_ready
                pending = eng.dev.drain(full=first)  # loop-side: O(delta)
                if pending.full is not None:
                    # a whole upload swaps the tables: serve from the host
                    # (counted) until it is applied and warmed
                    self._eng_ready = False
                await asyncio.to_thread(self._apply, eng, pending)
                if first or pending.full is not None:
                    await asyncio.to_thread(self._warm, eng)
                self._eng_ready = True
                self.syncs += 1
                dt = (time.perf_counter() - t0) * 1e3
                log.info(
                    "mirror sync: epoch %d (%s), %.1f ms",
                    pending.epoch,
                    "full upload" if pending.full is not None else
                    f"{len(pending.delta.state_idx)}+"
                    f"{len(pending.delta.bucket_idx)} rows",
                    dt,
                )
                if self.checkpoint_path:
                    await asyncio.to_thread(self._save_checkpoint)
            except Exception as e:
                # the drained delta is lost and the device mirror dropped
                # its arrays (DeviceNfa.apply_pending): re-mark dirty so
                # the next pass re-uploads in full, after a breather
                self.sync_failures += 1
                self.sync_error = e
                log.exception("mirror sync failed; full re-upload scheduled")
                await asyncio.sleep(1.0)
                self._dirty.set()

    def _warm(self, eng: _IncEngine) -> None:
        """WORKER THREAD (or start): one walk of the smallest batch
        bucket on pre-encoded inert rows, at the flat capacity serving
        uses, waited for: a kernel that does not build or launch raises
        here."""
        from ..ops.match_kernel import SERVE_FLAT_MULT

        words, lens, is_sys = eng.encode([], 64)  # inert padding rows
        with self._on_stream():
            res = eng.dev.match(*eng.dev.put_batch(words, lens, is_sys),
                                flat_cap=SERVE_FLAT_MULT * 64)
            self.warms += 1
            if self._stream is not None:
                ev = torch.cuda.Event()
                ev.record(self._stream)
                ev.synchronize()
        del res

    def _save_checkpoint(self) -> None:
        try:
            from ..storage.checkpoint import save_table

            if self._eng.inc.n_filters or self._eng.deep_aid:
                save_table(self._eng.inc.snapshot(), self.checkpoint_path)
            elif os.path.exists(self.checkpoint_path):
                # an emptied mirror must not resurrect the old table on
                # the next restart
                os.remove(self.checkpoint_path)
        except Exception:
            log.exception("checkpoint save failed")

    # ------------------------------------------------------------------
    # match paths
    # ------------------------------------------------------------------

    def _host_row(self, topic: str) -> List[int]:
        """Authoritative host answer as accept/alias ids — walks the
        live incremental trie directly (the single source of truth, so
        host answers are exact even mid-restore)."""
        eng = self._eng
        row = eng.inc.match_host(topic)
        row.extend(eng.deep_matches(topic))
        return row

    def _device_rows(self, eng: _IncEngine, enc, n: int):
        """WORKER THREAD: dispatch + readback of one encoded batch.
        Returns (rows, spilled_row_indexes).  The walk runs with the flat
        epilogue; the flat buffer, the counts and both spill flags are
        joined on the card and copied to pinned host memory in one copy,
        which the thread waits for on the batch's own event."""
        from ..ops.match_kernel import SERVE_FLAT_MULT, decode_flat

        B = enc[0].shape[0]
        cap = SERVE_FLAT_MULT * B
        with self._on_stream():
            res = eng.dev.match(*eng.dev.put_batch(*enc), flat_cap=cap)
            slab = torch.cat((res.matches, res.n_matches,
                              res.active_overflow, res.match_overflow))
            host = torch.empty(slab.shape, dtype=slab.dtype,
                               pin_memory=self._stream is not None)
            host.copy_(slab, non_blocking=True)
            if self._stream is not None:
                ev = torch.cuda.Event()
                ev.record(self._stream)
                ev.synchronize()
        flat = host.numpy()
        matches, counts = flat[:cap], flat[cap:cap + B]
        aover, mover = flat[cap + B:cap + 2 * B], flat[cap + 2 * B:]
        sp = (aover > 0) | (mover > 0)
        rows = [seg.tolist()
                for seg in decode_flat(matches, counts,
                                       eng.dev.max_matches)[:n]]
        return rows, np.flatnonzero(sp[:n]).tolist()

    async def _match_rows(self, topics: List[str]) -> List[List[int]]:
        """Match a batch to accept-id rows: one walk + per-row re-run of
        spills on the host + deep merge.  Encode and all host-trie reads
        stay on the loop; only the walk and its readback run in a
        thread, and an error of theirs propagates."""
        eng = self._eng
        if not topics:
            return []
        if not self._eng_ready:
            self.not_ready_rows += len(topics)
            return [self._host_row(t) for t in topics]
        # encoded at most max_batch rows, as the reference does: a larger
        # request raises here (ROADMAP Queue 3)
        B = _bucket_batch(min(len(topics), self.max_batch))
        enc = eng.encode(topics, B)
        # aid-reuse guard: device rows decoded through a mutated
        # accept_filters after an id was recycled would name the wrong
        # filter — discard the batch and answer from the host trie
        reuses0 = eng.inc.aid_reuses
        self.device_batches += 1
        rows, spilled = await asyncio.to_thread(
            self._device_rows, eng, enc, len(topics)
        )
        if eng.inc.aid_reuses != reuses0:
            log.warning("accept id reused mid-flight; %d rows from the host",
                        len(topics))
            self.aid_reuse_rows += len(topics)
            return [self._host_row(t) for t in topics]
        if spilled:
            self.spill_fallbacks += len(spilled)
            for r in spilled:
                rows[r] = self._host_row(topics[r])
        if eng.deep_aid:
            spset = set(spilled)
            for r, t in enumerate(topics):
                if r not in spset:
                    rows[r].extend(eng.deep_matches(t))
        return rows

    def _ids_to_filters(self, rows: List[List[int]]) -> List[List[str]]:
        table = self._eng.inc.accept_filters
        return [[table[a] for a in row if table[a] is not None]
                for row in rows]

    async def _queue_match(self, topic: str) -> List[str]:
        """Micro-batched single-topic match; returns filter strings."""
        if not self._eng_ready:
            self.not_ready_rows += 1
            return self._ids_to_filters([self._host_row(topic)])[0]
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending.append((topic, fut))
        self._batch_wake.set()
        try:
            # bounded wait: a stalled walk fails the hook RPC (counted),
            # never holds it past its deadline
            return await asyncio.wait_for(fut, QUEUE_WAIT_S)
        except asyncio.TimeoutError:
            self.queue_timeouts += 1
            log.error("publish waited over %.1f s for its micro-batch",
                      QUEUE_WAIT_S)
            raise

    async def _batch_loop(self) -> None:
        while True:
            await self._batch_wake.wait()
            self._batch_wake.clear()
            if not self._pending:
                continue
            # deadline micro-batching: let concurrent arrivals pile up
            await asyncio.sleep(self.batch_window_s)
            pending, self._pending = self._pending[: self.max_batch], \
                self._pending[self.max_batch:]
            if self._pending:
                self._batch_wake.set()
            topics = [t for t, _ in pending]
            t0 = time.perf_counter()
            try:
                results = self._ids_to_filters(await self._match_rows(topics))
            except Exception as e:
                # the waiters' RPCs fail; the broker's failure_action
                # decides (the reference answers them from the host)
                log.exception("batch match failed")
                for _, fut in pending:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            dt_ms = (time.perf_counter() - t0) * 1e3
            self.batches += 1
            self.topics_matched += len(topics)
            self._lat_ms.append(dt_ms)
            if len(self._lat_ms) > 1024:
                del self._lat_ms[:512]
            for (_, fut), res in zip(pending, results):
                if not fut.done():
                    fut.set_result(res)

    # ------------------------------------------------------------------
    # HookProvider service (async grpc.aio handlers)
    # ------------------------------------------------------------------

    async def OnProviderLoaded(self, request, context):
        log.info("provider loaded by node %s", request.meta.node)
        wanted = [
            "session.subscribed", "session.unsubscribed",
            "message.publish",
        ]
        return pb.LoadedResponse(
            hooks=[pb.HookSpec(name=h) for h in wanted]
        )

    async def OnProviderUnloaded(self, request, context):
        return pb.EmptySuccess()

    async def OnSessionSubscribed(self, request, context):
        # the mirror tracks routing filters; $share group load-balancing
        # stays broker-side, so the broker sends the stripped filter here
        self._add_filter(request.topic)
        return pb.EmptySuccess()

    async def OnSessionUnsubscribed(self, request, context):
        self._del_filter(request.topic)
        return pb.EmptySuccess()

    async def OnMessagePublish(self, request, context):
        try:
            matched = await self._queue_match(request.message.topic)
        except asyncio.TimeoutError:
            await context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                                "micro-batch match timed out")
        if not self.annotate:
            return pb.ValuedResponse(type=pb.ValuedResponse.CONTINUE)
        msg = pb.Message()
        msg.CopyFrom(request.message)
        msg.headers["matched_filters"] = str(len(matched))
        return pb.ValuedResponse(
            type=pb.ValuedResponse.STOP_AND_RETURN, message=msg
        )

    # ------------------------------------------------------------------
    # MirrorSync service
    # ------------------------------------------------------------------

    async def InstallSnapshot(self, request_iterator, context):
        """Bulk bootstrap: reconcile the mirror to exactly the streamed
        filter set (diff-apply through the same incremental machinery —
        also drops stale checkpoint-restored filters)."""
        ref: Dict[str, int] = {}
        epoch = 0
        async for chunk in request_iterator:
            epoch = max(epoch, chunk.epoch)
            counts = list(chunk.refcounts)
            for i, flt in enumerate(chunk.filters):
                ref[flt] = counts[i] if i < len(counts) else 1
        current = set(self._eng.live_filters())
        for flt in current - set(ref):
            self._eng.remove(flt)
        for flt in set(ref) - current:
            self._eng.add(flt)
        self._ref = ref
        self._epoch = epoch
        self._dirty.set()
        return pb.SnapshotAck(
            epoch=epoch, n_filters=len(ref), rebuilt=False
        )

    async def ApplyDeltas(self, request, context):
        for d in request.deltas:
            if d.op == pb.DeltaBatch.Delta.ADD:
                self._add_filter(d.filter)
            else:
                self._del_filter(d.filter)
        self._epoch = max(self._epoch, request.to_epoch)
        return pb.SnapshotAck(
            epoch=self._epoch, n_filters=len(self._ref), rebuilt=False
        )

    async def MatchBatch(self, request, context):
        topics = list(request.topics)
        t0 = time.perf_counter()
        resp = pb.MatchBatchResponse(
            epoch=self._epoch, table_version=self._table_version
        )
        rows = await self._match_rows(topics)
        for row in rows:
            resp.results.add(filter_ids=row)
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.batches += 1
        self.topics_matched += len(topics)
        self._lat_ms.append(dt_ms)
        return resp

    async def FilterTable(self, request, context):
        return pb.FilterTableResponse(
            table_version=self._table_version,
            filters=self.filter_table(),
        )

    async def Stats(self, request, context):
        lat = sorted(self._lat_ms) or [0.0]
        eng = self._eng
        return pb.StatsResponse(
            epoch=self._epoch,
            n_filters=len(self._ref),
            n_states=eng.inc.n_states if self._eng_ready else 0,
            batches=self.batches,
            topics_matched=self.topics_matched,
            p50_batch_ms=lat[len(lat) // 2],
            p99_batch_ms=lat[min(len(lat) - 1, int(len(lat) * 0.99))],
            pending_deltas=int(self._dirty.is_set()),
            extra={
                "table_version": str(self._table_version),
                "spill_fallbacks": str(self.spill_fallbacks),
                "device_uploads": str(eng.dev.uploads),
                "device_delta_applies": str(eng.dev.delta_applies),
                "syncs": str(self.syncs),
            },
        )

    # ------------------------------------------------------------------

    def filter_table(self) -> List[str]:
        """id -> filter for MatchBatch results; freed ids resolve to ""."""
        return [f or "" for f in self._eng.inc.accept_filters]


async def serve(
    port: int = 9000,
    host: str = "127.0.0.1",
    sidecar: Optional[TpuMatchSidecar] = None,
) -> Tuple[Any, TpuMatchSidecar]:
    """Start a grpc.aio server hosting the sidecar; returns (server,
    sidecar).  The port it bound (``port`` 0 takes a free one) is
    ``sidecar.port``."""
    import grpc.aio

    sidecar = sidecar if sidecar is not None else TpuMatchSidecar()
    server = grpc.aio.server()
    add_hook_provider_to_server(sidecar, server)
    add_mirror_sync_to_server(sidecar, server)
    sidecar.port = server.add_insecure_port(f"{host}:{port}")
    await sidecar.start()
    await server.start()
    return server, sidecar


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="match sidecar on the card")
    ap.add_argument("--port", type=int, default=9000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--annotate", action="store_true")
    ap.add_argument("--checkpoint", default="",
                    help="path for the compiled-table checkpoint")
    ap.add_argument("--device", default=None,
                    help="torch device of the mirror (default: the card; "
                    "'cpu' runs the walk's plain version)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    async def run():
        server, _ = await serve(
            port=args.port, host=args.host,
            sidecar=TpuMatchSidecar(depth=args.depth, annotate=args.annotate,
                                    checkpoint_path=args.checkpoint,
                                    device=args.device),
        )
        await server.wait_for_termination()

    asyncio.run(run())


if __name__ == "__main__":
    main()
