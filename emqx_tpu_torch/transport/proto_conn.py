"""The port's own copy of the reference's ``emqx_tpu/transport/proto_conn.py``, so
that nothing here imports the JAX package.

Protocol-mode TCP connection: the low-overhead datapath.

Behavioral reference: ``emqx_connection.erl`` [U] — same duties as
:class:`~emqx_tpu_torch.transport.connection.Connection` (SURVEY.md §2.1/§3.2:
recv loop, incremental parse, rate limiting, keepalive/retry timers,
serialized writes), rebuilt on ``asyncio.Protocol`` instead of streams.

Why this exists: the stream path costs ~6 event-loop callback hops per
message (reader-task wakeup, StreamReader buffering, out-queue put,
writer-task wakeup, drain) — measured as the dominant cost of BASELINE
config 1 on one core.  A Protocol collapses the whole per-packet path
into ONE synchronous call chain: ``data_received → Parser.feed →
Channel.handle_in → transport.write``.  No per-connection tasks at all;
timers ride ``loop.call_later``.

The async advisory stage (exhook / cluster takeover / TPU prefetch /
network authn) can't run synchronously — when a node installs
``intercept``, packets route through an ordered queue consumed by one
worker task, which is exactly the stream path's cost model.  Plain
nodes (no interceptors) stay on the zero-task fast path; the decision
is per-connection at accept time.

Backpressure: ``pause_writing`` buffers outgoing packets and pauses
reading (a slow consumer throttles its own socket, the activate-N
discipline); byte/message token buckets pause reading on overdraft and
resume via ``call_later``.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, List, Optional

from .. import faultinject as _fi
from ..broker.channel import Channel
from ..broker.limiter import LimiterGroup
from ..mqtt import frame as F
from ..mqtt import packet as P
from .connection import ConnInfo, set_nodelay

log = logging.getLogger(__name__)

__all__ = ["MqttProtocol"]


class MqttProtocol(asyncio.Protocol):
    TICK_S = 1.0
    # intercept-mode queue watermarks (packets): reading pauses past
    # HIGH and resumes once the worker drains below LOW
    QUEUE_HIGH_WATER = 256
    QUEUE_LOW_WATER = 64
    # ingest_parse stage histogram (observe/hist.py): the node's
    # factory points this at its plane's histogram (shard conns get
    # their shard's instance — each is written only by its own loop);
    # None keeps the parse path at zero recording calls
    _h_parse = None

    def __init__(
        self,
        channel: Channel,
        conninfo: Optional[ConnInfo] = None,
        max_packet_size: int = F.MAX_REMAINING_LEN,
        limiter: Optional[LimiterGroup] = None,
        on_closed=None,
        intercept=None,
        metrics=None,
        coalesce: bool = True,
        wheel=None,
    ) -> None:
        self.channel = channel
        self.conninfo = conninfo or ConnInfo()
        # ack-run + publish-run fast paths only on the zero-task
        # datapath: with an advisory stage the ordered queue handles
        # packets one at a time, so runs would just be re-expanded
        self.parser = F.Parser(max_packet_size=max_packet_size,
                               ack_runs=coalesce and intercept is None,
                               publish_runs=coalesce and intercept is None)
        # hashed timer wheel (transport/timerwheel.py): when the node
        # provides one, the per-connection keepalive/retry tick rides a
        # coarse bucket — one scheduled callback per wheel tick for ALL
        # connections — instead of one loop.call_later per connection
        # per second.  None keeps the per-connection timer exactly.
        self.wheel = wheel
        self.limiter = limiter
        self.on_closed = on_closed
        self.intercept = intercept
        self.metrics = metrics
        # the batched-stack opt-in (rides broker.fanout.enable at the
        # node level): ack-burst batching, write coalescing and the
        # QoS1 wire-template cache.  Off → per-packet handling and one
        # write per packet, byte-for-byte the pre-batching datapath.
        self.coalesce = coalesce
        self.transport: Optional[asyncio.Transport] = None
        self.bytes_in = 0
        self.bytes_out = 0
        self.pkts_in = 0
        self.pkts_out = 0
        self._closed = False
        self._close_reason = "closed"
        self._paused_write = False
        self._pending_out: List[bytes] = []
        # write-coalescing buffer: while a batch is open (one TCP read's
        # worth of inbound packets, one worker iteration, one timer
        # tick), every outgoing packet lands here and flushes as ONE
        # transport write — PUBACK/PUBREC/PUBREL/PUBCOMP bursts,
        # retained replays and ack-triggered queue drains stop costing
        # one syscall per packet.  Packet bytes are identical; only the
        # write boundaries coalesce.
        self._batching = False
        self._wbuf: List[bytes] = []
        self._wbuf_pkts = 0
        self._tick_handle = None
        self._msg_bucket = None
        self._byte_bucket = None
        self._queue: Optional[asyncio.Queue] = None
        self._worker: Optional[asyncio.Task] = None
        self._paused_read_queue = False

    # -- asyncio.Protocol ----------------------------------------------

    def connection_made(self, transport) -> None:
        self.transport = transport
        set_nodelay(transport.get_extra_info("socket"))
        self.conninfo.peername = transport.get_extra_info("peername")
        self.conninfo.sockname = transport.get_extra_info("sockname")
        # the channel's auth/flapping context sees the real peer address
        self.channel.conninfo["peername"] = self.conninfo.peername
        if self.limiter is not None:
            self._msg_bucket, self._byte_bucket = \
                self.limiter.conn_buckets(str(id(self)))
        if self.intercept is not None:
            # advisory stage present: packets take the ordered-queue
            # path so async round trips can't reorder handling
            self._queue = asyncio.Queue()
            self._worker = asyncio.ensure_future(self._worker_loop())
        if self.wheel is not None:
            # wheel mode: the storm problem the jitter below works
            # around does not exist — all due connections run inside
            # ONE bucket callback per tick, so alignment is free
            self._tick_handle = self.wheel.call_later(
                self.TICK_S, self._tick)
        else:
            # jitter the first tick: connections accepted in one storm
            # would otherwise fire thousands of keepalive timers in the
            # same millisecond every second — a recurring latency spike
            self._tick_handle = asyncio.get_running_loop().call_later(
                self.TICK_S * (0.5 + (id(self) % 1024) / 1024.0),
                self._tick)

    def data_received(self, data: bytes) -> None:
        self.bytes_in += len(data)
        if self._byte_bucket is not None and not self._byte_bucket.unlimited:
            ok, wait = self._byte_bucket.consume(len(data))
            if not ok:
                self._pause_read_for(wait)
        h_parse = self._h_parse
        t0 = time.perf_counter_ns() if h_parse is not None else 0
        try:
            pkts = self.parser.feed(data)
        except F.FrameError as e:
            self._frame_error(e)
            return
        if h_parse is not None:
            # one record per transport read: wire bytes → packet objects
            h_parse.record(time.perf_counter_ns() - t0)
        if self._queue is not None:
            for pkt in pkts:
                self._queue.put_nowait(pkt)
            # backpressure the SOCKET, not just the worker: while the
            # async advisory stage is slow, unread bytes must park in
            # the kernel buffer (and the sender's window), not in an
            # unbounded parsed-packet queue — the stream path had this
            # implicitly by awaiting each packet's handling
            if self._queue.qsize() >= self.QUEUE_HIGH_WATER \
                    and not self._paused_read_queue:
                self._paused_read_queue = True
                try:
                    self.transport.pause_reading()
                except RuntimeError:
                    self._paused_read_queue = False
            return
        if not self.coalesce:
            for pkt in pkts:
                self.pkts_in += 1
                if (
                    self._msg_bucket is not None
                    and not self._msg_bucket.unlimited
                    and pkt.type == P.PUBLISH
                ):
                    ok, wait = self._msg_bucket.consume(1.0)
                    if not ok:
                        self._pause_read_for(wait)
                self._run_actions(self.channel.handle_in(pkt))
                if self._closed:
                    return
            return
        channel = self.channel
        self._batching = True
        try:
            i = 0
            n = len(pkts)
            while i < n:
                pkt = pkts[i]
                if type(pkt) is P.AckRun:
                    if channel.state != "connected":
                        # pre-CONNECT acks are a protocol error: replay
                        # per-packet so the close reason matches the
                        # slow path exactly
                        for sub in pkt.expand():
                            self.pkts_in += 1
                            self._run_actions(channel.handle_in(sub))
                            if self._closed:
                                return
                        i += 1
                        continue
                    # packed ack run off the parser fast path: ONE
                    # batched session transition for the whole burst,
                    # one reply burst, one refill cycle
                    self.pkts_in += len(pkt.pids)
                    if self.metrics is not None:
                        self.metrics.inc("broker.ack.run_parsed")
                    reply, refill = channel.handle_ack_run(pkt)
                    if reply:
                        self._send_raw(reply, len(pkt.pids))
                    if refill:
                        self.deliver(refill)
                    i += 1
                    if self._closed:
                        return
                    continue
                if type(pkt) is P.PublishRun:
                    if channel.state != "connected":
                        # pre-CONNECT publishes are a protocol error:
                        # replay per-packet so the close reason matches
                        # the slow path exactly
                        for sub in pkt.expand():
                            self.pkts_in += 1
                            self._run_actions(channel.handle_in(sub))
                            if self._closed:
                                return
                        i += 1
                        continue
                    # contiguous same-client QoS1/2 PUBLISH run: ONE
                    # amortized authz/alias pass, one PUBACK/PUBREC
                    # burst through the open write batch.  `rest` is
                    # whatever the fast path could not guarantee
                    # (pipeline refusing) — replayed per-packet,
                    # byte-identical to the slow path.
                    reply, acts, rest = channel.handle_publish_run(pkt)
                    consumed = len(pkt.pkts) - len(rest)
                    if consumed:
                        self.pkts_in += consumed
                        if self._msg_bucket is not None \
                                and not self._msg_bucket.unlimited:
                            ok, wait = self._msg_bucket.consume(
                                float(consumed))
                            if not ok:
                                self._pause_read_for(wait)
                        if self.metrics is not None:
                            self.metrics.inc("broker.ingest.publish_runs")
                    if reply:
                        self._send_raw(reply, consumed)
                    if acts:
                        self._run_actions(acts)
                    if self._closed:
                        return
                    for sub in rest:
                        self.pkts_in += 1
                        if (
                            self._msg_bucket is not None
                            and not self._msg_bucket.unlimited
                        ):
                            ok, wait = self._msg_bucket.consume(1.0)
                            if not ok:
                                self._pause_read_for(wait)
                        self._run_actions(channel.handle_in(sub))
                        if self._closed:
                            return
                    i += 1
                    continue
                if (
                    pkt.type == P.PUBACK
                    and channel.state == "connected"
                    and i + 1 < n
                    and pkts[i + 1].type == P.PUBACK
                ):
                    # PUBACK burst (a windowed consumer acks a whole
                    # TCP read in one write): ack them all, refill the
                    # window ONCE, send the refills through the bulk
                    # wire path.  (With the ack-run parser these arrive
                    # packed above; this branch covers coalesce mode
                    # with an advisory stage, where runs are disabled.)
                    j = i + 2
                    while j < n and pkts[j].type == P.PUBACK:
                        j += 1
                    self.pkts_in += j - i
                    refill = channel.handle_puback_batch(pkts[i:j])
                    if refill:
                        self.deliver(refill)
                    i = j
                    if self._closed:
                        return
                    continue
                self.pkts_in += 1
                if (
                    self._msg_bucket is not None
                    and not self._msg_bucket.unlimited
                    and pkt.type == P.PUBLISH
                ):
                    ok, wait = self._msg_bucket.consume(1.0)
                    if not ok:
                        self._pause_read_for(wait)
                self._run_actions(channel.handle_in(pkt))
                if self._closed:
                    return
                i += 1
        finally:
            self._flush_writes()

    def connection_lost(self, exc) -> None:
        if self._tick_handle is not None:
            self._tick_handle.cancel()
        if self._worker is not None:
            self._worker.cancel()
        if not self._closed:
            self._closed = True
            self._close_reason = "peer closed"
        self.channel.handle_close(self._close_reason)
        if self.on_closed is not None:
            self.on_closed(self)
        if self.limiter is not None:
            self.limiter.drop_conn(str(id(self)))

    def pause_writing(self) -> None:
        self._paused_write = True
        # a consumer that can't drain its socket must not keep feeding
        # the broker either
        if self.transport is not None:
            try:
                self.transport.pause_reading()
            except RuntimeError:
                pass  # transport already closing: nothing to pause

    def resume_writing(self) -> None:
        self._paused_write = False
        if self._pending_out:
            pending, self._pending_out = self._pending_out, []
            for data in pending:
                self.transport.write(data)
        if self.transport is not None and not self._closed \
                and not self._paused_read_queue:
            try:
                self.transport.resume_reading()
            except RuntimeError:
                pass  # transport already closing: nothing to resume

    # -- async advisory path -------------------------------------------

    async def _worker_loop(self) -> None:
        while not self._closed:
            pkt = await self._queue.get()
            if self._paused_read_queue \
                    and self._queue.qsize() <= self.QUEUE_LOW_WATER:
                self._paused_read_queue = False
                if not self._closed and not self._paused_write:
                    try:
                        self.transport.resume_reading()
                    except RuntimeError:
                        pass  # transport already closing mid-drain
            self.pkts_in += 1
            try:
                if (
                    self._msg_bucket is not None
                    and not self._msg_bucket.unlimited
                    and pkt.type == P.PUBLISH
                ):
                    ok, wait = self._msg_bucket.consume(1.0)
                    if not ok:
                        await asyncio.sleep(wait)
                if self.intercept is not None and pkt.type in (
                    P.CONNECT, P.PUBLISH, P.SUBSCRIBE, P.UNSUBSCRIBE
                ):
                    actions = await self.intercept(self.channel, pkt)
                    if self._closed or self.channel.state == "disconnected":
                        return
                    if actions is not None:
                        self.channel.last_rx = time.time()
                        self._batching = self.coalesce
                        try:
                            self._run_actions(actions)
                        finally:
                            self._flush_writes()
                        continue
                self._batching = self.coalesce
                try:
                    self._run_actions(self.channel.handle_in(pkt))
                finally:
                    self._flush_writes()
            except asyncio.CancelledError:
                return  # connection closing: the worker exits with it
            except Exception:
                log.exception("protocol worker crashed (%s)",
                              self.conninfo.peername)
                self._do_close("internal error")
                return

    # -- broker-facing surface (same contract as Connection) -----------

    def deliver(self, pubs: List[Any]) -> None:
        """Routed deliveries.  The fanout pipeline hands MANY publishes
        per call, so this path serializes them all and issues ONE
        transport write (vs one syscall per message), and QoS0 publishes
        cache their wire bytes on the Message — a B-subscriber fan-out
        of a shared (zero-copy) message serializes once, not B times.
        On the batched stack (``coalesce``), QoS1/2 publishes cache a
        wire TEMPLATE: a fan-out leg differs from its siblings only in
        the 2 packet-id bytes, so one serialize + a per-leg patch
        replaces B full serializer passes.  The generic action path
        still serves everything else."""
        if self._closed or self.transport is None:
            return
        channel = self.channel
        ver = channel.proto_ver
        chunks: List[bytes] = []
        for p in pubs:
            data = None
            m = p.msg
            if p.pid is None:
                cache = m.__dict__.get("_wire")
                if cache is not None:
                    data = cache.get(ver)
            elif self.coalesce and not m.dup:
                cache = m.__dict__.get("_wire1")
                ent = cache.get(ver) if cache is not None else None
                if ent is not None:
                    tpl, off = ent
                    buf = bytearray(tpl)
                    buf[off] = p.pid >> 8
                    buf[off + 1] = p.pid & 0xFF
                    data = bytes(buf)
            if data is None:
                try:
                    data = F.serialize(channel._to_publish_pkt(p), ver=ver)
                except Exception:
                    log.exception("serialize failed (%s)",
                                  self.conninfo.peername)
                    continue
                if p.pid is None and not m.dup:
                    cache = m.__dict__.get("_wire")
                    if cache is None:
                        cache = m.__dict__["_wire"] = {}
                    cache[ver] = data
                elif self.coalesce and not m.dup:
                    # packet id sits right after the topic string in
                    # both v4 and v5 (§2.2.1 / §3.3.2.2): fixed header
                    # byte + remaining-length varint + 2-byte topic
                    # length + topic
                    vi = 1
                    while data[vi] & 0x80:
                        vi += 1
                    hdr = vi + 1
                    off = hdr + 2 + ((data[hdr] << 8) | data[hdr + 1])
                    cache = m.__dict__.get("_wire1")
                    if cache is None:
                        cache = m.__dict__["_wire1"] = {}
                    cache[ver] = (data, off)
            chunks.append(data)
        if not chunks:
            return
        self.pkts_out += len(chunks)
        data = chunks[0] if len(chunks) == 1 else b"".join(chunks)
        self.bytes_out += len(data)
        if _fi._injector is not None and not self._batching:
            # chaos seam: the fanout emit path writes here directly
            # (outside an inbound batch) — same drop/dup semantics as
            # the coalesced flush
            act = _fi._injector.act("transport.write")
            if act == "drop":
                return
            if act == "dup" and not self._paused_write \
                    and self.transport is not None:
                self.transport.write(data)
            if act == "raise":
                raise _fi.InjectedFault("transport.write")
        if self._batching:
            # deliveries landing re-entrantly while an inbound batch is
            # being handled (publisher subscribed to its own topic) stay
            # FIFO with the buffered acks and share their flush write
            self._wbuf.append(data)
            self._wbuf_pkts += len(chunks)
        elif self._paused_write:
            self._pending_out.append(data)
        else:
            self.transport.write(data)

    def kick(self, reason: str = "kicked") -> None:
        self._run_actions(self.channel.handle_takeover()
                          if reason == "takeover" else [("close", reason)])

    def _run_actions(self, actions: List[Any]) -> None:
        for act, arg in actions:
            if act == "send":
                self._send_pkt(arg)
            elif act == "close":
                self._do_close(str(arg))
            elif act == "takeover":
                old_conn = getattr(arg, "conn", None)
                acts = arg.handle_takeover()
                if old_conn is not None and old_conn is not self:
                    old_conn._run_actions(acts)

    # pid-only ack heads whose wire shape is fixed 4 bytes (PUBREL
    # carries its mandatory 0b0010 flags)
    _ACK_HEADS = {P.PUBACK: P.PUBACK << 4, P.PUBREC: P.PUBREC << 4,
                  P.PUBREL: (P.PUBREL << 4) | 2, P.PUBCOMP: P.PUBCOMP << 4}

    def _send_pkt(self, pkt: Any) -> None:
        if self._closed or self.transport is None:
            return
        head = self._ACK_HEADS.get(pkt.type) if self.coalesce else None
        if head is not None and type(pkt) is P.PubAck and (
            self.channel.proto_ver != 5
            or (pkt.reason_code == 0 and not pkt.properties)
        ):
            # serializer-free pid-only ack: identical 4 bytes (a v3/v4
            # wire never carries the rc; v5 rc-0/no-props is pid-only)
            pid = pkt.packet_id
            self._send_raw(bytes((head, 2, pid >> 8, pid & 0xFF)), 1)
            return
        try:
            data = F.serialize(pkt, ver=self.channel.proto_ver)
        except Exception:
            log.exception("serialize failed (%s)", self.conninfo.peername)
            return
        self.bytes_out += len(data)
        self.pkts_out += 1
        if self._batching:
            self._wbuf.append(data)
            self._wbuf_pkts += 1
        elif self._paused_write:
            self._pending_out.append(data)
        else:
            self.transport.write(data)

    def _send_raw(self, data: bytes, npkts: int) -> None:
        """Queue pre-serialized wire bytes (ack reply bursts, template
        resends) through the same batching/backpressure states as
        :meth:`_send_pkt`."""
        if self._closed or self.transport is None or not data:
            return
        self.bytes_out += len(data)
        self.pkts_out += npkts
        if self._batching:
            self._wbuf.append(data)
            self._wbuf_pkts += npkts
        elif self._paused_write:
            self._pending_out.append(data)
        else:
            self.transport.write(data)

    def _flush_writes(self) -> None:
        """Close the write batch: ONE transport write for everything
        buffered since it opened (ack bursts coalesce here)."""
        self._batching = False
        buf = self._wbuf
        if not buf:
            self._wbuf_pkts = 0
            return
        data = buf[0] if len(buf) == 1 else b"".join(buf)
        del buf[:]
        if self._wbuf_pkts > 1 and self.metrics is not None:
            self.metrics.inc("broker.ack.coalesced_writes")
        self._wbuf_pkts = 0
        if _fi._injector is not None:
            # chaos seam: lose or duplicate one coalesced flush on the
            # wire — the session retry machinery must heal the gap
            act = _fi._injector.act("transport.write")
            if act == "drop":
                return
            if act == "dup" and not self._paused_write \
                    and self.transport is not None:
                self.transport.write(data)
            if act == "raise":
                raise _fi.InjectedFault("transport.write")
        if self._paused_write:
            self._pending_out.append(data)
        elif self.transport is not None:
            self.transport.write(data)

    def _do_close(self, reason: str) -> None:
        if self._closed:
            return
        self._closed = True
        self._close_reason = reason
        if self.transport is not None:
            # flush the goodbye even under write pressure —
            # transport.write() only buffers while paused, and close()
            # tears down after the send buffer drains; dropping it
            # would turn a takeover DISCONNECT into a bare TCP reset.
            # _pending_out (paused-period backlog) predates the open
            # write batch, so it flushes first.
            for data in self._pending_out:
                self.transport.write(data)
            self._pending_out.clear()
            for data in self._wbuf:
                self.transport.write(data)
            self._wbuf.clear()
            self._wbuf_pkts = 0
            self.transport.close()

    def _frame_error(self, e: F.FrameError) -> None:
        adm = self.channel.broker.admission
        if adm is not None:
            # admission feature seam: malformed-frame rate.  Safe from
            # a shard loop — note_malformed only appends to a deque,
            # drained by the scorer on the main loop.
            adm.note_malformed(self.channel.clientid,
                               self.conninfo.peername)
        if self.channel.proto_ver == 5 and self.channel.state == "connected":
            self._send_pkt(P.Disconnect(reason_code=e.reason_code))
        self._do_close(f"frame error: {e}")

    def _pause_read_for(self, wait: float) -> None:
        if self.transport is None or self._closed:
            return
        try:
            self.transport.pause_reading()
        except RuntimeError:
            return  # transport already closing: no pacing needed

        def _resume():
            # a limiter resume must not undo queue/write backpressure —
            # those resume themselves when their own condition clears
            if self.transport is not None and not self._closed \
                    and not self._paused_write \
                    and not self._paused_read_queue:
                try:
                    self.transport.resume_reading()
                except RuntimeError:
                    pass  # transport closed while the pause timer ran

        asyncio.get_running_loop().call_later(max(wait, 0.001), _resume)

    def _tick(self) -> None:
        if self._closed:
            return
        try:
            self._batching = self.coalesce
            try:
                self._run_actions(self.channel.check_keepalive())
                if self.coalesce:
                    # batched resend: template-patched wire bytes, one
                    # coalesced flush for the whole tick
                    for chunk in self.channel.retry_wire_batch():
                        self._send_raw(chunk, 1)
                else:
                    self._run_actions(self.channel.retry_deliveries())
            finally:
                self._flush_writes()
            if not self._closed:
                # the flush reached the transport: commit the DUP
                # clones / age clocks (a raised write or a close mid-
                # tick leaves the entries due, so the next tick
                # re-offers them)
                self.channel.retry_commit()
        except Exception:
            log.exception("tick failed (%s)", self.conninfo.peername)
        if not self._closed:
            if self.wheel is not None:
                self._tick_handle = self.wheel.call_later(
                    self.TICK_S, self._tick)
            else:
                self._tick_handle = asyncio.get_running_loop().call_later(
                    self.TICK_S, self._tick)

    def info(self) -> dict:
        ch = self.channel
        return {
            "clientid": ch.clientid,
            "peername": self.conninfo.peername,
            "listener": self.conninfo.listener,
            "proto_ver": ch.proto_ver,
            "connected_at": self.conninfo.connected_at,
            "keepalive": ch.keepalive,
            "recv_oct": self.bytes_in,
            "send_oct": self.bytes_out,
            "recv_pkt": self.pkts_in,
            "send_pkt": self.pkts_out,
        }
