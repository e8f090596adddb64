"""The port's own copy of the reference's ``emqx_tpu/transport/connection.py``, so
that nothing here imports the JAX package.

Per-socket connection loop driving the IO-free Channel FSM.

Behavioral reference: ``emqx_connection.erl`` [U] (SURVEY.md §2.1, §3.2):
the socket-owner process — recv loop with activate-N-style bounded reads,
incremental frame parsing, rate limiting, keepalive/retry timers, and
serialized writes.  Here: one reader task + one writer task per socket; the
Channel stays synchronous and IO-free, this module owns all awaiting.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

from ..broker.channel import Channel
from ..broker.limiter import LimiterGroup
from ..mqtt import frame as F
from ..mqtt import packet as P

log = logging.getLogger(__name__)

__all__ = ["Connection", "ConnInfo", "TcpStream", "set_nodelay"]


def set_nodelay(sock) -> None:
    """TCP_NODELAY on an accepted/dialed socket (shared by the stream,
    protocol, and client paths)."""
    if sock is None:
        return
    try:
        import socket as _socket

        sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
    except OSError:
        pass  # best-effort opt: not a TCP socket, or already closed


@dataclass
class ConnInfo:
    peername: Any = None
    sockname: Any = None
    listener: str = "tcp:default"
    ws: bool = False
    tls: bool = False
    connected_at: float = field(default_factory=time.time)


class TcpStream:
    """Thin adapter over asyncio streams, same surface as
    a WebSocket stream."""

    def __init__(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._r = reader
        self._w = writer

    async def read(self, n: int) -> bytes:
        try:
            return await self._r.read(n)
        except ConnectionError:
            return b""

    def write(self, data: bytes) -> None:
        self._w.write(data)

    async def drain(self) -> None:
        await self._w.drain()

    def close(self) -> None:
        try:
            self._w.close()
        except Exception:
            log.debug("tcp transport close failed", exc_info=True)

    async def wait_closed(self) -> None:
        try:
            await self._w.wait_closed()
        except Exception:
            log.debug("tcp wait_closed failed", exc_info=True)

    def peername(self):
        return self._w.get_extra_info("peername")


class Connection:
    """Owns one client socket: reads bytes → Parser → Channel.handle_in,
    executes the returned actions, and flushes deliveries pushed by the
    broker.  ``recv_buf`` bounds each read (the activate-N analog: the
    connection never buffers more than one read's worth of unparsed
    input plus one partial packet).
    """

    TICK_S = 1.0

    def __init__(
        self,
        stream: Any,
        channel: Channel,
        conninfo: Optional[ConnInfo] = None,
        recv_buf: int = 65536,
        max_packet_size: int = F.MAX_REMAINING_LEN,
        limiter: Optional[LimiterGroup] = None,
        on_closed=None,
        coalesce: bool = False,
        wheel=None,
    ) -> None:
        self.stream = stream
        self.channel = channel
        self.conninfo = conninfo or ConnInfo()
        self.recv_buf = recv_buf
        # stream-path parity with the batched proto datapath: the same
        # opt-in enables the parser's ack-run + publish-run fast paths
        # (packed AckRun/PublishRun consumption below) — off, parsing
        # and handling stay the per-packet path, byte-identical
        self.coalesce = coalesce
        self.parser = F.Parser(max_packet_size=max_packet_size,
                               ack_runs=coalesce, publish_runs=coalesce)
        # hashed timer wheel (transport/timerwheel.py): when provided,
        # the keepalive/retry tick rides a shared bucket (one scheduled
        # callback per tick for every connection) instead of a
        # per-connection sleep loop task
        self.wheel = wheel
        self.limiter = limiter
        self.on_closed = on_closed
        # optional async advisory stage (exhook): awaited per packet before
        # handle_in; may mutate/tag the packet or return replacement actions
        self.intercept = None
        self._outq: asyncio.Queue = asyncio.Queue()
        self._closing = asyncio.Event()
        self._close_reason = "closed"
        self.bytes_in = 0
        self.bytes_out = 0
        self.pkts_in = 0
        self.pkts_out = 0

    # -- broker-facing -----------------------------------------------------

    def deliver(self, pubs: List[Any]) -> None:
        """Called (synchronously, on the loop) when routed messages land on
        this client's session."""
        self._run_actions(self.channel.handle_deliver(pubs))

    def kick(self, reason: str = "kicked") -> None:
        self._run_actions(self.channel.handle_takeover()
                          if reason == "takeover" else [("close", reason)])

    # -- lifecycle ---------------------------------------------------------

    async def run(self) -> None:
        """Serve until close; returns after the socket is torn down."""
        writer = asyncio.ensure_future(self._writer_loop())
        ticker = (self.wheel.call_repeat(self.TICK_S, self._tick_once)
                  if self.wheel is not None
                  else asyncio.ensure_future(self._tick_loop()))
        try:
            await self._reader_loop()
        except Exception:
            log.exception("connection crashed (%s)", self.conninfo.peername)
            self._close_reason = "internal error"
        finally:
            self._closing.set()
            await self._outq.put(None)  # unblock writer for final flush
            await writer
            ticker.cancel()
            self.channel.handle_close(self._close_reason)
            self.stream.close()
            await self.stream.wait_closed()
            if self.on_closed is not None:
                self.on_closed(self)

    async def _reader_loop(self) -> None:
        msg_bucket = byte_bucket = None
        if self.limiter is not None:
            msg_bucket, byte_bucket = self.limiter.conn_buckets(str(id(self)))
        while not self._closing.is_set():
            data = await self.stream.read(self.recv_buf)
            if not data:
                self._close_reason = "peer closed"
                return
            self.bytes_in += len(data)
            if byte_bucket is not None and not byte_bucket.unlimited:
                ok, wait = byte_bucket.consume(len(data))
                if not ok:
                    await asyncio.sleep(wait)  # flow control: pause reads
            try:
                pkts = self.parser.feed(data)
            except F.FrameError as e:
                self._frame_error(e)
                return
            for pkt in pkts:
                if type(pkt) is P.AckRun:
                    if self.channel.state != "connected":
                        for sub in pkt.expand():
                            self.pkts_in += 1
                            self._run_actions(self.channel.handle_in(sub))
                            if self._closing.is_set():
                                return
                        continue
                    # packed ack run: one batched session transition,
                    # reply burst rides the writer queue as raw bytes
                    self.pkts_in += len(pkt.pids)
                    reply, refill = self.channel.handle_ack_run(pkt)
                    if reply:
                        self._outq.put_nowait((reply, len(pkt.pids)))
                    if refill:
                        self._run_actions(
                            self.channel.handle_deliver(refill))
                    if self._closing.is_set():
                        return
                    continue
                if type(pkt) is P.PublishRun:
                    if self.channel.state != "connected" \
                            or self.intercept is not None:
                        # pre-CONNECT replay / advisory stage present:
                        # per-packet handling, byte-identical (the
                        # intercept must see each PUBLISH)
                        for sub in pkt.expand():
                            self.pkts_in += 1
                            if self.intercept is not None \
                                    and self.channel.state == "connected":
                                actions = await self.intercept(
                                    self.channel, sub)
                                if (self._closing.is_set() or
                                        self.channel.state
                                        == "disconnected"):
                                    return
                                if actions is not None:
                                    self.channel.last_rx = time.time()
                                    self._run_actions(actions)
                                    if self._closing.is_set():
                                        return
                                    continue
                            self._run_actions(self.channel.handle_in(sub))
                            if self._closing.is_set():
                                return
                        continue
                    reply, acts, rest = \
                        self.channel.handle_publish_run(pkt)
                    consumed = len(pkt.pkts) - len(rest)
                    if consumed:
                        self.pkts_in += consumed
                        if (
                            msg_bucket is not None
                            and not msg_bucket.unlimited
                        ):
                            ok, wait = msg_bucket.consume(float(consumed))
                            if not ok:
                                await asyncio.sleep(wait)
                    if reply:
                        self._outq.put_nowait((reply, consumed))
                    if acts:
                        self._run_actions(acts)
                    if self._closing.is_set():
                        return
                    for sub in rest:
                        self.pkts_in += 1
                        if (
                            msg_bucket is not None
                            and not msg_bucket.unlimited
                        ):
                            ok, wait = msg_bucket.consume(1.0)
                            if not ok:
                                await asyncio.sleep(wait)
                        self._run_actions(self.channel.handle_in(sub))
                        if self._closing.is_set():
                            return
                    continue
                self.pkts_in += 1
                if (
                    msg_bucket is not None
                    and not msg_bucket.unlimited
                    and pkt.type == P.PUBLISH
                ):
                    ok, wait = msg_bucket.consume(1.0)
                    if not ok:
                        await asyncio.sleep(wait)  # msg-rate flow control
                if self.intercept is not None and pkt.type in (
                    P.CONNECT, P.PUBLISH, P.SUBSCRIBE, P.UNSUBSCRIBE
                ):
                    actions = await self.intercept(self.channel, pkt)
                    # the await may span a takeover/kick: never hand the
                    # packet to a channel that died mid-round-trip
                    if (
                        self._closing.is_set()
                        or self.channel.state == "disconnected"
                    ):
                        return
                    if actions is not None:  # advisory deny replaces handling
                        # a denied packet still counts for keepalive
                        # (MQTT §3.1.2.10: any control packet received)
                        self.channel.last_rx = time.time()
                        self._run_actions(actions)
                        if self._closing.is_set():
                            return
                        continue
                self._run_actions(self.channel.handle_in(pkt))
                if self._closing.is_set():
                    return

    def _frame_error(self, e: F.FrameError) -> None:
        adm = self.channel.broker.admission
        if adm is not None:
            # admission feature seam: malformed-frame rate (stream-path
            # parity with proto_conn._frame_error)
            adm.note_malformed(self.channel.clientid,
                               self.conninfo.peername)
        # MQTT5 §4.13: respond DISCONNECT with the reason, then drop
        if self.channel.proto_ver == 5 and self.channel.state == "connected":
            self._send_pkt(P.Disconnect(reason_code=e.reason_code))
        self._close_reason = f"frame error: {e}"

    def _run_actions(self, actions: List[Any]) -> None:
        for act, arg in actions:
            if act == "send":
                self._send_pkt(arg)
            elif act == "close":
                self._close_reason = str(arg)
                self._closing.set()
                self._outq.put_nowait(None)
            elif act == "takeover":
                # arg is the displaced channel; route its goodbye through
                # the connection that owns it (emqx_cm takeover protocol)
                old_conn = getattr(arg, "conn", None)
                acts = arg.handle_takeover()
                if old_conn is not None and old_conn is not self:
                    old_conn._run_actions(acts)

    def _send_pkt(self, pkt: Any) -> None:
        self._outq.put_nowait(pkt)

    async def _writer_loop(self) -> None:
        """Single writer: serializes queue order, applies backpressure via
        drain() so one slow client never blocks the event loop.  Packets
        already queued coalesce into ONE stream write (ack bursts,
        retained replays, resume floods) — bytes are identical to
        per-packet writes, only the write boundaries merge."""
        while True:
            pkt = await self._outq.get()
            if pkt is None:
                if self._closing.is_set() and self._outq.empty():
                    # goodbye flushed: close the socket so a reader blocked
                    # in read() unblocks (server-initiated close)
                    try:
                        await self.stream.drain()
                    except ConnectionError:
                        pass  # peer already gone: close() below still runs
                    self.stream.close()
                    return
                continue
            try:
                # queue items are parsed packets OR (raw_bytes, npkts)
                # bursts from the ack-run path — both coalesce into one
                # stream write
                npkts = 0

                def _render(item):
                    nonlocal npkts
                    if type(item) is tuple:
                        npkts += item[1]
                        return item[0]
                    npkts += 1
                    return F.serialize(item, ver=self.channel.proto_ver)

                chunks = [_render(pkt)]
                while not self._outq.empty():
                    nxt = self._outq.get_nowait()
                    if nxt is None:
                        # re-park the close sentinel behind this flush;
                        # the goodbye packets were queued before it
                        self._outq.put_nowait(None)
                        break
                    chunks.append(_render(nxt))
                data = chunks[0] if len(chunks) == 1 else b"".join(chunks)
                self.stream.write(data)
                self.bytes_out += len(data)
                self.pkts_out += npkts
                if self._outq.empty():
                    await self.stream.drain()
            except ConnectionError:
                self._closing.set()
                return

    async def _tick_loop(self) -> None:
        while not self._closing.is_set():
            await asyncio.sleep(self.TICK_S)
            self._tick_once()

    def _tick_once(self) -> None:
        """One keepalive/retry pass — synchronous, so it runs either
        from the per-connection sleep loop or as a timer-wheel bucket
        entry (one scheduled callback per tick for ALL connections)."""
        if self._closing.is_set():
            return
        self._run_actions(self.channel.check_keepalive())
        self._run_actions(self.channel.retry_deliveries())
        if not self._closing.is_set():
            # resends queued to a live writer: commit the DUP
            # clones / age clocks; a closed connection leaves the
            # entries due for the session's next owner
            self.channel.retry_commit()

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
