"""The port's own copy of the reference's ``emqx_tpu/transport/listener.py``, so
that nothing here imports the JAX package.  It serves the ``tcp`` kind
over the protocol-mode fast path or the stream path; the ``ws`` kind,
TLS (``ssl_context``) and the connection-plane shard pool are not
ported, and asking for them raises :class:`NotImplementedError`.

Listeners: acceptor endpoints feeding connections into the broker.

Behavioral reference: ``emqx_listeners.erl`` + esockd acceptor pools /
cowboy WS [U] (SURVEY.md §3.1 boot).  asyncio's event-loop accept path
replaces esockd's acceptor pool; per-listener connection caps and a
connect-rate token bucket implement esockd's ``max_connections`` /
``max_conn_rate``.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Awaitable, Callable, Dict, List, Optional

from ..broker.limiter import TokenBucket
from .connection import ConnInfo, TcpStream, set_nodelay

log = logging.getLogger(__name__)

__all__ = ["Listener", "Listeners"]

# handler(stream, conninfo) -> runs the connection to completion
Handler = Callable[[object, ConnInfo], Awaitable[None]]


class _ShedProtocol(asyncio.Protocol):
    """Accept-and-close: the overload answer when the cap/rate trips."""

    def connection_made(self, transport) -> None:
        transport.close()


class Listener:
    def __init__(
        self,
        name: str,
        bind: str,
        handler: Handler,
        kind: str = "tcp",            # tcp (ws: not ported)
        ssl_context: Any = None,
        max_connections: int = 1 << 20,
        max_conn_rate: float = 0.0,   # conns/s, 0 = unlimited
        ws_path: str = "/mqtt",
        reuse_port: bool = False,
        proto_factory: Optional[Callable[[ConnInfo], object]] = None,
        shard_pool=None,
    ) -> None:
        if kind != "tcp":
            raise NotImplementedError(
                f"the {kind!r} listener kind is not ported")
        if ssl_context is not None:
            raise NotImplementedError("TLS listeners are not ported")
        if shard_pool is not None:
            raise NotImplementedError("connection shards are not ported")
        self.name = name
        self.kind = kind
        host, _, port = bind.rpartition(":")
        self.host, self.port = host or "0.0.0.0", int(port)
        self.handler = handler
        self.ssl_context = ssl_context
        self.max_connections = max_connections
        self.ws_path = ws_path
        # SO_REUSEPORT: several broker PROCESSES bind the same port and
        # the kernel load-balances accepted connections across them —
        # the esockd-multi-acceptor analog for scaling the connection
        # plane past one core (peers cluster as usual; routes replicate)
        self.reuse_port = reuse_port
        # protocol-mode datapath (transport/proto_conn.py): zero
        # per-connection tasks; used for plain TCP when the node
        # provides a factory
        self.proto_factory = proto_factory
        self._conn_rate = TokenBucket(max_conn_rate)
        self._server: Optional[asyncio.AbstractServer] = None
        self._main_conns = 0
        self.shed_count = 0

    @property
    def current_connections(self) -> int:
        """Live connections of the server."""
        return self._main_conns

    @property
    def running(self) -> bool:
        return self._server is not None

    async def start(self) -> None:
        if self.proto_factory is not None and self.kind == "tcp" \
                and self.ssl_context is None:
            loop = asyncio.get_running_loop()
            self._server = await loop.create_server(
                self._make_protocol, self.host, self.port,
                reuse_port=self.reuse_port or None,
            )
        else:
            self._server = await asyncio.start_server(
                self._accept, self.host, self.port, ssl=self.ssl_context,
                reuse_port=self.reuse_port or None,
            )
        # resolve the real port for bind=":0" (tests)
        socks = self._server.sockets or []
        if socks and self.port == 0:
            self.port = socks[0].getsockname()[1]
        log.info("listener %s (%s) on %s:%d", self.name, self.kind,
                 self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            try:
                # 3.12: wait_closed() blocks until every connection handler
                # returns; a socket that never spoke MQTT (so was never
                # kicked by the node) would hang us here forever
                await asyncio.wait_for(self._server.wait_closed(), timeout=5.0)
            except asyncio.TimeoutError:
                log.warning(
                    "listener %s: connections still open at stop", self.name
                )
            self._server = None

    def _make_protocol(self):
        """Protocol-mode accept with esockd-style shedding BEFORE any
        protocol work: past the cap/rate, not even a Channel is built —
        a trivial closing protocol answers the flood."""
        ok, _ = self._conn_rate.consume(1.0)
        if not ok or self.current_connections >= self.max_connections:
            self.shed_count += 1
            return _ShedProtocol()
        info = ConnInfo(listener=f"{self.kind}:{self.name}",
                        tls=self.ssl_context is not None)
        proto = self.proto_factory(info)
        orig_made = proto.connection_made
        orig_lost = proto.connection_lost

        def made(transport):
            self._main_conns += 1
            proto._listener_counted = True
            orig_made(transport)

        def lost(exc):
            if getattr(proto, "_listener_counted", False):
                self._main_conns -= 1
            orig_lost(exc)

        proto.connection_made = made
        proto.connection_lost = lost
        return proto

    async def _accept(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        ok, _ = self._conn_rate.consume(1.0)
        if not ok or self.current_connections >= self.max_connections:
            # esockd sheds by closing the socket before any protocol work
            self.shed_count += 1
            writer.close()
            return
        self._main_conns += 1
        set_nodelay(writer.get_extra_info("socket"))
        info = ConnInfo(
            peername=writer.get_extra_info("peername"),
            sockname=writer.get_extra_info("sockname"),
            listener=f"{self.kind}:{self.name}",
            ws=self.kind == "ws",
            tls=self.ssl_context is not None,
        )
        try:
            await self.handler(TcpStream(reader, writer), info)
        except Exception:
            log.exception("listener %s: connection handler crashed", self.name)
            writer.close()
        finally:
            self._main_conns -= 1

    def info(self) -> dict:
        return {
            "id": f"{self.kind}:{self.name}",
            "type": self.kind,
            "bind": f"{self.host}:{self.port}",
            "running": self.running,
            "max_connections": self.max_connections,
            "current_connections": self.current_connections,
            "shed_count": self.shed_count,
        }


class Listeners:
    """Registry of named listeners (start/stop all, REST surface)."""

    def __init__(self) -> None:
        self._by_id: Dict[str, Listener] = {}

    def add(self, lst: Listener) -> Listener:
        self._by_id[f"{lst.kind}:{lst.name}"] = lst
        return lst

    def get(self, lid: str) -> Optional[Listener]:
        return self._by_id.get(lid)

    def all(self) -> List[Listener]:
        return list(self._by_id.values())

    async def start_all(self) -> None:
        for lst in self._by_id.values():
            if not lst.running:
                await lst.start()

    async def stop_all(self) -> None:
        for lst in self._by_id.values():
            await lst.stop()
