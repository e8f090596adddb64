"""The port's network transport: the TCP listener, the protocol-mode fast
path, the stream-path connection and the batched stack's timer wheel."""

from .connection import Connection, ConnInfo
from .listener import Listener, Listeners

__all__ = ["Connection", "ConnInfo", "Listener", "Listeners"]
