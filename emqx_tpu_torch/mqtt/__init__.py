"""The port's own copy of the reference's ``emqx_tpu/mqtt/__init__.py``, so
that nothing here imports the JAX package.

MQTT protocol layer: packets, wire codec, channel FSM."""

from . import packet
from .frame import FrameError, Parser, parse_one, serialize

__all__ = ["packet", "FrameError", "Parser", "parse_one", "serialize"]
