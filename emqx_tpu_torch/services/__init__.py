"""The services that the node turns on by default: the retainer and the
delayed publish, each on the broker's hook bus."""

from .delayed import DelayedPublish
from .retainer import Retainer

__all__ = ["DelayedPublish", "Retainer"]
