"""Observability of the port: the fixed counter table."""

from .metrics import Metrics

__all__ = ["Metrics"]
