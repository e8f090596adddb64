"""Observability of the port: the fixed counter table, the stats gauges,
the alarms, the stage histograms and the flight recorder."""

from .alarm import Alarm, Alarms
from .flightrec import DUMP_REASONS, FlightRecorder
from .hist import HIST_NAMES, HistSet, LatencyHistogram
from .metrics import Metrics
from .stats import STAT_NAMES, Stats

__all__ = ["Alarm", "Alarms", "DUMP_REASONS", "FlightRecorder",
           "HIST_NAMES", "HistSet", "LatencyHistogram", "Metrics",
           "STAT_NAMES", "Stats"]
