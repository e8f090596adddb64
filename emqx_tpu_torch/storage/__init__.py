"""Durable storage of the match table: persistent compacted segments
(``segments.py``), the cold start without the rebuild, and the table
checkpoint of the match sidecar (``checkpoint.py``)."""

from .checkpoint import load_table, save_table
from .segments import (SEGMENT_VERSION, Segment, SegmentError, load_segment,
                       restore_incremental, save_segment)

__all__ = ["SEGMENT_VERSION", "Segment", "SegmentError", "load_segment",
           "restore_incremental", "save_segment", "load_table", "save_table"]
