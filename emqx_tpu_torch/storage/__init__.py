"""Persistent compacted table segments (``segments.py``): the match
table's cold start without the rebuild."""

from .segments import (SEGMENT_VERSION, Segment, SegmentError, load_segment,
                       restore_incremental, save_segment)

__all__ = ["SEGMENT_VERSION", "Segment", "SegmentError", "load_segment",
           "restore_incremental", "save_segment"]
