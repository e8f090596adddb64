"""Device data plane of the port: NFA tables, the join relation, the
walk kernels, the resident device table."""

from .compiler import BUCKET_SLOTS, NfaTable, compile_filters, encode_topics
from .device_table import DeviceNfa
from .encode import TopicEncoder, encode_batch
from .incremental import IncrementalNfa, NfaDelta
from .join_match import (OVERLAY_CAP, JoinRelation, OverlayFull, join_match,
                         relation_capacity)
from .match_kernel import MatchResult, match_topics, nfa_match
from .walk_kernel import join_walk, join_walk_plain, nfa_walk, nfa_walk_plain

__all__ = [
    "BUCKET_SLOTS", "NfaTable", "compile_filters", "encode_topics",
    "DeviceNfa", "TopicEncoder", "encode_batch", "IncrementalNfa",
    "NfaDelta", "MatchResult", "match_topics", "nfa_match", "nfa_walk", "nfa_walk_plain",
    "OVERLAY_CAP", "JoinRelation", "OverlayFull", "join_match",
    "relation_capacity", "join_walk", "join_walk_plain",
]
