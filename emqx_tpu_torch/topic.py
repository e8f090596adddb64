"""MQTT topic algebra for the port: split, validate and the match oracle.

The port's own copy of the reference's topic rules (``emqx_tpu/topic.py``),
so that nothing here imports the JAX package.  Semantics (MQTT v3.1.1 /
v5.0, emqx behaviour):

* levels are separated by ``/``; empty levels are significant
  (``"a//b"`` has three levels);
* ``+`` matches exactly one level, ``#`` zero or more trailing levels;
* topics whose first level starts with ``$`` are not matched by filters
  that start with ``+`` or ``#``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

MAX_TOPIC_LEN = 65535  # bytes, per the MQTT spec

SHARE_PREFIX = "$share"
QUEUE_PREFIX = "$queue"

__all__ = ["TopicError", "words", "join", "levels", "wildcard", "is_sys",
           "validate", "is_valid", "match", "parse_share", "is_shared", "strip_share",
           "make_share"]


class TopicError(ValueError):
    """Raised for malformed topics / filters."""


def words(topic: str) -> List[str]:
    """Split a topic into its levels.  ``"a//b"`` → ``['a', '', 'b']``."""
    return topic.split("/")


def join(ws: Sequence[str]) -> str:
    """Inverse of :func:`words`."""
    return "/".join(ws)


def levels(topic: str) -> int:
    return len(words(topic))


def wildcard(topic_or_words) -> bool:
    """True if the filter contains ``+`` or ``#`` at any level."""
    ws = (words(topic_or_words) if isinstance(topic_or_words, str)
          else topic_or_words)
    return any(w in ("+", "#") for w in ws)


def is_sys(topic: str) -> bool:
    """True for ``$``-prefixed topics (``$SYS/...``)."""
    return topic.startswith("$")


def parse_share(flt: str) -> Optional[Tuple[str, str]]:
    """``"$share/g/a/b"`` → ``("g", "a/b")``; ``"$queue/t"`` →
    ``("$queue", "t")``; anything else → None."""
    if flt.startswith(SHARE_PREFIX + "/"):
        group, sep, real = flt[len(SHARE_PREFIX) + 1:].partition("/")
        return (group, real if sep else "")
    if flt.startswith(QUEUE_PREFIX + "/"):
        return (QUEUE_PREFIX, flt[len(QUEUE_PREFIX) + 1:])
    return None


def is_shared(flt: str) -> bool:
    return parse_share(flt) is not None


def strip_share(flt: str) -> str:
    """The real filter, share prefix removed (identity otherwise)."""
    share = parse_share(flt)
    return share[1] if share is not None else flt


def make_share(group: str, real: str) -> str:
    return f"{SHARE_PREFIX}/{group}/{real}"


def validate(topic: str, kind: str = "filter") -> None:
    """Validate a topic name (``kind='name'``) or filter
    (``kind='filter'``); raises :class:`TopicError` on violation."""
    if kind not in ("name", "filter"):
        raise ValueError(f"bad kind: {kind!r}")
    if topic == "":
        raise TopicError("empty topic")
    if len(topic.encode("utf-8")) > MAX_TOPIC_LEN:
        raise TopicError("topic too long")
    if "\x00" in topic:
        raise TopicError("NUL character in topic")
    if kind == "filter":
        share = parse_share(topic)
        if share is not None:
            group, real = share
            if group == "" or "+" in group or "#" in group:
                raise TopicError(f"invalid $share group: {group!r}")
            if real == "":
                raise TopicError("empty $share real filter")
            if parse_share(real) is not None:
                raise TopicError(f"nested $share filter: {topic!r}")
            return validate(real, "filter")
    ws = words(topic)
    for i, w in enumerate(ws):
        if kind == "name":
            if "+" in w or "#" in w:
                raise TopicError(f"wildcard in topic name: {topic!r}")
        elif w == "#":
            if i != len(ws) - 1:
                raise TopicError(f"'#' not at last level: {topic!r}")
        elif "#" in w:
            raise TopicError(f"'#' must occupy a whole level: {topic!r}")
        elif w != "+" and "+" in w:
            raise TopicError(f"'+' must occupy a whole level: {topic!r}")


def is_valid(topic: str, kind: str = "filter") -> bool:
    try:
        validate(topic, kind)
        return True
    except TopicError:
        return False

def match(name, flt) -> bool:
    """Does concrete topic ``name`` match filter ``flt``?  Both may be
    strings or pre-split word lists."""
    nw = words(name) if isinstance(name, str) else list(name)
    fw = words(flt) if isinstance(flt, str) else list(flt)
    if not nw or not fw:
        return False
    if nw[0].startswith("$") and fw[0] in ("+", "#"):
        return False
    i = 0
    for fword in fw:
        if fword == "#":
            return True
        if i >= len(nw):
            return False
        if fword == "+" or fword == nw[i]:
            i += 1
            continue
        return False
    return i == len(nw)
