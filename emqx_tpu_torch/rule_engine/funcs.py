"""Builtin SQL functions — the ``emqx_rule_funcs`` analog.

The port's own copy of the reference's ``emqx_tpu/rule_engine/funcs.py``
(nothing here imports the JAX package).

Behavioral reference: ``apps/emqx_rule_engine/src/emqx_rule_funcs.erl``
[U] (SURVEY.md §2.3) — the commonly-used subset of its ~40 exported
families: math, string, map/array, json, codec/hash, time, type
conversion and conditionals.  1-based indexing (``nth``/``substr``)
matches the reference's Erlang heritage.
"""

from __future__ import annotations

import base64
import hashlib
import json
import re
import time
import uuid
from typing import Any, Callable, Dict, List

__all__ = ["FUNCS", "call_func"]


def _num(x: Any) -> float:
    if isinstance(x, bool):
        return 1.0 if x else 0.0
    if isinstance(x, (int, float)):
        return float(x)
    return float(str(x))


def _int(x: Any) -> int:
    return int(_num(x))


def _str(x: Any) -> str:
    if isinstance(x, bytes):
        return x.decode("utf-8", "replace")
    if isinstance(x, bool):
        return "true" if x else "false"
    if x is None:
        return ""
    if isinstance(x, float) and x.is_integer():
        return str(int(x))
    return str(x)


def _bytes(x: Any) -> bytes:
    if isinstance(x, bytes):
        return x
    return _str(x).encode()


FUNCS: Dict[str, Callable[..., Any]] = {}


def _reg(name):
    def deco(fn):
        FUNCS[name] = fn
        return fn
    return deco


# -- math -------------------------------------------------------------------
import math as _m

FUNCS.update({
    "abs": lambda x: abs(_num(x)),
    "ceil": lambda x: _m.ceil(_num(x)),
    "floor": lambda x: _m.floor(_num(x)),
    "round": lambda x: round(_num(x)),
    "sqrt": lambda x: _m.sqrt(_num(x)),
    "pow": lambda x, y: _m.pow(_num(x), _num(y)),
    "power": lambda x, y: _m.pow(_num(x), _num(y)),
    "exp": lambda x: _m.exp(_num(x)),
    "log": lambda x: _m.log(_num(x)),
    "log10": lambda x: _m.log10(_num(x)),
    "log2": lambda x: _m.log2(_num(x)),
    "sin": lambda x: _m.sin(_num(x)),
    "cos": lambda x: _m.cos(_num(x)),
    "tan": lambda x: _m.tan(_num(x)),
    "fmod": lambda x, y: _m.fmod(_num(x), _num(y)),
    "range": lambda a, b: list(range(_int(a), _int(b) + 1)),
})

# -- strings ----------------------------------------------------------------
FUNCS.update({
    "lower": lambda s: _str(s).lower(),
    "upper": lambda s: _str(s).upper(),
    "trim": lambda s: _str(s).strip(),
    "ltrim": lambda s: _str(s).lstrip(),
    "rtrim": lambda s: _str(s).rstrip(),
    "reverse": lambda s: _str(s)[::-1],
    "strlen": lambda s: len(_str(s)),
    "substr": lambda s, start, *ln: (
        _str(s)[_int(start):] if not ln
        else _str(s)[_int(start):_int(start) + _int(ln[0])]
    ),
    "split": lambda s, sep=" ": [p for p in _str(s).split(_str(sep)) if p != ""],
    "concat": lambda *xs: "".join(_str(x) for x in xs),
    "pad": lambda s, n, *a: _str(s).ljust(_int(n)),
    "replace": lambda s, old, new: _str(s).replace(_str(old), _str(new)),
    "regex_match": lambda s, p: re.search(_str(p), _str(s)) is not None,
    "regex_replace": lambda s, p, r: re.sub(_str(p), _str(r), _str(s)),
    "regex_extract": lambda s, p: (
        (lambda m: m.group(1) if m and m.groups() else (m.group(0) if m else ""))
        (re.search(_str(p), _str(s)))
    ),
    "ascii": lambda s: ord(_str(s)[0]) if _str(s) else None,
    "find": lambda s, sub: (
        _str(s)[_str(s).find(_str(sub)):] if _str(sub) in _str(s) else ""
    ),
    "tokens": lambda s, seps: [
        t for t in re.split("[" + re.escape(_str(seps)) + "]", _str(s)) if t
    ],
    "sprintf": lambda fmt, *a: _str(fmt) % tuple(a),
})

# -- maps / arrays ----------------------------------------------------------


@_reg("map_get")
def _map_get(key, m, default=None):
    if isinstance(m, dict):
        return m.get(_str(key), default)
    return default


@_reg("map_put")
def _map_put(key, val, m):
    out = dict(m) if isinstance(m, dict) else {}
    out[_str(key)] = val
    return out


FUNCS.update({
    "mget": _map_get,
    "mput": _map_put,
    "map_keys": lambda m: list(m.keys()) if isinstance(m, dict) else [],
    "map_values": lambda m: list(m.values()) if isinstance(m, dict) else [],
    "map_to_entries": lambda m: [
        {"key": k, "value": v} for k, v in m.items()
    ] if isinstance(m, dict) else [],
    "nth": lambda i, xs: xs[_int(i) - 1] if 1 <= _int(i) <= len(xs) else None,
    "length": lambda xs: len(xs),
    "sublist": lambda *a: (
        a[1][:_int(a[0])] if len(a) == 2 else a[2][_int(a[0]) - 1:_int(a[0]) - 1 + _int(a[1])]
    ),
    "first": lambda xs: xs[0] if xs else None,
    "last": lambda xs: xs[-1] if xs else None,
    "contains": lambda x, xs: x in xs if isinstance(xs, (list, str)) else False,
})

# -- json / codec / hash ----------------------------------------------------
FUNCS.update({
    "json_decode": lambda s: json.loads(_str(s)),
    "json_encode": lambda v: json.dumps(v, separators=(",", ":")),
    "base64_encode": lambda b: base64.b64encode(_bytes(b)).decode(),
    "base64_decode": lambda s: base64.b64decode(_str(s)).decode("utf-8", "replace"),
    "md5": lambda b: hashlib.md5(_bytes(b)).hexdigest(),
    "sha": lambda b: hashlib.sha1(_bytes(b)).hexdigest(),
    "sha256": lambda b: hashlib.sha256(_bytes(b)).hexdigest(),
    "bin2hexstr": lambda b: _bytes(b).hex(),
    "hexstr2bin": lambda s: bytes.fromhex(_str(s)),
    "str": _str,
    "str_utf8": _str,
    "int": _int,
    "float": _num,
    "bool": lambda x: bool(x) if not isinstance(x, str) else x.lower() == "true",
})

# -- time / ids -------------------------------------------------------------
FUNCS.update({
    "now_timestamp": lambda *unit: (
        int(time.time() * 1000) if unit and _str(unit[0]) == "millisecond"
        else int(time.time())
    ),
    "unix_ts_to_rfc3339": lambda ts, *unit: time.strftime(
        "%Y-%m-%dT%H:%M:%S+00:00",
        time.gmtime(_num(ts) / (1000 if unit and _str(unit[0]) == "millisecond" else 1)),
    ),
    "uuid_v4": lambda: str(uuid.uuid4()),
    "timezone_to_offset_seconds": lambda tz: 0,
})

# -- conditionals / misc ----------------------------------------------------
FUNCS.update({
    "coalesce": lambda *xs: next((x for x in xs if x is not None), None),
    "is_null": lambda x: x is None,
    "is_not_null": lambda x: x is not None,
    "is_num": lambda x: isinstance(x, (int, float)) and not isinstance(x, bool),
    "is_str": lambda x: isinstance(x, str),
    "is_bool": lambda x: isinstance(x, bool),
    "is_map": lambda x: isinstance(x, dict),
    "is_array": lambda x: isinstance(x, list),
    "proc_dict_get": lambda *a: None,
})

# -- jq ---------------------------------------------------------------------
#
# The reference binds libjq through a NIF (SURVEY.md §2.4); ours is the
# in-repo evaluator (`rule_engine/jq.py`): jq generator semantics —
# paths/slices/iteration with `?`, array/object construction, operators
# (`|`, `,`, `//`, and/or, comparisons, arithmetic), if/then/elif/else,
# and the common builtins.  Always returns the list of outputs,
# matching the reference's jq/2 contract; string/bytes input is parsed
# as JSON first (the rule-engine calling convention).

def _jq(prog: Any, value: Any) -> List[Any]:
    from .jq import jq_eval

    if isinstance(value, (bytes, str)):
        try:
            value = json.loads(_str(value))
        except json.JSONDecodeError:
            raise ValueError("jq: input is not JSON")
    return jq_eval(_str(prog), value)


FUNCS.update({"jq": _jq})

# -- topic helpers (the reference exposes these to rules) -------------------
from .. import topic as _T

FUNCS.update({
    "topic_match": lambda name, flt: _T.match(_str(name), _str(flt)),
    "nth_topic_level": lambda i, t: (
        _T.words(_str(t))[_int(i) - 1] if 1 <= _int(i) <= len(_T.words(_str(t))) else ""
    ),
})


def call_func(name: str, args: List[Any]) -> Any:
    fn = FUNCS.get(name)
    if fn is None:
        raise NameError(f"unknown sql function {name!r}")
    return fn(*args)
