"""Rule evaluation over event contexts.

The port's own copy of the reference's ``emqx_tpu/rule_engine/runtime.py``
(nothing here imports the JAX package).

Behavioral reference: ``emqx_rule_runtime.erl`` [U] (SURVEY.md §3.5):
per event, check the FROM filters (done by the engine), evaluate WHERE
over the event columns, then build the SELECT output map.  Payload
fields decode lazily — ``payload.x`` JSON-decodes the payload once per
evaluation, exactly when first needed (the reference memoizes the same
way).

``render_template`` implements the action-side ``${...}`` placeholder
templates ("t/${clientid}/out"), resolving paths against the SELECT
output first, then the raw event columns.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

from .funcs import call_func
from .sqlparser import Rule

__all__ = ["EvalContext", "eval_expr", "eval_rule", "render_template"]


class EvalContext:
    """Event columns + memoized decoded payload."""

    def __init__(self, columns: Dict[str, Any]) -> None:
        self.columns = columns
        self._decoded: Optional[Any] = None
        self._decode_tried = False
        self._fast_hits = 0   # payload.x answered natively (no decode)

    def decoded_payload(self) -> Any:
        if not self._decode_tried:
            self._decode_tried = True
            raw = self.columns.get("payload")
            if isinstance(raw, (bytes, str)):
                try:
                    self._decoded = json.loads(raw)
                except (ValueError, UnicodeDecodeError):
                    self._decoded = None
            else:
                self._decoded = raw
        return self._decoded

    def resolve(self, path: List[str]) -> Any:
        head, rest = path[0], path[1:]
        if head in self.columns:
            val = self.columns[head]
            if head == "payload" and rest:
                # native fast path (jiffy analog): extract ONE scalar
                # without materializing the whole document; any shape it
                # can't represent exactly bails to the memoized decode
                if not self._decode_tried:
                    raw = val
                    if isinstance(raw, str):
                        raw = raw.encode("utf-8", "surrogatepass")
                    if isinstance(raw, bytes):
                        from ..native import fastjson

                        found, fv = fastjson.get_path(raw, rest)
                        if found:
                            self._fast_hits += 1
                            return fv
                val = self.decoded_payload()
        elif (self._decode_tried or self._fast_hits) \
                and isinstance(self.decoded_payload(), dict) \
                and head in self._decoded:
            # aliases bound by FOREACH etc.  A native fast-path hit
            # counts as "payload was accessed": decode lazily HERE so
            # bare-key lookups see exactly the pre-fastjson behavior
            val = self._decoded[head]
        else:
            return None
        for p in rest:
            if isinstance(val, dict):
                val = val.get(p)
            elif isinstance(val, (bytes, str)):
                try:
                    val = json.loads(val)
                except (ValueError, UnicodeDecodeError):
                    return None
                if isinstance(val, dict):
                    val = val.get(p)
                else:
                    return None
            else:
                return None
        return val


def _truthy(v: Any) -> bool:
    if v is None:
        return False
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return v != 0
    if isinstance(v, str):
        return v.lower() == "true"
    return bool(v)


def _eq(a: Any, b: Any) -> bool:
    # cross-type numeric equality ('1' = 1), bytes/str equality
    if isinstance(a, bytes):
        a = a.decode("utf-8", "replace")
    if isinstance(b, bytes):
        b = b.decode("utf-8", "replace")
    if isinstance(a, (int, float)) and isinstance(b, str):
        try:
            return float(a) == float(b)
        except ValueError:
            return False
    if isinstance(b, (int, float)) and isinstance(a, str):
        try:
            return float(a) == float(b)
        except ValueError:
            return False
    return a == b


def eval_expr(e: Any, ctx: EvalContext) -> Any:
    tag = e[0]
    if tag == "lit":
        return e[1]
    if tag == "var":
        return ctx.resolve(e[1])
    if tag == "call":
        return call_func(e[1], [eval_expr(a, ctx) for a in e[2]])
    if tag == "and":
        return _truthy(eval_expr(e[1], ctx)) and _truthy(eval_expr(e[2], ctx))
    if tag == "or":
        return _truthy(eval_expr(e[1], ctx)) or _truthy(eval_expr(e[2], ctx))
    if tag == "not":
        return not _truthy(eval_expr(e[1], ctx))
    if tag == "in":
        v = eval_expr(e[1], ctx)
        return any(_eq(v, eval_expr(item, ctx)) for item in e[2])
    if tag == "like":
        v = eval_expr(e[1], ctx)
        pat = "^" + re.escape(e[2]).replace("%", ".*").replace("_", ".") + "$"
        return v is not None and re.match(pat, str(v)) is not None
    if tag == "case":
        for cond, then in e[1]:
            if _truthy(eval_expr(cond, ctx)):
                return eval_expr(then, ctx)
        return eval_expr(e[2], ctx) if e[2] is not None else None
    if tag == "index":
        base = eval_expr(e[1], ctx)
        idx = eval_expr(e[2], ctx)
        if isinstance(base, (bytes, str)):
            try:
                base = json.loads(base)
            except (ValueError, UnicodeDecodeError):
                return None
        if isinstance(base, dict):
            return base.get(str(idx))
        if isinstance(base, list) and isinstance(idx, (int, float)):
            i = int(idx) - 1          # 1-based, like the reference
            return base[i] if 0 <= i < len(base) else None
        return None
    if tag == "op":
        sym = e[1]
        a = eval_expr(e[2], ctx)
        b = eval_expr(e[3], ctx)
        if sym == "=":
            return _eq(a, b)
        if sym == "!=":
            return not _eq(a, b)
        if sym == "+":
            if isinstance(a, str) or isinstance(b, str):
                from .funcs import _str
                return _str(a) + _str(b)
            return (a or 0) + (b or 0)
        from .funcs import _num
        if sym == "-":
            return _num(a) - _num(b)
        if sym == "*":
            return _num(a) * _num(b)
        if sym == "/":
            return _num(a) / _num(b)
        if sym == "div":
            return int(_num(a) // _num(b))
        if sym == "mod":
            return int(_num(a)) % int(_num(b))
        if a is None or b is None:
            return False
        if sym == ">":
            return _cmp_vals(a, b) > 0
        if sym == "<":
            return _cmp_vals(a, b) < 0
        if sym == ">=":
            return _cmp_vals(a, b) >= 0
        if sym == "<=":
            return _cmp_vals(a, b) <= 0
    raise ValueError(f"bad expr node {e!r}")


def _cmp_vals(a: Any, b: Any) -> int:
    if isinstance(a, str) and isinstance(b, (int, float)):
        try:
            a = float(a)
        except ValueError:
            b = str(b)
    elif isinstance(b, str) and isinstance(a, (int, float)):
        try:
            b = float(b)
        except ValueError:
            a = str(a)
    return (a > b) - (a < b)


def _select_output(
    fields: List[Tuple[Any, Optional[str]]], ctx: EvalContext
) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for expr, alias in fields:
        if expr == "*":
            out.update(ctx.columns)
            continue
        val = eval_expr(expr, ctx)
        if alias is not None:
            out[alias] = val
        elif expr[0] == "var":
            out[expr[1][-1]] = val
        elif expr[0] == "call":
            out[expr[1]] = val
        else:
            out[f"col{len(out)}"] = val
    return out


def eval_rule(rule: Rule, columns: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Evaluate a parsed rule against one event's columns.

    Returns the list of output maps (one per action invocation): empty if
    WHERE failed; one entry for SELECT; one per array element for
    FOREACH (after INCASE filtering)."""
    ctx = EvalContext(dict(columns))
    if rule.where is not None and not _truthy(eval_expr(rule.where, ctx)):
        return []
    if rule.kind == "select":
        return [_select_output(rule.fields, ctx)]
    # FOREACH
    arr = eval_expr(rule.foreach, ctx)
    if not isinstance(arr, list):
        return []
    outs: List[Dict[str, Any]] = []
    alias = rule.foreach_alias or "item"
    for elem in arr:
        ectx = EvalContext({**ctx.columns, alias: elem, "item": elem})
        ectx._decoded = ctx.decoded_payload()
        ectx._decode_tried = True
        if rule.incase is not None and not _truthy(eval_expr(rule.incase, ectx)):
            continue
        outs.append(_select_output(rule.fields, ectx))
    return outs


_TEMPLATE = re.compile(r"\$\{([^}]+)\}")


def render_template(template: str, output: Dict[str, Any],
                    columns: Optional[Dict[str, Any]] = None) -> str:
    """Expand ``${path.to.field}`` placeholders (action templates)."""
    ctx_cols = dict(columns or {})

    def sub(m: "re.Match[str]") -> str:
        path = m.group(1).split(".")
        val: Any = output
        for i, p in enumerate(path):
            if isinstance(val, dict) and p in val:
                val = val[p]
            elif i == 0:
                val = EvalContext(ctx_cols).resolve(path)
                break
            else:
                return ""
        from .funcs import _str
        if isinstance(val, (dict, list)):
            return json.dumps(val, separators=(",", ":"))
        return _str(val)

    return _TEMPLATE.sub(sub, template)
