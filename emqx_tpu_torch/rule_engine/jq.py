"""jq expression evaluator — the libjq-NIF analog (SURVEY.md §2.4).

The port's own copy of the reference's ``emqx_tpu/rule_engine/jq.py``
(nothing here imports the JAX package).

The reference embeds libjq for its rule-engine ``jq/2`` SQL function;
this is an independent, dependency-free implementation of the jq
language core with jq's GENERATOR semantics: every expression maps one
input to a STREAM of outputs, ``|`` feeds each output of the left side
through the right side, ``,`` concatenates streams, and constructions
([], {}) take the cartesian product of their parts' streams — so
``{a: .xs[]}`` fans out into one object per array element, exactly like
real jq.

Supported (the surface rule engines actually use):

* paths: ``.a.b``, ``.["key"]``, ``.[0]``, negatives, slices
  ``.[2:5]``, iteration ``.[]``, optional forms ``.a?``/``.[]?``,
  postfix chains on any expression (``(.a)[0]``, ``.users[].name``);
* literals (numbers, strings, ``true/false/null``), array construction
  ``[...]``, object construction ``{a: expr, "k": expr, shorthand}``;
* operators: ``|``, ``,``, ``//`` (alternative: truthy outputs of the
  left, else the right; errors on the left also fall through),
  ``and``/``or``, ``== != < <= > >=``, ``+ - * / %``, unary ``-``;
* ``if COND then A elif B else C end`` (condition is a generator:
  every output selects a branch, jq-style; ``else`` defaults to ``.``);
* variable bindings ``EXPR as $x | BODY`` (``.`` unchanged in BODY,
  one binding per output — generator semantics), ``$x`` references
  with postfix chains (``$x.field``);
* ``reduce SRC as $x (INIT; UPDATE)`` (folds with the LAST output of
  UPDATE; empty UPDATE kills the fold, like jq) and
  ``foreach SRC as $x (INIT; UPDATE[; EXTRACT])``;
* ``try EXPR [catch HANDLER]`` — errors feed HANDLER the message, or
  vanish without one (``?`` still works as postfix try);
* string interpolation ``"a \\(expr) b"`` incl. nested strings inside
  the interpolation and multi-output fan-out;
* path expressions and the assignment family: ``path(f)``,
  ``del(f)``, ``delpaths``, ``.a = v``, ``.a |= f`` (empty rhs
  deletes, jq-1.7-style), ``+= -= *= /= %= //=`` — LHS paths support
  fields, indices, iteration, pipes, comma, optional forms,
  ``select``, ``first``/``last``, ``getpath``, ``if`` and ``try``;
* regex (Python ``re`` over the common Oniguruma subset, named groups
  auto-translated): ``test(re[;flags])``, ``match``, ``capture``,
  ``sub``, ``gsub`` — replacement expressions see the named captures
  as ``.`` and fan multi-output replacements out cartesian-style over
  every match (real-jq parity), flags ``g i x s m``;
* dates (UTC, jq's gmtime family): ``now``, ``gmtime``, ``mktime``,
  ``todate[iso8601]``, ``fromdate[iso8601]``, ``strftime``,
  ``strptime``;
* builtins: length, keys, values, type, add, floor, ceil, sqrt, abs,
  tostring, tonumber, tojson, fromjson, ascii_downcase, ascii_upcase,
  reverse, sort, sort_by(f), unique, unique_by(f), group_by(f),
  join(s), split(s), splits(re), map(f), select(f), has(k),
  contains(x), startswith(s), endswith(s), ltrimstr(s), rtrimstr(s),
  test(re), first, last, first(f), last(f), nth(n;f), limit(n;f),
  min, max, min_by(f), max_by(f), any, all, any(f), all(f), flatten,
  flatten(d), explode, implode, empty, not, error, error(msg),
  range(n), range(lo;hi), to_entries, from_entries, recurse,
  recurse(f), recurse(f;cond) (and ``..``), until(c;u), while(c;u),
  getpath(p), setpath(p;v), paths, leaf_paths, isnan, isinfinite,
  infinite, nan, utf8bytelength.

* ``def`` user functions (``def f(g; $x): body; rest``): filter
  params bind as closures over the call site, $-value params fan the
  call out over their output streams, recursion works (depth-capped
  into JqError), lexical scoping, user defs shadow same-name/arity
  builtins — all jq semantics.

* ``@format`` strings — ``@text @json @csv @tsv @html @uri @sh
  @base64 @base64d`` — as standalone filters and as
  interpolation-formatting string prefixes (``@uri "q=\\(.q)"``);
* destructuring patterns in ``as`` and ``reduce``/``foreach``
  (``. as [$a, {b: $c}] | ...``), incl. ``{$x}`` shorthand, string
  and computed ``(expr):`` keys (generator fan-out), null-tolerant
  bindings, mismatch errors, and ``?//`` alternatives (first
  pattern whose match and body succeed wins; variables from
  unmatched alternatives bind null; known divergence: a retry
  discards the failing attempt's already-produced outputs, where
  real jq streams them first — needs the lazy evaluator noted
  under label/break).

Out of scope (documented, erroring loudly rather than mis-evaluating):
``label``/``break`` (the eager list-based evaluator cannot preserve
already-yielded outputs across an unwind; its main idiom is covered
by the ``first(f)``/``limit(n;f)``/``until`` builtins), slice
assignment (``.[:2] = ...``), ``limit``/``..`` as path expressions,
and ``ltrimstr`` etc. in LHS paths.

jq's comparison/sort total order (null < false < true < numbers <
strings < arrays < objects) is implemented so ``sort``/``min``/``max``
/``<`` agree with real jq on mixed types.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, List, Optional, Tuple

__all__ = ["jq_eval", "JqError"]


class JqError(ValueError):
    pass


# ---------------------------------------------------------------------------
# @format strings (applied to interpolations and as standalone filters)
# ---------------------------------------------------------------------------

def _fmt_tostr(v: Any) -> str:
    return v if isinstance(v, str) else json.dumps(
        v, separators=(",", ":"))


def _fmt_csv_cell(x: Any) -> str:
    if x is None:
        return ""
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, (int, float)):
        return json.dumps(x)
    if isinstance(x, str):
        return '"' + x.replace('"', '""') + '"'
    raise JqError(f"jq: @csv cannot format {_jq_type(x)}")


def _fmt_tsv_cell(x: Any) -> str:
    if x is None:
        return ""
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, (int, float)):
        return json.dumps(x)
    if isinstance(x, str):
        return (x.replace("\\", "\\\\").replace("\t", "\\t")
                .replace("\n", "\\n").replace("\r", "\\r"))
    raise JqError(f"jq: @tsv cannot format {_jq_type(x)}")


def _fmt_row(v: Any, cell, sep: str) -> str:
    if not isinstance(v, list):
        raise JqError("jq: @csv/@tsv need an array input")
    return sep.join(cell(x) for x in v)


def _fmt_sh(v: Any) -> str:
    def one(x):
        if x is None:
            return "null"   # jq formats null via tojson, like booleans
        if isinstance(x, bool):
            return "true" if x else "false"
        if isinstance(x, (int, float)):
            return json.dumps(x)
        if isinstance(x, str):
            return "'" + x.replace("'", "'\\''") + "'"
        raise JqError(f"jq: @sh cannot format {_jq_type(x)}")
    return " ".join(one(x) for x in v) if isinstance(v, list) else one(v)


def _fmt_base64(v: Any) -> str:
    import base64
    return base64.b64encode(_fmt_tostr(v).encode()).decode()


def _fmt_base64d(v: Any) -> str:
    import base64
    if not isinstance(v, str):
        raise JqError("jq: @base64d needs a string")
    try:
        # validate=True: non-alphabet bytes must ERROR, not be
        # silently discarded (b64decode's permissive default)
        return base64.b64decode(v + "=" * (-len(v) % 4),
                                validate=True).decode("utf-8", "replace")
    except Exception:
        raise JqError("jq: invalid base64")


def _fmt_uri(v: Any) -> str:
    import urllib.parse
    # jq encodes everything outside alphanumerics and -_.~ (RFC 3986
    # unreserved), stricter than quote()'s default
    return urllib.parse.quote(_fmt_tostr(v), safe="-_.~")


def _fmt_html(v: Any) -> str:
    s = _fmt_tostr(v)
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace("'", "&#39;")
            .replace('"', "&quot;"))


_FORMATS = {
    "text": _fmt_tostr,
    "json": lambda v: json.dumps(v, separators=(",", ":")),
    "csv": lambda v: _fmt_row(v, _fmt_csv_cell, ","),
    "tsv": lambda v: _fmt_row(v, _fmt_tsv_cell, "\t"),
    "html": _fmt_html,
    "uri": _fmt_uri,
    "sh": _fmt_sh,
    "base64": _fmt_base64,
    "base64d": _fmt_base64d,
}


# ---------------------------------------------------------------------------
# lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<num>\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
  | (?P<var>\$[A-Za-z_][A-Za-z0-9_]*)
  | (?P<fmt>@[A-Za-z0-9_]+)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<punct>\.\.|//=|//|==|!=|<=|>=|\|=|\+=|-=|\*=|/=|%=|=|\||,|\.|\[|\]|\{|\}|\(|\)|:|;|\?|<|>|\+|-|\*|/|%)
""", re.VERBOSE)

# reserved words — like jq's lexer, these never parse as `.field`
# names or object-key shorthand (use .["as"] for such keys), so
# `. as $x | ...` binds instead of reading a field called "as"
_KEYWORDS = {"if", "then", "elif", "else", "end", "and", "or",
             "true", "false", "null", "as", "reduce", "foreach",
             "try", "catch", "def", "label", "import", "include"}


def _skip_string(src: str, start: int) -> int:
    """`start` at an opening quote; returns the index AFTER the
    closing quote (escape-aware; used to jump nested string literals
    while bracket-matching an interpolation)."""
    i = start + 1
    while i < len(src):
        if src[i] == "\\":
            i += 2
        elif src[i] == '"':
            return i + 1
        else:
            i += 1
    raise JqError("jq: unterminated string")


def _lex_string(src: str, start: int):
    """Scan one string literal, splitting out ``\\(...)``
    interpolations.  Plain -> ("str", raw-with-quotes); interpolated
    -> ("istr", [("lit", text) | ("expr", source), ...])."""
    i = start + 1
    parts: List[Tuple[str, str]] = []
    buf: List[str] = []
    while i < len(src):
        c = src[i]
        if c == "\\":
            if src[i + 1:i + 2] == "(":
                depth, j = 1, i + 2
                while j < len(src) and depth:
                    if src[j] == '"':
                        j = _skip_string(src, j)
                        continue
                    if src[j] == "(":
                        depth += 1
                    elif src[j] == ")":
                        depth -= 1
                    j += 1
                if depth:
                    raise JqError("jq: unterminated \\( interpolation")
                parts.append(("lit", "".join(buf)))
                buf = []
                parts.append(("expr", src[i + 2:j - 1]))
                i = j
                continue
            buf.append(src[i:i + 2])
            i += 2
            continue
        if c == '"':
            if not parts:
                return ("str", '"' + "".join(buf) + '"'), i + 1
            parts.append(("lit", "".join(buf)))
            return ("istr", parts), i + 1
        buf.append(c)
        i += 1
    raise JqError("jq: unterminated string")


def _lex(src: str) -> List[Tuple[str, str]]:
    toks: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(src):
        if src[pos] == '"':
            tok, pos = _lex_string(src, pos)
            toks.append(tok)
            continue
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise JqError(f"jq: bad character {src[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        toks.append((kind, m.group()))
    toks.append(("eof", ""))
    return toks


def _istr_segs(parts):
    """Lexer interpolation parts -> istr segments: literal text stays
    ("lit", str); interpolations parse to ("iexpr", ast)."""
    segs = []
    for skind, src in parts:
        if skind == "lit":
            segs.append(("lit", _unquote('"' + src + '"')))
        else:
            segs.append(("iexpr", _parse(src)))
    return segs


def _unquote(s: str) -> str:
    try:
        return json.loads(s)
    except json.JSONDecodeError:
        raise JqError(f"jq: bad string literal {s}")


# ---------------------------------------------------------------------------
# parser — precedence: | , // or and cmp add mul unary postfix primary
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, toks: List[Tuple[str, str]]) -> None:
        self.toks = toks
        self.i = 0

    def peek(self) -> Tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def eat(self, text: str) -> bool:
        if self.toks[self.i][1] == text and self.toks[self.i][0] in (
                "punct", "ident"):
            self.i += 1
            return True
        return False

    def expect(self, text: str) -> None:
        if not self.eat(text):
            raise JqError(f"jq: expected {text!r}, got "
                          f"{self.toks[self.i][1]!r}")

    # precedence ladder ----------------------------------------------------

    def parse_pattern_alts(self):
        """PATTERN [?// PATTERN ...] — destructuring alternatives: the
        first pattern whose match AND body succeed wins; variables
        from unmatched alternatives bind null."""
        pats = [self.parse_pattern()]
        while (self.peek() == ("punct", "?")
               and self.toks[self.i + 1] == ("punct", "//")):
            self.next()
            self.next()
            pats.append(self.parse_pattern())
        if len(pats) == 1:
            return pats[0]
        # variable sets are static per pattern: compute once at parse
        # time, not per source element in the evaluation hot path
        varsets = []
        for p in pats:
            vs: set = set()
            _pattern_vars(p, vs)
            varsets.append(frozenset(vs))
        allvars = frozenset().union(*varsets)
        return ("palt", pats, varsets, allvars)

    def parse_pattern(self):
        """Destructuring pattern for ``as``: $var, [patterns...], or
        {key: pattern, $shorthand, "str": pattern, (expr): pattern}."""
        kind, text = self.peek()
        if kind == "var":
            self.next()
            return ("pvar", text[1:])
        if text == "[" and kind == "punct":
            self.next()
            pats = [self.parse_pattern()]
            while self.eat(","):
                pats.append(self.parse_pattern())
            self.expect("]")
            return ("parray", pats)
        if text == "{" and kind == "punct":
            self.next()
            entries = []
            while True:
                ek, et = self.peek()
                if ek == "var":                 # {$x} == {x: $x}
                    self.next()
                    entries.append((("lit", et[1:]), ("pvar", et[1:])))
                elif ek == "ident" and et not in _KEYWORDS:
                    self.next()
                    self.expect(":")
                    entries.append((("lit", et), self.parse_pattern()))
                elif ek == "str":
                    self.next()
                    self.expect(":")
                    entries.append((("lit", _unquote(et)),
                                    self.parse_pattern()))
                elif et == "(":
                    self.next()
                    keyexpr = self.parse_pipe()
                    self.expect(")")
                    self.expect(":")
                    entries.append((keyexpr, self.parse_pattern()))
                else:
                    raise JqError(f"jq: bad pattern key {et!r}")
                if not self.eat(","):
                    break
            self.expect("}")
            return ("pobject", entries)
        raise JqError(f"jq: bad destructuring pattern {text!r}")

    def parse_pipe(self):
        if self.peek() == ("ident", "def"):
            return self.parse_def()
        left = self.parse_comma()
        if self.peek() == ("ident", "as"):
            # EXPR as PATTERN | BODY — `.` stays the original input
            self.next()
            pat = self.parse_pattern_alts()
            self.expect("|")
            return ("as", left, pat, self.parse_pipe())
        while self.eat("|"):
            if self.peek() == ("ident", "def"):
                return ("pipe", left, self.parse_def())
            right = self.parse_comma()
            if self.peek() == ("ident", "as"):
                self.next()
                pat = self.parse_pattern_alts()
                self.expect("|")
                return ("pipe", left,
                        ("as", right, pat, self.parse_pipe()))
            left = ("pipe", left, right)
        return left

    def parse_def(self):
        """``def name(p1; $p2): body; rest`` — jq function definitions
        prefix an expression; params are filter names (closures) or
        $-value names."""
        self.expect("def")
        kind, name = self.next()
        if kind != "ident" or name in _KEYWORDS:
            raise JqError(f"jq: bad function name {name!r}")
        params: List[str] = []
        if self.eat("("):
            while True:
                pk, pt = self.next()
                if pk == "var":
                    params.append("$" + pt[1:])
                elif pk == "ident" and pt not in _KEYWORDS:
                    params.append(pt)
                else:
                    raise JqError(f"jq: bad parameter {pt!r}")
                if not self.eat(";"):
                    break
            self.expect(")")
        self.expect(":")
        body = self.parse_pipe()
        self.expect(";")
        rest = self.parse_pipe()
        return ("def", name, params, body, rest)

    def parse_comma(self):
        parts = [self.parse_alt()]
        while self.eat(","):
            parts.append(self.parse_alt())
        return parts[0] if len(parts) == 1 else ("comma", parts)

    def parse_alt(self):
        left = self.parse_assign()
        while self.eat("//"):
            left = ("alt", left, self.parse_assign())
        return left

    _ASSIGN_OPS = ("=", "|=", "+=", "-=", "*=", "/=", "%=", "//=")

    def parse_assign(self):
        # jq precedence: `//` is LOOSER than the `=` family, which is
        # nonassoc over `or`-level operands (`.a = .b = 1` is an error,
        # matching jq)
        left = self.parse_or()
        kind, text = self.peek()
        if kind == "punct" and text in self._ASSIGN_OPS:
            self.next()
            return ("assign", text, left, self.parse_or())
        return left

    def parse_or(self):
        left = self.parse_and()
        while self.peek() == ("ident", "or"):
            self.next()
            left = ("or", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_cmp()
        while self.peek() == ("ident", "and"):
            self.next()
            left = ("and", left, self.parse_cmp())
        return left

    def parse_cmp(self):
        left = self.parse_add()
        if self.peek()[1] in ("==", "!=", "<", "<=", ">", ">=") \
                and self.peek()[0] == "punct":
            op = self.next()[1]
            return ("cmp", op, left, self.parse_add())
        return left

    def parse_add(self):
        left = self.parse_mul()
        while self.peek() in (("punct", "+"), ("punct", "-")):
            op = self.next()[1]
            left = ("arith", op, left, self.parse_mul())
        return left

    def parse_mul(self):
        left = self.parse_unary()
        while self.peek() in (("punct", "*"), ("punct", "/"),
                              ("punct", "%")):
            op = self.next()[1]
            left = ("arith", op, left, self.parse_unary())
        return left

    def parse_unary(self):
        if self.eat("-"):
            return ("neg", self.parse_postfix())
        return self.parse_postfix()

    def parse_postfix(self):
        node = self.parse_primary()
        return self._postfix_chain(node)

    def _postfix_chain(self, node):
        while True:
            kind, text = self.peek()
            if text == "." and self.toks[self.i + 1][0] == "ident" \
                    and self.toks[self.i + 1][1] not in _KEYWORDS:
                self.next()
                name = self.next()[1]
                node = ("field", node, ("lit", name), self.eat("?"))
            elif text == "." and self.toks[self.i + 1][1] == "[" \
                    and self.toks[self.i + 1][0] == "punct":
                self.next()     # jq accepts .a.["k"] / .a.[] / .a.[0]:
                continue        # swallow the dot, bracket handled next
            elif text == "[" and kind == "punct":
                self.next()
                if self.eat("]"):
                    node = ("iter", node, self.eat("?"))
                elif self.eat(":"):
                    hi = self.parse_pipe()
                    self.expect("]")
                    node = ("slice", node, None, hi, self.eat("?"))
                else:
                    idx = self.parse_pipe()
                    if self.eat(":"):
                        hi = None if self.peek()[1] == "]" \
                            else self.parse_pipe()
                        self.expect("]")
                        node = ("slice", node, idx, hi, self.eat("?"))
                    else:
                        self.expect("]")
                        node = ("indexe", node, idx, self.eat("?"))
            else:
                return node

    def parse_primary(self):
        kind, text = self.peek()
        if text == "." and kind == "punct":
            nk, nt = self.toks[self.i + 1]
            if nk == "ident" and nt not in _KEYWORDS:
                return ("identity",)     # postfix chain consumes .field
            self.next()                  # bare "." / ".[...]": consume
            return ("dot",)              # the dot; postfix sees the "["
        if text == ".." and kind == "punct":
            self.next()
            return ("call", "recurse", [])     # jq: .. == recurse
        if kind == "num":
            self.next()
            return ("lit", float(text) if "." in text or "e" in text
                    or "E" in text else int(text))
        if kind == "str":
            self.next()
            return ("lit", _unquote(text))
        if kind == "istr":
            self.next()
            return ("istr", _istr_segs(text))  # text is the parts list
        if kind == "var":
            self.next()
            return ("var", text[1:])
        if kind == "fmt":
            self.next()
            fname = text[1:]
            if fname not in _FORMATS:
                raise JqError(f"jq: unknown format @{fname}")
            nk, nt = self.peek()
            if nk == "str":             # @fmt "..." formats the whole
                self.next()             # literal's interpolations
                return ("istr", [("lit", _unquote(nt))], fname)
            if nk == "istr":
                self.next()
                return ("istr", _istr_segs(nt), fname)
            return ("format", fname)
        if kind == "ident":
            if text == "true":
                self.next(); return ("lit", True)
            if text == "false":
                self.next(); return ("lit", False)
            if text == "null":
                self.next(); return ("lit", None)
            if text == "if":
                return self.parse_if()
            if text in ("then", "elif", "else", "end", "and", "or"):
                raise JqError(f"jq: unexpected keyword {text!r}")
            if text in ("reduce", "foreach"):
                self.next()
                src = self.parse_postfix()
                self.expect("as")
                name = self.parse_pattern_alts()
                self.expect("(")
                init = self.parse_pipe()
                self.expect(";")
                update = self.parse_pipe()
                extract = None
                if text == "foreach" and self.eat(";"):
                    extract = self.parse_pipe()
                self.expect(")")
                if text == "reduce":
                    return ("reduce", src, name, init, update)
                return ("foreach", src, name, init, update, extract)
            if text == "try":
                self.next()
                body = self.parse_postfix()
                handler = self.parse_postfix() if self.eat("catch") \
                    else None
                return ("try", body, handler)
            if text in ("as", "catch", "def", "label", "import",
                        "include"):
                # "def" is supported at expression starts (parse_pipe/
                # parse_def); reaching here means a malformed position
                raise JqError(f"jq: {text!r} is not valid here")
            self.next()
            if self.eat("("):
                args = [self.parse_pipe()]
                while self.eat(";"):
                    args.append(self.parse_pipe())
                self.expect(")")
                return ("call", text, args)
            return ("call", text, [])
        if text == "(":
            self.next()
            node = self.parse_pipe()
            self.expect(")")
            return node
        if text == "[":
            self.next()
            if self.eat("]"):
                return ("array", None)
            node = self.parse_pipe()
            self.expect("]")
            return ("array", node)
        if text == "{":
            self.next()
            entries = []
            if not self.eat("}"):
                while True:
                    entries.append(self.parse_obj_entry())
                    if not self.eat(","):
                        break
                self.expect("}")
            return ("object", entries)
        raise JqError(f"jq: unexpected token {text!r}")

    def parse_obj_entry(self):
        kind, text = self.peek()
        if kind == "ident" and text not in _KEYWORDS:
            self.next()
            if self.eat(":"):
                return (("lit", text), self.parse_alt())
            return (("lit", text), ("field", ("dot",), ("lit", text),
                                    False))
        if kind == "str":
            self.next()
            key = _unquote(text)
            if self.eat(":"):
                return (("lit", key), self.parse_alt())
            return (("lit", key), ("field", ("dot",), ("lit", key), False))
        if text == "(":
            self.next()
            keyexpr = self.parse_pipe()
            self.expect(")")
            self.expect(":")
            return (keyexpr, self.parse_alt())
        raise JqError(f"jq: bad object key {text!r}")

    def parse_if(self):
        self.expect("if")
        cond = self.parse_pipe()
        self.expect("then")
        then = self.parse_pipe()
        elifs = []
        while self.eat("elif"):
            c = self.parse_pipe()
            self.expect("then")
            elifs.append((c, self.parse_pipe()))
        els = self.parse_pipe() if self.eat("else") else ("dot",)
        self.expect("end")
        # desugar elifs into nested ifs: eval handles one cond/then/else
        for c, t in reversed(elifs):
            els = ("if", c, t, els)
        return ("if", cond, then, els)


def _parse(src: str):
    p = _Parser(_lex(src))
    node = p.parse_pipe()
    if p.peek()[0] != "eof":
        raise JqError(f"jq: trailing input at {p.peek()[1]!r}")
    return node


# ---------------------------------------------------------------------------
# evaluation — eval(node, input) -> list of outputs
# ---------------------------------------------------------------------------

def _truthy(v: Any) -> bool:
    return v is not None and v is not False


_TYPE_ORDER = {"null": 0, "boolean": 1, "number": 2, "string": 3,
               "array": 4, "object": 5}


def _jq_type(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, list):
        return "array"
    if isinstance(v, dict):
        return "object"
    raise JqError(f"jq: unsupported value {type(v).__name__}")


def _cmp(a: Any, b: Any) -> int:
    """jq total order: null < false < true < numbers < strings < arrays
    < objects."""
    ta, tb = _jq_type(a), _jq_type(b)
    if ta != tb:
        return -1 if _TYPE_ORDER[ta] < _TYPE_ORDER[tb] else 1
    if ta == "null":
        return 0
    if ta == "boolean":
        return (a > b) - (a < b)
    if ta in ("number", "string"):
        return (a > b) - (a < b)
    if ta == "array":
        for x, y in zip(a, b):
            c = _cmp(x, y)
            if c:
                return c
        return (len(a) > len(b)) - (len(a) < len(b))
    # object: compare sorted key arrays, then values in key order
    ka, kb = sorted(a), sorted(b)
    c = _cmp(ka, kb)
    if c:
        return c
    for k in ka:
        c = _cmp(a[k], b[k])
        if c:
            return c
    return 0


def _num(v: Any, op: str) -> float:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise JqError(f"jq: {_jq_type(v)} and number cannot be {op}")
    return v


def _arith(op: str, a: Any, b: Any) -> Any:
    if op == "+":
        if a is None:
            return b
        if b is None:
            return a
        if isinstance(a, str) and isinstance(b, str):
            return a + b
        if isinstance(a, list) and isinstance(b, list):
            return a + b
        if isinstance(a, dict) and isinstance(b, dict):
            out = dict(a)
            out.update(b)
            return out
        return _num(a, "added") + _num(b, "added")
    if op == "-":
        if isinstance(a, list) and isinstance(b, list):
            return [x for x in a if not any(_cmp(x, y) == 0 for y in b)]
        return _num(a, "subtracted") - _num(b, "subtracted")
    if op == "*":
        if isinstance(a, str) and isinstance(b, (int, float)) \
                and not isinstance(b, bool):
            return a * int(b) if b > 0 else None
        return _num(a, "multiplied") * _num(b, "multiplied")
    if op == "/":
        if isinstance(a, str) and isinstance(b, str):
            return a.split(b)
        d = _num(b, "divided")
        if d == 0:
            raise JqError("jq: division by zero")
        r = _num(a, "divided") / d
        return int(r) if isinstance(a, int) and isinstance(b, int) \
            and a % b == 0 else r
    if op == "%":
        d = int(_num(b, "divided"))
        if d == 0:
            raise JqError("jq: division by zero")
        n = int(_num(a, "divided"))
        r = abs(n) % abs(d)          # jq: sign follows the dividend
        return -r if n < 0 else r
    raise JqError(f"jq: unknown operator {op}")


def _index(v: Any, idx: Any, opt: bool) -> List[Any]:
    try:
        if v is None:
            return [None]
        if isinstance(v, dict):
            if not isinstance(idx, str):
                raise JqError(
                    f"jq: cannot index object with {_jq_type(idx)}")
            return [v.get(idx)]
        if isinstance(v, list):
            if isinstance(idx, bool) or not isinstance(idx, (int, float)):
                raise JqError(
                    f"jq: cannot index array with {_jq_type(idx)}")
            i = int(idx)
            if -len(v) <= i < len(v):
                return [v[i]]
            return [None]
        raise JqError(f"jq: cannot index {_jq_type(v)}")
    except JqError:
        if opt:
            return []
        raise


def _slice(v: Any, lo: Any, hi: Any, opt: bool) -> List[Any]:
    try:
        if v is None:
            return [None]
        if not isinstance(v, (list, str)):
            raise JqError(f"jq: cannot slice {_jq_type(v)}")
        lo_i = None if lo is None else int(lo)
        hi_i = None if hi is None else int(hi)
        return [v[lo_i:hi_i]]
    except JqError:
        if opt:
            return []
        raise


def _eval(node, v: Any, env=None) -> List[Any]:
    tag = node[0]
    if tag in ("dot", "identity"):
        return [v]
    if tag == "lit":
        return [node[1]]
    if tag == "pipe":
        out: List[Any] = []
        for x in _eval(node[1], v, env):
            out.extend(_eval(node[2], x, env))
        return out
    if tag == "comma":
        out = []
        for part in node[1]:
            out.extend(_eval(part, v, env))
        return out
    if tag == "alt":
        try:
            good = [x for x in _eval(node[1], v, env) if _truthy(x)]
        except JqError:
            good = []
        return good if good else _eval(node[2], v, env)
    if tag == "or":
        out = []
        for a in _eval(node[1], v, env):
            if _truthy(a):
                out.append(True)
            else:
                out.extend(_truthy(b) for b in _eval(node[2], v, env))
        return out
    if tag == "and":
        out = []
        for a in _eval(node[1], v, env):
            if not _truthy(a):
                out.append(False)
            else:
                out.extend(_truthy(b) for b in _eval(node[2], v, env))
        return out
    if tag == "cmp":
        op = node[1]
        out = []
        for a in _eval(node[2], v, env):
            for b in _eval(node[3], v, env):
                c = _cmp(a, b)
                out.append({"==": c == 0, "!=": c != 0, "<": c < 0,
                            "<=": c <= 0, ">": c > 0, ">=": c >= 0}[op])
        return out
    if tag == "arith":
        out = []
        for a in _eval(node[2], v, env):
            for b in _eval(node[3], v, env):
                out.append(_arith(node[1], a, b))
        return out
    if tag == "neg":
        return [-_num(x, "negated") for x in _eval(node[1], v, env)]
    if tag == "field":
        opt = node[3]
        out = []
        for base in _eval(node[1], v, env):
            out.extend(_index(base, node[2][1], opt))
        return out
    if tag == "indexe":
        opt = node[3]
        out = []
        for base in _eval(node[1], v, env):
            for idx in _eval(node[2], v, env):
                out.extend(_index(base, idx, opt))
        return out
    if tag == "slice":
        _, base_n, lo_n, hi_n, opt = node
        out = []
        for base in _eval(base_n, v, env):
            los = [None] if lo_n is None else _eval(lo_n, v, env)
            his = [None] if hi_n is None else _eval(hi_n, v, env)
            for lo in los:
                for hi in his:
                    out.extend(_slice(base, lo, hi, opt))
        return out
    if tag == "iter":
        opt = node[2]
        out = []
        for base in _eval(node[1], v, env):
            if isinstance(base, list):
                out.extend(base)
            elif isinstance(base, dict):
                out.extend(base.values())
            elif not opt:
                raise JqError(
                    f"jq: cannot iterate over {_jq_type(base)}")
        return out
    if tag == "array":
        if node[1] is None:
            return [[]]
        return [list(_eval(node[1], v, env))]
    if tag == "object":
        results: List[dict] = [{}]
        for keyexpr, valexpr in node[1]:
            nxt = []
            for partial in results:
                for k in _eval(keyexpr, v, env):
                    if not isinstance(k, str):
                        raise JqError(
                            f"jq: object key must be string, got "
                            f"{_jq_type(k)}")
                    for val in _eval(valexpr, v, env):
                        d = dict(partial)
                        d[k] = val
                        nxt.append(d)
            results = nxt
        return results
    if tag == "if":
        _, cond, then, els = node
        out = []
        for c in _eval(cond, v, env):
            out.extend(_eval(then if _truthy(c) else els, v, env))
        return out
    if tag == "def":
        _, name, params, body, rest = node
        fenv = dict(env) if env else {}
        # self-referencing entry so the function can recurse
        fenv[("fn", name, len(params))] = (params, body, fenv)
        return _eval(rest, v, fenv)
    if tag == "call":
        fn = env.get(("fn", node[1], len(node[2]))) if env else None
        if fn is not None:
            return _call_user(fn, node[2], v, env)
        return _call(node[1], node[2], v, env)
    if tag == "var":
        if env and node[1] in env:
            return [env[node[1]]]
        raise JqError(f"jq: ${node[1]} is not defined")
    if tag == "as":
        out = []
        for x in _eval(node[1], v, env):
            out.extend(_as_eval(node[2], x, env, node[3], v))
        return out
    if tag == "reduce":
        _, srcn, pat, initn, updn = node
        xs = _eval(srcn, v, env)
        out = []
        for acc in _eval(initn, v, env):
            alive = True
            for x in xs:
                res = _fold_elem(pat, x, env, updn, acc)
                if res is _FOLD_DEAD:   # empty update kills this fold
                    alive = False
                    break
                acc = res               # jq folds with the LAST output
            if alive:
                out.append(acc)
        return out
    if tag == "foreach":
        _, srcn, pat, initn, updn, extn = node
        xs = _eval(srcn, v, env)
        out = []
        for acc in _eval(initn, v, env):
            for x in xs:
                emitted, acc, stopped = _foreach_elem(
                    pat, x, env, updn, extn, acc)
                out.extend(emitted)     # every update output is emitted
                if stopped:
                    break
        return out
    if tag == "try":
        try:
            return _eval(node[1], v, env)
        except JqError as e:
            if node[2] is None:
                return []
            msg = str(e)
            for pre in ("jq: error: ", "jq: "):
                if msg.startswith(pre):
                    msg = msg[len(pre):]
                    break
            return _eval(node[2], msg, env)
    if tag == "istr":
        fmt = _FORMATS[node[2]] if len(node) > 2 else _fmt_tostr
        results = [""]
        for seg in node[1]:
            if seg[0] == "lit":         # literal text: never formatted
                pieces = [seg[1]]
            else:
                pieces = [fmt(o) for o in _eval(seg[1], v, env)]
            # cartesian: a multi-output interpolation fans the string out
            results = [r + p for r in results for p in pieces]
        return results
    if tag == "format":
        return [_FORMATS[node[1]](v)]
    if tag == "assign":
        return _eval_assign(node[1], node[2], node[3], v, env)
    raise JqError(f"jq: internal: unknown node {tag}")


# ---------------------------------------------------------------------------
# path expressions — the machinery behind =, |=, op=, del(), path()
# ---------------------------------------------------------------------------

def _paths_of(node, v: Any, env) -> List[Tuple[List[Any], Any]]:
    """Evaluate ``node`` as a jq PATH EXPRESSION against ``v``:
    returns (path, value-at-path) pairs.  Non-path constructs raise,
    like jq's "Invalid path expression".  Index expressions inside
    brackets see the current input, jq-style."""
    tag = node[0]
    if tag in ("dot", "identity"):
        return [([], v)]
    if tag == "field":
        name, opt = node[2][1], node[3]
        out = []
        for bp, bv in _paths_of(node[1], v, env):
            if bv is None or isinstance(bv, dict):
                out.append((bp + [name],
                            None if bv is None else bv.get(name)))
            elif not opt:
                raise JqError(f"jq: cannot index {_jq_type(bv)} "
                              f"with \"{name}\"")
        return out
    if tag == "indexe":
        opt = node[3]
        out = []
        for bp, bv in _paths_of(node[1], v, env):
            for idx in _eval(node[2], v, env):
                if isinstance(idx, str):
                    if bv is None or isinstance(bv, dict):
                        out.append((bp + [idx],
                                    None if bv is None else bv.get(idx)))
                    elif not opt:
                        raise JqError(
                            f"jq: cannot index {_jq_type(bv)} with string")
                elif isinstance(idx, (int, float)) \
                        and not isinstance(idx, bool):
                    if bv is None or isinstance(bv, list):
                        got = [] if bv is None else _index(bv, idx, True)
                        out.append((bp + [int(idx)],
                                    got[0] if got else None))
                    elif not opt:
                        raise JqError(
                            f"jq: cannot index {_jq_type(bv)} with number")
                elif not opt:
                    raise JqError(
                        f"jq: invalid path index {_jq_type(idx)}")
        return out
    if tag == "iter":
        opt = node[2]
        out = []
        for bp, bv in _paths_of(node[1], v, env):
            if isinstance(bv, list):
                out.extend((bp + [i], x) for i, x in enumerate(bv))
            elif isinstance(bv, dict):
                out.extend((bp + [k], x) for k, x in bv.items())
            elif not opt:
                raise JqError(f"jq: cannot iterate over {_jq_type(bv)}")
        return out
    if tag == "pipe":
        out = []
        for bp, bv in _paths_of(node[1], v, env):
            out.extend((bp + sp, sv)
                       for sp, sv in _paths_of(node[2], bv, env))
        return out
    if tag == "comma":
        out = []
        for part in node[1]:
            out.extend(_paths_of(part, v, env))
        return out
    if tag == "if":
        _, cond, then, els = node
        out = []
        for c in _eval(cond, v, env):
            out.extend(_paths_of(then if _truthy(c) else els, v, env))
        return out
    if tag == "call" and node[1] == "select" and len(node[2]) == 1:
        return [(p, x) for p, x in _paths_of(("dot",), v, env)
                for c in _eval(node[2][0], x, env) if _truthy(c)]
    if tag == "call" and node[1] == "empty":
        return []
    if tag == "call" and node[1] in ("first", "last") and not node[2]:
        # jq defines first as .[0] and last as .[-1] — same in paths
        idx = 0 if node[1] == "first" else -1
        return _paths_of(("indexe", ("dot",), ("lit", idx), False),
                         v, env)
    if tag == "call" and node[1] == "getpath" and len(node[2]) == 1:
        out = []
        for p in _eval(node[2][0], v, env):
            if not isinstance(p, list):
                raise JqError("jq: getpath needs an array path")
            x = v
            for c in p:
                got = _index(x, c, opt=True) if x is not None else []
                x = got[0] if got else None
            out.append((p, x))
        return out
    if tag == "try":
        try:
            return _paths_of(node[1], v, env)
        except JqError:
            return [] if node[2] is None else _paths_of(node[2], v, env)
    raise JqError("jq: invalid path expression")


def _delpath(v: Any, path: List[Any]) -> Any:
    """Functional delete; missing segments are a no-op, like jq."""
    if not path:
        return None
    p = path[0]
    if isinstance(p, str):
        if v is None or not isinstance(v, dict) or p not in v:
            if v is not None and not isinstance(v, dict):
                raise JqError(
                    f"jq: cannot delete field of {_jq_type(v)}")
            return v
        out = dict(v)
        if len(path) == 1:
            del out[p]
        else:
            out[p] = _delpath(out[p], path[1:])
        return out
    if isinstance(p, (int, float)) and not isinstance(p, bool):
        if v is None:
            return v
        if not isinstance(v, list):
            raise JqError(f"jq: cannot delete index of {_jq_type(v)}")
        i = int(p) + (len(v) if p < 0 else 0)
        if not 0 <= i < len(v):
            return v
        out = list(v)
        if len(path) == 1:
            del out[i]
        else:
            out[i] = _delpath(out[i], path[1:])
        return out
    raise JqError(f"jq: invalid path component {_jq_type(p)}")


def _delpaths(v: Any, paths: List[List[Any]]) -> Any:
    # deepest/rightmost first so earlier deletions don't shift the
    # indices later ones rely on (jq sorts the same way)
    for p in sorted(paths, key=_SortKey, reverse=True):
        if not isinstance(p, list):
            raise JqError("jq: delpaths needs an array of paths")
        v = _delpath(v, p)
    return v


def _eval_assign(op: str, lhs, rhs, v: Any, env) -> List[Any]:
    paths = [p for p, _ in _paths_of(lhs, v, env)]
    if op == "|=":
        # update-assign: rhs sees the OLD value at each path; an empty
        # rhs deletes the path (jq 1.7 semantics)
        cur = v
        dels = []
        for p in paths:
            old = _getpath_value(cur, p)
            outs = _eval(rhs, old, env)
            if outs:
                cur = _setpath(cur, p, outs[0])
            else:
                dels.append(p)
        return [_delpaths(cur, dels) if dels else cur]
    out = []
    for b in _eval(rhs, v, env):        # rhs sees the ORIGINAL input
        cur = v
        for p in paths:
            if op == "=":
                new = b
            else:
                old = _getpath_value(cur, p)
                if op == "//=":
                    new = old if _truthy(old) else b
                else:
                    new = _arith(op[0], old, b)
            cur = _setpath(cur, p, new)
        out.append(cur)
    return out


def _getpath_value(v: Any, path: List[Any]) -> Any:
    x = v
    for p in path:
        if x is None:
            continue
        got = _index(x, p, opt=True)
        x = got[0] if got else None
    return x


def _pattern_vars(pat, into: set) -> None:
    if pat[0] == "pvar":
        into.add(pat[1])
    elif pat[0] == "parray":
        for sub in pat[1]:
            _pattern_vars(sub, into)
    elif pat[0] == "pobject":
        for _, sub in pat[1]:
            _pattern_vars(sub, into)
    else:                               # palt
        for sub in pat[1]:
            _pattern_vars(sub, into)


def _alt_attempts(pat, val, env):
    """Yield (envs, is_last) per ?// alternative whose MATCH succeeds
    (match failure skips to the next unless last); callers retry the
    next attempt when their BODY errors too — the full jq retry unit.
    Variables only present in other alternatives bind null so the
    body always sees the full variable set.

    Known divergence from jq (documented, deterministic): a retry
    DISCARDS outputs the failing attempt's body already produced —
    real jq streams them out before switching alternatives.  Exact
    parity needs the same lazy evaluator label/break would."""
    if pat[0] != "palt":
        yield _destructure(pat, val, env), True
        return
    _, pats, varsets, allvars = pat
    last = len(pats) - 1
    for k, p in enumerate(pats):
        try:
            envs = _destructure(p, val, env)
        except JqError:
            if k == last:
                raise
            continue
        for e in envs:
            for name in allvars - varsets[k]:
                e[name] = None
        yield envs, k == last


def _as_eval(pat, x, env, body, v) -> List[Any]:
    """One `as` binding + body evaluation with ?// retry."""
    for envs, is_last in _alt_attempts(pat, x, env):
        try:
            out = []
            for e2 in envs:
                out.extend(_eval(body, v, e2))
            return out
        except JqError:
            if is_last:
                raise
    return []


_FOLD_DEAD = object()       # sentinel: empty update killed the fold


def _fold_elem(pat, x, env, updn, acc):
    """One reduce step over one source element, with ?// retry on
    update errors (same retry unit as `as`)."""
    for envs, is_last in _alt_attempts(pat, x, env):
        try:
            a = acc
            for e2 in envs:
                outs = _eval(updn, a, e2)
                if not outs:
                    return _FOLD_DEAD
                a = outs[-1]
            return a
        except JqError:
            if is_last:
                raise
    return _FOLD_DEAD


def _foreach_elem(pat, x, env, updn, extn, acc):
    """One foreach step: returns (emitted, new_acc, stopped), with
    ?// retry on update/extract errors."""
    for envs, is_last in _alt_attempts(pat, x, env):
        try:
            trial: list = []
            a = acc
            stopped = False
            for e2 in envs:
                outs = _eval(updn, a, e2)
                if not outs:
                    stopped = True
                    break
                for o in outs:
                    trial.extend(_eval(extn, o, e2) if extn else [o])
                a = outs[-1]
            return trial, a, stopped
        except JqError:
            if is_last:
                raise
    return [], acc, True


def _destructure(pat, val, env) -> List[dict]:
    """Bind a destructuring pattern against one value: returns the
    environment(s) for the body — plural because ``(expr):`` pattern
    keys are generators (evaluated with ``.`` bound to the value
    being matched, like jq).  ``null`` destructures to all-null
    bindings; container mismatches error, like jq."""
    base = dict(env) if env else {}

    def bind(p, value, envs):
        tag = p[0]
        if tag == "pvar":
            for e in envs:
                e[p[1]] = value
            return envs
        if tag == "parray":
            if value is not None and not isinstance(value, list):
                raise JqError(
                    f"jq: cannot destructure {_jq_type(value)} as array")
            for i, sub in enumerate(p[1]):
                item = (None if value is None or i >= len(value)
                        else value[i])
                envs = bind(sub, item, envs)
            return envs
        if value is not None and not isinstance(value, dict):
            raise JqError(
                f"jq: cannot destructure {_jq_type(value)} as object")
        for keyexpr, sub in p[1]:
            nxt = []
            for e in envs:
                for k in _eval(keyexpr, value, e):
                    if not isinstance(k, str):
                        raise JqError("jq: pattern key must be a "
                                      "string")
                    item = None if value is None else value.get(k)
                    nxt.extend(bind(sub, item, [dict(e)]))
            envs = nxt
        return envs

    return bind(pat, val, [base])


def _call_user(fn, args: List[Any], v: Any, env) -> List[Any]:
    """Invoke a def'd function.  Filter params bind as CLOSURES over
    the caller's environment (invoked as zero-arg calls inside the
    body, jq-style); $-value params evaluate against the caller's
    input NOW, fanning the call out over their output streams."""
    if fn[0] == "closure":              # a filter param being invoked
        _, ast, cenv = fn
        return _eval(ast, v, cenv)
    params, body, fenv = fn
    envs = [dict(fenv)]
    for p, ast in zip(params, args):
        if p.startswith("$"):
            # jq desugars def f($a): B to def f(a): a as $a | B —
            # the bare name stays callable as a filter too
            nxt = []
            for e in envs:
                for val in _eval(ast, v, env):
                    e2 = dict(e)
                    e2[p[1:]] = val
                    e2[("fn", p[1:], 0)] = ("closure", ast, env)
                    nxt.append(e2)
            envs = nxt
        else:
            for e in envs:
                e[("fn", p, 0)] = ("closure", ast, env)
    out: List[Any] = []
    for e in envs:
        out.extend(_eval(body, v, e))
    return out


def _call(name: str, args: List[Any], v: Any,
          env=None) -> List[Any]:
    n = len(args)

    def one(i):
        outs = _eval(args[i], v, env)
        if len(outs) != 1:
            raise JqError(f"jq: {name} argument must yield one value")
        return outs[0]

    if name == "empty" and n == 0:
        return []
    if name == "error":
        raise JqError(f"jq: error: {one(0) if n else v}")
    if name == "length" and n == 0:
        if v is None:
            return [0]
        if isinstance(v, bool):
            raise JqError("jq: boolean has no length")
        if isinstance(v, (int, float)):
            return [abs(v)]
        return [len(v)]
    if name == "keys" and n == 0:
        if isinstance(v, dict):
            return [sorted(v)]
        if isinstance(v, list):
            return [list(range(len(v)))]
        raise JqError(f"jq: {_jq_type(v)} has no keys")
    if name == "values" and n == 0:   # jq: values == select(. != null)
        return [] if v is None else [v]
    if name == "type" and n == 0:
        return [_jq_type(v)]
    if name == "add" and n == 0:
        if not isinstance(v, list):
            raise JqError("jq: add needs an array")
        if not v:
            return [None]
        acc = v[0]
        for x in v[1:]:
            acc = _arith("+", acc, x)
        return [acc]
    if name in ("floor", "ceil", "sqrt", "abs") and n == 0:
        x = _num(v, name)
        return [{"floor": math.floor, "ceil": math.ceil,
                 "sqrt": math.sqrt, "abs": abs}[name](x)]
    if name == "tostring" and n == 0:
        return [v if isinstance(v, str)
                else json.dumps(v, separators=(",", ":"))]
    if name == "tonumber" and n == 0:
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return [v]
        if isinstance(v, str):
            try:
                f = float(v)
                return [int(f) if f.is_integer() and "." not in v
                        and "e" not in v.lower() else f]
            except ValueError:
                pass
        raise JqError(f"jq: cannot parse {v!r} as number")
    if name == "ascii_downcase" and n == 0:
        return [str(v).lower() if isinstance(v, str) else _bad(name, v)]
    if name == "ascii_upcase" and n == 0:
        return [str(v).upper() if isinstance(v, str) else _bad(name, v)]
    if name == "reverse" and n == 0:
        if isinstance(v, (list, str)):
            return [v[::-1]]
        raise JqError(f"jq: cannot reverse {_jq_type(v)}")
    if name == "sort" and n == 0:
        if not isinstance(v, list):
            raise JqError("jq: sort needs an array")
        return [sorted(v, key=_SortKey)]
    if name == "sort_by" and n == 1:
        if not isinstance(v, list):
            raise JqError("jq: sort_by needs an array")

        def _key(x):
            outs = _eval(args[0], x, env)
            return _SortKey(outs[0] if outs else None)

        return [sorted(v, key=_key)]
    if name == "unique" and n == 0:
        if not isinstance(v, list):
            raise JqError("jq: unique needs an array")
        out: List[Any] = []
        for x in sorted(v, key=_SortKey):
            if not out or _cmp(out[-1], x) != 0:
                out.append(x)
        return [out]
    if name == "join" and n == 1:
        sep = one(0)
        if not isinstance(v, list):
            raise JqError("jq: join needs an array")
        return [str(sep).join(
            "" if x is None else x if isinstance(x, str)
            else json.dumps(x, separators=(",", ":")) for x in v)]
    if name == "split" and n == 1:
        if not isinstance(v, str):
            raise JqError("jq: split needs a string")
        return [v.split(one(0))]
    if name == "map" and n == 1:
        if not isinstance(v, list):
            raise JqError("jq: map needs an array")
        out = []
        for x in v:
            out.extend(_eval(args[0], x, env))
        return [out]
    if name == "select" and n == 1:
        out = []
        for c in _eval(args[0], v, env):
            if _truthy(c):
                out.append(v)
        return out
    if name == "has" and n == 1:
        k = one(0)
        if isinstance(v, dict):
            return [k in v]
        if isinstance(v, list):
            return [isinstance(k, (int, float)) and 0 <= int(k) < len(v)]
        raise JqError(f"jq: cannot check has() on {_jq_type(v)}")
    if name == "contains" and n == 1:
        return [_contains(v, one(0))]
    if name in ("startswith", "endswith") and n == 1:
        s = one(0)
        if not isinstance(v, str) or not isinstance(s, str):
            raise JqError(f"jq: {name} needs strings")
        return [v.startswith(s) if name == "startswith"
                else v.endswith(s)]
    if name in ("ltrimstr", "rtrimstr") and n == 1:
        s = one(0)
        if not isinstance(v, str) or not isinstance(s, str):
            return [v]
        if name == "ltrimstr":
            return [v[len(s):] if v.startswith(s) else v]
        return [v[:len(v) - len(s)] if s and v.endswith(s) else v]
    if name == "test" and n in (1, 2):
        if not isinstance(v, str):
            raise JqError("jq: test needs a string input")
        rx = _jq_regex(one(0), one(1) if n == 2 else "")
        return [rx.search(v) is not None]
    if name == "match" and n in (1, 2):
        if not isinstance(v, str):
            raise JqError("jq: match needs a string input")
        flags = one(1) if n == 2 else ""
        rx = _jq_regex(one(0), flags)
        ms = rx.finditer(v) if "g" in flags else \
            ([m] if (m := rx.search(v)) else [])
        return [_match_obj(m) for m in ms]
    if name == "capture" and n in (1, 2):
        if not isinstance(v, str):
            raise JqError("jq: capture needs a string input")
        flags = one(1) if n == 2 else ""
        rx = _jq_regex(one(0), flags)
        ms = rx.finditer(v) if "g" in flags else \
            ([m] if (m := rx.search(v)) else [])
        return [m.groupdict() for m in ms]
    if name in ("sub", "gsub") and n in (2, 3):
        if not isinstance(v, str):
            raise JqError(f"jq: {name} needs a string input")
        flags = one(2) if n == 3 else ""
        rx = _jq_regex(one(0), flags)
        ms = list(rx.finditer(v))
        if not (name == "gsub" or "g" in flags):
            ms = ms[:1]
        if not ms:
            return [v]
        # jq evaluates the replacement EXPRESSION with the named
        # captures as `.` and fans its output stream out cartesian-style
        # over every match: earlier matches vary slowest (the recursive
        # sub-on-the-remainder order real jq produces)
        acc = [""]
        prev = 0
        for m in ms:
            outs = _eval(args[1], m.groupdict(), env)
            if not outs:
                raise JqError(f"jq: {name} replacement produced no value")
            for r in outs:
                if not isinstance(r, str):
                    raise JqError(
                        f"jq: {name} replacement must be a string")
            seg = v[prev:m.start()]
            acc = [a + seg + r for a in acc for r in outs]
            prev = m.end()
        tail = v[prev:]
        return [a + tail for a in acc]
    if name == "first" and n == 0:      # jq defines first as .[0]:
        if not isinstance(v, list):     # null on empty, not an error
            raise JqError("jq: first needs an array")
        return [v[0] if v else None]
    if name == "last" and n == 0:       # last == .[-1]
        if not isinstance(v, list):
            raise JqError("jq: last needs an array")
        return [v[-1] if v else None]
    if name in ("min", "max") and n == 0:
        if not isinstance(v, list):
            raise JqError(f"jq: {name} needs an array")
        if not v:
            return [None]
        pick = min if name == "min" else max
        return [pick(v, key=_SortKey)]
    if name == "not" and n == 0:
        return [not _truthy(v)]
    if name == "range":
        if n == 1:
            return list(_frange(0, one(0)))
        if n == 2:
            return list(_frange(one(0), one(1)))
    if name == "recurse" and n == 0:           # .. — every subvalue
        # iterative preorder: no recursion limit beyond memory — any
        # document json.loads produced must traverse (the sibling
        # flatten is iterative-safe for the same reason via its own
        # list recursion bounded by parse depth)
        out = []
        stack = [v]
        while stack:
            x = stack.pop()
            out.append(x)
            if isinstance(x, list):
                stack.extend(reversed(x))
            elif isinstance(x, dict):
                stack.extend(reversed(list(x.values())))
        return out
    if name == "recurse" and n in (1, 2):
        # builtin.jq: def recurse(f): def r: ., (f | r); r;
        #             def recurse(f; cond): ... (f | select(cond) | r)
        # Iterative preorder, capped: recurse(.) never terminates in
        # jq either, but a rule must not wedge the broker loop.
        out = []
        stack = [v]
        while stack:
            x = stack.pop()
            out.append(x)
            if len(out) > 1_000_000:
                raise JqError("jq: recurse output exceeds cap")
            nxt = _eval(args[0], x, env)
            if n == 2:
                nxt = [w for w in nxt
                       if any(_truthy(c) for c in _eval(args[1], w, env))]
            stack.extend(reversed(nxt))
        return out
    if name in ("any", "all") and n == 0:
        if not isinstance(v, list):
            raise JqError(f"jq: {name} needs an array")
        pick = any if name == "any" else all
        return [pick(_truthy(x) for x in v)]
    if name in ("any", "all") and n == 1:
        if not isinstance(v, list):
            raise JqError(f"jq: {name} needs an array")
        gen = (_truthy(c) for x in v for c in _eval(args[0], x, env))
        return [any(gen) if name == "any" else all(gen)]
    if name == "flatten" and n <= 1:
        if not isinstance(v, list):
            raise JqError("jq: flatten needs an array")
        depth = one(0) if n else 1 << 30
        if not isinstance(depth, int) or depth < 0:
            raise JqError("jq: flatten depth must be a non-negative int")

        def flat(xs, d):
            out2 = []
            for x in xs:
                if isinstance(x, list) and d > 0:
                    out2.extend(flat(x, d - 1))
                else:
                    out2.append(x)
            return out2

        return [flat(v, depth)]
    if name == "group_by" and n == 1:
        if not isinstance(v, list):
            raise JqError("jq: group_by needs an array")

        def gkey(x):
            outs = _eval(args[0], x, env)
            return outs[0] if outs else None

        pairs = sorted(((gkey(x), x) for x in v),
                       key=lambda p: _SortKey(p[0]))
        groups: List[List[Any]] = []
        last: Any = object()
        for k, x in pairs:
            if not groups or _cmp(k, last) != 0:
                groups.append([])
                last = k
            groups[-1].append(x)
        return [groups]
    if name in ("min_by", "max_by") and n == 1:
        if not isinstance(v, list):
            raise JqError(f"jq: {name} needs an array")
        if not v:
            return [None]

        def bkey(x):
            outs = _eval(args[0], x, env)
            return _SortKey(outs[0] if outs else None)

        pick2 = min if name == "min_by" else max
        return [pick2(v, key=bkey)]
    if name == "unique_by" and n == 1:
        if not isinstance(v, list):
            raise JqError("jq: unique_by needs an array")

        def ukey(x):
            outs = _eval(args[0], x, env)
            return outs[0] if outs else None

        pairs = sorted(((ukey(x), x) for x in v),
                       key=lambda p: _SortKey(p[0]))   # one eval/elem
        out2: List[Any] = []
        lastk: Any = object()
        for k, x in pairs:
            if not out2 or _cmp(k, lastk) != 0:
                out2.append(x)
                lastk = k
        return [out2]
    if name == "tojson" and n == 0:
        return [json.dumps(v, separators=(",", ":"))]
    if name == "fromjson" and n == 0:
        if not isinstance(v, str):
            raise JqError("jq: fromjson needs a string")
        try:
            return [json.loads(v)]
        except json.JSONDecodeError as e:
            raise JqError(f"jq: fromjson: {e}")
    if name == "explode" and n == 0:
        if not isinstance(v, str):
            raise JqError("jq: explode needs a string")
        return [[ord(c) for c in v]]
    if name == "implode" and n == 0:
        if not isinstance(v, list):
            raise JqError("jq: implode needs an array")
        for c in v:
            if isinstance(c, bool) or not isinstance(c, int):
                raise JqError("jq: implode: codepoints must be numbers")
        try:
            return ["".join(chr(c) for c in v)]
        except (ValueError, OverflowError):
            raise JqError("jq: implode: invalid codepoint")
    if name == "to_entries" and n == 0:
        if not isinstance(v, dict):
            raise JqError("jq: to_entries needs an object")
        return [[{"key": k, "value": val} for k, val in v.items()]]
    if name == "from_entries" and n == 0:
        if not isinstance(v, list):
            raise JqError("jq: from_entries needs an array")
        out_d = {}
        for e in v:
            if not isinstance(e, dict):
                raise JqError("jq: from_entries entry must be object")
            k = e.get("key", e.get("k", e.get("name")))
            out_d[str(k)] = e.get("value", e.get("v"))
        return [out_d]
    if name == "limit" and n == 2:
        k = one(0)
        if not isinstance(k, (int, float)) or isinstance(k, bool):
            raise JqError("jq: limit count must be a number")
        k = int(k)
        return _eval(args[1], v, env)[:max(0, k)]
    if name == "first" and n == 1:
        return _eval(args[0], v, env)[:1]
    if name == "last" and n == 1:
        return _eval(args[0], v, env)[-1:]
    if name == "nth" and n == 2:
        k = one(0)
        if not isinstance(k, (int, float)) or isinstance(k, bool):
            raise JqError("jq: nth count must be a number")
        k = int(k)
        if k < 0:
            raise JqError("jq: nth doesn't support negative indices")
        outs = _eval(args[1], v, env)
        return outs[k:k + 1]
    if name in ("until", "while") and n == 2:
        # canonical defs, iterated with an explicit stack (cond is a
        # generator: every output branches, like real jq) + a visit cap
        # so a non-terminating rule cannot wedge the broker loop
        out = []
        stack = [v]
        visited = 0
        while stack:
            x = stack.pop()
            visited += 1
            if visited > 1_000_000:
                raise JqError(f"jq: {name} exceeds iteration cap")
            for c in _eval(args[0], x, env):
                if name == "until":
                    if _truthy(c):
                        out.append(x)
                    else:
                        stack.extend(reversed(_eval(args[1], x, env)))
                else:                   # while: emit then continue
                    if _truthy(c):
                        out.append(x)
                        stack.extend(reversed(_eval(args[1], x, env)))
        return out
    if name == "getpath" and n == 1:
        path = one(0)
        if not isinstance(path, list):
            raise JqError("jq: getpath needs an array path")
        x = v
        for p in path:
            if x is None:
                continue
            got = _index(x, p, opt=True)
            x = got[0] if got else None
        return [x]
    if name == "setpath" and n == 2:
        path, val = one(0), one(1)
        if not isinstance(path, list):
            raise JqError("jq: setpath needs an array path")
        return [_setpath(v, path, val)]
    if name in ("paths", "leaf_paths") and n == 0:
        out = []
        stack = [(v, [])]
        while stack:
            x, path = stack.pop()
            if path:
                if name == "paths" or not isinstance(x, (list, dict)):
                    out.append(path)
            if isinstance(x, list):
                stack.extend((x[i], path + [i])
                             for i in range(len(x) - 1, -1, -1))
            elif isinstance(x, dict):
                stack.extend((x[k], path + [k])
                             for k in reversed(list(x)))
        return out
    if name == "splits" and n == 1:
        if not isinstance(v, str):
            _bad("splits", v)
        return list(re.split(one(0), v))
    if name == "isnan" and n == 0:
        return [isinstance(v, float) and math.isnan(v)]
    if name == "isinfinite" and n == 0:
        return [isinstance(v, float) and math.isinf(v)]
    if name == "infinite" and n == 0:
        return [math.inf]
    if name == "nan" and n == 0:
        return [math.nan]
    if name == "utf8bytelength" and n == 0:
        if not isinstance(v, str):
            _bad("utf8bytelength", v)
        return [len(v.encode())]
    if name == "path" and n == 1:
        return [p for p, _ in _paths_of(args[0], v, env)]
    if name == "del" and n == 1:
        return [_delpaths(v, [p for p, _ in _paths_of(args[0], v, env)])]
    if name == "delpaths" and n == 1:
        ps = one(0)
        if not isinstance(ps, list):
            raise JqError("jq: delpaths needs an array of paths")
        return [_delpaths(v, ps)]
    # --- dates (C-locale, UTC — matching jq's gmtime family) --------------
    if name == "now" and n == 0:
        import time as _t
        return [_t.time()]
    if name == "gmtime" and n == 0:
        return [_gmtime_arr(_num(v, "gmtime'd"))]
    if name == "mktime" and n == 0:
        return [_mktime_num(v)]
    if name in ("todate", "todateiso8601") and n == 0:
        import time as _t
        try:
            return [_t.strftime("%Y-%m-%dT%H:%M:%SZ",
                                _t.gmtime(_num(v, "dated")))]
        except (OverflowError, OSError, ValueError):
            raise JqError(f"jq: timestamp out of range: {v!r}")
    if name in ("fromdate", "fromdateiso8601") and n == 0:
        if not isinstance(v, str):
            _bad(name, v)
        import calendar
        import time as _t
        try:
            return [calendar.timegm(
                _t.strptime(v, "%Y-%m-%dT%H:%M:%SZ"))]
        except ValueError:
            raise JqError(f"jq: {v!r} is not an ISO-8601 datetime")
    if name == "strftime" and n == 1:
        import time as _t
        fmt = one(0)
        if not isinstance(fmt, str):
            raise JqError("jq: strftime needs a format string")
        secs = _num(v, "formatted") if isinstance(v, (int, float)) \
            and not isinstance(v, bool) else _mktime_num(v)
        try:
            return [_t.strftime(fmt, _t.gmtime(secs))]
        except (OverflowError, OSError, ValueError):
            raise JqError(f"jq: timestamp out of range: {v!r}")
    if name == "strptime" and n == 1:
        import calendar
        import time as _t
        fmt = one(0)
        if not isinstance(v, str) or not isinstance(fmt, str):
            raise JqError("jq: strptime needs string input and format")
        try:
            st = _t.strptime(v, fmt)
        except ValueError as e:
            raise JqError(f"jq: strptime: {e}")
        return [_gmtime_arr(calendar.timegm(st))]
    raise JqError(f"jq: unknown function {name}/{n}")


def _jq_regex(pat: Any, flags: Any):
    """Compile a jq (Oniguruma-style) regex with jq's flag letters.
    Python's `re` covers the common subset; named groups translate
    from ``(?<n>...)`` to ``(?P<n>...)``.  Divergences beyond that
    (e.g. \\h, possessive quantifiers) surface as JqError."""
    if not isinstance(pat, str):
        raise JqError("jq: regex must be a string")
    if not isinstance(flags, str):
        raise JqError("jq: regex flags must be a string")
    f = 0
    for c in flags:
        if c == "i":
            f |= re.IGNORECASE
        elif c == "x":
            f |= re.VERBOSE
        elif c == "s":
            f |= re.DOTALL
        elif c == "m":
            f |= re.MULTILINE
        elif c != "g":                  # g handled by the callers
            raise JqError(f"jq: unsupported regex flag {c!r}")
    pat = re.sub(r"\(\?<([A-Za-z_][A-Za-z0-9_]*)>", r"(?P<\1>", pat)
    try:
        return re.compile(pat, f)
    except re.error as e:
        raise JqError(f"jq: bad regex: {e}")


def _match_obj(m) -> dict:
    caps = []
    gi = m.re.groupindex
    names = {idx: nm for nm, idx in gi.items()}
    for i in range(1, m.re.groups + 1):
        s = m.group(i)
        caps.append({
            "offset": m.start(i) if s is not None else -1,
            "length": len(s) if s is not None else 0,
            "string": s,
            "name": names.get(i),
        })
    return {"offset": m.start(), "length": len(m.group(0)),
            "string": m.group(0), "captures": caps}


def _gmtime_arr(secs: float) -> list:
    """jq's broken-down UTC time: [year, month(0-based), mday, hour,
    min, sec(+frac), wday(Sunday=0), yday(0-based)]."""
    import time as _t
    try:
        g = _t.gmtime(int(secs))
    except (OverflowError, OSError, ValueError):
        # platform time_t limits must surface as jq errors (catchable
        # by try/catch), not raw OverflowError (module error contract)
        raise JqError(f"jq: timestamp out of range: {secs!r}")
    frac = secs - int(secs)
    return [g.tm_year, g.tm_mon - 1, g.tm_mday, g.tm_hour, g.tm_min,
            g.tm_sec + frac if frac else g.tm_sec,
            (g.tm_wday + 1) % 7, g.tm_yday - 1]


def _mktime_num(v: Any) -> int:
    import calendar
    if not (isinstance(v, list) and len(v) >= 6
            and all(isinstance(x, (int, float)) and not isinstance(x, bool)
                    for x in v[:6])):
        raise JqError("jq: mktime needs a broken-down time array")
    y, mon0, mday, hh, mm, ss = (int(x) for x in v[:6])
    try:
        return calendar.timegm((y, mon0 + 1, mday, hh, mm, ss, 0, 1, 0))
    except (OverflowError, OSError, ValueError):
        raise JqError(f"jq: broken-down time out of range: {v!r}")


def _setpath(v: Any, path: List[Any], val: Any) -> Any:
    """Functional deep-set: containers copied along the path, created
    (object for string keys, array for int) where missing."""
    if not path:
        return val
    p = path[0]
    if isinstance(p, str):
        if v is None:
            v = {}
        if not isinstance(v, dict):
            raise JqError(f"jq: cannot set field of {_jq_type(v)}")
        out = dict(v)
        out[p] = _setpath(v.get(p), path[1:], val)
        return out
    if isinstance(p, (int, float)) and not isinstance(p, bool):
        i = int(p)
        if v is None:
            v = []
        if not isinstance(v, list):
            raise JqError(f"jq: cannot set index of {_jq_type(v)}")
        if i < 0:
            if -i > len(v):
                raise JqError("jq: out of bounds negative array index")
            i += len(v)
        if i >= 1_000_000:
            # same posture as the range/recurse caps: one dashboard-
            # authored rule must not allocate a giant padded array in
            # the dispatch path
            raise JqError("jq: setpath index exceeds cap")
        out = list(v) + [None] * (i + 1 - len(v))
        out[i] = _setpath(out[i], path[1:], val)
        return out
    raise JqError(f"jq: invalid path component {_jq_type(p)}")


def _bad(name: str, v: Any):
    raise JqError(f"jq: {name} needs a string, got {_jq_type(v)}")


def _contains(a: Any, b: Any) -> bool:
    if isinstance(a, str) and isinstance(b, str):
        return b in a
    if isinstance(a, list) and isinstance(b, list):
        return all(any(_contains(x, y) for x in a) for y in b)
    if isinstance(a, dict) and isinstance(b, dict):
        return all(k in a and _contains(a[k], bv) for k, bv in b.items())
    return _cmp(a, b) == 0


_RANGE_CAP = 1_000_000


def _frange(lo: Any, hi: Any):
    x = _num(lo, "ranged")
    hi = _num(hi, "ranged")
    if hi - x > _RANGE_CAP:
        # the evaluator materializes streams; real jq streams range
        # lazily — cap so one dashboard-authored rule cannot build a
        # billion-element list in the dispatch path
        raise JqError(f"jq: range span exceeds {_RANGE_CAP}")
    while x < hi:
        yield int(x) if float(x).is_integer() else x
        x += 1


class _SortKey:
    __slots__ = ("v",)

    def __init__(self, v: Any) -> None:
        self.v = v

    def __lt__(self, other: "_SortKey") -> bool:
        return _cmp(self.v, other.v) < 0


_PARSE_CACHE: dict = {}


def jq_eval(prog: str, value: Any,
            max_cache: int = 256) -> List[Any]:
    """Evaluate jq ``prog`` against ``value`` → list of outputs (jq's
    output stream).  Programs are parse-cached (rules re-run the same
    program per message)."""
    node = _PARSE_CACHE.get(prog)
    if node is None:
        node = _parse(prog)
        if len(_PARSE_CACHE) >= max_cache:
            _PARSE_CACHE.clear()
        _PARSE_CACHE[prog] = node
    try:
        return _eval(node, value, {})
    except RecursionError:
        # unbounded def-recursion must surface as a jq error (still a
        # loud failure, but catchable and not a VM-level blowup)
        raise JqError("jq: recursion depth exceeded")
