"""Rule-SQL parser.

The port's own copy of the reference's ``emqx_tpu/rule_engine/sqlparser.py``
(nothing here imports the JAX package).

Behavioral reference: the ``rulesql`` grammar used by
``emqx_rule_sqlparser.erl`` [U] (SURVEY.md §2.3).  Supported surface::

    SELECT <field [AS alias], ...|*>
    FROM "topic/filter" [, "t2/#", ...]
    [WHERE <boolean expr>]

    FOREACH <array expr> [AS alias] [DO <field,...>] [INCASE <expr>]
    FROM ... [WHERE ...]

Expressions: arithmetic (+ - * / div mod), comparison (= != <> > < >= <=),
boolean (AND OR NOT), string concat via ``+``, ``IN (...)``, ``LIKE``
(% wildcards), CASE WHEN ... THEN ... [ELSE ...] END, function calls,
nested access paths (``payload.a.b``, ``payload.x[1]`` — 1-based like
the reference), ``'single-quoted'`` strings, numbers, booleans,
``${...}`` is NOT part of SQL (templates live in actions).

The output AST is plain tuples (pure data, picklable):

    ('lit', v) ('var', ['payload','a']) ('call', name, [args])
    ('op', sym, lhs, rhs) ('not', e) ('and', l, r) ('or', l, r)
    ('in', e, [items]) ('like', e, pattern) ('case', [(when, then)], else)
    ('index', e, idx_expr)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

__all__ = ["SqlError", "Rule", "parse_sql"]


class SqlError(ValueError):
    pass


@dataclass
class Rule:
    """Parsed statement: the compile artifact kept per rule."""

    kind: str                       # 'select' | 'foreach'
    fields: List[Tuple[Any, Optional[str]]]   # [(expr, alias)]; [('*',None)]
    froms: List[str]
    where: Optional[Any] = None
    # foreach only:
    foreach: Optional[Any] = None
    foreach_alias: Optional[str] = None
    incase: Optional[Any] = None


_TOKEN = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d+|\d+)
  | (?P<dqstr>"(?:[^"\\]|\\.)*")
  | (?P<sqstr>'(?:[^'\\]|\\.)*')
  | (?P<op><>|!=|>=|<=|=|>|<|\+|-|\*|/|\(|\)|\[|\]|,|\.)
  | (?P<ident>[A-Za-z_$][A-Za-z0-9_$]*)
    """,
    re.X,
)

_KEYWORDS = {
    "select", "from", "where", "as", "and", "or", "not", "in", "like",
    "case", "when", "then", "else", "end", "foreach", "do", "incase",
    "div", "mod", "true", "false", "null", "undefined",
}


def _tokenize(sql: str) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN.match(sql, pos)
        if m is None:
            raise SqlError(f"bad character at {pos}: {sql[pos:pos+16]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        tok = m.group()
        if kind == "ident" and tok.lower() in _KEYWORDS:
            out.append(("kw", tok.lower()))
        else:
            out.append((kind, tok))
    out.append(("eof", ""))
    return out


class _Parser:
    def __init__(self, sql: str) -> None:
        self.toks = _tokenize(sql)
        self.i = 0

    def peek(self) -> Tuple[str, str]:
        return self.toks[self.i]

    def take(self, kind: Optional[str] = None, val: Optional[str] = None):
        k, v = self.toks[self.i]
        if (kind is not None and k != kind) or (val is not None and v != val):
            raise SqlError(f"expected {val or kind}, got {v!r}")
        self.i += 1
        return v

    def at_kw(self, *words: str) -> bool:
        k, v = self.peek()
        return k == "kw" and v in words

    # -- statement ---------------------------------------------------------

    def parse(self) -> Rule:
        if self.at_kw("select"):
            self.take()
            fields = self.select_list()
            rule = Rule("select", fields, froms=[])
        elif self.at_kw("foreach"):
            self.take()
            fe = self.expr()
            alias = None
            if self.at_kw("as"):
                self.take()
                alias = self.take("ident")
            fields: List[Tuple[Any, Optional[str]]] = [("*", None)]
            incase = None
            if self.at_kw("do"):
                self.take()
                fields = self.select_list()
            if self.at_kw("incase"):
                self.take()
                incase = self.expr()
            rule = Rule("foreach", fields, froms=[], foreach=fe,
                        foreach_alias=alias, incase=incase)
        else:
            raise SqlError("statement must start with SELECT or FOREACH")
        self.take("kw", "from")
        rule.froms = self.from_list()
        if self.at_kw("where"):
            self.take()
            rule.where = self.expr()
        self.take("eof")
        return rule

    def select_list(self) -> List[Tuple[Any, Optional[str]]]:
        out: List[Tuple[Any, Optional[str]]] = []
        while True:
            if self.peek() == ("op", "*"):
                self.take()
                out.append(("*", None))
            else:
                e = self.expr()
                alias = None
                if self.at_kw("as"):
                    self.take()
                    alias = self.take("ident")
                out.append((e, alias))
            if self.peek() == ("op", ","):
                self.take()
                continue
            return out

    def from_list(self) -> List[str]:
        out = []
        while True:
            k, v = self.peek()
            if k == "dqstr":
                out.append(v[1:-1])
            elif k == "sqstr":
                out.append(v[1:-1])
            elif k == "ident":
                out.append(v)
            else:
                raise SqlError(f"bad FROM entry {v!r}")
            self.take()
            if self.peek() == ("op", ","):
                self.take()
                continue
            return out

    # -- expressions -------------------------------------------------------

    def expr(self):
        return self.or_expr()

    def or_expr(self):
        e = self.and_expr()
        while self.at_kw("or"):
            self.take()
            e = ("or", e, self.and_expr())
        return e

    def and_expr(self):
        e = self.not_expr()
        while self.at_kw("and"):
            self.take()
            e = ("and", e, self.not_expr())
        return e

    def not_expr(self):
        if self.at_kw("not"):
            self.take()
            return ("not", self.not_expr())
        return self.cmp_expr()

    def cmp_expr(self):
        e = self.add_expr()
        k, v = self.peek()
        if k == "op" and v in ("=", "!=", "<>", ">", "<", ">=", "<="):
            self.take()
            sym = "!=" if v == "<>" else v
            return ("op", sym, e, self.add_expr())
        if self.at_kw("in"):
            self.take()
            self.take("op", "(")
            items = [self.expr()]
            while self.peek() == ("op", ","):
                self.take()
                items.append(self.expr())
            self.take("op", ")")
            return ("in", e, items)
        if self.at_kw("like"):
            self.take()
            pat = self.take("sqstr")[1:-1]
            return ("like", e, pat)
        return e

    def add_expr(self):
        e = self.mul_expr()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("+", "-"):
                self.take()
                e = ("op", v, e, self.mul_expr())
            else:
                return e

    def mul_expr(self):
        e = self.unary()
        while True:
            k, v = self.peek()
            if (k == "op" and v in ("*", "/")) or self.at_kw("div", "mod"):
                self.take()
                e = ("op", v, e, self.unary())
            else:
                return e

    def unary(self):
        if self.peek() == ("op", "-"):
            self.take()
            return ("op", "-", ("lit", 0), self.unary())
        return self.postfix()

    def postfix(self):
        e = self.primary()
        while True:
            k, v = self.peek()
            if (k, v) == ("op", "."):
                self.take()
                name = self.take("ident")
                if e[0] == "var":
                    e = ("var", e[1] + [name])
                else:
                    e = ("index", e, ("lit", name))
            elif (k, v) == ("op", "["):
                self.take()
                idx = self.expr()
                self.take("op", "]")
                e = ("index", e, idx)
            else:
                return e

    def primary(self):
        k, v = self.peek()
        if k == "num":
            self.take()
            return ("lit", float(v) if "." in v else int(v))
        if k == "sqstr":
            self.take()
            return ("lit", v[1:-1].replace("\\'", "'"))
        if k == "dqstr":
            # double quotes quote identifiers/topics in rulesql
            self.take()
            return ("var", v[1:-1].split("."))
        if (k, v) == ("op", "("):
            self.take()
            e = self.expr()
            self.take("op", ")")
            return e
        if k == "kw" and v in ("true", "false"):
            self.take()
            return ("lit", v == "true")
        if k == "kw" and v in ("null", "undefined"):
            self.take()
            return ("lit", None)
        if k == "kw" and v == "case":
            return self.case_expr()
        if k == "ident":
            self.take()
            if self.peek() == ("op", "("):
                self.take()
                args = []
                if self.peek() != ("op", ")"):
                    args.append(self.expr())
                    while self.peek() == ("op", ","):
                        self.take()
                        args.append(self.expr())
                self.take("op", ")")
                return ("call", v.lower(), args)
            return ("var", [v])
        raise SqlError(f"unexpected token {v!r}")

    def case_expr(self):
        self.take("kw", "case")
        whens = []
        # operand form: CASE x WHEN v THEN r ... ; search form: CASE WHEN c THEN r
        operand = None
        if not self.at_kw("when"):
            operand = self.expr()
        while self.at_kw("when"):
            self.take()
            cond = self.expr()
            if operand is not None:
                cond = ("op", "=", operand, cond)
            self.take("kw", "then")
            whens.append((cond, self.expr()))
        els = None
        if self.at_kw("else"):
            self.take()
            els = self.expr()
        self.take("kw", "end")
        return ("case", whens, els)


def parse_sql(sql: str) -> Rule:
    """Parse one rule statement; raises :class:`SqlError` on bad input."""
    return _Parser(sql).parse()
