"""The port's rule engine (``emqx_tpu_torch/rule_engine``) against the
reference's (``emqx_tpu/rule_engine``), exactly.

* ``parse_sql``: the statements of ``tests/test_rule_engine.py`` and
  seeded SELECT / FOREACH / CASE / LIKE / IN statements give equal trees,
  or equal ``SqlError``s;
* ``eval_rule`` and ``render_template`` over seeded event columns give
  equal outputs (or the same exception);
* every ``call_func`` built-in, on meaningful and on seeded arguments:
  equal results or the same exception (``now_timestamp`` and
  ``uuid_v4`` compared by shape, not value);
* ``jq`` on every program of ``tests/test_jq.py`` (one parametrised
  test) and on its error programs;
* a scripted engine run (create, disable, enable, delete, republish, the
  loop guard and the chain depth bound, bridge and bad actions, the
  ``$events`` lifecycle taps and their lazy registration) on the
  reference's ``RuleEngine(Broker)`` and the port's: equal outputs,
  metrics, hook registrations and sends to each client;
* seeded overlapping rule filters with no hint: the port's host trie of
  rule filters runs the rules the reference's per-rule ``T.match`` does,
  in its order;
* the same script with the port's ``MatchService(device="cpu")``
  attached: ``hint_rules`` answers the publishes' rule selection, with
  the same results as the reference's host matching.

Intended divergence, asserted as such: a string (bridge) action fails on
both, since the port has no bridges and the reference engine has no
bridge resolver until a ``BridgeManager`` sets one.
"""

import asyncio
import gc
import json
import random

import pytest

import test_jq as ref_jq_cases
from emqx_tpu.broker import Broker as RefBroker
from emqx_tpu.broker.message import make_message as ref_make_message
from emqx_tpu.rule_engine import RuleEngine as RefEngine
from emqx_tpu.rule_engine import eval_rule as ref_eval
from emqx_tpu.rule_engine import parse_sql as ref_parse
from emqx_tpu.rule_engine import render_template as ref_render
from emqx_tpu.rule_engine.engine import message_columns as ref_columns
from emqx_tpu.rule_engine.funcs import FUNCS as REF_FUNCS
from emqx_tpu.rule_engine.funcs import call_func as ref_call
from emqx_tpu.rule_engine.jq import jq_eval as ref_jq
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.match_service import MatchService
from emqx_tpu_torch.broker.message import make_message
from emqx_tpu_torch.observe import Metrics
from emqx_tpu_torch.rule_engine import RuleEngine, SqlError, eval_rule
from emqx_tpu_torch.rule_engine import parse_sql, render_template
from emqx_tpu_torch.rule_engine.engine import message_columns
from emqx_tpu_torch.rule_engine.funcs import FUNCS, call_func
from emqx_tpu_torch.rule_engine.jq import jq_eval


def outcome(fn, *args):
    """``("ok", value)`` or ``("raise", exception class name, message)``."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — the exception is the outcome
        return ("raise", type(e).__name__, str(e))


def tree(rule):
    return None if rule is None else (
        rule.kind, rule.fields, rule.froms, rule.where, rule.foreach,
        rule.foreach_alias, rule.incase)


# -- parse_sql -------------------------------------------------------------------

# the statements of tests/test_rule_engine.py, and its error statements
FIXED_SQL = [
    'SELECT payload.x as x, topic FROM "t/#" WHERE qos > 0',
    'SELECT * FROM "a/+", "$events/client_connected"',
    "DELETE FROM x",
    'SELECT * FROM "t" WHERE (1 + ',
    "FOREACH payload.sensors AS s DO s.name, s.temp "
    'INCASE s.temp > 30 FROM "t"',
    'SELECT payload.temp as temp, topic FROM "t/#" '
    "WHERE payload.temp > 30 and qos = 1",
    'SELECT * FROM "t/#" WHERE payload.temp > 100',
    "SELECT a + b as add, a div b as d, a mod b as m, "
    "upper(s) as up, concat(s, '!') as ex, "
    "case when a > 5 then 'big' else 'small' end as sz, "
    "a in (1, 7) as isin, s like 'he%' as lk "
    'FROM "t/#"',
    "FOREACH payload.sensors AS s DO s.name as name, s.temp as temp "
    'INCASE s.temp > 30 FROM "t"',
    "SELECT nth(2, payload.xs) as n, length(payload.xs) as l, "
    "map_get('k', payload.m) as mk, first(payload.xs) as f, "
    "json_encode(payload.xs) as js, md5('abc') as h, "
    "nth_topic_level(2, topic) as lvl, "
    "topic_match(topic, 'a/#') as tm "
    'FROM "a/#"',
    'SELECT payload.temp as temp, clientid FROM "sensors/+/temp" '
    "WHERE payload.temp > 30",
    'SELECT clientid, topic, qos FROM "$events/session_subscribed"',
    'SELECT * FROM "s/+/t"', 'SELECT * FROM "s/#", "other/x"',
    "", "SELECT", "SELECT a FROM", 'SELECT a FROM "t" WHERE',
    'SELECT a b c FROM "t"', "FOREACH FROM \"t\"",
    "SELECT case when 1 then 2 FROM \"t\"",
    'SELECT \'unterminated FROM "t"',
    'SELECT payload.xs[1] as x1, payload.xs[0 + 2] FROM "t"',
    'SELECT not qos = 1 as nq, -payload.temp as neg FROM "t"',
    'SELECT jq(\'.xs[] | . * 2\', payload) as j FROM "t"',
]

_PATHS = ["payload.temp", "payload.xs", "payload.m.k", "topic", "clientid",
          "qos", "payload.xs[1]", "payload.s", "payload.missing", "retain",
          "flags.retain", "username", "payload.sensors"]
_FUNCS_1 = ["upper", "lower", "abs", "strlen", "length", "is_null", "str",
            "int", "float", "json_encode", "md5", "first", "last", "trim"]
_FUNCS_2 = ["concat", "nth", "map_get", "pow", "fmod", "split",
            "topic_match", "nth_topic_level", "contains", "regex_match"]
_OPS = ["+", "-", "*", "/", "div", "mod"]
_CMPS = ["=", "!=", "<>", ">", "<", ">=", "<="]


def _lit(rng):
    return rng.choice([str(rng.randint(-5, 40)),
                       f"{rng.uniform(-5, 40):.2f}", "'a/b'", "'he%'",
                       "'x'", "true", "false", "null"])


def _expr(rng, depth=0):
    k = rng.random() if depth < 3 else 0.0
    if k < 0.35:
        return rng.choice(_PATHS)
    if k < 0.5:
        return _lit(rng)
    if k < 0.65:
        return f"{_expr(rng, depth + 1)} {rng.choice(_OPS)} " \
               f"{_expr(rng, depth + 1)}"
    if k < 0.75:
        return f"{rng.choice(_FUNCS_1)}({_expr(rng, depth + 1)})"
    if k < 0.85:
        return f"{rng.choice(_FUNCS_2)}({_expr(rng, depth + 1)}, " \
               f"{_expr(rng, depth + 1)})"
    if k < 0.95:
        return (f"case when {_cond(rng, depth + 1)} then "
                f"{_expr(rng, depth + 1)} else {_expr(rng, depth + 1)} end")
    return f"({_expr(rng, depth + 1)})"


def _cond(rng, depth=0):
    k = rng.random() if depth < 3 else 0.0
    if k < 0.45:
        return f"{_expr(rng, depth + 1)} {rng.choice(_CMPS)} " \
               f"{_expr(rng, depth + 1)}"
    if k < 0.6:
        return f"{_cond(rng, depth + 1)} {rng.choice(['and', 'or'])} " \
               f"{_cond(rng, depth + 1)}"
    if k < 0.7:
        return f"not {_cond(rng, depth + 1)}"
    if k < 0.85:
        items = ", ".join(_lit(rng) for _ in range(rng.randint(1, 3)))
        return f"{_expr(rng, depth + 1)} in ({items})"
    return f"{rng.choice(_PATHS)} like {rng.choice(_LIKES)}"


_LIKES = ["'he%'", "'%/b'", "'a%b'", "'%'", "'x'", "'%1%'"]
_FROMS = ['"t/#"', '"sensors/+/temp"', '"a/+", "b/#"', '"+/+"', '"#"']


def seeded_sql(seed):
    """A seeded SELECT or FOREACH statement (which may not parse)."""
    rng = random.Random(seed)
    frm = rng.choice(_FROMS)
    where = f" WHERE {_cond(rng)}" if rng.random() < 0.6 else ""
    if rng.random() < 0.25:
        alias = rng.choice(["s", "x"])
        do = ", ".join(f"{alias}.{f} as {f}" for f in
                       rng.sample(["name", "temp", "v"], rng.randint(1, 2)))
        incase = (f" INCASE {alias}.temp {rng.choice(_CMPS)} "
                  f"{rng.randint(0, 40)}" if rng.random() < 0.6 else "")
        arr = rng.choice(["payload.sensors", "payload.xs", "payload.m"])
        return f"FOREACH {arr} AS {alias} DO {do}{incase} FROM {frm}{where}"
    if rng.random() < 0.1:
        fields = "*"
    else:
        fields = ", ".join(
            _expr(rng) + (f" as f{i}" if rng.random() < 0.7 else "")
            for i in range(rng.randint(1, 4)))
    return f"SELECT {fields} FROM {frm}{where}"


SEEDED_SQL = [seeded_sql(s) for s in range(120)]


@pytest.mark.parametrize("sql", FIXED_SQL + SEEDED_SQL)
def test_parse_sql_equals_the_reference(sql):
    want = outcome(ref_parse, sql)
    got = outcome(parse_sql, sql)
    assert got[0] == want[0], (sql, got, want)
    if want[0] == "ok":
        assert tree(got[1]) == tree(want[1])
    else:
        assert got[1:] == want[1:]
        if want[1] == "SqlError":
            with pytest.raises(SqlError):
                parse_sql(sql)


def test_parse_covers_select_foreach_case_like_in():
    parsed = [r for r in (outcome(parse_sql, s) for s in SEEDED_SQL)
              if r[0] == "ok"]
    kinds = {r[1].kind for r in parsed}
    text = " ".join(SEEDED_SQL)
    assert kinds == {"select", "foreach"}
    assert len(parsed) >= 100
    for word in ("case when", " like ", " in (", "INCASE", " not "):
        assert word in text, word


# -- eval_rule and render_template ----------------------------------------------

def seeded_payload(rng):
    return json.dumps({
        "temp": round(rng.uniform(0, 45), 1), "xs": [rng.randint(0, 9)
                                                     for _ in range(3)],
        "m": {"k": rng.choice(["v", "w"])},
        "s": rng.choice(["hello", "a/b", "x1"]),
        "sensors": [{"name": f"n{i}", "temp": rng.randint(10, 45)}
                    for i in range(rng.randint(0, 3))]}).encode()


def columns_pair(seed):
    """The message.publish columns of one seeded message on each side,
    the per-message fields (id, timestamps) pinned."""
    rng = random.Random(seed)
    topic = rng.choice(["t/1", "sensors/k/temp", "a/b", "b/c/d", "x/y"])
    payload = seeded_payload(rng) if rng.random() < 0.9 else b"not json"
    qos, retain = rng.randint(0, 2), rng.random() < 0.2
    out = []
    for mk, cols in ((ref_make_message, ref_columns),
                     (make_message, message_columns)):
        m = mk(f"c{seed % 3}", topic, payload, qos=qos, retain=retain,
               properties={"User-Property": [("k", "v")]})
        m.headers["username"] = "u1" if seed % 2 else None
        c = cols(m)
        c.update(id=1, timestamp=2, publish_received_at=2)
        out.append(c)
    return out


@pytest.mark.parametrize("seed", range(40))
def test_eval_rule_equals_the_reference(seed):
    ref_cols, cols = columns_pair(seed)
    assert cols == ref_cols
    for sql in SEEDED_SQL[seed::40] + FIXED_SQL[seed % 6::6]:
        ref_rule = outcome(ref_parse, sql)
        if ref_rule[0] != "ok":
            continue
        want = outcome(ref_eval, ref_rule[1], ref_cols)
        got = outcome(eval_rule, parse_sql(sql), cols)
        assert got == want, sql


def test_eval_rule_cases_of_the_reference_tests():
    cols = {"a": 7, "b": 2, "s": "hello", "topic": "t/x"}
    sql = FIXED_SQL[7]
    assert eval_rule(parse_sql(sql), cols) == \
        ref_eval(ref_parse(sql), cols)
    ref_cols, port_cols = columns_pair(3)
    for sql in FIXED_SQL[4:10]:
        if outcome(ref_parse, sql)[0] == "ok":
            assert outcome(eval_rule, parse_sql(sql), port_cols) == \
                outcome(ref_eval, ref_parse(sql), ref_cols), sql


TEMPLATES = ["alert/${clientid}/${temp}", "${nested}", "${missing}",
             "${payload.temp}", "x/${topic}/${qos}", "${xs}", "plain",
             "${a}${b}", "${", "${clientid", "$${clientid}", "${ n }",
             "${payload}", "${flags.retain}"]


@pytest.mark.parametrize("tpl", TEMPLATES)
def test_render_template_equals_the_reference(tpl):
    out = {"temp": 31.5, "nested": {"a": 1}, "xs": [1, 2], "a": b"b",
           "b": None}
    for seed in range(4):
        ref_cols, cols = columns_pair(seed)
        assert outcome(render_template, tpl, out, cols) == \
            outcome(ref_render, tpl, out, ref_cols)


# -- call_func: every built-in ------------------------------------------------

MEANINGFUL = {
    "abs": [(-3,), ("2.5",)], "ceil": [(1.2,)], "floor": [(1.8,)],
    "round": [(2.5,), (3.5,)], "sqrt": [(16,), (-1,)], "pow": [(2, 10)],
    "power": [(3, 2)], "exp": [(1,)], "log": [(10,), (0,)],
    "log10": [(1000,)], "log2": [(8,)], "sin": [(1,)], "cos": [(0,)],
    "tan": [(1,)], "fmod": [(7, 3), (1, 0)], "range": [(1, 4)],
    "lower": [("AbC",)], "upper": [(b"abc",)], "trim": [("  x ",)],
    "ltrim": [("  x ",)], "rtrim": [("  x ",)], "reverse": [("abc",)],
    "strlen": [("héllo",)], "substr": [("hello", 1), ("hello", 1, 2)],
    "split": [("a,b,,c", ","), ("a b  c",)],
    "concat": [("a", 1, None, True, 2.0)], "pad": [("ab", 5)],
    "replace": [("a-b-c", "-", "+")], "regex_match": [("abc1", r"\d")],
    "regex_replace": [("a1b22", r"\d+", "#")],
    "regex_extract": [("id=42;", r"id=(\d+)"), ("xyz", "y"),
                      ("xyz", "q")],
    "ascii": [("A",), ("",)], "find": [("hello", "ll"), ("hello", "q")],
    "tokens": [("a,b;c", ",;")], "sprintf": [("%s-%d", "a", 3)],
    "map_get": [("k", {"k": 1}), ("q", {"k": 1}, 7), ("k", [1])],
    "map_put": [("k", 2, {"a": 1}), ("k", 2, None)],
    "mget": [("k", {"k": 1})], "mput": [("k", 1, {})],
    "map_keys": [({"a": 1, "b": 2},), ([],)],
    "map_values": [({"a": 1, "b": 2},)],
    "map_to_entries": [({"a": 1},), (3,)],
    "nth": [(2, [1, 2, 3]), (9, [1])], "length": [([1, 2],), ("abc",)],
    "sublist": [(2, [1, 2, 3]), (2, 2, [1, 2, 3, 4])],
    "first": [([4, 5],), ([],)], "last": [([4, 5],), ([],)],
    "contains": [(2, [1, 2]), ("b", "abc"), (1, 5)],
    "json_decode": [('{"a": [1]}',), ("{bad",)],
    "json_encode": [({"a": [1, "x"]},)],
    "base64_encode": [(b"\x00ab",)], "base64_decode": [("YWI=",)],
    "md5": [("abc",)], "sha": [("abc",)], "sha256": [(b"abc",)],
    "bin2hexstr": [(b"\x01\xff",)], "hexstr2bin": [("01ff",), ("zz",)],
    "str": [(1.0,), (b"x",), (None,), (True,)], "str_utf8": [(2.5,)],
    "int": [("3.9",), (True,)], "float": [("2",), ("x",)],
    "bool": [("TRUE",), (0,), ([1],)],
    "now_timestamp": [(), ("millisecond",)],
    "unix_ts_to_rfc3339": [(0,), (1700000000000, "millisecond")],
    "uuid_v4": [()], "timezone_to_offset_seconds": [("+08:00",)],
    "coalesce": [(None, None, 3, 4), (None,)], "is_null": [(None,)],
    "is_not_null": [(0,)], "is_num": [(True,), (1.5,)],
    "is_str": [("s",)], "is_bool": [(False,)], "is_map": [({},)],
    "is_array": [([],)], "proc_dict_get": [("k",)],
    "jq": [(".a[] | . * 2", '{"a": [1, 2]}'), (".a", "{not json")],
    "topic_match": [("a/b/c", "a/+/c"), ("a", "b")],
    "nth_topic_level": [(2, "a/b/c"), (5, "a/b")],
}

#: compared by shape: their value is the clock's or random
BY_SHAPE = {"now_timestamp", "uuid_v4"}

_POOL = [0, 1, -2, 2.5, "a/b", "3", "", "x,y", b"ab", None, True,
         [1, 2, 3], {"k": "v"}, "%s", r"\d", "millisecond"]


def test_every_builtin_is_ported():
    assert sorted(FUNCS) == sorted(REF_FUNCS)
    assert set(MEANINGFUL) == set(FUNCS)


def _shape(out):
    if out[0] != "ok":
        return out
    v = out[1]
    if isinstance(v, str):      # uuid_v4: 36 chars, version 4
        return ("ok", "str", len(v), v[14], v.count("-"))
    return ("ok", type(v).__name__, len(str(v)))


@pytest.mark.parametrize("name", sorted(REF_FUNCS))
def test_call_func_equals_the_reference(name):
    rng = random.Random(name)
    calls = list(MEANINGFUL[name])
    for _ in range(30):
        calls.append(tuple(rng.choice(_POOL)
                           for _ in range(rng.randint(0, 3))))
    for args in calls:
        want = outcome(ref_call, name, list(args))
        got = outcome(call_func, name, list(args))
        if name in BY_SHAPE:
            got, want = _shape(got), _shape(want)
        assert got == want, (name, args)
    assert outcome(call_func, "no_such_fn", [])[:2] == ("raise",
                                                        "NameError")


# -- jq ----------------------------------------------------------------------

JQ_CASES = [(prog, doc) for name in sorted(vars(ref_jq_cases))
            if name.endswith("CASES")
            for prog, doc, _want in getattr(ref_jq_cases, name)]
JQ_ERRORS = [
    (".xs | .[] | .[]", {"xs": [1]}), ("1 + \"a\"", None), ("1 / 0", None),
    ("error(\"boom\")", None), ("nosuchfn", None), ("$undefined", None),
    (". ..", None), ("if true then 1", None), ('{"k" 1}', None),
    (".[]?", 42), ('.["k"]?', 42), (".k? // \"d\"", 42),
    (".[] // \"d\"", 42), ('.a.["k"]', {"a": {"k": 1}}),
    ("[limit(3; repeat(1))]", None), ("until(false; .)", 0),
    ("def f: f; f", None), ('"%" | @uri', None), ("@base64d", "!!"),
    ('"x" | fromjson', None), ("[1] | implode", None),
    ('"2015-03-05T23:51:47Z" | fromdateiso8601', None),
    ('"bad" | fromdateiso8601', None), (". as [$a, $b] | $a", {"a": 1}),
    ("setpath([\"a\", 100000000]; 1)", None),
]


def test_jq_cases_are_collected():
    assert len(JQ_CASES) > 250


@pytest.mark.parametrize("prog,doc", JQ_CASES + JQ_ERRORS,
                         ids=[p[:40] for p, _ in JQ_CASES + JQ_ERRORS])
def test_jq_equals_the_reference(prog, doc):
    got = outcome(jq_eval, prog, doc)
    want = outcome(ref_jq, prog, doc)
    if prog in ("now", "now | type", "[now] | length"):
        got, want = _shape(got), _shape(want)
    assert got == want


# -- a scripted engine run ---------------------------------------------------

class Side:
    """One package's broker and engine, recording rule outputs and each
    client's sends."""

    def __init__(self, broker_cls, engine_cls, make):
        self.b = broker_cls()
        self.eng = engine_cls(self.b)
        self.make = make
        self.sent = []
        self.outs = []
        self.b.on_deliver = self._deliver

    def _deliver(self, cid, pubs):
        for p in pubs:
            m = p.msg
            self.sent.append((cid, m.topic, m.payload, m.qos, m.retain,
                              m.sender))

    def recorder(self, rid):
        def act(out, cols):
            out = {k: v for k, v in out.items()
                   if k not in ("id", "timestamp", "publish_received_at")}
            self.outs.append((rid, json.dumps(out, sort_keys=True,
                                              default=repr)))
        return act


def _rules(side):
    rec = side.recorder
    return [
        ("r_temp", 'SELECT payload.temp as t, clientid FROM "sensors/+/temp" '
         "WHERE payload.temp > 30",
         [{"function": "republish",
           "args": {"topic": "alert/${clientid}", "payload": "hot ${t}",
                    "qos": 1}}, rec("r_temp")]),
        ("r_each", "FOREACH payload.sensors AS s DO s.name as name, "
         's.temp as temp INCASE s.temp > 30 FROM "sensors/#"',
         [rec("r_each")]),
        ("r_case", "SELECT case when payload.temp > 30 then 'hot' else "
         "'cold' end as lvl, upper(topic) as up, payload.s like 'he%' as lk "
         'FROM "sensors/#", "other/+"',
         [rec("r_case"), "kafka:k1", 42, {"function": "console"}]),
        ("r_fail", 'SELECT nth(1, payload.temp) as z FROM "sensors/#"',
         [rec("r_fail")]),
        ("loop", 'SELECT * FROM "x/#"',
         [{"function": "republish",
           "args": {"topic": "x/again", "payload": "p"}}, rec("loop")]),
        ("ping", 'SELECT topic FROM "ping/#"',
         [{"function": "republish", "args": {"topic": "pong/1"}},
          rec("ping")]),
        ("pong", 'SELECT topic FROM "pong/#"',
         [{"function": "republish", "args": {"topic": "ping/1"}},
          rec("pong")]),
        ("q_tpl", 'SELECT payload.xs as xs, qos FROM "other/+"',
         [{"function": "republish",
           "args": {"topic": "alert/q", "payload": "${xs}",
                    "qos": "${qos}"}}, rec("q_tpl")]),
        ("ev_sub", 'SELECT clientid, topic, qos FROM '
         '"$events/session_subscribed"', [rec("ev_sub")]),
        ("ev_unsub", 'SELECT clientid, topic FROM '
         '"$events/session_unsubscribed"', [rec("ev_unsub")]),
        ("ev_conn", 'SELECT clientid, username, event FROM '
         '"$events/client_connected"', [rec("ev_conn")]),
        ("ev_disc", 'SELECT clientid, reason FROM '
         '"$events/client_disconnected"', [rec("ev_disc")]),
        ("ev_deliv", 'SELECT clientid, from_clientid, topic FROM '
         '"$events/message_delivered"', [rec("ev_deliv")]),
        ("ev_ack", 'SELECT clientid, topic FROM "$events/message_acked"',
         [rec("ev_ack")]),
        ("ev_drop", 'SELECT topic, reason FROM "$events/message_dropped"',
         [rec("ev_drop")]),
    ]


def _publishes(seed, n):
    rng = random.Random(seed)
    topics = ["sensors/k1/temp", "sensors/k2/temp", "sensors/k/hum",
              "other/q", "x/start", "ping/0", "zzz/none", "sensors/a/b/c"]
    return [(f"p{rng.randint(0, 2)}", rng.choice(topics),
             seeded_payload(rng), rng.randint(0, 1)) for _ in range(n)]


LAZY = ("message.delivered", "message.acked", "message.dropped")


async def _publish(side, ms, sender, topic, payload, qos):
    if ms is not None:
        await ms.prefetch(topic)
    side.b.publish(side.make(sender, topic, payload, qos=qos))


async def _settle(ms, b):
    if ms is None:
        return
    for _ in range(3000):
        if ms.ready and ms._synced_epoch == b.router.epoch and \
                ms._synced_rule_gen == ms._rule_gen:
            return
        await asyncio.sleep(0.005)
    raise AssertionError("the match service never synced")


async def engine_script(side, ms=None, seed=0):
    """The script; returns (transcript, per-step notes)."""
    b, eng = side.b, side.eng
    taps = []
    b.open_session("sink")
    b.subscribe("sink", "alert/#")
    b.open_session("s2")
    b.subscribe("s2", "sensors/#")
    b.subscribe("s2", "ping/#")
    for rid, sql, actions in _rules(side):
        if rid.startswith("ev_"):
            continue
        eng.create_rule(rid, sql, actions=actions)
    taps.append([b.hooks.callbacks(p) for p in LAZY])
    await _settle(ms, b)
    for pub in _publishes(seed, 25):
        await _publish(side, ms, *pub)
    for rid, sql, actions in _rules(side):
        if rid.startswith("ev_"):
            eng.create_rule(rid, sql, actions=actions)
    taps.append([b.hooks.callbacks(p) for p in LAZY])
    b.hooks.run("client.connected", ("c7", {"username": "u7"}))
    b.open_session("c7")
    b.subscribe("c7", "sensors/+/temp")
    await _settle(ms, b)
    eng.set_enable("r_temp", False)
    await _settle(ms, b)
    for pub in _publishes(seed + 1, 15):
        await _publish(side, ms, *pub)
    msg = side.make("p0", "sensors/k1/temp", b'{"temp": 1}', qos=1)
    b.hooks.run("message.acked", ("c7", msg))
    eng.set_enable("r_temp", True)
    eng.delete_rule("r_case")
    b.unsubscribe("c7", "sensors/+/temp")
    b.hooks.run("client.disconnected", ("c7", "normal"))
    await _settle(ms, b)
    for pub in _publishes(seed + 2, 15):
        await _publish(side, ms, *pub)
    for rid in ("ev_deliv", "ev_ack", "ev_drop"):
        eng.delete_rule(rid)
    taps.append([b.hooks.callbacks(p) for p in LAZY])
    await _settle(ms, b)
    for pub in _publishes(seed + 3, 10):
        await _publish(side, ms, *pub)
    metrics = {rid: dict(r.metrics) for rid, r in eng.rules.items()}
    return {"outs": side.outs, "sent": side.sent, "metrics": metrics,
            "taps": taps, "epoch": eng.epoch, "rules": sorted(eng.rules)}


def ref_side():
    return Side(RefBroker, RefEngine, ref_make_message)


def port_side():
    return Side(Broker, RuleEngine, make_message)


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_script_equals_the_reference(seed):
    want = asyncio.run(engine_script(ref_side(), seed=seed))
    got = asyncio.run(engine_script(port_side(), seed=seed))
    assert got == want
    m = want["metrics"]
    # the script reached what it means to reach, on both sides
    assert m["loop"]["matched"] >= 1 and m["ping"]["matched"] >= 2
    assert m["r_fail"]["failed"] >= 1 and m["r_temp"]["no_result"] >= 1
    assert m["r_each"]["passed"] >= 1
    assert want["taps"][0] == [[], [], []]
    assert want["taps"][1] == [["rule_engine.delivered"],
                               ["rule_engine.acked"],
                               ["rule_engine.dropped"]]
    assert want["taps"][2] == [[], [], []]
    assert any(s[0] == "sink" for s in want["sent"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_rule_trie_equals_the_reference(seed):
    """With no hint, the port finds a publish's rules in a trie of the
    rule filters, the reference by ``T.match`` per rule: over a seeded
    set of overlapping filters (shared across rules, two FROMs, ``$``
    topics, rules disabled and deleted between rounds) both run the same
    rules in the same order."""
    rng = random.Random(seed)
    levels = ["a", "b", "$s", "", "+"]

    def flt():
        ws = [rng.choice(levels) for _ in range(rng.randint(1, 3))]
        return "/".join(ws + ["#"] * (rng.random() < 0.3)) or "#"

    rules = []
    for i in range(60):
        froms = ", ".join(f'"{flt()}"' for _ in range(rng.randint(1, 2)))
        rules.append((f"r{i}", f"SELECT topic FROM {froms}"))
    topics = ["/".join(rng.choice(["a", "b", "$s", "c", ""])
                       for _ in range(rng.randint(1, 4))) or "c"
              for _ in range(150)]
    runs = []
    for side in (ref_side(), port_side()):
        for rid, sql in rules:
            side.eng.create_rule(rid, sql, actions=[side.recorder(rid)])
        for rnd in range(2):
            for t in topics:
                side.b.publish(side.make("c", t, b"{}"))
            side.eng.set_enable(f"r{rnd}", False)
            side.eng.delete_rule(f"r{rnd + 10}")
        runs.append((side.outs, {rid: dict(r.metrics)
                                 for rid, r in side.eng.rules.items()}))
    assert runs[1] == runs[0]
    assert len(runs[0][0]) > 1000


def test_bridge_actions_fail_without_a_bridge():
    """Intended divergence of the port's node: it has no bridges, so a
    ``"<type>:<name>"`` action fails as it does on a reference engine
    with no bridge resolver; a resolver that knows the action makes it
    succeed on both."""
    counts = []
    for side in (ref_side(), port_side()):
        side.eng.create_rule("r", 'SELECT topic FROM "t/#"',
                             actions=["kafka:k1"])
        side.b.publish(side.make("c", "t/1", b"{}"))
        failed = side.eng.rules["r"].metrics["actions.failed"]
        assert side.eng.bridge_resolver is None
        side.eng.bridge_resolver = {"kafka:k1": lambda o, c: None}.get
        side.b.publish(side.make("c", "t/1", b"{}"))
        counts.append((failed, dict(side.eng.rules["r"].metrics)))
    assert counts[0] == counts[1]
    assert counts[1][0] == 1 and counts[1][1]["actions.success"] == 1


def _hint_counter(ms):
    seen = {"served": 0, "none": 0}
    inner = ms.hint_rules

    def counted(topic):
        ids = inner(topic)
        seen["served" if ids is not None else "none"] += 1
        return ids
    ms.hint_rules = counted
    return seen


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_script_with_the_match_service_equals_the_reference(seed):
    """The port's engine attached to the port's ``MatchService`` on the
    CPU: the publishes' rule ids come from ``hint_rules`` (the walk's
    co-batched answer), and everything equals the reference's engine
    matching its rules on the host."""
    want = asyncio.run(engine_script(ref_side(), seed=seed))

    async def port_run():
        side = port_side()
        ms = MatchService(side.b, Metrics(), device="cpu", bypass_rate=0,
                          debounce_s=0.0, prefetch_timeout_s=30)
        seen = _hint_counter(ms)
        await ms.start()
        try:
            side.b.device_match = ms.hint_routes
            side.eng.attach_match_service(ms)
            out = await engine_script(side, ms=ms, seed=seed)
            return out, seen, ms
        finally:
            await ms.stop()
            gc.unfreeze()

    got, seen, ms = asyncio.run(port_run())
    assert got == want
    assert seen["served"] >= 40, seen
    assert not ms._rule_refs.keys() - {
        "r_temp", "r_each", "r_fail", "loop", "ping", "pong", "q_tpl"}


def test_attach_registers_enabled_publish_rules_only():
    """``attach_match_service`` co-batches the enabled rules with a
    publish FROM filter; disabling or deleting one unregisters it; a
    failed registration logs and leaves host matching."""
    side = port_side()
    eng = side.eng
    eng.create_rule("a", 'SELECT * FROM "a/+", "$events/client_connected"')
    eng.create_rule("b", 'SELECT * FROM "b/#"', enable=False)
    eng.create_rule("e", 'SELECT * FROM "$events/message_acked"')
    calls = []

    class Recorder:
        def register_rule(self, rid, filters):
            calls.append(("reg", rid, list(filters)))
            if rid == "bad":
                raise RuntimeError("table full")

        def unregister_rule(self, rid):
            calls.append(("unreg", rid))

        def hint_rules(self, topic):
            return None

    eng.attach_match_service(Recorder())
    eng.set_enable("b", True)
    eng.set_enable("a", False)
    eng.delete_rule("e")
    eng.create_rule("bad", 'SELECT topic FROM "z/+"',
                    actions=[side.recorder("bad")])
    side.b.publish(side.make("c", "z/1", b"{}"))
    assert calls == [("reg", "a", ["a/+"]), ("unreg", "b"),
                     ("unreg", "e"), ("reg", "b", ["b/#"]),
                     ("unreg", "a"), ("unreg", "e"),
                     ("reg", "bad", ["z/+"])]
    assert eng.rules["bad"].metrics["matched"] == 1
    assert side.outs == [("bad", '{"topic": "z/1"}')]


def test_compile_table_cobatch_equals_the_reference():
    from emqx_tpu.ops import match_topics as ref_match_topics
    from emqx_tpu_torch.ops import match_topics

    rules = [("r1", 'SELECT * FROM "s/+/t"'),
             ("r2", 'SELECT * FROM "s/#", "other/x"'),
             ("off", 'SELECT * FROM "zzz/#"'), ("ev",
             'SELECT * FROM "$events/client_connected"')]
    got, want = [], []
    for eng, mt, out in ((RuleEngine(), match_topics, got),
                         (RefEngine(), ref_match_topics, want)):
        for rid, sql in rules:
            eng.create_rule(rid, sql, actions=[])
        eng.set_enable("off", False)
        table, by_filter = eng.compile_table()
        kw = {"device": "cpu"} if mt is match_topics else {}
        rows = mt(table, ["s/1/t", "s/9", "other/x", "zzz/q", "q"], **kw)
        out.append((by_filter, rows, table.accept_filters,
                    table.node_tab.tolist(), table.edge_tab.tolist()))
    assert got == want
    assert RuleEngine().compile_table() == (None, {})


def test_hinted_rules_run_in_the_reference_order():
    """With a hint the port visits only the hinted rules, in the order
    of the rule map: re-creating an id keeps its place, deleting and
    creating it again moves it last, and hinted ids of deleted or
    disabled rules are skipped, as the reference's full pass does."""
    class Hints:
        def __init__(self, eng):
            self.eng = eng

        def register_rule(self, rid, filters):
            pass

        def unregister_rule(self, rid):
            pass

        def hint_rules(self, topic):
            # every rule id once, newest first, and one that never was
            return ["ghost"] + list(reversed(list(self.eng.rules)))

    orders = []
    for side, hinted in ((ref_side(), False), (port_side(), True)):
        seen = []
        for rid in ("a", "b", "c", "d", "e"):
            side.eng.create_rule(
                rid, 'SELECT topic FROM "t/#"',
                actions=[lambda o, c, rid=rid: seen.append(rid)])
        side.eng.create_rule("b", 'SELECT topic FROM "t/+"',
                             actions=[lambda o, c: seen.append("b2")])
        side.eng.delete_rule("a")
        side.eng.create_rule("a", 'SELECT topic FROM "t/#"',
                             actions=[lambda o, c: seen.append("a2")])
        side.eng.set_enable("d", False)
        if hinted:
            side.eng.attach_match_service(Hints(side.eng))
        side.b.publish(side.make("p", "t/1", b"{}"))
        side.eng.apply_event("t/1", {"topic": "t/1"}, skip_rule="c")
        orders.append(seen)
    assert orders[1] == orders[0] == ["b2", "c", "e", "a2", "b2", "e", "a2"]
