"""The port's ``BrokerNode`` against the reference's, over real TCP.

Each node case of ``tests/test_match_service.py``, and the fanout's
node round trip of ``tests/test_fanout.py`` (fanout off and on), runs on
the reference's node (JAX on the CPU) and on the port's
(``device="cpu"``), both driven by the reference's MQTT client on
``127.0.0.1:0``.  A case returns a transcript (what each client received:
topic, payload, QoS and retain flag, in order; the hints and rule ids the
service answered; the ``tpu.match.*`` counters the reference case
asserts) and the two transcripts must be equal.  A counter whose value
depends on timing (how many batches a window caught) enters as the
reference case's predicate on it, not as its value.  Where a reference
case creates a rule, the port's side registers the rule's FROM filter
with its match service directly (``register_rule``, what the engine
does): these stay the service-level cases.  The rule engine itself runs
on both nodes in ``rules_and_access_control``: a rule created through
``node.rule_engine`` republishing to a subscriber, beside an
``auth_chain`` that refuses a bad password and an ACL that denies a
publish and a subscription; the intercept's async auth pre-resolution
runs on both nodes with an async authenticator and source.

A seeded script (connect, subscribe, retained and QoS 0/1/2 publishes,
``$delayed/`` publishes, unsubscribe, a ``clean_start=false`` resume)
gives equal decoded packets to each client on both nodes; the port's
client drives the reference's node as the reference's client does; the
port's node on ``cuda`` raises at start where there is no card; a key
of an unported subsystem set away from its default raises at
construction; ``stop()`` leaves no task and no open socket.
"""

import array
import asyncio
import dataclasses
import fcntl
import json
import random
import termios

import pytest
import torch

import emqx_tpu.auth as ref_auth
import emqx_tpu_torch.auth as port_auth
from emqx_tpu import topic as T
from emqx_tpu.broker.message import make_message as ref_make_message
from emqx_tpu.client import Client, MqttError
from emqx_tpu.config import Config as RefConfig
from emqx_tpu.node import BrokerNode as RefNode
from emqx_tpu_torch.broker.message import make_message as port_make_message
from emqx_tpu_torch.client import Client as PortClient
from emqx_tpu_torch.config import Config as PortConfig
from emqx_tpu_torch.node import UNPORTED_KEYS
from emqx_tpu_torch.node import BrokerNode as PortNode

REF, PORT = "ref", "port"


def run(coro):
    return asyncio.run(coro)


async def settle(pred, timeout=30.0, interval=0.02):
    deadline = asyncio.get_running_loop().time() + timeout
    while asyncio.get_running_loop().time() < deadline:
        if pred():
            return True
        await asyncio.sleep(interval)
    return pred()


#: the fanout on, with its load-dependent gates pinned off on both nodes:
#: the shape gate (a sender with nothing in custody goes the per-message
#: way unless a probe is due, 0.25 s apart) and the loop-lag probe of
#: overload protection (a lag past 0.5 s sheds QoS0 and defers retained
#: publishes).  Under a loaded machine either changes which path a
#: publish takes, so the PUBACK codes and the delivery order followed
#: the machine's load rather than the node
FANOUT_PINNED = {"broker.fanout.enable": True,
                 "broker.fanout.shape_routes": 0.0,
                 "overload_protection.lag_probe_interval": 0.0}


def make_node(side, tpu=True, auth=None, **extra):
    """A node of ``side`` as the reference cases make theirs; ``auth``
    is an ``(auth_chain, authz)`` pair of the side's package."""
    Config = RefConfig if side == REF else PortConfig
    cfg = Config(file_text='listeners.tcp.default.bind = "127.0.0.1:0"\n')
    cfg.put("tpu.enable", tpu)  # the env layer disables it for the suite
    cfg.put("tpu.mirror_refresh_interval", 0.01)
    cfg.put("tpu.bypass_rate", 0.0)  # pin the device path on for tests
    for k, v in extra.items():
        cfg.put(k, v)
    chain, authz = auth or (None, None)
    if side == REF:
        return RefNode(cfg, auth_chain=chain, authz=authz)
    return PortNode(cfg, chain, authz, device="cpu")


def sub(b, cid, flt):
    if cid not in b.sessions:
        b.open_session(cid)
    b.subscribe(cid, flt)


def _unread(transport) -> int:
    """Bytes that arrived on ``transport``'s socket and were not read."""
    sock = transport.get_extra_info("socket") if transport else None
    if sock is None or sock.fileno() < 0:
        return 0
    n = array.array("i", [0])
    fcntl.ioctl(sock.fileno(), termios.FIONREAD, n)
    return n[0]


def _transport(obj):
    """The asyncio transport under a connection, a stream writer or a
    protocol, or None."""
    for attr in ("transport", "stream", "_writer", "writer"):
        t = getattr(obj, attr, None)
        t = getattr(t, "transport", t)
        if t is not None and hasattr(t, "get_write_buffer_size"):
            return t
    return None


def _flushed(obj) -> bool:
    """Nothing of ``obj`` (a node's connection or a client) waits to be
    written or read: its output queues and write buffers are empty and
    its socket holds no unread byte."""
    q = getattr(obj, "_outq", None)
    if q is not None and not q.empty():
        return False
    if getattr(obj, "_pending_out", None) or getattr(obj, "_wbuf", None):
        return False
    t = _transport(obj)
    if t is None or t.is_closing():
        return True
    return not t.get_write_buffer_size() and not _unread(t)


def _node_idle(node):
    """Nothing of the node's in flight: no fanout offer queued, deferred
    or mid-batch, no prefetch waiting for a batch, no delivery to a
    connected client awaiting its ack."""
    fp, ms = node.fanout_pipeline, node.match_service
    if fp is not None and (fp._q or fp._deferred or fp._busy):
        return False
    if ms is not None and ms._pending:
        return False
    return all(not len(s.inflight) for s in node.broker.sessions.values()
               if s.connected)


async def drained(node, clients, timeout=10.0):
    """Wait until the node and ``clients`` are at rest: the node idle
    (:func:`_node_idle`), every connection of the node and every client
    with nothing queued, buffered or unread, on three checks in a row a
    loop turn apart (bytes between two sockets show as unread on one of
    them).  A bounded wait: the condition, not a settle time."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    calm = 0
    while calm < 3:
        await asyncio.sleep(0.001)
        at_rest = _node_idle(node) and all(
            _flushed(c) for c in list(node.connections.values())
            + list(clients))
        calm = calm + 1 if at_rest else 0
        assert loop.time() < deadline, "the node did not come to rest"


def ms_synced(node):
    ms = node.match_service
    return (
        ms is not None and ms.ready
        and ms._seen_epoch == node.broker.router.epoch
        and ms.dev.epoch == ms.inc.epoch
    )


def make_message(side, *a, **kw):
    return (ref_make_message if side == REF else port_make_message)(*a, **kw)


def add_rule(side, node, rid, flt, hits=None):
    """A rule selecting ``flt``: the rule engine on the reference's node
    (appending each firing's topic to ``hits``), the match service's rule
    co-batching on the port's."""
    if side == REF:
        actions = ([lambda out, cols: hits.append(out["topic"])]
                   if hits is not None else [])
        node.rule_engine.create_rule(
            rid, f'SELECT topic FROM "{flt}"', actions=actions)
    else:
        node.match_service.register_rule(rid, [flt])


def del_rule(side, node, rid):
    if side == REF:
        node.rule_engine.delete_rule(rid)
    else:
        node.match_service.unregister_rule(rid)


def routes(rs):
    return None if rs is None else sorted(map(tuple, rs))


def received(client):
    out = []
    while not client.messages.empty():
        m = client.messages.get_nowait()
        out.append((m.topic, m.payload, m.qos, m.retain))
    return out


def play(case, **kw):
    """Run ``case`` on a fresh node of each side; the transcripts must be
    equal."""
    want = run(case(REF, **kw))
    got = run(case(PORT, **kw))
    assert got == want
    return want


# -- the node cases of tests/test_match_service.py ---------------------------

async def publish_storm(side):
    node = make_node(side)
    await node.start()
    port = node.listeners.all()[0].port
    try:
        subs, filters = [], []
        for i in range(6):
            c = Client(clientid=f"s{i}", port=port)
            await c.connect()
            flt = f"room/+/kind{i % 3}"
            await c.subscribe(flt, qos=0)
            subs.append(c)
            filters.append(flt)
        assert await settle(lambda: ms_synced(node))
        pub = Client(clientid="p", port=port)
        await pub.connect()
        topics = [f"room/{i}/kind{i % 3}" for i in range(30)]
        for t in topics:
            await pub.publish(t, b"x", qos=0)
        want = sum(1 for t in topics for f in filters if T.match(t, f))
        assert await settle(
            lambda: sum(s.messages.qsize() for s in subs) >= want)
        await drained(node, subs + [pub])   # nothing more arrives
        m = node.observed.metrics
        out = [received(s) for s in subs] + [
            m.get("tpu.match.batches") >= 1,
            m.get("tpu.match.topics") >= len(topics),
            m.get("tpu.mirror.refresh") >= 1]
        for s in subs:
            await s.disconnect()
        await pub.disconnect()
        return out
    finally:
        await node.stop()


async def scoped_hint_invalidation(side):
    node = make_node(side)
    await node.start()
    try:
        b, ms = node.broker, node.match_service
        out = []
        sub(b, "c1", "a/+")
        assert await settle(lambda: ms_synced(node))
        await ms.prefetch("a/x")
        out.append(routes(ms.hint_routes("a/x")))
        sub(b, "c2", "a/x")         # exact add: the hint survives
        out.append(routes(ms.hint_routes("a/x")))
        out.append(routes(b.router.match_routes("a/x")))
        sub(b, "c3", "zzz/+")       # unrelated wildcard: survives
        out.append(routes(ms.hint_routes("a/x")))
        b.unsubscribe("c2", "a/x")  # delete: survives, route drops out
        out.append(routes(ms.hint_routes("a/x")))
        sub(b, "c4", "a/#")         # matching wildcard add: stale
        out.append(routes(ms.hint_routes("a/x")))
        out.append(node.observed.metrics.get("tpu.match.hint_stale"))
        assert await settle(lambda: ms_synced(node))
        await ms.prefetch("a/x")
        out.append(routes(ms.hint_routes("a/x")))
        return out
    finally:
        await node.stop()


async def churn_keeps_device_duty_cycle(side):
    node = make_node(side)
    await node.start()
    try:
        b, ms = node.broker, node.match_service
        for i in range(8):
            sub(b, f"s{i}", f"room/+/k{i}")
        assert await settle(lambda: ms_synced(node))
        m = node.observed.metrics
        topics = [f"room/{i}/k{i % 8}" for i in range(16)]
        served = total = 0
        used = []
        for round_ in range(12):
            sub(b, "churn", f"churnspace/{round_}/+")
            if round_ > 0:
                b.unsubscribe("churn", f"churnspace/{round_ - 1}/+")
            for t in topics:
                await ms.prefetch(t)
                total += 1
                hint = ms.hint_routes(t)
                want = routes(b.router.match_routes(t))
                if hint is not None:
                    served += 1
                    assert routes(hint) == want, t
                used.append(want)
            await asyncio.sleep(0.005)
        return [used, served / total > 0.5,
                m.get("tpu.match.hint_served") >= served]
    finally:
        await node.stop()


async def adaptive_bypass_low_concurrency(side):
    node = make_node(side, **{"tpu.bypass_rate": 1e9})
    await node.start()
    try:
        b, ms = node.broker, node.match_service
        sub(b, "c1", "a/+")
        assert await settle(lambda: ms_synced(node))
        await ms.prefetch("a/x")
        res = b.publish(make_message(side, "p", "a/x", b"!"))
        return [node.observed.metrics.get("tpu.match.bypass"),
                ms.hint_routes("a/x"), res.matched]
    finally:
        await node.stop()


async def hint_routes_match_host_routes(side):
    node = make_node(side)
    await node.start()
    try:
        b, ms = node.broker, node.match_service
        flts = ["s/+/t", "s/#", "exact/topic", "+/b", "deep/a/b/c/d/e/f/+/x"]
        for i, f in enumerate(flts):
            sub(b, f"c{i}", f)
        assert await settle(lambda: ms_synced(node))
        out = []
        for topic in ["s/1/t", "s/9", "exact/topic", "q/b", "none",
                      "deep/a/b/c/d/e/f/q/x"]:
            await ms.prefetch(topic)
            hint = routes(ms.hint_routes(topic))
            assert hint == routes(b.router.match_routes(topic)), topic
            out.append(hint)
        return out
    finally:
        await node.stop()


async def rule_cobatch_selected_by_hint(side):
    node = make_node(side)
    await node.start()
    try:
        b, ms = node.broker, node.match_service
        hits = []
        add_rule(side, node, "r1", "evt/+/fire", hits)
        add_rule(side, node, "r2", "other/#")
        sub(b, "c1", "evt/#")
        assert await settle(lambda: ms_synced(node))
        await ms.prefetch("evt/z1/fire")
        out = [ms.hint_rules("evt/z1/fire")]
        b.publish(make_message(side, "c9", "evt/z1/fire", b"!"))
        del_rule(side, node, "r1")
        assert await settle(lambda: ms_synced(node))
        await ms.prefetch("evt/z1/fire")
        out.append(ms.hint_rules("evt/z1/fire"))
        b.publish(make_message(side, "c9", "evt/z1/fire", b"!"))
        if side == REF:
            assert hits == ["evt/z1/fire"]   # r1 fired once, never again
        return out
    finally:
        await node.stop()


async def bootstrap_refcounts_multiple_dests(side):
    node = make_node(side)
    b = node.broker
    sub(b, "c1", "m/+")
    sub(b, "c2", "m/+")
    await node.start()  # the bootstrap sees 2 routes for m/+
    try:
        ms = node.match_service
        assert await settle(lambda: ms_synced(node))
        b.unsubscribe("c1", "m/+")
        assert await settle(lambda: ms_synced(node))
        await ms.prefetch("m/1")
        return [ms.inc.n_filters, routes(ms.hint_routes("m/1"))]
    finally:
        await node.stop()


async def rule_registration_invalidates_hints(side):
    node = make_node(side)
    await node.start()
    try:
        b, ms = node.broker, node.match_service
        sub(b, "c1", "evt/#")
        assert await settle(lambda: ms_synced(node))
        await ms.prefetch("evt/x")
        out = [ms.hint_rules("evt/x")]
        hits = []
        add_rule(side, node, "r1", "evt/+", hits)
        out.append(ms.hint_rules("evt/x"))   # stale in the rules dimension
        b.publish(make_message(side, "p", "evt/x", b"!"))
        if side == REF:
            assert hits == ["evt/x"]
        return out
    finally:
        await node.stop()


async def unsubscribe_prunes_mirror(side):
    node = make_node(side)
    await node.start()
    try:
        b, ms = node.broker, node.match_service
        sub(b, "c1", "x/+")
        assert await settle(lambda: ms_synced(node))
        out = [ms.inc.n_filters]
        b.unsubscribe("c1", "x/+")
        assert await settle(
            lambda: ms_synced(node) and ms.inc.n_filters == 0)
        return out + [ms.inc.n_filters]
    finally:
        await node.stop()


async def table_kind_selection_and_python_parity(side):
    node_native = make_node(side)
    await node_native.start()
    try:
        out = [node_native.match_service.table_kind]
    finally:
        await node_native.stop()
    node_py = make_node(side, **{"tpu.table": "python"})
    await node_py.start()
    try:
        ms = node_py.match_service
        out.append(ms.table_kind)
        port = node_py.listeners.all()[0].port
        s = Client(clientid="s", port=port)
        await s.connect()
        await s.subscribe("k/+/x")
        await settle(lambda: ms.dev.epoch == ms.inc.epoch)
        p = Client(clientid="p", port=port)
        await p.connect()
        await p.publish("k/1/x", b"v")
        got = await s.recv(timeout=5)
        out.append((got.topic, got.payload))
        await p.disconnect()
        await s.disconnect()
        return out
    finally:
        await node_py.stop()


async def depth_bucketed_batch_parity(side):
    node = make_node(side, **{"tpu.split_min": 1, "tpu.batch_size": 512})
    await node.start()
    try:
        ms = node.match_service
        port = node.listeners.all()[0].port
        s = Client(clientid="s", port=port)
        await s.connect()
        flts = ("a/+", "a/+/c/+/e", "deep/+/x/+/z/+/q", "#")
        for flt in flts:
            await s.subscribe(flt)
        assert await settle(lambda: ms_synced(node), timeout=120)
        topics = ["a/b", "a/b/c/d/e", "deep/1/x/2/z/3/q", "nah", "a/q",
                  "deep/only"]
        # one batch through the serve loop directly, as the reference
        # case pushes it
        loop = asyncio.get_running_loop()
        futs = []
        for t in topics:
            f = loop.create_future()
            futs.append(f)
            ms._pending.append((t, f))
        ms._batch_wake.set()
        assert await settle(lambda: all(f.done() for f in futs),
                            timeout=180)
        out = [sorted(ms._hints[t][2]) if t in ms._hints else None
               for t in topics]
        for t, got in zip(topics, out):
            assert got == sorted(f for f in flts if T.match(t, f)), t
        out.append(node.observed.metrics.get("tpu.match.batches") >= 2)
        await s.disconnect()
        return out
    finally:
        await node.stop()


async def hint_cache_lru_eviction_no_thrash(side):
    node = make_node(side)
    await node.start()
    try:
        b, ms = node.broker, node.match_service
        ms.hint_cap = 24  # a scaled-down 64k working set
        sub(b, "s", "room/+/k")
        assert await settle(lambda: ms_synced(node))
        hot = [f"room/h{i}/k" for i in range(8)]
        for t in hot:
            await ms.prefetch(t)
        first = [routes(ms.hint_routes(t)) for t in hot]
        served_hot = total_hot = 0
        sizes = []
        for round_ in range(6):
            cold = [f"room/c{round_}_{i}/k" for i in range(20)]
            for ci, t in enumerate(cold):
                await ms.prefetch(t)
                if ci % 4 == 3:
                    for h in hot:
                        total_hot += 1
                        served_hot += ms.hint_routes(h) is not None
            sizes.append(len(ms._hints))
        return [first, sizes, served_hot / total_hot > 0.9,
                node.observed.metrics.get("tpu.match.hint_evicted") >= 1]
    finally:
        await node.stop()


async def rules_only_hot_set_survives_lru_eviction(side):
    node = make_node(side)
    await node.start()
    try:
        b, ms = node.broker, node.match_service
        ms.hint_cap = 24
        add_rule(side, node, "r1", "room/+/k")
        # a subscription on another branch keeps the table non-empty
        # without routing the hot topics
        sub(b, "s", "other/+")
        assert await settle(lambda: ms_synced(node))
        hot = [f"room/h{i}/k" for i in range(8)]
        for t in hot:
            await ms.prefetch(t)
        first = [ms.hint_rules(t) for t in hot]
        served_hot = total_hot = 0
        sizes = []
        for round_ in range(6):
            cold = [f"room/c{round_}_{i}/k" for i in range(20)]
            for ci, t in enumerate(cold):
                await ms.prefetch(t)
                if ci % 4 == 3:
                    for h in hot:
                        total_hot += 1
                        served_hot += ms.hint_rules(h) is not None
            sizes.append(len(ms._hints))
        return [first, sizes, served_hot / total_hot > 0.9]
    finally:
        await node.stop()


NODE_CASES = [publish_storm, scoped_hint_invalidation,
              churn_keeps_device_duty_cycle, adaptive_bypass_low_concurrency,
              hint_routes_match_host_routes, rule_cobatch_selected_by_hint,
              bootstrap_refcounts_multiple_dests,
              rule_registration_invalidates_hints, unsubscribe_prunes_mirror,
              table_kind_selection_and_python_parity,
              depth_bucketed_batch_parity, hint_cache_lru_eviction_no_thrash,
              rules_only_hot_set_survives_lru_eviction]


@pytest.mark.parametrize("case", NODE_CASES, ids=lambda c: c.__name__)
def test_node_case_equals_the_reference(case):
    out = play(case)
    # the reference case's own predicates hold (they are in the
    # transcript, equal on both sides)
    assert all(x is not False for x in out)


# -- tests/test_fanout.py's node round trip ------------------------------------

async def e2e_roundtrip(side, fanout_on):
    Config = RefConfig if side == REF else PortConfig
    cfg = Config(file_text=(
        'listeners.tcp.default.bind = "127.0.0.1:0"\n'
        + ('broker.fanout.enable = true\n' if fanout_on else '')))
    cfg.put("tpu.enable", False)
    node = RefNode(cfg) if side == REF else PortNode(cfg, device="cpu")
    await node.start()
    try:
        out = [node.fanout_pipeline is not None]
        port = node.listeners.all()[0].port
        s = Client(clientid="sub", port=port)
        p = Client(clientid="pub", port=port)
        await s.connect()
        await p.connect()
        await s.subscribe("a/#", qos=1)
        for i in range(20):
            await p.publish("a/b", str(i).encode(), qos=1)
        got = [await s.recv(timeout=5) for _ in range(20)]
        out.append([(g.topic, g.payload, g.qos) for g in got])
        await s.disconnect()
        await p.disconnect()
        return out
    finally:
        await node.stop()


@pytest.mark.parametrize("fanout_on", [False, True])
def test_node_e2e_roundtrip_equals_the_reference(fanout_on):
    out = play(e2e_roundtrip, fanout_on=fanout_on)
    assert out[0] is fanout_on
    assert [int(g[1]) for g in out[1]] == list(range(20))


# -- the rule engine and access control over TCP -------------------------------

def access(side, allow_anonymous=False, no_match="allow"):
    """A builtin-DB chain (alice, bob) and an ACL that denies publishes
    under ``denied/``, of the side's package."""
    A = ref_auth if side == REF else port_auth
    db = A.BuiltinDbAuthenticator()
    db.add_user("alice", b"pw", salt=b"s1")
    db.add_user("bob", b"pw2", salt=b"s2", is_superuser=True)
    chain = A.AuthChain(allow_anonymous=allow_anonymous).add(db)
    authz = A.Authz([A.FileSource([
        A.AclRule("deny", "publish", ["denied/#"]),
        A.AclRule("deny", "subscribe", ["secret/#"]),
        A.AclRule("allow", "all", ["#"])])], no_match=no_match)
    return chain, authz


async def rules_and_access_control(side, fanout_on=False):
    """A rule created through ``node.rule_engine`` republishing to a
    subscriber; a bad password refused at CONNECT; an ACL denying a
    publish and a subscription; the rule's metrics and outputs."""
    extra = FANOUT_PINNED if fanout_on else {}
    node = make_node(side, auth=access(side), **extra)
    await node.start()
    port = node.listeners.all()[0].port
    hits = []
    try:
        node.rule_engine.create_rule(
            "hot", 'SELECT payload.temp as t, clientid FROM '
            '"sensors/+/temp" WHERE payload.temp > 30',
            actions=[{"function": "republish",
                      "args": {"topic": "alert/${clientid}",
                               "payload": "hot ${t}", "qos": 1}},
                     lambda out, cols: hits.append(sorted(out.items()))])
        node.rule_engine.create_rule(
            "bridge", 'SELECT topic FROM "sensors/#"', actions=["kafka:k"])
        out = []
        bad = Client(clientid="bad", port=port, username="alice",
                     password=b"nope")
        try:
            await bad.connect()
            out.append("connected")
        except MqttError as e:
            out.append(str(e))
        sink = Client(clientid="sink", port=port, username="alice",
                      password=b"pw", proto_ver=5)
        await sink.connect()
        out.append(await sink.subscribe([("alert/#", 1), ("secret/x", 0)]))
        assert await settle(lambda: ms_synced(node))
        pub = Client(clientid="pub", port=port, username="alice",
                     password=b"pw", proto_ver=5)
        root = Client(clientid="root", port=port, username="bob",
                      password=b"pw2", proto_ver=5)
        await pub.connect()
        await root.connect()
        for cl, topic, temp in ((pub, "sensors/k1/temp", 35),
                                (pub, "sensors/k2/temp", 5),
                                (pub, "denied/x", 50),
                                (root, "denied/y", 50),
                                (pub, "sensors/k3/temp", 41)):
            out.append(await cl.publish(
                topic, json.dumps({"temp": temp}).encode(), qos=1))
        assert await settle(lambda: sink.messages.qsize() >= 2)
        await drained(node, [sink, pub, root])   # nothing more arrives
        out.append(received(sink))
        out.append(hits)
        out.append({rid: dict(r.metrics)
                    for rid, r in node.rule_engine.rules.items()})
        info = node.info()
        out.append((info["rules"], info["auth"]["attached"]))
        out.append(node.observed.metrics.get("tpu.match.hint_served") >= 1)
        for cl in (sink, pub, root):
            await cl.disconnect()
        return out
    finally:
        await node.stop()


@pytest.mark.parametrize("fanout_on", [False, True])
def test_rules_and_access_control_equal_the_reference(fanout_on):
    out = play(rules_and_access_control, fanout_on=fanout_on)
    # the fanout acks at the offer, before the match
    ok = 0 if fanout_on else 0x10       # success / no matching subscribers
    not_authorized = 0x87
    assert out[0] == "CONNACK refused rc=4"    # 3.1.1: bad user or password
    assert out[1] == [1, not_authorized]
    assert out[2:7] == [ok, ok, not_authorized, ok, ok]
    assert [m[0] for m in out[7]] == ["alert/pub", "alert/pub"]
    assert out[9]["hot"]["passed"] == 2 and out[9]["hot"]["no_result"] == 1
    assert out[9]["bridge"]["actions.failed"] == 3
    assert out[10] == (2, True) and out[11] is True


def test_rules_ride_the_match_service_hints():
    """On the port's node the rule engine is attached to the started
    service: its publish rules sit in the walk's table, and a publish's
    rule selection comes from ``hint_rules``."""
    async def main():
        node = make_node(PORT)
        await node.start()
        try:
            ms = node.match_service
            assert node.rule_engine._match_service is ms
            node.rule_engine.create_rule("r", 'SELECT topic FROM "k/+"')
            served = []
            inner = ms.hint_rules

            def counted(topic):
                ids = inner(topic)
                served.append(ids)
                return ids
            ms.hint_rules = counted
            sub(node.broker, "c", "k/#")
            assert await settle(lambda: ms_synced(node)
                                and ms._synced_rule_gen == ms._rule_gen)
            await ms.prefetch("k/1")
            node.broker.publish(port_make_message("p", "k/1", b"{}"))
            assert served == [["r"]]
            assert node.rule_engine.rules["r"].metrics["matched"] == 1
            assert ms._rule_refs == {"r": {"k/+": 1}}
            node.rule_engine.set_enable("r", False)
            assert ms._rule_refs == {}
        finally:
            await node.stop()

    run(main())


def test_auth_keys_are_honoured():
    """The ``authn.*`` / ``authz.*`` keys no longer raise: a node built
    with them and no chain has no access control (as the reference's),
    and ``ensure_access_control`` builds one from them."""
    for side in (REF, PORT):
        node = make_node(side, tpu=False, **{
            "authn.allow_anonymous": False, "authz.no_match": "deny"})
        assert node.access_control is None
        ac = node.ensure_access_control()
        assert ac is node.ensure_access_control()
        assert ac.chain.allow_anonymous is False
        assert ac.authz.no_match == "deny"
        assert sorted(node.broker.hooks.callbacks("client.authorize")) == \
            ["authz.sources"]
        assert not node._wants_intercept()


def test_async_auth_pre_resolution_runs_in_the_intercept():
    """No ported backend is async, but the intercept's pre-resolution
    step is there: a backend with ``authenticate_async`` and a source
    with ``prefetch_async`` are awaited before the sync folds consume
    their parked verdicts, on both nodes alike."""
    def run_side(side):
        A = ref_auth if side == REF else port_auth
        calls = []

        class AsyncAuthn:
            def __init__(self):
                self.parked = {}

            async def authenticate_async(self, creds):
                calls.append(("authn", creds.clientid, creds.username))
                res = A.authn.AuthResult(
                    "ok" if creds.password == b"pw" else "deny")
                self.parked[creds.clientid] = res
                return res

            def authenticate(self, creds):
                return self.parked.pop(creds.clientid, A.authn.DENY)

        class AsyncSource:
            verdicts = {}

            async def prefetch_async(self, cid, user, peer, action, topic):
                calls.append(("authz", cid, action, topic))
                v = "deny" if topic.startswith("no/") else "allow"
                self.verdicts[(cid, action, topic)] = v
                return v

            def authorize(self, cid, user, peer, action, topic, **kw):
                return self.verdicts.pop((cid, action, topic), "nomatch")

        chain = A.AuthChain(allow_anonymous=False).add(AsyncAuthn())
        authz = A.Authz([AsyncSource()], no_match="deny",
                        cache_enable=False)

        async def main():
            node = make_node(side, tpu=False, auth=(chain, authz))
            assert node._wants_intercept()
            await node.start()
            port = node.listeners.all()[0].port
            try:
                out = []
                c = Client(clientid="c1", port=port, username="u",
                           password=b"pw", proto_ver=5)
                await c.connect()
                out.append(await c.subscribe([("ok/#", 1), ("no/#", 1)]))
                out.append(await c.publish("ok/1", b"x", qos=1))
                out.append(await c.publish("no/1", b"x", qos=1))
                got = await c.recv(timeout=5)
                out.append((got.topic, got.payload))
                bad = Client(clientid="c2", port=port, username="u",
                             password=b"no")
                try:
                    await bad.connect()
                except MqttError as e:
                    out.append(str(e))
                await c.disconnect()
                return out + [calls]
            finally:
                await node.stop()

        return run(main())

    want = run_side(REF)
    assert run_side(PORT) == want
    assert want[3] == ("ok/1", b"x") and want[4] == "CONNACK refused rc=4"


# -- a seeded script: decoded packets per client -------------------------------

def _norm(pkt):
    return (type(pkt).__name__, dataclasses.asdict(pkt))


def _recorder(cls):
    """``cls`` (a client class) recording every packet it receives."""

    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.inbound = []

        def _handle(self, pkt):
            self.inbound.append(_norm(pkt))
            super()._handle(pkt)

    return Recording


async def seeded_script(side, seed, fanout_on=False, client_cls=Client):
    rng = random.Random(seed)
    extra = FANOUT_PINNED if fanout_on else {}
    node = make_node(side, **extra)
    await node.start()
    port = node.listeners.all()[0].port
    C = _recorder(client_cls)
    try:
        a = C(clientid="A", port=port, proto_ver=5)
        b = C(clientid="B", port=port, proto_ver=4)
        c = C(clientid="C", port=port, proto_ver=5, clean_start=False,
              properties={"Session-Expiry-Interval": 300})
        clients = [a, b, c]
        for cl in clients:
            await cl.connect()
        await a.subscribe([("s/+/t", 2), ("r/#", 1)])
        await b.subscribe([("s/#", 0), ("d/+", 1)])
        await c.subscribe("s/1/t", qos=1)
        await settle(lambda: ms_synced(node))
        for i in range(3):      # retained, QoS 1, one a second retain
            await b.publish(f"r/k{i}", f"ret{i}".encode(), qos=1,
                            retain=True)
        await drained(node, clients)
        for i in range(12):     # a seeded QoS mix, topics and payloads
            qos = rng.randint(0, 2)
            topic = f"s/{rng.randint(0, 3)}/t"
            await a.publish(topic, bytes(rng.randrange(256)
                                         for _ in range(rng.randint(0, 8))),
                            qos=qos)
        await drained(node, clients)
        await b.publish("$delayed/1/d/x", b"later", qos=1)
        assert await settle(lambda: any(p[1].get("topic") == "d/x"
                                         for p in b.inbound), timeout=10)
        await c.disconnect()    # the session stays: clean_start false
        await settle(lambda: "C" not in node.connections)
        for i in range(3):      # queued for the offline C
            await a.publish("s/1/t", f"off{i}".encode(), qos=1)
        await drained(node, clients)
        c2 = C(clientid="C", port=port, proto_ver=5, clean_start=False,
               properties={"Session-Expiry-Interval": 300})
        await c2.connect()      # the resume: session present, the queue
        d = C(clientid="D", port=port, proto_ver=4)
        await d.connect()
        await d.subscribe("r/#", qos=2)     # the retained replay
        clients += [c2, d]
        await drained(node, clients)
        await a.unsubscribe("s/+/t")
        await b.publish("s/2/t", b"after-unsub", qos=1)
        await b.publish("r/k1", b"", qos=0, retain=True)   # clears it
        await drained(node, clients)
        for cl in (a, b, c2, d):
            await cl.disconnect()
        return {cl.clientid + ("2" if cl is c2 else ""): cl.inbound
                for cl in clients}
    finally:
        await node.stop()


def _streams(out):
    """Each client's packets as three streams: its deliveries (PUBLISH),
    the PUBRELs that answer its PUBRECs of QoS 2 deliveries, and the rest
    (the answers to its own packets).  With the fanout on, a drain
    batch's deliveries interleave with the answers to the client's own
    publishes as the batching window's timing falls, on either node; the
    order within each stream is fixed."""
    def kind(p):
        return ("Publish" if p[0] == "Publish" else
                "PubRel" if p[0] == "PubAck" and p[1]["type"] == 6 else "")
    return {cid: tuple([p for p in pkts if kind(p) == k]
                       for k in ("Publish", "PubRel", ""))
            for cid, pkts in out.items()}


@pytest.mark.parametrize("fanout_on", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_script_packets_equal_the_reference(seed, fanout_on):
    if fanout_on:
        want = _streams(run(seeded_script(REF, seed=seed, fanout_on=True)))
        got = _streams(run(seeded_script(PORT, seed=seed, fanout_on=True)))
        assert got == want
        out = {cid: sum(streams, []) for cid, streams in want.items()}
    else:
        out = play(seeded_script, seed=seed)
    connack = next(p for p in out["C2"] if p[0] == "Connack")
    assert connack[1]["session_present"] is True
    assert [p[1]["payload"] for p in out["C2"] if p[0] == "Publish"][:3] \
        == [b"off0", b"off1", b"off2"]
    assert any(p[1].get("retain") for p in out["D"])
    assert sum(p[0] == "Publish" for p in out["B"]) >= 10


def test_port_client_drives_the_reference_node():
    """The port's client on the reference's node receives what the
    reference's client does, packet for packet."""
    want = run(seeded_script(REF, seed=3, client_cls=Client))
    got = run(seeded_script(REF, seed=3, client_cls=PortClient))
    assert got == want


# -- the card, the unported keys, the stop -------------------------------------

def test_start_on_cuda_without_a_card_raises():
    """No host-trie fallback: where the reference logs and serves from
    the trie, the port's start raises and serves nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")

    async def main():
        cfg = PortConfig(
            file_text='listeners.tcp.default.bind = "127.0.0.1:0"\n')
        cfg.put("tpu.enable", True)
        node = PortNode(cfg, device="cuda")
        with pytest.raises((RuntimeError, AssertionError)):
            await node.start()
        assert node.match_service is None
        assert node.broker.device_match is None
        assert not node.listeners.all()[0].running
        await node.stop()

    run(main())


@pytest.mark.parametrize("key,value", [
    ("cluster.enable", True), ("dashboard.enable", True),
    ("listeners.ws.default.enable", True), ("broker.conn.shards", 2),
    ("admission.enable", True), ("node.data_dir", "data"),
    ("statsd.enable", True), ("gateway.stomp.enable", True),
    ("broker.sys_msg_interval", "10s"), ("psk.enable", True),
])
def test_unported_subsystem_key_raises(key, value):
    cfg = PortConfig(env={})
    cfg.put(key, value)
    assert any(key.startswith(p) for p in UNPORTED_KEYS)
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        PortNode(cfg, device="cpu")


def test_info_says_what_is_left_out():
    ref = RefNode(RefConfig(env={})).info()
    port = PortNode(PortConfig(env={}), device="cpu").info()
    assert set(port) <= set(ref)
    assert set(ref) - set(port) == {
        "gateways", "bridges", "plugins", "topic_metrics", "cluster_peers",
        "admission"}
    assert port["rules"] == ref["rules"] == 0
    assert port["auth"] == ref["auth"] == {
        "authenticators": 0, "sources": 0, "attached": False}


def test_stop_leaves_no_task_and_no_open_socket():
    async def main():
        node = make_node(PORT, **{"broker.fanout.enable": True})
        await node.start()
        port = node.listeners.all()[0].port
        c = Client(clientid="c", port=port)
        await c.connect()
        await c.subscribe("x/#", qos=1)
        half = await asyncio.open_connection("127.0.0.1", port)  # no CONNECT
        await node.stop()
        await c.wait_closed()
        assert await half[0].read() == b""   # the server closed it
        half[1].close()
        assert node._all_conns == set() and node.connections == {}
        assert not node.listeners.all()[0].running
        with pytest.raises(OSError):
            await asyncio.open_connection("127.0.0.1", port)
        await c.close()
        await asyncio.sleep(0)
        left = [t for t in asyncio.all_tasks()
                if t is not asyncio.current_task()]
        assert left == []

    run(main())
