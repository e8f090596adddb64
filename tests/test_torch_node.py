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
reference case's predicate on it, not as its value.  The reference's
rule engine has no port yet: where a case creates a rule, the port's
side registers the rule's FROM filter with its match service directly
(``register_rule``), which is what the engine does on the reference's.

A seeded script (connect, subscribe, retained and QoS 0/1/2 publishes,
``$delayed/`` publishes, unsubscribe, a ``clean_start=false`` resume)
gives equal decoded packets to each client on both nodes; the port's
client drives the reference's node as the reference's client does; the
port's node on ``cuda`` raises at start where there is no card; a key
of an unported subsystem set away from its default raises at
construction; ``stop()`` leaves no task and no open socket.
"""

import asyncio
import dataclasses
import random

import pytest
import torch

from emqx_tpu import topic as T
from emqx_tpu.broker.message import make_message as ref_make_message
from emqx_tpu.client import Client
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


def make_node(side, tpu=True, **extra):
    """A node of ``side`` as the reference cases make theirs."""
    Config = RefConfig if side == REF else PortConfig
    cfg = Config(file_text='listeners.tcp.default.bind = "127.0.0.1:0"\n')
    cfg.put("tpu.enable", tpu)  # the env layer disables it for the suite
    cfg.put("tpu.mirror_refresh_interval", 0.01)
    cfg.put("tpu.bypass_rate", 0.0)  # pin the device path on for tests
    for k, v in extra.items():
        cfg.put(k, v)
    return RefNode(cfg) if side == REF else PortNode(cfg, device="cpu")


def sub(b, cid, flt):
    if cid not in b.sessions:
        b.open_session(cid)
    b.subscribe(cid, flt)


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
        await asyncio.sleep(0.05)   # nothing more arrives
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


async def _quiet(clients, node, settle_s=0.05):
    """Wait until the node is idle and no client received anything for
    ``settle_s`` (on a loaded machine a fanout batch or a match batch
    can take longer than that)."""
    last = -1
    while True:
        n = sum(len(c.inbound) for c in clients)
        if n == last and _node_idle(node):
            return
        last = n
        await asyncio.sleep(settle_s)


async def seeded_script(side, seed, fanout_on=False, client_cls=Client):
    rng = random.Random(seed)
    extra = {"broker.fanout.enable": fanout_on} if fanout_on else {}
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
        await _quiet(clients, node)
        for i in range(12):     # a seeded QoS mix, topics and payloads
            qos = rng.randint(0, 2)
            topic = f"s/{rng.randint(0, 3)}/t"
            await a.publish(topic, bytes(rng.randrange(256)
                                         for _ in range(rng.randint(0, 8))),
                            qos=qos)
        await _quiet(clients, node)
        await b.publish("$delayed/1/d/x", b"later", qos=1)
        assert await settle(lambda: any(p[1].get("topic") == "d/x"
                                         for p in b.inbound), timeout=10)
        await c.disconnect()    # the session stays: clean_start false
        await settle(lambda: "C" not in node.connections)
        for i in range(3):      # queued for the offline C
            await a.publish("s/1/t", f"off{i}".encode(), qos=1)
        await _quiet(clients, node)
        c2 = C(clientid="C", port=port, proto_ver=5, clean_start=False,
               properties={"Session-Expiry-Interval": 300})
        await c2.connect()      # the resume: session present, the queue
        d = C(clientid="D", port=port, proto_ver=4)
        await d.connect()
        await d.subscribe("r/#", qos=2)     # the retained replay
        clients += [c2, d]
        await _quiet(clients, node)
        await a.unsubscribe("s/+/t")
        await b.publish("s/2/t", b"after-unsub", qos=1)
        await b.publish("r/k1", b"", qos=0, retain=True)   # clears it
        await _quiet(clients, node)
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
    ("exhook.servers", "s=127.0.0.1:9000"), ("gateway.stomp.enable", True),
    ("broker.sys_msg_interval", "10s"), ("authz.no_match", "deny"),
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
        "gateways", "bridges", "rules", "plugins", "auth", "topic_metrics",
        "cluster_peers", "admission"}


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
