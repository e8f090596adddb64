"""The port's Router and Broker (``emqx_tpu_torch/broker``) against the
reference's (``emqx_tpu/broker``) on the same seeded scripts of
``open_session`` / ``subscribe`` / ``unsubscribe`` / ``close_session`` /
``publish``, over exact, ``+``, ``#``, ``$SYS``, ``$share/g/...`` and
``$queue/...`` filters, with the deterministic round-robin shared
dispatch.  After every step the route tables must agree (epoch, delta
log, ``match_routes``, ``routes_with_wild``, ``wildcard_filters``,
``routes_of``), and every publish must give the same ``DeliverResult``
and the same per-client sends, exactly.
"""

import gc
import weakref

import numpy as np
import pytest

from emqx_tpu import topic as RT
from emqx_tpu.broker.broker import Broker as RefBroker
from emqx_tpu.broker.message import make_message as ref_message
from emqx_tpu.broker.router import Router as RefRouter
from emqx_tpu.broker.session import SubOpts as RefSubOpts
from emqx_tpu_torch import topic as T
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.message import make_message
from emqx_tpu_torch.broker.router import Router
from emqx_tpu_torch.broker.session import SubOpts
from emqx_tpu_torch.broker.trie import FilterTrie

FILTERS = ["a/b", "s/t/u", "a/+", "+/b", "s/+/u", "a/#", "#", "s/#",
           "$SYS/#", "$SYS/+/x", "$share/g/a/+", "$share/g2/s/#",
           "$share/g/+/b", "$queue/a/b", "$queue/s/+/u", "a//b", "+/+"]
TOPICS = ["a/b", "a/c", "s/t/u", "s/x/u", "$SYS/a/x", "$SYS/b", "q/b",
          "a", "a//b", "s/t"]
CLIENTS = [f"c{i}" for i in range(6)]


def _routes(routes):
    return sorted((r.filter, repr(r.dest)) for r in routes)


def _msg(m):
    return (m.qos, m.sender, m.topic, m.payload, m.retain, m.dup,
            sorted(m.properties.items()))


def _result(res):
    return ({c: [(p.pid, _msg(p.msg)) for p in pubs]
             for c, pubs in res.publishes.items()},
            [(c, _msg(m)) for c, m in res.dropped],
            res.matched, res.no_subscribers)


def _assert_routers_equal(port, ref, step):
    assert port.epoch == ref.epoch, step
    assert [tuple(d) for d in port.deltas_since(0)] == \
        [tuple(d) for d in ref.deltas_since(0)], step
    assert sorted(port.wildcard_filters()) == sorted(ref.wildcard_filters())
    for f in {RT.strip_share(f) for f in FILTERS}:
        assert port.routes_of(f) == ref.routes_of(f), (step, f)
    for t in TOPICS:
        want = _routes(ref.match_routes(t))
        assert _routes(port.match_routes(t)) == want, (step, t)
        wild = [f for f in ref.wildcard_filters() if RT.match(t, f)]
        assert _routes(port.routes_with_wild(t, wild)) == \
            _routes(ref.routes_with_wild(t, wild)), (step, t)


def _script(seed, steps=160):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(steps):
        kind = rng.choice(["open", "sub", "sub", "sub", "unsub", "close",
                           "pub", "pub", "pub"])
        c = CLIENTS[rng.integers(len(CLIENTS))]
        if kind == "open":
            ops.append(("open", c, bool(rng.random() < 0.7)))
        elif kind == "sub":
            ops.append(("sub", c, FILTERS[rng.integers(len(FILTERS))],
                        int(rng.integers(3)), bool(rng.random() < 0.2)))
        elif kind == "unsub":
            ops.append(("unsub", c, FILTERS[rng.integers(len(FILTERS))]))
        elif kind == "close":
            ops.append(("close", c, bool(rng.random() < 0.5)))
        else:
            ops.append(("pub", c, TOPICS[rng.integers(len(TOPICS))],
                        int(rng.integers(3)), bool(rng.random() < 0.3)))
    return ops


def _run(broker, ops, message, subopts):
    """Replay ``ops``; yields each step's comparable outcome."""
    for op in ops:
        kind, c = op[0], op[1]
        if kind == "open":
            # a small window and queue: QoS1/2 sends queue and drop
            _sess, present = broker.open_session(c, clean_start=op[2],
                                                 max_inflight=2,
                                                 max_mqueue_len=2)
            yield present
        elif kind == "sub":
            if c not in broker.sessions:
                yield "no-session"
                continue
            yield broker.subscribe(c, op[2], subopts(qos=op[3], nl=op[4]))
        elif kind == "unsub":
            yield broker.unsubscribe(c, op[2])
        elif kind == "close":
            broker.close_session(c, discard=op[2])
            yield sorted(broker.sessions)
        else:
            msg = message(c, op[2], f"{op[2]}:{op[3]}".encode(), qos=op[3],
                          retain=op[4])
            yield _result(broker.publish(msg))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_broker_script_equals_reference(seed):
    ops = _script(seed)
    port = Broker(shared_strategy="round_robin")
    ref = RefBroker(shared_strategy="round_robin")
    port_steps = _run(port, ops, make_message, SubOpts)
    ref_steps = _run(ref, ops, ref_message, RefSubOpts)
    for i, (got, want) in enumerate(zip(port_steps, ref_steps)):
        assert got == want, (i, ops[i])
        _assert_routers_equal(port.router, ref.router, (i, ops[i]))
    for c in CLIENTS:
        assert [(p.pid, _msg(p.msg)) for p in port.take_outbox(c)] == \
            [(p.pid, _msg(p.msg)) for p in ref.take_outbox(c)], c
    assert port.stats() == {k: v for k, v in ref.stats().items()
                            if k in port.stats()}


@pytest.mark.parametrize("seed", [5, 6])
def test_router_script_equals_reference(seed):
    """Direct route adds and deletes (also of dests that hold several
    filters, and of missing routes) and ``cleanup_routes``."""
    rng = np.random.default_rng(seed)
    port, ref = Router(), RefRouter()
    dests = ["n1", "n2", ("g", "n1")]
    for i in range(300):
        f = T.strip_share(FILTERS[rng.integers(len(FILTERS))])
        d = dests[rng.integers(len(dests))]
        op = rng.choice(["add", "add", "del", "cleanup"])
        if op == "add":
            assert port.add_route(f, d) == ref.add_route(f, d)
        elif op == "del":
            assert port.delete_route(f, d) == ref.delete_route(f, d)
        else:
            assert port.cleanup_routes(d) == ref.cleanup_routes(d)
        _assert_routers_equal(port, ref, i)
        for t in TOPICS:
            assert port.match_dests(t) == ref.match_dests(t)
    assert port.route_count() == ref.route_count()
    assert port.deltas_since(port.epoch) == []


def test_router_delta_log_gap_and_listeners():
    """A log shorter than the requested span answers None (the mirror
    then resnapshots), and every mutation wakes the listeners with the
    new epoch."""
    port, ref = Router(delta_log_cap=4), RefRouter(delta_log_cap=4)
    woke = []
    port.listeners.append(woke.append)
    for i in range(6):
        port.add_route(f"x/{i}/+", "n")
        ref.add_route(f"x/{i}/+", "n")
    assert woke == list(range(1, 7))
    assert port.deltas_since(0) is None and ref.deltas_since(0) is None
    assert [tuple(d) for d in port.deltas_since(3)] == \
        [tuple(d) for d in ref.deltas_since(3)]


def test_deltas_since_a_full_log_equals_reference():
    """The tail is taken from the log's right end (the reference steps
    through the whole deque to reach it): the same deltas for every
    epoch, with the log at its cap."""
    port, ref = Router(delta_log_cap=64), RefRouter(delta_log_cap=64)
    for i in range(200):
        for r in (port, ref):
            r.add_route(f"x/{i % 50}/+", f"n{i % 3}")
            if i % 4 == 0:
                r.delete_route(f"x/{i % 50}/+", "n0")
    for e in range(port.epoch + 1):
        got, want = port.deltas_since(e), ref.deltas_since(e)
        assert (got is None) == (want is None), e
        if got is not None:
            assert [tuple(d) for d in got] == [tuple(d) for d in want], e


def test_trie_node_count_and_topic_helpers():
    trie = FilterTrie()
    for f in ("a/+/c", "a/b", "#", "a/+/d"):
        trie.insert(f)
    # a, +, c, b, #, d
    assert trie.node_count() == 6
    for f in FILTERS + TOPICS:
        assert T.wildcard(f) == RT.wildcard(f)
        assert T.levels(f) == RT.levels(f)
        assert T.is_shared(f) == RT.is_shared(f)
        assert T.strip_share(f) == RT.strip_share(f)
    assert T.make_share("g", "a/+") == RT.make_share("g", "a/+")


def test_qos0_fanout_shares_one_publish_and_leaves_no_cycle():
    """A QoS0 publish hands every subscriber one shared Publish, and the
    message's cache of it is dropped once the publish is done: message
    and Publish die by refcount, with the collector off."""
    b = Broker()
    b.on_deliver = lambda _cid, _pubs: None
    for cid in ("a", "b"):
        b.open_session(cid)
        b.subscribe(cid, "t/+")
    msg = make_message("p", "t/1", b"x")
    res = b.publish(msg)
    pubs = [p for ps in res.publishes.values() for p in ps]
    assert res.matched == 2 and len(pubs) == 2 and pubs[0] is pubs[1]
    assert "_pub0" not in msg.__dict__
    gone = weakref.ref(msg)
    gc.disable()
    try:
        del msg, res, pubs
        assert gone() is None
    finally:
        gc.enable()
