"""The port's asyncio serve loop (``emqx_tpu_torch/broker/match_service.py``
with a broker attached) on the CPU, where the plain walks serve.

* (a) parity with the reference: one scripted broker drives the
  reference ``MatchService`` (JAX on the CPU, Python table, depth 8) and
  the port's on both host tables; after each sync the hints (routing
  filters, rule ids, availability) and the ``tpu.match.*`` counters must
  be equal, and every hint must equal ``router.match_routes``;
* (b) the reference's node-free scenarios of
  ``tests/test_match_service.py`` on the port, for both host tables;
* (c) ``_StaleRace``: an accept id reused while a batch is in flight;
* (d) the failure paths: a failed dispatch leaves no hint and publish
  delivers through the host trie; a stopped loop fails its waiters over
  at once; a failed warm-up keeps the service from serving; a join
  relation rebuild (sorted on the device, outside the dispatch lock)
  does not stall the loop; the started heap is frozen, and so is a
  large growth of the mirror after start;
* (d') a saturated loop: an answer given before its waiter's timer ran
  is kept, and a late wake runs the sync without a second debounce;
* (e) the autotuner against the reference class, and ``auto`` routing;
* (f) the encoder lock under concurrent encodes;
* (g) every reference parameter is taken (the multichip plane's, the
  last once refused, build the matcher; ``tests/test_torch_multichip*``
  hold it to the reference); an unknown one raises.
"""

import asyncio
import gc
import json
import logging
import sys
import threading
import time

import numpy as np
import pytest
import torch

from emqx_tpu.broker.broker import Broker as RefBroker
from emqx_tpu.broker.match_service import MatchService as RefMatchService
from emqx_tpu.observe.metrics import Metrics as RefMetrics
from emqx_tpu.ops import IncrementalNfa as RefIncrementalNfa
from emqx_tpu.ops.join_match import BackendAutotuner as RefAutotuner
from emqx_tpu_torch import faultinject as fi
from emqx_tpu_torch import topic as T
from emqx_tpu_torch.broker import match_service
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.match_service import MatchService
from emqx_tpu_torch.broker.message import make_message
from emqx_tpu_torch.native.nfa import NativeNfa
from emqx_tpu_torch.observe import Metrics
from emqx_tpu_torch.ops import DeviceNfa, IncrementalNfa
from emqx_tpu_torch.ops.encode import table_encoder
from emqx_tpu_torch.ops.join_match import (BackendAutotuner, JoinRelation,
                                           OverlayFull, relation_arrays)
from emqx_tpu_torch.workload import build_workload

TABLES = ["python", "native"]
COUNTERS = ["tpu.match.batches", "tpu.match.topics",
            "tpu.match.fallback_host", "tpu.match.hint_served",
            "tpu.match.hint_stale", "tpu.match.hint_evicted",
            "tpu.match.bypass"]
LOGGER = "emqx_tpu_torch.broker.match_service"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain walks are many small torch ops: with one intra-op thread
    they do not slow down tenfold when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _unfrozen():
    """A started service freezes the heap; each test hands the process
    back unfrozen."""
    yield
    gc.unfreeze()


@pytest.fixture
def injector():
    """Installs a scenario table of the port's fault injector for one
    test, and always takes it out again."""
    def install(rules, **kw):
        return fi.install(fi.FaultInjector(rules, **kw))
    yield install
    fi.uninstall()


def run(coro):
    return asyncio.run(coro)


async def settle(pred, timeout=20.0, interval=0.005):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if pred():
            return True
        await asyncio.sleep(interval)
    return pred()


def synced(ms):
    return (ms.ready and ms._synced_epoch == ms.router.epoch
            and ms._synced_rule_gen == ms._rule_gen
            and ms.dev.epoch == ms.inc.epoch)


def sub(b, cid, flt):
    if cid not in b.sessions:
        b.open_session(cid)
    b.subscribe(cid, flt)


def routes(rs):
    return None if rs is None else sorted((r.filter, repr(r.dest))
                                          for r in rs)


async def started(table, filters=(), depth=8, **kw):
    """A broker with one session per filter, and a port service on it
    (plain walks, bypass off, a short debounce), started and synced;
    ``device_match`` wired as the node wires it."""
    b = Broker()
    for i, f in enumerate(filters):
        sub(b, f"c{i}", f)
    m = Metrics()
    kw.setdefault("bypass_rate", 0)
    ms = MatchService(b, m, device="cpu", table=table, depth=depth,
                      debounce_s=0.01, **kw)
    await ms.start()
    assert await settle(lambda: synced(ms))
    b.device_match = ms.hint_routes
    return b, ms, m


# -- (a) parity with the reference MatchService -----------------------------

#: every level of w/{a,+}/{b,+}/{c,+}/{d,+}: the topic w/a/b/c/d has a
#: frontier of 16 at its last level, more than the 8 active slots below
FAN = ["w/" + "/".join("+" if m >> k & 1 else c for k, c in enumerate("abcd"))
       for m in range(16)]
TOPICS1 = ["a/b", "a/b/c", "x/y", "q/b", "$SYS/x", "s/t/u", "s/q/u", "w/a/b/c/d",
           "deep/a/b/c/d/e/f/q/x", "rule/only/z", "none", "a"]
TOPICS2 = ["a/z", "a/b/q", "rule/only/z", "rule/only", "w/a/b/c/d", "q/b/c",
           "x/y", "$SYS/a/b"]
COLD = [f"cold/{i}/b" for i in range(14)] + [f"q{i}/b" for i in range(6)]
#: the script: subscribe/unsubscribe on the broker, register/unregister
#: rules on the service, sync, serve (prefetch a set of topics in one
#: tick), peek (hint_available, hint_rules, hint_routes of each topic)
SCRIPT = (
    [("sub", f"c{i}", f) for i, f in enumerate(
        ["a/+", "a/#", "x/y", "+/b", "$SYS/#", "$share/g/s/+/u",
         "deep/a/b/c/d/e/f/+/x"])]
    + [("sub", f"f{i}", f) for i, f in enumerate(FAN)]
    + [("sync",), ("serve", TOPICS1), ("peek", TOPICS1),
       ("sub", "c7", "a/b/#"),              # a matching wildcard: stale
       ("sub", "c8", "x/y/z"),              # an exact filter: no harm
       ("peek", TOPICS1), ("sync",), ("serve", TOPICS1), ("peek", TOPICS1),
       ("rule", "r1", ["a/+", "rule/only/#"]),
       ("peek", TOPICS2), ("sync",), ("serve", TOPICS2), ("peek", TOPICS2),
       ("bypass", TOPICS1[:4]),
       ("unsub", "c0", "a/+"), ("unsub", "c3", "+/b"), ("unrule", "r1"),
       ("sync",), ("serve", TOPICS2), ("peek", TOPICS2 + TOPICS1),
       ("serve", COLD), ("peek", COLD[-4:] + TOPICS1[:6]),
       ("rule", "r2", ["cold/+/b", "x/#"]), ("sync",),
       ("serve", COLD[:8] + ["x/y"]), ("peek", COLD[:8] + ["x/y"])])


async def _drive(broker, ms, metrics):
    """Run SCRIPT against one broker/service pair; every hint must equal
    the router's own answer.  Returns the observations."""
    obs = []
    for step in SCRIPT:
        kind = step[0]
        if kind == "sub":
            sub(broker, step[1], step[2])
        elif kind == "unsub":
            broker.unsubscribe(step[1], step[2])
        elif kind == "rule":
            ms.register_rule(step[1], step[2])
        elif kind == "unrule":
            ms.unregister_rule(step[1])
        elif kind == "sync":
            assert await settle(lambda: synced(ms)), step
        elif kind in ("serve", "bypass"):
            ms.bypass_rate = 1e9 if kind == "bypass" else 0
            await asyncio.gather(*[ms.prefetch(t) for t in step[1]])
            ms.bypass_rate = 0
        else:
            for t in step[1]:
                got = (t, ms.hint_available(t), ms.hint_rules(t),
                       routes(ms.hint_routes(t)))
                if got[3] is not None:
                    assert got[3] == routes(broker.router.match_routes(t)), t
                obs.append(got)
        obs.append((kind, {k: metrics.get(k) for k in COUNTERS}))
    return obs


@pytest.fixture(scope="module")
def reference_script():
    """SCRIPT on the reference service (one start in this file)."""
    async def main():
        b = RefBroker()
        m = RefMetrics()
        ms = RefMatchService(b, m, depth=8, table="python", bypass_rate=0,
                             debounce_s=0.01, active_slots=8, hint_cap=12)
        await ms.start()
        try:
            assert await settle(lambda: synced(ms), timeout=120)
            b.device_match = ms.hint_routes
            return await _drive(b, ms, m)
        finally:
            await ms.stop()
    return run(main())


@pytest.mark.parametrize("table", TABLES)
def test_hints_and_counters_equal_reference(reference_script, table):
    async def main():
        b, ms, m = await started(table, [], active_slots=8,
                                 max_matches=32, hint_cap=12)
        try:
            return await _drive(b, ms, m)
        finally:
            await ms.stop()
    got = run(main())
    assert len(got) == len(reference_script)
    for i, (a, b) in enumerate(zip(got, reference_script)):
        assert a == b, (i, a, b)
    counters = dict(reference_script[-1][1])
    # the script reached every path it compares
    assert all(counters[k] > 0 for k in COUNTERS), counters


# -- (b) the reference's node-free scenarios on the port -------------------

@pytest.mark.parametrize("table", TABLES)
def test_scoped_hint_invalidation(table):
    """Only a new wildcard filter that matches a topic kills its hint;
    exact adds and deletes resolve live."""
    async def main():
        b, ms, m = await started(table, ["a/+"])
        try:
            await ms.prefetch("a/x")
            assert ms.hint_routes("a/x") is not None
            sub(b, "c2", "a/x")                   # exact add: survives
            assert routes(ms.hint_routes("a/x")) == \
                routes(b.router.match_routes("a/x"))
            sub(b, "c3", "zzz/+")                 # unrelated wildcard
            assert ms.hint_routes("a/x") is not None
            b.unsubscribe("c2", "a/x")            # delete: survives
            assert routes(ms.hint_routes("a/x")) == \
                routes(b.router.match_routes("a/x"))
            sub(b, "c4", "a/#")                   # the one poison case
            assert ms.hint_routes("a/x") is None
            assert m.get("tpu.match.hint_stale") >= 1
            assert await settle(lambda: synced(ms))
            await ms.prefetch("a/x")
            assert routes(ms.hint_routes("a/x")) == \
                routes(b.router.match_routes("a/x"))
        finally:
            await ms.stop()
    run(main())


@pytest.mark.parametrize("table", TABLES)
def test_churn_keeps_device_duty_cycle(table):
    async def main():
        b, ms, m = await started(table, [f"room/+/k{i}" for i in range(8)])
        try:
            topics = [f"room/{i}/k{i % 8}" for i in range(16)]
            served = total = 0
            for round_ in range(12):
                sub(b, "churn", f"churnspace/{round_}/+")
                if round_ > 0:
                    b.unsubscribe("churn", f"churnspace/{round_ - 1}/+")
                for t in topics:
                    await ms.prefetch(t)
                    total += 1
                    hint = ms.hint_routes(t)
                    if hint is not None:
                        served += 1
                        assert routes(hint) == \
                            routes(b.router.match_routes(t)), t
                await asyncio.sleep(0.005)
            assert served / total > 0.5
            assert m.get("tpu.match.hint_served") >= served
        finally:
            await ms.stop()
    run(main())


@pytest.mark.parametrize("table", TABLES)
def test_adaptive_bypass_low_concurrency(table):
    async def main():
        b, ms, m = await started(table, ["a/+"], bypass_rate=1e9)
        try:
            await ms.prefetch("a/x")
            assert m.get("tpu.match.bypass") >= 1
            assert ms.hint_routes("a/x") is None   # no hint minted
            assert b.publish(make_message("p", "a/x", b"!")).matched == 1
            assert m.get("tpu.match.topics") == 0
        finally:
            await ms.stop()
    run(main())


@pytest.mark.parametrize("table", TABLES)
def test_hint_routes_match_host_routes_with_too_deep_filter(table):
    """depth 8: the 9-level filter lives in the host trie under an alias
    id, and its hits are merged into the device rows."""
    flts = ["s/+/t", "s/#", "exact/topic", "+/b", "deep/a/b/c/d/e/f/+/x"]

    async def main():
        b, ms, _m = await started(table, flts)
        try:
            assert "deep/a/b/c/d/e/f/+/x" in ms._deep
            for t in ["s/1/t", "s/9", "exact/topic", "q/b", "none",
                      "deep/a/b/c/d/e/f/q/x"]:
                await ms.prefetch(t)
                hint = ms.hint_routes(t)
                assert hint is not None, t
                assert routes(hint) == routes(b.router.match_routes(t)), t
        finally:
            await ms.stop()
    run(main())


@pytest.mark.parametrize("table", TABLES)
def test_bootstrap_refcounts_multiple_dests(table):
    """A filter bootstrapped with two routes survives the deletion of
    one of them."""
    async def main():
        b = Broker()
        sub(b, "c1", "m/+")
        sub(b, "c2", "$share/g/m/+")
        ms = MatchService(b, Metrics(), device="cpu", table=table, depth=8,
                          bypass_rate=0, debounce_s=0.01)
        await ms.start()
        try:
            assert ms._ref == {"m/+": 2}
            assert await settle(lambda: synced(ms))
            b.unsubscribe("c1", "m/+")
            assert await settle(lambda: synced(ms))
            assert ms.inc.n_filters == 1, "filter dropped while still routed"
            await ms.prefetch("m/1")
            hint = ms.hint_routes("m/1")
            assert hint is not None and len(hint) == 1
        finally:
            await ms.stop()
    run(main())


@pytest.mark.parametrize("table", TABLES)
def test_rule_registration_invalidates_hints(table):
    async def main():
        b, ms, _m = await started(table, ["evt/#"])
        try:
            await ms.prefetch("evt/x")
            assert ms.hint_rules("evt/x") == []
            ms.register_rule("r1", ["evt/+"])
            assert ms.hint_rules("evt/x") is None   # stale for rules
            assert await settle(lambda: synced(ms))
            await ms.prefetch("evt/x")
            assert ms.hint_rules("evt/x") == ["r1"]
            # the rule filter is not a routing answer
            assert routes(ms.hint_routes("evt/x")) == \
                routes(b.router.match_routes("evt/x"))
        finally:
            await ms.stop()
    run(main())


@pytest.mark.parametrize("table", TABLES)
def test_unsubscribe_prunes_mirror(table):
    async def main():
        b, ms, _m = await started(table, ["x/+"])
        try:
            assert ms.inc.n_filters == 1
            b.unsubscribe("c0", "x/+")
            assert await settle(
                lambda: synced(ms) and ms.inc.n_filters == 0)
            assert ms.n_routing == 0
        finally:
            await ms.stop()
    run(main())


@pytest.mark.parametrize("table", TABLES)
def test_depth_bucketed_batch_parity(table):
    """A mixed-depth batch split across the shallow and the full walk
    gives the host trie's answers (split_min=1 pins the split on)."""
    flts = ("a/+", "a/+/c/+/e", "deep/+/x/+/z/+/q", "#")

    async def main():
        b, ms, m = await started(table, flts, split_min=1, max_batch=512)
        try:
            topics = ["a/b", "a/b/c/d/e", "deep/1/x/2/z/3/q", "nah", "a/q",
                      "deep/only"]
            loop = asyncio.get_running_loop()
            futs = [loop.create_future() for _ in topics]
            ms._pending.extend(zip(topics, futs))
            ms._batch_wake.set()
            assert await settle(lambda: all(f.done() for f in futs))
            for t in topics:
                hint = ms._hints.get(t)
                assert hint is not None, t
                assert sorted(hint[2]) == sorted(
                    r.filter for r in b.router.match_routes(t)), t
            assert m.get("tpu.match.batches") == 2   # two depth groups
            assert ms.dispatches == 2
        finally:
            await ms.stop()
    run(main())


@pytest.mark.parametrize("table", TABLES)
def test_hint_cache_lru_eviction_no_thrash(table):
    async def main():
        b, ms, m = await started(table, ["room/+/k"], hint_cap=24)
        try:
            hot = [f"room/h{i}/k" for i in range(8)]
            for t in hot:
                await ms.prefetch(t)
            for t in hot:
                assert ms.hint_routes(t) is not None
            served_hot = total_hot = 0
            for round_ in range(6):
                cold = [f"room/c{round_}_{i}/k" for i in range(20)]
                for ci, t in enumerate(cold):
                    await ms.prefetch(t)
                    if ci % 4 == 3:
                        for h in hot:
                            total_hot += 1
                            if ms.hint_routes(h) is not None:
                                served_hot += 1
                assert 8 <= len(ms._hints) <= ms.hint_cap
            assert served_hot / total_hot > 0.9
            assert m.get("tpu.match.hint_evicted") >= 1
        finally:
            await ms.stop()
    run(main())


@pytest.mark.parametrize("table", TABLES)
def test_rules_only_hot_set_survives_lru_eviction(table):
    async def main():
        b, ms, _m = await started(table, ["other/+"], hint_cap=24)
        try:
            ms.register_rule("r1", ["room/+/k"])
            assert await settle(lambda: synced(ms))
            hot = [f"room/h{i}/k" for i in range(8)]
            for t in hot:
                await ms.prefetch(t)
            for t in hot:
                assert ms.hint_rules(t) == ["r1"]
                assert ms.hint_routes(t) == []   # rules only: no routes
            served_hot = total_hot = 0
            for round_ in range(6):
                cold = [f"room/c{round_}_{i}/k" for i in range(20)]
                for ci, t in enumerate(cold):
                    await ms.prefetch(t)
                    if ci % 4 == 3:
                        for h in hot:
                            total_hot += 1
                            if ms.hint_rules(h) is not None:
                                served_hot += 1
                assert len(ms._hints) <= ms.hint_cap
            assert served_hot / total_hot > 0.9
        finally:
            await ms.stop()
    run(main())


@pytest.mark.parametrize("table", TABLES)
def test_prefetch_many_rides_one_batch(table):
    """The topics without a fresh hint are enqueued in one tick and
    served by one dispatch; a topic with one is skipped."""
    async def main():
        b, ms, m = await started(table, ["a/+", "+/b", "c/#"])
        try:
            await ms.prefetch("a/1")
            await ms.prefetch_many(["a/1", "a/2", "q/b", "c/d/e", "z"])
            assert m.get("tpu.match.batches") == 2
            assert m.get("tpu.match.topics") == 1 + 4
            for t in ("a/1", "a/2", "q/b", "c/d/e", "z"):
                assert routes(ms.hint_routes(t)) == \
                    routes(b.router.match_routes(t)), t
        finally:
            await ms.stop()
    run(main())


def test_recent_adds_proof_equals_the_delta_log_scan():
    """The freshness proof's index answers as the reference's scan of
    the delta log, on a seeded churn of exact, wildcard and shared
    routes, with proofs every few mutations and after gaps longer than
    its window."""
    rng = np.random.default_rng(8)
    b = Broker()
    recent = match_service._RecentAdds(b.router, 64)
    pool = ["a/+", "a/#", "+/b", "a/b", "#", "$SYS/#", "+/+", "c/+/d",
            "c/x/d", "+", "$share/g/a/+", "$queue/c/#"]
    topics = ["a/b", "a/c", "c/x/d", "$SYS/x", "q", "x/b", "a", "c/q/d"]
    subs = set()
    proofs = 0
    for step in range(900):
        key = (f"c{rng.integers(4)}", pool[rng.integers(len(pool))])
        if key in subs:
            b.unsubscribe(*key)
            subs.discard(key)
        else:
            sub(b, *key)
            subs.add(key)
        if step % 7 or (step // 150) % 2:
            continue
        now = b.router.epoch
        for e in rng.integers(max(0, now - 64), now + 1, size=4).tolist():
            for t in topics:
                want = any(d.op == "add" and T.wildcard(d.filter)
                           and T.match(t, d.filter)
                           for d in b.router.deltas_since(e))
                assert recent.stale(t, e) == want, (step, e, t)
                proofs += 1
    assert proofs > 1000 and len(recent.trie) <= 64


@pytest.mark.parametrize("table", TABLES)
def test_proven_hint_is_restamped(table):
    """A hint proven fresh through the delta log is re-stamped with the
    router's epoch, so it outlives more than ``max_stale_deltas``
    unrelated mutations when it is used in between; a matching wildcard
    add still invalidates it."""
    async def main():
        b, ms, m = await started(table, ["a/+"], max_stale_deltas=8)
        try:
            await ms.prefetch("a/x")
            for i in range(30):               # 30 unrelated mutations
                sub(b, "churn", f"z{i}/+")
                assert routes(ms.hint_routes("a/x")) == \
                    routes(b.router.match_routes("a/x"))
                assert ms._hints["a/x"][0] == b.router.epoch
            assert m.get("tpu.match.hint_stale") == 0
            sub(b, "c9", "+/x")               # a matching add
            assert ms.hint_routes("a/x") is None
            assert m.get("tpu.match.hint_stale") == 1
        finally:
            await ms.stop()
    run(main())


# -- (c) an accept id reused while a batch is in flight ---------------------

@pytest.mark.parametrize("table", TABLES)
def test_stale_race_on_aid_reused_mid_flight(table, injector, caplog):
    caplog.set_level(logging.DEBUG, logger=LOGGER)

    async def main():
        b, ms, _m = await started(table, ["keep/+", "gone/+"])
        try:
            b.unsubscribe("c1", "gone/+")         # frees an accept id ...
            assert await settle(lambda: synced(ms))   # ... acked: reusable
            gate = asyncio.Event()

            async def held(_delay):
                await gate.wait()

            inj = injector([{"point": "match.readback", "action": "delay"}],
                           sleep=held)
            task = asyncio.ensure_future(ms.prefetch("keep/x"))
            assert await settle(lambda: inj.fired.get("match.readback"))
            reuses = ms.inc.aid_reuses
            sub(b, "c9", "new/+")                  # takes the freed id
            assert await settle(lambda: ms.inc.aid_reuses == reuses + 1)
            gate.set()
            await asyncio.wait_for(task, 5)
            assert ms.hint_routes("keep/x") is None
            assert ms.dispatches == 1 and ms.topics == 0
            # publish still delivers, through the host trie
            assert b.publish(make_message("p", "keep/x", b"!")).matched == 1
        finally:
            await ms.stop()
    run(main())
    failed = [r for r in caplog.records
              if r.getMessage().startswith("device batch failed")]
    assert len(failed) == 1
    assert failed[0].exc_info[0] is match_service._StaleRace


# -- (d) failure paths ------------------------------------------------------

@pytest.mark.parametrize("table", TABLES)
def test_dispatch_fault_leaves_no_hint_and_host_delivers(table, injector,
                                                         caplog):
    caplog.set_level(logging.DEBUG, logger=LOGGER)

    async def main():
        b, ms, m = await started(table, ["a/+", "a/#"])
        try:
            injector([{"point": "match.dispatch", "action": "raise"}])
            await ms.prefetch("a/b")
            assert ms.hint_routes("a/b") is None
            res = b.publish(make_message("p", "a/b", b"!"))
            assert res.matched == 2
            assert m.get("tpu.match.batches") == 0
            # the fault fired once: the next batch serves again
            await ms.prefetch("a/b")
            assert routes(ms.hint_routes("a/b")) == \
                routes(b.router.match_routes("a/b"))
        finally:
            await ms.stop()
    run(main())
    assert any(r.getMessage().startswith("device batch failed")
               and r.exc_info[0] is fi.InjectedFault
               for r in caplog.records)


@pytest.mark.parametrize("table", TABLES)
def test_stopped_loop_fails_waiters_over_at_once(table, injector):
    async def main():
        b, ms, m = await started(table, ["a/+"], prefetch_timeout_s=30)
        inj = injector([{"point": "match.dispatch", "action": "hang"}])
        first = asyncio.ensure_future(ms.prefetch("a/1"))
        # the first batch hangs in flight
        assert await settle(lambda: inj.fired.get("match.dispatch"))
        queued = [asyncio.ensure_future(ms.prefetch(f"a/{i}"))
                  for i in range(2, 4)]
        assert await settle(lambda: len(ms._pending) == 2)
        await ms.stop()
        await asyncio.wait_for(asyncio.gather(first, *queued), 1.0)
        assert m.get("broker.match.cpu_fallback") == 2
        assert ms.hint_routes("a/1") is None
    run(main())


@pytest.mark.parametrize("table", TABLES)
def test_failed_warm_keeps_service_from_serving(table, injector):
    async def main():
        b = Broker()
        sub(b, "c0", "a/+")
        injector([{"point": "match.compile", "action": "raise",
                   "times": 0}])
        ms = MatchService(b, Metrics(), device="cpu", table=table, depth=8,
                          bypass_rate=0, debounce_s=0.01)
        b.device_match = ms.hint_routes
        await ms.start()
        try:
            await asyncio.sleep(0.2)
            assert not ms.ready
            await ms.prefetch("a/x")                # returns at once
            assert ms.dispatches == 0 and ms.hint_routes("a/x") is None
            assert b.publish(make_message("p", "a/x", b"!")).matched == 1
        finally:
            await ms.stop()
    run(main())


def _force_overflow(monkeypatch):
    """The next relation delta overflows the overlay (after the shadow
    took its rows), as a long churn would; returns the arming flag."""
    armed = [False]
    real = JoinRelation.apply_bucket_delta

    def delta(self, *a):
        out = real(self, *a)
        if armed[0]:
            armed[0] = False
            raise OverlayFull("forced")
        return out
    monkeypatch.setattr(JoinRelation, "apply_bucket_delta", delta)
    return armed


@pytest.mark.parametrize("table", TABLES)
def test_relation_sort_on_the_device_equals_the_host(table):
    """``relation_arrays`` (the rebuild's sort on the device) gives the
    host relation's arrays bit for bit, on a churned table."""
    filters, _ = build_workload(np.random.default_rng(4), 3000, 1)
    inc = IncrementalNfa(depth=8) if table == "python" else NativeNfa(depth=8)
    for f in filters:
        inc.add(f)
    for f in filters[::3]:
        inc.remove(f)
    node, edge = ((inc.node_tab, inc.edge_tab) if table == "python"
                  else inc.tables()[:2])
    host = JoinRelation(node.shape[0], edge)
    got = relation_arrays(node.shape[0], torch.from_numpy(edge))
    for g, w in zip(got, host.arrays()[:3]):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w)


def test_relation_rebuild_runs_outside_the_dispatch_lock(monkeypatch):
    """An overflow rebuild held in its sort on an applying thread: a
    dispatch meanwhile walks the old relation at once; the rebuilt one
    equals the host's sort of the new table."""
    from emqx_tpu_torch.ops import device_table

    inc = IncrementalNfa(depth=6)
    for f in ["a/+", "+/b", "s/+/u/#"]:
        inc.add(f)
    dev = DeviceNfa(inc, device="cpu")
    dev.enable_join()
    armed = _force_overflow(monkeypatch)
    sorting, release = threading.Event(), threading.Event()

    def held(*a):
        sorting.set()
        release.wait(10)
        return relation_arrays(*a)
    monkeypatch.setattr(device_table, "relation_arrays", held)
    inc.add("new/+")
    armed[0] = True
    rebuilds = dev.join_rebuilds
    applier = threading.Thread(target=dev.sync)
    applier.start()
    try:
        assert sorting.wait(10)
        t0 = time.monotonic()
        res = dev.match_names(["a/x", "new/x"], flat_cap=64)
        assert time.monotonic() - t0 < 2 and dev.join_rebuilds == rebuilds
        assert res.n_matches.tolist()[:2] == [1, 0]    # the old epoch
    finally:
        release.set()
        applier.join(10)
    assert dev.join_rebuilds == rebuilds + 1
    want = JoinRelation(inc.S, inc.edge_tab).arrays()
    for g, w in zip(dev._jarrs, want):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("table", TABLES)
def test_overflow_rebuild_keeps_the_loop_serving(table, monkeypatch):
    """A churn that overflows the join overlay: the loop serves the
    other topics through it, and the rebuilt relation serves the new
    filter."""
    armed = _force_overflow(monkeypatch)
    topics = ["a/b", "q/b", "s/t/u/v", "x/y"]

    async def main():
        b, ms, _m = await started(table, ["a/+", "+/b", "s/+/u/#", "x/y"],
                                  backend="join")
        try:
            rebuilds = ms.dev.join_rebuilds
            armed[0] = True
            sub(b, "c9", "new/+")
            served = asyncio.gather(*[ms.prefetch(t) for t in topics * 8])
            assert await settle(lambda: synced(ms))
            await served
            assert ms.dev.join_rebuilds == rebuilds + 1
            for t in topics + ["new/x"]:
                await ms.prefetch(t)
                assert routes(ms.hint_routes(t)) == \
                    routes(b.router.match_routes(t)), t
            assert ms.join_dispatches == ms.dispatches
        finally:
            await ms.stop()
    run(main())


def test_start_freezes_the_started_heap():
    """What is live at start (the sessions, the router) leaves the
    collector's generations for its permanent one; what comes later is
    collected as usual."""
    gc.unfreeze()

    async def main():
        b, ms, _m = await started("python", ["a/+", "b/#"])
        try:
            sess = b.sessions["c0"]
            sub(b, "late", "c/+")
            late = b.sessions["late"]
            assert gc.is_tracked(sess) and gc.get_freeze_count() > 0
            alive = gc.get_objects()
            assert not any(o is sess for o in alive)
            assert any(o is late for o in alive)
        finally:
            await ms.stop()
    run(main())


def test_a_large_sync_freezes_its_growth():
    """A fleet that subscribes after start() is frozen as the mirror
    takes it in: once ``FREEZE_GROWTH`` more live filters than at the
    last freeze are synced; a churn that adds as many as it removes
    freezes nothing."""
    gc.unfreeze()

    async def main():
        b, ms, _m = await started("python", ["a/+"])
        ms.FREEZE_GROWTH = 40
        try:
            for i in range(39):
                sub(b, f"f{i}", f"fleet/{i}/+")
            assert await settle(lambda: synced(ms))
            assert ms.freezes == 0
            for i in range(39, 45):
                sub(b, f"f{i}", f"fleet/{i}/+")
            assert await settle(lambda: synced(ms))
            assert ms.freezes == 1 and ms._frozen_filters == 46
            fleet = b.sessions["f44"]
            assert not any(o is fleet for o in gc.get_objects())
            for i in range(30):
                b.unsubscribe(f"f{i}", f"fleet/{i}/+")
                sub(b, f"g{i}", f"churn/{i}/+")
                assert await settle(lambda: synced(ms))
            late = b.sessions["g29"]
            assert ms.freezes == 1
            assert any(o is late for o in gc.get_objects())
        finally:
            await ms.stop()
    run(main())


def test_prefetch_keeps_an_answer_given_before_its_timer(caplog):
    """A round of a saturated loop outlasts the timeout: the batch loop
    answers at the start of the next round, before that round's due
    timers, while the waiter resumes a round later.  ``wait_for`` (the
    reference's) then cancels the answered waiter; the port keeps the
    answer.  An answer that comes after the timer ran is expired."""
    async def late_round(fut, answer, gap):
        loop = asyncio.get_running_loop()

        def round_of_work():        # the rest of the round, past the timer
            time.sleep(gap)
            loop.call_soon(answer, fut)   # the batch loop, next round
        loop.call_soon(round_of_work)

    def give(fut):
        if not fut.done():
            fut.set_result(None)

    async def main():
        loop = asyncio.get_running_loop()
        # the reference's wait: the answer is lost
        fut = loop.create_future()
        waiter = asyncio.ensure_future(asyncio.wait_for(fut, 0.05))
        await asyncio.sleep(0)
        await late_round(fut, give, 0.1)
        with pytest.raises(asyncio.TimeoutError):
            await waiter
        assert fut.done()
        # the port's: kept, and nothing logged
        fut = loop.create_future()
        waiter = asyncio.ensure_future(match_service._await_answers(
            (fut,), 0.05, "prefetch for %r timed out", "a/b"))
        await asyncio.sleep(0)
        await late_round(fut, give, 0.1)
        await waiter
        assert "timed out" not in caplog.text
        # no answer before the timer: expired, logged, a late answer
        # finds the waiter done
        futs = (loop.create_future(), loop.create_future())
        give(futs[0])
        await match_service._await_answers(
            futs, 0.02, "prefetch_many (%d topics) timed out", 2)
        assert all(f.done() for f in futs)
        give(futs[1])
        assert "prefetch_many (2 topics) timed out" in caplog.text

    with caplog.at_level(logging.DEBUG, logger=LOGGER):
        run(main())


@pytest.mark.parametrize("table", TABLES)
def test_late_wake_syncs_without_a_second_debounce(table):
    """The debounce runs from the first unsynced mutation: when the
    loop was busy past it, the woken sync loop syncs at once instead of
    sleeping another ``debounce_s``."""
    async def main():
        b, ms, _m = await started(table, ["a/+"])
        ms.debounce_s = 0.5
        try:
            sub(b, "x", "late/+")
            time.sleep(0.6)                 # a long round of the loop
            t0 = time.monotonic()
            assert await settle(lambda: synced(ms), timeout=5)
            assert time.monotonic() - t0 < 0.3
            # an idle loop still coalesces for debounce_s
            sub(b, "y", "idle/+")
            t0 = time.monotonic()
            assert await settle(lambda: synced(ms), timeout=5)
            assert time.monotonic() - t0 >= 0.45
        finally:
            await ms.stop()
    run(main())


def test_sync_mutators_raise_with_a_broker():
    ms = MatchService(Broker(), device="cpu")
    for call in (lambda: ms.add("a/+"), lambda: ms.remove("a/+"),
                 lambda: ms.load(["a/+"]), ms.sync):
        with pytest.raises(RuntimeError, match="router is the only source"):
            call()
    with pytest.raises(RuntimeError, match="broker"):
        run(MatchService(device="cpu").start())


# -- (e) the autotuner and the auto backend ---------------------------------

def test_autotuner_picks_equal_reference():
    port, ref = BackendAutotuner(), RefAutotuner()
    for args, be in [((64, 16, 1024, 64), "join"),
                     ((64, 16, 2048, 64), "join"),
                     ((128, 16, 1024, 64), "hash"),
                     ((128, 16, 1024, 128), "join"),
                     ((64, 4, 1024, 64), "hash")]:
        sig = port.sig(*args)
        assert sig == ref.sig(*args)
        assert port.family(sig) == ref.family(sig)
        port.record(sig, be, {"hash": 1e-3, "join": 2e-3})
        ref.record(sig, be, {"hash": 1e-3, "join": 2e-3})
    for b in (64, 128, 256):
        for d in (4, 16):
            for s in (1024, 4096):
                for hb in (64, 256):
                    assert port.pick_for(b, d, s, hb) == \
                        ref.pick_for(b, d, s, hb), (b, d, s, hb)
    assert port.family_hits == ref.family_hits > 0
    assert port.pick_for(128, 16, 4096, 256) is None   # split family
    assert port.info()["picks"] == ref.info()["picks"]


def test_autotuner_file_round_trip_and_corrupt_rejected(tmp_path):
    port = BackendAutotuner(path=str(tmp_path / "port.json"))
    port.record(port.sig(64, 16, 1024, 64), "join", {"join": 1e-4})
    port.record(port.sig(64, 4, 1024, 64), "hash")
    assert RefAutotuner(path=str(tmp_path / "port.json")).picks == port.picks
    ref = RefAutotuner(path=str(tmp_path / "ref.json"))
    ref.record(ref.sig(256, 16, 2048, 128), "join", {"hash": 2e-4})
    back = BackendAutotuner(path=str(tmp_path / "ref.json"))
    assert back.picks == ref.picks and not back.rejected
    assert back.measured == ref.measured
    doc = json.loads((tmp_path / "port.json").read_text())
    doc["picks"][port.sig(64, 4, 1024, 64)] = "join"   # checksum now wrong
    (tmp_path / "bad.json").write_text(json.dumps(doc))
    for cls in (BackendAutotuner, RefAutotuner):
        t = cls(path=str(tmp_path / "bad.json"))
        assert t.rejected and t.picks == {}


def test_autotuner_takes_a_runners_own_time():
    """A runner that times itself (CUDA events on the card) gives the
    time recorded, not the host clock around it; warm-up calls do not
    count."""
    t = BackendAutotuner(reps=2)
    took = {"hash": iter([9.0, 3e-5, 4e-5]), "join": iter([9.0, 5e-5, 2e-5])}
    sig = t.sig(64, 8, 1024, 64)
    assert t.measure(sig, {k: (lambda it=it: next(it))
                           for k, it in took.items()}) == "join"
    assert t.measured[sig] == {"hash": 30.0, "join": 20.0}
    assert t.pick(sig) == "join"


@pytest.mark.parametrize("table", TABLES)
def test_auto_routes_a_recorded_pick_to_join(table):
    flts = ["a/+", "a/#", "+/b", "s/+/u/#", "x/y"]
    topics = ["a/b", "q/b", "s/t/u/v", "x/y", "none/at/all"]

    async def main():
        b, ms, m = await started(table, flts, backend="auto")
        try:
            assert ms.dev.join_enabled
            s, hb, _ = ms.inc.shape_key()
            ms.tuner.record(ms.tuner.sig(64, 8, s, hb), "join")
            await asyncio.gather(*[ms.prefetch(t) for t in topics])
            assert ms.dispatches == ms.join_dispatches == 1
            assert m.get("tpu.match.backend_join_dispatches") == 1
            for t in topics:
                assert routes(ms.hint_routes(t)) == \
                    routes(b.router.match_routes(t)), t
            assert ms.autotune_launches == 0      # nothing to measure
        finally:
            await ms.stop()
    run(main())


@pytest.mark.parametrize("table", TABLES)
def test_auto_serves_hash_then_measures_an_unmeasured_shape(table):
    flts = ["a/+", "a/#", "+/b"]

    async def main():
        b, ms, m = await started(table, flts, backend="auto",
                                 autotune_reps=2)
        try:
            await asyncio.gather(*[ms.prefetch(t) for t in ("a/1", "q/b")])
            assert ms.join_dispatches == 0       # unmeasured: hash
            # measured on the loop after the batch, once its waiters had
            # their hints
            assert ms._tune_queue == []
            s, hb, _ = ms.inc.shape_key()
            sig = ms.tuner.sig(64, 8, s, hb)
            pick = ms.tuner.pick(sig)
            assert pick in ("hash", "join")
            assert set(ms.tuner.measured[sig]) == {"hash", "join"}
            assert ms.autotune_launches == 2 * (1 + 2)
            assert m.get("tpu.match.autotune_picks") == 1
            await asyncio.gather(*[ms.prefetch(t) for t in ("a/2", "z/b")])
            assert ms.join_dispatches == (1 if pick == "join" else 0)
            assert ms.autotune_launches == 2 * (1 + 2)   # measured once
            for t in ("a/1", "q/b", "a/2", "z/b"):
                assert routes(ms.hint_routes(t)) == \
                    routes(b.router.match_routes(t)), t
        finally:
            await ms.stop()
    run(main())


# -- (f) the encoder lock ----------------------------------------------------

@pytest.mark.parametrize("table", TABLES)
def test_encoder_serialises_concurrent_encodes(table):
    """Threads that share one table's encoder get the serial answers,
    while the owner adds filters with new words; no encode count is
    lost."""
    filters, topics = build_workload(np.random.default_rng(3), 1500, 2048)
    inc = IncrementalNfa(depth=8) if table == "python" else NativeNfa(depth=8)
    for f in filters:
        inc.add(f)
    enc = table_encoder(inc)
    batches = [topics[i:i + 64] for i in range(0, len(topics), 64)]
    want = [enc.encode(bt, 8, batch=64) for bt in batches]
    n0 = enc.native_batches
    errors = []
    rounds = 4

    def work(k):
        try:
            for _ in range(rounds):
                for i in range(k, len(batches), 2):
                    got = enc.encode(batches[i], 8, batch=64)
                    if not all(np.array_equal(a, w)
                               for a, w in zip(got, want[i])):
                        errors.append(i)
        except Exception as e:       # surfaced by the assert below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k % 2,))
                   for k in range(6)]
        for th in threads:
            th.start()
        for i in range(200):                  # the owner's mutations
            inc.add(f"fresh{i}/word{i}/+")
            table_encoder(inc)                 # refreshes a native vocab
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert enc.native_batches - n0 == 6 * rounds * len(batches) // 2
    # the new words reached the encoder
    got = enc.encode(["fresh7/word7/x"], 8, batch=64)[0][0, :2]
    assert got.tolist() == [inc.vocab["fresh7"], inc.vocab["word7"]]


# -- (g) parameters that are not ported, and the repair ---------------------

@pytest.mark.parametrize("name,value", [
    ("multichip", True), ("multichip_tp", 2), ("multichip_native", False),
    ("multichip_ep", True), ("multichip_ep_slack", 3.0),
    ("multichip_ep_micro", 4), ("multichip_degraded", True),
    ("multichip_ep_autotune", True), ("multichip_balance_budget", 8),
    ("multichip_ep_compact", True)])
def test_unported_parameters_raise(name, value):
    """The multichip plane's parameters, the last left unported, are now
    taken: nothing is refused any more, and the matcher gets the value
    (on a mesh of four CPU devices)."""
    assert not hasattr(match_service, "_UNPORTED")
    kw = {name: value, "device": [torch.device("cpu")] * 4}
    if name != "multichip":
        kw["multichip"] = True
    ms = MatchService(**kw)
    mc = ms.mc
    assert mc is not None and mc.n_devices == 4
    got = {"multichip": True, "multichip_tp": mc.tp,
           "multichip_native": mc.native, "multichip_ep": mc.ep,
           "multichip_ep_slack": mc.ep_slack,
           "multichip_ep_micro": mc.ep_micro_matches,
           "multichip_degraded": mc.degraded,
           "multichip_ep_autotune": mc.ep_autotune,
           "multichip_balance_budget": mc.balance_budget,
           "multichip_ep_compact": mc.ep_compact}[name]
    assert got == value


@pytest.mark.parametrize("name,value", [
    ("deadline", True), ("breaker_threshold", 3),
    ("dispatch_timeout_s", 1.0), ("segments", True),
    ("segments_dir", "seg"), ("compact_interval_s", 1.0),
    ("compact_min_mutations", 7), ("dirty_threshold", 0.25),
    ("prewarm", False), ("deadline_s", 0.02),
    ("breaker_probe_interval_s", 0.5)])
def test_ported_parameters_are_taken(name, value):
    """The deadline plane's and the segments' parameters, once refused,
    are taken as the reference takes them (segments need a directory)."""
    kw = {name: value}
    if name == "segments":
        kw["segments_dir"] = "seg"
    ms = MatchService(device="cpu", **kw)
    assert getattr(ms, name) == value


@pytest.mark.parametrize("name", ["hists", "flightrec", "alarms", "olp"])
def test_node_seams_are_taken(name):
    """The node's seams, once unported parameters, are now taken: the
    histograms and the flight recorder's rings are bound at
    construction, alarms and olp kept for the deadline loop."""
    from emqx_tpu_torch.broker.olp import Olp
    from emqx_tpu_torch.observe.alarm import Alarms
    from emqx_tpu_torch.observe.flightrec import FlightRecorder
    from emqx_tpu_torch.observe.hist import HistSet

    value = {"hists": HistSet("main"), "flightrec": FlightRecorder("trace"),
             "alarms": Alarms(), "olp": Olp()}[name]
    ms = MatchService(device="cpu", **{name: value})
    assert getattr(ms, name) is value
    if name == "hists":
        assert ms._h_wait is value.hist("obs.stage.match_wait")
        assert ms._h_readback is value.hist("obs.stage.match_readback")
    if name == "flightrec":
        assert ms._ring_rb is value.ring("match.readback")


def test_unported_defaults_accepted_and_unknown_rejected():
    ms = MatchService(device="cpu", deadline=False, readback_mode="chunked",
                      hists=None, multichip_tp=0)
    assert ms.backend == "hash"
    with pytest.raises(TypeError, match="no_such_knob"):
        MatchService(device="cpu", no_such_knob=1)


@pytest.mark.parametrize("kind", ["python", "native"])
def test_aid_reuses_counts_as_the_reference(kind):
    """The same add/remove/re-add script, with the device acking epochs,
    counts the same reuses of freed accept ids as the reference's
    table."""
    port = IncrementalNfa(depth=6) if kind == "python" else NativeNfa(depth=6)
    ref = RefIncrementalNfa(depth=6)
    for t in (port, ref):
        t.device_epoch = -1          # a device consumer, nothing acked
    filters = [f"r/{i}/+" for i in range(40)] + [f"s/{i}/#" for i in range(8)]
    rng = np.random.default_rng(9)

    def both(fn):
        assert fn(port) == fn(ref)

    for f in filters:
        both(lambda t: t.add(f))
    gone = [filters[i] for i in rng.choice(len(filters), 20, replace=False)]
    for f in gone[:10]:
        both(lambda t: t.remove(f))
    for f in gone[:5]:                  # not acked yet: fresh ids
        both(lambda t: t.add(f))
    assert port.aid_reuses == ref.aid_reuses == 0
    for t in (port, ref):
        t.device_epoch = t.epoch        # the device applied the removes
    for f in gone[5:10] + gone[10:15]:
        if f in gone[10:15]:
            both(lambda t: t.remove(f))
        else:
            both(lambda t: t.add(f))
    both(lambda t: t.add("late/+"))
    assert port.aid_reuses == ref.aid_reuses > 0
    for f in filters + ["late/+"]:
        both(lambda t: t.aid_of(f))
