"""The port's deadline serve plane (``MatchService(deadline=True)``) on
the CPU, held to the reference's.

* each case of ``tests/test_match_deadline.py`` on the port's
  ``BrokerNode`` (``device="cpu"``, the plain walks): the olp brownout
  ladder (the port's ``Olp`` and the reference's on the same reports),
  the deadline loop serving with parity, the partial dispatch a budget
  forces out, the adaptive bound and the lane caps, a hung dispatch
  answered by the host within the dispatch timeout, the breaker's trip,
  probe and recovery, the brownout's QoS0 shed and full host serve, the
  loop's death failing its waiters over (both loops), a failed warm-up
  that the retry heals, the loop off by default, the split estimate;
* ``_deadline_bound``, ``_lane_caps`` and ``_pop_batch`` equal the
  reference's methods on seeded states (rates, estimates, short
  shares, brownout stages, queues);
* one scripted broker drives the reference ``MatchService`` (JAX on the
  CPU, Python table) and the port's on both host tables with
  ``deadline=True``: the hints and the ``broker.match.*`` and
  ``tpu.match.*`` counters must be equal (``deadline_miss`` depends on
  how long a walk takes and is left out).  The arrival-rate window is
  held shut and the rate pinned high on both, so that every serve step
  is one batch the budget forces out.

Every case runs under a time limit of its own (:func:`run`).
"""

import asyncio
import gc
import time

import numpy as np
import pytest
import torch

from emqx_tpu.broker.broker import Broker as RefBroker
from emqx_tpu.broker.match_service import MatchService as RefMatchService
from emqx_tpu.broker.olp import Olp as RefOlp
from emqx_tpu.faultinject import FaultInjector as RefInjector
from emqx_tpu import faultinject as ref_fi
from emqx_tpu.observe.metrics import Metrics as RefMetrics
from emqx_tpu_torch import faultinject as fi
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.match_service import MatchService
from emqx_tpu_torch.broker.olp import Olp
from emqx_tpu_torch.config import Config
from emqx_tpu_torch.node import BrokerNode
from emqx_tpu_torch.observe import Metrics

TABLES = ["python", "native"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    """No injector and an unfrozen heap after each case."""
    yield
    fi.uninstall()
    ref_fi.uninstall()
    gc.unfreeze()


def run(coro, limit=120.0):
    """Run ``coro`` under a time limit of its own."""
    return asyncio.run(asyncio.wait_for(coro, limit))


async def settle(pred, timeout=60.0, interval=0.01):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if pred():
            return True
        await asyncio.sleep(interval)
    return pred()


def make_node(**extra):
    """The reference cases' node, on the port (the plain walks)."""
    cfg = Config(file_text='listeners.tcp.default.bind = "127.0.0.1:0"\n')
    cfg.put("tpu.enable", True)
    cfg.put("tpu.mirror_refresh_interval", 0.01)
    cfg.put("tpu.bypass_rate", 0.0)
    cfg.put("match.deadline.enable", True)
    cfg.put("match.deadline_ms", 60.0)
    cfg.put("match.breaker.threshold", 3)
    cfg.put("match.breaker.probe_interval", 0.05)
    cfg.put("supervisor.backoff_base", 0.005)
    cfg.put("supervisor.backoff_max", 0.05)
    for k, v in extra.items():
        cfg.put(k, v)
    return BrokerNode(cfg, device="cpu")


def sub(b, cid, flt):
    if cid not in b.sessions:
        b.open_session(cid)
    b.subscribe(cid, flt)


def ms_synced(node):
    ms = node.match_service
    return (ms is not None and ms.ready
            and ms._seen_epoch == node.broker.router.epoch
            and ms.dev.epoch == ms.inc.epoch)


def routes(rs):
    return None if rs is None else sorted((r.filter, repr(r.dest))
                                          for r in rs)


class FakeOlp:
    lvl = 0

    def brownout_level(self, now=None):
        return self.lvl


# -- the olp brownout ladder (injected clock) --------------------------------

def _ladder(olp_cls):
    o = olp_cls(max_queue_depth=10, cooloff=1.0)
    out = [o.brownout_level(now=0.0)]
    for depth, now, at in ((100, 0.0, 0.0), (100, 0.9, 1.1), (100, 1.9, 2.1),
                           (100, 2.9, 3.5), (0, 4.5, 4.5)):
        o.report(queue_depth=depth, now=now)
        out.append(o.brownout_level(now=at))
    return out


def test_olp_brownout_ladder_escalates_and_recovers():
    got = _ladder(Olp)
    assert got == _ladder(RefOlp) == [0, 1, 2, 3, 3, 0]


def test_olp_brownout_new_episode_resets_escalation():
    def episode(olp_cls):
        o = olp_cls(max_queue_depth=10, cooloff=1.0)
        o.report(queue_depth=100, now=0.0)
        o.report(queue_depth=100, now=0.9)
        first = o.brownout_level(now=1.0)
        o.report(queue_depth=100, now=5.0)     # after a silent gap
        return first, o.brownout_level(now=5.0)
    assert episode(Olp) == episode(RefOlp) == (2, 1)


# -- the deadline loop: parity, partial dispatch, the bound and the caps -----

@pytest.mark.parametrize("deadline", [True, False])
def test_deadline_loop_serves_with_parity(deadline):
    async def main():
        node = make_node(**{"match.deadline.enable": deadline})
        await node.start()
        try:
            b = node.broker
            ms = node.match_service
            assert ms.deadline is deadline
            for i in range(4):
                sub(b, f"s{i}", f"room/+/k{i}")
            assert await settle(lambda: ms_synced(node))
            topics = [f"room/{i}/k{i % 4}" for i in range(24)]
            await asyncio.gather(*[ms.prefetch(t) for t in topics])
            for t in topics:
                hint = ms.hint_routes(t)
                assert hint is not None, t
                assert routes(hint) == routes(b.router.match_routes(t))
            assert node.observed.metrics.get("tpu.match.batches") >= 1
            assert ms.info()["breaker"] == "closed"
            assert ms.info()["deadline"] is deadline
        finally:
            await node.stop()
    run(main())


def test_partial_dispatch_on_budget_expiry():
    """With the bound far above the queue, only the oldest waiter's
    budget flushes the batch: within the budget, not at batch-full."""
    async def main():
        node = make_node(**{"match.deadline_ms": 80.0})
        await node.start()
        try:
            ms = node.match_service
            sub(node.broker, "c1", "a/+")
            assert await settle(lambda: ms_synced(node))
            await ms.prefetch("a/warm")
            ms._rate_ewma = 1e9
            ms._win_start = float("inf")     # the rate window stays shut
            t0 = time.perf_counter()
            await asyncio.gather(*[ms.prefetch(f"a/p{i}") for i in range(3)])
            assert time.perf_counter() - t0 < 0.4
            for i in range(3):
                assert ms.hint_routes(f"a/p{i}") is not None
            assert node.observed.metrics.get(
                "broker.match.deadline_dispatch") >= 1
        finally:
            await node.stop()
    run(main())


def test_adaptive_bound_and_lane_caps():
    async def main():
        node = make_node()
        await node.start()
        try:
            ms = node.match_service
            ms._est_dispatch_s = 0.01
            ms._rate_ewma = 1000.0
            b1 = ms._deadline_bound()
            assert b1 == int(1000.0 * (ms.deadline_s - 0.01))
            ms._rate_ewma = 1e9
            assert ms._deadline_bound() == ms.max_batch
            ms.olp = FakeOlp()
            ms.olp.lvl = 1
            assert ms._deadline_bound() == ms.max_batch >> 1
            ms.olp.lvl = 2
            assert ms._deadline_bound() == ms.max_batch >> 2
            ms.olp = None
            ms._short_frac = 0.5
            short_cap, long_cap = ms._lane_caps(8)
            assert 1 <= short_cap <= 8 and 1 <= long_cap <= 8
            loop = asyncio.get_running_loop()
            deep = [(f"a/b/c/d/e/f{i}", loop.create_future(),
                     loop.time() + 1.0) for i in range(10)]
            shallow = [(f"s{i}", loop.create_future(), loop.time() + 1.0)
                       for i in range(4)]
            order = [p[0] for p in deep + shallow]
            ms._pending = deep + shallow
            batch = ms._pop_batch(8)
            assert any(t.count("/") < ms.short_depth for t, _f, _d in batch)
            left = [p[0] for p in ms._pending]
            assert left == sorted(left, key=order.index)
            for p in ms._pending:
                p[1].cancel()
            ms._pending = []
        finally:
            await node.stop()
    run(main())


# -- the failure ladder -------------------------------------------------------

def test_dispatch_hang_times_out_to_cpu_fallback():
    """A hung dispatch costs one dispatch timeout: the host tables answer
    the batch (hints minted, parity), and the failure counts toward the
    breaker."""
    async def main():
        node = make_node()
        await node.start()
        try:
            b = node.broker
            ms = node.match_service
            sub(b, "c1", "a/+")
            assert await settle(lambda: ms_synced(node))
            await ms.prefetch("a/warm")
            fi.install(fi.FaultInjector([
                {"point": "match.dispatch", "action": "hang", "times": 1}]))
            t0 = time.perf_counter()
            await ms.prefetch("a/hung")
            assert time.perf_counter() - t0 < ms.prefetch_timeout_s * 0.9
            hint = ms.hint_routes("a/hung")
            assert hint is not None, "the host minted no hint"
            assert routes(hint) == routes(b.router.match_routes("a/hung"))
            assert node.observed.metrics.get(
                "broker.match.cpu_fallback") >= 1
            assert ms._breaker_failures >= 1
        finally:
            await node.stop()
    run(main())


def test_dispatch_hang_on_the_readback_times_out_too():
    """The port's own seam of a hang: the wait on the readback (a walk
    that does not return) is under the same timeout, and what the batch
    owns is kept until it completes."""
    async def main():
        node = make_node()
        await node.start()
        try:
            b = node.broker
            ms = node.match_service
            sub(b, "c1", "a/+")
            assert await settle(lambda: ms_synced(node))
            await ms.prefetch("a/warm")
            fi.install(fi.FaultInjector([
                {"point": "match.readback", "action": "hang", "times": 1}]))
            t0 = time.perf_counter()
            await ms.prefetch("a/hung")
            assert time.perf_counter() - t0 < ms.prefetch_timeout_s * 0.9
            assert routes(ms.hint_routes("a/hung")) == \
                routes(b.router.match_routes("a/hung"))
            assert ms._breaker_failures == 1
            await ms.prefetch("a/next")         # the device serves again
            assert ms._breaker_failures == 0
            assert ms.hint_routes("a/next") is not None
        finally:
            await node.stop()
    run(main())


def test_breaker_trips_probes_and_recovers():
    async def main():
        node = make_node()
        await node.start()
        try:
            b = node.broker
            ms = node.match_service
            m = node.observed.metrics
            alarms = node.observed.alarms
            sub(b, "c1", "a/+")
            assert await settle(lambda: ms_synced(node))
            await ms.prefetch("a/warm")
            inj = fi.install(fi.FaultInjector([
                {"point": "match.dispatch", "action": "raise", "times": 3}]))
            for i in range(3):
                await ms.prefetch(f"a/f{i}")
                assert ms.hint_routes(f"a/f{i}") is not None
            assert ms._breaker_open
            assert alarms.is_active("match_degraded")
            assert m.get("broker.match.breaker_state") >= 1
            assert node.supervisor.lookup("match.probe") is not None
            t0 = time.perf_counter()
            await ms.prefetch("a/open")
            assert time.perf_counter() - t0 < 0.05
            assert m.get("broker.match.cpu_fallback") >= 4
            assert await settle(lambda: not ms._breaker_open, timeout=15)
            assert not alarms.is_active("match_degraded")
            assert m.get("broker.match.breaker_state") == 0
            assert inj.fired.get("match.dispatch") == 3
            await ms.prefetch("a/back")
            assert ms.hint_routes("a/back") is not None
        finally:
            await node.stop()
    run(main())


def test_brownout_sheds_qos0_then_everything():
    async def main():
        node = make_node()
        await node.start()
        try:
            ms = node.match_service
            m = node.observed.metrics
            sub(node.broker, "c1", "a/+")
            assert await settle(lambda: ms_synced(node))
            ms.olp = FakeOlp()
            ms.olp.lvl = 2
            before = m.get("broker.match.cpu_fallback")
            await ms.prefetch("a/q0", qos=0)
            assert m.get("broker.match.cpu_fallback") == before + 1
            assert ms.hint_routes("a/q0") is None
            await ms.prefetch("a/q1", qos=1)
            assert ms.hint_routes("a/q1") is not None
            assert m.get("broker.match.brownout_level") == 2
            ms.olp.lvl = 3
            t0 = time.perf_counter()
            await ms.prefetch("a/q2", qos=2)
            assert time.perf_counter() - t0 < 0.05
            assert ms.hint_routes("a/q2") is None
            ms.olp.lvl = 0
            await ms.prefetch("a/rec", qos=0)
            assert ms.hint_routes("a/rec") is not None
        finally:
            await node.stop()
    run(main())


def test_brownout_sheds_qos0_of_a_prefetch_many():
    """The fanout's batched prefetch: stage 2 sheds its QoS0 topics by the
    ``{topic: qos}`` mapping, stage 3 sheds them all."""
    async def main():
        node = make_node()
        await node.start()
        try:
            ms = node.match_service
            m = node.observed.metrics
            sub(node.broker, "c1", "a/+")
            assert await settle(lambda: ms_synced(node))
            ms.olp = FakeOlp()
            ms.olp.lvl = 2
            before = m.get("broker.match.cpu_fallback")
            await ms.prefetch_many({"a/m0": 0, "a/m1": 1, "a/m2": 0})
            assert m.get("broker.match.cpu_fallback") == before + 2
            assert ms.hint_routes("a/m0") is None
            assert ms.hint_routes("a/m1") is not None
            ms.olp.lvl = 3
            await ms.prefetch_many({"a/n0": 1, "a/n1": 2})
            assert m.get("broker.match.cpu_fallback") == before + 4
            assert ms.hint_routes("a/n0") is None
        finally:
            await node.stop()
    run(main())


def _kill_failover_body(deadline: bool):
    async def main():
        node = make_node(**{"match.deadline.enable": deadline})
        await node.start()
        try:
            ms = node.match_service
            assert ms.deadline is deadline
            sub(node.broker, "c1", "a/+")
            assert await settle(lambda: ms_synced(node))
            await ms.prefetch("a/warm")
            child = node.supervisor.lookup("match.batch")
            assert child is not None
            task = asyncio.ensure_future(ms.prefetch("a/kill"))
            await asyncio.sleep(0)
            t0 = time.perf_counter()
            assert child.kill()
            await task
            assert time.perf_counter() - t0 < 0.2
            assert node.observed.metrics.get(
                "broker.match.cpu_fallback") >= 1
            assert await settle(lambda: child.alive(), timeout=10)
            assert await settle(lambda: ms_synced(node))
            await ms.prefetch("a/again")
            assert ms.hint_routes("a/again") is not None
            assert node.observed.metrics.get(
                "broker.supervisor.restarts") >= 1
        finally:
            await node.stop()
    run(main())


def test_deadline_loop_death_fails_waiters_over_immediately():
    _kill_failover_body(deadline=True)


def test_legacy_loop_death_fails_waiters_over_immediately():
    _kill_failover_body(deadline=False)


def test_match_compile_fault_host_serves_then_recovers():
    """A failed warm-up rides the sync loop's failure path: the first
    sync fails, the retry a second later heals the mirror (the port's
    node start waits for it: where the reference's node starts serving
    from the host trie, the port's start raises on a service that is
    not ready within ``tpu.start_timeout``)."""
    async def main():
        fi.install(fi.FaultInjector([
            {"point": "match.compile", "action": "raise", "times": 1}]))
        b = Broker()
        ms = MatchService(b, Metrics(), device="cpu", table="python",
                          depth=8, bypass_rate=0, debounce_s=0.01,
                          deadline=True)
        await ms.start()
        try:
            sub(b, "c1", "a/+")
            assert await settle(lambda: ms.sync_error is not None)
            assert await settle(lambda: ms.ready and ms.dev.epoch
                                == ms.inc.epoch, timeout=60)
            assert fi.get().fired.get("match.compile") == 1
            await ms.prefetch("a/x")
            assert ms.hint_routes("a/x") is not None
        finally:
            await ms.stop()
    run(main())


def test_deadline_default_off_keeps_legacy_loop():
    async def main():
        cfg = Config(file_text='listeners.tcp.default.bind = "127.0.0.1:0"\n')
        cfg.put("tpu.enable", True)
        cfg.put("tpu.mirror_refresh_interval", 0.01)
        node = BrokerNode(cfg, device="cpu")
        await node.start()
        try:
            ms = node.match_service
            assert ms.deadline is False
            assert ms.info()["deadline"] is False
            child = node.supervisor.lookup("match.batch")
            assert child.factory.__func__ is MatchService._batch_loop
        finally:
            await node.stop()
    run(main())


# -- the split estimate -------------------------------------------------------

def test_split_estimate_warm_fallback_and_feed():
    async def main():
        node = make_node()
        await node.start()
        try:
            ms = node.match_service
            ms._est_split_samples = 0
            ms._est_dispatch_s = 0.033
            ms._est_disp_s = 0.004
            ms._est_rb_s = 0.002
            assert ms._dispatch_est() == 0.033
            for _ in range(ms.SPLIT_WARM):
                ms._note_split(0.010, 0.005)
            est = ms._dispatch_est()
            assert est == ms._est_disp_s + ms._est_rb_s
            assert 0.003 < ms._est_disp_s < 0.011
            assert 0.001 < ms._est_rb_s < 0.006
            ms._rate_ewma = 1000.0
            assert ms._deadline_bound() == int(1000.0 * (ms.deadline_s - est))
            info = ms.info()
            assert info["est_split_warm"] is True
            assert info["est_disp_ms"] > 0 and info["est_readback_ms"] > 0
        finally:
            await node.stop()
    run(main())


def test_split_estimate_fed_by_real_dispatches():
    async def main():
        node = make_node()
        await node.start()
        try:
            ms = node.match_service
            sub(node.broker, "c1", "a/+")
            assert await settle(lambda: ms_synced(node))
            before = ms._est_split_samples
            for i in range(3):
                await ms.prefetch(f"a/real{i}")
            assert ms._est_split_samples > before
            assert ms._est_disp_s > 0 and ms._est_rb_s > 0
        finally:
            await node.stop()
    run(main())


# -- the loop's methods against the reference's, on seeded states -----------

TOPIC_SHAPES = ["a", "a/b", "a/b/c", "a/b/c/d", "a/b/c/d/e", "a/b/c/d/e/f/g"]


def _seeded_state(seed):
    rng = np.random.default_rng(seed)
    depth = int(rng.choice([4, 8, 16]))
    st = {
        "kw": dict(depth=depth, max_batch=int(rng.choice([64, 512, 2048])),
                   short_depth=int(rng.choice([0, 2, 4, depth])),
                   deadline_s=float(rng.choice([0.005, 0.041, 0.2]))),
        "rate_ewma": None if rng.random() < 0.2 else float(
            rng.choice([0.0, 50.0, 3e3, 1e5, 1e9])),
        "last_rate": float(rng.uniform(0, 1e5)),
        "est_dispatch_s": float(rng.uniform(0.0005, 0.08)),
        "est_disp_s": float(rng.uniform(0.0001, 0.03)),
        "est_rb_s": float(rng.uniform(0.0001, 0.03)),
        "split_samples": int(rng.choice([0, 3, 8, 100])),
        "short_frac": None if rng.random() < 0.2 else float(rng.random()),
        "brownout": int(rng.integers(0, 4)),
        "queue": [TOPIC_SHAPES[int(i)] for i in rng.integers(
            0, len(TOPIC_SHAPES), int(rng.integers(0, 300)))],
    }
    return st


def _apply_state(ms, st):
    ms._rate_ewma = st["rate_ewma"]
    ms._last_rate = st["last_rate"]
    ms._est_dispatch_s = st["est_dispatch_s"]
    ms._est_disp_s = st["est_disp_s"]
    ms._est_rb_s = st["est_rb_s"]
    ms._est_split_samples = st["split_samples"]
    ms._short_frac = st["short_frac"]
    ms.olp = FakeOlp()
    ms.olp.lvl = st["brownout"]
    ms._pending = [(t, i, 1.0 + i) for i, t in enumerate(st["queue"])]


@pytest.mark.parametrize("seed", range(12))
def test_bound_caps_and_pop_equal_reference(seed):
    st = _seeded_state(seed)
    port = MatchService(Broker(), device="cpu", table="python", deadline=True,
                        **st["kw"])
    ref = RefMatchService(RefBroker(), table="python", deadline=True,
                          **st["kw"])
    out = []
    for ms in (port, ref):
        _apply_state(ms, st)
        bound = ms._deadline_bound()
        caps = [ms._lane_caps(b) for b in (1, 7, bound, ms.max_batch)]
        popped = ms._pop_batch(bound)
        again = ms._pop_batch(max(1, bound // 3))
        out.append((bound, caps, popped, again, list(ms._pending),
                    ms._dispatch_est(), ms._last_brownout))
    assert out[0] == out[1]


# -- a scripted broker on both services, deadline=True ------------------------

SCRIPT = (
    [("sub", f"c{i}", f) for i, f in enumerate(
        ["a/+", "a/#", "x/y", "+/b", "$SYS/#", "deep/a/b/c/d/e/f/+/x"])]
    + [("sync",), ("serve", ["a/b", "a/b/c", "x/y", "q/b", "$SYS/x", "none",
                             "deep/a/b/c/d/e/f/q/x"]),
       ("peek", ["a/b", "a/b/c", "x/y", "q/b", "none"]),
       ("rule", "r1", ["a/+", "rule/#"]), ("sync",),
       ("serve", ["a/z", "rule/q", "x/y"]), ("peek", ["a/z", "rule/q"]),
       ("fault", 3), ("serve1", ["f/0/b", "f/1/b", "f/2/b"]),
       ("peek", ["f/0/b", "f/1/b", "f/2/b"]),
       ("serve1", ["open/b"]), ("peek", ["open/b"]),
       ("closed",), ("serve", ["a/back", "q/b"]), ("peek", ["a/back"]),
       ("brown", 2), ("serve_qos", [("a/q0", 0), ("a/q1", 1)]),
       ("peek", ["a/q0", "a/q1"]),
       ("brown", 3), ("serve_qos", [("a/q2", 2)]), ("peek", ["a/q2"]),
       ("brown", 0), ("unsub", "c0", "a/+"), ("sync",),
       ("serve", ["a/b", "a/new", "rule/z"]), ("peek", ["a/b", "a/new"])])

COUNTERS = ["broker.match.cpu_fallback", "broker.match.deadline_dispatch",
            "broker.match.breaker_state", "broker.match.brownout_level",
            "broker.match.pipeline_inflight", "tpu.match.batches",
            "tpu.match.topics", "tpu.match.fallback_host",
            "tpu.match.hint_served", "tpu.match.hint_stale"]


def _synced(ms):
    return (ms.ready and ms._synced_epoch == ms.router.epoch
            and ms._synced_rule_gen == ms._rule_gen
            and ms.dev.epoch == ms.inc.epoch)


def _pin(ms):
    """Hold the rate window shut with the rate high: every serve step is
    one batch, forced out by its budget."""
    ms._rate_ewma = 1e9
    ms._short_frac = 0.5
    ms._win_start = float("inf")


async def _drive(broker, ms, metrics, injector_mod, injector_cls):
    olp = ms.olp = FakeOlp()
    obs = []
    for step in SCRIPT:
        kind = step[0]
        if kind == "sub":
            sub(broker, step[1], step[2])
        elif kind == "unsub":
            broker.unsubscribe(step[1], step[2])
        elif kind == "rule":
            ms.register_rule(step[1], step[2])
        elif kind == "sync":
            assert await settle(lambda: _synced(ms)), step
        elif kind == "serve":
            await asyncio.gather(*[ms.prefetch(t) for t in step[1]])
        elif kind == "serve1":
            for t in step[1]:
                await ms.prefetch(t)
        elif kind == "serve_qos":
            await asyncio.gather(*[ms.prefetch(t, qos=q) for t, q in step[1]])
        elif kind == "fault":
            injector_mod.install(injector_cls([
                {"point": "match.dispatch", "action": "raise",
                 "times": step[1]}]))
        elif kind == "closed":
            assert await settle(lambda: not ms._breaker_open, timeout=30)
            injector_mod.uninstall()
        elif kind == "brown":
            olp.lvl = step[1]
        else:
            for t in step[1]:
                got = (t, ms.hint_rules(t), routes(ms.hint_routes(t)))
                if got[2] is not None:
                    assert got[2] == routes(broker.router.match_routes(t)), t
                obs.append(got)
        obs.append((kind, ms._breaker_open,
                    {k: metrics.get(k) for k in COUNTERS}))
    return obs


@pytest.fixture(scope="module")
def reference_deadline_script():
    async def main():
        b = RefBroker()
        m = RefMetrics()
        # the reference's XLA compiles of a new batch shape outlast its
        # default dispatch timeout on the CPU
        ms = RefMatchService(b, m, depth=8, table="python", bypass_rate=0,
                             debounce_s=0.01, deadline=True, deadline_s=0.06,
                             breaker_threshold=3,
                             breaker_probe_interval_s=0.3,
                             dispatch_timeout_s=30.0)
        await ms.start()
        try:
            _pin(ms)
            assert await settle(lambda: _synced(ms), timeout=120)
            b.device_match = ms.hint_routes
            return await _drive(b, ms, m, ref_fi, RefInjector)
        finally:
            ref_fi.uninstall()
            await ms.stop()
    return run(main(), 600)


@pytest.mark.parametrize("table", TABLES)
def test_hints_and_counters_equal_reference(reference_deadline_script, table):
    async def main():
        b = Broker()
        m = Metrics()
        ms = MatchService(b, m, device="cpu", depth=8, table=table,
                          bypass_rate=0, debounce_s=0.01, deadline=True,
                          deadline_s=0.06, breaker_threshold=3,
                          breaker_probe_interval_s=0.3)
        await ms.start()
        try:
            _pin(ms)
            assert await settle(lambda: _synced(ms))
            b.device_match = ms.hint_routes
            return await _drive(b, ms, m, fi, fi.FaultInjector)
        finally:
            await ms.stop()
    got = run(main())
    want = reference_deadline_script
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, (i, a, b)
    last = want[-1][2]
    # the script reached the paths it compares
    assert last["broker.match.cpu_fallback"] > 0
    assert last["broker.match.deadline_dispatch"] > 0
    assert last["tpu.match.hint_served"] > 0


def test_idle_window_short_share_equals_reference():
    """A rate window that closes with no arrival in it sets the short
    share to 0 in both packages (0 short topics of max(1, 0)), so the
    short lane is capped at one topic a batch until later windows move
    the EWMA: a fault of the reference's estimator, kept for parity
    (ROADMAP Queue 3)."""
    port = MatchService(Broker(), device="cpu", table="python", deadline=True)
    ref = RefMatchService(RefBroker(), table="python", deadline=True)
    out = []
    for ms in (port, ref):
        ms._win_start = time.monotonic() - 1.0     # an idle second
        for t in ("a/b", "a/b/c/d/e/f", "x"):
            ms._note_arrival(t)
        out.append((ms._short_frac, ms._win_short, ms._win_count,
                    ms._lane_caps(2048)))
    assert out[0] == out[1] == (0.0, 2, 3, (1, 2048))
