"""The multichip serve backend wired into the port's ``MatchService`` and
``BrokerNode`` (``match.multichip.*``), on a mesh of CPU devices.

* The scripted broker of ``tests/test_torch_serve_loop.py`` on the
  reference's service (JAX on the eight virtual CPU devices) and on the
  port's (``device=[cpu] * 8``), both with the multichip backend: every
  hint, rule id and ``tpu.match.*`` counter equal, every batch served
  through the mesh.
* Each node case of ``tests/test_multichip_serve.py`` on the port's node
  (``BrokerNode(device=[cpu] * 8)``, the port's MQTT client over
  ``127.0.0.1:0``): serving through the mesh, then a shard kill with
  delivery held; the ``match.shard`` fault; the compaction swap
  repartitioning; flag off byte-identical (no matcher is built); the EP
  routed node; a kill racing the swap, then re-admission; a failing
  canary holding the shard out.
* Every multichip option at once, on both host tables; the pipelined
  and deadline serve loops through the mesh; the synchronous core; the
  probe riding the mesh.
"""

import asyncio
import gc
import json
import os

import numpy as np
import pytest
import torch

import test_torch_serve_loop as serve_loop
from emqx_tpu.broker.broker import Broker as RefBroker
from emqx_tpu.broker.match_service import MatchService as RefMatchService
from emqx_tpu.observe.metrics import Metrics as RefMetrics
from emqx_tpu_torch import faultinject as fi
from emqx_tpu_torch import topic as T
from emqx_tpu_torch.broker import match_service
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.match_service import MatchService
from emqx_tpu_torch.broker.trie import FilterTrie
from emqx_tpu_torch.client import Client
from emqx_tpu_torch.config import Config
from emqx_tpu_torch.node import BrokerNode
from emqx_tpu_torch.observe import Metrics

CPU = torch.device("cpu")
MESH = [CPU] * 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    yield
    fi.uninstall()
    gc.unfreeze()


def run(coro, limit=120.0):
    """Run ``coro`` under a time limit of its own."""
    return asyncio.run(asyncio.wait_for(coro, limit))


async def settle(pred, timeout=30.0, interval=0.01):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if pred():
            return True
        await asyncio.sleep(interval)
    return pred()


def mesh_synced(ms):
    return (serve_loop.synced(ms) and ms.mc.ready and not ms.mc.dirty)


# -- the scripted broker against the reference's service ----------------------

async def _drive(broker, ms, metrics):
    """``test_torch_serve_loop``'s SCRIPT, with each sync waiting for
    the mesh too; every hint must equal the router's answer."""
    obs = []
    for step in serve_loop.SCRIPT:
        kind = step[0]
        if kind == "sync":
            assert await settle(lambda: mesh_synced(ms), 120), step
            obs.append((kind, {k: metrics.get(k)
                               for k in serve_loop.COUNTERS}))
            continue
        if kind in ("serve", "bypass"):
            ms.bypass_rate = 1e9 if kind == "bypass" else 0
            await asyncio.gather(*[ms.prefetch(t) for t in step[1]])
            ms.bypass_rate = 0
            obs.append((kind, {k: metrics.get(k)
                               for k in serve_loop.COUNTERS}))
            continue
        if kind == "sub":
            serve_loop.sub(broker, step[1], step[2])
        elif kind == "unsub":
            broker.unsubscribe(step[1], step[2])
        elif kind == "rule":
            ms.register_rule(step[1], step[2])
        elif kind == "unrule":
            ms.unregister_rule(step[1])
        else:
            for t in step[1]:
                got = (t, ms.hint_available(t), ms.hint_rules(t),
                       serve_loop.routes(ms.hint_routes(t)))
                if got[3] is not None:
                    assert got[3] == serve_loop.routes(
                        broker.router.match_routes(t)), t
                obs.append(got)
        obs.append((kind, {k: metrics.get(k) for k in serve_loop.COUNTERS}))
    return obs


@pytest.mark.parametrize("ep", [False, True], ids=["replicated", "routed"])
def test_hints_and_counters_equal_reference_through_the_mesh(ep):
    """One script on both services with the multichip backend on: hints,
    rule ids and counters equal, each served batch through the mesh."""
    # the reference compiles each new step shape on first use: no
    # waiter may give up meanwhile
    kw = dict(depth=8, bypass_rate=0, debounce_s=0.01, active_slots=8,
              max_matches=32, hint_cap=12, multichip=True, multichip_ep=ep,
              multichip_ep_slack=4.0, prefetch_timeout_s=60.0)

    async def ref():
        import jax

        b = RefBroker()
        m = RefMetrics()
        ms = RefMatchService(b, m, table="python", **kw)
        await ms.start()
        try:
            assert ms.mc.n_devices == len(jax.devices()) == 8
            b.device_match = ms.hint_routes
            got = await _drive(b, ms, m)
            # every served batch went through the mesh
            assert ms.mc.dispatches >= m.get("tpu.match.batches") > 0
            return got
        finally:
            await ms.stop()

    async def port():
        b = Broker()
        m = Metrics()
        ms = MatchService(b, m, table="python", device=MESH, **kw)
        await ms.start()
        try:
            b.device_match = ms.hint_routes
            assert await settle(lambda: mesh_synced(ms))
            s0 = m.get("tpu.match.shard_dispatches")   # the warm-up's
            got = await _drive(b, ms, m)
            assert m.get("tpu.match.shard_dispatches") - s0 \
                == ms.dispatches > 0
            assert m.get("tpu.match.shard_devices") == 8
            if ep:
                assert m.get("tpu.match.ep_dispatches") > 0
            return got
        finally:
            await ms.stop()

    want = run(ref(), 300)
    got = run(port())
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, (i, a, b)


# -- the node ------------------------------------------------------------------

def make_node(device=MESH, **extra):
    cfg = Config(file_text='listeners.tcp.default.bind = "127.0.0.1:0"\n',
                 env={})
    cfg.put("tpu.enable", True)
    cfg.put("tpu.mirror_refresh_interval", 0.01)
    cfg.put("tpu.bypass_rate", 0.0)
    # eight plain walks a batch on a shared CPU: no waiter gives up
    cfg.put("tpu.prefetch_timeout", 10.0)
    cfg.put("match.multichip.enable", True)
    for k, v in extra.items():
        cfg.put(k, v)
    return BrokerNode(cfg, device=device)


async def _delivery_with_kill(node, victim):
    """Four subscribers, 20 publishes through the mesh, a shard kill, 20
    more: every delivery arrives both times."""
    ms = node.match_service
    port = node.listeners.all()[0].port
    subs, filters = [], []
    for i in range(4):
        c = Client(clientid=f"s{i}", port=port)
        await c.connect()
        flt = f"room/+/kind{i % 2}"
        await c.subscribe(flt, qos=0)
        subs.append(c)
        filters.append(flt)
    assert await settle(lambda: mesh_synced(ms))
    d0 = ms.mc.dispatches
    pub = Client(clientid="p", port=port)
    await pub.connect()
    topics = [f"room/{i}/kind{i % 2}" for i in range(20)]
    for t in topics:
        await pub.publish(t, b"x", qos=0)
    want = sum(1 for t in topics for f in filters if T.match(t, f))
    assert await settle(lambda: sum(s.messages.qsize() for s in subs)
                        >= want)
    m = node.observed.metrics
    assert ms.mc.dispatches > d0, "batches did not ride the mesh"
    assert m.get("tpu.match.shard_dispatches") >= 1
    assert m.get("tpu.match.shard_devices") == 8
    assert m.get("tpu.match.batches") >= 1
    ms.mc.kill_shard(victim)
    topics2 = [f"room/{100 + i}/kind{i % 2}" for i in range(20)]
    for t in topics2:
        await pub.publish(t, b"y", qos=0)
    want2 = want + sum(1 for t in topics2 for f in filters if T.match(t, f))
    assert await settle(lambda: sum(s.messages.qsize() for s in subs)
                        >= want2)
    await asyncio.sleep(0.05)
    assert sum(s.messages.qsize() for s in subs) == want2
    assert m.get("tpu.match.shard_failover") >= 1
    assert ms.info()["multichip"]["dead_shards"] == [victim]
    for s in subs:
        await s.disconnect()
    await pub.disconnect()


def test_node_multichip_serves_then_shard_kill_holds_delivery():
    async def main():
        node = make_node()
        await node.start()
        try:
            ms = node.match_service
            assert ms.mc is not None and ms.mc.n_devices == 8
            assert ms.mc.mesh.devices == [[CPU] * 4, [CPU] * 4]
            await _delivery_with_kill(node, 1)
        finally:
            await node.stop()
    run(main())


def test_node_ep_routed_serves_and_shard_kill_holds_delivery():
    async def main():
        node = make_node(**{"match.multichip.ep.enable": True})
        await node.start()
        try:
            ms = node.match_service
            assert ms.mc is not None and ms.mc.ep
            await _delivery_with_kill(node, 2)
            m = node.observed.metrics
            assert m.get("tpu.match.ep_dispatches") >= 1
            assert m.get("tpu.match.ep_shard_width") >= 1
        finally:
            await node.stop()
    run(main())


def test_node_match_shard_fault_failover_and_recovery():
    async def main():
        node = make_node()
        await node.start()
        ms = node.match_service
        try:
            b = node.broker
            b.open_session("c1")
            b.subscribe("c1", "f/+")
            assert await settle(lambda: mesh_synced(ms))
            inj = fi.install(fi.FaultInjector([
                {"point": "match.shard", "action": "raise", "times": 2}]))
            await ms.prefetch("f/one")
            assert inj.fired.get("match.shard", 0) >= 1
            assert ms.hint_routes("f/one") is None    # the host trie
            assert node.observed.metrics.get(
                "tpu.match.shard_failover") >= 1
            fi.uninstall()
            d0 = ms.mc.dispatches
            await ms.prefetch("f/two")
            assert await settle(lambda: ms.mc.dispatches > d0)
            assert ms.hint_routes("f/two") is not None
        finally:
            await node.stop()
    run(main())


def test_compaction_swap_repartitions_and_serves(tmp_path):
    async def main():
        seg = str(tmp_path)
        node = make_node(**{
            "match.segments.enable": True, "match.segments.dir": seg,
            "match.segments.compact_interval": 0.2,
            "match.segments.compact_min_mutations": 1})
        await node.start()
        ms = node.match_service
        try:
            b = node.broker
            b.open_session("c1")
            for i in range(8):
                b.subscribe("c1", f"swap/{i}/+")
            assert await settle(lambda: mesh_synced(ms))
            gen0 = ms.mc.gen
            assert await settle(lambda: ms._table_gen >= 1)
            assert await settle(lambda: ms.mc.ready and ms.mc.gen > gen0)
            d0 = ms.mc.dispatches
            await ms.prefetch("swap/3/x")
            assert ms.mc.dispatches > d0
            routes = ms.hint_routes("swap/3/x")
            assert routes is not None and [r.filter for r in routes] == \
                ["swap/3/+"]
            man = os.path.join(seg, "multichip", "manifest.json")
            assert await settle(lambda: os.path.exists(man))
            with open(man) as f:
                assert json.load(f)["tp"] == ms.mc.tp
        finally:
            await node.stop()
    run(main())


def test_flag_off_is_byte_identical_single_chip_path(monkeypatch):
    """Flag off: no matcher is built (spy), batches serve through the
    single-device table, and the shard metrics stay zero."""
    calls = []
    real = match_service.MultichipMatcher

    class Spy(real):
        def __init__(self, *a, **kw):
            calls.append(1)
            super().__init__(*a, **kw)

    monkeypatch.setattr(match_service, "MultichipMatcher", Spy)

    async def main():
        cfg = Config(file_text='listeners.tcp.default.bind = '
                     '"127.0.0.1:0"\n', env={})
        cfg.put("tpu.enable", True)
        cfg.put("tpu.mirror_refresh_interval", 0.01)
        cfg.put("tpu.bypass_rate", 0.0)
        node = BrokerNode(cfg, device=MESH)
        await node.start()
        ms = node.match_service
        try:
            assert ms.mc is None and ms.mesh_info() is None
            b = node.broker
            b.open_session("c1")
            b.subscribe("c1", "off/+")
            assert await settle(lambda: serve_loop.synced(ms))
            await ms.prefetch("off/x")
            assert ms.hint_routes("off/x") is not None
            m = node.observed.metrics
            assert m.get("tpu.match.batches") >= 1
            assert m.get("tpu.match.shard_dispatches") == 0
            assert m.get("tpu.match.shard_devices") == 0
            assert not calls
            assert ms.info()["multichip"] is None
        finally:
            await node.stop()
    run(main())
    assert not calls


def test_node_shard_kill_races_compaction_swap_then_readmits(tmp_path):
    async def main():
        node = make_node(**{
            "match.segments.enable": True,
            "match.segments.dir": str(tmp_path),
            "match.segments.compact_interval": 0.2,
            "match.segments.compact_min_mutations": 1,
            "match.multichip.degraded.enable": True,
            "supervisor.backoff_base": 0.005,
            "supervisor.backoff_max": 0.05})
        await node.start()
        ms = node.match_service
        try:
            assert ms.mc.degraded
            b = node.broker
            b.open_session("c1")
            for i in range(8):
                b.subscribe("c1", f"swap/{i}/+")
            assert await settle(lambda: mesh_synced(ms))
            gen0 = ms.mc.gen
            assert await settle(lambda: ms._table_gen >= 1)
            ms.mc.kill_shard(1)
            assert await settle(lambda: ms.mc.ready and ms.mc.gen > gen0)
            assert await settle(lambda: not ms.mc.dead_shards, 60)
            assert ms.mc.rebuilds >= 1
            assert await settle(lambda: not node.observed.alarms.is_active(
                "mesh_degraded"))
            await ms.prefetch("swap/3/x")
            assert ms.hint_routes("swap/3/x") is not None
            assert node.observed.metrics.get("tpu.mesh.state") == 0
        finally:
            await node.stop()
    run(main())


def test_node_canary_failure_blocks_readmit_until_parity():
    async def main():
        node = make_node(**{
            "match.multichip.degraded.enable": True,
            "supervisor.backoff_base": 0.005,
            "supervisor.backoff_max": 0.05})
        await node.start()
        ms = node.match_service
        try:
            b = node.broker
            b.open_session("c1")
            for i in range(6):
                b.subscribe("c1", f"cn/{i}/+")
            assert await settle(lambda: mesh_synced(ms))

            async def failing(t):
                return False

            ms._mesh_canary = failing
            ms.mc.kill_shard(0)
            await ms.prefetch("cn/0/x")
            m = node.observed.metrics
            assert await settle(
                lambda: m.get("tpu.mesh.readmit_canary_fails") >= 2)
            assert ms.mc.dead_shards == [0]
            assert node.observed.alarms.is_active("mesh_degraded")
            info = ms.mesh_info()
            assert info["alarmed"] and info["rebuilding"]
            del ms._mesh_canary
            assert await settle(lambda: not ms.mc.dead_shards, 60)
            assert await settle(lambda: not node.observed.alarms.is_active(
                "mesh_degraded"))
            assert ms.mc.readmit_canary_fails >= 2
            assert ms.mc.rebuilds >= 1
        finally:
            await node.stop()
    run(main())


# -- the service's serve paths through the mesh --------------------------------

FILTERS = ["a/+", "a/#", "+/b", "#", "x/y/z", "x/+/z", "$SYS/#",
           "rooms/+/temp", "rooms/1/#", "b/c", "deep/+/q/+", "m/n",
           "deep/a/b/c/d/e/f/g/h/+"]


def topics_for(n, seed=7):
    rng = np.random.default_rng(seed)
    words = ["a", "b", "x", "y", "z", "rooms", "1", "temp", "m", "n",
             "deep", "q", "h"]
    return ["/".join(rng.choice(words, size=rng.integers(1, 6)))
            for _ in range(n)]


async def _serve_and_check(ms, b, topics, rounds=3):
    """Prefetch ``topics`` in ``rounds`` batches; every hint equals the
    router's routes, and every batch went through the mesh."""
    for r in range(rounds):
        part = topics[r::rounds]
        ms._hints.clear()
        d0 = ms.mc.dispatches
        await ms.prefetch_many(part)
        assert ms.mc.dispatches > d0
        for t in part:
            got = ms.hint_routes(t)
            assert got is not None, t
            assert serve_loop.routes(got) == serve_loop.routes(
                b.router.match_routes(t)), t


@pytest.mark.parametrize("table", ["python", "native"])
def test_service_every_multichip_option_serves_on_cpu(table):
    """``MatchService(multichip=True, multichip_tp=4, multichip_ep=True,
    multichip_ep_compact=True, multichip_degraded=True,
    multichip_ep_autotune=True)`` on four CPU devices serves the host's
    routes through the routed compact step, through a churn and a dead
    shard (scoped failover)."""
    async def main():
        b = Broker()
        for i, f in enumerate(FILTERS):
            serve_loop.sub(b, f"c{i}", f)
        m = Metrics()
        ms = MatchService(b, m, device=[CPU] * 4, table=table, depth=8,
                          bypass_rate=0, debounce_s=0.01, multichip=True,
                          multichip_tp=4, multichip_ep=True,
                          multichip_ep_compact=True, multichip_degraded=True,
                          multichip_ep_autotune=True)
        await ms.start()
        try:
            assert (ms.mc.dp, ms.mc.tp) == (1, 4)
            assert await settle(lambda: mesh_synced(ms))
            b.device_match = ms.hint_routes
            topics = topics_for(120) + ["zz/b", "$SYS/q"]
            await _serve_and_check(ms, b, topics)
            assert m.get("tpu.match.ep_dispatches") > 0
            for i in range(30):
                serve_loop.sub(b, f"n{i}", f"h/{i}/+")
            b.unsubscribe("c0", "a/+")
            assert await settle(lambda: mesh_synced(ms))
            await _serve_and_check(ms, b, topics + [f"h/{i}/q"
                                                    for i in range(30)])
            ms.mc.kill_shard(2)
            await _serve_and_check(ms, b, topics)
            assert m.get("tpu.mesh.degraded_batches") > 0
            assert ms.info()["multichip"]["mesh_state"] == "degraded"
        finally:
            await ms.stop()
    run(main())


@pytest.mark.parametrize("mode", ["pipeline", "deadline",
                                  "deadline_pipeline", "ragged"])
def test_pipelined_and_deadline_loops_serve_through_the_mesh(mode):
    """The overlapped pipeline's slots, the deadline loop's timed
    dispatches and the two-phase readback mode all read mesh dispatches
    through their events; hints equal the router's, and the readback
    bytes are the mesh's."""
    kw = {"pipeline": {"pipeline": True},
          "deadline": {"deadline": True},
          "deadline_pipeline": {"deadline": True, "pipeline": True},
          "ragged": {"readback_mode": "ragged"}}[mode]

    async def main():
        b = Broker()
        for i, f in enumerate(FILTERS):
            serve_loop.sub(b, f"c{i}", f)
        m = Metrics()
        ms = MatchService(b, m, device=MESH, table="python", depth=8,
                          bypass_rate=0, debounce_s=0.01, multichip=True,
                          dispatch_timeout_s=30.0, prefetch_timeout_s=30.0,
                          **kw)
        await ms.start()
        try:
            assert await settle(lambda: mesh_synced(ms))
            b.device_match = ms.hint_routes
            s0 = m.get("tpu.match.shard_dispatches")
            await _serve_and_check(ms, b, topics_for(90))
            assert m.get("tpu.match.readback_bytes") > 0
            assert m.get("tpu.match.shard_dispatches") - s0 == ms.dispatches
            assert ms.info()["pipeline_inflight"] == 0
        finally:
            await ms.stop()
    run(main())


def test_probe_rides_the_mesh():
    """With the deadline breaker open, the recovery probe goes through
    the mesh: a dead shard keeps it failing (flag off: the whole plane
    refuses), a revived one closes the breaker."""
    async def main():
        b = Broker()
        serve_loop.sub(b, "c0", "p/+")
        m = Metrics()
        ms = MatchService(b, m, device=[CPU] * 4, table="python", depth=8,
                          bypass_rate=0, debounce_s=0.01, multichip=True,
                          deadline=True, breaker_threshold=2,
                          breaker_probe_interval_s=0.02,
                          dispatch_timeout_s=30.0)
        await ms.start()
        try:
            assert await settle(lambda: mesh_synced(ms))
            ms.mc.kill_shard(1)
            for i in range(3):
                await ms.prefetch(f"p/{i}")
            assert await settle(lambda: ms._breaker_open)
            f0 = ms.mc.failovers
            assert await settle(lambda: ms.mc.failovers >= f0 + 2)
            assert ms._breaker_open
            d0 = ms.mc.dispatches
            ms.mc.revive_shard(1)
            assert await settle(lambda: not ms._breaker_open)
            assert ms.mc.dispatches > d0
        finally:
            await ms.stop()
    run(main())


def test_sync_core_serves_through_the_mesh():
    """The synchronous core (no broker): ``load``, ``add``, ``remove``
    and ``sync`` keep the partition, and ``serve`` walks the mesh."""
    ms = MatchService(device=[CPU] * 4, table="native", depth=8,
                      multichip=True)
    flts = FILTERS[:-1] + [f"s/{i}/+" for i in range(50)]
    assert ms.load(flts) == len(flts)
    assert ms.sync()
    assert ms.mc.ready
    ms.add("late/+/x")
    ms.remove("a/+")
    assert ms.sync()
    trie = FilterTrie()
    for f in flts + ["late/+/x"]:
        if f != "a/+":
            trie.insert(f)
    topics = topics_for(60) + ["late/q/x", "s/7/z"]
    d0 = ms.mc.dispatches
    got = ms.serve(topics)
    assert ms.mc.dispatches > d0
    for t, fl in zip(topics, got):
        assert sorted(fl) == sorted(trie.match(t)), t
