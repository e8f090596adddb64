"""The match cases of ``tests/test_chaos_delivery.py`` on the port's
``BrokerNode`` (``device="cpu"``, the plain walks): each wounds the serve
plane in the middle of a publish storm and holds the invariants the
reference's do.

* the deadline serve loop killed twice mid-storm: every publish is
  delivered once, no waiter waits near the prefetch timeout, the
  supervisor's restart serves from the device again;
* 10% injected ``match.dispatch`` faults: delivery holds, each failed
  batch is answered by the host at once, the tail stays within twice
  the fault-free storm's;
* the breaker: host serving with the ``match_degraded`` alarm while it
  is open, and the probe closing it once the faults run out;
* the pipelined ``match.readback`` child killed twice mid-storm, and
  10% injected readback faults;
* segments: a corrupt segment rejected by its checksum and an injected
  ``table.load`` fault both leave the full rebuild serving; the
  ``table.compact`` child killed mid-swap (the injected ``table.swap``
  fault and a supervised kill) leaves serving unaffected;
* the flight recorder: one well-formed dump at a breaker trip, one at
  each brownout escalation.

Every case runs under a time limit of its own (:func:`run`).
"""

import asyncio
import gc
import glob
import json
import os
import time

import pytest
import torch

from emqx_tpu_torch import faultinject as fi
from emqx_tpu_torch.broker.message import make_message
from emqx_tpu_torch.config import Config
from emqx_tpu_torch.node import BrokerNode


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


def run(coro, limit=180.0):
    """Run ``coro`` under a time limit of its own."""
    return asyncio.run(asyncio.wait_for(coro, limit))


async def until(pred, timeout=30.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred() and loop.time() < deadline:
        await asyncio.sleep(0.002)
    return pred()


async def start_node(**extra):
    cfg = Config(file_text='listeners.tcp.default.bind = "127.0.0.1:0"\n')
    cfg.put("tpu.enable", True)
    cfg.put("tpu.mirror_refresh_interval", 0.01)
    cfg.put("tpu.bypass_rate", 0.0)
    cfg.put("match.deadline.enable", True)
    cfg.put("match.deadline_ms", 50.0)
    cfg.put("match.breaker.threshold", 3)
    cfg.put("match.breaker.probe_interval", 0.05)
    cfg.put("supervisor.backoff_base", 0.005)
    cfg.put("supervisor.backoff_max", 0.05)
    for k, v in extra.items():
        cfg.put(k, v)
    node = BrokerNode(cfg, device="cpu")
    await node.start()
    return node


def collect(node):
    got = []
    b = node.broker
    b.on_deliver = lambda cid, pubs: got.extend(
        bytes(p.msg.payload) for p in pubs)
    b.open_session("sub")
    b.subscribe("sub", "t/#")
    return got


def synced(ms):
    return ms.ready and ms.dev.epoch == ms.inc.epoch


async def storm(node, n, base, kill=None, kill_at=None):
    """Prefetch and publish of ``n`` distinct topics, one at a time (each
    parks a waiter on the serve loop); the seconds each prefetch took.
    ``kill`` (a supervised child's name) is killed after publish
    ``kill_at``."""
    b = node.broker
    ms = node.match_service
    child = node.supervisor.lookup(kill) if kill else None
    waits = []
    for i in range(n):
        topic = f"t/{base + i}/x"
        t0 = time.perf_counter()
        await ms.prefetch(topic)
        waits.append(time.perf_counter() - t0)
        b.publish(make_message("pub", topic, b"%d" % (base + i)))
        if i == kill_at:
            assert child.kill()
    return waits


# -- the deadline serve loop ----------------------------------------------------

def test_chaos_match_batch_kill_midstorm_delivery_holds():
    async def main():
        node = await start_node()
        try:
            ms = node.match_service
            assert ms.deadline
            got = collect(node)
            assert await until(lambda: synced(ms), 60)
            n = 160
            waits = await storm(node, n, 0, "match.batch", 40)
            waits += await storm(node, n, 1000, "match.batch", 90)
            assert sorted(int(x) for x in got) == sorted(
                list(range(n)) + list(range(1000, 1000 + n)))
            assert max(waits) < ms.prefetch_timeout_s * 0.9, max(waits)
            m = node.observed.metrics
            assert m.get("broker.supervisor.restarts") >= 2
            assert await until(lambda: synced(ms))
            await ms.prefetch("t/readback/x")
            assert ms.hint_routes("t/readback/x") is not None
        finally:
            await node.stop()
    run(main())


def test_chaos_match_dispatch_faults_storm_delivery_holds():
    async def main():
        node = await start_node()
        try:
            ms = node.match_service
            got = collect(node)
            assert await until(lambda: synced(ms), 60)
            n = 150
            clean = await storm(node, n, 0)
            inj = fi.install(fi.FaultInjector([
                {"point": "match.dispatch", "action": "raise", "prob": 0.1,
                 "times": 0}], seed=11))
            try:
                wounded = await storm(node, n, 2000)
            finally:
                fi.uninstall()
            assert len(got) == 2 * n and len(set(got)) == 2 * n
            assert inj.fired.get("match.dispatch", 0) >= 1
            assert max(wounded) < ms.prefetch_timeout_s * 0.9
            assert node.observed.metrics.get("broker.match.cpu_fallback") >= 1
            assert max(wounded) <= max(2.0 * max(clean), 0.1), (
                max(clean), max(wounded))
        finally:
            await node.stop()
    run(main())


def test_chaos_match_breaker_cpu_serve_with_alarm_and_recovery():
    async def main():
        node = await start_node()
        try:
            b = node.broker
            ms = node.match_service
            alarms = node.observed.alarms
            got = collect(node)
            assert await until(lambda: synced(ms), 60)
            await ms.prefetch("t/warm/x")
            inj = fi.install(fi.FaultInjector([
                {"point": "match.dispatch", "action": "raise", "times": 3}]))
            try:
                for i in range(3):
                    await ms.prefetch(f"t/f{i}/x")
                assert ms._breaker_open
                assert alarms.is_active("match_degraded")
                for i in range(20):
                    await ms.prefetch(f"t/open{i}/x")
                    b.publish(make_message("pub", f"t/open{i}/x",
                                           b"o%d" % i))
                assert len(got) == 20
                assert await until(lambda: not ms._breaker_open, 15)
                assert not alarms.is_active("match_degraded")
            finally:
                fi.uninstall()
            assert inj.fired.get("match.dispatch") == 3
            await ms.prefetch("t/rec/x")
            assert ms.hint_routes("t/rec/x") is not None
        finally:
            await node.stop()
    run(main())


# -- the pipelined readback child ------------------------------------------------

PIPELINE = {"match.deadline.enable": False, "match.pipeline.enable": True}


def test_chaos_pipeline_readback_kill_midstorm_delivery_holds():
    async def main():
        node = await start_node(**PIPELINE)
        try:
            ms = node.match_service
            assert ms.pipeline
            got = collect(node)
            assert await until(lambda: synced(ms), 60)
            n = 120
            waits = await storm(node, n, 0, "match.readback", 40)
            waits += await storm(node, n, 1000, "match.readback", 70)
            assert sorted(int(x) for x in got) == sorted(
                list(range(n)) + list(range(1000, 1000 + n)))
            assert max(waits) < ms.prefetch_timeout_s * 0.9, max(waits)
            m = node.observed.metrics
            assert m.get("broker.supervisor.restarts") >= 2
            rb0 = m.get("tpu.match.readback_bytes")
            await ms.prefetch("t/after/x")
            assert ms.hint_routes("t/after/x") is not None
            assert await until(lambda: m.get("tpu.match.readback_bytes")
                               > rb0)
            assert ms._inflight_n == 0
        finally:
            await node.stop()
    run(main())


@pytest.mark.parametrize("deadline", [False, True])
def test_chaos_pipeline_injected_readback_faults_delivery_holds(deadline):
    """Also with the deadline loop composed on the pipeline (the
    reference's pair): a failed readback counts toward the breaker."""
    async def main():
        node = await start_node(**{**PIPELINE,
                                   "match.deadline.enable": deadline,
                                   "match.breaker.threshold": 100})
        try:
            ms = node.match_service
            got = collect(node)
            assert await until(lambda: synced(ms), 60)
            n = 150
            clean = await storm(node, n, 0)
            inj = fi.install(fi.FaultInjector([
                {"point": "match.readback", "action": "raise", "prob": 0.1,
                 "times": 0}], seed=19))
            try:
                wounded = await storm(node, n, 2000)
            finally:
                fi.uninstall()
            assert len(got) == 2 * n and len(set(got)) == 2 * n
            assert inj.fired.get("match.readback", 0) >= 1
            assert max(wounded) < ms.prefetch_timeout_s * 0.9
            assert node.observed.metrics.get("broker.match.cpu_fallback") >= 1
            assert max(wounded) <= max(2.0 * max(clean), 0.1), (
                max(clean), max(wounded))
            assert not ms._breaker_open
        finally:
            await node.stop()
    run(main())


# -- segments and compaction ----------------------------------------------------

async def start_segment_node(seg_dir, **extra):
    extra.setdefault("tpu.table", "python")
    extra.setdefault("match.segments.enable", True)
    extra.setdefault("match.segments.dir", str(seg_dir))
    extra.setdefault("match.segments.compact_interval", 0.05)
    extra.setdefault("match.segments.compact_min_mutations", 1)
    return await start_node(**extra)


QUIET = {"match.segments.compact_interval": 30.0,
         "match.segments.compact_min_mutations": 10**9}


async def _write_segment(seg_dir):
    node = await start_segment_node(seg_dir)
    try:
        ms = node.match_service
        assert ms.segments
        node.broker.open_session("sub")
        node.broker.subscribe("sub", "t/#")
        m = node.observed.metrics
        assert await until(lambda: m.get("tpu.table.compact_runs") >= 1)
        return ms._segment_path
    finally:
        await node.stop()


def test_chaos_corrupt_segment_rejected_full_rebuild_serves(tmp_path):
    async def main():
        seg_path = await _write_segment(tmp_path)
        with open(seg_path, "r+b") as f:
            f.seek(300)
            f.write(b"\xde\xad\xbe\xef")
        node = await start_segment_node(tmp_path, **QUIET)
        try:
            ms = node.match_service
            assert not ms._segment_loaded
            got = collect(node)
            assert await until(lambda: ms.ready)
            n = 40
            for i in range(n):
                await ms.prefetch(f"t/{i}/x")
                node.broker.publish(make_message("pub", f"t/{i}/x",
                                                 b"%d" % i))
            assert await until(lambda: len(got) >= n)
            assert len(got) == n
        finally:
            await node.stop()
    run(main())


def test_chaos_injected_table_load_fault_falls_back(tmp_path):
    async def main():
        await _write_segment(tmp_path)
        fi.install(fi.FaultInjector([
            {"point": "table.load", "action": "raise"}]))
        try:
            node = await start_segment_node(tmp_path, **QUIET)
        finally:
            fi.uninstall()
        try:
            ms = node.match_service
            assert not ms._segment_loaded
            node.broker.open_session("sub")
            node.broker.subscribe("sub", "x/+/y")
            assert await until(lambda: ms.ready and ms._synced_epoch
                               == node.broker.router.epoch)
            await ms.prefetch("x/1/y")
            assert ms.hint_routes("x/1/y") is not None
        finally:
            await node.stop()
    run(main())


def test_chaos_compact_killed_midswap_serving_unaffected(tmp_path):
    async def main():
        node = await start_segment_node(tmp_path)
        try:
            ms = node.match_service
            b = node.broker
            m = node.observed.metrics
            got = collect(node)
            assert await until(lambda: ms.ready)
            inj = fi.install(fi.FaultInjector([
                {"point": "table.swap", "action": "raise", "times": 1}]))
            sent = 0
            gen0 = ms._table_gen
            for i in range(40):
                b.subscribe("sub", f"churn/{i}/+")
                await ms.prefetch(f"t/{i}/x")
                b.publish(make_message("pub", f"t/{i}/x", b"%d" % i))
                sent += 1
            assert await until(lambda: ms._table_gen > gen0)
            assert inj.fired.get("table.swap") == 1
            fi.uninstall()
            child = node.supervisor.lookup("table.compact")
            assert child is not None and child.kill()
            gen0 = ms._table_gen
            for i in range(40, 80):
                b.subscribe("sub", f"churn/{i}/+")
                await ms.prefetch(f"t/{i}/x")
                b.publish(make_message("pub", f"t/{i}/x", b"%d" % i))
                sent += 1
            assert await until(lambda: ms._table_gen > gen0)
            assert m.get("broker.supervisor.restarts") >= 1
            assert await until(lambda: len(got) >= sent)
            assert len(got) == sent
            await ms.prefetch("t/5/x")
            hint = ms.hint_routes("t/5/x")
            assert hint is not None
            assert sorted(map(tuple, hint)) == sorted(
                map(tuple, b.router.match_routes("t/5/x")))
        finally:
            await node.stop()
    run(main())


# -- the flight recorder --------------------------------------------------------

def _dumps(node, reason):
    return sorted(glob.glob(os.path.join(
        node.flightrec.out_dir, f"flightrec-{reason}-*.json")))


def _wellformed(path, reason):
    with open(path) as f:
        payload = json.load(f)
    assert payload["reason"] == reason
    slices = [e for e in payload["traceEvents"] if e["ph"] == "X"]
    ts = [e["ts"] for e in slices]
    assert ts == sorted(ts)
    for e in slices:
        assert e["name"] and "dur" in e and "args" in e
    return len(slices)


def test_chaos_breaker_trip_dumps_flightrec_once(tmp_path):
    async def main():
        node = await start_node()
        try:
            ms = node.match_service
            assert ms.flightrec is node.flightrec
            node.flightrec.out_dir = str(tmp_path)
            collect(node)
            assert await until(lambda: synced(ms), 60)
            for i in range(5):
                await ms.prefetch(f"t/warm{i}/x")
            assert _dumps(node, "breaker_trip") == []
            fi.install(fi.FaultInjector([
                {"point": "match.dispatch", "action": "raise", "times": 3}]))
            for i in range(3):
                await ms.prefetch(f"t/f{i}/x")
            assert ms._breaker_open
            files = _dumps(node, "breaker_trip")
            assert len(files) == 1, files
            assert _wellformed(files[0], "breaker_trip") >= 1
            assert node.observed.metrics.get("obs.flightrec.dumps") == 1
            assert await until(lambda: not ms._breaker_open, 15)
            assert len(_dumps(node, "breaker_trip")) == 1
        finally:
            await node.stop()
    run(main())


def test_chaos_brownout_escalation_dumps_flightrec_once(tmp_path):
    async def main():
        node = await start_node(**{"overload_protection.cooloff": 0.2})
        try:
            ms = node.match_service
            olp = node.olp
            node.flightrec.out_dir = str(tmp_path)
            assert _dumps(node, "brownout") == []
            olp.report(queue_depth=10 ** 9)
            assert olp.brownout_level() >= 1
            lvl = ms._brownout()
            assert lvl >= 1
            files = _dumps(node, "brownout")
            assert len(files) == 1, files
            _wellformed(files[0], "brownout")
            assert ms._brownout() == lvl
            assert len(_dumps(node, "brownout")) == 1
            await asyncio.sleep(0.3)
            assert ms._brownout() == 0
            assert len(_dumps(node, "brownout")) == 1
        finally:
            await node.stop()
    run(main())
