"""The port's segments, compaction and grow-in-place on the CPU, held to
the reference's.

* the file format: a segment the port writes loads in the reference,
  and one the reference writes loads in the port, with equal arrays and
  checksum, for both kinds (``state``, with the join relation, and
  ``filters``);
* each case of ``tests/test_match_segments.py`` on the port: a
  segment's round trip and lazy hydration, the serve parity of a
  restored table, the checksum reject, grow in place (skipping the whole
  upload, over the threshold falling back to it, off by default, and
  ``compact()`` forcing it), the service's cold start from a segment
  with a delta tail, hint freshness across a swap, churn under serve
  across swaps, a slot in flight across a swap discarded by the table
  generation, the rule ids remapped across a swap, and everything inert
  with the flag off; each on both host tables where it runs a service.
  The reference's ``prewarm``, ``CompileMiss`` and ``xla_cache`` cases
  pre-pay or refuse XLA compiles; the port's counterparts assert the
  recorded divergence (a CUDA kernel serves every shape: the keys are
  accepted and inert, a resized table serves at once);
* the region-mode deltas of the port's ``IncrementalNfa`` equal the
  reference's field for field on one seeded mutation script, and a
  table grown in place (with the join relation mirrored) is bit-equal
  to a whole upload and answers as the oracle does.

Every case runs under a time limit of its own (:func:`run`).
"""

import asyncio
import gc
import os
import time

import numpy as np
import pytest
import torch

from emqx_tpu.ops.incremental import IncrementalNfa as RefIncrementalNfa
from emqx_tpu.storage import segments as ref_segments
from emqx_tpu_torch import faultinject as fi
from emqx_tpu_torch import topic as T
from emqx_tpu_torch.broker import match_service
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.match_service import MatchService
from emqx_tpu_torch.config import SCHEMA, Config
from emqx_tpu_torch.native.nfa import NativeNfa
from emqx_tpu_torch.node import BrokerNode
from emqx_tpu_torch.observe import Metrics
from emqx_tpu_torch.ops import DeviceNfa, IncrementalNfa
from emqx_tpu_torch.ops.encode import encode_batch
from emqx_tpu_torch.storage import segments
from emqx_tpu_torch.storage.segments import (SegmentError, load_segment,
                                             restore_incremental,
                                             save_segment)

TABLES = ["python", "native"]


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


async def settle(pred, timeout=60.0, interval=0.01):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if pred():
            return True
        await asyncio.sleep(interval)
    return pred()


def make_service(broker, seg_dir, **kw):
    kw.setdefault("depth", 8)
    kw.setdefault("table", "python")
    kw.setdefault("bypass_rate", 0.0)
    kw.setdefault("debounce_s", 0.01)
    kw.setdefault("segments", True)
    kw.setdefault("segments_dir", str(seg_dir))
    kw.setdefault("compact_interval_s", 0.05)
    kw.setdefault("compact_min_mutations", 1)
    kw.setdefault("metrics", Metrics())
    return MatchService(broker, device="cpu", **kw)


def subscribe_many(b, filters, sessions=16):
    for i, flt in enumerate(filters):
        cid = f"s{i % sessions}"
        if cid not in b.sessions:
            b.open_session(cid)
        b.subscribe(cid, flt)


def routes(rs):
    return None if rs is None else sorted((r.filter, repr(r.dest))
                                          for r in rs)


def _table(cls, n=500):
    inc = cls(depth=4)
    for f in [f"a/{i}/+" for i in range(n)] + ["x/#", "+/y", "only"]:
        inc.add(f)
    inc.remove("a/7/+")
    inc.remove("a/9/+")
    deep = {"d/e/e/p/x/y/z/+": inc.alloc_alias("d/e/e/p/x/y/z/+")}
    routing = {aid for aid, f in enumerate(inc.accept_filters)
               if f is not None}
    return inc, deep, routing


def _same_segment(a, b):
    assert a.meta == b.meta
    for k in ("kind", "depth", "epoch", "filters", "deep", "routing_aids",
              "n_filters", "n_states", "aid_reuses", "vocab_words",
              "accept_filters", "alias_aids"):
        assert getattr(a, k) == getattr(b, k), k
    for k in ("node_tab", "edge_tab", "seeds", "trie", "accept_mask",
              "free_aids", "join_start", "join_word", "join_next"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert np.array_equal(x, y), k


# -- the file format, across the two packages --------------------------------

@pytest.mark.parametrize("join", [False, True])
def test_state_segment_loads_across_packages(tmp_path, join):
    port, pdeep, prouting = _table(IncrementalNfa)
    ref, rdeep, rrouting = _table(RefIncrementalNfa)
    assert np.array_equal(port.edge_tab, ref.edge_tab)
    pp, rp = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    meta_p = save_segment(pp, port, deep=pdeep, routing_aids=prouting,
                          join_relation=join)
    meta_r = ref_segments.save_segment(rp, ref, deep=rdeep,
                                       routing_aids=rrouting,
                                       join_relation=join)
    assert meta_p == meta_r           # the checksum too
    # each package reads the other's file as its own
    _same_segment(load_segment(rp), load_segment(pp))
    _same_segment(ref_segments.load_segment(pp),
                  ref_segments.load_segment(rp))
    a = restore_incremental(load_segment(rp))
    b = ref_segments.restore_incremental(ref_segments.load_segment(pp))
    for t in ("a/5/k", "x/q/r", "z/y", "a/7/k", "only"):
        assert sorted(a.match_host(t)) == sorted(b.match_host(t)) \
            == sorted(port.match_host(t)), t


def test_filters_segment_loads_across_packages(tmp_path):
    filters = sorted({f"n/{i % 97}/+/{i}" for i in range(300)} | {"n/#"})
    port = NativeNfa(depth=8)
    port.bulk_add(filters)
    from emqx_tpu.native.nfa import NativeNfa as RefNativeNfa
    ref = RefNativeNfa(depth=8)
    ref.bulk_add(filters)
    deep = {"a/b/c/d/e/f/g/h/i": 4242}
    pp, rp = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    meta_p = save_segment(pp, port, deep=deep, routing_aids={1, 2},
                          filters=filters)
    meta_r = ref_segments.save_segment(rp, ref, deep=deep,
                                       routing_aids={1, 2}, filters=filters)
    assert meta_p == meta_r
    _same_segment(load_segment(rp), ref_segments.load_segment(pp))
    assert load_segment(rp).filters == filters


# -- a segment's round trip ---------------------------------------------------

def test_segment_round_trip_parity(tmp_path):
    inc, deep, routing = _table(IncrementalNfa)
    p = str(tmp_path / "seg.npz")
    save_segment(p, inc, deep=deep, routing_aids=routing)
    seg = load_segment(p)
    assert seg.kind == "state"
    inc2 = restore_incremental(seg)
    assert np.array_equal(inc.node_tab, inc2.node_tab)
    assert np.array_equal(inc.edge_tab, inc2.edge_tab)
    assert np.array_equal(inc.seeds, inc2.seeds)
    assert inc.vocab == inc2.vocab
    assert list(inc.accept_filters) == list(inc2.accept_filters)
    assert inc._alias_aids == inc2._alias_aids
    assert list(inc._free_aids) == list(inc2._free_aids)
    assert set(inc._free_sids) == set(inc2._free_sids)
    assert (inc.n_states, inc.n_edges, inc.n_filters) == \
        (inc2.n_states, inc2.n_edges, inc2.n_filters)
    for f in ("a/5/+", "x/#", "+/y", "only"):
        assert inc.aid_of(f) == inc2.aid_of(f)
    for t in ("a/5/k", "x/q/r", "z/y", "a/7/k", "only"):
        assert sorted(inc.match_host(t)) == sorted(inc2.match_host(t)), t
    assert inc2.add("fresh/+") and inc2.remove("a/11/+")
    assert not inc2.flush().empty


def test_segment_device_serve_parity(tmp_path):
    inc = IncrementalNfa(depth=4)
    for i in range(200):
        inc.add(f"r/{i}/+")
    p = str(tmp_path / "seg.npz")
    save_segment(p, inc, deep={}, routing_aids=set())
    inc2 = restore_incremental(load_segment(p))
    d1 = DeviceNfa(inc, active_slots=8, max_matches=16, device="cpu")
    d2 = DeviceNfa(inc2, active_slots=8, max_matches=16, device="cpu")
    topics = [f"r/{i}/k" for i in range(20)]
    r1 = d1.match(*d1.put_batch(*encode_batch(inc, topics, batch=32)))
    r2 = d2.match(*d2.put_batch(*encode_batch(inc2, topics, batch=32)))
    assert torch.equal(r1.matches, r2.matches)
    assert torch.equal(r1.n_matches, r2.n_matches)


def test_segment_checksum_reject_and_version_skew(tmp_path):
    inc = IncrementalNfa(depth=4)
    inc.add("a/+")
    p = str(tmp_path / "seg.npz")
    save_segment(p, inc, deep={}, routing_aids=set())
    raw = open(p, "rb").read()
    mid = len(raw) // 2
    with open(p, "wb") as f:
        f.write(raw[:mid] + bytes([raw[mid] ^ 0xFF]) + raw[mid + 1:])
    with pytest.raises(SegmentError):
        load_segment(p)
    with pytest.raises(SegmentError):
        load_segment(str(tmp_path / "missing.npz"))
    # another version is refused, in both packages
    q = str(tmp_path / "v1.npz")
    old = segments.SEGMENT_VERSION
    try:
        segments.SEGMENT_VERSION = 1
        save_segment(q, inc, deep={}, routing_aids=set())
    finally:
        segments.SEGMENT_VERSION = old
    for loader in (load_segment, ref_segments.load_segment):
        with pytest.raises(Exception, match="version"):
            loader(q)


def test_segment_lazy_hydration_defers_trie_relink(tmp_path):
    inc = IncrementalNfa(depth=4)
    for i in range(50):
        inc.add(f"a/{i}/+")
    p = str(tmp_path / "seg.npz")
    save_segment(p, inc, deep={}, routing_aids=set())
    inc2 = restore_incremental(load_segment(p))
    assert inc2._pending_trie is not None and inc2.root is None
    assert sorted(inc2.match_host("a/3/k")) == sorted(inc.match_host("a/3/k"))
    assert inc2._pending_trie is None and inc2.root is not None


# -- grow in place --------------------------------------------------------------

def _grown(threshold, join=False, regions=True):
    inc = IncrementalNfa(depth=8, state_bucket=64)
    inc.track_regions = regions
    dev = DeviceNfa(inc, active_slots=8, max_matches=16, device="cpu")
    dev.dirty_regions = regions
    dev.dirty_full_threshold = threshold
    if join:
        dev.enable_join()
    uploads0 = dev.uploads
    for i in range(120):
        inc.add(f"g/{i}/x/y")
    dev.sync()
    return inc, dev, uploads0


def _bit_equal_to_upload(inc, dev):
    full = DeviceNfa(inc, active_slots=8, max_matches=16, device="cpu")
    for a, b in zip(dev.arrays(), full.arrays()):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("join", [False, True])
def test_dirty_region_grow_in_place_skips_full_upload(join):
    inc, dev, uploads0 = _grown(1.0, join)
    assert dev.uploads == uploads0, "the resize paid a whole upload"
    assert dev.grow_applies >= 1
    assert dev.dirty_rows_uploaded > 0
    assert np.array_equal(dev.arrays()[0].numpy(), inc.node_tab)
    assert np.array_equal(dev.arrays()[1].numpy(), inc.edge_tab)
    _bit_equal_to_upload(inc, dev)
    topics = [f"g/{i}/x/y" for i in range(0, 120, 7)] + ["g/1/x", "none"]
    enc = dev.put_batch(*encode_batch(inc, topics, batch=64))
    for be in ("hash",) + (("join",) if join else ()):
        got = dev.match(*enc, backend=be)
        for r, t in enumerate(topics):
            row = got.matches[r][got.matches[r] >= 0].tolist()
            want = [a for a, f in enumerate(inc.accept_filters)
                    if f is not None and T.match(t, f)]
            assert sorted(row) == want, (be, t)


def test_dirty_region_threshold_falls_back_to_full_upload():
    inc, dev, uploads0 = _grown(0.0001)
    assert dev.uploads > uploads0
    assert dev.grow_applies == 0
    assert np.array_equal(dev.arrays()[0].numpy(), inc.node_tab)


def test_dirty_region_off_keeps_legacy_full_upload():
    inc, dev, uploads0 = _grown(1.0, regions=False)
    assert dev.uploads > uploads0
    assert dev.grow_applies == 0


def test_compact_forces_full_upload_even_in_region_mode():
    inc = IncrementalNfa(depth=8, state_bucket=64)
    inc.track_regions = True
    dev = DeviceNfa(inc, active_slots=8, max_matches=16, device="cpu")
    dev.dirty_regions = True
    for i in range(50):
        inc.add(f"c/{i}/+")
    dev.sync()
    uploads0 = dev.uploads
    inc.compact()
    dev.sync()
    assert dev.uploads > uploads0
    assert np.array_equal(dev.arrays()[0].numpy(), inc.node_tab)
    assert np.array_equal(dev.arrays()[1].numpy(), inc.edge_tab)


def test_grow_in_place_of_a_missed_sync_drops_the_mirror():
    """The poison rule: a grow whose base is not the device's raises and
    drops the mirror, so that the next drain uploads whole."""
    inc, dev, _u = _grown(1.0)
    inc.add("h/1/x/y")
    p = dev.drain()
    p = p._replace(delta=p.delta._replace(resized=True,
                                          node_grown_from=int(inc.S) // 2))
    with pytest.raises(RuntimeError, match="grow in place"):
        dev.apply_pending(p)
    assert dev._arrs is None
    uploads = dev.uploads
    dev.sync()
    assert dev.uploads == uploads + 1
    _bit_equal_to_upload(inc, dev)


def _mutate(inc, rng):
    """A seeded script that grows the node and edge tables, frees ids,
    and compacts once."""
    out = []
    live = []
    for step in range(400):
        if live and rng.random() < 0.3:
            f = live.pop(int(rng.integers(len(live))))
            inc.remove(f)
        else:
            f = "/".join(f"w{int(x)}" for x in rng.integers(0, 40, size=int(
                rng.integers(1, 6)))) + rng.choice(["", "/+", "/#"])
            if inc.add(f):
                live.append(f)
        if step % 37 == 0:
            out.append(inc.flush())
        if step == 250:
            inc.compact()
            out.append(inc.flush())
    out.append(inc.flush())
    return out


def test_region_deltas_equal_reference():
    deltas = []
    for cls in (IncrementalNfa, RefIncrementalNfa):
        inc = cls(depth=8, state_bucket=64, edge_bucket=8)
        inc.track_regions = True
        deltas.append(_mutate(inc, np.random.default_rng(5)))
    assert len(deltas[0]) == len(deltas[1])
    grown = rehashed = 0
    for a, b in zip(*deltas):
        assert a.epoch == b.epoch and a.resized == b.resized
        assert a.node_grown_from == b.node_grown_from
        assert a.edges_rehashed == b.edges_rehashed
        for k in ("state_idx", "state_rows", "bucket_idx", "bucket_rows"):
            x, y = getattr(a, k), getattr(b, k)
            order_x = np.argsort(a.state_idx if k.startswith("state")
                                 else a.bucket_idx, kind="stable")
            order_y = np.argsort(b.state_idx if k.startswith("state")
                                 else b.bucket_idx, kind="stable")
            assert np.array_equal(x[order_x], y[order_y]), k
        grown += a.resized and a.node_grown_from > 0
        rehashed += a.resized and a.edges_rehashed
    assert grown and rehashed


# -- the JAX-only cases: the recorded divergences -----------------------------

def test_prewarmed_resize_serves_with_zero_compiles():
    """The reference pre-warms the next power-of-two shape's XLA compile
    so that a resize serves from its kernel cache.  A CUDA kernel is
    built once for every shape: the port has no cache to warm, accepts
    ``prewarm`` and does nothing with it, and a table that just grew
    serves on its next dispatch."""
    for prewarm in (True, False):
        ms = MatchService(Broker(), device="cpu", prewarm=prewarm)
        assert ms.prewarm is prewarm and not hasattr(ms, "kcache")
    inc, dev, uploads0 = _grown(1.0)
    res = dev.match(*dev.put_batch(*encode_batch(inc, ["g/5/x/y"], batch=64)),
                    flat_cap=8 * 64)
    assert res.n_matches[0].item() == 1


def test_compile_miss_raises_instead_of_stalling():
    """The reference's kernel cache raises ``CompileMiss`` for a shape
    not compiled yet (the host answers, no breaker strike).  The port's
    dispatch takes every shape: there is no such error, and a batch of
    a shape never served before serves."""
    assert not hasattr(match_service, "CompileMiss")
    inc = IncrementalNfa(depth=8)
    inc.add("a/+")
    dev = DeviceNfa(inc, active_slots=8, max_matches=16, device="cpu")
    for b in (64, 128, 4096):
        res = dev.match(*dev.put_batch(*encode_batch(inc, ["a/k"], batch=b)),
                        flat_cap=8 * b)
        assert res.n_matches[0].item() == 1


# -- the service: cold start, compaction, swaps --------------------------------

@pytest.mark.parametrize("table", TABLES)
def test_cold_start_from_segment_with_delta_tail(tmp_path, table):
    async def main():
        b = Broker()
        subscribe_many(b, [f"room/+/k{i}" for i in range(60)])
        m = Metrics()
        ms = make_service(b, tmp_path, table=table, metrics=m)
        await ms.start()
        assert await settle(lambda: m.get("tpu.table.compact_runs") >= 1)
        await ms.stop()
        b.open_session("late")
        b.subscribe("late", "late/+/f")
        b.unsubscribe("s0", "room/+/k0")
        m2 = Metrics()
        ms2 = make_service(b, tmp_path, table=table, metrics=m2,
                           compact_interval_s=30.0,
                           compact_min_mutations=10**9)
        await ms2.start()
        try:
            assert ms2._segment_loaded
            assert m2.get("tpu.table.segment_load_s") > 0
            assert await settle(lambda: ms2.ready)
            for t in ("late/1/f", "room/1/k1"):
                await ms2.prefetch(t)
                hint = ms2.hint_routes(t)
                assert hint is not None
                assert routes(hint) == routes(b.router.match_routes(t))
            assert ms2.inc.aid_of("room/+/k0") < 0
            assert ms2.info()["segments"]["loaded"] is True
        finally:
            await ms2.stop()
    run(main())


@pytest.mark.parametrize("table", TABLES)
def test_hint_freshness_preserved_across_segment_swap(tmp_path, table):
    async def main():
        b = Broker()
        subscribe_many(b, [f"room/+/k{i}" for i in range(30)])
        ms = make_service(b, tmp_path, table=table)
        await ms.start()
        try:
            assert await settle(lambda: ms.ready)
            topics = [f"room/{i}/k{i % 30}" for i in range(12)]
            await asyncio.gather(*[ms.prefetch(t) for t in topics])
            for t in topics:
                assert ms._hint_fresh(t, ms._hints[t][0])
            gen0 = ms._table_gen
            assert await settle(lambda: ms._table_gen > gen0, timeout=30)
            for t in topics:
                assert t in ms._hints
                assert ms._hint_fresh(t, ms._hints[t][0]), t
                hint = ms.hint_routes(t)
                assert hint is not None
                assert routes(hint) == routes(b.router.match_routes(t))
        finally:
            await ms.stop()
    run(main())


@pytest.mark.parametrize("table", TABLES)
def test_churn_under_serve_across_swaps_zero_stalls(tmp_path, table):
    """Subscribes and unsubscribes while the deadline loop serves and the
    compaction swaps tables: no waiter resolves past the prefetch
    budget, swaps land mid-churn, and every hint has routing parity."""
    async def main():
        b = Broker()
        subscribe_many(b, [f"base/+/k{i}" for i in range(50)])
        ms = make_service(b, tmp_path, table=table, deadline=True,
                          deadline_s=0.1)
        await ms.start()
        try:
            assert await settle(lambda: ms.ready)
            gen0 = ms._table_gen
            waits = []
            for i in range(120):
                cid = f"c{i % 8}"
                if cid not in b.sessions:
                    b.open_session(cid)
                if i % 2 == 0:
                    b.subscribe(cid, f"churn/{i}/+")
                elif i > 2:
                    b.unsubscribe(f"c{(i - 2) % 8}", f"churn/{i - 2}/+")
                t0 = time.perf_counter()
                await ms.prefetch(f"serve/{i}/x")
                waits.append(time.perf_counter() - t0)
                if i % 10 == 0:
                    await asyncio.sleep(0.02)
            assert ms._table_gen > gen0, "no swap landed during the churn"
            assert max(waits) < ms.prefetch_timeout_s * 0.9, max(waits)
            assert await settle(lambda: ms._synced_epoch == b.router.epoch)
            for t in ("base/9/k9", "churn/118/q", "churn/2/q"):
                await ms.prefetch(t)
                hint = ms.hint_routes(t)
                assert hint is not None
                assert routes(hint) == routes(b.router.match_routes(t))
        finally:
            await ms.stop()
    run(main())


@pytest.mark.parametrize("table", TABLES)
def test_swap_discards_inflight_batch_via_gen_guard(tmp_path, table):
    async def main():
        b = Broker()
        subscribe_many(b, [f"a/+/k{i}" for i in range(10)])
        ms = make_service(b, tmp_path, table=table, compact_interval_s=30.0)
        await ms.start()
        try:
            assert await settle(lambda: ms.ready)
            gate = asyncio.Event()

            async def held(_delay):
                await gate.wait()

            fi.install(fi.FaultInjector(
                [{"point": "match.readback", "action": "delay"}],
                sleep=held))
            fut = asyncio.ensure_future(ms._device_serve(["a/1/k1"]))
            assert await settle(lambda: fi.get().fired.get("match.readback"))
            ok = await ms._compact_once()     # a swap lands mid-flight
            assert ok
            gate.set()
            with pytest.raises(match_service._StaleRace):
                await fut
        finally:
            await ms.stop()
    run(main())


@pytest.mark.parametrize("table", TABLES)
def test_rules_remap_across_swap(tmp_path, table):
    async def main():
        b = Broker()
        subscribe_many(b, [f"r/+/k{i}" for i in range(10)])
        ms = make_service(b, tmp_path, table=table, compact_interval_s=30.0)
        await ms.start()
        try:
            assert await settle(lambda: ms.ready)
            ms.register_rule("rule1", ["rule/+/from"])
            assert await settle(lambda: ms._seen_epoch == b.router.epoch
                                and ms._synced_rule_gen == ms._rule_gen)
            gen = ms._table_gen
            assert await ms._compact_once()
            assert ms._table_gen == gen + 1
            aid = ms.inc.aid_of("rule/+/from")
            assert aid >= 0 and ms._aid_rules.get(aid) == {"rule1"}
            await ms.prefetch("rule/9/from")
            assert ms.hint_rules("rule/9/from") == ["rule1"]
        finally:
            await ms.stop()
    run(main())


@pytest.mark.parametrize("table", TABLES)
def test_changes_during_the_build_are_fixed_up(tmp_path, table,
                                               monkeypatch):
    """Filters subscribed, unsubscribed and registered while a compaction
    builds are fixed up in the fresh table and written to its device
    twin before the swap: the first batch after it answers them."""
    async def main():
        b = Broker()
        subscribe_many(b, [f"f/+/k{i}" for i in range(20)])
        ms = make_service(b, tmp_path, table=table, compact_interval_s=30.0)
        await ms.start()
        try:
            assert await settle(lambda: ms.ready)
            inner = match_service._build_compacted

            def build(*a):
                out = inner(*a)
                loop.call_soon_threadsafe(mutate.set)
                time.sleep(0.3)       # the loop mutates meanwhile
                return out

            loop = asyncio.get_running_loop()
            mutate = asyncio.Event()
            monkeypatch.setattr(match_service, "_build_compacted", build)
            task = asyncio.ensure_future(ms._compact_once())
            await mutate.wait()
            b.subscribe("s1", "mid/+/new")
            b.unsubscribe("s2", "f/+/k2")
            ms.register_rule("r1", ["rul/+"])
            assert await settle(lambda: ms._seen_epoch == b.router.epoch)
            assert await task
            assert ms._mut_count >= 3
            for t in ("mid/1/new", "f/1/k2", "rul/x", "f/3/k3"):
                await ms.prefetch(t)
                hint = ms.hint_routes(t)
                assert hint is not None, t
                assert routes(hint) == routes(b.router.match_routes(t)), t
            assert ms.hint_rules("rul/x") == ["r1"]
            assert ms.inc.aid_of("f/+/k2") < 0
        finally:
            await ms.stop()
    run(main())


def test_flag_off_structures_inert():
    ms = MatchService(Broker(), device="cpu", depth=8, table="python")
    assert not ms.segments
    assert not ms.dev.dirty_regions
    assert not ms.inc.track_regions
    assert ms._table_gen == 0 and ms._mut_count == 0
    assert ms.info()["segments"] is None
    # segments without a directory stay off, as in the reference
    assert not MatchService(Broker(), device="cpu", segments=True).segments


# -- the node's keys ------------------------------------------------------------

def test_xla_cache_dir_configured_under_segments_dir(tmp_path, monkeypatch):
    """The reference points JAX's compilation cache under the segments
    directory; the port has no XLA cache, and a node with
    ``match.segments.xla_cache`` on writes no cache directory."""
    monkeypatch.chdir(tmp_path)

    async def main():
        cfg = Config(file_text='listeners.tcp.default.bind = "127.0.0.1:0"\n')
        cfg.put("tpu.enable", True)
        cfg.put("tpu.mirror_refresh_interval", 0.01)
        cfg.put("tpu.table", "python")
        cfg.put("match.segments.enable", True)
        cfg.put("match.segments.xla_cache", True)
        node = BrokerNode(cfg, device="cpu")
        await node.start()
        try:
            ms = node.match_service
            return ms.segments, ms.segments_dir
        finally:
            await node.stop()
    on, seg_dir = run(main())
    assert on and seg_dir == os.path.join("data", "segments")
    assert not os.path.exists(os.path.join(seg_dir, "xla_cache"))


def test_xla_cache_config_key_registered():
    assert SCHEMA["match.segments.xla_cache"].default is True
    assert SCHEMA["match.segments.enable"].default is False


@pytest.mark.parametrize("enable,seg_dir,want", [
    (False, "", ""), (True, "", os.path.join("data", "segments")),
    (True, "segdir", "segdir")])
def test_node_wires_xla_cache_only_with_segments_enabled(tmp_path,
                                                        monkeypatch, enable,
                                                        seg_dir, want):
    """The node hands the service its segments directory only with
    ``match.segments.enable`` on: the configured one, else
    ``<node.data_dir or data>/segments``."""
    monkeypatch.chdir(tmp_path)
    got = {}

    class Probe(MatchService):
        def __init__(self, *a, **kw):
            got.update(kw)
            raise RuntimeError("probe")

    monkeypatch.setattr(match_service, "MatchService", Probe)
    cfg = Config(env={})
    cfg.put("tpu.enable", True)
    cfg.put("match.segments.enable", enable)
    cfg.put("match.segments.dir", seg_dir)
    with pytest.raises(RuntimeError, match="probe"):
        run(BrokerNode(cfg, device="cpu")._start_match_service())
    assert got["segments"] is enable and got["segments_dir"] == want


def test_blob_and_checksum_in_pieces_equal_reference(monkeypatch, tmp_path):
    """The port joins a segment's strings a piece at a time and hashes
    each array's buffer in place (``gil.PIECE`` shrunk here): the bytes
    and the checksum are the reference's, and a native segment written
    with a routing-id array loads in the reference."""
    monkeypatch.setattr(segments, "PIECE", 13)
    filters = [f"s/{i}/+" for i in range(300)] + ["", "é/#"]
    np.testing.assert_array_equal(segments._blob(filters),
                                  ref_segments._blob(filters))
    assert segments._blob([]).size == ref_segments._blob([]).size == 0
    arrays = {"a": np.arange(12, dtype=np.int32).reshape(3, 4),
              "b": np.array([True, False]), "c": np.zeros(0, np.int64),
              "d": segments._blob(filters)}
    assert segments._checksum(arrays, {"v": 1}) == \
        ref_segments._checksum(arrays, {"v": 1})
    nt = NativeNfa(depth=8)
    nt.bulk_add(filters[:300])
    aids = nt.bulk_aid_of(filters[:300])
    path = str(tmp_path / "n.seg.npz")
    segments.save_segment(path, nt, deep={}, routing_aids=aids[::-1].copy(),
                          filters=filters[:300])
    seg = ref_segments.load_segment(path)
    assert seg.routing_aids == sorted(aids.tolist())
    assert seg.filters == filters[:300]
