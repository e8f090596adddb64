"""The port's overlapped serve pipeline and two-phase readback
(``emqx_tpu_torch/broker/match_service.py`` with ``pipeline`` and
``readback_mode``; K5 in ``emqx_tpu_torch/ops/match_kernel.py``) against
the reference's (``emqx_tpu/broker/match_service.py``,
``emqx_tpu/ops/match_kernel.py``), on the CPU.

The node-free cases of the reference's ``tests/test_match_pipeline.py``
run here as scenarios over a kit (the reference's Broker and
MatchService with JAX on the CPU, or the port's with ``device="cpu"``),
both on the Python host table at depth 8: the hints, the decoded rows,
the spilled rows and ``tpu.match.readback_bytes`` must be equal, bit for
bit.  Three differences are intended and asserted as such:

* the round trips: each phase of the port's two-phase readback is one
  copy, so a batch with matches waits twice, where the reference's
  ``chunked`` mode counts 1 + popcount(Σcounts) copies;
* the port encodes and dispatches on the event loop (in both modes),
  where the reference takes a worker thread;
* with the deadline loop, a readback failure counts toward the breaker
  on both (``test_pipeline_with_deadline_is_not_ported``, once the
  refusal of the pair, now holds the port's composition to the
  reference's).

The rest holds the K5 functions to the reference's on seeded flat
buffers, the pipeline's stream order (a delta written between two slots
in flight is seen by the later only), and ``FilterTrie.match_many``.
"""

import asyncio
import gc
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from emqx_tpu import faultinject as ref_fi
from emqx_tpu.broker import Broker as RefBroker
from emqx_tpu.broker import FilterTrie as RefFilterTrie
from emqx_tpu.broker import SubOpts as RefSubOpts
from emqx_tpu.broker.match_service import MatchService as RefMatchService
from emqx_tpu.observe.metrics import Metrics as RefMetrics
from emqx_tpu.ops import match_kernel as ref_mk
from emqx_tpu_torch import faultinject as port_fi
from emqx_tpu_torch.broker import match_service
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.match_service import MatchService
from emqx_tpu_torch.broker.session import SubOpts
from emqx_tpu_torch.broker.trie import FilterTrie
from emqx_tpu_torch.observe import Metrics
from emqx_tpu_torch.ops import match_kernel as mk
from emqx_tpu_torch.workload import build_workload

#: the reference's pipelined readback gives up after its per-dispatch
#: timeout (0.164 s by default) and answers from the host tables; its
#: first XLA compiles of the readback slices on the CPU take longer, so
#: it gets 30 s here.  The port's timeout applies on the deadline path
#: only, as the reference's does.
REF = SimpleNamespace(name="ref", Broker=RefBroker, SubOpts=RefSubOpts,
                      MatchService=RefMatchService, Metrics=RefMetrics,
                      fi=ref_fi, kw={"dispatch_timeout_s": 30.0})
PORT = SimpleNamespace(name="port", Broker=Broker, SubOpts=SubOpts,
                       MatchService=MatchService, Metrics=Metrics,
                       fi=port_fi, kw={"device": "cpu"})


@pytest.fixture(autouse=True)
def _unfrozen():
    """A started port service freezes the heap; each test hands the
    process back unfrozen."""
    yield
    gc.unfreeze()


def run(coro):
    return asyncio.run(coro)


def both(scenario, *args):
    """``scenario`` on the reference's kit and on the port's; the two
    observations must be equal.  Returns the port's."""
    want = run(scenario(REF, *args))
    got = run(scenario(PORT, *args))
    assert got == want
    return got


async def settle(pred, timeout=30.0, interval=0.005):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if pred():
            return True
        await asyncio.sleep(interval)
    return pred()


def make_service(kit, broker, **kw):
    kw.setdefault("depth", 8)
    kw.setdefault("table", "python")
    kw.setdefault("bypass_rate", 0.0)
    kw.setdefault("metrics", kit.Metrics())
    return kit.MatchService(broker, **kit.kw, **kw)


def subscribe_many(b, kit, filters, sessions=8):
    for i, flt in enumerate(filters):
        cid = f"s{i % sessions}"
        if cid not in b.sessions:
            b.open_session(cid)
        b.subscribe(cid, flt, kit.SubOpts())


async def started(kit, filters, **kw):
    b = kit.Broker()
    subscribe_many(b, kit, filters)
    ms = make_service(kit, b, **kw)
    await ms.start()
    assert await settle(lambda: ms.ready and ms._seen_epoch == b.router.epoch
                        and ms.dev.epoch == ms.inc.epoch)
    return b, ms


def hint_of(ms, topic):
    hint = ms._hints.get(topic)
    return None if hint is None else (sorted(hint[2]), sorted(hint[3]))


def routes(rs):
    return sorted((r.filter, repr(r.dest)) for r in rs)


def dispatch_one(kit, ms, topics):
    """Encode and dispatch one batch of ``topics`` (one depth group) and
    return its ``(result, rows)`` handle."""
    groups = [(list(range(len(topics))), ms.depth)]
    if kit is REF:
        handles, _enc, _disp = ms._encode_dispatch(ms.inc, ms.dev, topics,
                                                   groups, False)
    else:
        handles = ms._encode_dispatch(topics, groups)
    return handles[0]


def make_slot(kit, ms, pending, topics):
    """An in-flight slot of ``pending`` dispatched now, as the
    pipeline's dispatch half makes one."""
    groups = [(list(range(len(topics))), ms.depth)]
    if kit is REF:
        handles, enc_ns, disp_ns = ms._encode_dispatch(
            ms.inc, ms.dev, topics, groups, True)
        return (pending, topics, groups, handles, ms.inc, ms.dev,
                ms.inc.aid_reuses, ms._table_gen, ms._synced_epoch,
                ms._synced_rule_gen, 0.0, False, enc_ns + disp_ns)
    handles = ms._encode_dispatch(topics, groups)
    return ms._make_slot(pending, topics, groups, handles,
                         ms.inc.aid_reuses, ms._table_gen,
                         ms._synced_epoch, ms._synced_rule_gen)


def batch_size(res):
    return int(res.row_meta.shape[0])


async def twophase(kit, ms, res, n, mode):
    """The two-phase readback of one dispatched group in ``mode``: the
    reference's ``_readback_rows_twophase``, or the port's one readback
    path (``_make_slot``, then ``_readback_slot``).  Returns ``(rows,
    spilled row indices, bytes, round trips)``."""
    k = ms.dev.max_matches
    if kit is REF:
        return ms._readback_rows_twophase(res, n, k, mode=mode)
    mode0, ms.readback_mode = ms.readback_mode, mode
    slot = ms._make_slot([], [], [], [(res, n)], ms.inc.aid_reuses,
                         ms._table_gen, 0, 0)
    try:
        [(rows, sp)], nbytes, _s, trips = await ms._readback_slot(slot)
    finally:
        ms._release_slot(slot)
        ms.readback_mode = mode0
    return rows, sp, nbytes, trips


# -- flag off: the pipeline is inert and the serial path reads the slab ----

def test_flag_off_pipeline_inert_and_slab_readback(monkeypatch):
    calls = {"twophase": 0, "slab": 0}
    orig = MatchService._readback_rows
    monkeypatch.setattr(MatchService, "_readback_rows", staticmethod(
        lambda res, n, k: (calls.__setitem__("slab", calls["slab"] + 1)
                           or orig(res, n, k))))
    slot_read = MatchService._readback_slot

    async def twophase_spy(self, slot):
        calls["twophase"] += 1
        return await slot_read(self, slot)

    monkeypatch.setattr(MatchService, "_readback_slot", twophase_spy)

    async def main():
        b, ms = await started(PORT, [f"room/+/k{i}" for i in range(6)])
        assert not ms.pipeline and ms._inflight_q is None
        assert len(ms._tasks) == 2           # no readback task
        await ms.prefetch("room/1/k1")
        assert ms.hint_routes("room/1/k1") is not None
        n = ms.metrics.get("tpu.match.readback_bytes")
        await ms.stop()
        return n
    nbytes = run(main())
    assert calls["slab"] >= 1 and calls["twophase"] == 0
    # the slab: 64 padded rows, FLAT_MULT ids each, counts and overflows
    assert nbytes == 4 * (MatchService.FLAT_MULT * 64 + 3 * 64)


async def _hints_with(kit, pipeline, mode="chunked"):
    b, ms = await started(
        kit, [f"room/+/k{i}" for i in range(8)] + ["deep/#"],
        pipeline=pipeline, readback_mode=mode)
    topics = [f"room/{i}/k{i % 8}" for i in range(20)] + ["deep/a/b"]
    await ms.prefetch_many({t: 1 for t in topics})
    out = {t: hint_of(ms, t) for t in topics}
    m = ms.metrics
    counters = {k: m.get(k) for k in ("tpu.match.batches",
                                      "tpu.match.topics",
                                      "tpu.match.readback_bytes")}
    await ms.stop()
    return out, counters


@pytest.mark.parametrize("pipeline", [False, True])
def test_flag_onoff_hints_identical(pipeline):
    """Both serve paths mint the reference's hints and count its bytes
    (the slab off, the two-phase contract on)."""
    hints, _c = both(_hints_with, pipeline)
    assert all(h is not None for h in hints.values())
    assert hints == run(_hints_with(PORT, not pipeline))[0]


async def _proportional(kit):
    b, ms = await started(kit, [f"room/+/k{i}" for i in range(8)],
                          pipeline=True)
    assert ms._inflight_q is not None
    topics = [f"room/{i}/k{i % 8}" for i in range(32)]
    await ms.prefetch_many({t: 1 for t in topics})
    good = all(routes(ms.hint_routes(t)) == routes(b.router.match_routes(t))
               for t in topics)
    m = ms.metrics
    out = (good, m.get("tpu.match.readback_bytes"), ms._inflight_n,
           m.get("broker.match.pipeline_inflight"),
           m.get("tpu.match.batches"))
    await ms.stop()
    return out


def test_pipeline_serves_with_parity_and_proportional_bytes():
    good, nbytes, inflight, metric, batches = both(_proportional)
    assert good and batches >= 1
    # 32 topics padded to 64 rows, one id each: meta + ids, not the slab
    assert nbytes == 4 * (64 + 32)
    assert nbytes < 4 * (MatchService.FLAT_MULT * 64 + 3 * 64)
    assert inflight == 0 and metric == 0    # quiesced


async def _two_phase(kit, topics, mode, **kw):
    b, ms = await started(kit, [f"a/+/k{i}" for i in range(6)] + ["a/#"],
                          pipeline=True, **kw)
    res, n = dispatch_one(kit, ms, topics)
    k = ms.dev.max_matches
    rows, sp, nbytes, trips = await twophase(kit, ms, res, n, mode)
    slab_rows, slab_sp = ms._readback_rows(res, n, k)
    out = (rows, sp, nbytes, slab_rows, slab_sp, batch_size(res),
           int(res.matches.shape[0]), trips)
    await ms.stop()
    return out


@pytest.mark.parametrize("mode", ["chunked", "ragged", "auto"])
def test_two_phase_readback_rows_and_bytes_equal_reference(mode):
    """Rows, spilled rows and bytes of the two-phase readback equal the
    reference's and the slab's; chunked ships exactly 4·(B + Σcounts),
    ragged the capacity class.  The round trips differ as intended: the
    port waits on two copies, the reference's chunked mode on one per
    power-of-two chunk."""
    topics = [f"a/{i}/k{i % 6}" for i in range(24)]
    want = run(_two_phase(REF, topics, mode))
    got = run(_two_phase(PORT, topics, mode))
    assert got[:7] == want[:7]
    rows, sp, nbytes, slab_rows, slab_sp, B, flat_cap, trips = got
    assert rows == slab_rows and sp == slab_sp
    total = sum(len(r) for r in rows)
    assert total == 48 and B == 64
    cap = mk.ragged_capacity(total, flat_cap)
    assert nbytes == 4 * (B + (total if mode == "chunked" else cap))
    # the intended divergence of the round trips
    assert trips == 2
    assert want[7] == (1 + bin(total).count("1") if mode == "chunked"
                       else 2)


# -- the intended divergence: encode and dispatch run on the loop ----------

@pytest.mark.parametrize("pipeline", [False, True])
def test_encode_runs_on_the_loop(monkeypatch, pipeline):
    """The reference encodes on a worker thread
    (``test_encode_runs_off_loop_flag_off``); the port encodes on the
    event loop in both modes, where a worker's GIL hand-offs wait out a
    busy loop's switch interval."""
    seen = []
    orig = match_service.encode_batch

    def spy(*a, **kw):
        seen.append(threading.get_ident())
        return orig(*a, **kw)

    monkeypatch.setattr(match_service, "encode_batch", spy)

    async def main():
        b, ms = await started(PORT, [f"room/+/k{i}" for i in range(4)],
                              pipeline=pipeline)
        loop_thread = threading.get_ident()
        await ms.prefetch("room/1/k1")
        assert routes(ms.hint_routes("room/1/k1")) == \
            routes(b.router.match_routes("room/1/k1"))
        await ms.stop()
        return loop_thread
    loop_thread = run(main())
    assert seen and all(t == loop_thread for t in seen)


# -- per-slot guards: a swap or a reuse discards exactly the slot ----------

async def _slot_guard(kit, mutate, mode="chunked"):
    b, ms = await started(kit, [f"a/+/k{i}" for i in range(6)],
                          pipeline=True, readback_mode=mode)
    topics = ["a/1/k1", "a/2/k2"]
    loop = asyncio.get_running_loop()
    pending = [(t, loop.create_future()) for t in topics]
    slot = make_slot(kit, ms, pending, topics)
    if mutate == "gen":
        ms._table_gen += 1          # the table swapped in flight
    else:
        ms.inc.aid_reuses += 1      # an accept id reused in flight
    await ms._finish_slot(slot)
    done = all(fut.done() for _t, fut in pending)
    good = all(
        routes(ms.router.routes_with_wild(t, ms._hints[t][2]))
        == routes(b.router.match_routes(t)) for t in topics)
    out = (done, good, {t: hint_of(ms, t) for t in topics},
           ms.metrics.get("broker.match.cpu_fallback"))
    await ms.stop()
    return out


@pytest.mark.parametrize("mutate", ["gen", "reuse"])
def test_inflight_slot_swap_or_reuse_discards_via_guards(mutate):
    done, good, _hints, fallback = both(_slot_guard, mutate)
    assert done and good and fallback == 2


def test_midflight_swap_discards_ragged_slot():
    done, good, _hints, fallback = both(_slot_guard, "gen", "ragged")
    assert done and good and fallback == 2


# -- the match.readback chaos seam ------------------------------------------

async def _readback_fault(kit, pipeline, mode="chunked"):
    b, ms = await started(kit, [f"room/+/k{i}" for i in range(4)],
                          pipeline=pipeline, readback_mode=mode)
    inj = kit.fi.install(kit.fi.FaultInjector([
        {"point": "match.readback", "action": "raise", "times": 1}]))
    try:
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        await ms.prefetch("room/1/k1")
        prompt = loop.time() - t0 < ms.prefetch_timeout_s * 0.9
        fired = inj.fired.get("match.readback")
        first = hint_of(ms, "room/1/k1")
        fallback = ms.metrics.get("broker.match.cpu_fallback")
    finally:
        kit.fi.uninstall()
    await ms.prefetch("room/2/k2")        # the seam fired once
    second = ms.hint_routes("room/2/k2") is not None
    await ms.stop()
    return prompt, fired, first, fallback, second


@pytest.mark.parametrize("mode", ["chunked", "ragged"])
def test_readback_fault_raise_falls_to_cpu_promptly(mode):
    """A pipelined slot whose readback faults is answered from the host
    tables in one hop, and the next batch rides the device again."""
    prompt, fired, first, fallback, second = both(_readback_fault, True,
                                                  mode)
    assert prompt and fired == 1 and second
    assert first == (["room/+/k1"], []) and fallback >= 1


def test_readback_fault_in_flag_off_path_shared_seam():
    """The serial loop's d2h boundary has the same seam: its batch
    resolves without a hint and publish walks the host trie."""
    prompt, fired, first, fallback, second = both(_readback_fault, False)
    assert prompt and fired == 1 and second
    assert first is None and fallback == 0


async def _stop_in_flight(kit):
    b, ms = await started(kit, ["t/+"], pipeline=True)
    loop = asyncio.get_running_loop()
    kit.fi.install(kit.fi.FaultInjector([
        {"point": "match.readback", "action": "hang", "times": 1}]))
    try:
        # the readback task parks on the hang with this batch's slot
        await asyncio.wait_for(ms.prefetch("t/1"), 5.0)
    finally:
        kit.fi.uninstall()
    fut = loop.create_future()
    queued = make_slot(kit, ms, [("t/2", fut)], ["t/2"])
    ms._inflight_q.put_nowait(queued)
    await ms.stop()
    await asyncio.sleep(0.01)
    return fut.done(), ms._inflight_n


def test_stop_resolves_inflight_slot_waiters():
    assert both(_stop_in_flight) == (True, 0)


async def _pipeline_deadline_breaker(kit):
    b, ms = await started(kit, [f"room/+/k{i}" for i in range(4)],
                          pipeline=True, deadline=True, breaker_threshold=3)
    m = ms.metrics
    kit.fi.install(kit.fi.FaultInjector([
        {"point": "match.readback", "action": "raise", "times": 3}]))
    try:
        for i in range(3):
            await ms.prefetch(f"room/{i}/k{i}")
        tripped = await settle(lambda: ms._breaker_open, timeout=5)
    finally:
        kit.fi.uninstall()
    before = m.get("broker.match.cpu_fallback")
    await ms.prefetch("room/9/k1")        # open: the host serves at once
    out = (tripped, m.get("broker.match.cpu_fallback") - before,
           ms.hint_routes("room/9/k1") is None)
    await ms.stop()
    return out


def test_pipeline_with_deadline_is_not_ported():
    """The reference composes the pipeline with its deadline loop and
    breaker (``test_pipeline_composes_with_deadline_breaker``): failed
    pipelined readbacks feed the breaker as failed dispatches do.  The
    port, which once refused the pair, now composes it the same way."""
    assert both(_pipeline_deadline_breaker) == (True, 1, True)


# -- ragged readback (the reference's one-round-trip cases) ----------------

def test_ragged_readback_two_copies_and_bit_parity(monkeypatch):
    """Ragged reads a batch in two copies (4·B meta, one padded payload)
    with rows equal to the chunked read's, the slab's and the
    reference's."""
    topics = [f"a/{i}/k{i % 6}" for i in range(24)]
    want = run(_two_phase(REF, topics, "ragged"))
    copies = {"n": 0}
    orig = torch.Tensor.copy_

    def spy(self, *a, **kw):
        copies["n"] += 1
        return orig(self, *a, **kw)

    async def main():
        b, ms = await started(PORT, [f"a/+/k{i}" for i in range(6)]
                              + ["a/#"], pipeline=True)
        res, n = dispatch_one(PORT, ms, topics)
        chunked = await twophase(PORT, ms, res, n, "chunked")
        monkeypatch.setattr(torch.Tensor, "copy_", spy)
        ragged = await twophase(PORT, ms, res, n, "ragged")
        monkeypatch.undo()
        await ms.stop()
        return chunked, ragged, batch_size(res)
    chunked, ragged, B = run(main())
    assert ragged[:3] == want[:3]
    assert ragged[0] == chunked[0] == want[3]
    assert ragged[3] == copies["n"] == 2
    total = sum(len(r) for r in ragged[0])
    assert chunked[2] == 4 * (B + total)
    assert ragged[2] == 4 * (B + mk.ragged_capacity(total, 8 * B))


async def _no_matches(kit):
    b, ms = await started(kit, [f"room/+/k{i}" for i in range(4)],
                          pipeline=True)
    res, n = dispatch_one(kit, ms, ["zzz/1", "zzz/2", "zzz/3"])
    out = [await twophase(kit, ms, res, n, m)
           for m in ("ragged", "auto", "chunked")]
    await ms.stop()
    return out, batch_size(res)


def test_ragged_readback_meta_only_when_no_matches():
    out, B = both(_no_matches)
    for rows, sp, nbytes, trips in out:
        assert rows == [[], [], []] and sp == [] and trips == 1
        assert nbytes == 4 * B


async def _all_spill(kit):
    filters = [f"s/+/k{i}" for i in range(4)] + ["s/#", "s/+/#", "#",
                                                 "+/+/+"]
    b, ms = await started(kit, filters, pipeline=True, max_matches=4)
    topics = [f"s/{i}/k{i % 4}" for i in range(6)]
    res, n = dispatch_one(kit, ms, topics)
    out = [(await twophase(kit, ms, res, n, m))[:3]
           for m in ("ragged", "chunked")]
    await ms.stop()
    return out


def test_ragged_readback_all_spill_batch():
    """Every row past K stays fail-open through the ragged contract:
    counts clamp to K and every row is spilled."""
    (rows_r, sp_r, _b), (rows_c, sp_c, _b2) = both(_all_spill)
    assert sp_r == sp_c == list(range(6))
    assert rows_r == rows_c and all(len(r) == 4 for r in rows_r)


async def _pow2_boundary(kit):
    b, ms = await started(kit, [f"p{i}/+" for i in range(4)],
                          pipeline=True)
    res, n = dispatch_one(kit, ms, [f"p{i}/x" for i in range(4)])
    out = [(await twophase(kit, ms, res, n, m))[:3]
           for m in ("ragged", "chunked", "auto")]
    await ms.stop()
    return out


def test_ragged_capacity_class_boundary_matches_chunked():
    """A power-of-two total: ragged pads nothing, and all three modes
    ship the same bytes."""
    out = both(_pow2_boundary)
    assert sum(len(r) for r in out[0][0]) == 4
    assert out[0][0] == out[1][0] == out[2][0]
    assert out[0][2] == out[1][2] == out[2][2]


def test_readback_mode_flag_off_byte_identity(monkeypatch):
    """``chunked`` (the default) never runs the ragged fetch on either
    path."""
    def boom(*a, **kw):  # pragma: no cover - must never run
        raise AssertionError("ragged fetch ran with the flag off")

    monkeypatch.setattr(match_service, "fetch_flat_ragged", boom)

    async def main(pipeline):
        b, ms = await started(PORT, [f"room/+/k{i}" for i in range(6)],
                              pipeline=pipeline)
        assert ms.readback_mode == "chunked"
        topics = [f"room/{i}/k{i % 6}" for i in range(12)]
        await ms.prefetch_many({t: 1 for t in topics})
        good = all(routes(ms.hint_routes(t)) ==
                   routes(b.router.match_routes(t)) for t in topics)
        await ms.stop()
        return good
    assert run(main(False)) and run(main(True))


@pytest.mark.parametrize("pipeline", [False, True])
def test_ragged_serve_parity_and_roundtrip_metric(pipeline):
    """Both loops with ``ragged``: the reference's hints and bytes, and
    at most two waits a batch."""
    hints, counters = both(_hints_with, pipeline, "ragged")
    assert all(h is not None for h in hints.values())

    async def trips():
        b, ms = await started(
            PORT, [f"room/+/k{i}" for i in range(8)] + ["deep/#"],
            pipeline=pipeline, readback_mode="ragged")
        await ms.prefetch_many({f"room/{i}/k{i % 8}": 1 for i in range(20)})
        m = ms.metrics
        out = (m.get("tpu.match.readback_roundtrips"),
               m.get("tpu.match.batches"))
        await ms.stop()
        return out
    n_trips, batches = run(trips())
    assert batches >= 1 and 0 < n_trips <= 2 * batches


# -- the pipeline's stream order --------------------------------------------

def test_delta_between_slots_is_seen_by_the_later_slot_only():
    """Two slots in flight at once; a subscription's row delta is
    written between their dispatches: the earlier slot's rows do not
    hold the new filter, the later slot's do, and neither is discarded
    (a new filter reuses no accept id)."""
    async def main():
        b, ms = await started(PORT, ["a/+/x"], pipeline=True)
        loop = asyncio.get_running_loop()
        topics = ["a/1/x", "a/2/x"]
        first = [(t, loop.create_future()) for t in topics]
        s1 = make_slot(PORT, ms, first, topics)
        b.open_session("late")
        b.subscribe("late", "a/#")
        assert await settle(lambda: ms._synced_epoch == b.router.epoch)
        assert ms.dev.uploads == 1          # rows written, no re-upload
        second = [(t, loop.create_future()) for t in topics]
        s2 = make_slot(PORT, ms, second, topics)
        await ms._finish_slot(s1)
        one = {t: hint_of(ms, t) for t in topics}
        await ms._finish_slot(s2)
        two = {t: hint_of(ms, t) for t in topics}
        fallback = ms.metrics.get("broker.match.cpu_fallback")
        await ms.stop()
        return one, two, fallback
    one, two, fallback = run(main())
    assert all(h == (["a/+/x"], []) for h in one.values())
    assert all(h == (["a/#", "a/+/x"], []) for h in two.values())
    assert fallback == 0


@pytest.mark.parametrize("table", ["python", "native"])
def test_churn_reuses_no_id_while_a_slot_is_in_flight(table):
    """A filter freed and acked, then another subscribed while a slot
    is in flight: the new filter takes a fresh accept id, so that the
    slot's reuse guard stays quiet and its hints are the device's; once
    the slot is done, the next new filter reuses the freed id."""
    async def main():
        b, ms = await started(PORT, ["a/+/x", "gone/+"], pipeline=True,
                              table=table)
        b.unsubscribe("s1", "gone/+")        # frees an accept id ...
        assert await settle(lambda: ms._synced_epoch == b.router.epoch)
        reuses = ms.inc.aid_reuses            # ... acked: reusable
        loop = asyncio.get_running_loop()
        topics = ["a/1/x", "a/2/x"]
        pending = [(t, loop.create_future()) for t in topics]
        slot = make_slot(PORT, ms, pending, topics)
        b.open_session("late")
        b.subscribe("late", "new/+")
        assert await settle(lambda: ms._synced_epoch == b.router.epoch)
        during = ms.inc.aid_reuses - reuses
        await ms._finish_slot(slot)
        device = [(hint_of(ms, t), ms._hints[t][4]) for t in topics]
        fallback = ms.metrics.get("broker.match.cpu_fallback")
        b.subscribe("late", "newer/+")
        assert await settle(lambda: ms._synced_epoch == b.router.epoch)
        after = ms.inc.aid_reuses - reuses
        await ms.prefetch("newer/1")
        newer = routes(ms.hint_routes("newer/1"))
        await ms.stop()
        return during, device, fallback, after, newer, b
    during, device, fallback, after, newer, b = run(main())
    assert during == 0 and fallback == 0
    assert device == [((["a/+/x"], []), False)] * 2
    assert after == 1
    assert newer == routes(b.router.match_routes("newer/1"))


def test_host_answered_hints_are_counted_apart():
    """Hints that ``_cpu_serve`` minted (here for a slot whose table was
    replaced in flight) count in ``tpu.match.hint_served_host`` as well
    as ``hint_served``; the device's count in ``hint_served`` only."""
    async def main():
        b, ms = await started(PORT, [f"a/+/k{i}" for i in range(6)],
                              pipeline=True)
        loop = asyncio.get_running_loop()
        topics = ["a/1/k1", "a/2/k2"]
        pending = [(t, loop.create_future()) for t in topics]
        slot = make_slot(PORT, ms, pending, topics)
        ms._table_gen += 1
        await ms._finish_slot(slot)           # the host tables answer
        served = [ms.hint_routes(t) is not None for t in topics]
        await ms.prefetch("a/3/k3")            # the device answers
        served.append(ms.hint_routes("a/3/k3") is not None)
        m = ms.metrics
        out = (served, m.get("tpu.match.hint_served"),
               m.get("tpu.match.hint_served_host"))
        await ms.stop()
        return out
    assert run(main()) == ([True] * 3, 3, 2)


def test_info_reports_the_pipeline():
    ms = MatchService(device="cpu", pipeline=True, pipeline_depth=3,
                      readback_mode="auto", readback_auto_slack=0.5)
    info = ms.info()
    assert (info["pipeline"], info["pipeline_depth"], info["readback_mode"],
            info["readback_auto_slack"], info["pipeline_inflight"]) == \
        (True, 3, "auto", 0.5, 0)
    with pytest.raises(ValueError, match="readback mode"):
        MatchService(device="cpu", readback_mode="sideways")


# -- K5: the phase-2 fetch functions ------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fetch_functions_equal_reference(seed):
    """``fetch_flat_prefix``, ``ragged_capacity`` and
    ``fetch_flat_ragged`` against the reference's on a seeded flat
    buffer, for totals of 0, 1, powers of two and between, up to the
    buffer's size: the ids copied into a host buffer are the
    reference's, and the ragged copy holds the whole capacity class."""
    rng = np.random.default_rng(seed)
    flat_cap = int(rng.choice([64, 512, 1000]))
    flat = rng.integers(-1, 1 << 20, flat_cap).astype(np.int32)
    t = torch.from_numpy(flat)
    out = torch.empty(flat_cap, dtype=torch.int32)
    totals = sorted({0, 1, 2, 3, 63, 64, 65, flat_cap - 1, flat_cap,
                     *rng.integers(1, flat_cap, 6).tolist()})
    import jax.numpy as jnp
    j = jnp.asarray(flat)
    for total in totals:
        assert mk.ragged_capacity(total, flat_cap) == \
            ref_mk.ragged_capacity(total, flat_cap), total
        want = np.asarray(ref_mk.fetch_flat_prefix(j, total))
        assert np.array_equal(
            mk.fetch_flat_prefix(t, total, out).numpy(), want), total
        ragged = mk.fetch_flat_ragged(t, total, out).numpy()
        assert ragged.size == mk.ragged_capacity(total, flat_cap), total
        assert np.array_equal(ragged[:total], np.asarray(
            ref_mk.fetch_flat_ragged(j, total))), total


def test_phase2_count_follows_the_reference_rule():
    """The ids phase 2 copies in each mode, with the auto slack knob:
    the total, or its capacity class where the reference reads it."""
    count = MatchService._phase2_count
    for total in range(0, 300):
        cap = mk.ragged_capacity(total, 256)
        assert count(total, 256, "chunked", 1.0) == min(total, 256)
        assert count(total, 256, "ragged", 1.0) == cap
        pow2 = total & (total - 1) == 0
        assert count(total, 256, "auto", 1.0) == \
            (min(total, 256) if pow2 else cap)
        assert count(total, 256, "auto", 0.0) == min(total, 256) or \
            cap == total


# -- FilterTrie.match_many ----------------------------------------------------

def test_match_many_equals_reference():
    filters, topics = build_workload(np.random.default_rng(6), 3000, 400)
    filters += ["#", "+/+", "$SYS/#", "a/+/c/#"]
    rng = np.random.default_rng(7)
    names = [topics[i] for i in rng.integers(0, len(topics), 900)] + \
        ["$SYS/x", "a/b/c", "a/b/c"]
    port, ref = FilterTrie(), RefFilterTrie()
    for f in filters:
        port.insert(f)
        ref.insert(f)
    got = port.match_many(names)
    want = ref.match_many(names)
    assert list(got) == list(want)             # distinct, first-seen order
    assert {k: sorted(v) for k, v in got.items()} == \
        {k: sorted(v) for k, v in want.items()}
    assert len(got) < len(names)               # the repeats walked once
    assert all(sorted(got[t]) == sorted(port.match(t)) for t in names)
