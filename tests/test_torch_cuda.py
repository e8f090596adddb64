"""The port's CUDA walk kernels (hash and join, raw and flat mode: the
flat epilogue fused in) against their plain PyTorch versions, and the asyncio serve loop on them
(the fixed-window path, the overlapped pipeline with its two-phase
readback, the deadline loop's dispatch timeout over a real hang, grow in
place and a compaction swap); the dense walk against its plain version,
the two-tier matcher and the retained replay; the exhook match sidecar;
the multichip step and matcher on a mesh of four shards of one card,
the routing grid and merge kernels of K8a and K8c against their plain
versions, and the prefix-EP step;
the fan-out's six bitmap kernels against their plain versions, the
library steps (K8b-K8f) and the dry run on that mesh; on the card.  These tests need an NVIDIA GPU and nvcc; they skip elsewhere.  The
module imports neither JAX nor the reference package, so it also runs
where only the port is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import asyncio
import gc

import numpy as np
import pytest
import torch

from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.match_service import MatchService
from emqx_tpu_torch.observe import Metrics
from emqx_tpu_torch.ops import (DeviceNfa, IncrementalNfa, encode_batch,
                                join_match, nfa_match)
from emqx_tpu_torch.ops import route_kernel as rk
from emqx_tpu_torch.ops import walk_kernel
from emqx_tpu_torch.ops.join_match import OVERLAY_EMPTY
from emqx_tpu_torch.ops.match_kernel import ragged_capacity
from emqx_tpu_torch.ops.walk_kernel import (join_walk, join_walk_plain,
                                            nfa_walk, nfa_walk_plain)
from emqx_tpu_torch.workload import build_workload

#: every level of w/a/b/c/d/e/f literal or '+': that topic's frontier
#: doubles each level, so its walk spills at every A below
FAN_FILTERS = ["w/" + "/".join("+" if m >> k & 1 else c
                               for k, c in enumerate("abcdef"))
               for m in range(64)]
EDGE_FILTERS = ["#", "+", "+/+", "$SYS/#", "$SYS/+/x", "x//y", "/", "//#",
                "a/+/c/#", "d/" + "/".join(["+"] * 14)] + FAN_FILTERS
EDGE_TOPICS = ["$SYS/a/x", "$SYS", "x//y", "/", "//", "a/b/c/d",
               "d/" + "/".join(["q"] * 14), "d/" + "/".join(["q"] * 30),
               "w/a/b/c/d/e/f"]
#: (depth, A, B): the lane layouts (A = 1, 12, 16, 32: one lane a row, a
#: power of two not filled, half and all of a warp) and B = 1000, which
#: fills no whole number of blocks
LAYOUT_CASES = [(8, 1, 64), (8, 1, 1000), (16, 12, 64), (16, 12, 1000),
                (16, 12, 2048), (8, 32, 1000), (8, 32, 2048),
                (16, 16, 1000)]


def _build_table():
    filters, topics = build_workload(np.random.default_rng(1), 20000, 2048)
    deep, deep_topics = build_workload(np.random.default_rng(2), 5000, 2048,
                                       depth=16)
    inc = IncrementalNfa(depth=16)
    for f in filters + deep + EDGE_FILTERS:
        inc.add(f)
    return inc, EDGE_TOPICS + topics + deep_topics


@pytest.fixture(scope="module")
def table():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return _build_table()


def _operands(inc, topics, depth, B):
    enc = encode_batch(inc, topics[:B], batch=B, depth=depth)
    arrs = enc + (inc.node_tab, inc.edge_tab, inc.seeds)
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize("depth,A,B", [(4, 16, 64), (8, 2, 2048),
                                       (16, 16, 2048), (8, 32, 256),
                                       (16, 1, 64)] + LAYOUT_CASES)
def test_kernel_equals_plain(table, depth, A, B):
    inc, topics = table
    args = _operands(inc, topics, depth, B)
    before = walk_kernel.launches
    acc, aover = nfa_walk(*args, active_slots=A)
    torch.cuda.synchronize()
    assert walk_kernel.launches == before + 1
    acc_p, aover_p = nfa_walk_plain(*args, active_slots=A)
    assert torch.equal(acc, acc_p)
    assert torch.equal(aover, aover_p)
    if A in (1, 2, 12):
        assert int((aover_p > 0).sum()) > 0, "the spill case must spill"


@pytest.mark.cuda
def test_flat_match_on_card_equals_cpu(table):
    inc, topics = table
    args = _operands(inc, topics, 16, 2048)
    kw = dict(active_slots=16, max_matches=8, flat_cap=4 * 2048)
    got = nfa_match(*args, **kw)
    want = nfa_match(*[a.cpu() for a in args], **kw)
    for f in ("matches", "n_matches", "active_overflow", "match_overflow",
              "row_meta"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


#: (D, A) of the flat cases: C = 446, 190, 62, 190 and 18 accept slots a
#: row; A = 1 puts 128 rows in a block (64 KB of row lists at K = 128)
FLAT_SHAPES = [(16, 16), (8, 16), (4, 16), (8, 32), (8, 1)]
FIELDS = ("matches", "n_matches", "active_overflow", "match_overflow",
          "row_meta")


def _flat_caps(n, K: int, B: int):
    """A roomy cap, one at every id, one that ends inside a row's segment
    (that row cut, the later ones dropped) and a cap of one id."""
    nk = torch.clamp(n, max=K)
    offs = torch.cumsum(nk, 0) - nk
    caps = [8 * max(B, 1), max(1, int(nk.sum())), 1]
    inside = torch.nonzero(nk >= 2).flatten()
    if len(inside):
        caps.append(int(offs[inside[len(inside) // 3]]) + 1)
    return caps


def _flat_plain(backend, args, A, K, cap):
    """The plain walk and ``flat_epilogue_plain`` on the same card
    tensors: the five fields."""
    plain = (walk_kernel.nfa_walk_flat_plain if backend == "hash"
             else walk_kernel.join_walk_flat_plain)
    return plain(*args, active_slots=A, max_matches=K, flat_cap=cap)


def _flat_args(backend, table, join_table, depth, B):
    if backend == "hash":
        inc, topics = table
        return _operands(inc, topics, depth, B), nfa_match
    inc, jarrs, topics = join_table
    return _join_operands(inc, jarrs, topics[::-1], depth, B), join_match


@pytest.mark.cuda
@pytest.mark.parametrize("K", [4, 128])
@pytest.mark.parametrize("depth,A", FLAT_SHAPES)
@pytest.mark.parametrize("backend", ["hash", "join"])
def test_flat_walk_kernel_equals_plain(table, join_table, backend, depth, A,
                                       K):
    """The flat mode of both walks (K3 fused) against the plain walk and
    ``flat_epilogue_plain``, all five fields bit for bit: rows past K,
    caps that cut a row and drop the later ones, the -1 tail, B = 2048,
    1000 (no whole number of tiles), 1 and 0; one launch a call."""
    for B in (2048, 1000, 1, 0):
        args, match = _flat_args(backend, table, join_table, depth, B)
        n = _flat_plain(backend, args, A, K, 1)[1]
        for cap in _flat_caps(n, K, B):
            before = walk_kernel.flat_launches
            got = match(*args, active_slots=A, max_matches=K, flat_cap=cap)
            assert walk_kernel.flat_launches == before + (B > 0)
            want = _flat_plain(backend, args, A, K, cap)
            for f, w in zip(FIELDS, want):
                assert torch.equal(getattr(got, f), w), (f, B, cap)


def _wide_batch(table, B):
    """``B`` topics of the table's, cycled: a grid of B / 8 blocks at
    A = 16, wider than the card holds at once."""
    inc, topics = table
    return _operands(inc, (topics * (B // len(topics) + 1))[:B], 16, B)


@pytest.mark.cuda
def test_flat_walk_kernel_wide_grid_and_two_streams(table, join_table):
    """B = 65,536 (8,192 blocks: later tiles' look-backs wait for tiles
    that are still walking) on one stream while a 2048-topic join match
    and a hash match run on a second, all at once; each equals its plain
    version, and the two streams have their own look-back state."""
    K, cap = 128, 8 * 65536
    wide = _wide_batch(table, 65536)
    jargs, _ = _flat_args("join", table, join_table, 16, 2048)
    hargs, _ = _flat_args("hash", table, join_table, 4, 2048)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    got = {}
    for rep in range(3):
        with torch.cuda.stream(s1):
            got["wide"] = nfa_match(*wide, active_slots=16, max_matches=K,
                                    flat_cap=cap)
        with torch.cuda.stream(s2):
            got["join"] = join_match(*jargs, active_slots=16, max_matches=K,
                                     flat_cap=8 * 2048)
            got["hash"] = nfa_match(*hargs, active_slots=16, max_matches=K,
                                    flat_cap=8 * 2048)
        torch.cuda.synchronize()
        for name, (backend, args, c) in {
                "wide": ("hash", wide, cap),
                "join": ("join", jargs, 8 * 2048),
                "hash": ("hash", hargs, 8 * 2048)}.items():
            want = _flat_plain(backend, args, 16, K, c)
            for f, w in zip(FIELDS, want):
                assert torch.equal(getattr(got[name], f), w), (rep, name, f)
    dev = torch.device("cuda", torch.cuda.current_device())
    assert (walk_kernel.flat_scratch(dev, s1.cuda_stream)
            is not walk_kernel.flat_scratch(dev, s2.cuda_stream))


@pytest.mark.cuda
def test_flat_match_is_one_launch(table, join_table):
    """On the card the flat mode of both walks (and ``DeviceNfa.match``)
    is one launch of the walk's flat kernel, counted in ``flat_launches``
    and in the walk's own count, and no other kernel runs (a profiler
    trace); compact and raw modes launch the raw walk."""
    from torch.profiler import ProfilerActivity, profile

    inc, topics = table
    args = _operands(inc, topics, 16, 2048)
    kw = dict(active_slots=16, max_matches=128, flat_cap=8 * 2048)
    nfa_match(*args, **kw)   # the stream's look-back state is made
    torch.cuda.synchronize()
    walk_kernel.flat_launches = walk_kernel.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        nfa_match(*args, **kw)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "flat" in kernels[0], kernels
    assert (walk_kernel.flat_launches, walk_kernel.launches) == (1, 1)
    nfa_match(*args, active_slots=16, max_matches=128)
    nfa_match(*args, active_slots=16, compact_output=False)
    assert (walk_kernel.flat_launches, walk_kernel.launches) == (1, 3)
    jinc, jarrs, jtopics = join_table
    walk_kernel.join_launches = 0
    join_match(*_join_operands(jinc, jarrs, jtopics, 8, 512),
               active_slots=16, max_matches=128, flat_cap=8 * 512)
    assert (walk_kernel.flat_launches, walk_kernel.join_launches) == (2, 1)
    dev = DeviceNfa(inc, device="cuda")
    enc = encode_batch(inc, topics[:256], batch=256, depth=16)
    dev.match(*dev.put_batch(*enc), flat_cap=8 * 256)
    assert walk_kernel.flat_launches == 3
    acc, aover = nfa_walk(*args, active_slots=16)
    from emqx_tpu_torch.ops.match_kernel import epilogue
    with pytest.raises(ValueError, match="one fused walk launch"):
        epilogue(acc, aover, 128, True, 8 * 2048)


@pytest.mark.cuda
def test_kernel_rejects_cpu_cuda_mix(table):
    inc, topics = table
    args = _operands(inc, topics, 4, 64)
    args[3] = args[3].cpu()
    with pytest.raises(ValueError, match="node_tab"):
        nfa_walk(*args, active_slots=16)


@pytest.fixture(scope="module")
def join_table():
    """A table's join relation after a churn through the device table's
    mirror (on the CPU): tombstones, revivals and overlay rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    inc, topics = _build_table()
    dev = DeviceNfa(inc, device="cpu")
    dev.enable_join()
    rng = np.random.default_rng(3)
    live = [f for f in inc.accept_filters if f is not None]
    gone = [live[i] for i in rng.choice(len(live), 300, replace=False)]
    for f in gone:
        inc.remove(f)
    for f in gone[:20] + [f"zz{i}/new/+" for i in range(40)]:
        inc.add(f)
    dev.sync()
    start, word, nxt, overlay = dev._jarrs
    assert (nxt[:int(start[-1])] == -1).any()
    assert (overlay[:, 0] != int(OVERLAY_EMPTY)).sum() >= 40
    return inc, dev._jarrs, topics + [f"zz{i}/new/x" for i in range(40)]


def _join_operands(inc, jarrs, topics, depth, B):
    enc = encode_batch(inc, topics[:B], batch=B, depth=depth)
    arrs = enc + (inc.node_tab,)
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in arrs] + [a.cuda() for a in jarrs]


@pytest.mark.cuda
@pytest.mark.parametrize("depth,A,B", [(4, 16, 64), (8, 2, 2048),
                                       (16, 16, 2048)] + LAYOUT_CASES)
def test_join_kernel_equals_plain(join_table, depth, A, B):
    inc, jarrs, topics = join_table
    args = _join_operands(inc, jarrs, topics[::-1], depth, B)
    before = (walk_kernel.launches, walk_kernel.join_launches)
    acc, aover = join_walk(*args, active_slots=A)
    torch.cuda.synchronize()
    assert (walk_kernel.launches, walk_kernel.join_launches) == (
        before[0], before[1] + 1)
    acc_p, aover_p = join_walk_plain(*args, active_slots=A)
    assert torch.equal(acc, acc_p)
    assert torch.equal(aover, aover_p)
    if A == 2:
        assert int((aover_p > 0).sum()) > 0


@pytest.mark.cuda
def test_flat_join_match_on_card_equals_cpu(join_table):
    inc, jarrs, topics = join_table
    args = _join_operands(inc, jarrs, topics[::-1], 16, 2048)
    kw = dict(active_slots=16, max_matches=8, flat_cap=4 * 2048)
    got = join_match(*args, **kw)
    want = join_match(*[a.cpu() for a in args], **kw)
    for f in ("matches", "n_matches", "active_overflow", "match_overflow",
              "row_meta"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("i,name", [(3, "node_tab"), (5, "edge_word"),
                                    (7, "overlay")])
def test_join_kernel_rejects_cpu_cuda_mix(join_table, i, name):
    inc, jarrs, topics = join_table
    args = _join_operands(inc, jarrs, topics, 4, 64)
    args[i] = args[i].cpu()
    with pytest.raises(ValueError, match=name):
        join_walk(*args, active_slots=16)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["hash", "auto"])
def test_serve_loop_on_card_hints_equal_router(backend):
    """The broker's publish path on the card at a small size: filters
    subscribed through the broker, the service started on CUDA (its
    warm-up builds the kernels), 2,048 topics prefetched in batches of
    256; every hint equals ``router.match_routes``, and the walks
    launched are the dispatches plus the autotuner's measurements, whose
    recorded times are the walks' (under a millisecond)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    filters, topics = build_workload(np.random.default_rng(5), 5000, 2048)

    async def main():
        b = Broker()
        for i, f in enumerate(filters + EDGE_FILTERS):
            cid = f"c{i % 64}"
            if cid not in b.sessions:
                b.open_session(cid)
            b.subscribe(cid, f)
        # no waiter may fall back to the host on a slow first batch: the
        # test holds the answers, not the latency
        ms = MatchService(b, Metrics(), backend=backend, bypass_rate=0,
                          debounce_s=0.01, prefetch_timeout_s=30)
        assert ms.dev.device.type == "cuda"
        await ms.start()
        try:
            for _ in range(2000):
                if ms.ready:
                    break
                await asyncio.sleep(0.01)
            assert ms.ready
            b.device_match = ms.hint_routes
            launches0 = walk_kernel.launches + walk_kernel.join_launches
            for lo in range(0, len(topics), 256):
                batch = topics[lo:lo + 256] + EDGE_TOPICS
                await asyncio.gather(*[ms.prefetch(t) for t in batch])
                for t in batch:
                    hint = ms.hint_routes(t)
                    assert hint is not None, t
                    assert sorted(hint) == sorted(b.router.match_routes(t))
            launched = (walk_kernel.launches + walk_kernel.join_launches
                        - launches0)
            assert ms.dispatches >= 8
            assert launched == ms.dispatches + ms.autotune_launches
            if backend == "auto":
                # the walks' own times (microseconds), not host waits
                assert ms.tuner.measured
                assert all(0 < us < 1000 for t in ms.tuner.measured.values()
                           for us in t.values()), ms.tuner.measured
        finally:
            await ms.stop()
            gc.unfreeze()       # the service froze the started heap
    asyncio.run(main())


# -- the two-phase readback and the overlapped pipeline on the card --------

def _card_service(filters, **kw):
    """A broker-less service on the card with ``filters`` loaded and
    synced (Python table, depth 16)."""
    ms = MatchService(table="python", depth=16, **kw)
    ms.load(filters)
    ms.sync()
    return ms


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["chunked", "ragged", "auto"])
def test_two_phase_readback_equals_slab_on_card(table, mode):
    """Real walk results read back in two phases, one group at a time
    and all groups in one slot, through the pipeline's pinned buffers
    and events, equal the slab readback bit for bit; the bytes are
    4·(B + Σcounts) (chunked) or 4·(B + the capacity class) (ragged,
    and auto off the powers of two)."""
    inc, topics = table
    filters = [f for f in inc.accept_filters if f is not None]
    ms = _card_service(filters, readback_mode=mode)
    assert ms.dev.device.type == "cuda"
    batch = topics[:1500]
    groups = ms._depth_groups(batch)
    handles = ms._encode_dispatch(batch, groups)
    k = ms.dev.max_matches
    slab = [MatchService._readback_rows(res, n, k) for res, n in handles]
    want_bytes = 0
    for (res, n), (rows, sp) in zip(handles, slab):
        one = ms._make_slot([], [], [], [(res, n)], ms.inc.aid_reuses,
                            ms._table_gen, 0, 0)
        [got_rows], nbytes, _s, waits = asyncio.run(ms._readback_slot(one))
        ms._release_slot(one)
        got = got_rows + (nbytes, waits)
        assert got[:2] == (rows, sp)
        total = sum(len(r) for r in rows)
        flat_cap = int(res.matches.shape[0])
        count = MatchService._phase2_count(total, flat_cap, mode, 1.0)
        assert count == (total if mode == "chunked" or
                         (mode == "auto" and total & (total - 1) == 0)
                         else ragged_capacity(total, flat_cap))
        assert got[2] == 4 * (int(res.row_meta.numel()) + count)
        assert got[3] == 2
        want_bytes += got[2]
    slot = ms._make_slot([], batch, groups, handles, ms.inc.aid_reuses,
                         ms._table_gen, 0, 0)
    assert slot.event is not None
    results, nbytes, _s, waits = asyncio.run(ms._readback_slot(slot))
    assert results == slab
    assert nbytes == want_bytes and waits == 2


@pytest.mark.cuda
def test_pipeline_hints_equal_router_under_churn():
    """The pipelined service on the card, ``auto`` readback: 2,048
    topics prefetched in batches of 256 while filters come and go
    between them; every hint equals ``router.match_routes`` and the
    walks launched are the dispatches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    filters, topics = build_workload(np.random.default_rng(5), 5000, 2048)
    fresh, _ = build_workload(np.random.default_rng(6), 400, 1)

    async def main():
        b = Broker()
        for i, f in enumerate(filters + EDGE_FILTERS):
            cid = f"c{i % 64}"
            if cid not in b.sessions:
                b.open_session(cid)
            b.subscribe(cid, f)
        m = Metrics()
        ms = MatchService(b, m, bypass_rate=0, debounce_s=0.01,
                          prefetch_timeout_s=30, pipeline=True,
                          readback_mode="auto")
        await ms.start()
        try:
            for _ in range(2000):
                if ms.ready:
                    break
                await asyncio.sleep(0.01)
            assert ms.ready
            b.device_match = ms.hint_routes
            launches0 = walk_kernel.launches
            d0 = ms.dispatches
            b.open_session("churn")
            for j, lo in enumerate(range(0, len(topics), 256)):
                for f in fresh[j * 50:(j + 1) * 50]:
                    b.subscribe("churn", f)
                for i in range(j * 50, (j + 1) * 50):
                    b.unsubscribe(f"c{i % 64}", filters[i])
                batch = topics[lo:lo + 256] + EDGE_TOPICS
                await ms.prefetch_many({t: 0 for t in batch})
                for t in batch:
                    hint = ms.hint_routes(t)
                    if hint is not None:
                        assert sorted(hint) == \
                            sorted(b.router.match_routes(t)), t
            assert m.get("tpu.match.hint_served") > len(topics) // 2
            assert walk_kernel.launches - launches0 == ms.dispatches - d0
            assert m.get("broker.match.pipeline_inflight") == 0
        finally:
            await ms.stop()
            gc.unfreeze()
    asyncio.run(main())


@pytest.mark.cuda
def test_pipeline_slot_wait_keeps_the_loop_responsive():
    """A slot whose walk queues behind ~0.3 s of ``torch.cuda._sleep``:
    its prefetch waits for it, and a heartbeat task on the same loop
    keeps beating through the wait (nothing of the pipeline blocks the
    loop on the card).  A wait on the card would hold the loop for the
    rest of the sleep; the chip machine's own scheduling holds a loop
    with nothing else on it up to ~15 ms between 1 ms beats
    (``scripts/torch_slot_wait_probe.py``: gaps over 5 ms in half its
    idle runs, with no step of the service in them), so the bound on a
    gap sits between the two, at 50 ms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    filters, topics = build_workload(np.random.default_rng(7), 2000, 512)

    async def main():
        b = Broker()
        b.open_session("c")
        for f in filters:
            b.subscribe("c", f)
        ms = MatchService(b, Metrics(), bypass_rate=0, debounce_s=0.01,
                          prefetch_timeout_s=30, pipeline=True)
        await ms.start()
        try:
            for _ in range(2000):
                if ms.ready:
                    break
                await asyncio.sleep(0.01)
            assert ms.ready
            await ms.prefetch_many(topics[:256])   # buffers allocated
            loop = asyncio.get_running_loop()
            gaps = []
            stop = asyncio.Event()

            async def heartbeat():
                last = loop.time()
                while not stop.is_set():
                    await asyncio.sleep(0.001)
                    now = loop.time()
                    gaps.append(now - last)
                    last = now

            beat = asyncio.ensure_future(heartbeat())
            await asyncio.sleep(0.01)
            t0 = loop.time()
            torch.cuda._sleep(600_000_000)      # ~0.3 s at boost clock
            await ms.prefetch_many(topics[256:])
            waited = loop.time() - t0
            stop.set()
            await beat
            assert waited > 0.1, "the slot did not wait for the card"
            assert all(ms._hints.get(t) is not None for t in topics[256:])
            assert max(gaps) < 0.05, max(gaps)
            assert len(gaps) >= 50, len(gaps)
        finally:
            await ms.stop()
            gc.unfreeze()
    asyncio.run(main())


@pytest.mark.cuda
def test_pipeline_delta_between_slots_on_card():
    """Two slots in flight behind a ``torch.cuda._sleep``; a
    subscription's row delta is written (on the same stream) between
    their dispatches: the earlier slot's rows lack the new filter, the
    later one's hold it.  On the native table (the node default), with
    a freed and acked accept id waiting: while a slot is in flight the
    new filter takes a fresh id, so that neither slot is discarded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")

    async def main():
        b = Broker()
        b.open_session("c")
        for i in range(200):
            b.subscribe("c", f"a/+/x{i}")
        m = Metrics()
        ms = MatchService(b, m, bypass_rate=0, debounce_s=0.0,
                          prefetch_timeout_s=30, pipeline=True)
        await ms.start()
        try:
            for _ in range(2000):
                if ms.ready:
                    break
                await asyncio.sleep(0.01)
            assert ms.ready
            b.unsubscribe("c", "a/+/x199")      # frees an accept id
            while ms._synced_epoch != b.router.epoch:
                await asyncio.sleep(0.001)
            reuses = ms.inc.aid_reuses
            loop = asyncio.get_running_loop()
            topics = [f"a/{i}/x{i}" for i in range(100)]
            groups = ms._depth_groups(topics)

            def slot():
                pending = [(t, loop.create_future()) for t in topics]
                return ms._make_slot(
                    pending, topics, groups,
                    ms._encode_dispatch(topics, groups),
                    ms.inc.aid_reuses, ms._table_gen, ms._synced_epoch,
                    ms._synced_rule_gen)

            torch.cuda._sleep(600_000_000)
            s1 = slot()
            b.subscribe("c", "a/#")
            while ms._synced_epoch != b.router.epoch:
                await asyncio.sleep(0.001)
            assert ms.inc.aid_reuses == reuses   # a fresh id for a/#
            uploads = ms.dev.uploads
            s2 = slot()
            assert not s1.event.query(), "the first slot already finished"
            await ms._finish_slot(s1)
            one = [sorted(ms._hints[t][2]) for t in topics]
            await ms._finish_slot(s2)
            two = [sorted(ms._hints[t][2]) for t in topics]
            assert ms.dev.uploads == uploads     # rows written in place
            assert m.get("broker.match.cpu_fallback") == 0
            assert all("a/#" not in h for h in one)
            assert all("a/#" in h for h in two)
        finally:
            await ms.stop()
            gc.unfreeze()
    asyncio.run(main())


# -- the port's node on the card, over TCP ----------------------------------

@pytest.mark.cuda
def test_node_on_card_delivers_the_host_routes():
    """A 100k-filter ``BrokerNode`` at the node defaults on ``cuda:0``,
    driven over TCP by the port's MQTT client: 100 clients subscribe 1,000
    filters each at QoS 1, 64 publishers publish 2,048 workload topics at
    QoS 1 (each awaiting its PUBACK); every client receives each message
    once per filter of its own that matches (``router.match_routes``),
    and the walks launched equal the service's dispatches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from collections import Counter

    from emqx_tpu_torch.client import Client
    from emqx_tpu_torch.config import Config
    from emqx_tpu_torch.node import BrokerNode

    filters, topics = build_workload(np.random.default_rng(7), 100_000,
                                     2048)

    async def main():
        cfg = Config(env={})
        cfg.put("listeners.tcp.default.bind", "127.0.0.1:0")
        node = BrokerNode(cfg)
        await node.start()
        try:
            ms = node.match_service
            assert ms.dev.device.type == "cuda"
            port = node.listeners.all()[0].port
            got = Counter()
            subs = []
            for k in range(100):
                def on_message(m, cid=f"s{k}"):
                    got[(cid, int(m.payload))] += 1
                c = Client(clientid=f"s{k}", port=port,
                           on_message=on_message)
                await c.connect()
                await c.subscribe([(f, 1) for f in
                                   filters[k * 1000:(k + 1) * 1000]])
                subs.append(c)
            router = node.broker.router
            for _ in range(6000):
                if (ms.ready and ms._synced_epoch == router.epoch
                        and ms.dev.epoch == ms.inc.epoch):
                    break
                await asyncio.sleep(0.01)
            pubs = []
            for k in range(64):
                c = Client(clientid=f"p{k}", port=port)
                await c.connect()
                pubs.append(c)
            walk_kernel.launches = 0
            d0 = ms.dispatches

            async def publisher(k):
                for i in range(k, len(topics), 64):
                    await pubs[k].publish(topics[i], b"%d" % i, qos=1)
            await asyncio.gather(*[publisher(k) for k in range(64)])
            launched, dispatched = walk_kernel.launches, ms.dispatches - d0
            want = Counter()
            for i, t in enumerate(topics):
                for flt, _dest in router.match_routes(t):
                    for cid in node.broker.subscribers.get(flt, ()):
                        want[(cid, i)] += 1
            for _ in range(3000):
                if sum(got.values()) >= sum(want.values()):
                    break
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.2)
            assert got == want
            assert sum(want.values()) > len(topics)
            assert dispatched > 0 and launched == dispatched
            m = node.observed.metrics
            assert m.get("tpu.match.hint_served") > 0
            for c in subs + pubs:
                await c.disconnect()
        finally:
            await node.stop()
            gc.unfreeze()       # the service froze the started heap
    asyncio.run(main())


# -- the rule engine's and the ACL batch's walks on the card ------------------

def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.cuda
def test_match_topics_on_card_equals_cpu():
    """``match_topics`` (encode, one hash walk, decode) of a compiled
    table: on ``cuda`` it launches the kernel once and gives the plain
    walk's rows on the CPU, filter for filter."""
    _skip_without_card()
    from emqx_tpu_torch.ops import compile_filters, match_topics

    filters, topics = build_workload(np.random.default_rng(3), 3000, 2048)
    table = compile_filters(filters)
    walk_kernel.launches = 0
    got = match_topics(table, topics, max_matches=64, device="cuda")
    assert walk_kernel.launches == 1
    assert got == match_topics(table, topics, max_matches=64, device="cpu")
    assert sum(map(len, got)) > len(topics)


@pytest.mark.cuda
def test_batch_authorize_on_card_equals_host_authz():
    """1,000 static ACL rules (a ``FileSource`` and a ``BuiltinDbSource``
    with global rules only), 2,048 topics: every verdict of the walk on
    the card equals the host ``Authz`` pipeline's, for both actions and
    both ``no_match`` policies."""
    _skip_without_card()
    import random

    from emqx_tpu_torch.auth import (AclRule, Authz, BuiltinDbSource,
                                     FileSource, batch_authorize,
                                     compile_acl_batch)

    filters, topics = build_workload(np.random.default_rng(4), 1000, 2048)
    rng = random.Random(4)
    rules = [AclRule(rng.choice(["allow", "deny"]),
                     rng.choice(["publish", "subscribe", "all"]), [f])
             for f in filters]
    db = BuiltinDbSource()
    db.set_rules(rules[900:])
    sources = [FileSource(rules[:900]), db]
    table, idx = compile_acl_batch(sources)
    for action in ("publish", "subscribe"):
        for no_match in ("allow", "deny"):
            walk_kernel.launches = 0
            got = batch_authorize(table, idx, topics, action,
                                  no_match=no_match, device="cuda")
            assert walk_kernel.launches == 1
            az = Authz(sources, no_match=no_match, cache_enable=False)
            assert got == [az.authorize("c", action, t) for t in topics]
            assert 0 < sum(got) < len(got)


@pytest.mark.cuda
def test_node_on_card_fires_a_cobatched_rule_from_its_hint():
    """A ``BrokerNode`` on ``cuda:0`` over TCP: a rule created through
    ``node.rule_engine`` is co-batched into the walk's table; a QoS 1
    publish's prefetch walks on the card, the engine takes the rule ids
    from ``hint_rules`` and the rule republishes to a subscriber
    (``tpu.match.hint_served`` grows, launches equal dispatches)."""
    _skip_without_card()
    from emqx_tpu_torch.client import Client
    from emqx_tpu_torch.config import Config
    from emqx_tpu_torch.node import BrokerNode

    async def main():
        cfg = Config(env={})
        cfg.put("listeners.tcp.default.bind", "127.0.0.1:0")
        cfg.put("tpu.bypass_rate", 0.0)
        node = BrokerNode(cfg)
        await node.start()
        try:
            ms = node.match_service
            assert ms.dev.device.type == "cuda"
            hits = []
            node.rule_engine.create_rule(
                "hot", 'SELECT payload.temp as t FROM "sensors/+/temp" '
                "WHERE payload.temp > 30",
                actions=[{"function": "republish",
                          "args": {"topic": "alert/${t}", "qos": 1}},
                         lambda out, cols: hits.append(out["t"])])
            served = []
            inner = ms.hint_rules

            def counted(topic):
                ids = inner(topic)
                served.append((topic, ids))
                return ids
            ms.hint_rules = counted
            port = node.listeners.all()[0].port
            sink = Client(clientid="sink", port=port)
            await sink.connect()
            await sink.subscribe([("alert/#", 1)])
            pub = Client(clientid="pub", port=port)
            await pub.connect()
            for _ in range(3000):
                if (ms.ready and ms._synced_epoch == node.broker.router.epoch
                        and ms._synced_rule_gen == ms._rule_gen):
                    break
                await asyncio.sleep(0.01)
            m = node.observed.metrics
            h0 = m.get("tpu.match.hint_served")
            walk_kernel.launches = 0
            d0 = ms.dispatches
            for i, temp in enumerate((35, 5, 41)):
                await pub.publish(f"sensors/k{i}/temp",
                                  b'{"temp": %d}' % temp, qos=1)
            got = [await sink.recv(timeout=10) for _ in range(2)]
            assert sorted(g.topic for g in got) == ["alert/35", "alert/41"]
            assert hits == [35, 41]
            # the republished messages were never prefetched: the host
            # matches the rules for them
            assert served == [("sensors/k0/temp", ["hot"]),
                              ("alert/35", None),
                              ("sensors/k1/temp", ["hot"]),
                              ("sensors/k2/temp", ["hot"]),
                              ("alert/41", None)]
            assert m.get("tpu.match.hint_served") > h0
            assert ms.dispatches > d0 and walk_kernel.launches == \
                ms.dispatches - d0
            await sink.disconnect()
            await pub.disconnect()
        finally:
            await node.stop()
            gc.unfreeze()
    asyncio.run(main())


# -- the deadline plane and the table lifecycle on the card -------------------

async def _until(pred, timeout=30.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred() and loop.time() < deadline:
        await asyncio.sleep(0.002)
    return pred()


def _slab_ptrs(slot):
    return {t.data_ptr() for host in slot.slab for t in host}


@pytest.mark.cuda
def test_dispatch_timeout_over_a_real_sleep_is_answered_by_the_host():
    """A batch whose walk queues behind ~0.5 s of ``torch.cuda._sleep``:
    the deadline loop answers it from the host tables within the
    dispatch timeout (plus the budget and 0.15 s of slack), the loop
    keeps beating through the hang (gaps under 50 ms), the batch keeps
    its pinned slab until its event completes and a batch that times
    out behind it is handed none of those buffers; once the sleep ends
    the card serves again, with the router's answers."""
    _skip_without_card()
    filters, topics = build_workload(np.random.default_rng(8), 2000, 2048)
    # distinct topics: none of a batch below has a hint before it
    topics = list(dict.fromkeys(topics))
    assert len(topics) >= 256

    async def main():
        b = Broker()
        b.open_session("c")
        for f in filters:
            b.subscribe("c", f)
        ms = MatchService(b, Metrics(), bypass_rate=0, debounce_s=0.01,
                          prefetch_timeout_s=30, deadline=True,
                          dispatch_timeout_s=0.1, breaker_threshold=5)
        await ms.start()
        try:
            assert await _until(lambda: ms.ready, 60)
            await ms.prefetch_many(topics[:64])
            # the rate window held shut with the rate high and the short
            # share at one half: each prefetch_many below is one batch,
            # forced out by its budget
            ms._rate_ewma = 1e9
            ms._win_start = float("inf")
            ms._short_frac = 0.5
            loop = asyncio.get_running_loop()
            gaps = []
            stop = asyncio.Event()

            async def heartbeat():
                last = loop.time()
                while not stop.is_set():
                    await asyncio.sleep(0.001)
                    now = loop.time()
                    gaps.append(now - last)
                    last = now

            beat = asyncio.ensure_future(heartbeat())
            await asyncio.sleep(0.01)
            torch.cuda._sleep(1_000_000_000)    # ~0.5 s at boost clock
            t0 = loop.time()
            await ms.prefetch_many(topics[64:96])
            took = loop.time() - t0
            assert took < ms.dispatch_timeout_s + ms.deadline_s + 0.15, took
            assert ms._breaker_failures == 1
            assert len(ms._timed_out) == 1
            first = ms._timed_out[0][1]
            assert not first.event.query()
            await ms.prefetch_many(topics[96:128])    # times out behind it
            assert len(ms._timed_out) == 2
            second = ms._timed_out[1][1]
            assert not (_slab_ptrs(first) & _slab_ptrs(second))
            for t in topics[64:128]:
                hint = ms._hints[t]
                assert hint[4], "a timed-out batch got a device answer"
                assert sorted(b.router.match_routes(t), key=repr) == sorted(
                    ms.hint_routes(t), key=repr)
            stop.set()
            await beat
            assert max(gaps) < 0.05, max(gaps)
            assert await _until(lambda: first.event.query(), 10)
            await ms.prefetch_many(topics[128:256])
            assert ms._breaker_failures == 0 and not ms._breaker_open
            assert ms._timed_out == []
            for t in topics[128:256]:
                hint = ms._hints[t]
                assert not hint[4], "the card did not serve after the hang"
                assert sorted(b.router.match_routes(t), key=repr) == sorted(
                    ms.hint_routes(t), key=repr)
        finally:
            await ms.stop()
            gc.unfreeze()
    asyncio.run(main())


@pytest.mark.cuda
@pytest.mark.parametrize("edge_bucket", [1 << 16, 8])
def test_grow_in_place_on_card_equals_full_upload(edge_bucket):
    """A Python table in region mode grows past its node table (and, from
    a tiny edge table, through cuckoo rehashes): the card's tables grow
    in place, bit-equal to a whole upload of the same host table, and
    both walks answer as on a fresh upload."""
    _skip_without_card()
    filters, topics = build_workload(np.random.default_rng(9), 3000, 512,
                                     depth=8)
    inc = IncrementalNfa(depth=8, state_bucket=1024, edge_bucket=edge_bucket)
    inc.track_regions = True
    for f in filters[:200]:
        inc.add(f)
    dev = DeviceNfa(inc, active_slots=16, max_matches=32)
    dev.dirty_regions = True
    dev.dirty_full_threshold = 1.0
    dev.enable_join()
    uploads = dev.uploads
    for f in filters[200:]:
        inc.add(f)
    dev.sync()
    assert dev.uploads == uploads and dev.grow_applies >= 1
    full = DeviceNfa(inc, active_slots=16, max_matches=32)
    full.enable_join()
    for a, b in zip(dev.arrays(), full.arrays()):
        assert a.device.type == "cuda" and torch.equal(a, b)
    enc = encode_batch(inc, topics, batch=512, depth=8)
    for be in ("hash", "join"):
        got = dev.match(*dev.put_batch(*enc), backend=be)
        want = full.match(*full.put_batch(*enc), backend=be)
        assert torch.equal(got.matches, want.matches), be
        assert torch.equal(got.n_matches, want.n_matches), be


@pytest.mark.cuda
def test_compaction_swap_discards_a_pipelined_slot_on_card(tmp_path):
    """A pipelined slot queued behind a ``torch.cuda._sleep`` while a
    compaction swaps the table in (its upload on a stream of its own):
    the table generation discards the slot, whose waiters the host
    answers; the next batch walks the swapped-in table on the card, and
    the swap left no freed id held."""
    _skip_without_card()
    filters, topics = build_workload(np.random.default_rng(10), 2000, 2048)
    topics = list(dict.fromkeys(topics))      # no hint before its batch
    assert len(topics) >= 256

    async def main():
        b = Broker()
        b.open_session("c")
        for f in filters:
            b.subscribe("c", f)
        m = Metrics()
        ms = MatchService(b, m, bypass_rate=0, debounce_s=0.01,
                          prefetch_timeout_s=30, pipeline=True,
                          segments=True, segments_dir=str(tmp_path),
                          compact_interval_s=3600)
        await ms.start()
        try:
            # made at start: a process's first stream waits for the card
            assert ms._build_stream is not None
            assert await _until(lambda: ms.ready, 60)
            await ms.prefetch_many(topics[:64])
            gen = ms._table_gen
            torch.cuda._sleep(4_000_000_000)    # ~2 s: the build fits
            task = asyncio.ensure_future(ms.prefetch_many(topics[64:128]))
            assert await _until(lambda: ms._inflight_n >= 1, 5)
            old_dev = ms.dev
            assert await ms._compact_once()
            assert ms._table_gen == gen + 1 and ms.dev is not old_dev
            assert ms.dev._id_holds == 0
            assert ms._inflight_n >= 1, "the slot finished before the swap"
            await task
            assert m.get("broker.match.cpu_fallback") == 64
            for t in topics[64:128]:
                assert ms._hints[t][4]
                assert sorted(b.router.match_routes(t), key=repr) == sorted(
                    ms.hint_routes(t), key=repr)
            await ms.prefetch_many(topics[128:256])
            for t in topics[128:256]:
                assert not ms._hints[t][4]
                assert sorted(b.router.match_routes(t), key=repr) == sorted(
                    ms.hint_routes(t), key=repr)
            assert old_dev._id_holds == 0
        finally:
            await ms.stop()
            gc.unfreeze()
    asyncio.run(main())


@pytest.mark.cuda
def test_node_on_card_with_deadline_and_segments(tmp_path):
    """A ``BrokerNode`` with ``match.deadline.enable`` and
    ``match.segments.enable`` on ``cuda:0``, driven over TCP: 20 clients
    subscribe 500 workload filters each at QoS 1, a compaction swaps the
    table in (its segment written under ``match.segments.dir``), then 32
    publishers publish 1,024 topics at QoS 1; every client receives each
    message once per matching filter of its own, through the deadline
    loop, with no batch answered by the host."""
    _skip_without_card()
    from collections import Counter

    from emqx_tpu_torch.client import Client
    from emqx_tpu_torch.config import Config
    from emqx_tpu_torch.node import BrokerNode

    filters, topics = build_workload(np.random.default_rng(11), 10_000, 1024)

    async def main():
        cfg = Config(env={})
        cfg.put("listeners.tcp.default.bind", "127.0.0.1:0")
        cfg.put("match.deadline.enable", True)
        cfg.put("match.segments.enable", True)
        cfg.put("match.segments.dir", str(tmp_path))
        cfg.put("match.segments.compact_interval", 0.2)
        cfg.put("match.segments.compact_min_mutations", 1)
        node = BrokerNode(cfg)
        await node.start()
        try:
            ms = node.match_service
            assert ms.dev.device.type == "cuda"
            assert ms.deadline and ms.segments
            m = node.observed.metrics
            port = node.listeners.all()[0].port
            got = Counter()
            subs = []
            for k in range(20):
                def on_message(msg, cid=f"s{k}"):
                    got[(cid, int(msg.payload))] += 1
                c = Client(clientid=f"s{k}", port=port,
                           on_message=on_message)
                await c.connect()
                await c.subscribe([(f, 1) for f in
                                   filters[k * 500:(k + 1) * 500]])
                subs.append(c)
            router = node.broker.router
            assert await _until(lambda: m.get("tpu.table.compact_runs") >= 1
                                and ms._synced_epoch == router.epoch, 120)
            assert ms._table_gen >= 1
            pubs = []
            for k in range(32):
                c = Client(clientid=f"p{k}", port=port)
                await c.connect()
                pubs.append(c)
            fallback0 = m.get("broker.match.cpu_fallback")

            async def publisher(k):
                for i in range(k, len(topics), 32):
                    await pubs[k].publish(topics[i], b"%d" % i, qos=1)
            await asyncio.gather(*[publisher(k) for k in range(32)])
            want = Counter()
            for i, t in enumerate(topics):
                for flt, _dest in router.match_routes(t):
                    for cid in node.broker.subscribers.get(flt, ()):
                        want[(cid, i)] += 1
            assert await _until(lambda: sum(got.values())
                                >= sum(want.values()), 30)
            await asyncio.sleep(0.2)
            assert got == want and sum(want.values()) > len(topics)
            assert m.get("tpu.match.hint_served") > 0
            assert m.get("broker.match.cpu_fallback") == fallback0
            assert not ms._breaker_open and ms._breaker_failures == 0
            for c in subs + pubs:
                await c.disconnect()
        finally:
            await node.stop()
            gc.unfreeze()
    asyncio.run(main())


# -- the dense walk (K6), the two-tier matcher (K7), the retained replay -------

def _dense_mod():
    import importlib

    return importlib.import_module("emqx_tpu_torch.ops.dense_match")


def _random_dense(seed, S, parents):
    return [torch.from_numpy(a).cuda()
            for a in _dense_mod().random_dense(seed, S, parents)]


def _random_batch(seed, B, D):
    return [torch.from_numpy(a).cuda()
            for a in _dense_mod().random_dense_batch(seed, B, D)]


def _dense_fields_equal(got, want):
    for f in ("matches", "n_matches", "active_overflow", "match_overflow"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("S,parents,B,K", [(128, 3, 4096, 64),
                                           (512, 1, 1000, 64),
                                           (512, 4, 4096, 2),
                                           (4096, 2, 2048, 64),
                                           (1024, 150, 333, 16)])
def test_dense_kernel_equals_plain(S, parents, B, K):
    """``dense_walk.cu`` against ``dense_match_plain``, every field bit for
    bit: several parents a column, rows past K, a partly filled last
    block, and a table (S = 1024, up to 150 parents a column) too large
    to stage in shared memory."""
    _skip_without_card()
    dm = _dense_mod()
    dense = _random_dense(S * 10 + parents, S, parents)
    batch = _random_batch(S + B, B, 8)
    dm.launches = 0
    got = dm.dense_match(*batch, *dense, max_matches=K)
    assert dm.launches == 1
    want = dm.dense_match_plain(*batch, *dense, max_matches=K)
    _dense_fields_equal(got, want)
    assert int(want.n_matches.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("S,parents,B", [(512, 3, 4096), (2048, 60, 333)])
def test_dense_kernel_on_wide_frontiers_equals_plain(S, parents, B):
    """One label for every literal edge and one word: frontiers of dozens
    of states (S = 2048 with up to 60 parents a column is too large to
    stage in shared memory)."""
    _skip_without_card()
    dm = _dense_mod()
    dense = [torch.from_numpy(a).cuda()
             for a in dm.random_dense(S * 3 + parents, S, parents, V=1)]
    batch = [torch.from_numpy(a).cuda()
             for a in dm.random_dense_batch(S + B, B, 6, V=1)]
    traffic = {}
    want = dm.dense_match_plain(*batch, *dense, max_matches=64,
                                traffic=traffic)
    assert traffic["states"] >= 24 * traffic["steps"] > 0
    _dense_fields_equal(dm.dense_match(*batch, *dense, max_matches=64), want)


@pytest.mark.cuda
def test_dense_kernel_on_bench_table_and_sys_topics():
    _skip_without_card()
    from emqx_tpu_torch.ops import compile_filters, encode_topics

    dm = _dense_mod()
    filters, table, dense, topics = dm.bench_dense_workload()
    b = [torch.from_numpy(a).cuda() for a in encode_topics(table, topics,
                                                           batch=4096)]
    d = [torch.from_numpy(a).cuda() for a in dense.device_arrays()]
    _dense_fields_equal(dm.dense_match(*b, *d, max_matches=64),
                        dm.dense_match_plain(*b, *d, max_matches=64))
    tab = compile_filters(EDGE_FILTERS + ["+/status"], depth=16)
    b = [torch.from_numpy(a).cuda() for a in encode_topics(
        tab, EDGE_TOPICS + ["$SYS/status", "node/status"], batch=64)]
    d = [torch.from_numpy(a).cuda()
         for a in dm.build_dense(tab).device_arrays()]
    want = dm.dense_match_plain(*b, *d, max_matches=8)
    _dense_fields_equal(dm.dense_match(*b, *d, max_matches=8), want)
    assert int(want.match_overflow.sum()) > 0


@pytest.mark.cuda
def test_dense_kernel_rejects_cpu_cuda_mix():
    _skip_without_card()
    dm = _dense_mod()
    dense = _random_dense(1, 128, 2)
    batch = _random_batch(2, 64, 6)
    dense[0] = dense[0].cpu()
    with pytest.raises(ValueError, match="lmat"):
        dm.dense_match(*batch, *dense)


def _tiered_case():
    from emqx_tpu_torch.ops.tiered import bench_tiered_workload

    return bench_tiered_workload(n_filters=20000, batch=4096)


@pytest.mark.cuda
def test_tiered_matcher_on_card_equals_cpu():
    """``TieredMatcher(hot_engine="auto")`` on the card: one dense launch
    and one hash-walk launch for a batch, the same lists as on the CPU."""
    _skip_without_card()
    from emqx_tpu_torch.ops.tiered import TieredMatcher

    dm = _dense_mod()
    filters, tiered, topics = _tiered_case()
    tm = TieredMatcher(tiered, depth=8, device="cuda")
    dm.launches = 0
    walk_kernel.launches = 0
    got = tm.match(topics)
    assert tm.hot_engine == "dense"
    assert (dm.launches, walk_kernel.launches) == (1, 1)
    assert got == TieredMatcher(tiered, depth=8, device="cpu").match(topics)


@pytest.mark.cuda
def test_fused_tiered_match_has_no_host_sync_and_equals_the_calls():
    _skip_without_card()
    from emqx_tpu_torch.ops import encode_topics
    from emqx_tpu_torch.ops.tiered import _pow2, fused_tiered_match, route

    dm = _dense_mod()
    filters, tiered, topics = _tiered_case()
    hot, cold = route(topics, tiered.hot_roots)

    def put(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                for a in arrays]

    hargs = put(encode_topics(tiered.hot, [topics[i] for i in hot],
                              batch=_pow2(len(hot)))) + put(
        dm.build_dense(tiered.hot).device_arrays())
    cargs = put(encode_topics(tiered.cold, [topics[i] for i in cold],
                              batch=_pow2(len(cold)))) + put(
        tiered.cold.device_arrays())
    dm.dense_match(*hargs)          # builds the packed table
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d, c = fused_tiered_match(hargs, cargs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _dense_fields_equal(d, dm.dense_match(*hargs, max_matches=64))
    _dense_fields_equal(c, nfa_match(*cargs, active_slots=8,
                                     compact_output=False))


@pytest.mark.cuda
def test_retained_replay_on_card_equals_cpu():
    _skip_without_card()
    from emqx_tpu_torch.broker.message import make_message
    from emqx_tpu_torch.services.retainer import Retainer

    filters, names = build_workload(np.random.default_rng(5), 5000, 8000)
    r = Retainer()
    for t in dict.fromkeys(names):
        r.insert(make_message("p", t, b"v", retain=True))
    walk_kernel.launches = 0
    got = r.replay_batch(filters, device="cuda")
    assert walk_kernel.launches == 1
    want = r.replay_batch(filters, device="cpu")
    assert {f: [m.topic for m in v] for f, v in got.items()} == \
        {f: [m.topic for m in v] for f, v in want.items()}


@pytest.mark.cuda
def test_match_sidecar_on_card_equals_cpu():
    """The exhook match sidecar on ``cuda`` answers MatchBatch and
    OnMessagePublish as the CPU sidecar does, with one walk launch per
    device batch beside the warm-up, and no host answer but spills."""
    _skip_without_card()
    import grpc.aio

    from emqx_tpu_torch.exhook.rpc import (HookProviderStub, MirrorSyncStub,
                                           pb)
    from emqx_tpu_torch.exhook.server import TpuMatchSidecar, serve

    filters, topics = build_workload(np.random.default_rng(6), 3000, 512)
    filters = filters + ["a/b/c/d/e/f/g/h/i/+"]     # deeper than 8: alias
    topics = topics + ["a/b/c/d/e/f/g/h/i/j"]

    async def one(device):
        sc = TpuMatchSidecar(device=device, rebuild_debounce_s=0.01,
                             annotate=True, active_slots=4, max_matches=8)
        server, sc = await serve(port=0, sidecar=sc)
        chan = grpc.aio.insecure_channel(f"127.0.0.1:{sc.port}")
        mirror, hooks = MirrorSyncStub(chan), HookProviderStub(chan)
        try:
            async def chunks():
                yield pb.SnapshotChunk(epoch=1, filters=filters, last=True)

            await mirror.InstallSnapshot(chunks())
            for _ in range(3000):
                if sc._engine is not None and not sc._dirty.is_set():
                    break
                await asyncio.sleep(0.01)
            launches0 = walk_kernel.launches
            resp = await mirror.MatchBatch(pb.MatchBatchRequest(
                topics=topics))
            pubs = await asyncio.gather(*(hooks.OnMessagePublish(
                pb.MessagePublishRequest(message=pb.Message(topic=t)))
                for t in topics[:64]))
            rows = [list(r.filter_ids) for r in resp.results]
            counts = [p.message.headers["matched_filters"] for p in pubs]
            return (rows, counts, walk_kernel.launches - launches0,
                    sc.device_batches, sc.host_rows, sc.spill_fallbacks)
        finally:
            await chan.close()
            await sc.stop()
            await server.stop(None)

    walk_kernel.launches = 0
    card = asyncio.run(one("cuda"))
    cpu = asyncio.run(one("cpu"))
    assert card[0] == cpu[0] and card[1] == cpu[1]
    # one launch per device batch (MatchBatch and the publish
    # micro-batches; the warm-up's walk came before the window)
    assert card[2] == card[3] >= 2
    assert card[4] == cpu[4] == 0 and card[5] == cpu[5] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("ep,compact", [(False, False), (True, False),
                                        (True, True)],
                         ids=["replicated", "routed", "routed_compact"])
def test_multichip_step_on_card_equals_plain_and_cpu(ep, compact):
    """The multichip step (K8a) on ``[cuda:0] * 4``: each shard's walk is
    the hash-walk kernel, two launches a shard a dispatch; every field
    equals the step with the plain walk on the same card tables, and the
    matcher's rows equal a CPU mesh's on the same filters (through a
    churn scattered in place and a dead shard's failover)."""
    _skip_without_card()
    from emqx_tpu_torch.parallel import (MultichipMatcher, ShardDead,
                                         build_multichip_step)

    filters, topics = build_workload(np.random.default_rng(8), 20000, 4096)
    inc = IncrementalNfa(depth=16)
    pairs = []
    for f in filters:
        inc.add(f)
        pairs.append((f, inc.aid_of(f)))
    mcs = {}
    for dev in ("cuda", "cpu"):
        mc = MultichipMatcher(depth=16, tp=4,
                              devices=[torch.device(dev)] * 4,
                              active_slots=16, max_matches=32, ep=ep,
                              ep_compact=compact, ep_slack=4.0)
        mc.rebuild(pairs)
        assert mc.apply_pending()
        mcs[dev] = mc
    card = mcs["cuda"]
    assert card.mesh.devices[0][0].type == "cuda"
    enc = card.encode(topics[:2048], batch=2048)
    kw = dict(routed=card._routed_for(2048),
              capacity=card.ep_capacity(2048) if ep else 0,
              compact=compact)
    walk_kernel.launches = 0
    rk.reset_launches()
    with card.mesh.streams():
        got = build_multichip_step(card.mesh, 16, 32, **kw)(*enc,
                                                             card._arrs)
        launched = dict(rk.launches)
        want = build_multichip_step(card.mesh, 16, 32, plain=True,
                                    **kw)(*enc, card._arrs)
    assert walk_kernel.launches == 2 * card.tp
    # one device: one grid launch (routed) and one merge a dispatch
    assert launched == {"ep_route": int(kw["routed"]), "ep_merge": 1}
    assert rk.launches == launched      # the plain step launches none
    for name, g, w in zip(got._fields, got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w), name

    def rows(mc, names):
        out, sp, nb = mc.readback(mc.dispatch(mc.encode(names, batch=2048)),
                                  len(names))
        return [sorted(r) for r in out], sp, nb

    for lo in (0, 2048):
        assert rows(card, topics[lo:lo + 2048]) == \
            rows(mcs["cpu"], topics[lo:lo + 2048])
    for i, f in enumerate(["fresh/+/x", "+/fresh", filters[3]]):
        if f == filters[3]:
            inc.remove(f)
            for mc in mcs.values():
                mc.note_del(f)
        else:
            inc.add(f)
            for mc in mcs.values():
                mc.note_add(f, inc.aid_of(f))
    for mc in mcs.values():
        assert mc.apply_pending()
    names = topics[:2000] + ["fresh/q/x", "q/fresh"]
    assert rows(card, names) == rows(mcs["cpu"], names)
    card.kill_shard(1)
    with pytest.raises(ShardDead):
        card.dispatch(card.encode(names, batch=2048))
    assert card.failovers == 1


# -- the routing grid and the merge (ep_route.cu) ------------------------------

def _route_inputs(seed, rows, D, tp, owner_map):
    """A batch with a hot root, negative and out-of-map root words, rows
    past the depth and pad rows, and an owner map of 40 roots (None: the
    floor remainder)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 40, (rows, D)).astype(np.int32)
    words[::3, 0] = 3
    words[1::11, 0] = -5
    words[2::13, 0] = 1 << 20
    lens = rng.integers(1, D + 1, rows).astype(np.int32)
    lens[3::9] = D + 1
    lens[4::17] = D + 2
    is_sys = rng.random(rows) < 0.2
    wo = (torch.from_numpy(rng.integers(0, tp, 40).astype(np.int32))
          if owner_map else None)
    return [torch.from_numpy(words), torch.from_numpy(lens),
            torch.from_numpy(is_sys), wo]


def _route_outs(rows, slots, D, dev):
    grid = rk.RouteGrid(
        torch.full((slots, D), -7, dtype=torch.int32, device=dev),
        torch.full((slots,), -7, dtype=torch.int32, device=dev),
        torch.ones((slots,), dtype=torch.bool, device=dev),
        torch.full((slots,), -7, dtype=torch.int32, device=dev))
    outs = dict(fill_ids=torch.full((rows, 9), -7, dtype=torch.int32,
                                    device=dev),
                zeros=[torch.full((rows, w), -7, dtype=torch.int32,
                                  device=dev) for w in (4, 1)],
                flag=torch.full((rows,), -7, dtype=torch.int32, device=dev),
                owner_out=torch.full((rows,), -7, dtype=torch.int32,
                                     device=dev))
    return grid, outs


@pytest.mark.cuda
@pytest.mark.parametrize("tp,C,Bs,n_src,owner_map", [
    (4, 256, 512, 4, True),    # chip_smoke's routed grid (B = 2048)
    (4, 3, 700, 8, True),      # dp 2, buckets far past capacity
    (2, 300, 1000, 2, True),   # several rounds of the block
    (4, 512, 512, 4, False),   # K8c at chip_smoke's EP shape
    (3, 7, 333, 3, False)])
def test_ep_route_kernel_equals_plain(tp, C, Bs, n_src, owner_map):
    """``ep_route`` on the card against ``ep_route_plain`` on the same
    card tensors, every grid slot and per-row output (the landed
    layout of one device, sources in row groups of tp)."""
    _skip_without_card()
    D = 16
    rows = n_src * Bs
    x = [t.cuda() if t is not None else None
         for t in _route_inputs(tp + C + Bs, rows, D, tp, owner_map)]
    R = tp * C
    kw = dict(tp=tp, C=C, Bs=Bs, so=R,
              sources=[(b * Bs, ((b // tp) * tp * tp + b % tp) * C)
                       for b in range(n_src)])
    slots = -(-n_src // tp) * tp * R
    got, want = (_route_outs(rows, slots, D, "cuda") for _ in range(2))
    rk.reset_launches()
    rk.ep_route(*x, got[0], **kw, **got[1])
    assert rk.launches["ep_route"] == 1
    rk.ep_route_plain(*x, want[0], **kw, **want[1])
    torch.cuda.synchronize()
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)
    for k in ("fill_ids", "flag", "owner_out"):
        assert torch.equal(got[1][k], want[1][k]), k
    for g, w in zip(got[1]["zeros"], want[1]["zeros"]):
        assert torch.equal(g, w)
    assert int((want[0].src >= 0).sum()) > 0


def _merge_inputs(seed, n_pairs, rows, cols, routed, micro, maps, C, Bs,
                  dev):
    rng = np.random.default_rng(seed)

    def raw(dense):
        acc = np.where(rng.random((rows, cols)) < 0.03,
                       rng.integers(0, 5000, (rows, cols)), -1)
        acc[dense] = rng.integers(0, 5000, cols)
        return torch.from_numpy(acc.astype(np.int32)).to(dev)

    pairs = []
    for k in range(n_pairs):
        amap = mamap = src = None
        if maps:
            am = rng.integers(0, 1 << 20, 5000).astype(np.int32)
            am[::9] = -1
            amap = torch.from_numpy(am).to(dev)
            mamap = torch.from_numpy(rng.integers(0, 1 << 20, 3000)
                                     .astype(np.int32)).to(dev)
        if routed:
            s = np.full((rows // C, C), -1, np.int32)
            for i in range(rows // C):
                perm = np.random.default_rng(seed * 100 + i).permutation(Bs)
                for c in range(C):
                    if k * C + c < Bs and rng.random() < 0.8:
                        s[i, c] = perm[k * C + c]
            src = torch.from_numpy(s.reshape(-1)).to(dev)
        ints = lambda hi: torch.from_numpy(  # noqa: E731
            rng.integers(0, hi, rows).astype(np.int32)).to(dev)
        pairs.append(rk.MergePair(raw(1), ints(3), raw(2) if micro else None,
                                  ints(2) if micro else None, amap, mamap,
                                  src, 0, 0, micro))
    return pairs


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["routed", "routed_compact", "replicated",
                                  "replicated_dp2", "identity"])
def test_ep_merge_kernel_equals_plain(form):
    """``ep_merge`` on the card against ``ep_merge_plain`` at the served
    shapes (K = 128, Km = 8, 446 accept columns; routed 4 × 1024 landed
    slots, replicated 2048 rows a group; K8c's identity form): every
    output field, rows past K and micro rows past Km among them."""
    _skip_without_card()
    K, Km, cols, tp = 128, 8, 446, 4
    routed = form.startswith("routed") or form == "identity"
    micro = form != "identity"
    if form == "identity":
        Km = 0
    C, Bs = 256, 512
    rows = tp * C if routed else 2048
    n_pairs = 2 * tp if form == "replicated_dp2" else tp
    pairs = _merge_inputs(len(form), n_pairs, rows, cols, routed, micro,
                          form != "identity", C, Bs, "cuda")
    segs = 1 if form in ("routed_compact", "identity") else tp
    if routed:
        pairs = [p._replace(seg=0 if segs == 1 else o)
                 for o, p in enumerate(pairs)]
        n_rows = tp * Bs
    else:
        owner = 1 if form == "replicated_dp2" else 0
        pairs = [p._replace(seg=k % tp, row_base=(k // tp) * rows,
                            micro=k % tp == owner)
                 for k, p in enumerate(pairs)]
        n_rows = rows * (n_pairs // tp)
    W = K + Km

    def outs():
        full = lambda *shape: torch.full(  # noqa: E731
            shape, -7, dtype=torch.int32, device="cuda")
        if form == "identity":
            return rk.MergeOut(full(n_rows, W), None, None, full(n_rows),
                               None, None)
        return rk.MergeOut(full(n_rows, segs * W), full(n_rows, segs),
                           full(n_rows, segs), full(n_rows), full(n_rows),
                           full(n_rows))

    got, want = outs(), outs()
    kw = dict(routed=routed, K=K, Km=Km, C=C, Bs=Bs, segs=segs)
    rk.reset_launches()
    rk.ep_merge(pairs, got, **kw)
    assert rk.launches["ep_merge"] == 1
    rk.ep_merge_plain(pairs, want, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(want._fields, got, want):
        if w is not None:
            assert torch.equal(g, w), name
    assert int(want.nm.max()) > K


@pytest.mark.cuda
def test_route_kernels_reject_wrong_operands():
    """A CUDA operand of the wrong dtype, shape or device raises before
    any launch; nothing falls back to the plain version."""
    _skip_without_card()
    x = [t.cuda() for t in _route_inputs(1, 64, 8, 4, True)]
    grid, outs = _route_outs(64, 4 * 4 * 16, 8, "cuda")
    kw = dict(tp=4, C=16, Bs=16, so=64,
              sources=[(b * 16, b * 16) for b in range(4)])
    rk.reset_launches()
    bad = [
        (x[0].long(), *x[1:]),                        # words int64
        (x[0], x[1][:-1], *x[2:]),                    # lens too short
        (x[0], x[1], x[2].int(), x[3]),               # is_sys int32
        (x[0], x[1], x[2], x[3].cpu()),               # owner map on cpu
        (x[0].t(), *x[1:]),                           # words not contiguous
    ]
    for args in bad:
        with pytest.raises(ValueError):
            rk.ep_route(*args, grid, **kw, **outs)
    with pytest.raises(ValueError):
        rk.ep_route(*x, grid._replace(lens=grid.lens.float()), **kw, **outs)
    with pytest.raises(ValueError):
        rk.ep_route(*x, grid, **{**kw, "tp": 33}, **outs)
    with pytest.raises(ValueError):     # a source past the grid
        rk.ep_route(*x, grid, **{**kw, "sources": [(0, 250)]}, **outs)
    pairs = _merge_inputs(3, 4, 64, 100, True, True, True, 16, 16, "cuda")
    out = rk.MergeOut(*(torch.zeros(shape, dtype=torch.int32, device="cuda")
                        for shape in ((64, 4 * 40), (64, 4), (64, 4), (64,),
                                      (64,), (64,))))
    mkw = dict(routed=True, K=32, Km=8, C=16, Bs=16, segs=4)
    bad_pairs = [
        [pairs[0]._replace(acc=pairs[0].acc.long())] + pairs[1:],
        [pairs[0]._replace(aover=pairs[0].aover[:-1])] + pairs[1:],
        [pairs[0]._replace(src=None)] + pairs[1:],
        [pairs[0]._replace(seg=4)] + pairs[1:],
        [pairs[0]._replace(amap=pairs[0].amap.cpu())] + pairs[1:],
        pairs * 5,                                     # 20 pairs > 16
    ]
    for ps in bad_pairs:
        with pytest.raises(ValueError):
            rk.ep_merge(ps, out, **mkw)
    with pytest.raises(ValueError):
        rk.ep_merge(pairs, out._replace(ids=out.ids[:, :100].contiguous()),
                    **mkw)
    with pytest.raises(ValueError):
        rk.ep_merge(pairs, out._replace(nm=out.nm.float()), **mkw)
    assert rk.launches == {"ep_route": 0, "ep_merge": 0}


@pytest.mark.cuda
def test_ep_step_on_card_equals_plain_and_cpu():
    """The prefix-EP step (K8c) on ``[cuda:0] * 4``: one grid launch, E
    raw walks and one merge a dispatch; every field equals the plain
    step on the card and the step on a CPU mesh."""
    _skip_without_card()
    from emqx_tpu_torch import parallel as P
    from emqx_tpu_torch.ops.encode import TopicEncoder

    filters, topics = build_workload(np.random.default_rng(10), 20000, 2048)
    E = 4
    tabs = P.build_partitions(filters, E, depth=16)
    enc = [torch.from_numpy(np.ascontiguousarray(a)) for a in
           TopicEncoder(tabs.vocab).encode(topics, 16, batch=2048)]
    t = [torch.from_numpy(a) for a in (tabs.node_tabs, tabs.edge_tabs,
                                       tabs.seeds)]
    res = {}
    for dev, plain in (("cuda", False), ("cuda", True), ("cpu", False)):
        mesh = P.make_mesh({"ep": E}, [torch.device(dev)] * E)
        step = P.build_ep_matcher(mesh, capacity=128, plain=plain)
        rk.reset_launches()
        walk_kernel.launches = 0
        with mesh.streams():
            res[(dev, plain)] = step(*(x.to(dev) for x in enc),
                                     *(x.to(dev) for x in t))
        if dev == "cuda" and not plain:
            assert rk.launches == {"ep_route": 1, "ep_merge": 1}
            assert walk_kernel.launches == E
    got = res[("cuda", False)]
    assert int(got.overflow.sum()) > 0          # capacity 128 < hot roots
    for name, g, w, c in zip(got._fields, got, res[("cuda", True)],
                             res[("cpu", False)]):
        assert torch.equal(g, w) and torch.equal(g.cpu(), c), name


# -- the fan-out's bitmap kernels and the library steps (K8b-K8f) -------------

def _bits(rng, shape, density):
    b = rng.random(shape + (32,)) < density
    words = (b * (1 << np.arange(32, dtype=np.uint64))).sum(-1)
    return torch.from_numpy(words.astype(np.uint32).view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("W,K,lo,rows", [(300, 200, 0, 97),
                                         (79, 128, 0, 97),
                                         (316, 40, 30, 40)])
def test_accept_or_kernel_equals_plain(W, K, lo, rows):
    """``accept_or`` on a column slice (rows W + 37 apart): a partly
    filled last tile, more ids than a block, a row of -1 ids, a window of
    rows; then ids all -1."""
    _skip_without_card()
    from emqx_tpu_torch.ops import bitmap_kernel as bk

    rng = np.random.default_rng(W + K)
    wide = _bits(rng, (rows, W + 37), 0.05)
    wide[-1] = 0
    bitmap = wide.cuda()[:, 37:]
    ids = rng.integers(-1, lo + rows + 20, (1000, K)).astype(np.int32)
    ids[2] = -1
    ids = torch.from_numpy(ids).cuda()
    bk.reset_launches()
    got = bk.accept_or(bitmap, ids, lo)
    assert bk.launches["accept_or"] == 1
    want = bk.accept_or_plain(bitmap, ids, lo)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    none = torch.full((5, 8), -1, dtype=torch.int32, device="cuda")
    got = bk.accept_or(bitmap, none, lo)
    assert not bool(got[0].any()) and not bool(got[1].any())


@pytest.mark.cuda
@pytest.mark.parametrize("W,cap,base", [(316, 64, 0), (79, 64, 3 * 79 * 32),
                                        (300, 10_000, 0), (79, 0, 0)])
def test_bitmap_compact_kernel_equals_plain(W, cap, base):
    """Rows of every density (empty and full among them), rows past the
    cap, a cap past every id and a cap of 0."""
    _skip_without_card()
    from emqx_tpu_torch.ops import bitmap_kernel as bk

    rng = np.random.default_rng(W + cap)
    bitmap = torch.cat([_bits(rng, (200, W), d)
                        for d in (0.0, 1.0, 0.01, 0.2, 0.5)]).cuda()
    got = bk.bitmap_compact(bitmap, cap, base)
    want = bk.bitmap_compact_plain(bitmap, cap, base)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,W,tp", [(2048, 16, 79, 4), (333, 5, 40, 2)])
def test_group_kernels_equal_plain(B, G, W, tp):
    """``group_count`` and ``group_pick`` on each of ``tp`` column slices
    (a partly filled last block, negative hashes, an empty group)."""
    _skip_without_card()
    from emqx_tpu_torch.ops import bitmap_kernel as bk

    rng = np.random.default_rng(B + G)
    bitmap = _bits(rng, (B, W * tp), 0.3).cuda()
    masks = _bits(rng, (G, W * tp), 0.2).cuda()
    masks[-1] = 0
    sel = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, B)
                           .astype(np.int32)).cuda()
    counts = []
    for t in range(tp):
        bl, ml = bitmap[:, t * W:(t + 1) * W], masks[:, t * W:(t + 1) * W]
        got = bk.group_count(bl, ml)
        assert torch.equal(got, bk.group_count_plain(bl, ml))
        counts.append(got)
    total = sum(counts)
    for t in range(tp):
        bl, ml = bitmap[:, t * W:(t + 1) * W], masks[:, t * W:(t + 1) * W]
        before = sum(counts[:t], torch.zeros_like(total))
        got = bk.group_pick(bl, ml, sel, total, before, counts[t], t * W)
        want = bk.group_pick_plain(bl, ml, sel, total, before, counts[t],
                                   t * W)
        assert torch.equal(got, want)


def _raw_rows(rng, B, C, hi):
    """Raw accept rows ``(B, C)``: -1 empty slots and ids in ``[0, hi +
    20)`` (some past the bitmap's ``hi`` rows); row 0 every slot valid,
    row 1 none, row 2 only ids past the bitmap, row 3 one id at the
    end."""
    acc = np.where(rng.random((B, C)) < 0.3, rng.integers(0, hi + 20, (B, C)),
                   -1)
    acc[0] = rng.integers(0, hi, C)
    acc[1] = -1
    acc[2] = np.where(np.arange(C) % 3 == 0, hi + np.arange(C) % 7, -1)
    acc[3] = -1
    acc[3, -1] = hi - 1
    return torch.from_numpy(acc.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("W,C,K,ring,cap,B", [
    (316, 446, 128, 4, 64, 2048),    # the served shape, compact form
    (316, 446, 128, 4, None, 2048),  # and plain
    (300, 130, 16, 2, 1, 1000),      # a cap of 1, a partly filled tile
    (150, 40, 40, 3, 10_000, 333),   # a cap past every bit, K = C
    (5, 7, 3, 1, 0, 64),             # ring 1, cap 0
    (200, 60, 200, 8, 9, 100)])      # eight windows, K past C
def test_ring_or_kernel_equals_plain(W, C, K, ring, cap, B):
    """``ring_or`` on a column slice (rows W + 37 apart) against
    ``ring_or_plain``, both outputs: several word tiles, rows past K,
    none valid, only ids past the bitmap."""
    _skip_without_card()
    from emqx_tpu_torch.ops import bitmap_kernel as bk

    rng = np.random.default_rng(W + C + K)
    rows = 40 * ring
    bitmap = _bits(rng, (rows, W + 37), 0.05).cuda()[:, 37:]
    acc = _raw_rows(rng, B, C, rows).cuda()
    bk.reset_launches()
    got = bk.ring_or(acc, bitmap, ring, K, cap)
    assert bk.launches["ring_or"] == 1
    want = bk.ring_or_plain(acc, bitmap, ring, K, cap)
    assert torch.equal(got[0], want[0])
    if cap is None:
        assert got[1] is None and want[1] is None
    else:
        assert torch.equal(got[1], want[1])
        assert (int(want[1].max()) > 0) == (cap < 100)


@pytest.mark.cuda
@pytest.mark.parametrize("W,U,C,K,B", [
    (316, 4, 446, 128, 2048),   # the served shape: W/U = 79
    (300, 4, 130, 16, 1000),    # W/U = 75, no multiple of the block
    (8, 8, 40, 40, 64),         # a word a part
    (160, 2, 7, 3, 333)])       # rows of more valid slots than K
def test_ulysses_or_kernel_equals_plain(W, U, C, K, B):
    """``ulysses_or`` on a column slice against ``ulysses_or_plain``,
    every field, twice (the counts are zeroed at each launch)."""
    _skip_without_card()
    from emqx_tpu_torch.ops import bitmap_kernel as bk

    rng = np.random.default_rng(W + U + C)
    bitmap = _bits(rng, (97, W + 5), 0.05).cuda()[:, 5:]
    acc = _raw_rows(rng, B, C, 97).cuda()
    aover = torch.from_numpy(rng.integers(0, 3, B).astype(np.int32)).cuda()
    want = bk.ulysses_or_plain(acc, aover, bitmap, U, K)
    bk.reset_launches()
    for _ in range(2):
        got = bk.ulysses_or(acc, aover, bitmap, U, K)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert bk.launches["ulysses_or"] == 2
    assert int(want[1].sum()) > 0


@pytest.mark.cuda
def test_fanout_steps_on_card_equal_plain_and_cpu():
    """Each library step on ``[cuda:0] * 4`` (its walk the hash-walk
    kernel, its bitmap work the four kernels, as many launches as the
    step states) equals the same step with the plain versions on the
    card and the step on a CPU mesh, every field."""
    _skip_without_card()
    from emqx_tpu_torch import parallel as P
    from emqx_tpu_torch.ops import bitmap_kernel as bk
    from emqx_tpu_torch.ops import compile_filters, encode_topics

    filters, topics = build_workload(np.random.default_rng(9), 5000, 512)
    table = compile_filters(filters, depth=8)
    enc = encode_topics(table, topics, batch=512)
    n_subs = 5000
    bitmap = P.make_accept_bitmap(
        table, lambda f: [hash(f) % n_subs, len(f) * 7 % n_subs], n_subs,
        tp=4)
    host = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (*enc, *table.device_arrays(),
                      bitmap.view(np.int32))]
    card = [x.cuda() for x in host]
    rows = P.shard_bitmap_rows(bitmap, 4)
    meshes = {d: {k: P.make_mesh(s, [torch.device(d)] * 4) for k, s in (
        ("tp", {"dp": 1, "tp": 4}), ("ring", {"dp": 1, "ring": 4}),
        ("u", {"u": 4}))} for d in ("cuda", "cpu")}

    def run(dev, plain):
        ms = meshes[dev]
        x = card if dev == "cuda" else host
        r = torch.from_numpy(rows.view(np.int32)).to(dev)
        return {
            "sharded": P.build_sharded_matcher(ms["tp"], plain=plain)(*x),
            "compact": P.build_sharded_matcher_compact(
                ms["tp"], cap_row=8, plain=plain)(*x),
            "ring": (P.build_ring_fanout(ms["ring"], plain=plain)(
                *x[:6], r),),
            "ring_compact": P.build_ring_fanout_compact(
                ms["ring"], cap_row=8, plain=plain)(*x[:6], r),
            "ulysses": ulysses(P.build_ulysses_step(ms["u"], plain=plain)(
                *x)),
        }

    def ulysses(res):
        return (res.dispatch_bitmap.full(), res.sub_deliveries.full(),
                res.n_matches, res.active_overflow)

    bk.reset_launches()
    walk_kernel.launches = 0
    got = run("cuda", False)
    assert walk_kernel.launches == 5        # one walk a step (one card)
    # the ring's two forms and Ulysses: one kernel each on one card
    assert bk.launches == {"accept_or": 8, "bitmap_compact": 4,
                           "group_count": 0, "group_pick": 0, "ring_or": 2,
                           "ulysses_or": 1}
    want, cpu = run("cuda", True), run("cpu", False)
    for k in got:
        for g, w, c in zip(got[k], want[k], cpu[k]):
            assert g.device.type == "cuda"
            assert torch.equal(g, w) and torch.equal(g.cpu(), c), k
    sel = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2**31 - 1, 512).astype(np.int32))
    masks = torch.from_numpy(P.make_group_masks(
        [range(g, n_subs, 17 + g) for g in range(7)] + [[]], n_subs,
        bitmap.shape[1]).view(np.int32))
    bm = got["sharded"].bitmap
    bk.reset_launches()
    pick = P.build_shared_selector(meshes["cuda"]["tp"])(bm, masks.cuda(),
                                                         sel.cuda())
    assert bk.launches["group_count"] == bk.launches["group_pick"] == 4
    assert torch.equal(pick, P.build_shared_selector(
        meshes["cuda"]["tp"], plain=True)(bm, masks.cuda(), sel.cuda()))
    assert torch.equal(pick.cpu(), P.build_shared_selector(
        meshes["cpu"]["tp"])(bm.cpu(), masks, sel))


@pytest.mark.cuda
def test_dryrun_multichip_on_card():
    """The dry run on ``[cuda:0] * 4`` through to its end."""
    _skip_without_card()
    from emqx_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip([torch.device("cuda", 0)] * 4, verbose=False)
    assert out["config2_3"]["mesh"] == {"dp": 1, "tp": 4}
    assert out["ep"]["parity_checked"] > 0
