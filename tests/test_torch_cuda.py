"""The port's CUDA walk kernels (hash and join) against their plain
PyTorch versions, and the asyncio serve loop on them, on the card.  These tests need an NVIDIA GPU and nvcc; they skip elsewhere.  The
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
from emqx_tpu_torch.ops import walk_kernel
from emqx_tpu_torch.ops.join_match import OVERLAY_EMPTY
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
