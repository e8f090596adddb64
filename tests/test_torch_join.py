"""The port's join backend against the JAX reference, on the CPU.

The join walk (``walk_kernel.join_walk_plain``, the plain version of the
CUDA kernel ``csrc/nfa_join_walk.cu``) against the reference's
``join_match`` and its Pallas ``_join_kernel`` in interpret mode; the
port's ``join_match`` epilogues; the host ``JoinRelation`` along one
churn; the device table's relation mirror through tombstones, revivals,
overlay rows and an overlay overflow; the serve core on the join
backend; and the loader of a reference relation.  Inputs are made from
seeded numpy.  Every output is an integer, so the tolerance is exact
equality.

The reference's jitted functions run here with ``jax.disable_jit()``:
op by op, the same computation without an XLA compile per shape, which
would take 10-20 s for each of these unrolled searches on one core."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from emqx_tpu.ops import DeviceNfa as RefDeviceNfa
from emqx_tpu.ops import IncrementalNfa as RefIncrementalNfa
from emqx_tpu.ops.join_match import JoinRelation as RefJoinRelation
from emqx_tpu.ops.join_match import OverlayFull as RefOverlayFull
from emqx_tpu.ops.join_match import join_match as ref_join_match
from emqx_tpu.ops.pallas_match import pallas_join_match

from emqx_tpu_torch.broker.match_service import MatchService
from emqx_tpu_torch.broker.trie import FilterTrie
from emqx_tpu_torch.convert import from_reference
from emqx_tpu_torch.ops import (OVERLAY_CAP, DeviceNfa, IncrementalNfa,
                                JoinRelation, OverlayFull, encode_batch,
                                join_match, relation_capacity)
from emqx_tpu_torch.ops import cuda_build, walk_kernel
from emqx_tpu_torch.ops.join_match import OVERLAY_EMPTY
from emqx_tpu_torch.ops.walk_kernel import (
    accept_cols, join_walk, join_walk_plain)
from emqx_tpu_torch.workload import build_workload

EDGE_FILTERS = [
    "a/b/c", "a/+/c", "a/#", "#", "+", "+/b", "a/b", "b", "$SYS/#",
    "$SYS/+/x", "x//y", "/", "+/+", "+/+/+", "//#", "deep/1/2/3/4/5/6/#",
    "deep/+/2/+/4/+/6/7", "a/+/+/+", "a/b/+/d", "a/+/c/#", "+/b/#",
]
EDGE_TOPICS = [
    "a/b/c", "a/b", "a", "b", "x//y", "/", "//", "$SYS/broker", "$SYS/q/x",
    "$SYS", "deep/1/2/3/4/5/6/7", "deep/1/2/3/4/5/6/7/8/9/10", "nomatch/z",
    "a/q/c", "a/b/c/d", "a/b/c/d/e/f/g/h/i", "q/b/c", "unknownword",
]
FIELDS = ("matches", "n_matches", "active_overflow", "match_overflow",
          "row_meta")


def _torch(args):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)


def _jax(args):
    return tuple(jnp.asarray(a) for a in args)


def _eager(fn, *args, **kw):
    with jax.disable_jit():
        return fn(*args, **kw)


def _assert_result_equal(got, ref):
    for f in FIELDS:
        g, r = getattr(got, f), getattr(ref, f)
        if r is None:
            assert g is None, f
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=f)


def _churned(seed: int, table_depth: int, n_filters: int = 160):
    """A port table of ``table_depth`` (S = 1024, Hb = 512, so E = 2¹⁰)
    and the reference relation of it after one churn: removed filters
    leave tombstones, re-added ones revive them, fresh filters land in
    the overlay.  Returns ``(inc, relation arrays, topics)``."""
    rng = np.random.default_rng(seed)
    filters, topics = build_workload(rng, n_filters, 200,
                                     depth=min(table_depth, 8))
    filters = sorted(set(filters) | set(EDGE_FILTERS))
    held = filters[::9]                         # added after the build
    base = [f for f in filters if f not in set(held)]
    inc = IncrementalNfa(depth=table_depth, state_bucket=1024,
                         edge_bucket=512)
    for f in base:
        inc.add(f)
    rel = RefJoinRelation(inc.S, inc.edge_tab)
    inc.flush()
    gone = [base[i] for i in rng.choice(len(base), 25, replace=False)]
    for f in gone:
        inc.remove(f)
    for f in held + gone[:8]:
        inc.add(f)
    d = inc.flush()
    rel.apply_bucket_delta(d.bucket_idx, d.bucket_rows)
    assert inc.shape_key()[:2] == (1024, 512)
    start, word, nxt, overlay = (a.copy() for a in rel.arrays())
    live = int(start[-1])
    assert (nxt[:live] == -1).any(), "the churn must leave tombstones"
    assert (overlay[:, 0] != OVERLAY_EMPTY).any(), "the overlay must hold rows"
    return inc, (start, word, nxt, overlay), EDGE_TOPICS + topics


def _with_overlay_conflicts(inc, arrays):
    """The relation with two overlay rows added on keys the CSR already
    holds: one on a tombstoned row, one on a live row with a smaller
    ``next``.  The walk takes the max of the two answers, so both must
    come out as the reference's."""
    start, word, nxt, overlay = (a.copy() for a in arrays)
    rows = overlay[overlay[:, 0] != OVERLAY_EMPTY].tolist()
    seg = np.repeat(np.arange(len(start) - 1), np.diff(start))
    dead = np.flatnonzero(nxt[:len(seg)] == -1)
    alive = np.flatnonzero(nxt[:len(seg)] > 0)
    rows.append([int(seg[dead[0]]), int(word[dead[0]]), 7])
    rows.append([int(seg[alive[0]]), int(word[alive[0]]),
                 int(nxt[alive[0]]) - 1])
    rows.sort()
    overlay[:, :2] = OVERLAY_EMPTY
    overlay[:, 2] = -1
    overlay[:len(rows)] = rows
    return start, word, nxt, overlay


def _operands(inc, arrays, topics, depth, batch):
    enc = encode_batch(inc, topics[:batch], batch=batch, depth=depth)
    return enc + (inc.node_tab,) + tuple(arrays)


@pytest.mark.parametrize("depth,A", [(4, 16), (8, 16), (16, 16), (8, 2),
                                     (4, 2), (8, 1), (16, 12), (8, 32)])
def test_join_walk_plain_equals_reference_raw(depth, A):
    inc, arrays, topics = _churned(depth + A, max(depth, 8))
    args = _operands(inc, _with_overlay_conflicts(inc, arrays), topics,
                     depth, batch=256)
    ref = _eager(ref_join_match, *_jax(args), active_slots=A,
                 compact_output=False)
    acc, aover = join_walk_plain(*_torch(args), active_slots=A)
    assert acc.shape == (256, accept_cols(depth, A))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref.matches))
    np.testing.assert_array_equal(aover.numpy(),
                                  np.asarray(ref.active_overflow))
    assert (acc.numpy() >= 0).sum() > 256, "the batch must match"
    if A <= 2:
        assert aover.numpy().max() > 0, "the spill case must spill"


@pytest.mark.parametrize("depth,A", [(4, 2), (16, 16)])
def test_join_walk_plain_equals_pallas_interpret(depth, A):
    """The reference's Pallas ``_join_kernel`` itself, in interpret mode
    (one tile of 64 rows), against the port's plain join walk."""
    inc, arrays, topics = _churned(3 * depth + A, max(depth, 8))
    args = _operands(inc, _with_overlay_conflicts(inc, arrays), topics,
                     depth, batch=64)
    acc_ref, aover_ref = _eager(pallas_join_match, *_jax(args), depth=depth,
                                active_slots=A, interpret=True)
    acc, aover = join_walk(*_torch(args), active_slots=A)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_ref))
    np.testing.assert_array_equal(aover.numpy(), np.asarray(aover_ref))


@pytest.mark.parametrize("depth,A,K,flat_cap", [
    (8, 8, 32, 0),           # compact
    (8, 2, 4, 0),            # compact with active and match spill
    (8, 8, 4, 300),          # flat: K truncation + global-cap truncation
    (4, 16, 128, 8 * 256),   # the serve shape of the short group
    (16, 16, 128, 8 * 256),  # the serve shape of the long group
])
def test_join_match_equals_reference(depth, A, K, flat_cap):
    inc, arrays, topics = _churned(depth + K, max(depth, 8))
    args = _operands(inc, arrays, topics, depth, batch=256)
    kw = dict(active_slots=A, max_matches=K, flat_cap=flat_cap)
    _assert_result_equal(join_match(*_torch(args), **kw),
                         _eager(ref_join_match, *_jax(args), **kw))


def _assert_delta_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_join_relation_equals_reference_along_churn():
    """Build, the delta writes of each churn step, OverlayFull at the
    same step, the arrays after ``rebuild`` and ``grow_states``."""
    rng = np.random.default_rng(5)
    filters, _ = build_workload(rng, 200, 0)
    inc = IncrementalNfa(depth=8, state_bucket=4096, edge_bucket=2048)
    for f in filters:
        inc.add(f)
    port = JoinRelation(inc.S, inc.edge_tab)
    ref = RefJoinRelation(inc.S, inc.edge_tab)
    _assert_delta_equal(port.arrays(), ref.arrays())
    assert port.cap == ref.cap == relation_capacity(inc.Hb)
    inc.flush()
    fresh, _ = build_workload(np.random.default_rng(6), 600, 0)
    fresh = [f for f in fresh if f not in set(filters)]
    overflowed_at = None
    for step in range(40):
        for f in rng.choice(filters, 6, replace=False):
            inc.remove(str(f)) if inc.aid_of(str(f)) >= 0 else inc.add(str(f))
        for f in fresh[step * 8:(step + 1) * 8]:
            inc.add(f)
        d = inc.flush()
        try:
            want = ref.apply_bucket_delta(d.bucket_idx, d.bucket_rows)
        except RefOverlayFull:
            with pytest.raises(OverlayFull):
                port.apply_bucket_delta(d.bucket_idx, d.bucket_rows)
            overflowed_at = step
            break
        _assert_delta_equal(
            port.apply_bucket_delta(d.bucket_idx, d.bucket_rows), want)
        _assert_delta_equal(port.arrays(), ref.arrays())
    assert overflowed_at is not None and overflowed_at > 0
    assert inc.shape_key()[:2] == (4096, 2048)
    port.rebuild(inc.S)
    ref.rebuild(inc.S)
    _assert_delta_equal(port.arrays(), ref.arrays())
    flat = inc.edge_tab.reshape(-1, 4)
    for s, w, n, _pad in flat[flat[:, 0] >= 0][::7].tolist():
        assert port.lookup(s, w) == ref.lookup(s, w) == n
    port.rebuild(inc.S, inc.edge_tab)
    ref.rebuild(inc.S, inc.edge_tab)
    port.grow_states(inc.S * 2)
    ref.grow_states(inc.S * 2)
    _assert_delta_equal(port.arrays(), ref.arrays())


def _mirrors(filters, depth=6, A=8, K=8, **buckets):
    """Port and reference device tables over ``filters``, the relation
    mirror enabled on the synced twins (so it is sorted from them)."""
    port_inc = IncrementalNfa(depth=depth, **buckets)
    ref_inc = RefIncrementalNfa(depth=depth, **buckets)
    for f in filters:
        assert port_inc.add(f) == ref_inc.add(f)
    port = DeviceNfa(port_inc, active_slots=A, max_matches=K, device="cpu")
    ref = _eager(RefDeviceNfa, ref_inc, active_slots=A, max_matches=K)
    port.enable_join()
    _eager(ref.enable_join)
    return port_inc, ref_inc, port, ref


def _assert_mirror_equal(port, ref, topics, ctx):
    """Relation arrays and rebuild counts equal; both port join names
    (and the port's hash walk) answer like the reference's join.  An
    intended divergence: the port's ``join-pallas`` runs the join kernel
    in every output mode and at every batch, where the reference runs
    its Pallas kernel only flat at tile multiples (a TPU tiling rule)
    and serves ``join`` otherwise; the answers are the same."""
    for a, b in zip(port._jarrs, ref._jarrs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=ctx)
    assert port.join_rebuilds == ref.join_rebuilds, ctx
    enc = encode_batch(port.inc, topics, batch=64)
    for flat_cap in (0, 4 * 64):
        want = _eager(ref.match, *_jax(enc), flat_cap=flat_cap,
                      backend="join")
        for be in ("join", "join-pallas", "hash"):
            got = port.match(*_torch(enc), flat_cap=flat_cap, backend=be)
            _assert_result_equal(got, want)


def test_device_join_mirror_equals_reference_through_churn():
    """Tombstones, revivals, overlay rows, then an overlay overflow, then
    table growth (a whole upload): after every sync the port's relation
    arrays, its rebuild count and its join answers equal the
    reference's."""
    base = [f"b{i}/c{i % 7}/+" for i in range(60)] + ["b1/#", "+/c3/x"]
    port_inc, ref_inc, port, ref = _mirrors(base, state_bucket=2048,
                                            edge_bucket=1024)
    topics = [f"b{i}/c{i % 7}/z" for i in range(0, 60, 3)] + [
        "b1/q", "w/c3/x", "o3/p3", "o300/p300/x", "nope"]

    def churn(add=(), remove=()):
        for f in remove:
            assert port_inc.remove(f) == ref_inc.remove(f)
        for f in add:
            assert port_inc.add(f) == ref_inc.add(f)
        port.sync()
        _eager(ref.sync)

    _assert_mirror_equal(port, ref, topics, "build")
    rebuilds = port.join_rebuilds
    def tombstones():
        start, _word, nxt, _ov = (a.numpy() for a in port._jarrs)
        return int((nxt[:start[-1]] == -1).sum())

    churn(remove=base[:10])
    dead = tombstones()
    assert dead >= 10
    _assert_mirror_equal(port, ref, topics, "tombstones")
    churn(add=base[:5] + [f"o{i}/p{i}" for i in range(20)])
    assert tombstones() < dead                       # revived in place
    ov = port._jarrs[3].numpy()
    assert (ov[:, 0] != OVERLAY_EMPTY).sum() >= 20   # overlay rows
    assert port.join_rebuilds == rebuilds            # written in place
    _assert_mirror_equal(port, ref, topics, "revival + overlay")
    churn(add=[f"o{i}/p{i}/x" for i in range(100, 100 + OVERLAY_CAP)])
    assert port.join_rebuilds == rebuilds + 1        # overlay overflow
    assert port_inc.shape_key()[:2] == (2048, 1024)  # ... without growth
    _assert_mirror_equal(port, ref, topics, "overflow rebuild")
    uploads = port.uploads
    churn(add=[f"g{i}/h{i}/k{i}" for i in range(900)])
    assert port.uploads == uploads + 1               # the table grew
    _assert_mirror_equal(port, ref, topics, "growth")


@pytest.mark.parametrize("backend,raises", [("dense", ValueError)])
def test_service_rejects_backends_it_cannot_serve(backend, raises):
    with pytest.raises(raises):
        MatchService(device="cpu", backend=backend)


@pytest.mark.parametrize("backend", ["join", "join-pallas"])
def test_service_join_backend_equals_oracle_and_hash(backend):
    filters, topics = build_workload(np.random.default_rng(12), 2500, 1100)
    filters = sorted(set(filters) | set(EDGE_FILTERS))
    topics = EDGE_TOPICS + topics
    svc = MatchService(device="cpu", backend=backend, max_batch=600)
    hashed = MatchService(device="cpu", max_batch=600)
    trie = FilterTrie()
    for f in filters:
        assert svc.add(f) and hashed.add(f)
        trie.insert(f)
    svc.sync()
    hashed.sync()
    got = svc.serve(topics)
    assert got == hashed.serve(topics)
    for t, row in zip(topics, got):
        assert sorted(row) == sorted(trie.match(t)), t
    assert svc.join_dispatches == svc.dispatches >= 2
    assert hashed.join_dispatches == 0
    # churn through the mirror: tombstones and overlay rows, no rebuild
    rebuilds = svc.dev.join_rebuilds
    for f in filters[:40]:
        svc.remove(f)
        trie.delete(f)
    for f in ("new/+/edge", "new/x/#", "$SYS/new/+"):
        svc.add(f)
        trie.insert(f)
    svc.sync()
    assert svc.dev.join_rebuilds == rebuilds
    for t, row in zip(topics, svc.serve(topics + ["new/a/edge"])):
        assert sorted(row) == sorted(trie.match(t)), t


def test_from_reference_join_answers_identically():
    """A relation the reference built and churned (tombstones and
    overlay rows) is mirrored as it is and answers like the reference's
    join backend."""
    ref_inc = RefIncrementalNfa(depth=6, state_bucket=2048,
                                edge_bucket=1024)
    for i in range(80):
        ref_inc.add(f"r{i}/s{i % 5}/+")
    ref = _eager(RefDeviceNfa, ref_inc, active_slots=8, max_matches=8)
    _eager(ref.enable_join)
    for i in range(0, 80, 4):
        ref_inc.remove(f"r{i}/s{i % 5}/+")
    for i in range(30):
        ref_inc.add(f"fresh{i}/t/#")
    _eager(ref.sync)
    arrays = tuple(np.asarray(a) for a in ref._jarrs)
    assert (arrays[3][:, 0] != OVERLAY_EMPTY).any()
    assert (arrays[2][:int(arrays[0][-1])] == -1).any()
    port = from_reference(ref_inc.node_tab, ref_inc.edge_tab, ref_inc.seeds,
                          ref_inc.accept_filters, ref_inc.vocab,
                          device="cpu", depth=6, active_slots=8,
                          max_matches=8, join=arrays)
    for a, b in zip(port._jarrs, arrays):
        np.testing.assert_array_equal(a.numpy(), b)
    topics = [f"r{i}/s{i % 5}/x" for i in range(0, 80, 3)] + [
        f"fresh{i}/t/u/v" for i in range(30)] + ["none"]
    enc = encode_batch(ref_inc, topics, batch=64)
    want = _eager(ref.match, *_jax(enc), flat_cap=4 * 64, backend="join")
    _assert_result_equal(port.match(*_torch(enc), flat_cap=4 * 64,
                                    backend="join"), want)
    bad = list(arrays)
    bad[3] = arrays[3][::-1].copy()
    with pytest.raises(ValueError, match="sorted"):
        from_reference(ref_inc.node_tab, ref_inc.edge_tab, ref_inc.seeds,
                       ref_inc.accept_filters, ref_inc.vocab, device="cpu",
                       depth=6, join=bad)


def _good_join_args(B=64, D=4, S=8, E=16):
    return [torch.zeros((B, D), dtype=torch.int32),
            torch.full((B,), D + 2, dtype=torch.int32),
            torch.ones(B, dtype=torch.bool),
            torch.full((S, 4), -1, dtype=torch.int32),
            torch.zeros(S + 1, dtype=torch.int32),
            torch.zeros(E, dtype=torch.int32),
            torch.full((E,), -1, dtype=torch.int32),
            torch.full((OVERLAY_CAP, 3), -1, dtype=torch.int32)]


@pytest.mark.parametrize("bad,match", [
    ((4, torch.zeros(8, dtype=torch.int32)), "S\\+1"),
    ((6, torch.full((15,), -1, dtype=torch.int32)), "lengths"),
    ((5, torch.zeros(0, dtype=torch.int32)), "lengths"),
    ((7, torch.full((128, 3), -1, dtype=torch.int32)), "overlay shape"),
    ((5, torch.zeros(16, dtype=torch.int64)), "edge_word"),
    ((1, torch.zeros(32, dtype=torch.int32)), "length"),
])
def test_join_wrapper_rejects_bad_operands(bad, match):
    args = _good_join_args()
    i, t = bad
    args[i] = t
    with pytest.raises(ValueError, match=match):
        walk_kernel._check_join(*args, A=8)


def test_cpu_join_walk_runs_plain_and_counts_no_launch():
    inc, arrays, topics = _churned(1, 8)
    before = (walk_kernel.launches, walk_kernel.join_launches)
    traffic = {}
    args = _torch(_operands(inc, arrays, topics, 4, batch=64))
    acc, aover = join_walk(*args, active_slots=16)
    acc_p, _ = join_walk_plain(*args, active_slots=16, traffic=traffic)
    assert torch.equal(acc, acc_p)
    assert (walk_kernel.launches, walk_kernel.join_launches) == before
    assert traffic["node_rows"] >= traffic["csr_pairs"] > 0
    assert traffic["word_probes"] >= traffic["next_reads"] > 0


def test_kernel_digest_covers_included_headers(tmp_path, monkeypatch):
    """Editing a header that a kernel source includes gives the kernel a
    new library path, so a stale build is never loaded (no nvcc runs)."""
    for f in cuda_build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    for name in ("nfa_walk", "nfa_join_walk"):
        assert "walk_common.cuh" in cuda_build._sources(name)
    before = {n: cuda_build._lib_path(n) for n in cuda_build.SOURCES}
    hdr = tmp_path / "walk_common.cuh"
    hdr.write_bytes(hdr.read_bytes() + b"\n// edited\n")
    after = {n: cuda_build._lib_path(n) for n in cuda_build.SOURCES}
    for n in ("nfa_walk", "nfa_join_walk"):
        assert after[n] != before[n]
        assert after[n].name.startswith(f"lib{n}-")
    src = tmp_path / "nfa_join_walk.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    assert cuda_build._lib_path("nfa_join_walk") != after["nfa_join_walk"]
    assert cuda_build._lib_path("nfa_walk") == after["nfa_walk"]
