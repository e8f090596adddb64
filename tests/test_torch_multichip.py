"""The port's multichip serve plane (``emqx_tpu_torch/parallel/``) held to
the reference's (``emqx_tpu/parallel/``) on the CPU.

The reference runs its ``shard_map`` step on the eight virtual CPU
devices that ``tests/conftest.py`` makes; the port runs its step on a
mesh of ``[torch.device("cpu")] * n`` (a device may repeat in the grid).
Compared exactly (tolerance 0):

* the mesh shapes, the partition and the pure helpers;
* the collectives, against numpy;
* ``convert.multichip_arrays_from_reference``: the reference's stacked
  tables, per shard, on the port's mesh;
* the step (K8a) on those very tables: every ``CompactFanoutResult``
  field and every decoded row, replicated, routed, routed+compact, with
  the micro merge migrated (``micro_owner = 2``) and with a capacity
  small enough that buckets overflow, at (dp, tp) = (1, 4), (2, 4),
  (1, 8);
* the matcher: its stacked tables (Python subtables) and its rows
  against the reference's; then each scenario of
  ``tests/test_multichip_serve.py`` (compact rows against the host and
  the single-device flat path, churn and restacks, truncation fail-open,
  shard kills and the fault seams, segments with their guards, EP parity
  and overflow, the micro table, the degraded ladder, rebuild and
  re-admission, the capacity autotune, the rebalance) on the port,
  against the host table's walk.

Intended divergences, each asserted: no kernel cache and no
``CompileMiss`` on the mesh; the capacity resize compiles nothing and
flips at the readback that triggers it (no background thread); a
shard whose launch raises surfaces as ``ShardDead`` naming it.
"""

import json
import logging
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emqx_tpu.ops.incremental import IncrementalNfa as RefIncrementalNfa
from emqx_tpu.parallel import mesh as ref_mesh
from emqx_tpu.parallel import multichip_serve as ref_mcs
from emqx_tpu.parallel import prefix_ep as ref_prefix_ep
from emqx_tpu.parallel.sharded_match import \
    decode_compact_rows as ref_decode
from emqx_tpu_torch import faultinject
from emqx_tpu_torch.convert import multichip_arrays_from_reference
from emqx_tpu_torch.faultinject import FaultInjector
from emqx_tpu_torch.observe.metrics import Metrics
from emqx_tpu_torch.ops import DeviceNfa, IncrementalNfa, encode_batch
from emqx_tpu_torch.parallel import (
    MultichipMatcher, ShardDead, all_gather, all_to_all,
    build_multichip_step, decode_compact_rows, greedy_balance,
    is_micro_filter, make_mesh, owner_of, pick_shape, psum,
    serve_mesh_shape, shard_of_filter)
from emqx_tpu_torch.parallel import multichip_serve as mcs_mod
from emqx_tpu_torch.parallel.mesh import Mesh, default_devices

CPU = torch.device("cpu")

FILTERS = ["a/+", "a/#", "+/b", "#", "x/y/z", "x/+/z", "$SYS/#",
           "rooms/+/temp", "rooms/1/#", "b/c", "deep/+/q/+", "m/n"]


@pytest.fixture(autouse=True)
def _clean():
    yield
    faultinject.uninstall()


def cpus(n):
    return [CPU] * n


def pairs_of(inc, filters):
    out = []
    for f in filters:
        inc.add(f)
        out.append((f, inc.aid_of(f)))
    return out


def build_pair(filters=FILTERS, depth=8, n=8, **mc_kw):
    """(service table, port matcher with the same aid space, pairs)."""
    inc = IncrementalNfa(depth=depth)
    pairs = pairs_of(inc, filters)
    mc = MultichipMatcher(depth=depth, devices=cpus(n), **mc_kw)
    mc.rebuild(pairs)
    assert mc.apply_pending()
    return inc, mc, pairs


def build_ep_pair(filters=FILTERS, depth=8, **mc_kw):
    return build_pair(filters, depth, ep=True, **mc_kw)


def ref_matcher(pairs, n=8, depth=8, **kw):
    mc = ref_mcs.MultichipMatcher(depth=depth, devices=jax.devices()[:n],
                                  **kw)
    mc.rebuild(pairs)
    assert mc.apply_pending()
    return mc


def topics_for(n, seed=5):
    rng = np.random.default_rng(seed)
    words = ["a", "b", "x", "y", "z", "rooms", "1", "temp", "m", "n",
             "deep", "q"]
    return ["/".join(rng.choice(words, size=rng.integers(1, 5)))
            for _ in range(n)]


def mesh_rows(mc, topics, batch=64, depth=None):
    enc = mc.encode(topics, batch=batch, depth=depth)
    return mc.readback(mc.dispatch(enc), len(topics))


def host_rows(inc, topics):
    return [sorted(inc.match_host(t)) for t in topics]


# -- the mesh, the partition, the collectives ---------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shape_and_partition_determinism(n):
    """The mesh factorization, the prefix partition and the micro split
    are the reference's; the matcher spreads the table over its shards
    as the reference's does."""
    for tp in (None, 1, 2):
        if tp is not None and n % tp:
            with pytest.raises(ValueError):
                pick_shape(n, tp)
            continue
        assert pick_shape(n, tp) == ref_mesh.pick_shape(n, tp)
        assert serve_mesh_shape(n, tp or 0) == \
            ref_mcs.serve_mesh_shape(n, tp or 0)
    rng = np.random.default_rng(n)
    flts = FILTERS + ["/".join(rng.choice(["a", "b", "+", "c9", "dd", "#"],
                                          size=3)) for _ in range(50)]
    for f in flts:
        for tp in (1, 2, 4, 8):
            assert shard_of_filter(f, tp) == ref_mcs.shard_of_filter(f, tp)
        assert is_micro_filter(f) == ref_mcs.is_micro_filter(f)
    inc, mc, pairs = build_pair(n=n)
    ref = ref_matcher(pairs, n=n)
    assert (mc.dp, mc.tp, mc.n_devices) == (ref.dp, ref.tp, ref.n_devices)
    assert [s.n_filters for s in mc._subs] == \
        [s.n_filters for s in ref._subs]
    assert mc._micro_filters == ref._micro_filters
    assert mc._filters == ref._filters
    n_micro = sum(1 for f in FILTERS if is_micro_filter(f))
    assert len(mc._micro_filters) == n_micro >= 2
    assert sum(s.n_filters for s in mc._subs) == len(FILTERS) - n_micro


def test_mesh_is_a_grid_of_torch_devices():
    """Intended divergence: the mesh is the device list (repeats allowed),
    not a ``jax.sharding.Mesh``; no list means every visible card, and
    without a card the caller must name the CPU."""
    m = make_mesh({"dp": 2, "tp": 4}, ["cpu"] * 8)
    assert isinstance(m, Mesh)
    assert m.shape == {"dp": 2, "tp": 4}
    assert m.devices == [[CPU] * 4, [CPU] * 4]
    assert m.distinct == [CPU] and m.lead == CPU
    assert m.stream_of == {} and m.record() == []
    with m.streams():
        pass
    assert make_mesh(None, cpus(8)).shape == {"dp": 2, "tp": 4}
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh({"dp": 2, "tp": 4}, cpus(4))
    with pytest.raises(ValueError):
        Mesh([[CPU, CPU], [CPU]])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            default_devices()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MultichipMatcher(depth=8)


def test_collectives_against_numpy():
    """all_to_all, psum and all_gather over one mesh axis, as the
    reference's ``jax.lax`` collectives inside ``shard_map`` compute
    them; positions on one device share one result."""
    rng = np.random.default_rng(3)
    n = 4
    devs = cpus(n)
    parts = [torch.from_numpy(rng.integers(-9, 9, (n, 3, 2)).astype(
        np.int32)) for _ in range(n)]
    got = all_to_all(parts, devs)
    for o in range(n):
        assert np.array_equal(
            got[o].numpy(), np.stack([parts[i][o].numpy()
                                      for i in range(n)]))
    s = psum(parts, devs)
    want = sum(p.numpy() for p in parts)
    assert all(np.array_equal(x.numpy(), want) for x in s)
    assert all(x is s[0] for x in s)
    g = all_gather(parts, devs, dim=1)
    assert np.array_equal(g[0].numpy(),
                          np.concatenate([p.numpy() for p in parts], 1))
    assert all(x is g[0] for x in g)
    with pytest.raises(ValueError):
        all_to_all(parts[:3], devs)


def test_greedy_balance_pure_strict_improvement():
    """The pure core, and the reference's answers on seeded loads."""
    loads = {"h0": 100.0, "h1": 90.0, "h2": 80.0, "h3": 70.0, "c0": 1.0}
    owners = {"h0": 0, "h1": 0, "h2": 0, "h3": 0, "c0": 1}

    def worst(o):
        per = [0.0] * 4
        for w, t in o.items():
            per[t] += loads[w]
        return max(per)

    new, moved = greedy_balance(loads, owners, 4, 64)
    assert moved >= 3
    assert worst(new) < worst(owners)
    assert worst(new) <= 100.0
    assert set(new) == set(owners)
    same, n0 = greedy_balance(loads, owners, 4, 0)
    assert n0 == 0 and same == owners
    flat = {f"r{i}": 10.0 for i in range(4)}
    fown = {f"r{i}": i for i in range(4)}
    kept, nk = greedy_balance(flat, fown, 4, 64)
    assert nk == 0 and kept == fown
    rng = np.random.default_rng(11)
    for _ in range(20):
        k = int(rng.integers(1, 30))
        ld = {f"w{i}": float(rng.integers(0, 50)) for i in range(k)}
        ow = {f"w{i}": int(rng.integers(0, 4)) for i in range(k)}
        budget = int(rng.integers(0, 10))
        assert greedy_balance(ld, ow, 4, budget) == \
            ref_prefix_ep.greedy_balance(ld, ow, 4, budget)
        vocab = {f"w{i}": i + 1 for i in range(k)}
        for t in ("w0/x", "zz/y", f"w{k - 1}"):
            assert owner_of(t, vocab, 4) == \
                ref_prefix_ep.owner_of(t, vocab, 4)


def test_scatter_keeps_the_last_write_and_drops_out_of_range():
    """The per-shard delta scatter (the reference's ``_scatter_stacked``
    with ``mode="drop"``, ``unique_indices=False``): of a repeated row
    the last write lands, a row past the table is dropped, and a tensor
    two grid positions share is written once."""
    tab = torch.zeros((6, 4), dtype=torch.int32)
    idx = np.array([1, 3, 1, 9, 5, 3], np.int32)
    rows = np.arange(24, dtype=np.int32).reshape(6, 4)
    mcs_mod._scatter_rows([tab, tab], idx, rows)
    want = np.zeros((6, 4), np.int32)
    want[1], want[3], want[5] = rows[2], rows[5], rows[4]
    assert np.array_equal(tab.numpy(), want)
    mcs_mod._scatter_rows([tab], np.zeros(0, np.int32),
                          np.zeros((0, 4), np.int32))
    assert np.array_equal(tab.numpy(), want)


# -- the reference's tables on the port's mesh --------------------------------

@pytest.mark.parametrize("dp,tp", [(1, 4), (2, 4), (1, 8)])
def test_convert_multichip_arrays_equal_reference(dp, tp):
    """Every converted tensor equals the reference's stacked array for
    its shard (the replicated ones everywhere), element for element."""
    inc = RefIncrementalNfa(depth=8)
    pairs = pairs_of(inc, FILTERS + [f"grow/{i}/+" for i in range(40)])
    ref = ref_matcher(pairs, n=dp * tp, tp=tp, native=False)
    mesh = make_mesh({"dp": dp, "tp": tp}, cpus(dp * tp))
    tabs = multichip_arrays_from_reference(ref, mesh)
    arrs = [np.asarray(a) for a in ref._arrs]
    for d in range(dp):
        for t in range(tp):
            for k in range(4):
                got = tabs.shard[d][t][k]
                assert got.dtype == torch.int32
                assert np.array_equal(got.numpy(), arrs[k][t])
            for k in range(5):
                assert np.array_equal(tabs.repl[d][t][k].numpy(),
                                      arrs[4 + k])
            # one copy per device: the grid's repeats share it
            assert tabs.shard[d][t] is tabs.shard[0][t]
    with pytest.raises(ValueError, match="shards"):
        multichip_arrays_from_reference(
            ref, make_mesh({"dp": 1, "tp": 2}, cpus(2)))


_STEP_FORMS = {
    "replicated": dict(routed=False),
    "routed": dict(routed=True),
    "routed_compact": dict(routed=True, compact=True),
    "micro_owner_2": dict(routed=False, micro_owner=2),
    "overflow": dict(routed=True, capacity=1),
    "overflow_compact": dict(routed=True, compact=True, capacity=1),
}


@pytest.fixture(scope="module")
def step_tables():
    """One reference matcher a mesh shape (its step compiles are the
    file's cost), with the port's converted tables."""
    out = {}
    for dp, tp in ((1, 4), (2, 4), (1, 8)):
        inc = RefIncrementalNfa(depth=8)
        pairs = pairs_of(inc, FILTERS)
        ref = ref_matcher(pairs, n=dp * tp, tp=tp, native=False)
        mesh = make_mesh({"dp": dp, "tp": tp}, cpus(dp * tp))
        out[(dp, tp)] = (inc, ref, mesh,
                         multichip_arrays_from_reference(ref, mesh))
    return out


@pytest.mark.parametrize("form", sorted(_STEP_FORMS))
@pytest.mark.parametrize("dp,tp", [(1, 4), (2, 4), (1, 8)])
def test_step_matches_reference(step_tables, dp, tp, form):
    """K8a: the port's step on the reference's tables equals the
    reference's step on every field and every decoded row.  The topics
    mix every root, unknown roots, ``$`` topics and a hot ``x`` root
    (the routed grid overflows at capacity 1, and at the default
    slack on some source slices)."""
    inc, ref, mesh, tabs = step_tables[(dp, tp)]
    kw = dict(_STEP_FORMS[form])
    if kw["routed"]:
        kw.setdefault("capacity", ref.ep_capacity(64))
    topics = (topics_for(40, seed=dp * 10 + tp) + [f"x/{i}/z"
                                                   for i in range(16)]
              + ["$SYS/a", "zzz/b", "qqq"])
    enc = ref.encode(topics, batch=64)
    rstep = ref_mcs.build_multichip_step(ref.mesh, 16, 32, micro_matches=8,
                                         **kw)
    want = jax.device_get(rstep(*(jnp.asarray(x) for x in enc), *ref._arrs))
    got = build_multichip_step(mesh, 16, 32, micro_matches=8, **kw)(
        *enc, tabs)
    for name, w, g in zip(want._fields, want, got):
        assert g.device == mesh.lead
        assert np.array_equal(np.asarray(w), g.numpy()), name
    ids, counts = np.asarray(want.ids), np.asarray(want.counts)
    cap = ids.shape[1] // counts.shape[1]
    for w, g in zip(ref_decode(ids, counts, cap),
                    decode_compact_rows(got.ids.numpy(), got.counts.numpy(),
                                        cap)):
        assert np.array_equal(w, g)
    if form.startswith("overflow"):
        assert int(np.asarray(want.match_overflow).sum()) > 0


def test_step_truncation_matches_reference(step_tables):
    """K = Km = 1: own and micro segments truncate; the summed overflow
    flags and the surviving prefixes are the reference's."""
    _inc, ref, mesh, tabs = step_tables[(1, 4)]
    topics = ["a/b", "a/b/c", "x/y/z", "m/n", "b/c"] + topics_for(20)
    enc = ref.encode(topics, batch=64)
    for routed in (False, True):
        kw = dict(routed=routed, capacity=ref.ep_capacity(64) if routed
                  else 0)
        rstep = ref_mcs.build_multichip_step(ref.mesh, 16, 1,
                                             micro_matches=1, **kw)
        want = jax.device_get(rstep(*(jnp.asarray(x) for x in enc),
                                    *ref._arrs))
        got = build_multichip_step(mesh, 16, 1, micro_matches=1, **kw)(
            *enc, tabs)
        for name, w, g in zip(want._fields, want, got):
            assert np.array_equal(np.asarray(w), g.numpy()), name
        assert int(np.asarray(want.match_overflow).sum()) > 0


#: the edge cases' filters: FILTERS and deeper ones under the same roots,
#: so a row matches more than K = 2 own and Km = 1 micro filters
EDGE_FILTERS = FILTERS + ["a/b", "a/b/#", "a/+/#", "+/b/#", "+/+", "x/#",
                          "rooms/#", "b/#"]
_EDGE_FORMS = {
    "replicated": dict(routed=False),
    "micro_owner_1": dict(routed=False, micro_owner=1),
    "routed": dict(routed=True),
    "routed_compact": dict(routed=True, compact=True),
    "overflow": dict(routed=True, capacity=1),
    "overflow_compact": dict(routed=True, compact=True, capacity=2),
}


@pytest.fixture(scope="module")
def edge_tables():
    """One reference matcher a mesh shape of tp 2 and 4, dp 1 and 2, on
    EDGE_FILTERS, with the port's converted tables."""
    out = {}
    for dp, tp in ((1, 2), (2, 2), (1, 4), (2, 4)):
        inc = RefIncrementalNfa(depth=8)
        pairs = pairs_of(inc, EDGE_FILTERS)
        ref = ref_matcher(pairs, n=dp * tp, tp=tp, native=False)
        mesh = make_mesh({"dp": dp, "tp": tp}, cpus(dp * tp))
        out[(dp, tp)] = (ref, mesh,
                         multichip_arrays_from_reference(ref, mesh))
    return out


def _edge_batch(ref, seed):
    """A 64-row batch with a hot root, rows that match past K = 2 and Km
    = 1, a negative and an out-of-map root word, rows past the depth (len
    D+1) and the encoder's pad rows (len D+2)."""
    topics = (topics_for(30, seed=seed) + ["a/b/c"] * 6 + ["x/y/z"] * 12
              + ["a/b", "rooms/1/temp", "$SYS/a", "zzz/b", "qqq"])
    words, lens, is_sys = (np.array(x) for x in ref.encode(topics,
                                                           batch=64))
    D = words.shape[1]
    words[3, 0] = -5
    words[4, 0] = 1 << 20
    words[5, 0] = -(1 << 30)
    lens[6] = D + 1
    lens[7] = D + 2
    return words, lens, is_sys


def _step_pair(ref, mesh, tabs, enc, K, Km, kw):
    rstep = ref_mcs.build_multichip_step(ref.mesh, 16, K, micro_matches=Km,
                                         **kw)
    want = jax.device_get(rstep(*(jnp.asarray(x) for x in enc), *ref._arrs))
    got = build_multichip_step(mesh, 16, K, micro_matches=Km, **kw)(
        *enc, tabs)
    return want, got


@pytest.mark.parametrize("form", sorted(_EDGE_FORMS))
@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (1, 4), (2, 4)])
def test_step_edge_cases_match_reference(edge_tables, dp, tp, form):
    """K8a's routing grid and merge on the edge cases, every field bit
    for bit the reference's: buckets past capacity, rows past the depth,
    rows past K and micro counts past Km, negative and out-of-map root
    words, dp 2, a migrated micro owner, tp 2 and 4."""
    ref, mesh, tabs = edge_tables[(dp, tp)]
    kw = dict(_EDGE_FORMS[form])
    if kw["routed"]:
        kw.setdefault("capacity", ref.ep_capacity(64))
    enc = _edge_batch(ref, seed=dp * 10 + tp)
    want, got = _step_pair(ref, mesh, tabs, enc, 2, 1, kw)
    for name, w, g in zip(want._fields, want, got):
        assert np.array_equal(np.asarray(w), g.numpy()), name
    assert int(np.asarray(want.n_matches).max()) > 3
    assert int(np.asarray(want.match_overflow).sum()) > 0
    if form.startswith("overflow"):
        # the source-side overflow flags rows that no owner wrote
        counts = np.asarray(want.counts).sum(axis=1)
        assert ((np.asarray(want.match_overflow) > 0) & (counts == 0)).any()


@pytest.mark.parametrize("form", ["replicated", "routed", "routed_compact",
                                  "overflow"])
@pytest.mark.parametrize("dp,tp", [(1, 4), (2, 2)])
def test_step_on_several_devices_matches_reference(edge_tables, monkeypatch,
                                                   dp, tp, form):
    """The layout of a mesh of several devices (each device buckets its
    own sources, ``all_to_all`` lands the grid, each device merges what
    it walked and the lead sums the parts), forced on the CPU mesh:
    every field the reference's."""
    from emqx_tpu_torch.parallel import steps

    monkeypatch.setattr(steps, "one_device", lambda devices: False)
    ref, mesh, tabs = edge_tables[(dp, tp)]
    kw = dict(_EDGE_FORMS[form])
    if kw["routed"]:
        kw.setdefault("capacity", ref.ep_capacity(64))
    enc = _edge_batch(ref, seed=7)
    want, got = _step_pair(ref, mesh, tabs, enc, 2, 1, kw)
    for name, w, g in zip(want._fields, want, got):
        assert np.array_equal(np.asarray(w), g.numpy()), name


def test_step_result_is_one_buffer_and_one_host_copy(step_tables):
    """The step's six fields are views of one int32 buffer, so the
    matcher's readback is one copy of it."""
    _inc, ref, mesh, tabs = step_tables[(1, 4)]
    enc = ref.encode(topics_for(20), batch=64)
    for kw in (dict(routed=False), dict(routed=True, capacity=8),
               dict(routed=True, compact=True, capacity=8)):
        got = build_multichip_step(mesh, 16, 32, micro_matches=8, **kw)(
            *enc, tabs)
        base = got.ids._base
        assert base is not None and all(x._base is base for x in got)
        assert base.numel() == sum(x.numel() for x in got)
        host = mcs_mod._host_copy(got, False)
        assert host[0]._base is host[-1]._base is not None
        for h, x in zip(host, got):
            assert torch.equal(h, x)


# -- the matcher against the reference's ---------------------------------------

@pytest.mark.parametrize("kw", [{}, {"ep": True, "ep_slack": 4.0},
                                {"ep": True, "ep_slack": 4.0,
                                 "ep_compact": True}],
                         ids=["replicated", "routed", "routed_compact"])
def test_matcher_tables_and_rows_equal_reference(kw):
    """On Python subtables the port's matcher builds the reference's
    stacked tables byte for byte, and serves the reference's rows, spill
    sets and readback bytes; through a churn (scatters) too."""
    grow = [f"g{i % 7}/{i}/+" for i in range(60)]
    inc = RefIncrementalNfa(depth=8)
    pairs = pairs_of(inc, FILTERS + grow)
    ref = ref_matcher(pairs, native=False, **kw)
    mc = MultichipMatcher(depth=8, devices=cpus(8), native=False, **kw)
    mc.rebuild(pairs)
    assert mc.apply_pending()
    topics = topics_for(48) + [f"g3/{i}/q" for i in range(3, 60, 7)]

    def same():
        _shape, arrs = mc._stacked()
        for a, b in zip(ref._arrs, arrs):
            assert np.array_equal(np.asarray(a), b)
        assert mc._stacked_shape == ref._stacked_shape
        for dp_row in mc._arrs.shard:
            for t, s in enumerate(dp_row):
                assert np.array_equal(s[0].numpy(),
                                      np.asarray(ref._arrs[0])[t])
                assert np.array_equal(s[1].numpy(),
                                      np.asarray(ref._arrs[1])[t])
        want = ref.readback(ref.dispatch(ref.encode(topics, batch=64)),
                            len(topics))
        got = mesh_rows(mc, topics)
        assert got == want

    same()
    for f in ("live/+/one", "+/added", "g3/9/+"):
        inc.add(f)
        for m in (ref, mc):
            m.note_add(f, inc.aid_of(f))
    for f in ("a/+", "#"):
        inc.remove(f)
        for m in (ref, mc):
            m.note_del(f)
    assert ref.apply_pending() and mc.apply_pending()
    assert mc.restacks == ref.restacks
    topics += ["live/x/one", "q/added"]
    same()


# -- the reference's scenarios on the port ------------------------------------

def test_compact_rows_bit_for_bit_vs_host_and_single_chip():
    """The dense compact contract off the mesh reproduces the
    single-device serve path's rows (same service accept ids) and the
    host walk on every topic, on both kinds of subtable."""
    from emqx_tpu_torch.broker.match_service import MatchService

    for native in (False, True):
        inc, mc, _pairs = build_pair(native=native)
        dev = DeviceNfa(inc, active_slots=8, max_matches=16, device="cpu")
        topics = topics_for(64)
        rows8, sp8, nbytes = mesh_rows(mc, topics)
        assert nbytes == 4 * 64 * (mc.tp * 40 + mc.tp + 3)
        enc = encode_batch(inc, topics, batch=64)
        res = dev.match(*dev.put_batch(*enc), flat_cap=8 * 64)
        rows1, sp1 = MatchService._readback_rows(res, len(topics), 16)
        assert not sp8 and not sp1
        for t, r8, r1 in zip(topics, rows8, rows1):
            assert sorted(r8) == sorted(r1) == sorted(inc.match_host(t)), t


@pytest.mark.parametrize("native", [False, True])
def test_delta_churn_and_growth_restack_parity(native):
    """note_add/note_del ride the apply cycle; small deltas scatter in
    place (no restack), growth past a power of two restacks, and parity
    holds through both."""
    inc, mc, _pairs = build_pair(native=native)
    gen0, restacks0 = mc.gen, mc.restacks
    tabs0 = mc._arrs
    for f in ("live/+/one", "live/two"):
        inc.add(f)
        mc.note_add(f, inc.aid_of(f))
    inc.remove("a/+")
    mc.note_del("a/+")
    assert mc.apply_pending()
    if mc.restacks == restacks0:
        # scattered into the same node tensors, in place
        assert mc._arrs.shard[0][0][0] is tabs0.shard[0][0][0]
    topics = topics_for(32) + ["live/x/one", "live/two", "a/q"]
    rows, sp, _ = mesh_rows(mc, topics)
    for i, (t, r) in enumerate(zip(topics, rows)):
        if i not in sp:
            assert sorted(r) == sorted(inc.match_host(t)), t
    for i in range(400):
        f = f"grow/{i}/+"
        inc.add(f)
        mc.note_add(f, inc.aid_of(f))
    assert mc.apply_pending()
    assert mc.gen > gen0
    check = ["grow/7/z", "grow/399/z", "m/n"]
    rows, sp, _ = mesh_rows(mc, check)
    assert not sp
    assert [sorted(r) for r in rows] == host_rows(inc, check)


def test_truncation_psum_fail_open():
    """Every row the summed overflow did not flag is complete."""
    inc, mc, _pairs = build_pair(max_matches=1, ep_micro_matches=1)
    topics = ["a/b", "a/b/c", "x/y/z", "m/n", "b/c"]
    rows, sp, _ = mesh_rows(mc, topics)
    assert sp
    for i, t in enumerate(topics):
        if i not in sp:
            assert sorted(rows[i]) == sorted(inc.match_host(t)), t


def test_shard_kill_raises_and_counts_failover():
    inc, mc, _pairs = build_pair()
    enc = mc.encode(["a/b"], batch=64)
    mc.dispatch(enc)
    mc.kill_shard(2)
    with pytest.raises(ShardDead):
        mc.dispatch(enc)
    assert mc.failovers == 1
    mc.revive_shard(2)
    rows, _, _ = mesh_rows(mc, ["a/b"])
    assert sorted(rows[0]) == sorted(inc.match_host("a/b"))


def test_match_shard_fault_injection_point():
    inc, mc, _pairs = build_pair()
    enc = mc.encode(["a/b"], batch=64)
    faultinject.install(FaultInjector([
        {"point": "match.shard", "action": "raise", "times": 1}]))
    with pytest.raises(faultinject.InjectedFault):
        mc.dispatch(enc)
    assert mc.failovers == 1
    mc.dispatch(enc)   # the rule is spent: healthy again


def test_shard_launch_failure_surfaces_as_shard_dead(monkeypatch):
    """A shard whose walk raises is never a silent host answer: the
    dispatch raises ShardDead naming the shard, counted as a failover,
    and with the degraded mesh it strikes that shard (three strikes mark
    it dead)."""
    m = Metrics()
    inc, mc, _pairs = build_pair(degraded=True, metrics=m)
    real = mcs_mod._raw_walk

    def failing(active_slots, plain):
        walk = real(active_slots, plain)

        def fn(w, l, s, node, edge, seeds):
            if node.shape[0] == failing.rows:
                raise RuntimeError("launch failed")
            return walk(w, l, s, node, edge, seeds)
        return fn

    failing.rows = int(mc._arrs.shard[0][0][0].shape[0])
    monkeypatch.setattr(mcs_mod, "_raw_walk", failing)
    mc._steps.clear()
    enc = mc.encode(["a/b"], batch=64)
    for strike in range(1, 4):
        with pytest.raises(ShardDead) as e:
            mc.dispatch(enc)
        assert e.value.shard == 0
        assert mc.failovers == strike
        assert m.get("tpu.match.shard_failover") == strike
    assert mc.dead_shards == [0] and mc.mesh_state() == 1
    monkeypatch.setattr(mcs_mod, "_raw_walk", real)
    mc._steps.clear()
    rows, sp, _ = mesh_rows(mc, ["a/b", "m/n"])
    assert not sp
    fill = mc.dead_aids()
    for t, r in zip(["a/b", "m/n"], rows):
        host = set(inc.match_host(t))
        assert set(r) | (host & fill) == host


@pytest.mark.parametrize("native", [False, True])
def test_segments_roundtrip_epoch_and_checksum_guards(tmp_path, native):
    inc, mc, _pairs = build_pair(native=native)
    d = str(tmp_path)
    mc.save_segments(d, epoch=inc.epoch)
    topics = topics_for(16)
    want, _, _ = mesh_rows(mc, topics)
    mc2 = MultichipMatcher(depth=8, devices=cpus(8), native=native)
    assert not mc2.load_segments(d, expect_epoch=inc.epoch + 1)
    mc3 = MultichipMatcher(depth=8, devices=cpus(8), native=native)
    assert mc3.load_segments(d, expect_epoch=inc.epoch)
    assert mc3.dirty and not mc3.ready
    assert mc3.apply_pending()
    got, _, _ = mesh_rows(mc3, topics)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert mc3.seeded_from_segments
    # a table of the other kind refuses the manifest
    other = MultichipMatcher(depth=8, devices=cpus(8), native=not native)
    assert not other.load_segments(d, expect_epoch=inc.epoch)
    mpath = os.path.join(d, "multichip", "aid_maps.npz")
    maps = dict(np.load(mpath))
    maps["m0"] = np.asarray(maps["m0"], np.int32) + 1
    np.savez(mpath, **maps)
    mc4 = MultichipMatcher(depth=8, devices=cpus(8), native=native)
    assert not mc4.load_segments(d, expect_epoch=inc.epoch)
    mc5 = MultichipMatcher(depth=8, tp=2, devices=cpus(8), native=native)
    assert not mc5.load_segments(d, expect_epoch=inc.epoch)


def test_segments_cross_package(tmp_path):
    """Per-shard segments written by the reference load into the port's
    matcher and serve the reference's rows (and the other way round)."""
    inc = RefIncrementalNfa(depth=8)
    pairs = pairs_of(inc, FILTERS)
    ref = ref_matcher(pairs, native=False)
    topics = topics_for(24)
    want = ref.readback(ref.dispatch(ref.encode(topics, batch=64)),
                        len(topics))
    ref.save_segments(str(tmp_path / "a"), epoch=inc.epoch)
    mc = MultichipMatcher(depth=8, devices=cpus(8), native=False)
    assert mc.load_segments(str(tmp_path / "a"), expect_epoch=inc.epoch)
    assert mc.apply_pending()
    assert mesh_rows(mc, topics) == want
    mc.save_segments(str(tmp_path / "b"), epoch=inc.epoch)
    back = ref_mcs.MultichipMatcher(depth=8, devices=jax.devices()[:8],
                                    native=False)
    assert back.load_segments(str(tmp_path / "b"), expect_epoch=inc.epoch)
    assert back.apply_pending()
    assert back.readback(back.dispatch(back.encode(topics, batch=64)),
                         len(topics)) == want


def test_no_kernel_cache_or_compile_miss_on_the_mesh():
    """Intended divergence (in place of the reference's kernel-cache
    mesh keys, CompileMiss and prewarm): the matcher takes no kernel
    cache, and a cold shape dispatches and serves at once: a CUDA kernel
    is built once for every shape, so there is nothing to compile."""
    with pytest.raises(TypeError):
        MultichipMatcher(depth=8, devices=cpus(8), kernel_cache=object())
    inc, mc, _pairs = build_pair()
    assert not hasattr(mc, "kernel_cache")
    assert not hasattr(mc, "_lower_step")
    for b in (64, 128, 256):
        for depth in (4, 8):
            rows, sp, _ = mesh_rows(mc, ["a/b", "x/y/z"], batch=b,
                                    depth=depth)
            assert not sp
            assert [sorted(r) for r in rows] == \
                host_rows(inc, ["a/b", "x/y/z"])
    assert len(mc._steps) == 6


def test_ep_routed_parity_vs_replicated_mixed_roots():
    inc, mc_rep, pairs = build_pair()
    mc_ep = MultichipMatcher(depth=8, devices=cpus(8), ep=True,
                             ep_slack=4.0)
    mc_ep.rebuild(pairs)
    assert mc_ep.apply_pending()
    topics = topics_for(48)
    rows_r, sp_r, _ = mesh_rows(mc_rep, topics)
    rows_e, sp_e, _ = mesh_rows(mc_ep, topics)
    assert mc_ep.ep_dispatches == 1 and mc_rep.ep_dispatches == 0
    assert not sp_r and not sp_e
    for t, rr, re_ in zip(topics, rows_r, rows_e):
        assert sorted(re_) == sorted(rr) == sorted(inc.match_host(t)), t


@pytest.mark.parametrize("compact", [False, True])
def test_ep_bucket_overflow_fails_open(compact):
    """A hot root overflows its (source, owner) bucket: the overflowed
    rows are flagged for the host, never dropped; the rest stay
    complete (with the compact contract too)."""
    inc, mc, _pairs = build_ep_pair(ep_slack=1.0, ep_compact=compact)
    topics = [f"x/{i}/z" for i in range(24)] + ["x/y/z"] * 8
    rows, sp, _ = mesh_rows(mc, topics)
    assert sp and len(set(sp)) < len(topics)
    for i, t in enumerate(topics):
        if i not in sp:
            assert sorted(rows[i]) == sorted(inc.match_host(t)), t


def test_ep_micro_table_completeness_unknown_roots():
    inc, mc, _pairs = build_ep_pair(ep_slack=4.0)
    topics = ["zzz/b", "unknown/word/here", "qqq"]
    rows, sp, _ = mesh_rows(mc, topics)
    assert not sp
    for t, r in zip(topics, rows):
        want = sorted(inc.match_host(t))
        assert want and sorted(r) == want, (t, r, want)


def test_ep_micro_table_tracks_churn():
    inc, mc, _pairs = build_ep_pair(ep_slack=4.0)
    inc.add("+/added")
    mc.note_add("+/added", inc.aid_of("+/added"))
    inc.remove("#")
    mc.note_del("#")
    assert mc.apply_pending()
    assert "+/added" in mc._micro_filters and "#" not in mc._micro_filters
    topics = ["q/added", "zz/yy"]
    rows, sp, _ = mesh_rows(mc, topics)
    assert not sp
    assert [sorted(r) for r in rows] == host_rows(inc, topics)


def test_ep_route_fault_injection_point():
    inc, mc, _pairs = build_ep_pair(ep_slack=4.0)
    enc = mc.encode(["a/b"], batch=64)
    faultinject.install(FaultInjector([
        {"point": "ep.route", "action": "raise", "times": 1}]))
    with pytest.raises(faultinject.InjectedFault):
        mc.dispatch(enc)
    assert mc.failovers == 1
    rows, _, _ = mc.readback(mc.dispatch(enc), 1)
    assert sorted(rows[0]) == sorted(inc.match_host("a/b"))


def test_ep_shard_kill_raises_before_routing():
    _inc, mc, _pairs = build_ep_pair(ep_slack=4.0)
    enc = mc.encode(["a/b"], batch=64)
    mc.dispatch(enc)
    mc.kill_shard(3)
    with pytest.raises(ShardDead):
        mc.dispatch(enc)
    assert mc.failovers == 1


def test_ep_metrics_width_gate_and_odd_batches_fall_back():
    m = Metrics()
    inc, mc, _pairs = build_ep_pair(metrics=m)
    b = 64
    rows, _, _ = mesh_rows(mc, ["a/b"], batch=b)
    assert sorted(rows[0]) == sorted(inc.match_host("a/b"))
    assert m.get("tpu.match.ep_dispatches") == 1
    width = m.get("tpu.match.ep_shard_width")
    assert width == mc.tp * mc.ep_capacity(b)
    assert width <= math.ceil(mc.ep_slack * (b // mc.dp) / mc.tp)
    assert m.get("tpu.match.ep_ici_bytes") == \
        mc.dp * mc.tp * (mc.tp - 1) * mc.ep_capacity(b) * (8 + 3) * 4
    assert m.get("tpu.match.shard_devices") == 8
    rows2, _, _ = mesh_rows(mc, ["a/b"], batch=4)
    assert sorted(rows2[0]) == sorted(inc.match_host("a/b"))
    assert m.get("tpu.match.ep_dispatches") == 1   # replicated fallback


def test_ep_compact_parity_and_bytes_reduction():
    inc, mc_rep, pairs = build_pair()
    mcs = {}
    for compact in (False, True):
        mcs[compact] = MultichipMatcher(depth=8, devices=cpus(8), ep=True,
                                        ep_slack=4.0, ep_compact=compact)
        mcs[compact].rebuild(pairs)
        assert mcs[compact].apply_pending()
        assert mcs[compact].info()["ep_compact"] is compact
    topics = topics_for(48)
    rows_r, sp_r, _ = mesh_rows(mc_rep, topics)
    rows_e, sp_e, nb_e = mesh_rows(mcs[False], topics)
    rows_c, sp_c, nb_c = mesh_rows(mcs[True], topics)
    assert not sp_r and not sp_e and not sp_c
    for t, rr, re_, rc in zip(topics, rows_r, rows_e, rows_c):
        assert sorted(rc) == sorted(re_) == sorted(rr) \
            == sorted(inc.match_host(t)), t
    assert nb_c <= nb_e // 2, (nb_c, nb_e)


def test_ep_compact_odd_batch_falls_back_replicated():
    inc, mc, _pairs = build_ep_pair(ep_slack=4.0, ep_compact=True)
    rows, _, _ = mesh_rows(mc, ["a/b"], batch=4)
    assert sorted(rows[0]) == sorted(inc.match_host("a/b"))
    assert mc.ep_dispatches == 0


# -- the degraded mesh ---------------------------------------------------------

def fill_parity(inc, mc, topics, rows, sp, fill=None):
    fill = mc.dead_aids() if fill is None else fill
    for i, t in enumerate(topics):
        if i in set(sp):
            continue
        host = set(inc.match_host(t))
        assert set(rows[i]) | (host & fill) == host, t


def test_degraded_flag_off_whole_plane_failover_unchanged():
    inc, mc, _pairs = build_pair()
    assert mc.degraded is False
    mc.kill_shard(0)
    assert not mc.degraded_serving and mc.mesh_state() == 2
    with pytest.raises(ShardDead):
        mc.dispatch(mc.encode(["a/b"], batch=64))
    assert mc.failovers == 1 and mc.degraded_batches == 0
    mc.revive_shard(0)
    assert mc.mesh_state() == 0
    rows, _, _ = mesh_rows(mc, ["a/b"])
    assert sorted(rows[0]) == sorted(inc.match_host("a/b"))
    assert all(len(k) == 3 for k in mc._steps)


def test_degraded_replicated_mask_and_micro_owner_migration():
    met = Metrics()
    inc, mc, _pairs = build_pair(degraded=True, metrics=met)
    topics = topics_for(24) + ["m/n", "q/b"]
    want = [set(inc.match_host(t)) for t in topics]
    mc.kill_shard(0)
    assert mc.degraded_serving and mc.mesh_state() == 1
    dead = mc.dead_aids()
    assert dead
    micro_aids = set(mc._micro_filters.values())
    assert micro_aids and not (micro_aids & dead)
    rows, sp, _ = mesh_rows(mc, topics)
    assert not sp
    for t, r, w in zip(topics, rows, want):
        assert set(r) == w - dead, t
    i = topics.index("q/b")
    assert set(rows[i]) == want[i]
    assert any(k[-1] == 1 for k in mc._steps if len(k) == 4)
    assert met.get("tpu.mesh.degraded_batches") >= 1
    assert met.get("tpu.mesh.state") == 1
    mc.revive_shard(0)
    rows2, _, _ = mesh_rows(mc, topics)
    assert [set(r) for r in rows2] == want


def test_degraded_ep_scoped_failover_row_accounting():
    met = Metrics()
    tp = serve_mesh_shape(8)["tp"]
    roots = {t: [] for t in range(tp)}
    i = 0
    while any(len(v) < 2 for v in roots.values()):
        r = f"r{i}"
        i += 1
        roots[shard_of_filter(f"{r}/a/+", tp)].append(r)
    inc = IncrementalNfa(depth=8)
    flts = [f for t in range(tp) for r in roots[t][:2]
            for f in (f"{r}/a/+", f"{r}/b/#")] + ["+/m/#"]
    pairs = pairs_of(inc, flts)
    mc = MultichipMatcher(depth=8, devices=cpus(8), ep=True, ep_slack=4.0,
                          degraded=True, metrics=met)
    mc.rebuild(pairs)
    assert mc.apply_pending()
    batch = 64
    topics = [f"{roots[k % tp][(k // tp) % 2]}/a/x" for k in range(batch)]
    _rows0, sp0, _ = mesh_rows(mc, topics, batch=batch)
    assert not sp0 and mc.ep_dispatches == 1
    victim = 1
    mc.kill_shard(victim)
    rows, sp, _ = mesh_rows(mc, topics, batch=batch)
    dead_rows = {k for k, t in enumerate(topics)
                 if shard_of_filter(t, tp) == victim}
    assert set(sp) == dead_rows and len(sp) == batch // tp
    for k, t in enumerate(topics):
        if k not in dead_rows:
            assert sorted(rows[k]) == sorted(inc.match_host(t)), t
    assert mc.cpu_filled_rows == len(dead_rows)
    assert met.get("tpu.mesh.cpu_filled_rows") == len(dead_rows)


def test_degraded_double_kill_cpu_only_then_staged_readmit():
    inc, mc, pairs = build_pair(degraded=True)
    topics = topics_for(24) + ["m/n", "b/c"]
    mc.kill_shard(0)
    assert mc.mesh_state() == 1
    mc.kill_shard(1)
    assert not mc.degraded_serving and mc.mesh_state() == 2
    with pytest.raises(ShardDead):
        mc.dispatch(mc.encode(topics, batch=64))
    for t in (0, 1):
        assert mc.rebuild_shard(t, pairs) >= 0.0
        ctop = mc.canary_topics(t)
        assert ctop
        crows, csp = mc.canary_rows(ctop, 64, t)
        fill_parity(inc, mc, ctop, crows, csp, fill=mc.dead_aids(exclude=t))
        mc.revive_shard(t)
        assert mc.mesh_state() == (1 if t == 0 else 0)
        if t == 0:
            rows, sp, _ = mesh_rows(mc, topics)
            assert not sp
            fill_parity(inc, mc, topics, rows, sp)
    rows, sp, _ = mesh_rows(mc, topics)
    assert not sp and [sorted(r) for r in rows] == host_rows(inc, topics)
    assert mc.rebuilds == 2


@pytest.mark.parametrize("native", [False, True])
def test_rebuild_shard_delta_tail_replay_and_readmit_zero_stale(native,
                                                                tmp_path):
    """The online rebuild converges on the live filters (a filter added
    while its shard was dead is replayed), seeded from the shard's
    segment when its epoch matches; the canary proves parity."""
    inc, mc, pairs = build_pair(degraded=True, native=native)
    mc.save_segments(str(tmp_path), epoch=inc.epoch)
    f = "delta/x/+"
    t = shard_of_filter(f, mc.tp)
    mc.kill_shard(t)
    epoch = inc.epoch
    inc.add(f)
    pairs.append((f, inc.aid_of(f)))
    assert mc.rebuild_shard(t, pairs, str(tmp_path), epoch) >= 0.0
    ctop = mc.canary_topics(t)
    assert any(c.startswith("delta/") for c in ctop)
    crows, csp = mc.canary_rows(ctop, 64, t)
    for i, topic in enumerate(ctop):
        if i not in csp:
            assert sorted(crows[i]) == sorted(inc.match_host(topic)), topic
    mc.revive_shard(t)
    rows, sp, _ = mesh_rows(mc, ["delta/x/y"])
    assert not sp and inc.aid_of(f) in rows[0]
    assert sorted(rows[0]) == sorted(inc.match_host("delta/x/y"))


def test_mesh_rebuild_fault_injection_point():
    _inc, mc, pairs = build_pair(degraded=True)
    mc.kill_shard(1)
    faultinject.install(FaultInjector([
        {"point": "mesh.rebuild", "action": "raise", "times": 1}]))
    with pytest.raises(faultinject.InjectedFault):
        mc.rebuild_shard(1, pairs)
    assert mc.rebuilds == 0
    assert mc.rebuild_shard(1, pairs) >= 0.0


def test_shard_kill_races_apply_pending_restack():
    inc, mc, pairs = build_pair(degraded=True)
    victim = 1
    real = mc._restack

    def racy():
        mc.kill_shard(victim)
        real()

    mc._restack = racy
    try:
        pairs += pairs_of(inc, ["race/a/+", "race/b/#"])
        mc.rebuild(pairs)
        assert mc.apply_pending()
    finally:
        mc._restack = real
    assert mc.dead_shards == [victim] and mc.degraded_serving
    topics = topics_for(16) + ["race/a/x", "b/c"]
    rows, sp, _ = mesh_rows(mc, topics)
    assert not sp
    fill_parity(inc, mc, topics, rows, sp)
    assert mc.rebuild_shard(victim, pairs) >= 0.0
    mc.revive_shard(victim)
    rows2, sp2, _ = mesh_rows(mc, topics)
    assert not sp2 and [sorted(r) for r in rows2] == host_rows(inc, topics)


# -- the load-adaptive plane ---------------------------------------------------

def _colliding_roots(tp, n, prefix="h"):
    out, i = [], 0
    while len(out) < n:
        r = f"{prefix}{i}"
        if shard_of_filter(r, tp) == shard_of_filter(f"{prefix}0", tp):
            out.append(r)
        i += 1
    return out


def test_autotune_flag_off_byte_identical():
    _inc, mc_off, pairs = build_ep_pair(ep_slack=4.0)
    mc_on = MultichipMatcher(depth=8, devices=cpus(8), ep=True, ep_slack=4.0,
                             ep_autotune=True)
    mc_on.rebuild(pairs)
    assert mc_on.apply_pending()
    topics = topics_for(48)
    rows_off, sp_off, _ = mesh_rows(mc_off, topics)
    rows_on, sp_on, _ = mesh_rows(mc_on, topics)
    assert sp_off == sp_on
    assert [sorted(r) for r in rows_off] == [sorted(r) for r in rows_on]
    assert mc_off._cap_class == 0 and mc_off._placement == {}
    assert mc_off.ep_resizes == 0 and not mc_off._root_load.any()
    assert mc_off.plan_rebalance() == 0
    assert mc_off._placement_next is None
    for f in FILTERS:
        assert mc_off.shard_of(f) == shard_of_filter(f, mc_off.tp)
    assert mc_off.ep_capacity(64) == mc_on.ep_capacity(64)
    assert mc_on._cap_class == 0 and mc_on._placement == {}


def test_overflow_ewma_grow_rearms_warn_latch_rows_complete(caplog):
    """A hot root overflowing every source slice grows the grid two
    classes; every row of every batch stays complete meanwhile, the grow
    zeroes the EWMA and re-arms the warning (it warns again at the
    grown class)."""
    inc, mc, _pairs = build_ep_pair(ep_slack=0.5, ep_autotune=True,
                                    ep_grow_threshold=0.6)
    topics = [f"x/{i}/z" for i in range(56)] + ["x/y/z"] * 8
    want = host_rows(inc, topics)
    cap0 = mc.ep_capacity(64)
    with caplog.at_level(logging.WARNING, logger=mcs_mod.__name__):
        for _ in range(200):
            if mc.ep_resizes >= 2:
                break
            rows, sp, _ = mesh_rows(mc, topics)
            for k, r in enumerate(rows):
                if k not in sp:
                    assert sorted(r) == want[k]
    assert mc.ep_resizes >= 2 and mc._cap_class >= 2
    assert mc.failovers == 0
    assert mc.ep_capacity(64) > cap0
    warns = [r for r in caplog.records if "overflow EWMA" in r.message]
    assert len(warns) >= 2
    assert len([r for r in caplog.records
                if "grew to capacity" in r.message]) >= 2
    rows, sp, _ = mesh_rows(mc, topics)
    for k, r in enumerate(rows):
        if k not in sp:
            assert sorted(r) == want[k]


def test_resize_compiles_nothing_and_flips_at_the_readback():
    """Intended divergence (in place of the reference's kernel-cache
    grow that compiles ahead on a background thread): there is nothing
    to compile, so the class flips inside the readback that crosses the
    threshold, no thread is started, and the next dispatch serves the
    grown grid at once."""
    m = Metrics()
    inc, mc, _pairs = build_ep_pair(ep_slack=0.5, ep_autotune=True,
                                    ep_grow_threshold=0.05, metrics=m)
    assert not hasattr(mc, "_resize_thread")
    assert not hasattr(mc, "drain_resize")
    topics = [f"x/{i}/z" for i in range(64)]
    enc = mc.encode(topics, batch=64)
    h = mc.dispatch(enc)
    assert mc._cap_class == 0
    mc.readback(h, len(topics))
    assert mc._cap_class == 1 and mc.ep_resizes == 1
    assert m.get("tpu.match.ep_cap_class") == 1
    assert m.get("tpu.match.ep_resizes") == 1
    assert mc._ov_ewma == 0.0
    cap1 = mc.ep_capacity(64)
    assert cap1 > mc._capacity_at(64, 0)
    rows, sp, _ = mc.readback(mc.dispatch(enc), len(topics))
    assert (64, 8, 1, cap1) in mc._steps
    for k, t in enumerate(topics):
        if k not in sp:
            assert sorted(rows[k]) == sorted(inc.match_host(t)), t


def test_plan_rebalance_stages_and_rebuild_applies_with_parity():
    mc = MultichipMatcher(depth=8, devices=cpus(8), ep=True, ep_slack=4.0,
                          ep_autotune=True, balance_budget=64)
    hot = _colliding_roots(mc.tp, 4)
    home = shard_of_filter(f"{hot[0]}/a/+", mc.tp)
    inc = IncrementalNfa(depth=8)
    pairs = pairs_of(inc, [f for r in hot for f in (f"{r}/a/+", f"{r}/b/#")])
    mc.rebuild(pairs)
    assert mc.apply_pending()
    topics = [f"{hot[k % 4]}/a/x" for k in range(64)]
    for _ in range(3):
        mesh_rows(mc, topics)
    assert mc._root_load.any()
    moved = mc.plan_rebalance()
    assert moved >= 1
    assert mc._placement == {} and mc._placement_next
    assert all(mc.shard_of(f"{r}/a/x") == home for r in hot)
    rows0, sp0, _ = mesh_rows(mc, topics)
    assert not sp0
    mc.rebuild(pairs)
    assert mc.apply_pending()
    assert mc._placement and mc._placement_next is None
    assert len({mc.shard_of(f"{r}/a/x") for r in hot}) > 1
    for r in hot:
        assert int(mc._word_owner[mc.vocab[r]]) == mc.shard_of(f"{r}/a/x")
    _, mc_rep, _ = build_pair()
    mc_rep.rebuild(pairs)
    assert mc_rep.apply_pending()
    rows_e, sp_e, _ = mesh_rows(mc, topics)
    rows_r, sp_r, _ = mesh_rows(mc_rep, topics)
    assert not sp_e and not sp_r
    for t, re_, rr, r0 in zip(topics, rows_e, rows_r, rows0):
        assert sorted(re_) == sorted(rr) == sorted(r0) == \
            sorted(inc.match_host(t)), t
    assert mc.ep_rebalances == 1 and mc.moved_roots == moved


def test_placement_segments_roundtrip_v3_and_skew_rejection(tmp_path):
    mc = MultichipMatcher(depth=8, devices=cpus(8), ep=True, ep_slack=4.0,
                          ep_autotune=True, balance_budget=64)
    hot = _colliding_roots(mc.tp, 4)
    inc = IncrementalNfa(depth=8)
    pairs = pairs_of(inc, [f for r in hot for f in (f"{r}/a/+", f"{r}/b/#")])
    mc.rebuild(pairs)
    assert mc.apply_pending()
    topics = [f"{hot[k % 4]}/a/x" for k in range(64)]
    for _ in range(3):
        mesh_rows(mc, topics)
    assert mc.plan_rebalance() >= 1
    mc.rebuild(pairs)
    assert mc.apply_pending() and mc._placement
    d = str(tmp_path)
    mc.save_segments(d, epoch=inc.epoch)
    want, _, _ = mesh_rows(mc, topics)
    mc2 = MultichipMatcher(depth=8, devices=cpus(8), ep=True, ep_slack=4.0,
                           ep_autotune=True)
    assert mc2.load_segments(d, expect_epoch=inc.epoch)
    assert mc2._placement == mc._placement
    assert mc2.apply_pending()
    got, sp, _ = mesh_rows(mc2, topics)
    assert not sp and [sorted(r) for r in got] == [sorted(r) for r in want]
    mpath = os.path.join(d, "multichip", "aid_maps.npz")
    maps = dict(np.load(mpath))
    ps = np.asarray(maps["ps"], np.int32)
    ps[0] = (ps[0] + 1) % mc.tp
    maps["ps"] = ps
    np.savez(mpath, **maps)
    manp = os.path.join(d, "multichip", "manifest.json")
    with open(manp) as f:
        meta = json.load(f)
    core = {k: meta[k] for k in ("version", "epoch", "tp", "depth", "native")}
    meta["checksum"] = MultichipMatcher._manifest_checksum(core, maps)
    with open(manp, "w") as f:
        json.dump(meta, f, sort_keys=True)
    mc3 = MultichipMatcher(depth=8, devices=cpus(8), ep=True,
                           ep_autotune=True)
    assert not mc3.load_segments(d, expect_epoch=inc.epoch)
    meta["version"] = 2
    with open(manp, "w") as f:
        json.dump(meta, f, sort_keys=True)
    mc4 = MultichipMatcher(depth=8, devices=cpus(8), ep=True,
                           ep_autotune=True)
    assert not mc4.load_segments(d, expect_epoch=inc.epoch)


def test_rebalance_defers_while_degraded_then_readmit_post_remap():
    mc = MultichipMatcher(depth=8, devices=cpus(8), ep=True, ep_slack=4.0,
                          ep_autotune=True, balance_budget=64, degraded=True)
    hot = _colliding_roots(mc.tp, 4)
    home = shard_of_filter(f"{hot[0]}/a/+", mc.tp)
    inc = IncrementalNfa(depth=8)
    pairs = pairs_of(inc, [f for r in hot for f in (f"{r}/a/+", f"{r}/b/#")])
    mc.rebuild(pairs)
    assert mc.apply_pending()
    topics = [f"{hot[k % 4]}/a/x" for k in range(64)]
    for _ in range(3):
        mesh_rows(mc, topics)
    mc.kill_shard(home)
    assert mc.plan_rebalance() == 0
    assert mc._placement_next is None and mc.ep_rebalances == 0
    rows_d, sp_d, _ = mesh_rows(mc, topics)
    assert sp_d
    for k, t in enumerate(topics):
        if k not in sp_d:
            assert sorted(rows_d[k]) == sorted(inc.match_host(t)), t
    assert mc.rebuild_shard(home, pairs) >= 0.0
    mc.revive_shard(home)
    assert mc.plan_rebalance() >= 1
    mc.rebuild(pairs)
    assert mc.apply_pending()
    moved = [r for r in hot if mc.shard_of(f"{r}/a/x") != home]
    assert moved
    t2 = mc.shard_of(f"{moved[0]}/a/x")
    mc.kill_shard(t2)
    assert mc.plan_rebalance() == 0
    assert mc.rebuild_shard(t2, pairs) >= 0.0
    ctop = mc.canary_topics(t2)
    assert any(c.startswith(f"{moved[0]}/") for c in ctop)
    crows, csp = mc.canary_rows(ctop, 64, t2)
    for i, topic in enumerate(ctop):
        if i not in csp:
            assert sorted(crows[i]) == sorted(inc.match_host(topic)), topic
    mc.revive_shard(t2)
    rows_p, sp_p, _ = mesh_rows(mc, topics)
    assert not sp_p and [sorted(r) for r in rows_p] == host_rows(inc, topics)


def test_ep_rebalance_fault_injection_noop():
    mc = MultichipMatcher(depth=8, devices=cpus(8), ep=True, ep_slack=4.0,
                          ep_autotune=True, balance_budget=64)
    hot = _colliding_roots(mc.tp, 4)
    inc = IncrementalNfa(depth=8)
    pairs = pairs_of(inc, [f"{r}/a/+" for r in hot])
    mc.rebuild(pairs)
    assert mc.apply_pending()
    topics = [f"{hot[k % 4]}/a/x" for k in range(64)]
    for _ in range(3):
        mesh_rows(mc, topics)
    faultinject.install(FaultInjector([
        {"point": "ep.rebalance", "action": "raise", "times": 1}]))
    with pytest.raises(faultinject.InjectedFault):
        mc.plan_rebalance()
    assert mc._placement == {} and mc._placement_next is None
    assert mc.ep_rebalances == 0
    rows, sp, _ = mesh_rows(mc, topics)
    assert not sp and [sorted(r) for r in rows] == host_rows(inc, topics)
    assert mc.plan_rebalance() >= 1
    assert mc._placement_next
