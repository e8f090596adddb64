"""Parity of the port's two-tier table (``emqx_tpu_torch.ops.tiered``, K7)
with the JAX reference (``emqx_tpu.ops.tiered``), on the CPU.

Each case of ``tests/test_tiered.py`` and the tiered cases of
``tests/test_dense_match.py`` are played on both packages:
``split_filters``, ``route`` and ``pick_hot_roots`` (the byte budget,
a tiny one and the dense tier's state budget) equal; ``build_tiered``'s
hot roots and both tables' arrays equal; ``TieredMatcher.match`` per
topic equal to the reference's, list for list, with the reference in
interpret mode (its Pallas hot engine; the port's ``pallas`` engine is
its hash walk in raw mode, the same slots) and on its ``dense`` engine;
``info()`` counters equal; ``fused_tiered_match`` equal, field for
field, to the two calls made apart and to the reference's fused program.
The intended divergences are asserted: no demotion of a failing hot
engine (it raises), ``interpret`` has no effect, ``auto`` resolves to
``dense`` on a table within the cap.  All outputs are integers or filter
strings: the tolerance is exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emqx_tpu import topic as T
from emqx_tpu.ops import tiered as ref_tiered
from emqx_tpu.ops.dense_match import build_dense as ref_build_dense
from emqx_tpu.ops.dense_match import supports_dense as ref_supports

from emqx_tpu_torch.ops import tiered
from emqx_tpu_torch.ops.dense_match import (build_dense, dense_match,
                                            supports_dense)
from emqx_tpu_torch.ops.match_kernel import nfa_match
from emqx_tpu_torch.ops.compiler import encode_topics
from emqx_tpu_torch.ops.tiered import (
    HOT_BUDGET_BYTES, TieredMatcher, bench_tiered, build_tiered,
    fused_tiered_match, pick_hot_roots, route, split_filters)

FILTERS = [
    "hot1/+", "hot1/a/#", "hot1/x/y", "hot1/+/z",
    "hot2/devices/+/temp", "hot2/#",
    "cold1/a", "cold1/+/b", "cold2/#", "cold3/deep/+/x",
    "+/status", "#",                       # root wildcards: both tiers
    "$SYS/broker/uptime",
]
TOPICS = [
    "hot1/a", "hot1/a/b/c", "hot1/x/y", "hot1/q/z",
    "hot2/devices/d9/temp", "hot2/anything",
    "cold1/a", "cold1/x/b", "cold2/what/ever", "cold3/deep/k/x",
    "misc/status", "unrelated/topic",
    "$SYS/broker/uptime",
]
FIELDS = ("matches", "n_matches", "active_overflow", "match_overflow")


def oracle(topics, filters):
    return [sorted(f for f in set(filters) if T.match(t, f))
            for t in topics]


def _tables_equal(ref, port):
    """Two compiled tables (or both None): every array and list equal."""
    assert (ref is None) == (port is None)
    if ref is None:
        return
    for name in ("node_tab", "edge_tab", "seeds"):
        assert np.array_equal(getattr(ref, name), getattr(port, name)), name
    assert ref.n_states == port.n_states
    assert ref.vocab == port.vocab
    assert ref.accept_filters == port.accept_filters


def _build_both(filters, roots, **kw):
    ref = ref_tiered.build_tiered(filters, roots, depth=8, **{
        k: {supports_dense: ref_supports}.get(v, v) for k, v in kw.items()})
    port = build_tiered(filters, roots, depth=8, **kw)
    assert ref.hot_roots == port.hot_roots
    _tables_equal(ref.hot, port.hot)
    _tables_equal(ref.cold, port.cold)
    assert ref.stats() == port.stats()
    return ref, port


def _randomized(seed=9):
    rng = np.random.default_rng(seed)
    roots = [f"r{i}" for i in range(12)]
    filters = sorted({
        rng.choice(roots + ["+"]) + "/"
        + "/".join(("+" if rng.random() < 0.3 else f"w{rng.integers(6)}")
                   for _ in range(rng.integers(1, 4)))
        + ("/#" if rng.random() < 0.25 else "")
        for _ in range(160)
    })
    counts = {r: (1000 if i < 4 else 0) for i, r in enumerate(roots)}
    topics = [
        f"{rng.choice(roots)}/" + "/".join(
            f"w{rng.integers(6)}" for _ in range(rng.integers(1, 5)))
        for _ in range(64)
    ]
    return filters, counts, topics


def test_split_filters_replicates_root_wildcards():
    hot, cold = split_filters(FILTERS, {"hot1", "hot2"})
    assert (hot, cold) == ref_tiered.split_filters(FILTERS, {"hot1", "hot2"})
    assert "+/status" in hot and "+/status" in cold
    assert "#" in hot and "#" in cold
    assert "hot1/+" in hot and "hot1/+" not in cold
    assert "cold1/a" in cold and "cold1/a" not in hot


def test_route_by_root():
    roots = frozenset({"hot1", "hot2"})
    hot_idx, cold_idx = route(TOPICS, roots)
    assert (hot_idx, cold_idx) == ref_tiered.route(TOPICS, roots)
    assert sorted(hot_idx + cold_idx) == list(range(len(TOPICS)))
    assert all(TOPICS[i].split("/")[0] in ("hot1", "hot2")
               for i in hot_idx)


def test_pick_hot_roots_traffic_driven():
    counts = {"hot1": 100_000, "hot2": 50_000, "cold1": 3}
    picked = pick_hot_roots(FILTERS, counts)
    assert picked == ref_tiered.pick_hot_roots(FILTERS, counts)
    assert picked[:2] == ["hot1", "hot2"]
    # zero-traffic roots are not admitted
    assert "cold2" not in picked and "cold3" not in picked


@pytest.mark.parametrize("kw", [dict(vmem_budget_bytes=16 * 10),
                                dict(state_budget=512),
                                dict(state_budget=20),
                                dict(vmem_budget_bytes=HOT_BUDGET_BYTES)])
def test_pick_hot_roots_respects_budget(kw):
    counts = {"hot1": 100, "hot2": 50}
    picked = pick_hot_roots(FILTERS, counts, **kw)
    assert picked == ref_tiered.pick_hot_roots(FILTERS, counts, **kw)
    if kw.get("vmem_budget_bytes") == 160:
        assert len(picked) <= 1   # tiny budget: at most one root fits
    filters, counts, _ = _randomized()
    assert pick_hot_roots(filters, counts, depth=8, **kw) == \
        ref_tiered.pick_hot_roots(filters, counts, depth=8, **kw)


def test_hot_budget_is_the_references():
    from emqx_tpu.ops.pallas_match import VMEM_BUDGET_BYTES, supports_table

    assert HOT_BUDGET_BYTES == VMEM_BUDGET_BYTES
    _ref, port = _build_both(FILTERS, {"hot1", "hot2"})
    for tab in (port.hot, port.cold):
        assert tiered.supports_hot_table(tab.node_tab, tab.edge_tab) == \
            supports_table(tab.node_tab, tab.edge_tab)


def _ref_matcher(table, **kw):
    return ref_tiered.TieredMatcher(table, depth=8, **kw)


def test_tiered_matches_oracle_interpret():
    """The reference in interpret mode (its Pallas hot engine) against
    the port's ``pallas`` engine (the hash walk, raw slots): equal lists;
    the port's ``auto`` with ``interpret=True`` runs the dense walk."""
    ref, port = _build_both(FILTERS, {"hot1", "hot2"})
    assert port.hot is not None
    rm = _ref_matcher(ref, interpret=True)
    want = rm.match(TOPICS)
    pm = TieredMatcher(port, depth=8, hot_engine="pallas", device="cpu")
    assert pm.match(TOPICS) == want
    assert pm.info() == rm.info()
    am = TieredMatcher(port, depth=8, interpret=True, device="cpu")
    got = am.match(TOPICS)
    assert am.hot_engine == "dense" and rm.hot_engine == "pallas"
    for t, g, w in zip(TOPICS, got, oracle(TOPICS, FILTERS)):
        assert sorted(g) == w, (t, sorted(g), w)
    # routing actually split the work
    assert am.hot_topics > 0 and am.cold_topics > 0
    info = am.info()
    assert {k: v for k, v in info.items() if k != "hot_engine"} == {
        k: v for k, v in rm.info().items() if k != "hot_engine"}


def test_tiered_randomized_parity():
    filters, counts, topics = _randomized()
    hot_roots = pick_hot_roots(filters, counts, depth=8)
    assert hot_roots, "expected some hot roots"
    ref, port = _build_both(filters, hot_roots)
    want = _ref_matcher(ref, interpret=True).match(topics)
    for engine in ("pallas", "xla"):
        tm = TieredMatcher(port, depth=8, hot_engine=engine, device="cpu")
        assert tm.match(topics) == want
    got = TieredMatcher(port, depth=8, device="cpu").match(topics)
    for t, g, w in zip(topics, got, oracle(topics, filters)):
        assert sorted(g) == w, (t, sorted(g), w)


def test_no_hot_roots_degenerates_to_cold_only():
    ref, port = _build_both(FILTERS, ())
    assert port.hot is None
    rm = _ref_matcher(ref)
    tm = TieredMatcher(port, depth=8, device="cpu")
    got = tm.match(TOPICS)
    assert got == rm.match(TOPICS)
    for g, w in zip(got, oracle(TOPICS, FILTERS)):
        assert sorted(g) == w
    assert tm.hot_topics == 0 and tm.info() == rm.info()


def test_build_demotes_until_budget_fits(monkeypatch):
    """If the compiled hot tier exceeds the budget, roots demote until
    it fits; the same fit on both sides gives the same tables."""
    import emqx_tpu.ops.pallas_match as pm

    def tight(calls):
        def fit(node_tab, edge_tab):
            calls.append(node_tab.shape[0])
            # reject anything holding both hot roots' filters
            return (node_tab.nbytes + edge_tab.nbytes) < 10_000 \
                and len(calls) > 1
        return fit

    ref_calls, port_calls = [], []
    monkeypatch.setattr(pm, "supports_table", tight(ref_calls))
    monkeypatch.setattr(tiered, "supports_hot_table", tight(port_calls))
    _ref, port = _build_both(FILTERS, ["hot1", "hot2"])
    assert ref_calls == port_calls
    assert len(port.hot_roots) < 2
    # every filter is still matchable somewhere
    all_placed = set()
    if port.hot is not None:
        all_placed |= {f for f in port.hot.accept_filters if f}
    all_placed |= {f for f in port.cold.accept_filters if f}
    assert set(FILTERS) <= all_placed


def _dense_case():
    rng = np.random.default_rng(9)
    filters = sorted({
        "hot%d/%s" % (rng.integers(3), "/".join(
            ("+" if rng.random() < 0.3 else "w%d" % rng.integers(6))
            for _ in range(rng.integers(1, 4))))
        for _ in range(60)
    } | {"cold%d/+/#" % i for i in range(20)} | {"#"})
    topics = ["hot%d/w1/w2" % rng.integers(3) for _ in range(40)] \
        + ["cold3/anything/x", "hot0/w0"]
    return filters, topics


def test_tiered_dense_hot_engine_parity():
    filters, topics = _dense_case()
    ref, port = _build_both(filters, ["hot0", "hot1", "hot2"],
                            fit=supports_dense)
    rm = _ref_matcher(ref, hot_engine="dense")
    tm = TieredMatcher(port, depth=8, hot_engine="dense", device="cpu")
    got = tm.match(topics)
    assert got == rm.match(topics)
    for t, rows in zip(topics, got):
        assert sorted(rows) == sorted(
            f for f in filters if T.match(t, f)), t
    assert tm.hot_topics and tm.cold_topics
    assert tm.info() == rm.info() and tm.info()["hot_engine"] == "dense"


def test_dense_rows_past_k_fall_open_to_the_host():
    """A hot row with more than 64 matches: the dense walk flags it and
    ``_decode`` serves it from the host matcher, as the reference."""
    filters = [f"hot0/+/f{i}/#" for i in range(70)] + \
        [f"hot0/a/f{i}" for i in range(70)] + ["cold/x"]
    topics = ["hot0/a/f1", "hot0/a/f1/z", "cold/x"]
    ref, port = _build_both(filters, ["hot0"], fit=supports_dense)
    rm = _ref_matcher(ref, hot_engine="dense")
    tm = TieredMatcher(port, depth=8, hot_engine="dense", device="cpu")
    got = tm.match(topics)
    assert got == rm.match(topics)
    assert [len(r) for r in got] == [2, 1, 1]


@pytest.mark.parametrize("engine", ["pallas", "dense"])
def test_engine_failure_raises_instead_of_demoting(monkeypatch, engine):
    """The failure ``test_tiered_demotes_on_engine_failure`` injects: the
    reference demotes its hot engine and serves; the port raises from
    ``match`` and keeps its engine (an intended divergence)."""
    filters = ["hot0/a", "hot0/+", "cold/x"]
    ref, port = _build_both(filters, ["hot0"], fit=supports_dense)

    def boom(*a, **kw):
        raise RuntimeError("Mosaic says no")

    rm = _ref_matcher(ref, hot_engine="pallas")
    monkeypatch.setattr(ref_tiered.TieredMatcher, "_match_hot_pallas", boom)
    got = rm.match(["hot0/a", "cold/x"])
    assert sorted(got[0]) == ["hot0/+", "hot0/a"]
    assert rm.hot_engine == "dense"   # demoted, traffic served

    tm = TieredMatcher(port, depth=8, hot_engine=engine, device="cpu")
    if engine == "dense":
        monkeypatch.setattr(TieredMatcher, "_match_hot_dense", boom)
    else:
        real = TieredMatcher._match_gather

        def gather(self, topics, tab):
            if tab is self.table.hot:
                boom()
            return real(self, topics, tab)

        monkeypatch.setattr(TieredMatcher, "_match_gather", gather)
    with pytest.raises(RuntimeError, match="Mosaic says no"):
        tm.match(["hot0/a", "cold/x"])
    assert tm.hot_engine == engine and tm.hot_batches == 0


def test_fused_tiered_match_equals_the_two_calls_and_the_reference():
    filters, topics = _dense_case()
    ref, port = _build_both(filters, ["hot0", "hot1", "hot2"],
                            fit=supports_dense)
    hot_idx, cold_idx = route(topics, port.hot_roots)
    hot_t = [topics[i] for i in hot_idx]
    cold_t = [topics[i] for i in cold_idx]

    def args(tab, dense_arrays, names, B):
        return [np.ascontiguousarray(a) for a in (
            *encode_topics(tab, names, batch=B), *dense_arrays)]

    hot_np = args(port.hot, build_dense(port.hot).device_arrays(), hot_t, 256)
    cold_np = args(port.cold, port.cold.device_arrays(), cold_t, 256)
    hargs = [torch.from_numpy(a) for a in hot_np]
    cargs = [torch.from_numpy(a) for a in cold_np]
    d, c = fused_tiered_match(hargs, cargs)
    d2 = dense_match(*hargs, max_matches=64)
    c2 = nfa_match(*cargs, active_slots=8, compact_output=False)
    rd, rc = ref_tiered.fused_tiered_match(
        [jnp.asarray(a) for a in args(
            ref.hot, ref_build_dense(ref.hot).device_arrays(), hot_t, 256)],
        [jnp.asarray(a) for a in cold_np])
    for f in FIELDS:
        for got, apart, want in ((d, d2, rd), (c, c2, rc)):
            assert torch.equal(getattr(got, f), getattr(apart, f)), f
            assert np.array_equal(getattr(got, f).numpy(),
                                  np.asarray(getattr(want, f))), f
    assert int(d.n_matches.sum()) > 0 and int((c.matches >= 0).sum()) > 0


def test_bench_tiered_runs_on_the_cpu():
    out = bench_tiered(n_filters=3000, batch=512, iters=1, device="cpu")
    assert out["device"] == "cpu" and out["hot_engine"] == "dense"
    assert out["hot_roots"] >= 1 and out["dense_S"] <= 4096
    assert out["routing"]["hot_topics"] + out["routing"]["cold_topics"] \
        == 512
    assert out["parity_mismatches_128"] == 0
