"""Parity of the port's dense walk (``emqx_tpu_torch.ops.dense_match``,
K6) with the JAX reference (``emqx_tpu.ops.dense_match``), on the CPU.

Each case of ``tests/test_dense_match.py`` is played on both packages
with the same seeded inputs, handed to both as numpy arrays: the
``build_dense`` arrays equal, every ``MatchResult`` field bit for bit
(``matches`` in the compact column order, ``n_matches``,
``active_overflow``, ``match_overflow``), and the reference test's own
predicates (the host oracle, ``$``-root suppression, the overflow flag,
exactness where the hash walk spills, the cap).  Random 0/1 tables with
several parents a column, S = 128 to 1024, hold the port's bf16
arithmetic to the reference's.  All outputs are integers: the tolerance
is exact equality.  The kernel itself is held to the plain version in
``tests/test_torch_kernel_emu.py`` (g++) and ``tests/test_torch_cuda.py``
(the card)."""

import importlib
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emqx_tpu import topic as T
from emqx_tpu.ops.compiler import compile_filters as ref_compile
from emqx_tpu.ops.compiler import encode_topics as ref_encode
from emqx_tpu.ops.dense_match import DENSE_STATE_CAP as REF_CAP
from emqx_tpu.ops.dense_match import build_dense as ref_build_dense
from emqx_tpu.ops.dense_match import dense_match as ref_dense_match
from emqx_tpu.ops.dense_match import supports_dense as ref_supports

from emqx_tpu_torch.ops import compile_filters, encode_topics, nfa_match
# the module (``emqx_tpu_torch.ops.dense_match`` is the function)
dense_mod = importlib.import_module("emqx_tpu_torch.ops.dense_match")
from emqx_tpu_torch.ops.dense_match import (
    DENSE_STATE_CAP, bench_dense, build_dense, dense_match, dense_match_plain,
    random_dense, random_dense_batch, supports_dense)

FIELDS = ("matches", "n_matches", "active_overflow", "match_overflow")


def _ref(batch, dense, K):
    res = ref_dense_match(*[jnp.asarray(a) for a in batch],
                          *[jnp.asarray(a) for a in dense], max_matches=K)
    return {f: np.asarray(getattr(res, f)) for f in FIELDS}


def _port(batch, dense, K):
    res = dense_match(*[torch.from_numpy(np.ascontiguousarray(a))
                        for a in batch],
                      *[torch.from_numpy(np.ascontiguousarray(a))
                        for a in dense], max_matches=K)
    return {f: getattr(res, f).numpy() for f in FIELDS}


def _both(filters, topics, K, depth=8):
    """Compile, build and walk ``topics`` on each side; the tables and
    every field must be equal.  Returns (port table, port result)."""
    rt = ref_compile(filters, depth=depth)
    pt = compile_filters(filters, depth=depth)
    rd, pd = ref_build_dense(rt), build_dense(pt)
    for a, b in zip(rd, pd):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert rd.S == pd.S
    rb = ref_encode(rt, topics, batch=len(topics))
    pb = encode_topics(pt, topics, batch=len(topics))
    for a, b in zip(rb, pb):
        assert np.array_equal(a, b)
    want = _ref(rb, rd.device_arrays(), K)
    got = _port(pb, pd.device_arrays(), K)
    for f in FIELDS:
        assert np.array_equal(got[f], want[f]), f
    return pt, got


def _decode(tab, res, i):
    row = res["matches"][i]
    return sorted(tab.accept_filters[a] for a in row[row >= 0])


def test_dense_matches_oracle_randomized():
    rng = np.random.default_rng(7)
    filters = sorted({
        "r%d/" % rng.integers(8)
        + "/".join(("+" if rng.random() < 0.35 else "w%d" % rng.integers(10))
                   for _ in range(rng.integers(1, 6)))
        + ("/#" if rng.random() < 0.25 else "")
        for _ in range(400)
    } | {"#", "+/x", "$SYS/broker/+", "a/b/c"})
    topics = ["r%d/" % rng.integers(8)
              + "/".join("w%d" % rng.integers(10)
                         for _ in range(rng.integers(1, 8)))
              for _ in range(300)]
    topics += ["$SYS/broker/uptime", "a/b/c", "r1", "none/of/these/words"]
    tab, res = _both(filters, topics, 128)
    assert not res["active_overflow"].any(), "dense cannot spill"
    for i, t in enumerate(topics):
        if res["match_overflow"][i]:
            continue
        assert _decode(tab, res, i) == sorted(
            f for f in filters if T.match(t, f)), t


def test_dense_exact_where_gather_spills():
    # every literal/+ combination over 4 levels: a/b/c/d holds 16 trie
    # nodes active at step 4, past the hash walk's A=4; the dense walk
    # has no cap and stays exact
    filters = ["/".join(seg) + "/#" for seg in itertools.product(
        *([w, "+"] for w in "abcd"))]
    topics = ["a/b/c/d/tail", "x/y/l7/z"]
    tab, res = _both(filters, topics, 64)
    words, lens, is_sys = encode_topics(tab, topics, batch=2)
    g = nfa_match(*[torch.from_numpy(a) for a in (
        words, lens, is_sys, *tab.device_arrays())],
        active_slots=4, compact_output=True, max_matches=64)
    assert int(g.active_overflow.sum()) > 0, \
        "workload should overflow the hash walk's active set"
    assert not res["active_overflow"].any()
    assert _decode(tab, res, 0) == sorted(
        f for f in filters if T.match("a/b/c/d/tail", f))


def test_dense_sys_topic_root_suppression():
    tab, res = _both(["#", "+/status", "$SYS/+", "$SYS/#"],
                     ["$SYS/status", "node/status"], 64)
    # $-topics must not match root-level `#`/`+` but do match $SYS/...
    assert _decode(tab, res, 0) == ["$SYS/#", "$SYS/+"]
    assert _decode(tab, res, 1) == ["#", "+/status"]


def test_dense_match_overflow_flagged():
    filters = [f"a/+/f{i}" for i in range(40)] + ["a/b/#"]
    _tab, res = _both(filters, ["a/b/f1"], 1)
    assert res["match_overflow"][0] == 1
    assert res["n_matches"][0] == 2  # a/+/f1, a/b/#


def test_supports_dense_cap():
    for compile_, supports in ((ref_compile, ref_supports),
                               (compile_filters, supports_dense)):
        tab = compile_(["a/b"], depth=8)
        assert supports(tab)
        assert not supports(tab, state_cap=1)
    assert DENSE_STATE_CAP == REF_CAP == 512


def test_build_dense_structure():
    filters = ["a/b", "a/+", "c/#"]
    tab, _res = _both(filters, ["a/b"], 4)
    d = build_dense(tab)
    # every literal edge: exactly one nonzero per column; labels set
    cols = d.lmat.sum(axis=0)
    assert set(np.unique(cols)) <= {0.0, 1.0}
    lit_children = np.nonzero(cols)[0]
    assert all(d.label[c] >= 0 for c in lit_children)
    # plus edges come from node_tab column 0
    n = tab.n_states
    src = np.nonzero(tab.node_tab[:n, 0] >= 0)[0]
    assert d.pmat.sum() == len(src)


@pytest.mark.parametrize("S,parents,K", [(128, 1, 32), (128, 6, 8),
                                         (256, 3, 64), (512, 2, 16),
                                         (1024, 4, 32)])
def test_random_multi_parent_tables_equal_the_reference(S, parents, K):
    """Several parents a column in both matrices: the reference's bf16
    sums and ``> 0.5`` against the port's, field for field."""
    dense = random_dense(S * 10 + parents, S, parents)
    batch = random_dense_batch(S + K, 64, 6)
    want = _ref(batch, dense, K)
    got = _port(batch, dense, K)
    for f in FIELDS:
        assert np.array_equal(got[f], want[f]), f
    assert want["n_matches"].sum() > 0
    if parents > 1:
        assert (dense[0].sum(axis=0) > 1).any()


def test_cpu_operands_run_the_plain_version_and_other_devices_raise():
    dense = [torch.from_numpy(a) for a in random_dense(3, 128, 2)]
    batch = [torch.from_numpy(a) for a in random_dense_batch(4, 16, 5)]
    before = dense_mod.launches
    got = dense_match(*batch, *dense, max_matches=8)
    want = dense_match_plain(*batch, *dense, max_matches=8)
    assert dense_mod.launches == before
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f))
    with pytest.raises(ValueError):
        dense_match(*[t.to("meta") for t in batch],
                    *[t.to("meta") for t in dense])


def test_plain_traffic_counts_the_steps_the_kernel_runs():
    """``traffic["steps"]``: rows whose walk computes a next frontier at
    step t (t < min(D, len), a state active); ``states``: the active
    states those steps expand; ``children``: the states they make
    active."""
    tab = compile_filters(["a/b/c", "a/+/#"], depth=8)
    d = [torch.from_numpy(a) for a in build_dense(tab).device_arrays()]
    b = [torch.from_numpy(a) for a in encode_topics(
        tab, ["a/b/c", "zz/b/c", "a"], batch=3)]
    traffic = {}
    dense_match_plain(*b, *d, max_matches=4, traffic=traffic)
    # a/b/c: 3 steps expanding {root}, {a}, {a/b, a/+} into {a},
    # {a/b, a/+}, {a/b/c}; zz/b/c: the root steps once into nothing; a:
    # 1 step, {root} into {a}
    assert traffic == {"steps": 5, "states": 6, "children": 5}


def test_bench_dense_runs_on_the_cpu():
    out = bench_dense(batch=256, iters=1, device="cpu")
    assert out["device"] == "cpu" and out["n_filters"] > 300
    assert out["dense_S"] == 2048 and out["parity_mismatches"] == 0
