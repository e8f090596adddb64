"""The port's multi-device fan-out library (``emqx_tpu_torch/parallel/``:
K8b-K8f) held to the reference's (``emqx_tpu/parallel/``) on the CPU.

The reference runs each ``shard_map`` step on the eight virtual CPU
devices of ``tests/conftest.py``; the port runs its step on a mesh of
``[torch.device("cpu")] * n``, where each bitmap function runs its plain
version (the kernels of ``ops/csrc/bitmap_fanout.cu`` are held to those
in ``tests/test_torch_kernel_emu.py`` and on the card).  The same numpy
inputs, made from a seed, go through both; every field is compared
exactly (tolerance 0), bitmaps as uint32.  Each case of
``tests/test_sharded_match.py`` has its counterpart here, at (dp, tp) in
{(1, 4), (2, 4), (1, 8)}, ring in {2, 4, 8}, ep in {2, 4} and u in {2,
4, 8}, with ``cap_row`` truncation, EP bucket overflow, an empty group,
rows that match nothing and ``$`` topics; then each plain version
against the reference function alone, the converters, the named-axis
mesh and the collectives against numpy.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emqx_tpu import parallel as ref
from emqx_tpu import topic as RT
from emqx_tpu.broker import FilterTrie as RefTrie
from emqx_tpu.ops import compile_filters as ref_compile
from emqx_tpu.ops import encode_topics as ref_encode
from emqx_tpu.ops import nfa_match as ref_nfa_match
from emqx_tpu.ops.encode import TopicEncoder as RefEncoder
from emqx_tpu.parallel import shared_group as ref_shared_group
from emqx_tpu.parallel import sharded_match as ref_sharded_match
from emqx_tpu_torch import parallel as P
from emqx_tpu_torch.convert import (accept_bitmap_from_reference,
                                    ep_tables_from_reference,
                                    group_masks_from_reference)
from emqx_tpu_torch.ops import bitmap_kernel as bk
from emqx_tpu_torch.ops import compile_filters
from emqx_tpu_torch.ops.encode import TopicEncoder
from emqx_tpu_torch.parallel import prefix_ep as port_prefix_ep
from emqx_tpu_torch.parallel import shared_group as port_shared_group

CPU = torch.device("cpu")

FILTERS = ["a/+", "a/#", "+/b", "#", "x/y/z", "x/+/z", "$SYS/#"]
N_SUBS = 100


def cpus(n):
    return [CPU] * n


def subscribers_of(flt):
    i = FILTERS.index(flt)
    return [(i * 13 + k * 7) % N_SUBS for k in range(i + 1)]


def crc_subs(n_subs):
    """A deterministic subscriber set of each filter (1-5 ids)."""
    def subs(f):
        h = zlib.crc32(f.encode())
        return [(h + k * 13) % n_subs for k in range(1 + h % 5)]
    return subs


def u32(t) -> np.ndarray:
    """int32 bit patterns (a tensor or an array) as uint32."""
    return np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t) \
        .view(np.uint32)


def equal_fields(port, want):
    """Every field of a port result equal to the reference's (int32 bit
    patterns against uint32)."""
    assert len(port) == len(want)
    for name, p, w in zip(getattr(want, "_fields", range(len(want))),
                          port, want):
        w = np.asarray(w)
        p = p.numpy()
        if w.dtype == np.uint32:
            p = p.view(np.uint32)
        np.testing.assert_array_equal(p, w, err_msg=str(name))


def _setup(batch=64):
    table = ref_compile(FILTERS, depth=8, state_bucket=8)
    rng = np.random.default_rng(7)
    names = ["/".join(rng.choice(["a", "b", "x", "y", "z"],
                                 size=rng.integers(1, 4)))
             for _ in range(batch)]
    names[:3] = ["$SYS/x", "$SYS/a/b", "nomatch"]
    enc = ref_encode(table, names)
    return table, names, enc


def _random_table(seed=4, n_filters=300, n_topics=64):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(20)]
    filters = sorted({
        "/".join(("+" if rng.random() < 0.25 else words[rng.integers(20)])
                 for _ in range(rng.integers(1, 5)))
        + ("/#" if rng.random() < 0.3 else "")
        for _ in range(n_filters)} | {"$SYS/+/w1"})
    table = ref_compile(filters, depth=8)
    topics = ["/".join(words[rng.integers(20)]
                       for _ in range(rng.integers(1, 6)))
              for _ in range(n_topics)]
    topics[:2] = ["$SYS/w0/w1", "zz/none"]
    return table, filters, topics


def ref_args(table, enc):
    return (*[jnp.asarray(a) for a in enc],
            *[jnp.asarray(a) for a in table.device_arrays()])


def port_args(table, enc):
    return (*[torch.from_numpy(np.ascontiguousarray(a)) for a in enc],
            *[torch.from_numpy(np.asarray(a)) for a in table.device_arrays()])


def dense_ref(table, enc, bitmap):
    """The single-device walk and the host OR of its rows."""
    res = ref_nfa_match(*ref_args(table, enc))
    m = np.asarray(res.matches)
    out = np.zeros((m.shape[0], bitmap.shape[1]), np.uint32)
    for r in range(m.shape[0]):
        for a in m[r][m[r] >= 0]:
            out[r] |= bitmap[a]
    return res, out


def ref_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return ref.make_mesh(shape, devices=jax.devices()[:n])


def port_mesh(shape):
    return P.make_mesh(shape, cpus(int(np.prod(list(shape.values())))))


MESHES = [(1, 4), (2, 4), (1, 8)]


# -- configs 2/3: the dp x tp bitmap fan-out ----------------------------------

def test_pick_shape():
    for n in (1, 2, 4, 6, 8):
        assert P.pick_shape(n) == ref.pick_shape(n)
    with pytest.raises(ValueError):
        P.pick_shape(6, tp=4)


@pytest.mark.parametrize("dp,tp", MESHES)
def test_sharded_matches_unsharded(dp, tp):
    """Every ``FanoutResult`` field equals the reference step's and the
    single-device walk's OR (``$`` topics and a row with no match in
    the batch)."""
    table, _names, enc = _setup(64)
    bitmap = ref.make_accept_bitmap(table, subscribers_of, N_SUBS, tp=tp)
    want = ref.build_sharded_matcher(ref_mesh({"dp": dp, "tp": tp}))(
        *ref_args(table, enc), jnp.asarray(bitmap))
    got = P.build_sharded_matcher(port_mesh({"dp": dp, "tp": tp}))(
        *port_args(table, enc), accept_bitmap_from_reference(bitmap, CPU))
    equal_fields(got, want)
    single, ref_bm = dense_ref(table, enc, bitmap)
    np.testing.assert_array_equal(u32(got.bitmap), ref_bm)
    popc = [bin(int.from_bytes(row.tobytes(), "little")).count("1")
            for row in ref_bm]
    np.testing.assert_array_equal(got.n_subscribers.numpy(), popc)
    np.testing.assert_array_equal(got.n_matches.numpy(),
                                  np.asarray(single.n_matches))


def test_sharded_trie_parity():
    table, names, enc = _setup(32)
    tr = RefTrie()
    for f in FILTERS:
        tr.insert(f)
    bitmap = ref.make_accept_bitmap(table, subscribers_of, N_SUBS, tp=2)
    res = P.build_sharded_matcher(port_mesh({"dp": 4, "tp": 2}))(
        *port_args(table, enc), bitmap)       # numpy uint32 in
    n = res.n_matches.numpy()
    for r, name in enumerate(names):
        assert n[r] == len(tr.match(name)), name


def test_accept_bitmap_padding():
    """The port's ``make_accept_bitmap`` over the port's table equals the
    reference's over the reference's."""
    table = compile_filters(["a"], depth=4, state_bucket=8)
    bm = P.make_accept_bitmap(table, lambda f: [0, 31, 32, 99], 100, tp=4)
    assert bm.shape[1] % 4 == 0
    assert bm[0, 0] == (1 | (1 << 31)) and bm[0, 1] == 1
    assert bm[-1].sum() == 0
    rt = ref_compile(["a"], depth=4, state_bucket=8)
    np.testing.assert_array_equal(
        bm, ref.make_accept_bitmap(rt, lambda f: [0, 31, 32, 99], 100, tp=4))
    ft, filters, _t = _random_table(5, 200, 1)
    pt = compile_filters(filters, depth=8)
    np.testing.assert_array_equal(
        P.make_accept_bitmap(pt, crc_subs(777), 777, tp=3),
        ref.make_accept_bitmap(ft, crc_subs(777), 777, tp=3))
    with pytest.raises(ValueError):
        P.make_accept_bitmap(pt, lambda f: [777], 777)


# -- config 4: $share selection ------------------------------------------------

@pytest.mark.parametrize("dp,tp,negative", [(2, 4, False), (1, 4, True),
                                            (1, 8, False)])
def test_shared_group_selection_parity(dp, tp, negative):
    """Picks equal to the reference step's and ``host_pick``'s, an empty
    group all -1, an empty row all -1; with ``negative``, hashes of both
    signs (the reference's remainder takes the divisor's sign)."""
    rng = np.random.default_rng(9 + tp)
    n_subs, W, B, G = 4096, 128, 64, 8
    bitmap = rng.integers(0, 2**32, (B, W), dtype=np.uint32)
    bitmap[5] = 0
    groups = [rng.choice(n_subs, size=rng.integers(1, 200), replace=False)
              for _ in range(G - 1)] + [[]]
    masks = ref.make_group_masks(groups, n_subs, W)
    np.testing.assert_array_equal(
        P.make_group_masks(groups, n_subs, W), masks)
    lo = -2**31 if negative else 0
    sel_hash = rng.integers(lo, 2**31 - 1, B).astype(np.int32)
    want = np.asarray(ref.build_shared_selector(ref_mesh(
        {"dp": dp, "tp": tp}))(jnp.asarray(bitmap), jnp.asarray(masks),
                               jnp.asarray(sel_hash)))
    got = P.build_shared_selector(port_mesh({"dp": dp, "tp": tp}))(
        accept_bitmap_from_reference(bitmap, CPU),
        group_masks_from_reference(masks, CPU), torch.from_numpy(sel_hash))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (B, G)
    assert (want[:, G - 1] == -1).all() and (want[5] == -1).all()
    for b in range(0, B, 7):
        for g in range(G):
            assert got[b, g] == P.host_pick(bitmap[b], masks[g],
                                            int(sel_hash[b])) == \
                ref.host_pick(bitmap[b], masks[g], int(sel_hash[b]))


# -- config 5: the ring ----------------------------------------------------------

RINGS = [(4, 2), (2, 4), (1, 8)]


@pytest.fixture(scope="module")
def ring_case():
    table, filters, topics = _random_table()
    n_subs = 2048
    bitmap = ref.make_accept_bitmap(table, crc_subs(n_subs), n_subs)
    enc = ref_encode(table, topics, batch=64)
    return table, bitmap, enc


def _layout(monkeypatch, layout):
    """``several_devices`` forces the several-device code on the CPU
    mesh (per-position kernels and collectives); ``one_device`` is the
    CPU mesh as it is, one device (a raw walk and one kernel)."""
    from emqx_tpu_torch.parallel import steps

    if layout == "several_devices":
        monkeypatch.setattr(steps, "one_device", lambda devices: False)


LAYOUTS = ["one_device", "several_devices"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dp,ring", RINGS)
def test_ring_fanout_parity(monkeypatch, ring_case, dp, ring, layout):
    _layout(monkeypatch, layout)
    table, bitmap, enc = ring_case
    rows = ref.shard_bitmap_rows(bitmap, ring)
    np.testing.assert_array_equal(P.shard_bitmap_rows(bitmap, ring), rows)
    assert rows.shape[0] % ring == 0
    want = np.asarray(ref.build_ring_fanout(ref_mesh(
        {"dp": dp, "ring": ring}))(*ref_args(table, enc), jnp.asarray(rows)))
    got = P.build_ring_fanout(port_mesh({"dp": dp, "ring": ring}))(
        *port_args(table, enc), accept_bitmap_from_reference(rows, CPU))
    np.testing.assert_array_equal(u32(got), want)
    np.testing.assert_array_equal(want, dense_ref(table, enc, bitmap)[1])


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dp,ring", RINGS)
@pytest.mark.parametrize("cap", [128, 1])
def test_ring_fanout_compact_parity_and_truncation(monkeypatch, ring_case, dp,
                                                   ring, cap, layout):
    """An ample cap reduces to the bitmap ring's result; a starving one
    flags truncation and, like the reference, returns the ring's first
    position's (partial) bitmap, a subset of the full one."""
    _layout(monkeypatch, layout)
    table, bitmap, enc = ring_case
    rows = ref.shard_bitmap_rows(bitmap, ring)
    shape = {"dp": dp, "ring": ring}
    want = ref.build_ring_fanout_compact(ref_mesh(shape), cap_row=cap)(
        *ref_args(table, enc), jnp.asarray(rows))
    got = P.build_ring_fanout_compact(port_mesh(shape), cap_row=cap)(
        *port_args(table, enc), torch.from_numpy(rows.view(np.int32)))
    equal_fields(got, want)
    full = dense_ref(table, enc, bitmap)[1]
    if cap == 128:
        np.testing.assert_array_equal(u32(got[0]), full)
        assert int(got[1].sum()) == 0
    else:
        assert int(got[1].sum()) > 0
        assert ((u32(got[0]) & ~full) == 0).all()


# -- shard-local compaction ------------------------------------------------------

def test_compact_bitmap_ids_unit():
    rng = np.random.default_rng(21)
    bm = rng.integers(0, 2**32, (16, 4), dtype=np.uint32)
    bm[3] = 0
    fn = jax.jit(ref.compact_bitmap_ids, static_argnums=(1,))
    t = torch.from_numpy(bm.view(np.int32))
    want = fn(jnp.asarray(bm), 128)
    got = P.compact_bitmap_ids(t, 128)
    equal_fields(got, want)
    ids, n, _over = (x.numpy() for x in got)
    for r in range(16):
        exp = [w * 32 + b for w in range(4) for b in range(32)
               if bm[r, w] >> b & 1]
        assert n[r] == len(exp) and ids[r, :n[r]].tolist() == exp
        assert (ids[r, n[r]:] == -1).all()
    cap = int(n.max()) - 1            # truncation: the densest row flags
    equal_fields(P.compact_bitmap_ids(t, cap), fn(jnp.asarray(bm), cap))
    assert int(P.compact_bitmap_ids(t, cap)[2][n.argmax()]) == 1
    base_fn = jax.jit(ref.compact_bitmap_ids, static_argnums=(1,))
    equal_fields(P.compact_bitmap_ids(t, 40, id_base=4 * 32 * 3),
                 base_fn(jnp.asarray(bm), 40, 4 * 32 * 3))


@pytest.mark.parametrize("dp,tp", MESHES)
@pytest.mark.parametrize("cap", [32, 2])
def test_compact_sharded_matcher_matches_bitmap_path(dp, tp, cap):
    """Every ``CompactFanoutResult`` field equals the reference's; with
    an ample cap the decoded rows are the bitmap path's subscribers, with
    a starving one the truncated segments are flagged."""
    table, _names, enc = _setup(64)
    bitmap = ref.make_accept_bitmap(table, subscribers_of, N_SUBS, tp=tp)
    shape = {"dp": dp, "tp": tp}
    want = ref.build_sharded_matcher_compact(ref_mesh(shape), cap_row=cap)(
        *ref_args(table, enc), jnp.asarray(bitmap))
    got = P.build_sharded_matcher_compact(port_mesh(shape), cap_row=cap)(
        *port_args(table, enc), accept_bitmap_from_reference(bitmap, CPU))
    equal_fields(got, want)
    rows = P.decode_compact_rows(got.ids.numpy(), got.counts.numpy(), cap)
    _single, ref_bm = dense_ref(table, enc, bitmap)
    over = got.overflow.numpy().any(axis=1)
    assert over.any() == (cap == 2)
    for r in range(64):
        exp = {w * 32 + b for w in range(ref_bm.shape[1]) for b in range(32)
               if ref_bm[r, w] >> b & 1}
        if not over[r]:
            assert sorted(rows[r].tolist()) == sorted(exp), r
        else:
            assert set(rows[r].tolist()) < exp
        assert len(rows[r]) == len(set(rows[r].tolist()))


# -- EP: prefix-partitioned tables + all-to-all routing -------------------------

def _ep_case(seed=17):
    rng = np.random.default_rng(seed)
    words = [f"r{i}" for i in range(24)]
    filters = sorted({
        "/".join((words[rng.integers(24)] if lvl > 0 or rng.random() > 0.15
                  else "+") for lvl in range(rng.integers(1, 5)))
        + ("/#" if rng.random() < 0.3 else "")
        for _ in range(400)} | {"+/status", "#", "$SYS/r1"})
    topics = ["/".join(words[rng.integers(24)]
                       for _ in range(rng.integers(1, 6)))
              for _ in range(64)]
    topics[:3] = ["$SYS/r1", "nowhere/x", "r2/status"]
    return filters, topics


@pytest.mark.parametrize("E", [2, 4])
def test_prefix_ep_all_to_all_parity(E):
    """``build_partitions`` byte for byte; every ``EpResult`` field
    equals the reference step's; each row's filters are the oracle's."""
    filters, topics = _ep_case()
    rtabs = ref.build_partitions(filters, E, depth=8)
    tabs = P.build_partitions(filters, E, depth=8)
    conv = ep_tables_from_reference(rtabs)
    for port_tabs in (tabs, conv):
        for f in ("node_tabs", "edge_tabs", "seeds"):
            np.testing.assert_array_equal(getattr(port_tabs, f),
                                          getattr(rtabs, f))
        assert port_tabs.vocab == rtabs.vocab
        assert port_tabs.accept_filters == rtabs.accept_filters
        assert port_tabs.depth == rtabs.depth and port_tabs.n_parts == E
    B = 64
    w, l, s = RefEncoder(rtabs.vocab).encode(topics, 8, batch=B)
    pw, pl, ps = TopicEncoder(tabs.vocab).encode(topics, 8, batch=B)
    np.testing.assert_array_equal(pw, w)
    want = ref.build_ep_matcher(ref_mesh({"ep": E}), capacity=B)(
        jnp.asarray(w), jnp.asarray(l), jnp.asarray(s),
        jnp.asarray(rtabs.node_tabs), jnp.asarray(rtabs.edge_tabs),
        jnp.asarray(rtabs.seeds))
    got = P.build_ep_matcher(port_mesh({"ep": E}), capacity=B)(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (pw, pl, ps)),
        *(torch.from_numpy(a) for a in (tabs.node_tabs, tabs.edge_tabs,
                                         tabs.seeds)))
    equal_fields(got, want)
    assert not got.overflow.any()
    m, n, own = got.matches.numpy(), got.n_matches.numpy(), got.owners.numpy()
    for i, t in enumerate(topics):
        assert own[i] == P.owner_of(t, tabs.vocab, E)
        gotf = {tabs.accept_filters[own[i]][a] for a in m[i][:n[i]]}
        assert gotf == {f for f in filters if RT.match(t, f)}, t


def test_prefix_ep_native_partitions_answer_alike(monkeypatch):
    """From ``NATIVE_FROM`` filters on the partitions are ``NativeNfa``
    tables: other bytes, the same vocab, shapes common to every
    partition, and every row's filters equal to the Python tables' (the
    intended divergence)."""
    filters, topics = _ep_case(18)
    E, B = 4, 64
    assert len(filters) < port_prefix_ep.NATIVE_FROM
    py = P.build_partitions(filters, E, depth=8)
    monkeypatch.setattr(port_prefix_ep, "NATIVE_FROM", len(filters))
    nat = P.build_partitions(filters, E, depth=8)
    assert not np.array_equal(py.edge_tabs, nat.edge_tabs)
    assert {w: nat.vocab[w] for w in py.vocab} == py.vocab
    assert nat.node_tabs.shape[0] == nat.edge_tabs.shape[0] == E
    mesh = port_mesh({"ep": E})
    rows = []
    for tabs in (py, nat):
        enc = TopicEncoder(tabs.vocab).encode(topics, 8, batch=B)
        res = P.build_ep_matcher(mesh, capacity=B)(
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in enc),
            *(torch.from_numpy(a) for a in (tabs.node_tabs, tabs.edge_tabs,
                                             tabs.seeds)))
        m, n, own = (x.numpy() for x in (res.matches, res.n_matches,
                                         res.owners))
        rows.append([sorted(tabs.accept_filters[own[i]][a]
                            for a in m[i][:n[i]]) for i in range(B)])
    assert rows[0] == rows[1]
    assert sum(map(len, rows[0])) > 0


@pytest.mark.parametrize("E", [2, 4])
def test_prefix_ep_overflow_flags_host_rerun(E):
    """Every topic has one owner, so buckets of capacity 2 overflow: the
    overflowed rows are flagged and every field equals the
    reference's."""
    filters = ["hot/a", "hot/+", "cold/b"]
    rtabs = ref.build_partitions(filters, E, depth=4)
    tabs = P.build_partitions(filters, E, depth=4)
    topics = ["hot/a"] * 16
    w, l, s = RefEncoder(rtabs.vocab).encode(topics, 4, batch=16)
    want = ref.build_ep_matcher(ref_mesh({"ep": E}), capacity=2)(
        jnp.asarray(w), jnp.asarray(l), jnp.asarray(s),
        jnp.asarray(rtabs.node_tabs), jnp.asarray(rtabs.edge_tabs),
        jnp.asarray(rtabs.seeds))
    got = P.build_ep_matcher(port_mesh({"ep": E}), capacity=2)(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (w, l, s)),
        *(torch.from_numpy(a) for a in (tabs.node_tabs, tabs.edge_tabs,
                                         tabs.seeds)))
    equal_fields(got, want)
    over = got.overflow.numpy()
    assert over.sum() == 16 - 2 * E
    for i in np.flatnonzero(over == 0):
        own = int(got.owners[i])
        assert {tabs.accept_filters[own][a]
                for a in got.matches[i][:got.n_matches[i]].tolist()} == \
            {"hot/a", "hot/+"}
    with pytest.raises(ValueError, match="partitions"):
        P.build_ep_matcher(port_mesh({"ep": E * 2}), capacity=2)(
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in (w, l, s)),
            *(torch.from_numpy(a) for a in (tabs.node_tabs, tabs.edge_tabs,
                                             tabs.seeds)))


@pytest.mark.parametrize("layout", ["one_device", "several_devices"])
@pytest.mark.parametrize("E,capacity,K", [(2, 64, 32), (4, 6, 32),
                                          (4, 64, 3)])
def test_prefix_ep_edge_cases_match_reference(monkeypatch, E, capacity, K,
                                              layout):
    """K8c's routing grid and merge, every field the reference's: root
    words negative (owner by the floor remainder) and past the vocab,
    rows past the depth and the encoder's pad rows, buckets past
    capacity, rows past K; on one device (the grid written as it lands)
    and in the several-device layout (forced on the CPU mesh: a grid a
    source, ``all_to_all``, the parts summed on the lead)."""
    _layout(monkeypatch, layout)
    filters, topics = _ep_case(23)
    topics += ["r1/r2"] * 20
    rtabs = ref.build_partitions(filters, E, depth=8)
    tabs = P.build_partitions(filters, E, depth=8)
    B = 96
    w, l, s = (np.array(x) for x in RefEncoder(rtabs.vocab).encode(
        topics, 8, batch=B))
    w[3, 0], w[4, 0], w[5, 0] = -7, -(1 << 30), 1 << 20
    l[6] = 9
    want = ref.build_ep_matcher(ref_mesh({"ep": E}), capacity=capacity,
                                max_matches=K)(
        jnp.asarray(w), jnp.asarray(l), jnp.asarray(s),
        jnp.asarray(rtabs.node_tabs), jnp.asarray(rtabs.edge_tabs),
        jnp.asarray(rtabs.seeds))
    got = P.build_ep_matcher(port_mesh({"ep": E}), capacity=capacity,
                             max_matches=K)(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (w, l, s)),
        *(torch.from_numpy(a) for a in (tabs.node_tabs, tabs.edge_tabs,
                                         tabs.seeds)))
    equal_fields(got, want)
    assert int(got.owners[3]) == -7 % E
    if capacity < 10:
        assert int(got.overflow.sum()) > 0
    if K < 10:
        assert int(got.n_matches.max()) > K


# -- Ulysses reshard -------------------------------------------------------------

@pytest.mark.parametrize("U", [2, 4, 8])
def test_ulysses_reshard_roundtrip(U):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2**32, size=(64, 16), dtype=np.uint32)
    mesh = port_mesh({"u": U})
    d = P.build_reshard(mesh)(torch.from_numpy(x.view(np.int32)))
    want = ref.build_reshard(ref_mesh({"u": U}))(jnp.asarray(x))
    np.testing.assert_array_equal(u32(d.full()), np.asarray(want))
    np.testing.assert_array_equal(u32(d.full()), x)
    assert d.dim == 1 and {tuple(p.shape) for p in d.parts} == {
        tuple(s.data.shape) for s in want.addressable_shards} == {
        (64, 16 // U)}
    for i, p in enumerate(d.parts):
        np.testing.assert_array_equal(
            u32(p), x[:, i * 16 // U:(i + 1) * 16 // U])
    back = P.build_unreshard(mesh)(d)
    np.testing.assert_array_equal(u32(back.full()), x)
    assert back.dim == 0 and {tuple(p.shape) for p in back.parts} == {
        (64 // U, 16)}
    # the global array in, column blocks out, the same
    again = P.build_unreshard(mesh)(d.full())
    assert all(torch.equal(a, b) for a, b in zip(again.parts, back.parts))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("U", [2, 4, 8])
def test_ulysses_step_matches_reference(monkeypatch, U, layout):
    """The dispatch bitmap equals the reference's and the dense OR, each
    position holding all rows of a W/U column slice; the per-subscriber
    counts equal the reference's, block by block."""
    _layout(monkeypatch, layout)
    table, _names, enc = _setup(64)
    bitmap = ref.make_accept_bitmap(table, subscribers_of, N_SUBS, tp=8)
    want = ref.build_ulysses_step(ref_mesh({"u": U}))(
        *ref_args(table, enc), jnp.asarray(bitmap))
    got = P.build_ulysses_step(port_mesh({"u": U}))(
        *port_args(table, enc), accept_bitmap_from_reference(bitmap, CPU))
    W = bitmap.shape[1]
    np.testing.assert_array_equal(u32(got.dispatch_bitmap.full()),
                                  np.asarray(want.dispatch_bitmap))
    np.testing.assert_array_equal(u32(got.dispatch_bitmap.full()),
                                  dense_ref(table, enc, bitmap)[1])
    np.testing.assert_array_equal(got.sub_deliveries.full().numpy(),
                                  np.asarray(want.sub_deliveries))
    np.testing.assert_array_equal(got.n_matches.numpy(),
                                  np.asarray(want.n_matches))
    np.testing.assert_array_equal(got.active_overflow.numpy(),
                                  np.asarray(want.active_overflow))
    assert {tuple(p.shape) for p in got.dispatch_bitmap.parts} == {
        tuple(s.data.shape)
        for s in want.dispatch_bitmap.addressable_shards} == {(64, W // U)}
    assert {tuple(p.shape) for p in got.sub_deliveries.parts} == {
        (W * 32 // U,)}
    back = P.build_unreshard(port_mesh({"u": U}))(got.dispatch_bitmap)
    assert torch.equal(back.full(), got.dispatch_bitmap.full())


# -- the plain versions against the reference's functions ----------------------

def test_accept_or_plain_equals_reference_functions():
    """``accept_or_plain`` is ``or_accept_rows`` (-1 reads nothing, the
    reference's all-zero sentinel row) and the ring's window (ids outside
    it read nothing); its popcount is the reference's
    ``population_count`` sum."""
    rng = np.random.default_rng(5)
    bm = rng.integers(0, 2**32, (41, 9), dtype=np.uint32)
    bm[-1] = 0
    ids = rng.integers(-1, 40, (13, 6)).astype(np.int32)
    ids[4] = -1
    want = np.asarray(jax.jit(ref_sharded_match.or_accept_rows)(jnp.asarray(bm),
                                                  jnp.asarray(ids)))
    out, popc = bk.accept_or_plain(torch.from_numpy(bm.view(np.int32)),
                                   torch.from_numpy(ids))
    np.testing.assert_array_equal(u32(out), want)
    np.testing.assert_array_equal(
        u32(P.or_accept_rows(torch.from_numpy(bm.view(np.int32)),
                             torch.from_numpy(ids))), want)
    np.testing.assert_array_equal(
        popc.numpy(), np.asarray(jnp.sum(jax.lax.population_count(
            jnp.asarray(want)).astype(jnp.int32), axis=1)))
    lo, f_local = 10, 15                     # the ring's window, by numpy
    local = ids - lo
    valid = (ids >= 0) & (local >= 0) & (local < f_local)
    rows = bm[lo:lo + f_local][np.where(valid, local, 0)]
    ring_want = np.bitwise_or.reduce(np.where(valid[:, :, None], rows, 0),
                                     axis=1)
    out, _ = bk.accept_or_plain(
        torch.from_numpy(bm[lo:lo + f_local].view(np.int32)),
        torch.from_numpy(ids), lo)
    np.testing.assert_array_equal(u32(out), ring_want)


def _raw_accepts(rng, B, C, hi):
    """Raw accept slots ``(B, C)``: -1 empty, ids in ``[0, hi + 10)``
    (some past the bitmap's ``hi`` rows); row 0 every slot valid (past
    K), row 1 none."""
    acc = np.where(rng.random((B, C)) < 0.4, rng.integers(0, hi + 10, (B, C)),
                   -1).astype(np.int32)
    acc[0] = rng.integers(0, hi, C)
    acc[1] = -1
    return acc


def _ref_bits_of(ids, W):
    """The reference ring's ``bits_of`` (a closure of its step)."""
    ok = ids >= 0
    word = jnp.where(ok, ids >> 5, W)
    bit = jnp.where(ok, jnp.uint32(1) << (ids & 31).astype(jnp.uint32),
                    jnp.uint32(0))
    rows = jnp.broadcast_to(jnp.arange(ids.shape[0])[:, None], ids.shape)
    return jnp.zeros((ids.shape[0], W), jnp.uint32).at[rows, word].add(
        bit, mode="drop")


def _ref_ring(acc, bm, ring, K, cap, dp):
    """The reference ring's arithmetic on raw accept slots, a dp row group
    at a time: its ``_compact``, each position's window gather-OR as its
    step writes it, then the OR of the partials, or the first position's
    partial with the others' ``compact_bitmap_ids`` lists through
    ``bits_of``, and the overflow flags summed over the ring."""
    from emqx_tpu.ops.match_kernel import _compact as ref_compact

    f_local, W = bm.shape[0] // ring, bm.shape[1]
    outs, truncs = [], []
    for m in np.split(np.asarray(ref_compact(jnp.asarray(acc), K)), dp):
        m = jnp.asarray(m)
        parts = []
        for r in range(ring):
            local = m - r * f_local
            valid = (m >= 0) & (local >= 0) & (local < f_local)
            rows = jnp.asarray(bm[r * f_local:(r + 1) * f_local])[
                jnp.where(valid, local, 0)]
            parts.append(jax.lax.reduce(
                jnp.where(valid[:, :, None], rows, jnp.uint32(0)),
                np.uint32(0), jax.lax.bitwise_or, (1,)))
        out, trunc = parts[0], jnp.zeros(m.shape[0], jnp.int32)
        for r, p in enumerate(parts):
            if cap is None:
                out = out | p
                continue
            ids, _n, over = ref_sharded_match.compact_bitmap_ids(p, cap)
            trunc = trunc + over
            if r:
                out = out | _ref_bits_of(ids, W)
        outs.append(np.asarray(out))
        truncs.append(np.asarray(trunc))
    return np.concatenate(outs), np.concatenate(truncs)


@pytest.mark.parametrize("ring,cap,dp", [(4, None, 1), (4, 5, 2), (2, 40, 3),
                                         (3, 1, 1), (2, 0, 2), (4, 500, 4)])
def test_ring_or_plain_equals_reference_arithmetic(ring, cap, dp):
    """``ring_or_plain`` on raw accept slots against the reference ring's
    own arithmetic row group by row group (dp groups; one launch takes the
    whole batch): caps that cut a partial mid-word, 0 and past every bit,
    rows of more than K valid slots, -1 and ids past the bitmap."""
    rng = np.random.default_rng(10 * ring + dp)
    B, C, K, W = 12, 50, 8, 9
    bm = rng.integers(0, 2**32, (13 * ring, W), dtype=np.uint32)
    bm &= rng.integers(0, 2**32, bm.shape, dtype=np.uint32)
    acc = _raw_accepts(rng, B, C, bm.shape[0])
    want_out, want_trunc = _ref_ring(acc, bm, ring, K, cap, dp)
    out, trunc = bk.ring_or_plain(torch.from_numpy(acc),
                                  torch.from_numpy(bm.view(np.int32)), ring,
                                  K, cap)
    np.testing.assert_array_equal(u32(out), want_out)
    if cap is None:
        assert trunc is None
        return
    np.testing.assert_array_equal(trunc.numpy(), want_trunc)
    assert (want_trunc > 0).any() == (cap < 100)
    assert not want_out[1].any() and want_out[0].any()


@pytest.mark.parametrize("U", [1, 3])
def test_ulysses_or_plain_equals_reference_arithmetic(U):
    """``ulysses_or_plain`` on raw accept slots against the reference
    step's arithmetic: its ``_compact``, ``or_accept_rows`` (-1 reads
    the zero sentinel row, an id past it is clamped there), the tiled
    ``all_to_all``'s column blocks, each block's per-subscriber bit
    counts; ``n_matches`` counts every valid slot."""
    from emqx_tpu.ops.match_kernel import _compact as ref_compact

    rng = np.random.default_rng(U)
    B, C, K, W = 10, 40, 6, 12
    bm = rng.integers(0, 2**32, (30, W), dtype=np.uint32)
    bm[-1] = 0
    acc = _raw_accepts(rng, B, C, bm.shape[0])
    aover = rng.integers(0, 3, B).astype(np.int32)
    ingest = ref_sharded_match.or_accept_rows(
        jnp.asarray(bm), ref_compact(jnp.asarray(acc), K))
    blocks = [ingest[:, u * W // U:(u + 1) * W // U] for u in range(U)]
    per_sub = [jnp.sum(((b[:, :, None] >> jnp.arange(32, dtype=jnp.uint32))
                        & jnp.uint32(1)).astype(jnp.int32), axis=0)
               .reshape(-1) for b in blocks]
    disp, counts, n, over = bk.ulysses_or_plain(
        torch.from_numpy(acc), torch.from_numpy(aover),
        torch.from_numpy(bm.view(np.int32)), U, K)
    for u in range(U):
        np.testing.assert_array_equal(u32(disp[u]), np.asarray(blocks[u]))
    np.testing.assert_array_equal(counts.numpy(),
                                  np.concatenate([np.asarray(x)
                                                  for x in per_sub]))
    np.testing.assert_array_equal(n.numpy(), (acc >= 0).sum(1))
    np.testing.assert_array_equal(over.numpy(), aover)
    assert n.numpy()[0] == C > K


def test_group_plain_versions_equal_reference_functions():
    """``group_count_plain`` is the reference's per-(row, group)
    popcount; ``group_pick_plain`` on one shard (prefix 0) is the
    reference's one-shard selector and ``_nth_set_bit``."""
    rng = np.random.default_rng(6)
    bm = rng.integers(0, 2**32, (12, 7), dtype=np.uint32)
    masks = rng.integers(0, 2**32, (5, 7), dtype=np.uint32)
    masks[2] = 0
    tb, tm = (torch.from_numpy(a.view(np.int32)) for a in (bm, masks))
    count = bk.group_count_plain(tb, tm)
    want = np.asarray(jnp.sum(jax.lax.population_count(
        jnp.asarray(bm)[:, None, :] & jnp.asarray(masks)[None]).astype(
            jnp.int32), axis=-1))
    np.testing.assert_array_equal(count.numpy(), want)
    sel = rng.integers(-2**31, 2**31 - 1, 12).astype(np.int32)
    pick = bk.group_pick_plain(tb, tm, torch.from_numpy(sel), count,
                               torch.zeros_like(count), count, 0)
    ref_pick = ref.build_shared_selector(ref_mesh({"dp": 1, "tp": 1}))(
        jnp.asarray(bm), jnp.asarray(masks), jnp.asarray(sel))
    np.testing.assert_array_equal(pick.numpy(), np.asarray(ref_pick))
    words = rng.integers(0, 2**32, 64, dtype=np.uint32)
    n = rng.integers(0, 8, 64).astype(np.int32)
    np.testing.assert_array_equal(
        bk._nth_set_bit_plain(torch.from_numpy(words.view(np.int32)),
                              torch.from_numpy(n)).numpy(),
        np.asarray(ref_shared_group._nth_set_bit(jnp.asarray(words),
                                                 jnp.asarray(n))))
    assert port_shared_group.host_pick(bm[0].view(np.int32), masks[0], 5) \
        == ref.host_pick(bm[0], masks[0], 5)


def test_converters():
    rng = np.random.default_rng(8)
    bm = rng.integers(0, 2**32, (9, 4), dtype=np.uint32)
    for conv in (accept_bitmap_from_reference, group_masks_from_reference):
        t = conv(bm, CPU)
        assert t.dtype == torch.int32 and t.device == CPU
        np.testing.assert_array_equal(u32(t), bm)
        with pytest.raises(ValueError):
            conv(bm.astype(np.int64), CPU)
    rtabs = ref.build_partitions(["a/b", "+/c", "d/#"], 2, depth=4)
    tabs = ep_tables_from_reference(rtabs)
    assert isinstance(tabs, P.EpTables) and tabs.n_parts == 2
    assert tabs.accept_filters == rtabs.accept_filters
    np.testing.assert_array_equal(tabs.edge_tabs, rtabs.edge_tabs)


# -- the named-axis mesh and the collectives ------------------------------------

@pytest.mark.parametrize("shape", [{"dp": 2, "tp": 4}, {"dp": 1, "ring": 4},
                                   {"ep": 4}, {"u": 8}, {"dp": 4, "ring": 2}])
def test_named_axis_mesh_equals_reference(shape):
    """The port's grid is the reference's device array, reshaped the same
    way (devices named by index), with each axis's positions."""
    n = int(np.prod(list(shape.values())))
    r = ref_mesh(shape)
    devs = [torch.device("cpu", i) for i in range(n)]
    m = P.make_mesh(shape, devs)
    assert m.shape == dict(r.shape) and m.axes == tuple(r.axis_names)
    ids = np.vectorize(lambda d: d.id)(r.devices)
    positions = list(np.ndindex(*shape.values()))
    for pos in positions:
        assert m.device_at(pos).index == ids[pos]
    for axis in shape:
        k = m.axes.index(axis)
        for pos in positions:
            got = [d.index for d in m.axis_devices(axis, pos)]
            idx = list(pos)
            idx[k] = slice(None)
            assert got == ids[tuple(idx)].tolist()
    assert m.lead.index == 0 and len(m.distinct) == n
    assert P.make_mesh(shape, cpus(n)).distinct == [CPU]


def test_collectives_against_numpy():
    rng = np.random.default_rng(12)
    n = 4
    devs = cpus(n)
    xs = [rng.integers(-50, 50, (8, 12)).astype(np.int32) for _ in range(n)]
    parts = [torch.from_numpy(x) for x in xs]
    got = parts
    for hop in range(1, n + 1):      # n hops come back around
        got = P.ppermute(got, devs)
        for o in range(n):
            np.testing.assert_array_equal(got[o].numpy(), xs[(o - hop) % n])
    for got in P.pmax(parts, devs):
        np.testing.assert_array_equal(got.numpy(), np.maximum.reduce(xs))
    for split, concat in ((1, 0), (0, 1), (0, 0)):
        got = P.all_to_all_tiled(parts, devs, split, concat)
        for o in range(n):
            want = np.concatenate(
                [np.split(x, n, axis=split)[o] for x in xs], axis=concat)
            np.testing.assert_array_equal(got[o].numpy(), want)
    with pytest.raises(ValueError):
        P.all_to_all_tiled([torch.zeros(3, 5)] * n, devs, 1, 0)
    with pytest.raises(ValueError):
        P.ppermute(parts[:3], devs)
