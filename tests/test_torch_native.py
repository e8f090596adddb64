"""The port's native host table and encoder against the JAX package's, on
the CPU.

The port's ``NativeNfa`` (``emqx_tpu_torch/native/nfa.cpp``) is held to
the reference's (``emqx_tpu/native/nfa.cpp``) byte for byte — tables,
seeds, vocab, accept ids, host matches and drained deltas — along seeded
add/remove churn with growth, aliases and freed-id reuse; both are built
by the same ``g++`` in this process, so the ``std::mt19937`` cuckoo seeds
agree.  The native ``TopicEncoder`` is held to the reference's.  The
serve core on the native table is held to the serve core on the Python
table and to the topic oracle on ``hash`` and ``join``, through churn
that reuses freed accept ids; the plain walks run on the CPU.  Every
output is an integer or a string, so the tolerance is exact equality.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from emqx_tpu.native.nfa import NativeNfa as RefNativeNfa
from emqx_tpu.ops import nfa_match as ref_nfa_match
from emqx_tpu.ops.encode import TopicEncoder as RefTopicEncoder

from emqx_tpu_torch import topic as T
from emqx_tpu_torch.broker import match_service
from emqx_tpu_torch.broker.match_service import MatchService
from emqx_tpu_torch.broker.trie import FilterSet, FilterTrie
from emqx_tpu_torch.convert import from_reference
from emqx_tpu_torch.native import NativeBuildFailed, build
from emqx_tpu_torch.native import nfa as native_nfa
from emqx_tpu_torch.native.nfa import NativeNfa
from emqx_tpu_torch.ops import DeviceNfa, encode, encode_batch
from emqx_tpu_torch.ops.encode import TopicEncoder
from emqx_tpu_torch.workload import build_workload

EDGE_FILTERS = ["#", "+", "+/+", "$SYS/#", "$SYS/+/x", "x//y", "/", "//#",
                "a/+/c/#", "+/L1w0/#", "a/#", "a", "/+", "+//+"]
EDGE_TOPICS = ["$SYS/a/x", "$SYS", "x//y", "/", "//", "a/b/c/d", "a",
               "L0w0/L1w0", "never/seen/words", "$SYS/q/x/y", "a//b"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain walks are many small torch ops: with one intra-op thread
    they do not slow down tenfold when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _workload(seed, n_filters, n_topics, depth=8):
    filters, topics = build_workload(np.random.default_rng(seed), n_filters,
                                     n_topics, depth=depth)
    return (sorted(set(filters) | set(EDGE_FILTERS)),
            EDGE_TOPICS + topics)


def _deep(depth, n):
    """Filters one level deeper than ``depth`` (aliases in the table)."""
    return [f"deep{i}/" + "/".join(["+"] * depth) for i in range(n)]


# -- the table: port == reference, byte for byte ----------------------------

def _assert_native_equal(port, ref, filters, topics):
    for a, b in zip(port.tables(), ref.tables()):
        np.testing.assert_array_equal(a, b)
    assert port.vocab == ref.vocab
    assert port.shape_key() == ref.shape_key()
    for k in ("n_filters", "n_states", "epoch", "aid_reuses"):
        assert getattr(port, k) == getattr(ref, k), k
    n = len(ref.accept_filters)
    assert port.n_accepts == n
    assert [port.accept_get(a) for a in range(n)] == [
        ref.accept_get(a) for a in range(n)]
    assert [port.aid_of(f) for f in filters] == [ref.aid_of(f)
                                                 for f in filters]
    for t in topics:
        assert port.match_host(t) == ref.match_host(t), t


def _assert_delta_equal(a, b):
    assert (a.epoch, a.resized) == (b.epoch, b.resized)
    for f in ("state_idx", "state_rows", "bucket_idx", "bucket_rows"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


@pytest.mark.parametrize("depth,build,consumer", [
    (8, "bulk", True), (8, "add", True), (16, "add", False),
    (16, "bulk", False)])
def test_native_table_equals_reference(depth, build, consumer):
    """From the same calls the port's table holds the reference's bytes:
    a build that grows S and Hb from small buckets (one bulk call, or one
    add at a time), aliases of too-deep filters, then removes and adds
    drained between steps — with a device consumer, freed ids come back
    once their removal's epoch is acked."""
    filters, topics = _workload(depth, 2500, 300, depth=min(depth, 8))
    port, ref = (cls(depth=depth, state_bucket=256, edge_bucket=32)
                 for cls in (NativeNfa, RefNativeNfa))
    if consumer:
        port.device_epoch = ref.device_epoch = -1
    if build == "bulk":
        assert port.bulk_add(filters) == ref.bulk_add(filters)
    else:
        for f in filters:
            assert port.add(f) == ref.add(f)
    aliases = [(port.alloc_alias(f), ref.alloc_alias(f))
               for f in _deep(depth, 5)]
    assert all(a == b for a, b in aliases)
    _assert_native_equal(port, ref, filters, topics)
    _assert_delta_equal(port.flush(), ref.flush())
    rng = np.random.default_rng(depth)
    live = list(filters)
    for step in range(3):
        gone = [live[i] for i in rng.choice(len(live), 150, replace=False)]
        for f in gone:
            assert port.remove(f) == ref.remove(f)
        port.free_alias(aliases[step][0])
        ref.free_alias(aliases[step][1])
        _assert_delta_equal(port.flush(), ref.flush())
        if consumer:
            port.device_epoch = port.epoch
            ref.device_epoch = ref.epoch
        fresh, _ = _workload(100 + step, 120, 0, depth=min(depth, 8))
        for f in fresh + gone[:50]:
            assert port.add(f) == ref.add(f)
        live = sorted((set(live) - set(gone)) | set(fresh) | set(gone[:50]))
        _assert_delta_equal(port.flush(), ref.flush())
        _assert_native_equal(port, ref, live, topics)
    assert port.aid_reuses > 0     # with no consumer, at once


def test_bulk_aid_of_equals_aid_of():
    filters, _ = _workload(3, 800, 0)
    nt = NativeNfa(depth=8)
    nt.bulk_add(filters[::2])
    probe = filters + ["absent/x", "a/b\nc"]
    want = [nt.aid_of(f) for f in probe]
    assert nt.bulk_aid_of(probe).tolist() == want
    assert nt.bulk_aid_of(probe[:-1]).tolist() == want[:-1]
    assert nt.bulk_aid_of([]).tolist() == []
    assert sum(a >= 0 for a in want) == len(filters[::2])


# -- the encoder: port == reference -----------------------------------------

@pytest.mark.parametrize("depth", [4, 8, 16])
@pytest.mark.parametrize("case", ["workload", "sys_and_edges", "padding",
                                  "nul"])
def test_native_encoder_equals_reference(depth, case):
    """Seeded topics, ``$`` topics and edge shapes, padding rows, and a
    batch with a NUL in a topic (the whole batch on the Python loop, as
    the reference does, counted)."""
    filters, topics = _workload(11, 1500, 400)
    nt = NativeNfa(depth=16)
    nt.bulk_add(filters)
    batch = None
    if case == "sys_and_edges":
        topics = EDGE_TOPICS + ["$" + t for t in topics[:100]] + [
            "/".join(["L0w1"] * 30), "", "+"]
    elif case == "padding":
        topics, batch = topics[:37], 64
    elif case == "nul":
        topics = topics[:50] + ["a\x00b/c"] + topics[50:80]
    port, ref = TopicEncoder(nt.vocab), RefTopicEncoder(nt.vocab)
    for _ in range(2):          # the second call: vocab grew in between
        for a, b in zip(port.encode(topics, depth, batch),
                        ref.encode(topics, depth, batch)):
            np.testing.assert_array_equal(a, b)
        nt.add("fresh/L1w0/word")
        topics = topics + ["fresh/L1w0/word"]
    assert port.python_batches == (2 if case == "nul" else 0)
    assert port.native_batches == (0 if case == "nul" else 2)


def test_encoder_is_cached_on_its_table():
    nt = NativeNfa(depth=8)
    nt.add("a/b")
    enc = encode.table_encoder(nt)
    encode_batch(nt, ["a/b", "a/c"])
    nt.add("a/c")
    words, _lens, _sys = encode_batch(nt, ["a/b", "a/c"])
    assert encode.table_encoder(nt) is enc and enc.native_batches == 2
    assert words[1, 1] == nt.vocab["c"]


# -- the serve core on the native table -------------------------------------

def _oracle(filters):
    trie = FilterTrie()
    for f in filters:
        trie.insert(f)
    return trie


@pytest.mark.parametrize("backend", ["hash", "join"])
@pytest.mark.parametrize("start", ["load", "add"])
def test_native_service_equals_python_and_oracle(backend, start):
    """``table=native`` answers as ``table=python`` and the oracle,
    before and after churn whose adds reuse freed accept ids."""
    filters, topics = _workload(21, 2000, 900)
    filters += _deep(16, 3)
    topics += ["deep1/" + "/".join(["q"] * 16)]
    svcs = {}
    for table in ("native", "python"):
        svc = MatchService(device="cpu", backend=backend, table=table,
                           max_batch=512)
        if start == "load":
            assert svc.load(filters) == len(filters)
        else:
            assert all(svc.add(f) for f in filters)
        svc.sync()
        svcs[table] = svc
    nat, py = svcs["native"], svcs["python"]
    assert nat.table_kind == "native" and py.table_kind == "python"
    trie = _oracle(filters)

    def check():
        got = nat.serve(topics)
        assert got == py.serve(topics)
        for t, row in zip(topics, got):
            assert sorted(row) == sorted(trie.match(t)), t

    check()
    rng = np.random.default_rng(22)
    gone = [filters[i] for i in rng.choice(len(filters) - 3, 300,
                                           replace=False)]
    gone.append(filters[-1])        # a too-deep one: its alias id goes
    for svc in svcs.values():
        for f in gone:
            assert svc.remove(f)
        assert not svc.remove(gone[0])
    for f in gone:
        trie.delete(f)
    check()     # the device still holds the removed filters' ids
    for svc in svcs.values():
        svc.sync()                  # acks the removes: ids reusable
    check()
    fresh, _ = _workload(23, 200, 0)
    fresh = [f for f in fresh if f not in set(filters)][:150] + gone[:40]
    for svc in svcs.values():
        for f in fresh:
            assert svc.add(f)
        svc.sync()
    for f in fresh:
        trie.insert(f)
    assert nat.inc.aid_reuses > 0
    check()
    assert nat.encoder.python_batches == 0 and nat.encoder.native_batches > 0
    if backend == "join":
        assert nat.join_dispatches == nat.dispatches > 0


def test_split_lookup_follows_reused_ids_as_the_reference():
    """The serve core's accept id → filter map after removes and adds
    that reuse freed ids equals the reference table's own accept table
    (driven with the same calls), for every id either holds."""
    filters, _ = _workload(31, 600, 0)
    svc = MatchService(device="cpu", table="native")
    ref = RefNativeNfa(depth=16)
    ref.device_epoch = -1
    for f in filters:
        svc.add(f)
        ref.add(f)
    svc.sync()
    ref.flush()
    ref.device_epoch = ref.epoch
    gone = filters[::3]
    for f in gone:
        svc.remove(f)
        ref.remove(f)
    svc.sync()
    ref.flush()
    ref.device_epoch = ref.epoch
    fresh = [f"re/{i}/+" for i in range(len(gone))]
    reused = set()
    for f in fresh:
        svc.add(f)
        ref.add(f)
        reused.add(svc.inc.aid_of(f))
    assert svc.inc.aid_reuses == ref.aid_reuses == len(fresh)
    n = len(ref.accept_filters)
    want = [ref.accept_get(a) for a in range(n)]
    got = [(svc._split_row([a])[0] or [None])[0] for a in range(n)]
    assert got == want
    assert {want[a] for a in reused} == set(fresh)


@pytest.mark.parametrize("bad", ["a/b+", "a/#/b", "a#", "", "x/\x00",
                                 "$share//a", "+a/b", "#/", "a/+#"])
def test_load_validates_every_filter(bad):
    filters, _ = _workload(41, 300, 0)
    svc = MatchService(device="cpu", table="native")
    with pytest.raises(T.TopicError):
        svc.load(filters[:100] + [bad] + filters[100:])
    assert svc.inc.n_filters == 0
    assert svc.load(filters + ["$share/g/a/+"]) == len(filters) + 1


def test_validate_all_equals_topic_validate():
    rng = np.random.default_rng(42)
    alphabet = ["a", "b", "+", "#", "/", "$", "é", "share", "\n"]
    for _ in range(400):
        fs = ["".join(rng.choice(alphabet, rng.integers(0, 6)))
              for _ in range(rng.integers(1, 5))]
        try:
            for f in fs:
                T.validate(f, "filter")
            ok = True
        except T.TopicError:
            ok = False
        try:
            match_service._validate_all(fs)
            got = True
        except T.TopicError:
            got = False
        assert got == ok, fs


@pytest.mark.parametrize("table", ["native", "python"])
def test_split_map_counts_and_frees(table):
    """The accept id → filter map after ``load``, a remove and an add:
    the routing count, a freed id answering nothing, a new id its
    filter."""
    filters, _ = _workload(45, 400, 0)
    svc = MatchService(device="cpu", table=table)
    svc.load(filters + _deep(16, 2))
    gone = svc.inc.aid_of(filters[0])
    svc.remove(filters[0])
    svc.add("fresh/+/x")
    assert svc.n_routing == len(filters) + 2
    assert svc._split_row([gone]) == ([], [])
    assert svc._split_row([svc.inc.aid_of("fresh/+/x")]) == (["fresh/+/x"],
                                                             [])


def test_load_needs_an_empty_service():
    svc = MatchService(device="cpu")
    svc.add("a/b")
    with pytest.raises(RuntimeError, match="empty"):
        svc.load(["c/d"])


def test_device_table_uploads_native_export_and_deltas():
    """The device twin of a native table holds its exported bytes after
    the first upload, after in-place deltas and after growth."""
    filters, _ = _workload(51, 1500, 0)
    nt = NativeNfa(depth=8, state_bucket=1024, edge_bucket=256)
    dev = DeviceNfa(nt, device="cpu", lazy=True)
    nt.bulk_add(filters[:500])
    for step, chunk in enumerate((filters[500:520], filters[520:])):
        dev.sync()
        for a, b in zip(dev.arrays(), nt.tables()):
            np.testing.assert_array_equal(a.numpy(), b)
        for f in chunk:
            nt.add(f)
        nt.remove(filters[step])
    dev.sync()
    for a, b in zip(dev.arrays(), nt.tables()):
        np.testing.assert_array_equal(a.numpy(), b)
    assert dev.uploads == 2 and dev.delta_applies == 1   # growth: re-upload


def test_from_reference_takes_a_native_table():
    """A reference ``NativeNfa``'s export (numpy arrays, vocab dict,
    accept filters as a list) answers through the port as the
    reference's walk answers on it."""
    filters, topics = _workload(61, 900, 300)
    ref = RefNativeNfa(depth=8)
    ref.bulk_add(filters)
    node, edge, seeds = ref.tables()
    accepts = [ref.accept_get(a) for a in range(len(ref.accept_filters))]
    dev = from_reference(node, edge, seeds, accepts, ref.vocab, device="cpu",
                         depth=8, active_slots=8, max_matches=16)
    words, lens, is_sys = RefTopicEncoder(ref.vocab).encode(topics, 8, 512)
    want = ref_nfa_match(jnp.asarray(words), jnp.asarray(lens),
                         jnp.asarray(is_sys), jnp.asarray(node),
                         jnp.asarray(edge), jnp.asarray(seeds),
                         active_slots=8, max_matches=16, flat_cap=2048)
    got = dev.match_names(topics, batch=512, flat_cap=2048)
    for f in ("matches", "n_matches", "active_overflow", "match_overflow",
              "row_meta"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


# -- the intended divergences: no Python stand-in ---------------------------

def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_libs", {})
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    with pytest.raises(NativeBuildFailed, match="g\\+\\+ broken.cpp"):
        build.load_library("broken")
    with pytest.raises(NativeBuildFailed, match="absent.cpp"):
        build.load_library("absent")
    assert not list((tmp_path / "_build").glob("*"))   # no temp left


@pytest.mark.parametrize("table", ["auto", "native"])
def test_native_table_never_falls_back(table, monkeypatch):
    """Where the reference's ``auto`` serves the Python table when the
    native one cannot be built, the port raises; so does the encoder."""
    def fail(name):
        raise NativeBuildFailed(f"no {name}")

    monkeypatch.setattr(native_nfa, "_lib", None)
    monkeypatch.setattr(native_nfa, "load_library", fail)
    with pytest.raises(NativeBuildFailed, match="no nfa"):
        MatchService(device="cpu", table=table)
    monkeypatch.setattr(encode, "_lib", None)
    monkeypatch.setattr(encode, "load_library", fail)
    with pytest.raises(NativeBuildFailed, match="no encoder"):
        TopicEncoder({})
    svc = MatchService(device="cpu", table="python")
    svc.add("a/+")
    svc.sync()
    with pytest.raises(NativeBuildFailed):
        svc.serve(["a/b"])


def test_service_table_kinds():
    assert MatchService(device="cpu").table_kind == "native"
    assert MatchService(device="cpu", table="python").table_kind == "python"
    with pytest.raises(ValueError, match="host table"):
        MatchService(device="cpu", table="dense")


# -- the 10M oracle: the filter-set enumerator against the trie -------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_set_equals_trie(seed):
    """Seeded filters and topics plus ``$`` topics, '#' matching its
    parent level, empty levels and root wildcards."""
    filters, topics = _workload(70 + seed, 3000, 1500)
    filters += ["/#", "+/#", "$SYS", "$SYS/+", "//", "+//#", "a/+/#"]
    topics += ["$SYS", "$SYS/x", "$", "a/", "/a", "a/b/", "///"]
    fs, trie = FilterSet(filters), _oracle(filters)
    rng = np.random.default_rng(seed)
    for t in topics:
        got = fs.match(t)
        assert len(got) == len(set(got))
        assert sorted(got) == sorted(trie.match(t)), t
    for f in [filters[i] for i in rng.choice(len(filters), 500,
                                             replace=False)]:
        fs.delete(f)
        trie.delete(f)
    for t in topics:
        assert sorted(fs.match(t)) == sorted(trie.match(t)), t
    assert len(fs) == len(set(filters)) - 500


# -- the bulk calls in pieces, and the table freed off the caller ----------

def test_bulk_calls_in_pieces_equal_reference(monkeypatch):
    """``bulk_add`` and ``bulk_aid_of`` join the filters a piece at a
    time (``gil.PIECE``, shrunk here so that the workload spans many
    pieces); a filter holding '\\n' in a later piece still takes the
    one-at-a-time path.  The table is the reference's, byte for byte,
    and the ids are its ids."""
    monkeypatch.setattr(native_nfa, "PIECE", 97)
    filters, topics = _workload(31, 1500, 200)
    odd = filters[:700] + ["a/\nb/+"] + filters[700:]
    for flts in (filters, odd):
        port, ref = (cls(depth=8, state_bucket=256, edge_bucket=32)
                     for cls in (NativeNfa, RefNativeNfa))
        assert port.bulk_add(flts) == ref.bulk_add(flts)
        _assert_native_equal(port, ref, flts, topics)
        np.testing.assert_array_equal(
            port.bulk_aid_of(flts),
            np.array([ref.aid_of(f) for f in flts], np.int32))
    assert native_nfa._lines(filters) == (
        "\n".join(filters).encode(), True)
    assert native_nfa._lines(odd)[1] is False
    assert native_nfa._lines([]) == (b"", True)


def test_collected_table_is_freed_off_the_callers_thread():
    """A collected table's handle goes to the ``nfa-free`` thread, which
    frees it; ``close()`` still frees on the spot."""
    import gc
    import threading
    import time

    freed = []
    inner = native_nfa._free_loop

    nt = NativeNfa(depth=8)
    nt.bulk_add(_workload(5, 300, 0)[0])
    lib = nt._lib

    class Spy:
        def nfa_free(self, h):
            freed.append((threading.current_thread().name, h))
            lib.nfa_free(h)
    nt._lib = Spy()
    h = nt._h
    del nt
    gc.collect()
    deadline = time.monotonic() + 10
    while not freed and time.monotonic() < deadline:
        time.sleep(0.01)
    assert [(name, h2) for name, h2 in freed] == [("nfa-free", h)]
    assert native_nfa._free_loop is inner
    nt = NativeNfa(depth=8)
    nt.close()
    assert nt._h is None


def test_yield_points_sleep_only_inside_yielding(monkeypatch):
    """``gil.yield_lock`` sleeps on a thread inside ``gil.yielding`` and
    nowhere else (the same pieces run on the loop at a bootstrap)."""
    from emqx_tpu_torch import gil

    slept = []
    monkeypatch.setattr(gil.time, "sleep", slept.append)
    gil.yield_lock()
    assert slept == []
    with gil.yielding():
        gil.yield_lock()
        with gil.yielding():
            gil.yield_lock()
        gil.yield_lock()
    gil.yield_lock()
    assert slept == [gil.PAUSE_S] * 3
