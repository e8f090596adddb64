"""The port's match-plane slice against the JAX reference, on the CPU:
host table builder, resident device table with delta churn, the loader of
reference tables, and the serve core against the topic oracle.  All
outputs are integers or strings, so every comparison is exact."""

import ast
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from emqx_tpu.ops import DeviceNfa as RefDeviceNfa
from emqx_tpu.ops import IncrementalNfa as RefIncrementalNfa
from emqx_tpu.ops import compile_filters as ref_compile
from emqx_tpu.ops import encode_topics as ref_encode
from emqx_tpu.ops import nfa_match as ref_nfa_match

from emqx_tpu_torch import topic as T
from emqx_tpu_torch.broker.match_service import MatchService
from emqx_tpu_torch.broker.trie import FilterTrie
from emqx_tpu_torch.convert import from_reference
from emqx_tpu_torch.ops import DeviceNfa, IncrementalNfa
from emqx_tpu_torch.ops.device_table import resolve_device
from emqx_tpu_torch.workload import build_workload

REPO = Path(__file__).resolve().parent.parent

EXTRA_FILTERS = ["$SYS/#", "$SYS/+/load", "#", "+", "+/+", "x//y", "/",
                 "//#", "a/+/c/#", "+/L1w0/#"]
EXTRA_TOPICS = ["$SYS/broker/load", "$SYS", "x//y", "/", "//", "a/b/c/d",
                "L0w0/L1w0", "never/seen/words/at/all",
                "L0w1/L1w2/L2w3/L3w4/L4w5/L5w6/L6w7/L7w8/x/y/z"]


def _workload(seed, n_filters, n_topics, depth=8):
    filters, topics = build_workload(np.random.default_rng(seed), n_filters,
                                     n_topics, depth=depth)
    return sorted(set(filters) | set(EXTRA_FILTERS)), EXTRA_TOPICS + topics


def _assert_tables_equal(port, ref):
    np.testing.assert_array_equal(port.node_tab, ref.node_tab)
    np.testing.assert_array_equal(port.edge_tab, ref.edge_tab)
    np.testing.assert_array_equal(port.seeds, ref.seeds)
    assert port.vocab == ref.vocab
    assert port.accept_filters == ref.accept_filters
    assert port.epoch == ref.epoch


@pytest.mark.parametrize("seed,n_filters,n_topics,depth", [
    (0, 50, 10, 8), (1, 1500, 200, 8), (2, 5000, 100, 12), (3, 20000, 2048, 8),
    (4, 10, 5, 3), (5, 3, 0, 2), (6, 0, 4, 8), (9, 3000, 300, 16)])
def test_workload_equals_reference(seed, n_filters, n_topics, depth):
    """The port's array-coded generator makes the reference benchmark's
    filters and topics from the same seed (small sets repeat filters, so
    the reference's redraw rounds run too)."""
    from bench import build_workload as ref_build_workload

    assert build_workload(np.random.default_rng(seed), n_filters, n_topics,
                          depth) == ref_build_workload(
        np.random.default_rng(seed), n_filters, n_topics, depth)


def test_incremental_builder_equals_reference():
    filters, _ = _workload(1, 1500, 0)
    rng = np.random.default_rng(2)
    port, ref = IncrementalNfa(depth=8), RefIncrementalNfa(depth=8)
    for f in filters:
        assert port.add(f) == ref.add(f)
    _assert_tables_equal(port, ref)       # grew: S and Hb doubled
    gone = [filters[i] for i in rng.choice(len(filters), 600, replace=False)]
    for f in gone:
        assert port.remove(f) == ref.remove(f)
    _assert_tables_equal(port, ref)
    fresh, _ = _workload(3, 300, 0)
    for f in fresh + gone[:100]:
        assert port.add(f) == ref.add(f)
    _assert_tables_equal(port, ref)
    for a, b in zip(port.flush(), ref.flush()):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(np.sort(a, axis=0),
                                          np.sort(b, axis=0))
        else:
            assert a == b
    for t in _workload(4, 10, 200)[1]:
        assert port.match_host(t) == ref.match_host(t)


def test_from_reference_answers_identically():
    filters, topics = _workload(5, 800, 300)
    t = ref_compile(filters, depth=8, state_bucket=64)
    dev = from_reference(t.node_tab, t.edge_tab, t.seeds, t.accept_filters,
                         t.vocab, device="cpu", depth=8, active_slots=8,
                         max_matches=16)
    words, lens, is_sys = ref_encode(t, topics, batch=512)
    ref = ref_nfa_match(jnp.asarray(words), jnp.asarray(lens),
                        jnp.asarray(is_sys),
                        *[jnp.asarray(a) for a in t.device_arrays()],
                        active_slots=8, max_matches=16, flat_cap=2048)
    got = dev.match_names(topics, batch=512, flat_cap=2048)
    for f in ("matches", "n_matches", "active_overflow", "match_overflow",
              "row_meta"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert dev.uploads == 1 and dev.table_bytes == (
        t.node_tab.nbytes + t.edge_tab.nbytes + t.seeds.nbytes)


def test_device_table_churn_equals_reference():
    """Add/remove churn drained through drain/apply_pending: after every
    sync the resident tables and the answers equal the reference's."""
    filters, topics = _workload(6, 1200, 240)
    rng = np.random.default_rng(7)
    port_inc, ref_inc = IncrementalNfa(depth=8), RefIncrementalNfa(depth=8)
    port = DeviceNfa(port_inc, active_slots=8, max_matches=16, device="cpu")
    ref = RefDeviceNfa(ref_inc, active_slots=8, max_matches=16)
    live = set()
    pool, _ = _workload(8, 2000, 0)
    for step in range(6):
        for f in rng.choice(pool, 300, replace=False):
            f = str(f)
            if f in live and rng.random() < 0.5:
                assert port_inc.remove(f) == ref_inc.remove(f)
                live.discard(f)
            else:
                assert port_inc.add(f) == ref_inc.add(f)
                live.add(f)
        port.apply_pending(port.drain())
        ref.apply_pending(ref.drain())
        assert port.epoch == ref.epoch
        for a, b in zip(port.arrays(), ref.arrays()):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        got = port.match_names(topics, batch=256)
        want = ref.match_names(topics, batch=256)
        for a, b in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # later steps wrote rows in place: the tables were not re-uploaded
    # for every sync
    assert port.delta_applies > 0
    assert port.uploads == ref.uploads


@pytest.mark.parametrize("backend,raises,match", [
    ("dense", ValueError, "unknown"),
    ("auto", NotImplementedError, "auto"),
    ("join", RuntimeError, "enable_join"),
    ("join-pallas", RuntimeError, "enable_join"),
])
def test_device_table_rejects_unported_backends(backend, raises, match):
    """An unknown backend raises ValueError and ``auto`` (not ported)
    NotImplementedError.  A join backend without the relation mirror
    raises, where the reference quietly serves ``hash``: a join dispatch
    never runs the hash walk in its place."""
    dev = DeviceNfa(IncrementalNfa(depth=4), device="cpu")
    words = torch.zeros((64, 4), dtype=torch.int32)
    lens = torch.full((64,), 6, dtype=torch.int32)
    is_sys = torch.ones(64, dtype=torch.bool)
    with pytest.raises(raises, match=match):
        dev.match(words, lens, is_sys, backend=backend)


def test_no_cuda_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceNfa(IncrementalNfa(depth=4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MatchService(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def _oracle(filters, topic):
    return {f for f in filters if T.match(topic, f)}


DEEP = ["d/" + "/".join(f"l{i}" for i in range(20)),
        "d/" + "/".join(["+"] * 17) + "/#",
        "/".join(["d"] * 18)]
DEEP_TOPICS = ["d/" + "/".join(f"l{i}" for i in range(20)),
               "/".join(["d"] * 18), "/".join(["d"] * 25)]


@pytest.mark.parametrize("active_slots,max_matches", [(16, 128), (2, 4)])
def test_serve_equals_oracle(active_slots, max_matches):
    """serve() over a few thousand filters, deep filters included, equals
    topic.match over the filter list; the (2, 4) case spills rows to the
    host table."""
    filters, topics = _workload(9, 3000, 1400)
    filters += DEEP
    topics += DEEP_TOPICS
    svc = MatchService(device="cpu", active_slots=active_slots,
                       max_matches=max_matches, max_batch=1024)
    for f in filters:
        assert svc.add(f)
    assert not svc.add(filters[0])
    svc.sync()
    got = svc.serve(topics)
    assert len(got) == len(topics)
    for t, row in zip(topics, got):
        assert sorted(row) == sorted(_oracle(filters, t)), t
    assert svc.batches == svc.dispatches >= 3   # 2 chunks, depth split
    if active_slots == 2:
        assert svc.fallback_host > 0


def test_serve_after_churn_uses_row_writes():
    filters, topics = _workload(10, 2500, 600)
    svc = MatchService(device="cpu")
    for f in filters:
        svc.add(f)
    svc.sync()
    uploads = svc.dev.uploads
    rng = np.random.default_rng(11)
    gone = {filters[i] for i in rng.choice(len(filters), 200, replace=False)}
    for f in gone:
        assert svc.remove(f)
    assert not svc.remove("never/added")
    fresh = [f"new/{i}/+/#" for i in range(50)] + DEEP
    for f in fresh:
        svc.add(f)
    assert svc.remove(DEEP[0])
    svc.sync()
    assert svc.dev.uploads == uploads and svc.dev.delta_applies == 1
    live = [f for f in filters if f not in gone] + fresh[:-3] + DEEP[1:]
    trie = FilterTrie()
    for f in live:
        trie.insert(f)
    for t, row in zip(topics + DEEP_TOPICS, svc.serve(topics + DEEP_TOPICS)):
        assert sorted(row) == sorted(trie.match(t)), t


def test_depth_groups_split_short_topics():
    svc = MatchService(device="cpu", split_min=2)
    topics = ["a", "a/b/c/d", "a/b/c/d/e", "x/y/z/w/v/u", "q"]
    groups = svc._depth_groups(topics)
    assert groups == [([0, 1, 4], 4), ([2, 3], 16)]
    svc.split_min = 3
    assert svc._depth_groups(topics) == [([0, 1, 2, 3, 4], 16)]


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_nothing_of_jax_or_the_reference():
    files = sorted((REPO / "emqx_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    # every subpackage, the rule engine and access control among them
    scanned = {p.parent.name for p in files}
    assert {"rule_engine", "auth", "broker", "ops", "native", "exhook",
            "storage", "parallel"} <= scanned
    for mod in ("mesh", "collectives", "sharded_match", "prefix_ep",
                "multichip_serve", "shared_group", "ring_fanout", "ulysses",
                "steps", "dryrun"):
        assert REPO / "emqx_tpu_torch" / "parallel" / f"{mod}.py" in files
    assert REPO / "emqx_tpu_torch" / "storage" / "checkpoint.py" in files
    # the kernels' wrappers, the flat epilogue's and the dense walk's
    # among them
    for mod in ("match_kernel", "walk_kernel", "dense_match", "cuda_build",
                "bitmap_kernel", "route_kernel"):
        assert REPO / "emqx_tpu_torch" / "ops" / f"{mod}.py" in files
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for mod in _imports(tree):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "emqx_tpu"), (path, mod)
