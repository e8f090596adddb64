"""The CUDA sources of the port's kernels, built with g++ against a CPU
stand-in for CUDA (``tests/cuda_emu/cuda_runtime.h``: the threads of a
block are coroutines on one host thread, and a shuffle or ballot is
exchanged between rounds of them), against their plain PyTorch
versions, bit for bit.

This checks the kernels' logic where there is no card and no nvcc: the
lane layout (one lane per frontier slot, L = the smallest power of two
>= A), the frontier exchange and the top_k ranks, rows past B in a
partly filled block, the join's CSR search with its one round of tail
loads and its live-row overlay search.  Besides a compiled filter
table, a random table whose states repeat within a frontier holds the
ranks' tie-break to top_k, with an overlay of 0, 1 and 40 rows.  The
dense walk (``dense_walk.cu``) is held to ``dense_match_plain`` on
``bench_dense``'s table, a table of ``$``-topic and wildcard-root
filters with rows past K, random tables with several parents a column
(one too large to stage in shared memory), a state with 30 children
under one label, frontiers of dozens of states, and batches that leave
the last block partly filled.  The flat epilogue (``flat_epilogue.cu``)
is held to ``flat_epilogue_plain`` at C of (D, A) = (16, 16), (8, 16),
(4, 16) and (8, 1) with K 32, 64 and 128: rows past K, spills, a cap
that drops whole rows and part of one, an all-empty batch, B = 101 (no
whole number of tiles).  It says nothing of speed, and
``tests/test_torch_cuda.py`` remains the test on the card.  Skips where
g++ is missing."""

import ctypes
import importlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from emqx_tpu_torch.ops import DeviceNfa, IncrementalNfa, encode_batch
from emqx_tpu_torch.ops import compile_filters, cuda_build, encode_topics
# the module (``emqx_tpu_torch.ops.dense_match`` is the function)
dense_mod = importlib.import_module("emqx_tpu_torch.ops.dense_match")
from emqx_tpu_torch.ops.dense_match import (
    _LABEL_NONE, DenseTable, _layout, bench_dense_workload, build_dense,
    dense_match_plain, dense_table, random_dense, random_dense_batch)
from emqx_tpu_torch.ops.dense_match import launch_shape as dense_launch_shape
from emqx_tpu_torch.ops.match_kernel import (
    FLAT_ENTRY, FLAT_TILE_ROWS, flat_epilogue_plain, random_accepts)
from emqx_tpu_torch.ops.walk_kernel import (
    _ENTRY, OVERLAY_CAP, _hash_plain, accept_cols, join_walk_plain,
    launch_shape, nfa_walk_plain)
from emqx_tpu_torch.workload import build_workload

SHIM = cuda_build.CSRC.parents[2] / "tests" / "cuda_emu"
LAUNCH = re.compile(r"(\w+)<<<\s*(.*?),\s*(\w+),\s*(\w+),\s*"
                    r"\(cudaStream_t\)stream>>>\(", re.S)
DYN_SMEM = re.compile(r"extern __shared__ (\w+) (\w+)\[\];")
ENTRIES = {**_ENTRY, "dense_walk": dense_mod._ENTRY,
           "flat_epilogue": FLAT_ENTRY}
#: each level of w/a/b/c/d/e/f literal or '+': that topic's frontier
#: doubles each level, so its walk spills at every A below 64
FAN_FILTERS = ["w/" + "/".join("+" if m >> k & 1 else c
                               for k, c in enumerate("abcdef"))
               for m in range(64)]
EDGE_FILTERS = ["#", "+", "+/+", "$SYS/#", "$SYS/+/x", "x//y", "/", "//#",
                "a/+/c/#", "d/" + "/".join(["+"] * 14)] + FAN_FILTERS
EDGE_TOPICS = ["w/a/b/c/d/e/f", "$SYS/a/x", "$SYS", "x//y", "/", "//",
               "a/b/c/d", "d/" + "/".join(["q"] * 14),
               "d/" + "/".join(["q"] * 30)]
B = 101  # no whole number of blocks at any lane count
CASES = [(8, 1), (8, 2), (8, 3), (16, 12), (4, 16), (16, 16), (8, 32)]


@pytest.fixture(scope="module")
def emu_kernels(tmp_path_factory):
    """Every kernel source, launches and dynamic shared memory rewritten
    for the stand-in, built into shared libraries (one g++ each, started
    together); returns the bound C entry points by kernel name."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    src = tmp_path_factory.mktemp("csrc")
    for f in cuda_build.CSRC.iterdir():
        text = LAUNCH.sub(r"emu_launch_smem(\1, \2, \3, \4, ",
                          f.read_text())
        text = DYN_SMEM.sub(
            r"\1* \2 = reinterpret_cast<\1*>(emu_dyn_smem.data());", text)
        (src / f.name).write_text(text)
    procs = {}
    for name, source in cuda_build.SOURCES.items():
        out = src / f"lib{name}.so"
        procs[name] = (out, subprocess.Popen(
            [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-x", "c++",
             f"-I{SHIM}", f"-I{src}", "-o", str(out), str(src / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        sym, argtypes = ENTRIES[name]
        fn = getattr(ctypes.CDLL(str(out)), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@pytest.fixture(scope="module")
def table():
    """A table with a churned join relation (tombstones, revivals and
    overlay rows) and the topics to walk."""
    filters, topics = build_workload(np.random.default_rng(1), 3000, 200)
    deep, deep_topics = build_workload(np.random.default_rng(2), 750, 200,
                                       depth=16)
    inc = IncrementalNfa(depth=16)
    for f in filters + deep + EDGE_FILTERS:
        inc.add(f)
    dev = DeviceNfa(inc, device="cpu")
    dev.enable_join()
    rng = np.random.default_rng(3)
    live = [f for f in inc.accept_filters if f is not None]
    gone = [live[i] for i in rng.choice(len(live), 60, replace=False)]
    for f in gone:
        inc.remove(f)
    for f in gone[:20] + [f"zz{i}/new/+" for i in range(40)]:
        inc.add(f)
    dev.sync()
    start, _word, nxt, overlay = dev._jarrs
    assert (nxt[:int(start[-1])] == -1).any()
    assert (overlay[:, 0] != 2**31 - 1).sum() >= 40
    mixed = EDGE_TOPICS + [f"zz{i}/new/x" for i in range(0, 40, 3)] + [
        t for pair in zip(topics, deep_topics) for t in pair]
    return inc, dev, mixed


def _run(fn, operands, ints, depth, A):
    acc = torch.full((B, accept_cols(depth, A)), -7, dtype=torch.int32)
    aover = torch.full((B,), -7, dtype=torch.int32)
    rc = fn(*(t.data_ptr() for t in operands), *ints, acc.data_ptr(),
            aover.data_ptr(), None)
    assert rc == 0
    return acc, aover


def _batch(inc, topics, depth):
    enc = encode_batch(inc, topics[:B], batch=B, depth=depth)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in enc]


@pytest.mark.parametrize("depth,A", CASES)
def test_hash_kernel_source_equals_plain(emu_kernels, table, depth, A):
    inc, _dev, topics = table
    ops = _batch(inc, topics, depth) + [torch.from_numpy(a) for a in (
        inc.node_tab, inc.edge_tab, inc.seeds)]
    acc, aover = _run(emu_kernels["nfa_walk"], ops,
                      (B, depth, A, inc.edge_tab.shape[0],
                       accept_cols(depth, A)), depth, A)
    acc_p, aover_p = nfa_walk_plain(*ops, active_slots=A)
    assert torch.equal(acc, acc_p)
    assert torch.equal(aover, aover_p)
    if A in (1, 2, 3, 12):
        assert int((aover_p > 0).sum()) > 0, "the spill case must spill"


@pytest.mark.parametrize("depth,A", CASES)
def test_join_kernel_source_equals_plain(emu_kernels, table, depth, A):
    inc, dev, topics = table
    ops = _batch(inc, topics, depth) + [dev.arrays()[0], *dev._jarrs]
    acc, aover = _run(emu_kernels["nfa_join_walk"], ops,
                      (B, depth, A, ops[3].shape[0], ops[5].shape[0],
                       accept_cols(depth, A)), depth, A)
    acc_p, aover_p = join_walk_plain(*ops, active_slots=A)
    assert torch.equal(acc, acc_p)
    assert torch.equal(aover, aover_p)
    if A in (1, 2, 3, 12):
        assert int((aover_p > 0).sum()) > 0, "the spill case must spill"


def _random_tables(seed: int, n_overlay: int, S: int = 96, V: int = 40):
    """A random node table and literal edges (as a cuckoo table and as a
    sorted relation with tombstones and ``n_overlay`` overlay rows) in
    which many states share a `+` child or a literal target, so that a
    frontier holds repeated states; some hash keys sit in both buckets
    with different targets.  Segments of up to V rows take the join's
    halvings before its tail round."""
    rng = np.random.default_rng(seed)
    node = np.zeros((S, 4), np.int32)
    node[:, 0] = np.where(rng.random(S) < 0.9, rng.integers(0, S, S), -1)
    node[:, 1] = np.where(rng.random(S) < 0.4, rng.integers(0, 999, S), -1)
    node[:, 2] = np.where(rng.random(S) < 0.4, rng.integers(0, 999, S), -1)
    keys = [(s, w) for s in range(S) for w in range(1, V + 1)
            if rng.random() < 0.9]
    nxt = rng.integers(0, S, len(keys))
    seeds = np.array([12345, 777], np.int32)
    Hb = 1024
    edge = np.full((Hb, 2, 4), -1, np.int32)
    entries = [(s, w, n) for (s, w), n in zip(keys, nxt.tolist())]
    entries += [(s, w, int(rng.integers(0, S))) for s, w in keys[::9]]
    for s, w, n in entries:
        for k in range(2):
            b = int(_hash_plain(torch.tensor(s), torch.tensor(w),
                                torch.tensor(int(seeds[k])), Hb - 1))
            free = np.flatnonzero(edge[b, :, 0] < 0)
            if free.size:
                edge[b, free[0]] = (s, w, n, 0)
                break
    states = np.array([k[0] for k in keys], np.int32)
    start = np.zeros(S + 1, np.int32)
    start[1:] = np.cumsum(np.bincount(states, minlength=S))
    E = 1 << len(keys).bit_length()
    word = np.zeros(E, np.int32)
    word[:len(keys)] = [k[1] for k in keys]
    nexts = np.full(E, -1, np.int32)
    nexts[:len(keys)] = np.where(rng.random(len(keys)) < 0.85, nxt, -1)
    overlay = np.full((OVERLAY_CAP, 3), 2**31 - 1, np.int32)
    overlay[:, 2] = -1
    picks = sorted({(int(rng.integers(0, S)), int(rng.integers(1, V + 1)))
                    for _ in range(3 * n_overlay)})
    picks = [picks[i] for i in sorted(
        rng.choice(len(picks), n_overlay, replace=False))]
    for i, (s, w) in enumerate(picks):
        overlay[i] = (s, w, int(rng.integers(0, S)))
    return node, edge.reshape(Hb, 8), seeds, (start, word, nexts, overlay)


def _random_batch(seed: int, depth: int, V: int = 40):
    rng = np.random.default_rng(seed)
    words = np.where(rng.random((B, depth)) < 0.95,
                     rng.integers(1, V + 1, (B, depth)),
                     rng.integers(0, V + 2, (B, depth))).astype(np.int32)
    lens = rng.integers(depth - 3, depth + 3, B).astype(np.int32)
    is_sys = rng.random(B) < 0.2
    return [torch.from_numpy(a) for a in (words, lens, is_sys)]


@pytest.mark.parametrize("depth,A,n_overlay", [
    (6, 1, 0), (6, 3, 1), (8, 4, 40), (8, 12, 0), (8, 16, 40), (6, 32, 1)])
def test_kernel_sources_break_ties_like_top_k(emu_kernels, depth, A,
                                              n_overlay):
    node, edge, seeds, relation = _random_tables(depth * A + n_overlay,
                                                 n_overlay)
    batch = _random_batch(depth + A, depth)
    node_t = torch.from_numpy(node)
    ops = batch + [node_t, torch.from_numpy(edge), torch.from_numpy(seeds)]
    acc, aover = _run(emu_kernels["nfa_walk"], ops,
                      (B, depth, A, edge.shape[0], accept_cols(depth, A)),
                      depth, A)
    acc_p, aover_p = nfa_walk_plain(*ops, active_slots=A)
    assert torch.equal(acc, acc_p)
    assert torch.equal(aover, aover_p)
    jops = batch + [node_t] + [torch.from_numpy(a) for a in relation]
    acc, aover = _run(emu_kernels["nfa_join_walk"], jops,
                      (B, depth, A, node.shape[0], relation[1].shape[0],
                       accept_cols(depth, A)), depth, A)
    acc_p, aover_p = join_walk_plain(*jops, active_slots=A)
    assert torch.equal(acc, acc_p)
    assert torch.equal(aover, aover_p)
    assert int((aover_p > 0).sum()) > 0, "the random walk must spill"


def test_launch_shape_is_the_kernels_layout():
    """chip_smoke reports ``launch_shape``: the header's block size and
    one lane per slot, L the smallest power of two >= A."""
    for A, lanes in [(1, 1), (2, 2), (3, 4), (12, 16), (16, 16), (17, 32),
                     (32, 32)]:
        threads, L = launch_shape(A)
        assert L == lanes
        assert threads % 32 == 0 and threads % L == 0


# -- the dense walk (K6) -------------------------------------------------------

def _dense_emu(fn, batch, dense, K):
    """``dense_walk.cu`` through the stand-in on ``batch`` (words, lens,
    is_sys) and the dense operands ``dense`` (lmat, pmat, label, hacc,
    eacc), packed by ``dense_table``: the four ``MatchResult`` fields."""
    words, lens, is_sys = batch
    table, nl, np_ = dense_table(*dense)
    B, D = words.shape
    matches = torch.full((B, K), -7, dtype=torch.int32)
    n, aover, mover = (torch.full((B,), -7, dtype=torch.int32)
                       for _ in range(3))
    rc = fn(words.data_ptr(), lens.data_ptr(), is_sys.data_ptr(),
            table.data_ptr(), B, D, dense[2].shape[0], nl, np_, K,
            matches.data_ptr(), n.data_ptr(), aover.data_ptr(),
            mover.data_ptr(), None)
    assert rc == 0
    return matches, n, aover, mover


def _staged_bytes(dense) -> int:
    """Shared memory a block of ``dense_walk.cu`` needs to stage the
    packed table beside its rows' bitsets (four S-bit sets a row)."""
    S = dense[2].shape[0]
    _table, nl, np_ = dense_table(*dense)
    threads, G = dense_launch_shape(S)
    return (4 * _layout(S, nl, np_)["total"][0]
            + (threads // G) * 16 * (-(-S // 32)))


def _dense_equal(fn, batch, dense, K):
    got = _dense_emu(fn, batch, dense, K)
    want = dense_match_plain(*batch, *dense, max_matches=K)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return want


def _compiled_dense(filters, topics, depth, B):
    tab = compile_filters(filters, depth=depth)
    dense = [torch.from_numpy(a) for a in build_dense(tab).device_arrays()]
    batch = [torch.from_numpy(a) for a in encode_topics(tab, topics[:B],
                                                        batch=B)]
    return batch, dense


@pytest.mark.parametrize("B,K", [(B, 64), (5, 64), (B, 0)])
def test_dense_kernel_source_equals_plain_on_bench_table(emu_kernels, B, K):
    """``bench_dense``'s 420-filter table (S = 2048) and its topics; B = 5
    leaves the second of two blocks with one row, K = 0 puts every row
    with a match past K."""
    filters, _tab, _dense, topics = bench_dense_workload(batch=B)
    batch, dense = _compiled_dense(filters, topics, 8, B)
    assert dense[2].shape[0] == 2048
    want = _dense_equal(emu_kernels["dense_walk"], batch, dense, K)
    assert int(want.n_matches.sum()) > 0
    if K == 0:
        assert int(want.match_overflow.sum()) > 0


def test_dense_kernel_source_equals_plain_on_sys_topics(emu_kernels):
    """Root wildcards and ``$SYS`` filters (no root fire and no root '+'
    for a ``$`` topic), a padding row, the fan topic past K."""
    filters = EDGE_FILTERS[:9] + ["+/status", "$SYS/broker/+"] + FAN_FILTERS
    topics = EDGE_TOPICS + ["$SYS/status", "node/status",
                            "$SYS/broker/uptime", "a/x/c", "a/x/c/d/e"]
    batch, dense = _compiled_dense(filters, topics, 8, len(topics) + 1)
    want = _dense_equal(emu_kernels["dense_walk"], batch, dense, 8)
    assert bool(batch[2].any()) and int(want.match_overflow.sum()) > 0


@pytest.mark.parametrize("S,parents,rows", [(200, 3, B), (256, 1, 37),
                                            (1024, 150, 9)])
def test_dense_kernel_source_equals_plain_on_random_tables(emu_kernels, S,
                                                           parents, rows):
    """Random 0/1 tables with several parents a column (S = 200 fills its
    last 32-column chunk partly; S = 1024 with up to 150 parents a column
    holds more than shared memory, so the kernel reads the tables from
    device memory)."""
    dense = [torch.from_numpy(a) for a in random_dense(S + parents, S,
                                                       parents)]
    assert (_staged_bytes(dense) > 232448) == (S == 1024)
    batch = [torch.from_numpy(a) for a in random_dense_batch(S, rows, 6)]
    want = _dense_equal(emu_kernels["dense_walk"], batch, dense, 16)
    assert int(want.n_matches.sum()) > 0


def _fan_table(S: int = 128) -> DenseTable:
    """A table whose root has 40 literal children, 30 of them under one
    label and 10 under another, and 3 ``+`` children; each of those 43
    states has a literal child (labels 0-2) and every third a ``+`` child
    too; accept ids on most states."""
    lmat = np.zeros((S, S), np.float32)
    pmat = np.zeros((S, S), np.float32)
    label = np.full((S,), _LABEL_NONE, np.int32)
    lmat[0, 1:41] = 1.0
    label[1:31] = 1
    label[31:41] = 2
    pmat[0, 41:44] = 1.0
    for c in range(1, 44):
        lmat[c, 43 + c] = 1.0
        label[43 + c] = c % 3
        if c % 3 == 0:
            pmat[c, 87 + c // 3] = 1.0
    rng = np.random.default_rng(7)
    hacc = np.where(rng.random(S) < 0.6, rng.integers(0, 999, S), -1)
    eacc = np.where(rng.random(S) < 0.6, rng.integers(0, 999, S), -1)
    return DenseTable(lmat, pmat, label, hacc.astype(np.int32),
                      eacc.astype(np.int32))


def test_dense_kernel_source_equals_plain_on_one_label_fan(emu_kernels):
    """One parent with many children under the same label: the binary
    search's equal range sets 30 states at once (rows past K too)."""
    dense = [torch.from_numpy(a) for a in _fan_table()]
    rng = np.random.default_rng(8)
    words = rng.integers(0, 4, (B, 3)).astype(np.int32)
    words[:40, 0] = 1
    batch = [torch.from_numpy(words),
             torch.from_numpy(rng.integers(0, 5, B).astype(np.int32)),
             torch.from_numpy(rng.random(B) < 0.2)]
    traffic = {}
    dense_match_plain(*batch, *dense, max_matches=16, traffic=traffic)
    assert traffic["children"] >= 40 * 30
    want = _dense_equal(emu_kernels["dense_walk"], batch, dense, 16)
    assert int(want.match_overflow.sum()) > 0


@pytest.mark.parametrize("S,parents,rows", [(512, 3, 40), (2048, 60, 9)])
def test_dense_kernel_source_equals_plain_on_a_wide_frontier(emu_kernels, S,
                                                             parents, rows):
    """One label for every literal edge and one word, so every literal
    child of an active state goes on: frontiers of dozens of states (S =
    2048, up to 60 parents a column, is too large to stage)."""
    dense = [torch.from_numpy(a)
             for a in random_dense(S * 3 + parents, S, parents, V=1)]
    assert (_staged_bytes(dense) > 232448) == (S == 2048)
    batch = [torch.from_numpy(a)
             for a in random_dense_batch(S + rows, rows, 6, V=1)]
    traffic = {}
    dense_match_plain(*batch, *dense, max_matches=64, traffic=traffic)
    assert traffic["states"] >= 24 * traffic["steps"] > 0
    want = _dense_equal(emu_kernels["dense_walk"], batch, dense, 64)
    assert int(want.n_matches.sum()) > 0


# -- the flat epilogue (K3) ---------------------------------------------------

#: (D, A) of the flat epilogue's cases: C = 446, 190, 62 and 18 columns
FLAT_SHAPES = [(16, 16), (8, 16), (4, 16), (8, 1)]


def _flat_emu(fn, acc, aover, K, cap):
    """``flat_epilogue.cu`` through the stand-in: ``(matches, n, mover,
    row_meta)``."""
    rows, C = acc.shape
    matches = torch.full((cap,), -7, dtype=torch.int32)
    n, mover, meta = (torch.full((rows,), -7, dtype=torch.int32)
                      for _ in range(3))
    tiles = torch.full((max(1, -(-rows // FLAT_TILE_ROWS)),), -7,
                       dtype=torch.int32)
    rc = fn(acc.data_ptr(), aover.data_ptr(), rows, C, K, cap,
            matches.data_ptr(), n.data_ptr(), mover.data_ptr(),
            meta.data_ptr(), tiles.data_ptr(), None)
    assert rc == 0
    return matches, n, mover, meta


def _flat_equal(fn, acc, aover, K, cap):
    want = flat_epilogue_plain(acc, aover, K, cap)
    for f, g, w in zip(("matches", "n", "mover", "row_meta"),
                       _flat_emu(fn, acc, aover, K, cap), want):
        assert torch.equal(g, w), f
    return want


def test_flat_tile_rows_is_the_kernels():
    """The wrapper sizes its scratch by the source's tile."""
    src = (cuda_build.CSRC / "flat_epilogue.cu").read_text()
    rows = int(re.search(r"#define EPI_ROWS (\d+)", src).group(1))
    assert rows == FLAT_TILE_ROWS


@pytest.mark.parametrize("K", [32, 64, 128])
@pytest.mark.parametrize("depth,A", FLAT_SHAPES)
def test_flat_epilogue_source_equals_plain(emu_kernels, depth, A, K):
    """Every field bit for bit: rows past K (where C > K), rows with
    spills, B = 101
    (no whole number of tiles), a roomy cap, a cap that ends inside a
    row's segment (whole rows and part of a row dropped), a cap of one
    id, and an all-empty batch."""
    fn = emu_kernels["flat_epilogue"]
    C = accept_cols(depth, A)
    acc, aover = (torch.from_numpy(a) for a in random_accepts(
        depth * 1000 + A * 10 + K, B, C))
    want = _flat_equal(fn, acc, aover, K, 8 * B)
    n = want[1]
    nk = torch.clamp(n, max=K)
    assert bool((n > K).any()) == (C > K) and bool((aover > 0).any())
    offs = torch.cumsum(nk, 0) - nk
    inside = int(torch.nonzero(nk >= 2)[len(nk) // 3 % int(
        (nk >= 2).sum())])
    cap = int(offs[inside]) + 1
    got = _flat_equal(fn, acc, aover, K, cap)
    dropped = (offs >= cap) & (nk > 0)
    assert bool(dropped.any()) and int(got[2][inside]) == 1
    _flat_equal(fn, acc, aover, K, 1)
    empty = torch.full_like(acc, -1)
    got = _flat_equal(fn, empty, aover, K, 2 * B)
    assert int(got[1].sum()) == 0 and bool((got[0] == -1).all())


def test_dense_launch_shape_is_the_kernels():
    """chip_smoke reports ``launch_shape``: the source's block size and
    G lanes a row, about one frontier word a lane."""
    for S, lanes in [(128, 8), (256, 8), (257, 16), (512, 16), (513, 32),
                     (4096, 32)]:
        threads, G = dense_launch_shape(S)
        assert G == lanes and threads % 32 == 0
