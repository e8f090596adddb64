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
the last block partly filled.  The flat mode of both walk sources (the
flat epilogue, K3, fused into the walk: per-row lists in shared memory,
a block scan and a decoupled look-back over tile states) is held to the
plain walk and ``flat_epilogue_plain`` on all five ``MatchResult``
fields at (D, A) = (16, 16), (8, 16), (4, 16), (8, 32) and (8, 1) (row
lists past 48 KB of shared memory): rows past K, a cap that cuts one
row mid-way and drops the later ones, a cap past every id (the -1 tail),
B = 1, B = 101 (no whole number of tiles, several tiles), ``$`` topics,
one state buffer across launches (no memset between them).  A
look-back that would wait for a tile that never publishes ends the
launch with the stand-in's fault.  The four kernels of the fan-out's
bitmaps (``bitmap_fanout.cu``) are held to their plain versions: an OR
of gathered rows with its popcount (a tile of the row partly filled,
ids all -1, a window of rows, a column slice, more ids than a block),
the compaction (rows past ``cap_row``, an empty and a full row, rounds
of words not a multiple of the block), the group counts and the
hashed pick (a partly filled last block, negative hashes, an empty
group).  The routing grid and the merge of the multichip and prefix-EP
steps (``ep_route.cu``) are held to their plain versions on every
field: K8a's owner map with negative and out-of-map root words, rows
past the depth, buckets past capacity, source slices of several rounds
of the block, the landed layout of one device and the per-source
layout; K8c's floor remainder; the merge's routed, compact, replicated
(two row groups, a migrated micro owner) and identity forms, with rows
past K, micro rows past Km, aid maps holding -1 and empty landed
slots.  It says nothing of speed, and
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
from emqx_tpu_torch.ops import bitmap_kernel as bk
from emqx_tpu_torch.ops import route_kernel as rk
# the module (``emqx_tpu_torch.ops.dense_match`` is the function)
dense_mod = importlib.import_module("emqx_tpu_torch.ops.dense_match")
from emqx_tpu_torch.ops.dense_match import (
    _LABEL_NONE, DenseTable, _layout, bench_dense_workload, build_dense,
    dense_match_plain, dense_table, random_dense, random_dense_batch)
from emqx_tpu_torch.ops.dense_match import launch_shape as dense_launch_shape
from emqx_tpu_torch.ops.walk_kernel import (
    _ENTRY, OVERLAY_CAP, FlatScratch, _hash_plain, accept_cols,
    join_walk_flat_plain, join_walk_plain, launch_shape, nfa_walk_flat_plain,
    nfa_walk_plain)
from emqx_tpu_torch.workload import build_workload

SHIM = cuda_build.CSRC.parents[2] / "tests" / "cuda_emu"
LAUNCH = re.compile(r"(\w+)<<<\s*(.*?),\s*(\w+),\s*(\w+),\s*"
                    r"\(cudaStream_t\)stream>>>\(", re.S)
DYN_SMEM = re.compile(r"extern __shared__ (\w+) (\w+)\[\];")
#: each C entry point: (library, symbol, ctypes arguments)
ENTRIES = {**_ENTRY, "dense_walk": ("dense_walk", *dense_mod._ENTRY),
           **bk._ENTRY}
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
    together); returns the bound C entry points by name, and each
    library's ``emu_fault_message`` as ``fault.<library>``."""
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
    libs, fns = {}, {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        libs[name] = ctypes.CDLL(str(out))
        fault = libs[name].emu_fault_message
        fault.restype = ctypes.c_char_p
        fns[f"fault.{name}"] = fault
    for name, (lib, sym, argtypes) in ENTRIES.items():
        fn = getattr(libs[lib], sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    for name in rk._ENTRY:
        fns[name] = rk.bind(libs["ep_route"], name)
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


# -- flat mode: the flat epilogue (K3) fused into both walks -----------------

FIELDS = ("matches", "n_matches", "active_overflow", "match_overflow",
          "row_meta")
#: (D, A) of the flat cases: C = 446, 190, 62 and 190 accept slots a row;
#: 8, 8, 8 and 4 rows a block (13, 13, 13 and 26 tiles at B = 101)
FLAT_SHAPES = [(16, 16), (8, 16), (4, 16), (8, 32)]


def _flat_emu(emu, name, ops, ints, A, K, cap, scratch, base_shift=0):
    """Flat entry ``name`` through the stand-in on ``ops``: the five
    fields, or the stand-in's fault as an AssertionError.  The launch
    takes ``scratch`` as the wrapper does (``base_shift`` moves the ticket
    base it is given)."""
    B = ops[0].shape[0]
    outs = [torch.full((cap,), -7, dtype=torch.int32)] + [
        torch.full((B,), -7, dtype=torch.int32) for _ in range(4)]
    threads, lanes = launch_shape(A)
    tiles = -(-B // (threads // lanes))
    state, base, epoch = scratch.reserve(tiles)
    rc = emu[name](*(t.data_ptr() for t in ops), *ints, K, cap,
                   *(o.data_ptr() for o in outs), state.data_ptr(),
                   (base + base_shift) & 0xFFFFFFFF, epoch, None)
    lib = ENTRIES[name][0]
    assert rc == 0, (rc, emu[f"fault.{lib}"]().decode())
    scratch.commit(tiles)
    return outs


def _flat_inputs(table, backend, depth, rows):
    """The entry name, operands and int arguments of a flat launch of the
    ``table`` fixture's first ``rows`` topics, and its plain version."""
    inc, dev, topics = table
    enc = encode_batch(inc, topics[:rows], batch=rows, depth=depth)
    batch = [torch.from_numpy(np.ascontiguousarray(a)) for a in enc]
    if backend == "hash":
        ops = batch + [torch.from_numpy(a) for a in (
            inc.node_tab, inc.edge_tab, inc.seeds)]
        return ("nfa_walk_flat", ops,
                (rows, depth, None, inc.edge_tab.shape[0]),
                nfa_walk_flat_plain)
    ops = batch + [dev.arrays()[0], *dev._jarrs]
    return ("nfa_join_walk_flat", ops,
            (rows, depth, None, ops[3].shape[0], ops[5].shape[0]),
            join_walk_flat_plain)


def _flat_equal(emu, table, backend, depth, A, K, caps, rows=B,
                scratch=None):
    """The flat entry of ``backend`` against its plain version at each
    cap of ``caps(n)`` (n the plain rows' counts), all five fields bit
    for bit, on one state buffer; returns the plain results."""
    name, ops, ints, plain = _flat_inputs(table, backend, depth, rows)
    ints = tuple(A if x is None else x for x in ints)
    scratch = scratch or FlatScratch("cpu")
    roomy = plain(*ops, active_slots=A, max_matches=K, flat_cap=1)
    wants = []
    for cap in caps(roomy[1]):
        got = _flat_emu(emu, name, ops, ints, A, K, cap, scratch)
        want = plain(*ops, active_slots=A, max_matches=K, flat_cap=cap)
        for f, g, w in zip(FIELDS, got, want):
            assert torch.equal(g, w), (f, cap)
        wants.append(want)
    return wants


def _caps(K):
    """Caps of a batch whose rows count ``n``: past every id by 37 (the -1
    tail starts off a 16 B boundary), exactly every id, one inside a row
    of two or more ids (it cuts that row and drops the later ones), one
    id."""
    def caps(n):
        nk = torch.clamp(n, max=K)
        offs = torch.cumsum(nk, 0) - nk
        total = int(nk.sum())
        inside = torch.nonzero(nk >= 2).flatten()
        return [total + 37, max(total, 1),
                int(offs[inside[len(inside) // 3]]) + 1, 1]
    return caps


@pytest.mark.parametrize("depth,A", FLAT_SHAPES)
@pytest.mark.parametrize("backend", ["hash", "join"])
def test_flat_walk_source_equals_plain(emu_kernels, table, backend, depth,
                                       A):
    """Both K (4: rows past K; 128, the serve K) and each cap of
    :func:`_caps`, eight launches on one state buffer; the batch holds
    ``$`` topics and spills at A = 16 and 32 are checked as found."""
    scratch = FlatScratch("cpu")
    for K in (4, 128):
        got = _flat_equal(emu_kernels, table, backend, depth, A, K,
                          _caps(K), scratch=scratch)
        roomy, exact, cut, _one = got
        n = roomy[1]
        nk = torch.clamp(n, max=K)
        offs = torch.cumsum(nk, 0) - nk
        assert int(nk.sum()) > 0
        assert bool((roomy[0][int(nk.sum()):] == -1).all())
        if K == 4:
            assert bool((n > K).any()), "no row past K"
        cap = int(cut[0].shape[0])
        assert bool(((offs >= cap) & (nk > 0)).any()), "no row dropped"
        assert bool(((offs < cap) & (offs + nk > cap)).any()), "no row cut"
    assert scratch.epoch == 8


@pytest.mark.parametrize("backend", ["hash", "join"])
def test_flat_walk_source_one_row(emu_kernels, table, backend):
    """B = 1: one tile, which is also the last and fills the tail."""
    _flat_equal(emu_kernels, table, backend, 8, 16, 128,
                lambda n: [8, 1, 3], rows=1)


@pytest.mark.parametrize("backend", ["hash", "join"])
def test_flat_walk_source_row_lists_past_48k(emu_kernels, table, backend):
    """A = 1: 128 rows a block, so K = 128 needs 64 KB of row lists (the
    opt-in past 48 KB); B = 300 is three tiles, the last partly filled."""
    from emqx_tpu_torch.ops.walk_kernel import flat_smem_bytes

    assert flat_smem_bytes(1, 128) > 48 * 1024
    _flat_equal(emu_kernels, table, backend, 8, 1, 128, _caps(128),
                rows=300)


def test_flat_lookback_that_would_wait_is_a_fault(emu_kernels, table):
    """A ticket base one short makes the first block tile 1, whose
    look-back would wait for tile 0 forever: the stand-in ends the launch
    with a fault and its reason, where a spin would hang the suite."""
    name, ops, ints, _plain = _flat_inputs(table, "hash", 8, B)
    ints = tuple(16 if x is None else x for x in ints)
    with pytest.raises(AssertionError, match="look-back waited"):
        _flat_emu(emu_kernels, name, ops, ints, 16, 128, 8 * B,
                  FlatScratch("cpu"), base_shift=-1)


def test_flat_scratch_tickets_and_epochs():
    """The wrapper's bookkeeping: each launch a new epoch and the tickets
    of the launches before; a buffer grown or out of epochs is a new
    zeroed one, counted from zero."""
    sc = FlatScratch("cpu")
    state, base, epoch = sc.reserve(13)
    assert (state.numel(), base, epoch) == (14, 0, 1)
    sc.commit(13)
    state.fill_(5)
    again, base, epoch = sc.reserve(4)
    assert again is state and (base, epoch) == (13, 2)
    sc.commit(4)
    grown, base, epoch = sc.reserve(40)
    assert grown.numel() == 41 and not bool(grown.any())
    assert (base, epoch) == (0, 1)
    sc.commit(40)
    sc.epoch = 0xFFFFFFFF
    fresh, base, epoch = sc.reserve(40)
    assert fresh is not grown and (base, epoch) == (0, 1)


def test_dense_launch_shape_is_the_kernels():
    """chip_smoke reports ``launch_shape``: the source's block size and
    G lanes a row, about one frontier word a lane."""
    for S, lanes in [(128, 8), (256, 8), (257, 16), (512, 16), (513, 32),
                     (4096, 32)]:
        threads, G = dense_launch_shape(S)
        assert G == lanes and threads % 32 == 0


# -- the fan-out's bitmap kernels (bitmap_fanout.cu) ---------------------------

I32 = torch.int32


def _bits(rng, shape, density):
    """int32 bit patterns with each bit set with probability
    ``density``."""
    b = rng.random(shape + (32,)) < density
    words = (b * (1 << np.arange(32, dtype=np.uint64))).sum(-1)
    return torch.from_numpy(words.astype(np.uint32).view(np.int32))


def _accept_or_emu(emu, bitmap, ids, lo):
    rows, W = bitmap.shape
    B, K = ids.shape
    out = torch.full((B, W), -7, dtype=I32)
    popc = torch.zeros((B,), dtype=I32)
    rc = emu["accept_or"](bitmap.data_ptr(), rows, W, bitmap.stride(0),
                          ids.data_ptr(), B, K, lo, out.data_ptr(),
                          popc.data_ptr(), None)
    assert rc == 0
    return out, popc


@pytest.mark.parametrize("W,K,lo,rows", [
    (300, 200, 0, 97),    # three tiles, the last 44 words; two id rounds
    (79, 16, 0, 97),      # one tile, 79 of 128 threads
    (150, 40, 30, 40),    # a ring window [30, 70): others read nothing
    (5, 1, 0, 8)])
def test_accept_or_source_equals_plain(emu_kernels, W, K, lo, rows):
    rng = np.random.default_rng(W + K)
    wide = _bits(rng, (rows, W + 37), 0.05)
    bitmap = wide[:, 37:]            # a column slice, rows W + 37 apart
    B = 7
    ids = rng.integers(-1, lo + rows + 20, (B, K)).astype(np.int32)
    ids[2] = -1                       # a row of no ids
    ids[3, : K // 2] = rng.integers(lo, lo + rows, K // 2)
    ids = torch.from_numpy(ids)
    got = _accept_or_emu(emu_kernels, bitmap, ids, lo)
    want = bk.accept_or_plain(bitmap, ids, lo)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[1][2]) == 0 and int(want[1].sum()) > 0


def test_accept_or_source_all_ids_invalid(emu_kernels):
    """Ids all -1 give zero rows and counts, though every bitmap row
    (the last, a sentinel's place, among them) has bits set."""
    rng = np.random.default_rng(3)
    bitmap = _bits(rng, (20, 130), 0.5)
    assert bool((bitmap != 0).any(dim=1).all())
    ids = torch.full((5, 8), -1, dtype=I32)
    got = _accept_or_emu(emu_kernels, bitmap, ids, 0)
    assert not bool(got[0].any()) and not bool(got[1].any())
    want = bk.accept_or_plain(bitmap, ids, 0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("W,cap,base", [(300, 10_000, 0), (300, 17, 3 * 79 * 32),
                                        (79, 64, 79 * 32), (79, 0, 0),
                                        (1, 5, 2**31 - 40)])
def test_bitmap_compact_source_equals_plain(emu_kernels, W, cap, base):
    """Rows of every density: empty, full, sparse and dense; a cap past
    every id, rows past the cap, a cap of 0, ids that wrap past int32."""
    rng = np.random.default_rng(W + cap)
    B = 6
    bitmap = torch.cat([_bits(rng, (1, W), d)
                        for d in (0.0, 1.0, 0.01, 0.2, 0.5, 0.03)])
    ids = torch.full((B, cap), -7, dtype=I32)
    counts, over = (torch.full((B,), -7, dtype=I32) for _ in range(2))
    rc = emu_kernels["bitmap_compact"](
        bitmap.data_ptr(), B, W, bitmap.stride(0), cap, bk._i32(base),
        ids.data_ptr(), counts.data_ptr(), over.data_ptr(), None)
    assert rc == 0
    want = bk.bitmap_compact_plain(bitmap, cap, base)
    for g, w in zip((ids, counts, over), want):
        assert torch.equal(g, w)
    assert int(want[1][0]) == 0 and int(want[1][1]) == 32 * W
    if 0 < cap < 32 * W:
        assert bool(want[2].any())


def _group_inputs(seed, B, G, W, tp):
    """A bitmap, masks (the last group empty) and hashes (some negative),
    with each of ``tp`` column shards' counts, the total and each
    shard's exclusive prefix, as the selector computes them."""
    rng = np.random.default_rng(seed)
    bitmap = _bits(rng, (B, W * tp), 0.3)
    bitmap[1] = 0                     # a row with no candidate
    masks = _bits(rng, (G, W * tp), 0.2)
    masks[-1] = 0
    sel = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, B)
                           .astype(np.int32))
    sel[: B // 2] = sel[: B // 2].abs()
    counts = [bk.group_count_plain(bitmap[:, t * W:(t + 1) * W],
                                   masks[:, t * W:(t + 1) * W])
              for t in range(tp)]
    total = sum(counts)
    before = [sum(counts[:t], torch.zeros_like(total)) for t in range(tp)]
    return bitmap, masks, sel, counts, total, before


@pytest.mark.parametrize("B,G,W,tp", [(7, 5, 79, 4), (3, 3, 40, 2),
                                      (9, 16, 10, 1)])
def test_group_kernels_source_equal_plain(emu_kernels, B, G, W, tp):
    """Each shard's counts and picks against the plain versions (B·G
    pairs fill the last block partly; W past one warp's 32 words); the
    picks of all shards, max-reduced, name one member of each group that
    has candidates."""
    bitmap, masks, sel, counts, total, before = _group_inputs(
        B * G + W, B, G, W, tp)
    picks = []
    for t in range(tp):
        bl, ml = bitmap[:, t * W:(t + 1) * W], masks[:, t * W:(t + 1) * W]
        got = torch.full((B, G), -7, dtype=I32)
        rc = emu_kernels["group_count"](bl.data_ptr(), bl.stride(0),
                                        ml.data_ptr(), ml.stride(0), B, G, W,
                                        got.data_ptr(), None)
        assert rc == 0 and torch.equal(got, counts[t])
        pick = torch.full((B, G), -7, dtype=I32)
        rc = emu_kernels["group_pick"](
            bl.data_ptr(), bl.stride(0), ml.data_ptr(), ml.stride(0), B, G,
            W, sel.data_ptr(), total.data_ptr(), before[t].data_ptr(),
            counts[t].data_ptr(), t * W, pick.data_ptr(), None)
        assert rc == 0
        want = bk.group_pick_plain(bl, ml, sel, total, before[t], counts[t],
                                   t * W)
        assert torch.equal(pick, want)
        picks.append(pick)
    picked = torch.stack(picks).amax(0)
    assert bool(((picked >= 0) == (total > 0)).all())
    assert bool((picked[:, -1] == -1).all()) and bool((picked[1] == -1).all())


# -- the one-device ring and Ulysses steps (ring_or, ulysses_or) -------------

def _raw_rows(rng, B, C, hi):
    """Raw accept rows ``(B, C)`` as a walk leaves them: -1 empty slots
    and ids in ``[0, hi + 20)`` (some past the bitmap's ``hi`` rows, which
    read nothing); row 0 every slot valid (more than K), row 1 none, row
    2 only ids past the bitmap, row 3 one valid slot at the end."""
    acc = np.where(rng.random((B, C)) < 0.3, rng.integers(0, hi + 20, (B, C)),
                   -1)
    acc[0] = rng.integers(0, hi, C)
    acc[1] = -1
    acc[2] = np.where(np.arange(C) % 3 == 0, hi + np.arange(C) % 7, -1)
    acc[3] = -1
    acc[3, -1] = hi - 1
    return torch.from_numpy(acc.astype(np.int32))


def _ring_or_emu(emu, acc, bitmap, ring, K, cap):
    (B, C), (rows, W) = acc.shape, bitmap.shape
    out = torch.full((B, W), -7, dtype=I32)
    trunc = torch.full((B,), -7, dtype=I32)
    rc = emu["ring_or"](acc.data_ptr(), B, C, bitmap.data_ptr(), rows, W,
                        bitmap.stride(0), rows // ring, ring, K,
                        -1 if cap is None else cap, out.data_ptr(),
                        trunc.data_ptr(), None)
    assert rc == 0
    return out, (None if cap is None else trunc)


@pytest.mark.parametrize("W,C,K,ring,cap,B", [
    (300, 446, 128, 4, 64, 7),     # three word tiles (the last 44 words),
    #                                C over four blocks, a cap cut mid-word
    (300, 446, 128, 4, None, 7),   # the plain form
    (79, 130, 16, 2, 1, 6),        # a cap of 1, one tile partly filled
    (150, 40, 40, 3, 10_000, 5),   # a cap past every bit, K = C
    (5, 7, 3, 1, 0, 4),            # ring 1, cap 0: every window over
    (200, 60, 200, 8, 9, 5)])      # eight windows, K past C
def test_ring_or_source_equals_plain(emu_kernels, W, C, K, ring, cap, B):
    """``ring_or`` against ``ring_or_plain`` on a column-sliced bitmap
    (rows W + 37 apart), both forms: rows past K, none valid, only ids
    past the bitmap, one id."""
    rng = np.random.default_rng(W + C + K)
    rows = 40 * ring
    bitmap = _bits(rng, (rows, W + 37), 0.05)[:, 37:]
    acc = _raw_rows(rng, B, C, rows)
    got = _ring_or_emu(emu_kernels, acc, bitmap, ring, K, cap)
    want = bk.ring_or_plain(acc, bitmap, ring, K, cap)
    assert torch.equal(got[0], want[0])
    if cap is None:
        assert want[1] is None
        return
    assert torch.equal(got[1], want[1])
    assert not bool(want[0][1].any()) and not bool(want[0][2].any())
    if 0 < cap < 100:
        assert int(want[1].max()) > 0
        # a cut window keeps part of its partial: a subset of the plain OR
        full = bk.ring_or_plain(acc, bitmap, ring, K)[0]
        assert bool(((want[0] & ~full) == 0).all())
        assert not torch.equal(want[0], full)
    if cap == 10_000:
        assert int(want[1].max()) == 0
        assert torch.equal(want[0], bk.ring_or_plain(acc, bitmap, ring, K)[0])


def _ulysses_or_emu(emu, acc, aover, bitmap, U, K):
    (B, C), (rows, W) = acc.shape, bitmap.shape
    disp = torch.full((U, B, W // U), -7, dtype=I32)
    counts = torch.full((W * 32,), -7, dtype=I32)
    meta = torch.full((2 * B,), -7, dtype=I32)
    rc = emu["ulysses_or"](acc.data_ptr(), aover.data_ptr(), B, C,
                           bitmap.data_ptr(), rows, W, bitmap.stride(0), K, U,
                           disp.data_ptr(), counts.data_ptr(),
                           meta.data_ptr(), None)
    assert rc == 0
    return disp, counts, meta[:B], meta[B:]


@pytest.mark.parametrize("W,U,C,K,B", [
    (316, 4, 446, 128, 6),   # the served width: W/U = 79, three tiles
    (300, 4, 130, 16, 7),    # W/U = 75, no multiple of the block
    (8, 8, 40, 40, 5),       # a word a part, K = C
    (160, 2, 7, 3, 4)])      # rows of more valid slots than K
def test_ulysses_or_source_equals_plain(emu_kernels, W, U, C, K, B):
    """``ulysses_or`` against ``ulysses_or_plain`` on a column-sliced
    bitmap, every field; its counts start from -7 (the entry zeroes
    them)."""
    rng = np.random.default_rng(W + U + C)
    rows = 97
    bitmap = _bits(rng, (rows, W + 5), 0.05)[:, 5:]
    acc = _raw_rows(rng, B, C, rows)
    aover = torch.from_numpy(rng.integers(0, 3, B).astype(np.int32))
    got = _ulysses_or_emu(emu_kernels, acc, aover, bitmap, U, K)
    want = bk.ulysses_or_plain(acc, aover, bitmap, U, K)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[2][0]) == C > K or K >= C
    assert int(want[1].sum()) == sum(
        int(bk.popcount32(want[0][u]).sum()) for u in range(U)) > 0


# -- the routing grid and the merge (ep_route.cu) ------------------------------

def _route_case(seed, rows, D, tp, owner_map):
    """A batch with hot owners, negative and out-of-map root words and
    rows past the depth (lens D+1 and the pad's D+2), and an owner map
    over 40 root words, two of them owned outside the mesh (not routed;
    None: K8c's floor remainder)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 40, (rows, D)).astype(np.int32)
    words[::3, 0] = 3                         # one hot root
    words[1::11, 0] = -rng.integers(1, 9, len(words[1::11]))
    words[2::13, 0] = 40 + rng.integers(0, 1000, len(words[2::13]))
    lens = rng.integers(1, D + 1, rows).astype(np.int32)
    lens[3::9] = D + 1
    lens[4::17] = D + 2
    is_sys = rng.random(rows) < 0.2
    wo = None
    if owner_map:                 # two roots owned outside the mesh
        wo = rng.integers(0, tp, 40).astype(np.int32)
        wo[[5, 7]] = (-1, tp)
        wo = torch.from_numpy(wo)
    return (torch.from_numpy(words), torch.from_numpy(lens),
            torch.from_numpy(is_sys), wo)


def _route_outputs(rows, slots, D, ld):
    """Grid and per-row outputs, every int -7 and every flag True: what
    the kernel leaves alone must stay so."""
    grid = rk.RouteGrid(torch.full((slots, D), -7, dtype=I32),
                        torch.full((slots,), -7, dtype=I32),
                        torch.ones((slots,), dtype=torch.bool),
                        torch.full((slots,), -7, dtype=I32))
    outs = dict(fill_ids=torch.full((rows, ld), -7, dtype=I32),
                zeros=[torch.full((rows, w), -7, dtype=I32)
                       for w in (3, 1)],
                flag=torch.full((rows,), -7, dtype=I32),
                owner_out=torch.full((rows,), -7, dtype=I32))
    return grid, outs


@pytest.mark.parametrize("tp,C,Bs,n_src,landed,owner_map", [
    (4, 3, 10, 4, True, True),      # buckets past capacity, one device
    (4, 40, 300, 2, True, True),    # two rounds of the block, no overflow
    (2, 100, 300, 4, True, True),   # dp 2: four sources, a row group each two
    (4, 3, 10, 4, False, True),     # the per-source layout (several cards)
    (4, 5, 37, 4, True, False),     # K8c: w0 % E, every row routable
    (3, 200, 290, 1, False, False)])
def test_ep_route_source_equals_plain(emu_kernels, tp, C, Bs, n_src, landed,
                                      owner_map):
    D = 6
    rows = n_src * Bs + 5
    words, lens, is_sys, wo = _route_case(tp * Bs + C, rows, D, tp,
                                          owner_map)
    R = tp * C
    if landed:      # (group, owner, source, C), sources in groups of tp
        sources = [(b * Bs, ((b // tp) * tp * tp + b % tp) * C)
                   for b in range(n_src)]
        so, slots = R, -(-n_src // tp) * tp * R
    else:           # (source, owner, C)
        sources, so, slots = [(b * Bs, b * R) for b in range(n_src)], C, \
            n_src * R
    got = _route_outputs(rows, slots, D, 9)
    want = _route_outputs(rows, slots, D, 9)
    kw = dict(tp=tp, C=C, Bs=Bs, sources=sources, so=so)
    a = rk.route_args(words, lens, is_sys, wo, got[0], **kw, **got[1])
    assert emu_kernels["ep_route"](ctypes.byref(a), None) == 0
    rk.ep_route_plain(words, lens, is_sys, wo, want[0], **kw, **want[1])
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)
    for k in ("fill_ids", "flag", "owner_out"):
        assert torch.equal(got[1][k], want[1][k]), k
    for g, w in zip(got[1]["zeros"], want[1]["zeros"]):
        assert torch.equal(g, w)
    landed_rows = int((want[0].src >= 0).sum())
    over = int((want[1]["flag"] == 1).sum())
    assert landed_rows > 0
    if C < 10:
        assert over > 0
    assert bool((want[1]["flag"][n_src * Bs:] == -7).all())


def _raw_slots(rng, rows, cols, dense_rows=()):
    """Raw accept slots: mostly -1, a few ids a row, every id of the
    rows in ``dense_rows``."""
    acc = np.where(rng.random((rows, cols)) < 0.03,
                   rng.integers(0, 50, (rows, cols)), -1)
    for r in dense_rows:
        acc[r] = rng.integers(0, 50, cols)
    return torch.from_numpy(acc.astype(np.int32))


def _merge_pairs(seed, n_pairs, rows, cols, routed, micro, maps, C, Bs):
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(n_pairs):
        amap = mamap = None
        if maps:
            am = rng.integers(0, 10_000, 50).astype(np.int32)
            am[::9] = -1                       # a dead aid
            amap = torch.from_numpy(am)
            mamap = torch.from_numpy(rng.integers(0, 10_000, 37)
                                     .astype(np.int32))
        src = None
        if routed:
            # slot (source i, c) of owner k: one of source i's rows, each
            # row landing once over all owners; the rest empty
            s = np.full((rows // C, C), -1, np.int32)
            for i in range(rows // C):
                perm = np.random.default_rng(seed * 100 + i).permutation(Bs)
                for c in range(C):
                    if k * C + c < Bs and rng.random() < 0.8:
                        s[i, c] = perm[k * C + c]
            src = torch.from_numpy(s.reshape(-1))
        pairs.append(rk.MergePair(
            _raw_slots(rng, rows, cols, (1, 2)),
            torch.from_numpy(rng.integers(0, 3, rows).astype(np.int32)),
            _raw_slots(rng, rows, cols, (2, 3)) if micro else None,
            torch.from_numpy(rng.integers(0, 2, rows).astype(np.int32))
            if micro else None, amap, mamap, src, 0, 0, micro))
    return pairs


def _merge_out(n_rows, segs, W, with_counts=True):
    full = lambda *shape: torch.full(shape, -7, dtype=I32)  # noqa: E731
    if not with_counts:
        return rk.MergeOut(full(n_rows, W), None, None, full(n_rows),
                           None, None)
    return rk.MergeOut(full(n_rows, segs * W), full(n_rows, segs),
                       full(n_rows, segs), full(n_rows), full(n_rows),
                       full(n_rows))


@pytest.mark.parametrize("form", ["routed", "routed_compact", "replicated",
                                  "replicated_dp2", "identity"])
def test_ep_merge_source_equals_plain(emu_kernels, form):
    K, Km, cols = 5, 2, 300
    tp, C = 4, 3
    Bs = 7
    routed = form.startswith("routed") or form == "identity"
    micro = form != "identity"
    if form == "identity":
        Km = 0
        cols = 70
    rows = tp * C if routed else 9
    pairs = _merge_pairs(len(form), tp if form != "replicated_dp2" else 2 * tp,
                         rows, cols, routed, micro, form != "identity", C, Bs)
    segs = 1 if form in ("routed_compact", "identity") else tp
    if routed:
        pairs = [p._replace(seg=0 if segs == 1 else o, row_base=0)
                 for o, p in enumerate(pairs)]
        n_rows = tp * Bs
    else:
        owner = 1 if form == "replicated_dp2" else 0
        pairs = [p._replace(seg=k % tp, row_base=(k // tp) * rows,
                            micro=k % tp == owner)
                 for k, p in enumerate(pairs)]
        n_rows = rows * (len(pairs) // tp)
    W = K + Km
    got = _merge_out(n_rows, segs, W, form != "identity")
    want = _merge_out(n_rows, segs, W, form != "identity")
    kw = dict(routed=routed, K=K, Km=Km, C=C, Bs=Bs, segs=segs)
    a = rk.merge_args(pairs, got, **kw)
    assert emu_kernels["ep_merge"](ctypes.byref(a), None) == 0
    rk.ep_merge_plain(pairs, want, **kw)
    for name, g, w in zip(want._fields, got, want):
        if w is not None:
            assert torch.equal(g, w), name
    # rows past K and micro rows past Km were merged and flagged
    assert int(want.nm.max()) > K
    if routed:
        assert bool((want.nm == -7).any())   # rows no slot landed on
    else:
        assert not bool((want.ids == -7).any())
