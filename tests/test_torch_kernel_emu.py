"""The CUDA sources of both walk kernels, built with g++ against a CPU
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
ranks' tie-break to top_k, with an overlay of 0, 1 and 40 rows.  It says nothing of speed, and
``tests/test_torch_cuda.py`` remains the test on the card.  Skips where
g++ is missing."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from emqx_tpu_torch.ops import DeviceNfa, IncrementalNfa, encode_batch
from emqx_tpu_torch.ops import cuda_build
from emqx_tpu_torch.ops.walk_kernel import (
    _ENTRY, OVERLAY_CAP, _hash_plain, accept_cols, join_walk_plain,
    launch_shape, nfa_walk_plain)
from emqx_tpu_torch.workload import build_workload

SHIM = cuda_build.CSRC.parents[2] / "tests" / "cuda_emu"
LAUNCH = re.compile(r"(\w+)<<<\s*(.*?),\s*NFA_THREADS,\s*0,\s*"
                    r"\(cudaStream_t\)stream>>>\(", re.S)
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
    """Both kernel sources, launches rewritten for the stand-in, built
    into shared libraries (one g++ each, started together); returns the
    bound C entry points by kernel name."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    src = tmp_path_factory.mktemp("csrc")
    for f in cuda_build.CSRC.iterdir():
        (src / f.name).write_text(LAUNCH.sub(r"emu_launch(\1, \2, NFA_THREADS, ",
                                             f.read_text()))
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
        sym, argtypes = _ENTRY[name]
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
