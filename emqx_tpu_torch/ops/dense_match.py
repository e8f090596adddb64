"""The dense walk of a multi-hot frontier (K6): the small-table match engine.

The port of ``emqx_tpu/ops/dense_match.py``.  Active-state sets are
multi-hot rows ``active (B, S)`` instead of id lists, so the walk has no
active-set cap and never spills: it is exact where the hash walk fails
open (``active_overflow`` is always 0).  One step of the walk:

* literal edges: ``L[parent, child] = 1``; a child survives only if the
  topic word at this level equals its edge label (``label (S,)``);
* ``+`` edges: ``P[state, plus_child] = 1``, with no root ``+`` for
  ``$`` topics at t = 0;
* accepts are bitmaps: ``ever-active ∧ has-hash-accept`` (no root fire
  for ``$`` topics) and ``active-at-len ∧ has-end-accept``, compacted to
  the first K ids, every state's hash accept in state order, then every
  state's end accept.

:func:`dense_match_plain` repeats the reference's arithmetic step by step
(``active @ lmat`` and ``active @ pmat`` in bf16, ``> 0.5``), as PyTorch
ops on any device.  :func:`dense_match` runs it for CPU tensors; for CUDA
tensors it launches ``csrc/dense_walk.cu``, which computes the whole
function in one launch, or raises.  The kernel does not multiply the
S×S matrices: ``> 0.5`` after a sum of 0/1 values is an OR, so "state c
is active iff some active state has c as a ``+`` child, or as a literal
child whose label equals the word".  The wrapper turns ``lmat`` and
``pmat`` into each state's literal children sorted by (label, child) and
its ``+`` children, packed with the accept ids and their bitmaps into
one int32 buffer (:func:`dense_table`), once per table, on the card; the
kernel pushes from the active states of a frontier held as an S-bit set,
finding a literal edge by a binary search.  This is exact for any 0/1
matrix, several parents a column and several children a label included.
"""

from __future__ import annotations

import ctypes
import re
import time
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from . import cuda_build
from .compiler import NfaTable
from .match_kernel import MatchResult, _compact

__all__ = ["DenseTable", "build_dense", "dense_match", "dense_match_plain",
           "supports_dense", "bench_dense", "DENSE_STATE_CAP"]

#: above this many states the reference's S² matmuls lost to its gather
#: kernel on the same small table (the reference's own TPU sweep); kept
#: so that the tiered matcher picks the same engine and hot roots
DENSE_STATE_CAP = 512
_LABEL_NONE = -7            # never equals a word id (those are >= 0)

#: launches of the dense-walk kernel since the count was last reset (set
#: it to 0 to reset)
launches = 0

#: packed tables of recent ``(lmat, pmat, label, hacc, eacc)`` on the card
_TABLE_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_TABLE_CACHE_SIZE = 4
_entry_fn = None

#: C entry point of the kernel and its ctypes arguments: 4 operand
#: pointers (words, lens, is_sys, the packed table), 6 ints (B, D, S,
#: literal and ``+`` child counts, K), 4 output pointers and the stream
_ENTRY = ("dense_walk_launch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
          + [ctypes.c_void_p] * 5)


class DenseTable(NamedTuple):
    """Operands of the dense walk (host numpy until shipped)."""

    lmat: np.ndarray        # (S, S) f32 0/1 — literal edge parent→child
    pmat: np.ndarray        # (S, S) f32 0/1 — plus edge parent→child
    label: np.ndarray       # (S,) i32 — incoming literal word id, -7 none
    hacc: np.ndarray        # (S,) i32 — hash-accept id, -1 none
    eacc: np.ndarray        # (S,) i32 — end-accept id, -1 none

    @property
    def S(self) -> int:
        return int(self.label.shape[0])

    def device_arrays(self):
        return (self.lmat, self.pmat, self.label, self.hacc, self.eacc)


def supports_dense(table: NfaTable,
                   state_cap: int = DENSE_STATE_CAP) -> bool:
    return table.n_states <= state_cap


def build_dense(table: NfaTable, min_s: int = 128) -> DenseTable:
    """Dense operands from the compiled table; S is padded to a power
    of two ≥ live states (not ``table.S``, whose cuckoo layout pads far
    wider)."""
    n = max(table.n_states, 1)
    S = min_s
    while S < n:
        S <<= 1
    lmat = np.zeros((S, S), np.float32)
    pmat = np.zeros((S, S), np.float32)
    label = np.full((S,), _LABEL_NONE, np.int32)
    hacc = np.full((S,), -1, np.int32)
    eacc = np.full((S,), -1, np.int32)
    node = table.node_tab
    hacc[:min(S, node.shape[0])] = node[:min(S, node.shape[0]), 1]
    eacc[:min(S, node.shape[0])] = node[:min(S, node.shape[0]), 2]
    plus = node[:n, 0]
    src = np.nonzero(plus >= 0)[0]
    pmat[src, plus[src]] = 1.0
    slots = table.edge_tab.reshape(-1, 4)
    live = slots[slots[:, 2] >= 0]          # [state, word, next, 0]
    lmat[live[:, 0], live[:, 2]] = 1.0
    label[live[:, 2]] = live[:, 1]
    return DenseTable(lmat, pmat, label, hacc, eacc)


# -- plain version ----------------------------------------------------------

def dense_match_plain(words, lens, is_sys, lmat, pmat, label, hacc, eacc, *,
                      max_matches: int = 32,
                      traffic: Optional[Dict[str, int]] = None
                      ) -> MatchResult:
    """The reference's dense walk as PyTorch ops, on any device: bf16
    matmuls of the multi-hot frontier, step by step.  A ``traffic`` dict
    receives, for the kernel's bound, ``steps``, the row steps for which
    the CUDA kernel computes a next frontier (t < min(D, len) with a
    state active), ``states``, the active states it expands on them, and
    ``children``, the states those steps make active."""
    B, D = words.shape
    S = label.shape[0]
    dev = words.device
    dt = torch.bfloat16
    if traffic is not None:
        traffic.update(steps=0, states=0, children=0)
    lmat = lmat.to(dt)
    pmat = pmat.to(dt)
    not_sys = ~is_sys[:, None]
    active = torch.zeros((B, S), dtype=dt, device=dev)
    active[:, 0] = 1.0
    acc_h = torch.zeros((B, S), dtype=torch.bool, device=dev)
    acc_e = torch.zeros((B, S), dtype=torch.bool, device=dev)
    for t in range(D + 1):
        a = active > 0.5
        fire = a if t else a & not_sys           # $-topics: no root fire
        acc_h = acc_h | fire
        acc_e = acc_e | (a & (lens == t)[:, None])
        if t == D:
            break
        going = (t < lens) & a.any(dim=1)
        if traffic is not None:
            traffic["steps"] += int(going.sum())
            traffic["states"] += int(a[going].sum())
        lit_in = active @ lmat
        plus_src = active if t else active * not_sys.to(dt)
        plus_in = plus_src @ pmat
        wmatch = words[:, t:t + 1] == label[None, :]
        nxt = torch.where(wmatch, lit_in, torch.zeros((), dtype=dt,
                                                       device=dev)) + plus_in
        active = ((t < lens)[:, None] & (nxt > 0.5)).to(dt)
        if traffic is not None:
            traffic["children"] += int((active > 0.5).sum())
    cand = torch.cat(
        [torch.where(acc_h & (hacc >= 0)[None, :], hacc[None, :], -1),
         torch.where(acc_e & (eacc >= 0)[None, :], eacc[None, :], -1)],
        dim=1).to(torch.int32)                   # (B, 2S)
    n = (cand >= 0).sum(dim=1, dtype=torch.int32)
    return MatchResult(
        matches=_compact(cand, max_matches),
        n_matches=n,
        active_overflow=torch.zeros((B,), dtype=torch.int32, device=dev),
        match_overflow=(n > max_matches).to(torch.int32))


# -- the kernel -------------------------------------------------------------

def _entry():
    """The bound C entry point of ``csrc/dense_walk.cu``, built at first
    use."""
    global _entry_fn
    if _entry_fn is None:
        sym, argtypes = _ENTRY
        fn = getattr(cuda_build.load("dense_walk"), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entry_fn = fn
    return _entry_fn


def launch_shape(S: int) -> Tuple[int, int]:
    """``(threads per block, lanes per row)`` of ``csrc/dense_walk.cu``
    at S states: its ``DENSE_THREADS`` and G = 8, 16 or 32, about one
    frontier word a lane."""
    src = (cuda_build.CSRC / "dense_walk.cu").read_text()
    threads = int(re.search(r"#define DENSE_THREADS (\d+)", src).group(1))
    nw = (S + 31) // 32
    return threads, 8 if nw <= 8 else 16 if nw <= 16 else 32


def _layout(S: int, nl: int, np_: int) -> Dict[str, Tuple[int, int]]:
    """``name → (offset, length)`` in ints of each segment of the packed
    table, each padded to a multiple of 4 ints (16 B): the ``layout`` of
    ``csrc/dense_walk.cu``, in its order."""
    nw = (S + 31) // 32
    out, off = {}, 0
    for name, n in (("lptr", S + 1), ("llab", nl), ("lchild", nl),
                    ("pptr", S + 1), ("pchild", np_), ("hacc", S),
                    ("eacc", S), ("hmask", nw), ("emask", nw)):
        out[name] = (off, n)
        off += -(-n // 4) * 4
    out["total"] = (off, 0)
    return out


def _children(mat: torch.Tensor, label: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parent → children of a 0/1 matrix: ``(ptr (S+1,), child (nnz,))``
    int32, each state's children by ascending child id, or, given
    ``label``, by ascending ``(label[child], child)``."""
    S = mat.shape[0]
    p, c = (mat != 0).nonzero(as_tuple=True)   # by parent, then child
    if label is not None:
        order = torch.sort(label[c], stable=True).indices
        order = order[torch.sort(p[order], stable=True).indices]
        p, c = p[order], c[order]
    ptr = torch.zeros((S + 1,), dtype=torch.int32, device=mat.device)
    ptr[1:] = torch.cumsum(torch.bincount(p, minlength=S), dim=0)
    return ptr, c.to(torch.int32)


def _bitmap(valid: torch.Tensor) -> torch.Tensor:
    """(S,) bool → (ceil(S/32),) int32 words, bit j of word k set iff
    ``valid[32k + j]``."""
    S = valid.shape[0]
    nw = (S + 31) // 32
    v = torch.zeros((nw * 32,), dtype=torch.int64, device=valid.device)
    v[:S] = valid.to(torch.int64)
    shift = torch.arange(32, dtype=torch.int64, device=valid.device)
    w = (v.view(nw, 32) << shift).sum(dim=1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def dense_table(lmat, pmat, label, hacc, eacc
                ) -> Tuple[torch.Tensor, int, int]:
    """``(table, nl, np)``: the packed int32 buffer the kernel walks
    (:func:`_layout`: each state's literal children sorted by (label,
    child) with their labels, its ``+`` children, both accept-id vectors
    and their bitmaps) and the literal and ``+`` child counts.  Built on
    the operands' device at the first call for a table (one host sync,
    as a table upload has) and kept for the next calls.  Raises
    ValueError for a matrix entry other than 0 or 1."""
    ops = (lmat, pmat, label, hacc, eacc)
    key = tuple((t.data_ptr(), t._version, tuple(t.shape), t.dtype)
                for t in ops) + (str(lmat.device),)
    hit = _TABLE_CACHE.get(key)
    if hit is not None:
        _TABLE_CACHE.move_to_end(key)
        return hit[1]
    for name, m in (("lmat", lmat), ("pmat", pmat)):
        if not bool(((m == 0) | (m == 1)).all()):
            raise ValueError(f"{name} holds an entry other than 0 or 1")
    S = label.shape[0]
    lptr, lchild = _children(lmat, label)
    pptr, pchild = _children(pmat)
    parts = {"lptr": lptr, "llab": label[lchild.long()], "lchild": lchild,
             "pptr": pptr, "pchild": pchild, "hacc": hacc, "eacc": eacc,
             "hmask": _bitmap(hacc >= 0), "emask": _bitmap(eacc >= 0)}
    nl, np_ = int(lchild.shape[0]), int(pchild.shape[0])
    lay = _layout(S, nl, np_)
    table = torch.zeros((lay["total"][0],), dtype=torch.int32,
                        device=lmat.device)
    for name, part in parts.items():
        off, n = lay[name]
        table[off:off + n] = part
    out = (table, nl, np_)
    # the operands stay referenced, so their storage (and key) stays theirs
    _TABLE_CACHE[key] = (ops, out)
    while len(_TABLE_CACHE) > _TABLE_CACHE_SIZE:
        _TABLE_CACHE.popitem(last=False)
    return out


def _check(words, lens, is_sys, lmat, pmat, label, hacc, eacc, K) -> None:
    dev = words.device
    S = label.shape[0] if label.dim() == 1 else -1
    for name, t, dtypes, shape in [
            ("words", words, (torch.int32,), None),
            ("lens", lens, (torch.int32,), (words.shape[0],)),
            ("is_sys", is_sys, (torch.bool,), (words.shape[0],)),
            ("lmat", lmat, (torch.float32, torch.bfloat16), (S, S)),
            ("pmat", pmat, (torch.float32, torch.bfloat16), (S, S)),
            ("label", label, (torch.int32,), (S,)),
            ("hacc", hacc, (torch.int32,), (S,)),
            ("eacc", eacc, (torch.int32,), (S,))]:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, words on {dev}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name}: want {dtypes}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: want shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if words.dim() != 2:
        raise ValueError("words must be 2-d (B, D)")
    if S < 1:
        raise ValueError("label must be 1-d with at least one state")
    if K < 0:
        raise ValueError(f"max_matches {K} < 0")


def dense_match(words, lens, is_sys, lmat, pmat, label, hacc, eacc, *,
                max_matches: int = 32) -> MatchResult:
    """The dense walk of one encoded batch: ``MatchResult`` with the
    ``(B, K)`` compact ``matches``, ``n_matches``, ``active_overflow``
    (always 0) and ``match_overflow`` (``n > K``).  CPU tensors run
    :func:`dense_match_plain`; CUDA tensors launch ``csrc/dense_walk.cu``
    on the current stream (outputs allocated here) or raise."""
    dev = words.device
    if dev.type == "cpu":
        return dense_match_plain(words, lens, is_sys, lmat, pmat, label,
                                 hacc, eacc, max_matches=max_matches)
    if dev.type != "cuda":
        raise ValueError(f"dense_match runs on cuda or cpu, not {dev}")
    K = int(max_matches)
    _check(words, lens, is_sys, lmat, pmat, label, hacc, eacc, K)
    table, nl, np_ = dense_table(lmat, pmat, label, hacc, eacc)
    B, D = words.shape
    S = label.shape[0]
    matches = torch.empty((B, K), dtype=torch.int32, device=dev)
    n, aover, mover = (torch.empty((B,), dtype=torch.int32, device=dev)
                       for _ in range(3))
    if B:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _entry()(
                words.data_ptr(), lens.data_ptr(), is_sys.data_ptr(),
                table.data_ptr(), B, D, S, nl, np_, K, matches.data_ptr(),
                n.data_ptr(), aover.data_ptr(), mover.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"dense_walk launch failed: cudaError {rc}")
        global launches
        launches += 1
    return MatchResult(matches=matches, n_matches=n, active_overflow=aover,
                       match_overflow=mover)


def bench_dense_workload(n_filters: int = 420, batch: int = 4096,
                         depth: int = 8):
    """``bench_dense``'s seeded table and batch: ``(filters, table, dense,
    topics)``, the reference's draws in its order (seed 11)."""
    from .compiler import compile_filters

    rng = np.random.default_rng(11)
    filters = sorted({
        f"r{rng.integers(40)}/"
        + "/".join(("+" if rng.random() < 0.3 else f"w{rng.integers(30)}")
                   for _ in range(rng.integers(1, depth - 2)))
        + ("/#" if rng.random() < 0.2 else "")
        for _ in range(n_filters)})
    table = compile_filters(filters, depth=depth)
    dense = build_dense(table)
    topics = [f"r{rng.integers(40)}/" +
              "/".join(f"w{rng.integers(30)}"
                       for _ in range(rng.integers(1, depth - 1)))
              for _ in range(batch)]
    return filters, table, dense, topics


def random_dense(seed: int, S: int, parents: int, V: int = 4) -> DenseTable:
    """A seeded random 0/1 table: up to ``parents`` parents a column in
    ``lmat`` (nine columns in ten) and in ``pmat`` (three in ten), mostly
    from the first third of the states so that the root reaches far, a
    tenth from anywhere (cycles; a repeated parent counts once); labels
    in [0, V) where a column has a literal parent; accept ids on about a
    third of the states.  The kernel's OR of several parents against the
    reference's bf16 sums."""
    rng = np.random.default_rng(seed)
    lmat = np.zeros((S, S), np.float32)
    pmat = np.zeros((S, S), np.float32)
    for mat, share in ((lmat, 0.9), (pmat, 0.3)):
        k = np.where(rng.random(S) < share, rng.integers(1, parents + 1, S),
                     0)
        for c in range(1, S):
            lo = max(1, c // 3)
            ps = np.where(rng.random(k[c]) < 0.9, rng.integers(0, lo, k[c]),
                          rng.integers(0, S, k[c]))
            mat[ps, c] = 1.0
    label = np.where(lmat.any(axis=0), rng.integers(0, V, S), _LABEL_NONE)
    hacc = np.where(rng.random(S) < 0.3, rng.integers(0, 999, S), -1)
    eacc = np.where(rng.random(S) < 0.3, rng.integers(0, 999, S), -1)
    return DenseTable(lmat, pmat, label.astype(np.int32),
                      hacc.astype(np.int32), eacc.astype(np.int32))


def random_dense_batch(seed: int, B: int, D: int, V: int = 4):
    """A seeded batch for :func:`random_dense` tables: ``(words (B, D),
    lens (B,), is_sys (B,))`` with words in [0, V), lengths 0..D+2 (D+2
    is a padding row's) and a fifth of the rows ``$`` topics."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (B, D)).astype(np.int32),
            rng.integers(0, D + 3, B).astype(np.int32), rng.random(B) < 0.2)


def _time_ms(fn, iters: int, device: torch.device) -> float:
    """ms per call of ``fn`` after one warm-up call: CUDA events around
    ``iters`` calls on the card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def bench_dense(n_filters: int = 420, batch: int = 4096, iters: int = 20,
                depth: int = 8, *,
                device: Union[None, str, torch.device] = None) -> dict:
    """Dense walk against the hash walk on the same small table, the
    hot-tier engine decision measurement (device ms from CUDA events on
    the card, the host clock on the CPU).  Sized near
    ``DENSE_STATE_CAP`` states, the regime the tier runs in."""
    from .compiler import encode_topics
    from .device_table import resolve_device
    from .match_kernel import nfa_match

    dev = resolve_device(device)
    filters, table, dense, topics = bench_dense_workload(n_filters, batch,
                                                         depth)
    words, lens, is_sys = encode_topics(table, topics, batch=batch)
    batch_t = [torch.from_numpy(a).to(dev) for a in (words, lens, is_sys)]
    gargs = [torch.from_numpy(a).to(dev) for a in table.device_arrays()]
    dargs = [torch.from_numpy(a).to(dev) for a in dense.device_arrays()]
    out = {"device": str(dev), "n_filters": len(filters),
           "n_states": table.n_states, "dense_S": dense.S, "batch": batch}

    def gather():
        return nfa_match(*batch_t, *gargs, active_slots=8,
                         compact_output=True, max_matches=64)

    def dense_call():
        return dense_match(*batch_t, *dargs, max_matches=64)

    out["gather_ms"] = _time_ms(gather, iters, dev)
    out["dense_ms"] = _time_ms(dense_call, iters, dev)
    out["dense_topics_per_s"] = batch / (out["dense_ms"] / 1e3)
    out["speedup_vs_gather"] = out["gather_ms"] / out["dense_ms"]
    # parity on the measured batch (sets; gather rows that spilled are
    # left out: dense cannot spill)
    r, d = gather(), dense_call()
    ga = r.matches.cpu().numpy()
    da = d.matches.cpu().numpy()
    skip = ((r.active_overflow > 0) | (r.match_overflow > 0)
            | (d.match_overflow > 0)).cpu().numpy()
    out["parity_mismatches"] = sum(
        1 for i in range(len(topics))
        if not skip[i] and set(ga[i][ga[i] >= 0]) != set(da[i][da[i] >= 0]))
    return out


if __name__ == "__main__":
    print(bench_dense())
