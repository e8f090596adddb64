"""The fused NFA walks: two CUDA kernels and their plain versions.

:func:`nfa_walk` (hash backend) is the port of the reference's Pallas kernel
``emqx_tpu/ops/pallas_match.py`` ``_kernel`` (with ``_walk_tile`` and
``_hash``): the whole (D+1)-step walk of a topic batch over the node
table and the cuckoo edge table, returning the raw accept slots of
``nfa_match(compact_output=False)`` and the per-row active-set spill.
On CUDA tensors it launches ``csrc/nfa_walk.cu``; on CPU tensors it runs
:func:`nfa_walk_plain`, the same walk as PyTorch ops.  A CUDA tensor gets
the kernel or an exception, never the plain version.

:func:`join_walk` (``join`` and ``join-pallas`` backends) is the port of
``pallas_match._join_kernel``: the same walk, with each literal edge
found by a lower bound over the sorted CSR relation and its sorted
overlay (``join_match``) in place of the two cuckoo probes.  It
launches ``csrc/nfa_join_walk.cu`` or runs :func:`join_walk_plain`, by
the same rule.  Both plain versions share one walk skeleton with the
lookup as an argument, as both kernels share ``csrc/walk_common.cuh``.

Layout (shared with the reference, so the two agree bit for bit): the
frontier width starts at 1 and doubles each step up to A; step t writes
``w_t`` hash-accept columns then ``w_t`` end-accept columns; when 2·w_t
exceeds A the next frontier is the A largest candidate states in
descending order (``top_k``).  Both kernels walk a row with one lane
per frontier slot (:func:`launch_shape`).

:func:`nfa_walk_flat` and :func:`join_walk_flat` are the flat mode of
``nfa_match`` / ``join_match`` (``flat_cap`` > 0) in one launch: the same
walks with the reference's flat epilogue (K3, the XLA function
``match_kernel.flat_epilogue`` with ``_compact``) fused in, each row's
ids placed by a single-pass scan with a decoupled look-back
(``csrc/walk_common.cuh``).  Their plain version is the plain walk and
``match_kernel.flat_epilogue_plain``.  The look-back's state words live
in a :class:`FlatScratch` of the launch's stream.
"""

from __future__ import annotations

import ctypes
import functools
import re
import threading
from typing import Dict, Optional, Tuple

import torch

from .compiler import BUCKET_SLOTS
from . import cuda_build

__all__ = ["FlatScratch", "accept_cols", "flat_smem_bytes", "join_walk",
           "join_walk_flat", "join_walk_flat_plain", "join_walk_plain",
           "launch_shape", "nfa_walk", "nfa_walk_flat",
           "nfa_walk_flat_plain", "nfa_walk_plain", "MAX_ACTIVE_SLOTS",
           "OVERLAY_CAP"]

#: widest frontier the CUDA kernels take (one warp's lanes a row)
MAX_ACTIVE_SLOTS = 32

#: launches of the hash-walk kernel since the count was last reset (set
#: it to 0 to reset)
launches = 0

#: launches of the join-walk kernel, counted the same way
join_launches = 0

#: flat-mode launches of either walk kernel (the flat epilogue, K3, fused
#: in), counted the same way; each also counts in ``launches`` or
#: ``join_launches``
flat_launches = 0

#: rows of the join relation's sorted overlay, which the join kernel
#: stages in shared memory; the walk searches them per slot, so the
#: size rides every dispatch (log2 steps)
OVERLAY_CAP = 256

_U32 = 0xFFFFFFFF
_entries: Dict[str, object] = {}


@functools.lru_cache(maxsize=None)
def _block_threads() -> int:
    header = (cuda_build.CSRC / "walk_common.cuh").read_text()
    return int(re.search(r"#define NFA_THREADS (\d+)", header).group(1))


def launch_shape(active_slots: int) -> Tuple[int, int]:
    """``(threads per block, lanes per row)`` of both walk kernels: the
    block size ``NFA_THREADS`` of ``csrc/walk_common.cuh`` (read once)
    and the smallest power of two >= A, one lane per frontier slot."""
    return _block_threads(), 1 << (active_slots - 1).bit_length()


def accept_cols(depth: int, active_slots: int) -> int:
    """C = Σ_t 2·w_t, the raw accept-slot count of one row."""
    cols = 0
    w = 1
    for _ in range(depth + 1):
        cols += 2 * w
        w = min(2 * w, active_slots)
    return cols


# -- plain version ----------------------------------------------------------

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a · c) mod 2³² for int64 ``a`` in [0, 2³²): split ``c`` in 16-bit
    halves so that no int64 product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _hash_plain(state, word, seed, mask: int):
    """``pallas_match._hash`` in int64 masked to 32 bits: the uint32 mix
    with wraparound (a negative state or word is taken as its uint32)."""
    h = (_mul32(state & _U32, 2654435761) + _mul32(word & _U32, 2246822519)
         + (seed & _U32)) & _U32
    h = h ^ (h >> 16)
    h = _mul32(h, 3266489917)
    h = h ^ (h >> 13)
    return h & mask


def _lookup_plain(active, word, live, edge_tab, seeds, traffic=None):
    """Literal edge of each (state, word): the max ``next`` over matching
    slots of both cuckoo buckets, -1 on a miss.  ``traffic`` counts the
    two bucket rows the kernel gathers for each ``live`` slot."""
    B, w = active.shape
    mask = int(edge_tab.shape[0]) - 1
    s64 = active.long()
    w64 = word.long()
    best = None
    for k in range(2):
        b = _hash_plain(s64, w64, seeds[k].long(), mask)
        rows = edge_tab[b].view(B, w, BUCKET_SLOTS, 4)
        hit = (rows[..., 0] == active[..., None]) & (
            rows[..., 1] == word[..., None])
        got = torch.where(hit, rows[..., 2], -1).amax(dim=-1)
        best = got if best is None else torch.maximum(best, got)
    if traffic is not None:
        traffic["bucket_rows"] += 2 * int(live.sum())
    return best


def _lower_bound(lo, hi, less, steps: int, count: bool = False):
    """``steps`` masked halvings of ``[lo, hi)`` toward the first row
    that is not ``less`` than the query: the reference's unrolled lower
    bound, in which a slot stops moving once ``lo == hi``.  Returns
    ``(lo, probes)``, ``probes`` the per-slot count of rows read when
    ``count`` is set, else None."""
    probes = torch.zeros_like(lo) if count else None
    for _ in range(steps):
        act = lo < hi
        mid = (lo + hi) >> 1
        right = act & less(mid)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(act & ~right, mid, hi)
        if count:
            probes += act
    return lo, probes


def _join_lookup_plain(active, word, live, state_start, edge_word,
                       edge_next, overlay, traffic=None):
    """``join_match._join_edge_lookup`` of the reference: the lower bound
    of ``word`` in the state's CSR segment of ``edge_word`` (a hit gives
    ``edge_next``, -1 for a tombstone), then a lower bound of (state,
    word) over the sorted overlay rows, and the max of the two.
    ``traffic`` counts what the kernel loads for each ``live`` slot: one
    CSR bound pair, each ``edge_word`` probe, the ``edge_next`` of a
    hit (the overlay sits in shared memory)."""
    E = int(edge_word.shape[0])
    sa = active.clamp(min=0).long()
    lo = state_start[sa]
    hi0 = state_start[sa + 1]

    def word_less(mid):
        return edge_word[mid.clamp(0, E - 1).long()] < word

    lo, probes = _lower_bound(lo, hi0, word_less, max(1, E.bit_length()),
                              count=traffic is not None)
    pos = lo.clamp(0, E - 1).long()
    hit = (lo < hi0) & (edge_word[pos] == word)
    nxt = torch.where(hit, edge_next[pos], -1)

    cap = int(overlay.shape[0])
    o_state, o_word, o_next = overlay[:, 0], overlay[:, 1], overlay[:, 2]

    def pair_less(mid):
        m = mid.clamp(0, cap - 1).long()
        ms, mw = o_state[m], o_word[m]
        return (ms < active) | ((ms == active) & (mw < word))

    olo, _ = _lower_bound(torch.zeros_like(active),
                          torch.full_like(active, cap), pair_less,
                          max(1, cap.bit_length()))
    opos = olo.clamp(0, cap - 1).long()
    ohit = (olo < cap) & (o_state[opos] == active) & (o_word[opos] == word)
    nxt_o = torch.where(ohit, o_next[opos], -1)
    if traffic is not None:
        traffic["csr_pairs"] += int(live.sum())
        traffic["word_probes"] += int(probes[live].sum())
        traffic["next_reads"] += int((hit & live).sum())
    return torch.maximum(nxt, nxt_o)


def _walk_plain(words, lens, is_sys, node_tab, lookup, A: int, traffic):
    """The (D+1)-step walk with the literal lookup as an argument (the
    reference's ``_walk_tile`` factoring): ``lookup(active, word, live,
    traffic)`` gives the literal edge of each slot, where ``live`` marks
    the valid slots before the topic's end (those the kernel looks up).
    ``traffic["node_rows"]`` counts one node row per valid slot and
    step."""
    B, D = words.shape
    dev = words.device
    active = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    aover = torch.zeros((B,), dtype=torch.int32, device=dev)
    sys_col = is_sys[:, None]
    cols = []
    for t in range(D + 1):
        valid = active >= 0
        if traffic is not None:
            traffic["node_rows"] += int(valid.sum())
        node = node_tab[active.clamp(min=0).long()]        # (B, w, 4)
        hacc = torch.where(valid, node[..., 1], -1)
        if t == 0:
            hacc = torch.where(sys_col, -1, hacc)
        eacc = torch.where(valid & (lens == t)[:, None], node[..., 2], -1)
        cols += [hacc, eacc]
        if t == D:
            break
        word = words[:, t:t + 1].expand(B, active.shape[1])
        live = valid & (t < lens)[:, None]
        lit = torch.where(valid, lookup(active, word, live, traffic), -1)
        plus = torch.where(valid, node[..., 0], -1)
        if t == 0:
            plus = torch.where(sys_col, -1, plus)
        cand = torch.cat([lit, plus], dim=1)
        cand = torch.where((t < lens)[:, None], cand, -1)
        if cand.shape[1] <= A:
            active = cand
        else:
            active = torch.topk(cand, A, dim=1).values
            aover += ((cand >= 0).sum(dim=1, dtype=torch.int32)
                      - (active >= 0).sum(dim=1, dtype=torch.int32))
    return torch.cat(cols, dim=1), aover


def nfa_walk_plain(words, lens, is_sys, node_tab, edge_tab, seeds, *,
                   active_slots: int, traffic: Optional[Dict[str, int]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hash walk as PyTorch ops, on any device: ``(acc (B, C) int32,
    aover (B,) int32)``.  A ``traffic`` dict receives the table rows the
    CUDA kernel gathers on these inputs: ``node_rows`` (one per valid
    slot and step) and ``bucket_rows`` (two per valid slot and step
    before the topic's end), for the kernel's bound."""
    if traffic is not None:
        traffic.update(node_rows=0, bucket_rows=0)

    def lookup(active, word, live, tr):
        return _lookup_plain(active, word, live, edge_tab, seeds, tr)

    return _walk_plain(words, lens, is_sys, node_tab, lookup, active_slots,
                       traffic)


def join_walk_plain(words, lens, is_sys, node_tab, state_start, edge_word,
                    edge_next, overlay, *, active_slots: int,
                    traffic: Optional[Dict[str, int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The join walk as PyTorch ops, on any device: the same outputs as
    :func:`nfa_walk_plain`, with the literal edge from the sorted
    relation.  A ``traffic`` dict receives what the CUDA kernel loads on
    these inputs: ``node_rows`` (16 B each), ``csr_pairs`` (8 B each),
    ``word_probes`` and ``next_reads`` (4 B each)."""
    if traffic is not None:
        traffic.update(node_rows=0, csr_pairs=0, word_probes=0,
                       next_reads=0)

    def lookup(active, word, live, tr):
        return _join_lookup_plain(active, word, live, state_start,
                                  edge_word, edge_next, overlay, tr)

    return _walk_plain(words, lens, is_sys, node_tab, lookup, active_slots,
                       traffic)


# -- the kernels ------------------------------------------------------------

#: C entry point of each kernel: its library (a ``cuda_build.SOURCES``
#: name), its symbol and ctypes arguments: the operand pointers (6 hash,
#: 8 join), the int shape arguments, then the raw mode's two output
#: pointers, or flat mode's K and flat_cap, five output pointers, the
#: state pointer and two unsigned ints (ticket base, epoch); the stream
_ENTRY = {
    "nfa_walk": ("nfa_walk", "nfa_walk_launch", [ctypes.c_void_p] * 6
                 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3),
    "nfa_join_walk": ("nfa_join_walk", "nfa_join_walk_launch",
                      [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                      + [ctypes.c_void_p] * 3),
    "nfa_walk_flat": ("nfa_walk", "nfa_walk_flat_launch",
                      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                      + [ctypes.c_void_p] * 6 + [ctypes.c_uint] * 2
                      + [ctypes.c_void_p]),
    "nfa_join_walk_flat": ("nfa_join_walk", "nfa_join_walk_flat_launch",
                           [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p] * 6 + [ctypes.c_uint] * 2
                           + [ctypes.c_void_p]),
}


def _entry(name: str):
    """The bound C entry point ``name`` of ``_ENTRY``, built at first
    use."""
    fn = _entries.get(name)
    if fn is None:
        lib, sym, argtypes = _ENTRY[name]
        fn = getattr(cuda_build.load(lib), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _check_operands(words, lens, is_sys, node_tab, tables, A: int) -> None:
    """Device, dtype, rank and contiguity of the batch operands, the node
    table and the ``(name, tensor, dtype, ndim)`` entries of ``tables``
    (all on the device of ``words``), the batch shapes and the frontier
    width."""
    dev = words.device
    for name, t, dtype, ndim in [
            ("words", words, torch.int32, 2), ("lens", lens, torch.int32, 1),
            ("is_sys", is_sys, torch.bool, 1),
            ("node_tab", node_tab, torch.int32, 2)] + tables:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, words on {dev}")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{name}: want {ndim}-d {dtype}, got "
                             f"{t.dim()}-d {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, D = words.shape
    if lens.shape[0] != B or is_sys.shape[0] != B:
        raise ValueError("lens / is_sys length differs from the batch")
    if node_tab.shape[1] != 4:
        raise ValueError(f"node table width {node_tab.shape[1]}: want 4")
    if node_tab.data_ptr() % 16:
        raise ValueError("node table must be 16-byte aligned")
    if not 1 <= A <= MAX_ACTIVE_SLOTS:
        raise ValueError(f"active_slots {A} outside [1, {MAX_ACTIVE_SLOTS}]")
    if D < 1:
        raise ValueError("depth must be >= 1")


def _check(words, lens, is_sys, node_tab, edge_tab, seeds, A: int) -> None:
    _check_operands(words, lens, is_sys, node_tab, [
        ("edge_tab", edge_tab, torch.int32, 2),
        ("seeds", seeds, torch.int32, 1)], A)
    Hb = edge_tab.shape[0]
    if edge_tab.shape[1] != 4 * BUCKET_SLOTS:
        raise ValueError(f"edge table widths {edge_tab.shape[1]}: want "
                         f"{4 * BUCKET_SLOTS}")
    if Hb < 1 or Hb & (Hb - 1):
        raise ValueError(f"edge table rows {Hb} not a power of two")
    if seeds.shape[0] != 2:
        raise ValueError("seeds must hold 2 values")
    if edge_tab.data_ptr() % 16:
        raise ValueError("edge table must be 16-byte aligned")


def _check_join(words, lens, is_sys, node_tab, state_start, edge_word,
                edge_next, overlay, A: int) -> None:
    _check_operands(words, lens, is_sys, node_tab, [
        ("state_start", state_start, torch.int32, 1),
        ("edge_word", edge_word, torch.int32, 1),
        ("edge_next", edge_next, torch.int32, 1),
        ("overlay", overlay, torch.int32, 2)], A)
    S = node_tab.shape[0]
    if state_start.shape[0] != S + 1:
        raise ValueError(f"state_start holds {state_start.shape[0]} "
                         f"offsets for {S} states: want S+1")
    E = edge_word.shape[0]
    if E < 1 or edge_next.shape[0] != E:
        raise ValueError(f"edge_word / edge_next lengths {E}, "
                         f"{edge_next.shape[0]}: want equal and >= 1")
    if tuple(overlay.shape) != (OVERLAY_CAP, 3):
        raise ValueError(f"overlay shape {tuple(overlay.shape)}: want "
                         f"({OVERLAY_CAP}, 3)")


def _outputs(words, A: int):
    B, D = words.shape
    acc = torch.empty((B, accept_cols(D, A)), dtype=torch.int32,
                      device=words.device)
    aover = torch.empty((B,), dtype=torch.int32, device=words.device)
    return acc, aover


def _launch(name: str, words, operands, ints, acc, aover) -> None:
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry(name)(*(t.data_ptr() for t in operands), *ints,
                          acc.data_ptr(), aover.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _on_card(fn_name: str, words) -> bool:
    """False for CPU operands (the plain version runs); True for CUDA
    ones; raises for any other device."""
    if words.device.type == "cpu":
        return False
    if words.device.type != "cuda":
        raise ValueError(f"{fn_name} runs on cuda or cpu, not {words.device}")
    return True


def nfa_walk(words, lens, is_sys, node_tab, edge_tab, seeds, *,
             active_slots: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw accept slots ``(acc (B, C) int32, aover (B,) int32)`` of the
    hash walk.  CPU tensors run :func:`nfa_walk_plain`; CUDA tensors
    launch ``csrc/nfa_walk.cu`` on the current stream (outputs allocated
    here) or raise."""
    if not _on_card("nfa_walk", words):
        return nfa_walk_plain(words, lens, is_sys, node_tab, edge_tab, seeds,
                              active_slots=active_slots)
    A = active_slots
    _check(words, lens, is_sys, node_tab, edge_tab, seeds, A)
    acc, aover = _outputs(words, A)
    B, D = words.shape
    if B == 0:
        return acc, aover
    _launch("nfa_walk", words,
            (words, lens, is_sys, node_tab, edge_tab, seeds),
            (B, D, A, int(edge_tab.shape[0]), acc.shape[1]), acc, aover)
    global launches
    launches += 1
    return acc, aover


def join_walk(words, lens, is_sys, node_tab, state_start, edge_word,
              edge_next, overlay, *, active_slots: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw accept slots ``(acc (B, C) int32, aover (B,) int32)`` of the
    join walk, the port of ``pallas_match._join_kernel``.  CPU tensors
    run :func:`join_walk_plain`; CUDA tensors launch
    ``csrc/nfa_join_walk.cu`` on the current stream or raise."""
    if not _on_card("join_walk", words):
        return join_walk_plain(words, lens, is_sys, node_tab, state_start,
                               edge_word, edge_next, overlay,
                               active_slots=active_slots)
    A = active_slots
    _check_join(words, lens, is_sys, node_tab, state_start, edge_word,
                edge_next, overlay, A)
    acc, aover = _outputs(words, A)
    B, D = words.shape
    if B == 0:
        return acc, aover
    _launch("nfa_join_walk", words,
            (words, lens, is_sys, node_tab, state_start, edge_word,
             edge_next, overlay),
            (B, D, A, int(node_tab.shape[0]), int(edge_word.shape[0]),
             acc.shape[1]), acc, aover)
    global join_launches
    join_launches += 1
    return acc, aover


# -- flat mode: the walk with the flat epilogue (K3) fused ------------------

#: shared memory an H100 block may opt in to (bytes); flat mode's row
#: lists and the kernels' static arrays must fit
MAX_SHARED_BYTES = 232448

#: the largest B * K a flat launch takes: a tile's state word keeps a sum
#: of ids in 30 bits (``NFA_TILE_VALUE`` of ``csrc/walk_common.cuh``)
FLAT_MAX_IDS = (1 << 30) - 1


def flat_smem_bytes(active_slots: int, max_matches: int) -> int:
    """Dynamic shared memory of a flat launch: a list of K ints for each
    of a block's rows (``flat_list_bytes`` of ``csrc/walk_common.cuh``)."""
    threads, lanes = launch_shape(active_slots)
    return (threads // lanes) * max_matches * 4


class FlatScratch:
    """The look-back's state of the flat launches on one stream: an int64
    buffer whose word 0 is the kernels' ticket counter and word 1 + t the
    state of tile t, with the counter's value and the epoch that the next
    launch gets.  The buffer is zeroed once, when it is made or grown (a
    fill on the stream, ordered before every launch that uses it); a
    launch then needs no memset, since its tiles read only words of its
    own epoch.  A launch takes :meth:`reserve` and, once launched,
    :meth:`commit` under :attr:`lock`, so launches on one stream from
    several threads see the tickets in their launch order."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.lock = threading.Lock()
        self.state: Optional[torch.Tensor] = None
        self.epoch = 0
        self.tickets = 0

    def reserve(self, tiles: int) -> Tuple[torch.Tensor, int, int]:
        """``(state, ticket base, epoch)`` of a launch of ``tiles``
        blocks; makes or grows the buffer (zeroed) where it is too small
        or the epochs have run out."""
        if (self.state is None or self.state.numel() < 1 + tiles
                or self.epoch == 0xFFFFFFFF):
            size = max(1 + tiles, 0 if self.state is None
                       else self.state.numel())
            self.state = torch.zeros(size, dtype=torch.int64,
                                     device=self.device)
            self.epoch = 0
            self.tickets = 0
        return self.state, self.tickets, self.epoch + 1

    def commit(self, tiles: int) -> None:
        """A launch of ``tiles`` blocks went out with the last
        :meth:`reserve`."""
        self.epoch += 1
        self.tickets = (self.tickets + tiles) & 0xFFFFFFFF


_scratch: Dict[Tuple[int, int], FlatScratch] = {}
_scratch_lock = threading.Lock()


def flat_scratch(device, stream: int) -> FlatScratch:
    """The :class:`FlatScratch` of CUDA ``stream`` (a ``cudaStream_t``)
    on ``device``: launches on two streams never share one."""
    key = (torch.device(device).index, int(stream))
    with _scratch_lock:
        sc = _scratch.get(key)
        if sc is None:
            sc = _scratch[key] = FlatScratch(device)
        return sc


def _flat_plain(walk_plain, args, A: int, K: int, cap: int):
    from .match_kernel import flat_epilogue_plain

    acc, aover = walk_plain(*args, active_slots=A)
    matches, n, mover, row_meta = flat_epilogue_plain(acc, aover, K, cap)
    return matches, n, aover, mover, row_meta


def nfa_walk_flat_plain(words, lens, is_sys, node_tab, edge_tab, seeds, *,
                        active_slots: int, max_matches: int, flat_cap: int):
    """The plain version of :func:`nfa_walk_flat`, on any device:
    :func:`nfa_walk_plain` and ``match_kernel.flat_epilogue_plain``."""
    return _flat_plain(nfa_walk_plain, (words, lens, is_sys, node_tab,
                                        edge_tab, seeds),
                       active_slots, int(max_matches), int(flat_cap))


def join_walk_flat_plain(words, lens, is_sys, node_tab, state_start,
                         edge_word, edge_next, overlay, *, active_slots: int,
                         max_matches: int, flat_cap: int):
    """The plain version of :func:`join_walk_flat`, on any device:
    :func:`join_walk_plain` and ``match_kernel.flat_epilogue_plain``."""
    return _flat_plain(join_walk_plain, (words, lens, is_sys, node_tab,
                                         state_start, edge_word, edge_next,
                                         overlay),
                       active_slots, int(max_matches), int(flat_cap))


def _flat_launch(name: str, words, operands, ints, A: int, K: int,
                 cap: int):
    """One flat launch of entry ``name``: the five outputs allocated
    here, the stream's scratch taken under its lock."""
    B = words.shape[0]
    dev = words.device
    if K < 0 or cap <= 0:
        raise ValueError(f"max_matches {K} < 0 or flat_cap {cap} <= 0")
    if B * K > FLAT_MAX_IDS:
        raise ValueError(f"flat mode takes B * K <= {FLAT_MAX_IDS}, got "
                         f"{B} * {K}")
    threads, lanes = launch_shape(A)
    smem = flat_smem_bytes(A, K)
    # beside the walk's static arrays (the join's overlay the largest)
    if smem + (3 * OVERLAY_CAP + 2 * threads + 3) * 4 > MAX_SHARED_BYTES:
        raise ValueError(
            f"flat mode at active_slots={A}, max_matches={K} needs {smem} "
            f"bytes of shared memory a block for its row lists; a block may "
            f"have at most {MAX_SHARED_BYTES} with the walk's own")
    matches = torch.empty((cap,), dtype=torch.int32, device=dev)
    n, aover, mover, row_meta = (torch.empty((B,), dtype=torch.int32,
                                             device=dev) for _ in range(4))
    if B == 0:
        return matches.fill_(-1), n, aover, mover, row_meta
    tiles = -(-B // (threads // lanes))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        sc = flat_scratch(dev, stream)
        with sc.lock:
            state, base, epoch = sc.reserve(tiles)
            rc = _entry(name)(
                *(t.data_ptr() for t in operands), *ints, K, cap,
                matches.data_ptr(), n.data_ptr(), aover.data_ptr(),
                mover.data_ptr(), row_meta.data_ptr(), state.data_ptr(),
                base, epoch, stream)
            if rc == 0:
                sc.commit(tiles)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    global flat_launches
    flat_launches += 1
    return matches, n, aover, mover, row_meta


def nfa_walk_flat(words, lens, is_sys, node_tab, edge_tab, seeds, *,
                  active_slots: int, max_matches: int, flat_cap: int):
    """The flat mode of the hash walk: ``(matches (flat_cap,), n, aover,
    mover, row_meta)``, the fields of ``nfa_match(flat_cap=...)``'s
    ``MatchResult`` in order.  CPU tensors run
    :func:`nfa_walk_flat_plain`; CUDA tensors make one launch of
    ``csrc/nfa_walk.cu``'s flat kernel on the current stream (outputs
    allocated here; B = 0 launches nothing and gives a -1 buffer) or
    raise."""
    A, K, cap = active_slots, int(max_matches), int(flat_cap)
    args = (words, lens, is_sys, node_tab, edge_tab, seeds)
    if not _on_card("nfa_walk_flat", words):
        return nfa_walk_flat_plain(*args, active_slots=A, max_matches=K,
                                   flat_cap=cap)
    _check(*args, A)
    B, D = words.shape
    out = _flat_launch("nfa_walk_flat", words, args,
                       (B, D, A, int(edge_tab.shape[0])), A, K, cap)
    if B:
        global launches
        launches += 1
    return out


def join_walk_flat(words, lens, is_sys, node_tab, state_start, edge_word,
                   edge_next, overlay, *, active_slots: int,
                   max_matches: int, flat_cap: int):
    """The flat mode of the join walk, as :func:`nfa_walk_flat`: CPU
    tensors run :func:`join_walk_flat_plain`; CUDA tensors make one
    launch of ``csrc/nfa_join_walk.cu``'s flat kernel or raise."""
    A, K, cap = active_slots, int(max_matches), int(flat_cap)
    args = (words, lens, is_sys, node_tab, state_start, edge_word,
            edge_next, overlay)
    if not _on_card("join_walk_flat", words):
        return join_walk_flat_plain(*args, active_slots=A, max_matches=K,
                                    flat_cap=cap)
    _check_join(*args, A)
    B, D = words.shape
    out = _flat_launch("nfa_join_walk_flat", words, args,
                       (B, D, A, int(node_tab.shape[0]),
                        int(edge_word.shape[0])), A, K, cap)
    if B:
        global join_launches
        join_launches += 1
    return out
