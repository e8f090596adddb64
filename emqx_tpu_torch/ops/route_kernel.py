"""The routing grid and the merge of the multi-device match steps, and
their plain versions.

Two functions that the multichip serve step (K8a,
``parallel/multichip_serve.py`` ``build_multichip_step``) and the
prefix-EP step (K8c, ``parallel/prefix_ep.py`` ``build_ep_matcher``)
share around their walks; the reference computes both with XLA inside
its ``shard_map`` steps (``emqx_tpu/parallel/multichip_serve.py:327-400``,
``merge_micro`` ``:230``; ``emqx_tpu/parallel/prefix_ep.py:207-242``):

* :func:`ep_route` — the stable bucketing of each source slice's rows by
  owner into a ``(tp, C)`` grid (the reference's cumsum rank), the empty
  slots padded, the per-row overflow flag and owner, and each source
  row's output set to "nobody wrote it";
* :func:`ep_merge` — from the walks' raw accept slots, each row's first K
  (Km) valid ids translated through the aid maps, the micro ids packed
  behind the row's own, and every output field written at the row's
  place in the assembled output: its segment, count and overflow, its
  n_matches, active_overflow and match_overflow.

On CUDA tensors each launches its kernel of ``csrc/ep_route.cu`` on the
current stream, or raises; on CPU tensors it runs its plain version
(``*_plain``, PyTorch ops on any device).  Both write into buffers the
caller allocates (views of one output buffer, so the step's result
leaves the card in one copy).  ``launches`` counts each kernel's
launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import cuda_build
from .match_kernel import _compact

__all__ = ["EP_MAX_OWNERS", "EP_MAX_PAIRS", "EP_MAX_SRC", "MergeOut",
           "MergePair", "RouteGrid", "bind", "ep_merge", "ep_merge_plain",
           "ep_route", "ep_route_plain", "launches", "merge_args",
           "reset_launches", "route_args"]

#: launches of each kernel since the counts were last reset
launches: Dict[str, int] = {"ep_route": 0, "ep_merge": 0}

#: the kernels' fixed limits (``csrc/ep_route.cu``): source slices of one
#: ``ep_route`` launch, owners, walk pairs of one ``ep_merge`` launch
EP_MAX_SRC = 64
EP_MAX_OWNERS = 32
EP_MAX_PAIRS = 16


class RouteGrid(NamedTuple):
    """The routing grid's slots: ``words (slots, D)`` int32, ``lens``
    int32, ``is_sys`` bool and ``src`` int32 (the row within its source
    slice; -1 empty), each contiguous."""

    words: torch.Tensor
    lens: torch.Tensor
    is_sys: torch.Tensor
    src: torch.Tensor


class MergePair(NamedTuple):
    """One walk pair of the merge: the shard walk's raw accept slots
    ``acc (rows, cols)`` and spills ``aover (rows,)``; the micro-table
    walk's (None: none); the local → service aid maps (None: the
    identity); ``src`` the landed slots' source rows (routed); the output
    segment ``seg``; ``row_base`` the first output row of the pair's row
    group; ``micro`` whether the micro answers merge into the segment."""

    acc: torch.Tensor
    aover: torch.Tensor
    macc: Optional[torch.Tensor]
    maover: Optional[torch.Tensor]
    amap: Optional[torch.Tensor]
    mamap: Optional[torch.Tensor]
    src: Optional[torch.Tensor]
    seg: int
    row_base: int
    micro: bool


class MergeOut(NamedTuple):
    """Where the merge writes (None: not written): ``ids (rows, ld)``
    with segment ``s`` at columns ``s·(K+Km)``, ``counts`` and ``ov``
    ``(rows, segs)``, ``nm``, ``ao`` and ``mo`` ``(rows,)``; int32."""

    ids: Optional[torch.Tensor]
    counts: Optional[torch.Tensor]
    ov: Optional[torch.Tensor]
    nm: Optional[torch.Tensor]
    ao: Optional[torch.Tensor]
    mo: Optional[torch.Tensor]


_P, _I = ctypes.c_void_p, ctypes.c_int


class _RouteArgs(ctypes.Structure):
    _fields_ = [("words", _P), ("lens", _P), ("is_sys", _P),
                ("word_owner", _P), ("n_word_owner", _I),
                ("n_src", _I), ("Bs", _I), ("D", _I), ("tp", _I),
                ("C", _I), ("so", _I), ("row0", _I * EP_MAX_SRC),
                ("base", _I * EP_MAX_SRC), ("grid_w", _P), ("grid_l", _P),
                ("grid_s", _P), ("grid_src", _P), ("fill_ids", _P),
                ("ld_ids", _I), ("zero", _P * 4), ("zero_w", _I * 4),
                ("flag", _P), ("owner_out", _P)]


class _Pair(ctypes.Structure):
    _fields_ = [("acc", _P), ("aover", _P), ("macc", _P), ("maover", _P),
                ("amap", _P), ("mamap", _P), ("src", _P), ("amap_n", _I),
                ("mamap_n", _I), ("seg", _I), ("row_base", _I),
                ("micro", _I)]


class _MergeArgs(ctypes.Structure):
    _fields_ = [("pair", _Pair * EP_MAX_PAIRS), ("n_pairs", _I),
                ("routed", _I), ("rows", _I), ("cols", _I), ("K", _I),
                ("Km", _I), ("C", _I), ("Bs", _I), ("segs", _I),
                ("n_groups", _I), ("gstart", _I * (EP_MAX_PAIRS + 1)),
                ("ids", _P), ("ld_ids", _I), ("counts", _P), ("ov", _P),
                ("nm", _P), ("ao", _P), ("mo", _P)]


#: C entry point of each kernel: symbol, its arguments' structure
_ENTRY = {"ep_route": ("ep_route_launch", _RouteArgs),
          "ep_merge": ("ep_merge_launch", _MergeArgs)}
_entries: Dict[str, object] = {}


def reset_launches() -> None:
    """Zero every kernel's launch count."""
    for k in launches:
        launches[k] = 0


def bind(lib, name: str):
    """Kernel ``name``'s C entry point in ``lib``, its arguments'
    structure checked against the library's own size of it."""
    sym, struct = _ENTRY[name]
    size = getattr(lib, f"{name}_args_size")
    size.restype = ctypes.c_int
    if size() != ctypes.sizeof(struct):
        raise RuntimeError(f"{name}: the library's argument structure is "
                           f"{size()} bytes, the wrapper's "
                           f"{ctypes.sizeof(struct)}")
    fn = getattr(lib, sym)
    fn.argtypes = [ctypes.POINTER(struct), _P]
    fn.restype = ctypes.c_int
    return fn


def _entry(name: str):
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = bind(cuda_build.load("ep_route"), name)
    return fn


def _on_card(name: str, t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    return True


def _check(name: str, dev: torch.device, dtype: torch.dtype, ndim: int,
           **tensors) -> None:
    """Each tensor on ``dev``, of ``dtype`` and rank ``ndim``, and
    contiguous (None is skipped)."""
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{name}: {arg} must be {ndim}-d {dtype}, "
                             f"not {t.dim()}-d {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(name: str, dev: torch.device, args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry(name)(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    launches[name] += 1


# -- the routing grid -----------------------------------------------------------

def ep_route_plain(words: torch.Tensor, lens: torch.Tensor,
                   is_sys: torch.Tensor, word_owner: Optional[torch.Tensor],
                   grid: RouteGrid, *, tp: int, C: int, Bs: int,
                   sources: Sequence[Tuple[int, int]], so: int,
                   fill_ids: Optional[torch.Tensor] = None,
                   zeros: Sequence[torch.Tensor] = (),
                   flag: Optional[torch.Tensor] = None,
                   owner_out: Optional[torch.Tensor] = None) -> None:
    """:func:`ep_route` as the reference's PyTorch ops, on any device:
    per source ``(row0, base)``, a one-hot of the owners, a cumsum rank,
    the grid's slots padded and its rows written in place."""
    dev = words.device
    D = int(words.shape[1])
    oc = torch.arange(tp, device=dev)
    cc = torch.arange(C, device=dev)
    local = torch.arange(Bs, dtype=torch.int32, device=dev)
    for r0, base in sources:
        rows = slice(r0, r0 + Bs)
        w, l, s = words[rows], lens[rows], is_sys[rows]
        if word_owner is not None:
            root = w[:, 0].clamp(0, word_owner.shape[0] - 1).long()
            owner = word_owner[root].long()
            routable = l <= D        # encode pads with the D+2 sentinel
        else:
            owner = (w[:, 0] % tp).long()   # the sign of the divisor
            routable = torch.ones((Bs,), dtype=torch.bool, device=dev)
        routable = routable & (owner >= 0) & (owner < tp)
        onehot = (owner[:, None] == oc[None, :]) & routable[:, None]
        rank = torch.cumsum(onehot.to(torch.int32), dim=0) - 1
        my_rank = rank.gather(1, owner.clamp(0, tp - 1)[:, None])[:, 0]
        keep = routable & (my_rank < C)
        slots = (base + oc[:, None] * so + cc[None, :]).reshape(-1)
        grid.words[slots] = 0
        grid.lens[slots] = D + 2
        grid.is_sys[slots] = True
        grid.src[slots] = -1
        at = (base + owner * so + my_rank)[keep]
        grid.words[at] = w[keep]
        grid.lens[at] = l[keep]
        grid.is_sys[at] = s[keep]
        grid.src[at] = local[keep]
        if flag is not None:
            flag[rows] = (routable & (my_rank >= C)).to(torch.int32)
        if owner_out is not None:
            owner_out[rows] = torch.where(routable, owner, -1).to(
                torch.int32)
        if fill_ids is not None:
            fill_ids[rows] = -1
        for z in zeros:
            z[rows] = 0


def ep_route(words: torch.Tensor, lens: torch.Tensor, is_sys: torch.Tensor,
             word_owner: Optional[torch.Tensor], grid: RouteGrid, *,
             tp: int, C: int, Bs: int, sources: Sequence[Tuple[int, int]],
             so: int, fill_ids: Optional[torch.Tensor] = None,
             zeros: Sequence[torch.Tensor] = (),
             flag: Optional[torch.Tensor] = None,
             owner_out: Optional[torch.Tensor] = None) -> None:
    """Bucket the rows of each source slice by owner into ``grid``.

    ``words (rows, D)``, ``lens``, ``is_sys`` the batch; source ``(row0,
    base)`` is rows ``[row0, row0 + Bs)``, its rows landing at slot
    ``base + owner·so + rank`` for ``rank < C``.  The owner is
    ``word_owner[clamp(words[:, 0])]`` for rows with ``lens <= D`` (K8a),
    or with ``word_owner`` None ``words[:, 0] % tp`` (Python's sign) for
    every row (K8c).  The source's empty slots are padded (words 0, len
    D+2, is_sys True, src -1).  At each source row: ``flag`` 1 where its
    rank reached C, ``owner_out`` its owner (-1 not routable),
    ``fill_ids`` -1 and each of ``zeros`` 0.  CPU tensors run
    :func:`ep_route_plain`; CUDA tensors launch ``ep_route_kernel`` (a
    block a source) or raise."""
    if not _on_card("ep_route", words):
        return ep_route_plain(words, lens, is_sys, word_owner, grid, tp=tp,
                              C=C, Bs=Bs, sources=sources, so=so,
                              fill_ids=fill_ids, zeros=zeros, flag=flag,
                              owner_out=owner_out)
    a = route_args(words, lens, is_sys, word_owner, grid, tp=tp, C=C, Bs=Bs,
                   sources=sources, so=so, fill_ids=fill_ids, zeros=zeros,
                   flag=flag, owner_out=owner_out)
    if a.n_src:
        _launch("ep_route", words.device, a)


def route_args(words, lens, is_sys, word_owner, grid: RouteGrid, *,
               tp: int, C: int, Bs: int, sources, so: int, fill_ids=None,
               zeros=(), flag=None, owner_out=None) -> _RouteArgs:
    """:func:`ep_route`'s operands checked (device, dtype, shape,
    contiguity, bounds; ValueError) and packed as the kernel's argument
    structure."""
    dev = words.device
    i32 = torch.int32
    _check("ep_route", dev, i32, 2, words=words, grid_words=grid.words,
           fill_ids=fill_ids)
    _check("ep_route", dev, i32, 1, lens=lens, word_owner=word_owner,
           grid_lens=grid.lens, grid_src=grid.src, flag=flag,
           owner_out=owner_out)
    _check("ep_route", dev, torch.bool, 1, is_sys=is_sys,
           grid_is_sys=grid.is_sys)
    _check("ep_route", dev, i32, 2,
           **{f"zeros[{k}]": z for k, z in enumerate(zeros)})
    rows, D = (int(x) for x in words.shape)
    n_src = len(sources)
    slots = int(grid.lens.shape[0])
    if not 1 <= tp <= EP_MAX_OWNERS or n_src > EP_MAX_SRC or len(zeros) > 4:
        raise ValueError(f"ep_route: tp {tp} (1..{EP_MAX_OWNERS}), "
                         f"{n_src} sources (<= {EP_MAX_SRC}), {len(zeros)} "
                         "zeroed outputs (<= 4)")
    if lens.shape[0] != rows or is_sys.shape[0] != rows:
        raise ValueError("ep_route: lens / is_sys length differs from words")
    if tuple(grid.words.shape) != (slots, D) or any(
            t.shape[0] != slots for t in (grid.is_sys, grid.src)):
        raise ValueError("ep_route: the grid's tensors disagree in shape")
    if word_owner is not None and word_owner.shape[0] < 1:
        raise ValueError("ep_route: an empty word_owner map")
    for t in (fill_ids, flag, owner_out, *zeros):
        if t is not None and t.shape[0] != rows:
            raise ValueError("ep_route: an output's rows differ from the "
                             "batch's")
    for r0, base in sources:
        if r0 < 0 or r0 + Bs > rows or base < 0 or (
                C and base + (tp - 1) * so + C > slots):
            raise ValueError(f"ep_route: source ({r0}, {base}) outside the "
                             "batch or the grid")
    a = _RouteArgs(words=_ptr(words), lens=_ptr(lens), is_sys=_ptr(is_sys),
                   word_owner=_ptr(word_owner),
                   n_word_owner=0 if word_owner is None
                   else int(word_owner.shape[0]),
                   n_src=n_src, Bs=int(Bs), D=D, tp=int(tp), C=int(C),
                   so=int(so), grid_w=_ptr(grid.words),
                   grid_l=_ptr(grid.lens), grid_s=_ptr(grid.is_sys),
                   grid_src=_ptr(grid.src), fill_ids=_ptr(fill_ids),
                   ld_ids=0 if fill_ids is None else int(fill_ids.shape[1]),
                   flag=_ptr(flag), owner_out=_ptr(owner_out))
    for b, (r0, base) in enumerate(sources):
        a.row0[b], a.base[b] = int(r0), int(base)
    for k, z in enumerate(zeros):
        a.zero[k], a.zero_w[k] = z.data_ptr(), int(z.shape[1])
    return a


# -- the merge --------------------------------------------------------------------

def _translate(ids: torch.Tensor, amap: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """Local accept ids → service ids through ``amap`` (-1 stays -1;
    indices clamp into the map, as the reference's gather does)."""
    if amap is None:
        return ids
    idx = ids.clamp(0, amap.shape[0] - 1).long()
    return torch.where(ids >= 0, amap[idx], -1)


def _segments(p: MergePair, K: int, Km: int):
    """Pair ``p``'s merged segments ``(rows, K+Km)``, their counts and
    overflows, and the rows' matches and spills (the reference's compact
    walks, translation and ``merge_micro``)."""
    W = K + Km
    n = (p.acc >= 0).sum(dim=1, dtype=torch.int32)
    own = torch.clamp(n, max=K)
    rows = p.acc.shape[0]
    dev = p.acc.device
    out = torch.full((rows, W + 1), -1, dtype=torch.int32, device=dev)
    out[:, :K] = _translate(_compact(p.acc, K), p.amap)
    micro = p.micro and p.macc is not None
    if micro:
        mn = (p.macc >= 0).sum(dim=1, dtype=torch.int32)
        mcnt = torch.clamp(mn, max=Km)
        mg = _translate(_compact(p.macc, Km), p.mamap)
        j = torch.arange(Km, dtype=torch.int32, device=dev)[None, :]
        pos = torch.where(j < mcnt[:, None], own[:, None] + j, W)
        out.scatter_(1, pos.long(), mg)
        maov = p.maover
    else:
        mn = mcnt = maov = torch.zeros_like(n)
    sov = (n > K).to(torch.int32) + (mn > Km).to(torch.int32)
    return out[:, :W], own + mcnt, sov, n + mn, p.aover + maov


def ep_merge_plain(pairs: Sequence[MergePair], out: MergeOut, *,
                   routed: bool, K: int, Km: int, C: int = 1, Bs: int = 0,
                   segs: int = 1) -> None:
    """:func:`ep_merge` as the reference's PyTorch ops, on any device."""
    W = K + Km
    if routed:
        for p in pairs:
            seg, cnt, sov, nm, ao = _segments(p, K, Km)
            R = p.acc.shape[0]
            slot = torch.arange(R, device=p.acc.device)
            landed = p.src >= 0
            at = (p.row_base + (slot // C) * Bs + p.src.long())[landed]
            _write(out, at, p.seg, W, seg[landed], cnt[landed],
                   sov[landed])
            for dst, v in ((out.nm, nm), (out.ao, ao), (out.mo, sov)):
                if dst is not None:
                    dst[at] = v[landed]
        return
    for group in _groups(pairs):
        sums = None
        for p in group:
            seg, cnt, sov, nm, ao = _segments(p, K, Km)
            R = p.acc.shape[0]
            at = torch.arange(p.row_base, p.row_base + R, device=seg.device)
            _write(out, at, p.seg, W, seg, cnt, sov)
            part = (nm, ao, sov)
            sums = part if sums is None else tuple(
                x + y for x, y in zip(sums, part))
        rows = slice(group[0].row_base, group[0].row_base + R)
        for dst, v in zip((out.nm, out.ao, out.mo), sums):
            if dst is not None:
                dst[rows] = v


def _write(out: MergeOut, at, seg: int, W: int, ids, cnt, sov) -> None:
    if out.ids is not None:
        out.ids[at, seg * W:(seg + 1) * W] = ids
    if out.counts is not None:
        out.counts[at, seg] = cnt
    if out.ov is not None:
        out.ov[at, seg] = sov


def _groups(pairs: Sequence[MergePair]) -> List[List[MergePair]]:
    """Consecutive pairs with one ``row_base``: the replicated row
    groups."""
    out: List[List[MergePair]] = []
    for p in pairs:
        if out and out[-1][0].row_base == p.row_base:
            out[-1].append(p)
        else:
            out.append([p])
    return out


def ep_merge(pairs: Sequence[MergePair], out: MergeOut, *, routed: bool,
             K: int, Km: int, C: int = 1, Bs: int = 0,
             segs: int = 1) -> None:
    """Merge the walk pairs' raw accept slots into ``out``.

    Each pair's row keeps its first ``K`` valid shard ids in column order
    and, where the pair merges the micro answers, its first ``Km`` micro
    ids behind them, each through its aid map; -1 after.  That segment,
    its count (own + micro) and its overflow ((n > K) + (micro n > Km))
    go to segment ``seg`` of the row; ``nm``, ``ao`` and ``mo`` get the
    row's matches, spills and overflows.  ``routed``: slot ``s`` of a
    pair with ``src[s] >= 0`` is row ``row_base + (s // C)·Bs + src[s]``
    (one owner writes each row).  Replicated: row ``j`` of a pair is row
    ``row_base + j``, and the pairs sharing a ``row_base`` (consecutive)
    sum into ``nm``, ``ao`` and ``mo``.  CPU tensors run
    :func:`ep_merge_plain`; CUDA tensors launch ``ep_merge_kernel`` (a
    warp a landed slot or a row) or raise."""
    if not pairs:
        return
    if not _on_card("ep_merge", pairs[0].acc):
        return ep_merge_plain(pairs, out, routed=routed, K=K, Km=Km, C=C,
                              Bs=Bs, segs=segs)
    _launch("ep_merge", pairs[0].acc.device,
            merge_args(pairs, out, routed=routed, K=K, Km=Km, C=C, Bs=Bs,
                       segs=segs))


def merge_args(pairs: Sequence[MergePair], out: MergeOut, *, routed: bool,
               K: int, Km: int, C: int = 1, Bs: int = 0,
               segs: int = 1) -> _MergeArgs:
    """:func:`ep_merge`'s operands checked (device, dtype, shape,
    contiguity, limits; ValueError) and packed as the kernel's argument
    structure."""
    dev = pairs[0].acc.device
    i32 = torch.int32
    if len(pairs) > EP_MAX_PAIRS:
        raise ValueError(f"ep_merge: {len(pairs)} pairs on one device "
                         f"(<= {EP_MAX_PAIRS})")
    rows, cols = (int(x) for x in pairs[0].acc.shape)
    for k, p in enumerate(pairs):
        _check("ep_merge", dev, i32, 2, acc=p.acc, macc=p.macc)
        _check("ep_merge", dev, i32, 1, aover=p.aover, maover=p.maover,
               amap=p.amap, mamap=p.mamap, src=p.src)
        if (p.macc is None) != (p.maover is None):
            raise ValueError("ep_merge: macc and maover go together")
        if tuple(p.acc.shape) != (rows, cols) or p.aover.shape[0] != rows \
                or (p.macc is not None and (tuple(p.macc.shape) != (
                    rows, cols) or p.maover.shape[0] != rows)):
            raise ValueError(f"ep_merge: pair {k}'s walks are not "
                             f"({rows}, {cols})")
        if any(m is not None and m.shape[0] < 1 for m in (p.amap, p.mamap)):
            raise ValueError("ep_merge: an empty aid map")
        if routed and (p.src is None or p.src.shape[0] != rows):
            raise ValueError(f"ep_merge: pair {k} needs src ({rows},)")
        if not 0 <= p.seg < segs:
            raise ValueError(f"ep_merge: segment {p.seg} outside {segs}")
    if routed and C < 1:
        raise ValueError("ep_merge: a routed merge needs C >= 1")
    _check("ep_merge", dev, i32, 2, ids=out.ids, counts=out.counts,
           ov=out.ov)
    _check("ep_merge", dev, i32, 1, nm=out.nm, ao=out.ao, mo=out.mo)
    n_out = None
    for t in out:
        if t is not None:
            n_out = t.shape[0] if n_out is None else n_out
            if t.shape[0] != n_out:
                raise ValueError("ep_merge: the outputs' rows disagree")
    if out.ids is not None and out.ids.shape[1] < segs * (K + Km):
        raise ValueError(f"ep_merge: ids are {out.ids.shape[1]} wide, "
                         f"want {segs} x {K + Km}")
    for t in (out.counts, out.ov):
        if t is not None and t.shape[1] != segs:
            raise ValueError(f"ep_merge: counts / ov must be {segs} wide")
    a = _MergeArgs(n_pairs=len(pairs), routed=int(bool(routed)), rows=rows,
                   cols=cols, K=int(K), Km=int(Km), C=int(C), Bs=int(Bs),
                   segs=int(segs), ids=_ptr(out.ids),
                   ld_ids=0 if out.ids is None else int(out.ids.shape[1]),
                   counts=_ptr(out.counts), ov=_ptr(out.ov),
                   nm=_ptr(out.nm), ao=_ptr(out.ao), mo=_ptr(out.mo))
    for k, p in enumerate(pairs):
        a.pair[k] = _Pair(
            acc=_ptr(p.acc), aover=_ptr(p.aover), macc=_ptr(p.macc),
            maover=_ptr(p.maover), amap=_ptr(p.amap), mamap=_ptr(p.mamap),
            src=_ptr(p.src),
            amap_n=0 if p.amap is None else int(p.amap.shape[0]),
            mamap_n=0 if p.mamap is None else int(p.mamap.shape[0]),
            seg=int(p.seg), row_base=int(p.row_base), micro=int(p.micro))
    groups = _groups(pairs)
    a.n_groups = len(groups)
    at = 0
    for g, group in enumerate(groups):
        a.gstart[g] = at
        at += len(group)
    a.gstart[len(groups)] = at
    return a
