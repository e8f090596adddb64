"""The subscriber-bitmap kernels of the multi-device fan-out, and their
plain versions.

Six functions that the reference computes with XLA inside its
``shard_map`` steps (``emqx_tpu/parallel/``) and that PyTorch has no op
for (no OR reduction over gathered rows, no popcount; ``torch.uint32``
raises on shifts and reductions):

* :func:`accept_or` — ``sharded_match.or_accept_rows`` and the ring's
  window: per row, the OR of the bitmap rows its ids name, and the row's
  popcount;
* :func:`bitmap_compact` — ``sharded_match.compact_bitmap_ids``: a bitmap
  row to its first ``cap_row`` subscriber ids, the count and the
  overflow flag;
* :func:`group_count` and :func:`group_pick` — ``shared_group.
  build_shared_selector``'s two halves around its collectives: the
  candidates of each ``$share`` group in a row, then the picked member;
* :func:`ring_or` — the ring step (``ring_fanout.build_ring_fanout`` and
  its compact form) on one device, from the walk's raw accept slots: each
  row's first K valid ids, their bitmap rows ORed window by window, the
  windows past the first cut to ``cap_row`` bits in the compact form,
  and the rows' truncation counts;
* :func:`ulysses_or` — the Ulysses step (``ulysses.build_ulysses_step``)
  on one device, from the raw accept slots: the dispatch blocks, the
  per-subscriber counts, ``n_matches`` and the spill flags.

On CUDA tensors each launches its kernel of ``csrc/bitmap_fanout.cu`` on
the current stream (outputs allocated here) or raises; on CPU tensors
it runs its plain version (``*_plain``, the reference's arithmetic as
PyTorch ops, which runs on any device).  Bitmaps are int32 tensors
holding the reference's uint32 bit patterns; a bitmap may be a column
slice of a wider one (its rows ``stride(0)`` ints apart), read in place.
``launches`` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import cuda_build
from .match_kernel import _compact

__all__ = ["accept_or", "accept_or_plain", "bitmap_compact",
           "bitmap_compact_plain", "bits_of_plain", "deliveries_plain",
           "group_count", "group_count_plain", "group_pick",
           "group_pick_plain", "launches", "popcount32", "reset_launches",
           "ring_or", "ring_or_plain", "ulysses_or", "ulysses_or_plain"]

#: launches of each kernel since the counts were last reset
launches: Dict[str, int] = {"accept_or": 0, "bitmap_compact": 0,
                            "group_count": 0, "group_pick": 0, "ring_or": 0,
                            "ulysses_or": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C entry point of each kernel: library (a ``cuda_build.SOURCES`` name),
#: symbol, ctypes arguments (pointers, ints, then the stream)
_ENTRY = {
    "accept_or": ("bitmap_fanout", "accept_or_launch",
                  [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P]),
    "bitmap_compact": ("bitmap_fanout", "bitmap_compact_launch",
                       [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P]),
    "group_count": ("bitmap_fanout", "group_count_launch",
                    [_P, _I, _P, _I, _I, _I, _I, _P, _P]),
    "group_pick": ("bitmap_fanout", "group_pick_launch",
                   [_P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P,
                    _P]),
    "ring_or": ("bitmap_fanout", "ring_or_launch",
                [_P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P]),
    "ulysses_or": ("bitmap_fanout", "ulysses_or_launch",
                   [_P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                    _P]),
}
_entries: Dict[str, object] = {}


def reset_launches() -> None:
    """Zero every kernel's launch count."""
    for k in launches:
        launches[k] = 0


def _entry(name: str):
    fn = _entries.get(name)
    if fn is None:
        lib, sym, argtypes = _ENTRY[name]
        fn = getattr(cuda_build.load(lib), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _on_card(name: str, t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    return True


def _check(name: str, dev: torch.device, rows=(), **tensors) -> None:
    """int32 and on ``dev``; contiguous, except that the 2-D tensors named
    in ``rows`` need only contiguous rows (``stride(0)`` ints apart: a
    column slice)."""
    for arg, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {arg} must be int32, not {t.dtype}")
        if arg in rows and t.dim() == 2:
            if t.shape[1] > 1 and t.stride(1) != 1:
                raise ValueError(f"{name}: {arg}'s rows must be contiguous")
        elif not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _i32(x: int) -> int:
    """``x`` as an int32 with two's-complement wraparound."""
    return (int(x) + (1 << 31)) % (1 << 32) - (1 << 31)


def _ld(t: torch.Tensor) -> int:
    """Ints between two rows of the 2-D ``t`` (its width when it has one
    row)."""
    return int(t.stride(0)) if t.shape[0] > 1 else int(t.shape[1])


def _launch(name: str, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    launches[name] += 1


# -- plain versions -----------------------------------------------------------

def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns, as int32 (SWAR in
    int64, on any device)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values to int32 with two's-complement wraparound."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def accept_or_plain(bitmap: torch.Tensor, ids: torch.Tensor, lo: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out (B, W), popc (B,))``: ``out[b]`` the OR of ``bitmap[id -
    lo]`` over the ids of row ``b`` in ``[lo, lo + rows)`` (any other id,
    -1 among them, reads nothing), ``popc[b]`` its set bits."""
    rows, W = bitmap.shape
    local = ids.to(torch.int64) - lo
    valid = (local >= 0) & (local < rows)
    safe = torch.where(valid, local, 0)
    out = torch.zeros((ids.shape[0], W), dtype=torch.int32,
                      device=bitmap.device)
    for k in range(ids.shape[1]):
        out |= torch.where(valid[:, k, None], bitmap[safe[:, k]], 0)
    return out, popcount32(out).sum(dim=1, dtype=torch.int32)


def bitmap_compact_plain(bitmap: torch.Tensor, cap_row: int,
                         id_base: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(ids (B, cap_row), counts (B,), overflow (B,))`` int32: the set
    bits of each row as ids ``id_base + 32·word + bit``, ascending, -1
    padded, as the reference's expand, cumsum and compare-scatter (a
    write at or past ``cap_row`` goes to a spare column, cut off)."""
    B, W = bitmap.shape
    dev = bitmap.device
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    bits = ((bitmap.to(torch.int64)[:, :, None] >> shifts) & 1) \
        .to(torch.int32).reshape(B, W * 32)
    sub = _wrap32(id_base + torch.arange(W * 32, dtype=torch.int64,
                                         device=dev))
    n = bits.sum(dim=1, dtype=torch.int32)
    pos = torch.cumsum(bits, dim=1, dtype=torch.int32) - 1
    keep = (bits > 0) & (pos < cap_row)
    out = torch.full((B, cap_row + 1), -1, dtype=torch.int32, device=dev)
    out.scatter_(1, torch.where(keep, pos, cap_row).long(),
                 torch.where(keep, sub[None, :], -1))
    return out[:, :cap_row].contiguous(), n, (n > cap_row).to(torch.int32)


def group_count_plain(bitmap: torch.Tensor,
                      masks: torch.Tensor) -> torch.Tensor:
    """``(B, G)`` int32: the set bits of ``bitmap[b] & masks[g]``."""
    cand = bitmap[:, None, :] & masks[None, :, :]
    return popcount32(cand).sum(dim=-1, dtype=torch.int32)


def _nth_set_bit_plain(word: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The reference's ``_nth_set_bit``: the index of the ``n``-th
    (0-based) set bit of each uint32 bit pattern, by a 32-step probe."""
    w = word.to(torch.int64) & 0xFFFFFFFF
    idx = torch.full(word.shape, -1, dtype=torch.int32, device=word.device)
    seen = torch.zeros(word.shape, dtype=torch.int32, device=word.device)
    for b in range(32):
        bit = ((w >> b) & 1).to(torch.int32)
        hit = (bit == 1) & (seen == n) & (idx < 0)
        idx = torch.where(hit, b, idx)
        seen = seen + bit
    return idx


def group_pick_plain(bitmap: torch.Tensor, masks: torch.Tensor,
                     sel_hash: torch.Tensor, total: torch.Tensor,
                     before: torch.Tensor, count: torch.Tensor,
                     col_base: int) -> torch.Tensor:
    """``(B, G)`` int32: for each (row, group) whose ordinal ``sel_hash[b]
    % max(total, 1)`` (the sign of the divisor, as the reference's
    integer remainder) lies in this shard's ``[before, before + count)``,
    the id of that candidate, ``(col_base + word) * 32 + bit``; -1
    elsewhere.  The reference's cumsum-popcount word walk and bit probe."""
    cand = bitmap[:, None, :] & masks[None, :, :]
    wc = popcount32(cand)
    sel = sel_hash[:, None] % torch.clamp(total, min=1)
    local_ord = sel - before
    mine = (local_ord >= 0) & (local_ord < count) & (total > 0)
    cum = torch.cumsum(wc, dim=-1, dtype=torch.int32) - wc
    o = torch.where(mine, local_ord, 0)[:, :, None]
    in_word = (o >= cum) & (o < cum + wc)
    word_idx = in_word.to(torch.int32).argmax(dim=-1)
    at = word_idx[:, :, None].long()
    word = cand.gather(-1, at)[:, :, 0]
    rem = o[:, :, 0] - cum.gather(-1, at)[:, :, 0]
    bit = _nth_set_bit_plain(word, rem)
    sub_id = (col_base + word_idx) * 32 + bit
    return torch.where(mine, sub_id, -1).to(torch.int32)


def bits_of_plain(ids: torch.Tensor, W: int) -> torch.Tensor:
    """The reference's ``bits_of``: dense ``(B, cap)`` ids → ``(B, W)``
    bitmap tile, ``1 << bit`` added into word ``id >> 5`` of a zero tile
    (unique ids, so add is OR); a -1 pad adds 0 into the spare column W,
    cut off."""
    ok = ids >= 0
    word = torch.where(ok, ids >> 5, W).long()
    bit = torch.where(ok, torch.ones_like(ids) << (ids & 31), 0)
    z = torch.zeros((ids.shape[0], W + 1), dtype=torch.int32,
                    device=ids.device)
    return z.scatter_add_(1, word, bit)[:, :W]


def deliveries_plain(block: torch.Tensor) -> torch.Tensor:
    """``(B, Wl)`` bitmap → ``(Wl·32,)`` int32: how many rows set each
    bit (bit b of word w is subscriber w·32 + b), by the reference's
    ``(B, Wl, 32)`` expand and sum."""
    shifts = torch.arange(32, dtype=torch.int64, device=block.device)
    bits = (block.to(torch.int64)[:, :, None] >> shifts) & 1
    return bits.sum(dim=0, dtype=torch.int32).reshape(-1)


def ring_or_plain(acc: torch.Tensor, bitmap: torch.Tensor, ring: int,
                  K: int, cap_row: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(out (B, W), truncated (B,) or None)`` from the raw accept slots
    ``acc (B, C)`` and the ring's bitmap rows ``(F_pad, W)``, as the
    reference's ring computes them: the compact epilogue's ids
    (``_compact``), each window's partial by :func:`accept_or_plain`,
    then the plain form's OR of them all, or (``cap_row``) the first
    window's partial ORed with the others' :func:`bitmap_compact_plain`
    lists re-expanded by :func:`bits_of_plain`, and the overflow flags
    summed over the windows."""
    F_pad, W = bitmap.shape
    if F_pad % ring:
        raise ValueError(f"bitmap rows {F_pad} do not split over "
                         f"ring={ring}")
    f_local = F_pad // ring
    ids = _compact(acc, K)
    parts = [accept_or_plain(bitmap[r * f_local:(r + 1) * f_local], ids,
                             r * f_local)[0] for r in range(ring)]
    out = parts[0]
    if cap_row is None:
        for p in parts[1:]:
            out = out | p
        return out, None
    trunc = torch.zeros((acc.shape[0],), dtype=torch.int32,
                        device=acc.device)
    for r, p in enumerate(parts):
        lst, _n, over = bitmap_compact_plain(p, cap_row)
        trunc = trunc + over
        if r:
            out = out | bits_of_plain(lst, W)
    return out, trunc


def ulysses_or_plain(acc: torch.Tensor, aover: torch.Tensor,
                     bitmap: torch.Tensor, U: int, K: int
                     ) -> Tuple[torch.Tensor, ...]:
    """``(disp (U, B, W/U), counts (W·32,), n_matches (B,),
    active_overflow (B,))`` from the raw accept slots ``acc (B, C)``, the
    spills ``aover`` and the full-width bitmap ``(F+1, W)``, as the
    reference's Ulysses step computes them: the compact epilogue's ids
    ORed by :func:`accept_or_plain`, the tiled ``all_to_all``'s column
    blocks, :func:`deliveries_plain` of the whole (each block's counts in
    order), the count of valid raw slots."""
    W = bitmap.shape[1]
    if W % U:
        raise ValueError(f"bitmap width {W} does not split over u={U}")
    B = acc.shape[0]
    ingest = accept_or_plain(bitmap, _compact(acc, K))[0]
    disp = ingest.view(B, U, W // U).transpose(0, 1).contiguous()
    n = (acc >= 0).sum(dim=1, dtype=torch.int32)
    return disp, deliveries_plain(ingest), n, aover


# -- the kernels ---------------------------------------------------------------

def accept_or(bitmap: torch.Tensor, ids: torch.Tensor, lo: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`accept_or_plain` on CPU tensors; on CUDA tensors one launch
    of ``accept_or_kernel`` (``bitmap`` rows, ``ids (B, K)``)."""
    if not _on_card("accept_or", ids):
        return accept_or_plain(bitmap, ids, lo)
    _check("accept_or", ids.device, ("bitmap",), bitmap=bitmap,
           ids=ids)
    rows, W = bitmap.shape
    B, K = ids.shape
    if lo < 0:
        raise ValueError(f"accept_or: lo {lo} < 0")
    out = torch.empty((B, W), dtype=torch.int32, device=ids.device)
    popc = torch.zeros((B,), dtype=torch.int32, device=ids.device)
    if B and W:
        _launch("accept_or", ids.device, bitmap.data_ptr(), rows, W,
                _ld(bitmap), ids.data_ptr(), B, K, lo, out.data_ptr(),
                popc.data_ptr())
    return out, popc


def bitmap_compact(bitmap: torch.Tensor, cap_row: int, id_base: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`bitmap_compact_plain` on CPU tensors; on CUDA tensors one
    launch of ``bitmap_compact_kernel`` (a block a row)."""
    if not _on_card("bitmap_compact", bitmap):
        return bitmap_compact_plain(bitmap, cap_row, id_base)
    _check("bitmap_compact", bitmap.device, ("bitmap",),
           bitmap=bitmap)
    B, W = bitmap.shape
    if cap_row < 0:
        raise ValueError(f"bitmap_compact: cap_row {cap_row} < 0")
    dev = bitmap.device
    ids = torch.empty((B, cap_row), dtype=torch.int32, device=dev)
    counts, overflow = (torch.empty((B,), dtype=torch.int32, device=dev)
                        for _ in range(2))
    if B:
        _launch("bitmap_compact", dev, bitmap.data_ptr(), B, W,
                _ld(bitmap) if W else 0, int(cap_row),
                _i32(id_base), ids.data_ptr(),
                counts.data_ptr(), overflow.data_ptr())
    return ids, counts, overflow


def group_count(bitmap: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """:func:`group_count_plain` on CPU tensors; on CUDA tensors one
    launch of ``group_count_kernel`` (a warp a (row, group))."""
    if not _on_card("group_count", bitmap):
        return group_count_plain(bitmap, masks)
    _check("group_count", bitmap.device, ("bitmap", "masks"),
           bitmap=bitmap, masks=masks)
    (B, W), G = bitmap.shape, masks.shape[0]
    if masks.shape[1] != W:
        raise ValueError(f"group_count: masks are {masks.shape[1]} words "
                         f"wide, the bitmap {W}")
    counts = torch.empty((B, G), dtype=torch.int32, device=bitmap.device)
    if B and G:
        _launch("group_count", bitmap.device, bitmap.data_ptr(),
                _ld(bitmap) if W else 0, masks.data_ptr(),
                _ld(masks) if W else 0, B, G, W, counts.data_ptr())
    return counts


def group_pick(bitmap: torch.Tensor, masks: torch.Tensor,
               sel_hash: torch.Tensor, total: torch.Tensor,
               before: torch.Tensor, count: torch.Tensor,
               col_base: int) -> torch.Tensor:
    """:func:`group_pick_plain` on CPU tensors; on CUDA tensors one
    launch of ``group_pick_kernel`` (a warp a (row, group))."""
    if not _on_card("group_pick", bitmap):
        return group_pick_plain(bitmap, masks, sel_hash, total, before,
                                count, col_base)
    _check("group_pick", bitmap.device, ("bitmap", "masks"),
           bitmap=bitmap, masks=masks, sel_hash=sel_hash, total=total,
           before=before, count=count)
    (B, W), G = bitmap.shape, masks.shape[0]
    if masks.shape[1] != W or sel_hash.shape != (B,) or any(
            t.shape != (B, G) for t in (total, before, count)):
        raise ValueError("group_pick: operand shapes disagree")
    if col_base < 0:
        raise ValueError(f"group_pick: col_base {col_base} < 0")
    picked = torch.empty((B, G), dtype=torch.int32, device=bitmap.device)
    if B and G:
        _launch("group_pick", bitmap.device, bitmap.data_ptr(),
                _ld(bitmap) if W else 0, masks.data_ptr(),
                _ld(masks) if W else 0, B, G, W, sel_hash.data_ptr(),
                total.data_ptr(), before.data_ptr(), count.data_ptr(),
                int(col_base),
                picked.data_ptr())
    return picked


def ring_or(acc: torch.Tensor, bitmap: torch.Tensor, ring: int, K: int,
            cap_row: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`ring_or_plain` on CPU tensors; on CUDA tensors one launch
    of ``ring_or_kernel`` (a block a row; ``out`` and ``truncated`` views
    of one buffer)."""
    if not _on_card("ring_or", acc):
        return ring_or_plain(acc, bitmap, ring, K, cap_row)
    _check("ring_or", acc.device, ("bitmap",), acc=acc, bitmap=bitmap)
    (B, C), (F_pad, W) = acc.shape, bitmap.shape
    if ring < 1 or F_pad % ring or F_pad < ring:
        raise ValueError(f"ring_or: bitmap rows {F_pad} do not split over "
                         f"ring={ring}")
    if K < 0 or (cap_row is not None and cap_row < 0):
        raise ValueError(f"ring_or: K {K} or cap_row {cap_row} < 0")
    compact = cap_row is not None
    buf = torch.empty((B * W + (B if compact else 0),), dtype=torch.int32,
                      device=acc.device)
    out = buf[:B * W].view(B, W)
    trunc = buf[B * W:] if compact else None
    if B:
        _launch("ring_or", acc.device, acc.data_ptr(), B, C,
                bitmap.data_ptr(), F_pad, W, _ld(bitmap) if W else 0,
                F_pad // ring, ring, K, cap_row if compact else -1,
                out.data_ptr(), trunc.data_ptr() if compact else None)
    return out, trunc


def ulysses_or(acc: torch.Tensor, aover: torch.Tensor, bitmap: torch.Tensor,
               U: int, K: int) -> Tuple[torch.Tensor, ...]:
    """:func:`ulysses_or_plain` on CPU tensors; on CUDA tensors the
    counts' memset and one launch of ``ulysses_or_kernel`` (a block a
    row).  The four outputs are views of one buffer."""
    if not _on_card("ulysses_or", acc):
        return ulysses_or_plain(acc, aover, bitmap, U, K)
    _check("ulysses_or", acc.device, ("bitmap",), acc=acc, aover=aover,
           bitmap=bitmap)
    (B, C), (rows, W) = acc.shape, bitmap.shape
    if U < 1 or W % U or aover.shape != (B,) or K < 0:
        raise ValueError(f"ulysses_or: bitmap width {W} over u={U}, spills "
                         f"{tuple(aover.shape)} for {B} rows, K {K}")
    nd = B * W
    buf = torch.empty((nd + 32 * W + 2 * B,), dtype=torch.int32,
                      device=acc.device)
    disp = buf[:nd].view(U, B, W // U)
    counts = buf[nd:nd + 32 * W]
    meta = buf[nd + 32 * W:]
    if B:
        _launch("ulysses_or", acc.device, acc.data_ptr(), aover.data_ptr(),
                B, C, bitmap.data_ptr(), rows, W, _ld(bitmap) if W else 0, K,
                U, disp.data_ptr(), counts.data_ptr(), meta.data_ptr())
    else:
        counts.zero_()
    return disp, counts, meta[:B], meta[B:]
