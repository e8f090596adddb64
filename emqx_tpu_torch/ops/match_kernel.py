"""Batched NFA wildcard match: the walk plus its output epilogues.

The port of ``emqx_tpu/ops/match_kernel.py``.  :func:`nfa_match` runs the
fused hash walk (:func:`~emqx_tpu_torch.ops.walk_kernel.nfa_walk`: the
CUDA kernel on the card, its plain version on the CPU) for the raw
accept slots, then :func:`epilogue`, which ``join_match.join_match``
shares, picks one of three outputs:

* raw — all Σ2·w_t accept slots with -1 holes (nothing truncates, only
  active-set spill is a fail-open cause);
* compact — per row the first K valid ids (valids first, -1 padded) and
  ``match_overflow`` where the count exceeds K;
* flat — the per-row compaction scattered at global cumsum offsets into
  one ``(flat_cap,)`` buffer, plus the packed ``row_meta`` vector; a row
  whose segment runs past ``flat_cap`` is truncated and flagged.

Raw and compact are PyTorch ops.  Flat (K3, the reference's XLA
``flat_epilogue``) is fused into the walk on the card: on CUDA tensors
with ``flat_cap`` > 0, :func:`nfa_match` (and ``join_match``) make one
launch of the walk kernel's flat mode
(:func:`~emqx_tpu_torch.ops.walk_kernel.nfa_walk_flat`), which writes
the five ``MatchResult`` fields and never the raw accept plane.  On CPU
tensors the walk's plain version runs and :func:`epilogue` takes its
accept slots through :func:`flat_epilogue_plain`, the same function as
PyTorch ops.

Everything is int32 and matches the reference bit for bit.

:func:`match_topics` is the reference's end-to-end convenience (encode,
walk, decode to filter strings) for a stand-alone :class:`NfaTable`:
the rule engine's ``compile_table`` and the ACL batch path
(``auth/authz.py`` ``batch_authorize``) run it, one walk a call.

The second phase of the two-phase readback (the reference's XLA
function K5, :func:`fetch_flat_prefix` and :func:`fetch_flat_ragged`)
copies the head of the flat buffer into a host buffer.  The reference
cuts the copy into power-of-two chunks, or pads it to a power-of-two
capacity class, only to bound its number of XLA executables; here
``matches[:n]`` is a view, so each is one non-blocking copy (``ragged``
keeps the reference's padded length, so that its bytes are the
reference's).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from .compiler import NfaTable, encode_topics
from .walk_kernel import _on_card, nfa_walk, nfa_walk_flat

__all__ = ["MatchResult", "SERVE_FLAT_MULT", "ROW_META_COUNT_MASK",
           "ROW_META_SPILL_SHIFT", "decode_flat", "decode_row_meta",
           "epilogue", "fetch_flat_prefix", "fetch_flat_ragged",
           "flat_epilogue_plain", "match_topics",
           "nfa_match", "ragged_capacity"]

#: serving flat-output capacity per padded batch row (ids per topic)
SERVE_FLAT_MULT = 8

#: ``row_meta`` packing: low 16 bits = per-row flat entry count
#: (min(n, K)); bit 16 = the row's fail-open flag (active-set OR match
#: overflow)
ROW_META_COUNT_MASK = 0xFFFF
ROW_META_SPILL_SHIFT = 16

class MatchResult(NamedTuple):
    matches: torch.Tensor      # (B, K) int32, valids first, -1 pad; flat
                               # mode: (flat_cap,) globally compacted ids;
                               # raw mode: (B, C) accept slots
    n_matches: torch.Tensor    # (B,) int32 exact count (may exceed K)
    active_overflow: torch.Tensor  # (B,) int32 per-row active-set spills
    match_overflow: torch.Tensor   # (B,) int32, 1 where truncated
    row_meta: Optional[torch.Tensor] = None  # flat mode only


def decode_row_meta(meta: np.ndarray):
    """(B,) packed row_meta → (per-row flat entry counts, spilled bool)."""
    return (meta & ROW_META_COUNT_MASK), (meta >> ROW_META_SPILL_SHIFT) > 0


def fetch_flat_prefix(matches: torch.Tensor, total: int,
                      out: torch.Tensor) -> torch.Tensor:
    """Phase 2 of the two-phase readback: the first ``total`` ids of the
    flat buffer ``matches`` (at most all of it), in one copy enqueued
    into the head of ``out`` (a host int32 tensor, pinned when
    ``matches`` is on the card) without waiting.  Returns that view: it
    holds the ids once an event recorded after the copy has
    completed."""
    n = min(max(0, int(total)), int(matches.shape[0]))
    view = out[:n]
    if n:
        view.copy_(matches[:n], non_blocking=True)
    return view


def ragged_capacity(total: int, flat_cap: int) -> int:
    """The capacity class of a ragged readback: the smallest power of
    two ≥ ``total``, clipped to the flat buffer's size."""
    if total <= 0:
        return 0
    return min(1 << max(0, int(total) - 1).bit_length(), int(flat_cap))


def fetch_flat_ragged(matches: torch.Tensor, total: int,
                      out: torch.Tensor) -> torch.Tensor:
    """The ragged twin of :func:`fetch_flat_prefix`, with the
    reference's bytes: the first :func:`ragged_capacity` ids in one
    copy (the reference trims them to ``total`` on the host; the caller
    reads the first ``total``)."""
    return fetch_flat_prefix(
        matches, ragged_capacity(total, int(matches.shape[0])), out)


def decode_flat(matches: np.ndarray, n_matches: np.ndarray,
                max_matches: int) -> List[np.ndarray]:
    """Split a flat-mode ``matches`` buffer into per-row id arrays."""
    nk = np.minimum(n_matches, max_matches)
    offs = np.cumsum(nk) - nk
    return [matches[o:o + c] for o, c in zip(offs, nk)]


def _compact(cand: torch.Tensor, width: int) -> torch.Tensor:
    """(B, C) → (B, width): the first ``width`` valid ids of each row in
    column order, -1 padded."""
    B = cand.shape[0]
    valid = cand >= 0
    pos = torch.cumsum(valid, dim=1, dtype=torch.int32) - 1
    keep = valid & (pos < width)
    out = torch.full((B, width + 1), -1, dtype=torch.int32,
                     device=cand.device)
    # dropped entries all land in the spare column `width`
    out.scatter_(1, torch.where(keep, pos, width).long(),
                 torch.where(keep, cand, -1))
    return out[:, :width].contiguous()


def flat_epilogue_plain(acc, aover, max_matches: int, flat_cap: int):
    """The flat epilogue as PyTorch ops, on any device: the row counts
    ``n``, a per-row top-K compaction, a global cumsum-offset scatter
    into one ``(flat_cap,)`` buffer (writes past the end dropped) and
    the packed ``row_meta``.  Returns ``(matches, n, mover, row_meta)``."""
    n = (acc >= 0).sum(dim=1, dtype=torch.int32)
    K = max_matches
    per_row = _compact(acc, K)                             # (B, K)
    nk = torch.clamp(n, max=K)
    offs = torch.cumsum(nk, dim=0, dtype=torch.int32) - nk
    col = torch.arange(K, dtype=torch.int32, device=acc.device)[None, :]
    idx = offs[:, None] + col
    keep = (col < nk[:, None]) & (idx < flat_cap)
    out = torch.full((flat_cap + 1,), -1, dtype=torch.int32,
                     device=acc.device)
    out.scatter_(0, torch.where(keep, idx, flat_cap).reshape(-1).long(),
                 torch.where(keep, per_row, -1).reshape(-1))
    matches = out[:flat_cap].contiguous()
    mover = ((n > K) | (offs + nk > flat_cap)).to(torch.int32)
    spilled = ((aover > 0) | (mover > 0)).to(torch.int32)
    row_meta = nk | (spilled << ROW_META_SPILL_SHIFT)
    return matches, n, mover, row_meta


def random_accepts(seed: int, B: int, C: int):
    """Seeded raw accept slots for the flat epilogue's plain checks: ``(acc
    (B, C), aover (B,))`` int32 numpy, rows of every density (empty,
    sparse, a fifth, half and all valid; ids in [0, 2**20)) and spills
    on about a quarter of the rows."""
    rng = np.random.default_rng(seed)
    share = rng.choice([0.0, 0.03, 0.2, 0.5, 1.0], B)
    acc = np.where(rng.random((B, C)) < share[:, None],
                   rng.integers(0, 1 << 20, (B, C)), -1)
    aover = np.where(rng.random(B) < 0.25, rng.integers(1, 5, B), 0)
    return acc.astype(np.int32), aover.astype(np.int32)


def epilogue(acc, aover, max_matches: int, compact_output: bool,
             flat_cap: int) -> MatchResult:
    """The output of a walk's raw accept slots ``acc`` and spills
    ``aover``: flat when ``flat_cap`` > 0, else compact or raw.  Shared
    by every walk backend.  Flat mode here is :func:`flat_epilogue_plain`
    on CPU tensors only: on the card it is fused into the walk, and a
    flat call on CUDA accept slots raises."""
    K = max_matches
    row_meta = None
    if flat_cap:
        if _on_card("epilogue", acc):
            raise ValueError(
                "a flat match on the card is one fused walk launch "
                "(nfa_match / join_match with flat_cap); there is no "
                "epilogue over raw accept slots on cuda")
        matches, n, mover, row_meta = flat_epilogue_plain(acc, aover, K,
                                                          flat_cap)
    else:
        n = (acc >= 0).sum(dim=1, dtype=torch.int32)
        if compact_output:
            matches = _compact(acc, K)
            mover = (n > K).to(torch.int32)
        else:
            matches = acc
            mover = torch.zeros_like(n)
    return MatchResult(matches=matches, n_matches=n, active_overflow=aover,
                       match_overflow=mover, row_meta=row_meta)


def nfa_match(words, lens, is_sys, node_tab, edge_tab, seeds, *,
              active_slots: int = 16, max_matches: int = 32,
              compact_output: bool = True, flat_cap: int = 0) -> MatchResult:
    """The hash walk over one encoded batch, then the flat
    (``flat_cap`` > 0), compact or raw epilogue.  Flat mode on CUDA
    tensors is one launch of the walk with the epilogue fused
    (:func:`~emqx_tpu_torch.ops.walk_kernel.nfa_walk_flat`)."""
    if flat_cap and _on_card("nfa_match", words):
        return MatchResult(*nfa_walk_flat(
            words, lens, is_sys, node_tab, edge_tab, seeds,
            active_slots=active_slots, max_matches=max_matches,
            flat_cap=flat_cap))
    acc, aover = nfa_walk(words, lens, is_sys, node_tab, edge_tab, seeds,
                          active_slots=active_slots)
    return epilogue(acc, aover, max_matches, compact_output, flat_cap)


def match_topics(table: NfaTable, names: Sequence[str],
                 active_slots: int = 16, max_matches: int = 32, *,
                 device: Union[None, str, torch.device] = None
                 ) -> List[List[str]]:
    """Encode ``names``, walk them through ``table`` in one hash walk on
    ``device`` (the card unless the caller names another; ``"cpu"`` runs
    the plain walk) and decode each row to its matching filters, in the
    compact order.  Raises OverflowError if a row's active set spilled
    or it matched more than ``max_matches`` filters (callers wanting
    fail-open use :func:`nfa_match` directly)."""
    from .device_table import resolve_device

    dev = resolve_device(device)
    words, lens, is_sys = encode_topics(table, names)
    ops = [torch.from_numpy(a).to(dev)
           for a in (words, lens, is_sys, *table.device_arrays())]
    res = nfa_match(*ops, active_slots=active_slots,
                    max_matches=max_matches)
    aover = int(res.active_overflow.sum())
    mover = int(res.match_overflow.sum())
    if aover or mover:
        raise OverflowError(
            f"match overflow: active={aover} rows>{max_matches}={mover}")
    matches = res.matches.cpu().numpy()
    counts = res.n_matches.cpu().numpy()
    acc = table.accept_filters
    return [[acc[a] for a in matches[r, :counts[r]]]
            for r in range(len(names))]
