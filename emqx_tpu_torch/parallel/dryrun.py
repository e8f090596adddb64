"""The multi-device dry run: every library step of the fan-out at a
non-trivial size on a list of devices, each checked against the
single-device walk and the host oracles.

The port of the reference's ``__graft_entry__.py`` ``dryrun_multichip``
(configs 2/3, 4 and 5, the EP matcher and the Ulysses reshard).  The
mesh shapes follow from ``len(devices)`` by the reference's rules; a
device may repeat (``[cpu] * 8`` on the CPU, ``[cuda:0] * 4`` on one
card).  Run it on the card with::

    python -m emqx_tpu_torch.parallel.dryrun          # every visible card
    python -m emqx_tpu_torch.parallel.dryrun cuda:0 cuda:0 cuda:0 cuda:0

and on the CPU with ``python -m emqx_tpu_torch.parallel.dryrun --cpu 8``.
"""

from __future__ import annotations

import argparse
import sys
import time
import zlib
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import topic as T
from ..ops import compile_filters, encode_topics, nfa_match
from ..ops.encode import TopicEncoder
from .mesh import default_devices, make_mesh, pick_shape
from .prefix_ep import build_ep_matcher, build_partitions
from .ring_fanout import build_ring_fanout, shard_bitmap_rows
from .shared_group import build_shared_selector, host_pick, make_group_masks
from .sharded_match import build_sharded_matcher, make_accept_bitmap
from .ulysses import build_ulysses_step, build_unreshard

__all__ = ["dryrun_multichip"]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"dryrun_multichip: {what}")


def _or_rows(matches: np.ndarray, bitmap: np.ndarray) -> np.ndarray:
    """The host OR of each row's matched bitmap rows."""
    out = np.zeros((matches.shape[0], bitmap.shape[1]), np.uint32)
    for r in range(matches.shape[0]):
        for a in matches[r][matches[r] >= 0]:
            out[r] |= bitmap[a]
    return out


def dryrun_multichip(devices: Optional[Sequence[Union[str, torch.device]]]
                     = None, *, verbose: bool = True) -> Dict[str, Dict]:
    """Run every fan-out step over ``devices`` (default: every visible
    card) at the reference's dry-run sizes: 4,096 topics, 65,536
    subscribers, K = 16 over 1,500 filters; 16 ``$share`` groups; EP at
    512 topics.  Raises AssertionError on the first disagreement with
    the single-device walk or a host oracle; returns what each config
    checked."""
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else default_devices())]
    n = len(devs)
    lead = devs[0]
    shape = pick_shape(n)
    mesh = make_mesh(shape, devs)
    rng = np.random.default_rng(7)
    out: Dict[str, Dict] = {}

    def say(msg: str) -> None:
        if verbose:
            print(msg, flush=True)

    # ---- non-trivial workload: 4k batch, 64k subscribers, K=16 ---------
    B, n_subs, K = 4096, 65536, 16
    words = [f"w{i}" for i in range(48)]
    filters = sorted({
        "/".join(("+" if rng.random() < 0.25 else words[rng.integers(48)])
                 for _ in range(rng.integers(1, 6)))
        + ("/#" if rng.random() < 0.3 else "")
        for _ in range(1500)})
    table = compile_filters(filters, depth=8)
    topics = ["/".join(words[rng.integers(48)]
                       for _ in range(rng.integers(1, 7)))
              for _ in range(B)]
    enc = encode_topics(table, topics, batch=B)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(lead)
            for a in (*enc, *table.device_arrays())]

    def subscribers_of(flt):
        h = zlib.crc32(flt.encode())
        return [(h + k * 9973) % n_subs for k in range(1 + h % 6)]

    bitmap = make_accept_bitmap(table, subscribers_of, n_subs, tp=shape["tp"])
    bitmap_t = torch.from_numpy(bitmap.view(np.int32)).to(lead)

    # dense single-device reference (shared by all configs)
    ref = nfa_match(*args, active_slots=16, max_matches=K)
    m = ref.matches.cpu().numpy()
    ref_n = ref.n_matches.cpu().numpy()
    ref_bm = _or_rows(m, bitmap)

    # ---- configs 2/3: dp x tp sharded match + fan-out ------------------
    t0 = time.perf_counter()
    res = build_sharded_matcher(mesh, active_slots=16, max_matches=K)(
        *args, bitmap_t)
    _check(np.array_equal(res.n_matches.cpu().numpy(), ref_n),
           "config 2/3 n_matches")
    _check(np.array_equal(_u32(res.bitmap), ref_bm), "config 2/3 bitmap")
    popc = np.unpackbits(ref_bm.view(np.uint8), axis=1).sum(1)
    _check(np.array_equal(res.n_subscribers.cpu().numpy(), popc),
           "config 2/3 n_subscribers")
    out["config2_3"] = {"mesh": shape, "batch": B, "subs": n_subs,
                        "matches": int(ref_n.sum()),
                        "s": time.perf_counter() - t0}
    say(f"dryrun config2/3 ok: mesh={shape}, batch={B}, subs={n_subs}, "
        f"matches={int(ref_n.sum())}")

    # ---- config 4: on-device $share group selection --------------------
    t0 = time.perf_counter()
    G = 16
    groups = [rng.choice(n_subs, size=int(rng.integers(2, 4000)),
                         replace=False) for _ in range(G - 1)] + [[]]
    masks = make_group_masks(groups, n_subs, bitmap.shape[1])
    sel_hash = rng.integers(0, 2**31 - 1, B).astype(np.int32)
    picked = build_shared_selector(mesh)(
        torch.from_numpy(ref_bm.view(np.int32)).to(lead),
        torch.from_numpy(masks.view(np.int32)).to(lead),
        torch.from_numpy(sel_hash).to(lead)).cpu().numpy()
    for b in range(0, B, 97):   # sampled host parity
        for g in range(G):
            want = host_pick(ref_bm[b], masks[g], int(sel_hash[b]))
            _check(picked[b, g] == want,
                   f"config 4 pick ({b}, {g}): {picked[b, g]} != {want}")
    _check(bool((picked[:, G - 1] == -1).all()), "config 4 empty group")
    out["config4"] = {"groups": G, "selected": int((picked >= 0).sum()),
                      "of": B * G, "s": time.perf_counter() - t0}
    say(f"dryrun config4 ok: groups={G}, selected="
        f"{int((picked >= 0).sum())} of {B * G}")

    # ---- config 5: ring-tiled bitmap OR-reduction ----------------------
    t0 = time.perf_counter()
    ring = max(2, n // shape["dp"])
    rmesh = make_mesh({"dp": n // ring, "ring": ring}, devs)
    rows = shard_bitmap_rows(bitmap, ring)
    got = build_ring_fanout(rmesh, active_slots=16, max_matches=K)(
        *args, torch.from_numpy(rows.view(np.int32)).to(lead))
    _check(np.array_equal(_u32(got), ref_bm), "config 5 bitmap")
    out["config5"] = {"ring": ring, "bitmap_rows": int(rows.shape[0]),
                      "rows_per_shard": int(rows.shape[0] // ring),
                      "W": int(rows.shape[1]), "s": time.perf_counter() - t0}
    say(f"dryrun config5 ok: ring={ring}, bitmap_rows={rows.shape[0]} "
        f"({rows.shape[0] // ring}/shard), W={rows.shape[1]}")

    # ---- EP: prefix-partitioned tables + all-to-all routing ------------
    t0 = time.perf_counter()
    E = 4 if n >= 4 else 2
    ep_tabs = build_partitions(filters, E, depth=8)
    emesh = make_mesh({"ep": E}, devs[:E])
    Bep = 512
    ew, el, es = TopicEncoder(ep_tabs.vocab).encode(topics[:Bep], 8,
                                                    batch=Bep)
    eres = build_ep_matcher(emesh, capacity=max(32, Bep // (E * E) * 4))(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(lead)
          for a in (ew, el, es)),
        *(torch.from_numpy(a).to(lead) for a in (
            ep_tabs.node_tabs, ep_tabs.edge_tabs, ep_tabs.seeds)))
    em, en, eo, eover = (x.cpu().numpy() for x in (
        eres.matches, eres.n_matches, eres.owners, eres.overflow))
    checked = 0
    for i in range(0, Bep, 37):
        if eover[i]:
            continue
        own = int(eo[i])
        got_f = {ep_tabs.accept_filters[own][a] for a in em[i][:en[i]]}
        want_f = {f for f in filters if T.match(topics[i], f)}
        _check(got_f == want_f, f"EP row {topics[i]!r}: {got_f ^ want_f}")
        checked += 1
    out["ep"] = {"parts": E, "batch": Bep, "overflow": int(eover.sum()),
                 "parity_checked": checked, "s": time.perf_counter() - t0}
    say(f"dryrun EP ok: parts={E}, batch={Bep}, "
        f"overflow={int(eover.sum())}, parity_checked={checked}")

    # ---- Ulysses reshard: ingest(batch-sharded) -> dispatch(sub-sharded)
    t0 = time.perf_counter()
    U = 1 << (n.bit_length() - 1)
    umesh = make_mesh({"u": U}, devs[:U])
    ubitmap = make_accept_bitmap(table, subscribers_of, n_subs, tp=U)
    ures = build_ulysses_step(umesh, active_slots=16, max_matches=K)(
        *args, torch.from_numpy(ubitmap.view(np.int32)).to(lead))
    Wu = ubitmap.shape[1]
    uref = _or_rows(m, ubitmap)
    _check(np.array_equal(_u32(ures.dispatch_bitmap.full()), uref),
           "Ulysses dispatch bitmap")
    # the dispatch layout happened: every position holds ALL B rows over
    # a Wu/U column slice (its subscriber range)
    ushapes = {tuple(p.shape) for p in ures.dispatch_bitmap.parts}
    _check(ushapes == {(B, Wu // U)}, f"Ulysses layout {ushapes}")
    bits = np.unpackbits(uref.view(np.uint8), axis=1, bitorder="little")
    _check(np.array_equal(ures.sub_deliveries.full().cpu().numpy(),
                          bits.sum(axis=0, dtype=np.int32)),
           "Ulysses sub_deliveries")
    back = build_unreshard(umesh)(ures.dispatch_bitmap)
    _check(np.array_equal(_u32(back.full()), uref), "Ulysses unreshard")
    _check({tuple(p.shape) for p in back.parts} == {(B // U, Wu)},
           "Ulysses unreshard layout")
    out["ulysses"] = {"u": U, "batch": B, "subs": n_subs,
                      "slice_cols": Wu // U,
                      "deliveries": int(ures.sub_deliveries.full().sum()),
                      "s": time.perf_counter() - t0}
    say(f"dryrun ulysses-reshard ok: u={U}, batch={B}, subs={n_subs}, "
        f"slice_cols={Wu // U}, deliveries={out['ulysses']['deliveries']}")
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("devices", nargs="*",
                    help="mesh devices (default: every visible card)")
    ap.add_argument("--cpu", type=int, default=0,
                    help="run on this many positions of the CPU instead")
    a = ap.parse_args(argv)
    devs = (["cpu"] * a.cpu if a.cpu else a.devices or None)
    dryrun_multichip(devs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
