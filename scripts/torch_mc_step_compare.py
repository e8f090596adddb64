"""Device and host times of the multichip step (K8a, each form), the
prefix-EP step (K8c), the ring fan-out (K8d, both forms) and the Ulysses
step (K8f) of two checkouts of the port, on one card, in turns.

    python scripts/torch_mc_step_compare.py --old <root of another checkout>

The cases are made once, with this checkout's package, and kept in a
``.npz`` in ``--out`` (deleted at the end), at chip_smoke's shapes:
BASELINE config 2's filters (``workload.build_workload``, seed 0; 1M),
each with its index as its accept id, in a ``MultichipMatcher``'s stacked
tables (tp = 4, depth 16, A = 16, K = 128, Km = 8, native shard tables,
the default slack's capacity), in ``build_partitions``' four native EP
partitions (capacity 512, K = 128) and in one native table (each filter
once, the i-th one subscription of client i % 10,000), and four batches
of B = 2048 of the workload's topics encoded for each.  Each turn is a
child process (both packages are named ``emqx_tpu_torch``) that imports
the package of one root and puts the tables on ``[cuda:0] * 4`` meshes;
the fan-out steps' accept bitmap ``(F+1, W)`` is built on the card (W =
313 words padded to 316 for four positions; its rows padded to a
multiple of four for the ring).  For each of the replicated, routed and
routed+compact forms of ``build_multichip_step``, for
``build_ep_matcher``, and for ``build_ring_fanout``,
``build_ring_fanout_compact`` (cap 64) and ``build_ulysses_step`` (u =
4): checks the step against the same step with the plain versions on
every field (one batch); then a dispatch (K8a as the matcher makes one:
the step on the mesh's stream and its outputs' copies to pinned host
memory; the others the step alone; one in flight: each waited for
before the next, as the serve loop has it) over the four batches in
rotation: device ms from CUDA events around each dispatch on the mesh's
stream, host ms to enqueue it, K8a's host decode of the copies into rows
(``decode_ms``, the matcher's readback), device operations a dispatch
(kernels, copies, memsets) from a ``torch.profiler`` trace of three
dispatches (chip_smoke's ``_device_ops``: the most a call holds, each
device event placed by the host op that launched it, and each call's
events by name), and where the host's time goes (the functions of
largest own time under ``cProfile``, ms a dispatch).  The turns run
old, new, new, old; the card's name and power limit and one JSON object
a turn are printed, then a summary line.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILTERS = 1_000_000
B = 2048
TP = 4
DEPTH = 16
A = 16
K = 128
KM = 8
EP_K = 128
EP_CAPACITY = 512
BATCHES = 4
DISPATCHES = 20
CAP = 64
CLIENTS = 10_000
FORMS = (("replicated", False, False), ("routed", True, False),
         ("routed_compact", True, True))
ARRAYS = ("node_stk", "edge_stk", "seeds_stk", "aid_stk", "micro_node",
          "micro_edge", "micro_seeds", "micro_amap", "word_owner")


def make_cases(path: str) -> dict:
    """The stacked tables, the EP partitions, the fan-out table with its
    filters' accept ids and clients, and the batches, saved to ``path``;
    returns their sizes."""
    sys.path.insert(0, HERE)
    import torch

    from emqx_tpu_torch.native.nfa import NativeNfa
    from emqx_tpu_torch.ops.encode import TopicEncoder, encode_batch
    from emqx_tpu_torch.parallel import MultichipMatcher, build_partitions
    from emqx_tpu_torch.workload import build_workload

    filters, topics = build_workload(np.random.default_rng(0), FILTERS,
                                     BATCHES * B)
    mc = MultichipMatcher(depth=DEPTH, tp=TP,
                          devices=[torch.device("cpu")] * TP,
                          active_slots=A, max_matches=K, native=True)
    mc.rebuild([(f, i) for i, f in enumerate(filters)])
    assert mc.apply_pending()
    _shape, arrays = mc._stacked()
    out = dict(zip(ARRAYS, arrays))
    out["capacity"] = np.array([mc.ep_capacity(B)])
    eps = build_partitions(filters, TP, depth=DEPTH)
    out.update(ep_node=eps.node_tabs, ep_edge=eps.edge_tabs,
               ep_seeds=eps.seeds)
    enc = TopicEncoder(eps.vocab)
    fan = list(dict.fromkeys(filters))
    nfa = NativeNfa(depth=DEPTH)
    nfa.bulk_add(fan)
    node, edge, seeds = nfa.tables()
    aids = nfa.bulk_aid_of(fan)
    ok = aids >= 0
    out.update(fan_node=node, fan_edge=edge, fan_seeds=seeds,
               fan_aids=aids[ok].astype(np.int64),
               fan_clients=(np.arange(len(fan)) % CLIENTS)[ok],
               fan_accepts=np.array([nfa.n_accepts]))
    for j in range(BATCHES):
        batch = topics[j * B:(j + 1) * B]
        for i, a in enumerate(mc.encode(batch, batch=B)):
            out[f"mc.{j}.{i}"] = a
        for i, a in enumerate(enc.encode(batch, DEPTH, batch=B)):
            out[f"ep.{j}.{i}"] = a
        for i, a in enumerate(encode_batch(nfa, batch, batch=B)):
            out[f"fan.{j}.{i}"] = a
    np.savez(path, **out)
    return {"filters": len(filters), "capacity": int(out["capacity"][0]),
            "shard_filters": [x.n_filters for x in mc._subs],
            "stacked_bytes": int(sum(a.nbytes for a in arrays)),
            "ep_partition_bytes": int(eps.node_tabs.nbytes
                                      + eps.edge_tabs.nbytes),
            "fan_accept_ids": int(nfa.n_accepts),
            "fan_table_bytes": int(node.nbytes + edge.nbytes)}


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module, whichever package
    the turn imports: its ``_device_ops`` reads the device operations a
    dispatch for both scripts."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _fields(out) -> list:
    """A step's outputs as a list of tensors (a ``Sharded`` whole)."""
    if hasattr(out, "parts") and hasattr(out, "full"):
        return [out.full()]
    if isinstance(out, tuple):
        return [t for x in out for t in _fields(x)]
    return [out]


def _fan_bitmap(torch, data, dev):
    """The fan-out steps' accept bitmap on ``dev``: row ``aid`` holds the
    bit of its filter's client; rows padded to a multiple of ``TP`` for
    the ring, words to a multiple of ``TP``."""
    F = int(data["fan_accepts"][0])
    W = (CLIENTS + 31) // 32
    W += (-W) % TP
    bm = torch.zeros((F + 1 + (-(F + 1)) % TP, W), dtype=torch.int32,
                     device=dev)
    subs = data["fan_clients"].astype(np.int64)
    bit = np.int64(1) << (subs & 31)
    bit = np.where(bit >= 1 << 31, bit - (1 << 32), bit).astype(np.int32)
    bm[torch.from_numpy(data["fan_aids"]).to(dev),
       torch.from_numpy(subs >> 5).to(dev)] = torch.from_numpy(bit).to(dev)
    return bm, bm[:F + 1]


def child(root: str, cases_path: str) -> dict:
    """One turn: the package under ``root`` on every step."""
    sys.path.insert(0, root)
    import torch

    from emqx_tpu_torch.parallel import (build_ep_matcher,
                                         build_multichip_step,
                                         build_ring_fanout,
                                         build_ring_fanout_compact,
                                         build_ulysses_step,
                                         decode_compact_rows, make_mesh,
                                         mesh_tables)
    from emqx_tpu_torch.parallel import multichip_serve as mcs

    dev = torch.device("cuda", 0)
    data = np.load(cases_path)
    mesh = make_mesh({"dp": 1, "tp": TP}, [dev] * TP)
    emesh = make_mesh({"ep": TP}, [dev] * TP)
    with mesh.streams():
        tables = mesh_tables(mesh, *(data[k] for k in ARRAYS))
    ep_t = [torch.from_numpy(data[k]).to(dev)
            for k in ("ep_node", "ep_edge", "ep_seeds")]
    enc = [[data[f"mc.{j}.{i}"] for i in range(3)] for j in range(BATCHES)]
    ep_enc = [[torch.from_numpy(np.ascontiguousarray(data[f"ep.{j}.{i}"]))
               .to(dev) for i in range(3)] for j in range(BATCHES)]
    fan_t = [torch.from_numpy(data[k]).to(dev)
             for k in ("fan_node", "fan_edge", "fan_seeds")]
    fan_enc = [[torch.from_numpy(np.ascontiguousarray(data[f"fan.{j}.{i}"]))
                .to(dev) for i in range(3)] for j in range(BATCHES)]
    bm, bm_main = _fan_bitmap(torch, data, dev)
    rmesh = make_mesh({"dp": 1, "ring": TP}, [dev] * TP)
    umesh = make_mesh({"u": TP}, [dev] * TP)
    torch.cuda.synchronize()
    cap = int(data["capacity"][0])
    copy = getattr(mcs, "_host_copy", None)

    def host_copy(res):
        if copy is not None:
            return copy(res, True)
        out = []
        for x in res:
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x, non_blocking=True)
            out.append(h)
        return out

    steps = {}
    for form, routed, compact in FORMS:
        kw = dict(routed=routed, capacity=cap if routed else 0,
                  compact=compact)
        fn = build_multichip_step(mesh, A, K, micro_matches=KM, **kw)
        plain = build_multichip_step(mesh, A, K, micro_matches=KM,
                                     plain=True, **kw)
        steps[form] = (mesh, lambda j, fn=fn: host_copy(fn(*enc[j], tables)),
                       lambda fn=fn, plain=plain: [
                           fn(*enc[0], tables), plain(*enc[0], tables)])
    fn = build_ep_matcher(emesh, EP_CAPACITY, A, EP_K)
    plain = build_ep_matcher(emesh, EP_CAPACITY, A, EP_K, plain=True)
    steps["ep"] = (emesh, lambda j, fn=fn: fn(*ep_enc[j], *ep_t),
                   lambda fn=fn, plain=plain: [fn(*ep_enc[0], *ep_t),
                                               plain(*ep_enc[0], *ep_t)])
    kw = dict(active_slots=A, max_matches=K)
    compact = functools.partial(build_ring_fanout_compact, cap_row=CAP)
    for name, m, build, b in (("ring", rmesh, build_ring_fanout, bm),
                              ("ring_compact", rmesh, compact, bm),
                              ("ulysses", umesh, build_ulysses_step,
                               bm_main)):
        fn, plain = build(m, **kw), build(m, plain=True, **kw)
        steps[name] = (m, lambda j, fn=fn, b=b: fn(*fan_enc[j], *fan_t, b),
                       lambda fn=fn, plain=plain, b=b: [
                           fn(*fan_enc[0], *fan_t, b),
                           plain(*fan_enc[0], *fan_t, b)])
    device_ops = _chip_smoke()._device_ops
    out = {"root": root, "steps": {}}
    for name, (m, dispatch, pair) in steps.items():
        stream = m.stream_of[dev]
        with m.streams():
            got, want = pair()
            torch.cuda.synchronize()
            for i, (g, w) in enumerate(zip(_fields(got), _fields(want))):
                if not torch.equal(g, w):
                    raise SystemExit(f"{root}: {name} output {i} differs "
                                     "from the plain step")
            for j in range(BATCHES):          # warm-up
                dispatch(j)
            torch.cuda.synchronize()
            marks, host, decode = [], [], []
            for i in range(DISPATCHES):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record(stream)
                t0 = time.perf_counter()
                res = dispatch(i % BATCHES)
                host.append((time.perf_counter() - t0) * 1e3)
                e1.record(stream)
                marks.append((e0, e1))
                # one batch in flight, as the serve loop has it: the copies
                # land before the next dispatch (its pinned buffers free)
                torch.cuda.synchronize()
                if name in {f for f, _r, _c in FORMS}:
                    t0 = time.perf_counter()
                    _decode(decode_compact_rows, res)
                    decode.append((time.perf_counter() - t0) * 1e3)
                del res
            ops = device_ops(torch, lambda: dispatch(0))

            def loop():
                for i in range(DISPATCHES):
                    dispatch(i % BATCHES)
                    torch.cuda.synchronize()
            prof = _host_profile(loop)
        dev_ms = [a.elapsed_time(b) for a, b in marks]
        out["steps"][name] = {
            "device_ms": float(np.mean(dev_ms)),
            "device_ms_p50": float(np.median(dev_ms)),
            "host_ms": float(np.mean(host)),
            "decode_ms": float(np.mean(decode)) if decode else None,
            "device_ops_per_dispatch": ops["per_dispatch"],
            "device_ops": ops, "dispatches": DISPATCHES,
            "equal_to_plain": True, "host_profile_ms": prof}
    return out


def _decode(decode_compact_rows, host) -> list:
    """The matcher's readback decode of a dispatch's host copies: each
    row's service ids, the -1s dropped."""
    ids, counts = host[0].numpy(), host[1].numpy()
    rows = decode_compact_rows(ids, counts, ids.shape[1] // counts.shape[1])
    return [[int(a) for a in row if a >= 0] for row in rows]


def _host_profile(fn, top: int = 12) -> dict:
    """Where the host's time of ``DISPATCHES`` dispatches goes: the
    functions of largest own time under ``cProfile``, ms a dispatch (the
    profiler's own cost inflates them all)."""
    import cProfile
    import pstats

    pr = cProfile.Profile()
    pr.enable()
    fn()
    pr.disable()
    st = pstats.Stats(pr).stats
    rows = sorted(((tt, f"{os.path.basename(f)}:{ln}({fname})")
                   for (f, ln, fname), (_cc, _nc, tt, _ct, _c) in st.items()),
                  reverse=True)[:top]
    return {name: tt * 1e3 / DISPATCHES for tt, name in rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="root of the other checkout")
    ap.add_argument("--out", help="directory for the cases file (default: a "
                    "new temporary directory)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--cases", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child, args.cases)), flush=True)
        return 0
    if not args.old:
        ap.error("--old is required")
    import torch

    if not torch.cuda.is_available():
        print("torch_mc_step_compare: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = args.out or tempfile.mkdtemp(prefix="mc_step_compare_")
    os.makedirs(out, exist_ok=True)
    cases = os.path.join(out, "mc_step_compare_cases.npz")
    try:
        return _turns(args, card, cases)
    finally:
        if os.path.exists(cases):
            os.remove(cases)


def _turns(args, card: str, cases: str) -> int:
    t0 = time.perf_counter()
    sizes = make_cases(cases)
    print(json.dumps({"cases_s": time.perf_counter() - t0, **sizes}),
          flush=True)
    old, new = os.path.abspath(args.old), HERE
    turns = []
    for label, root in (("old", old), ("new", new), ("new", new),
                        ("old", old)):
        got = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root,
             "--cases", cases], capture_output=True, text=True)
        if got.returncode != 0:
            print(got.stderr[-4000:], file=sys.stderr)
            return got.returncode
        turn = {"turn": label, **json.loads(got.stdout.splitlines()[-1])}
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    keys = ("device_ms", "host_ms", "device_ops_per_dispatch", "decode_ms")
    summary = {name: {label: [[t["steps"][name][k] for k in keys]
                              for t in turns if t["turn"] == label]
                      for label in ("old", "new")}
               for name in turns[0]["steps"]}
    print(json.dumps({"card": card, "device_ms_host_ms_ops_decode_ms":
                      summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
