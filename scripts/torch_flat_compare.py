"""Device times of the flat match (``nfa_match`` / ``join_match`` with
``flat_cap``) of two checkouts of the port, on one card, in turns.

    python scripts/torch_flat_compare.py --old <root of another checkout>

The cases are made once, with this checkout's package, and kept in a
``.npz`` in ``--out`` (deleted at the end): BASELINE config 2's filters
(``workload.build_workload``, seed 0; ``--filters``, 1M by default) in a
native table at depth 16, its join relation (sorted from the cuckoo
table, empty overlay), and four batches of B = 2048 of the workload's
topics at each of D = 4, 8 and 16.  Each turn is a child process (both
packages are named ``emqx_tpu_torch``) that imports the package of one
root and, for each backend (hash, join) and depth, checks the flat match
(K = 128, flat_cap = 8·B) against the plain walk and
``flat_epilogue_plain`` on every batch, all five fields, then times it
with CUDA events behind a ``torch.cuda._sleep`` (as
``chip_smoke.timer``), rotating over the four batches (``ms``), and the
raw walk on the same batches beside (``raw_ms``): ``ms - raw_ms`` is
what the flat epilogue adds.  The turns run old, new, new, old; the
card's name and power limit and one JSON object a turn are printed,
then a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2048
K = 128
CAP = 8 * B
A = 16
DEPTHS = (4, 8, 16)
BATCHES = 4
FIELDS = ("matches", "n_matches", "active_overflow", "match_overflow",
          "row_meta")


def make_cases(path: str, n_filters: int) -> dict:
    """The table, its relation and the batches, saved to ``path``;
    returns the table's sizes."""
    sys.path.insert(0, HERE)
    from emqx_tpu_torch.native.nfa import NativeNfa
    from emqx_tpu_torch.ops import encode_batch
    from emqx_tpu_torch.ops.join_match import JoinRelation
    from emqx_tpu_torch.workload import build_workload

    filters, topics = build_workload(np.random.default_rng(0), n_filters,
                                     4 * BATCHES * B)
    table = NativeNfa(depth=16)
    table.bulk_add(filters)
    node, edge, seeds = table.tables()
    rel = JoinRelation(int(node.shape[0]), edge)
    out = {"node": node, "edge": edge, "seeds": seeds}
    for name, a in zip(("state_start", "edge_word", "edge_next", "overlay"),
                       rel.arrays()):
        out[name] = a
    for depth in DEPTHS:
        # topics with at most `depth` levels: a depth group of the serve
        pool = [t for t in topics if t.count("/") < depth]
        for j in range(BATCHES):
            enc = encode_batch(table, pool[j * B:(j + 1) * B], batch=B,
                               depth=depth)
            for i, a in enumerate(enc):
                out[f"D{depth}.{j}.{i}"] = a
    np.savez(path, **out)
    sizes = {"filters": len(filters), "states": int(node.shape[0]),
             "buckets": int(edge.shape[0])}
    table.close()
    return sizes


def child(root: str, cases_path: str) -> dict:
    """One turn: the package under ``root`` on every case."""
    sys.path.insert(0, root)
    import torch

    from emqx_tpu_torch.ops import join_match, nfa_match
    from emqx_tpu_torch.ops.match_kernel import flat_epilogue_plain
    from emqx_tpu_torch.ops.walk_kernel import (
        join_walk, join_walk_plain, nfa_walk, nfa_walk_plain)

    dev = torch.device("cuda", 0)
    data = np.load(cases_path)

    def put(key):
        return torch.from_numpy(np.ascontiguousarray(data[key])).to(dev)

    tables = {"hash": [put(k) for k in ("node", "edge", "seeds")],
              "join": [put(k) for k in ("node", "state_start", "edge_word",
                                        "edge_next", "overlay")]}
    fns = {"hash": (nfa_match, nfa_walk, nfa_walk_plain),
           "join": (join_match, join_walk, join_walk_plain)}
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    torch.cuda._sleep(50_000_000)
    e.record()
    torch.cuda.synchronize()
    cycles_per_ms = 50_000_000 / s.elapsed_time(e)

    def timed(fn, reps: int) -> dict:
        fn()
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        cover_ms = 2 * (time.perf_counter() - t0) * 1e3 + 5
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(int(cover_ms * cycles_per_ms))
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return {"ms": a.elapsed_time(b) / reps,
                "covered": enqueue_ms < cover_ms}

    out = {"root": root, "cases": {}}
    for backend, (match, walk, plain) in fns.items():
        for depth in DEPTHS:
            batches = [[put(f"D{depth}.{j}.{i}") for i in range(3)]
                       + tables[backend] for j in range(BATCHES)]
            for args in batches:
                got = match(*args, active_slots=A, max_matches=K,
                            flat_cap=CAP)
                acc, aover = plain(*args, active_slots=A)
                matches, n, mover, meta = flat_epilogue_plain(acc, aover, K,
                                                              CAP)
                for f, w in zip(FIELDS, (matches, n, aover, mover, meta)):
                    if not torch.equal(getattr(got, f), w):
                        raise SystemExit(f"{root}: {backend} D={depth} "
                                         f"field {f} differs from plain")
            turn = [0]

            def flat():
                turn[0] += 1
                match(*batches[turn[0] % BATCHES], active_slots=A,
                      max_matches=K, flat_cap=CAP)

            def raw():
                turn[0] += 1
                walk(*batches[turn[0] % BATCHES], active_slots=A)

            f1, r1, r2, f2 = (timed(fn, 50 * BATCHES)
                              for fn in (flat, raw, raw, flat))
            out["cases"][f"{backend}_D{depth}"] = {
                "B": B, "D": depth, "K": K, "flat_cap": CAP,
                "batches": BATCHES, "ms": (f1["ms"] + f2["ms"]) / 2,
                "raw_ms": (r1["ms"] + r2["ms"]) / 2,
                "turns_ms": [x["ms"] for x in (f1, r1, r2, f2)],
                "covered": all(x["covered"] for x in (f1, r1, r2, f2)),
                "equal": True}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="root of the other checkout")
    ap.add_argument("--filters", type=int, default=1_000_000)
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
        print("torch_flat_compare: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = args.out or tempfile.mkdtemp(prefix="flat_compare_")
    os.makedirs(out, exist_ok=True)
    cases = os.path.join(out, "flat_compare_cases.npz")
    try:
        return _turns(args, card, cases)
    finally:
        if os.path.exists(cases):
            os.remove(cases)


def _turns(args, card: str, cases: str) -> int:
    t0 = time.perf_counter()
    sizes = make_cases(cases, args.filters)
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
    summary = {name: {label: [[t["cases"][name][k] for k in ("ms", "raw_ms")]
                              for t in turns if t["turn"] == label]
                      for label in ("old", "new")}
               for name in turns[0]["cases"]}
    print(json.dumps({"card": card, "ms_and_raw_ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
