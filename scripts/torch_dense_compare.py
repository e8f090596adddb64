"""Device times of the dense walk (K6, ``csrc/dense_walk.cu``) of two
checkouts of the port, on one card, in turns.

    python scripts/torch_dense_compare.py --old <root of another checkout>

The cases are made once, with this checkout's package, and kept in a
``.npz`` in ``--out`` (deleted at the end): the tiered matcher's hot
shape (``bench_tiered_workload``'s defaults, seed 5: the hot table and
four hot batches of its stream, B = 8192, D = 8), ``bench_dense``'s
table (S = 2048, four batches of B = 4096) and the random table of
``chip_smoke``'s ``dense_kernel`` at S = 4096 (up to two parents a
column, B = 4096).  Each turn is a child process (both packages are
named ``emqx_tpu_torch``) that imports the package of one root, checks
``dense_match`` against ``dense_match_plain`` on every batch, field for
field, and times it with CUDA events behind a ``torch.cuda._sleep``
(as ``chip_smoke.timer``): one batch repeated (``ms_warm``) and
rotating over the batches (``ms``).  The turns run old, new, new, old;
the card's name and power limit and one JSON object a turn are printed,
then a summary line.  K = 64 throughout (the tiered matcher's).
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
K = 64
FIELDS = ("matches", "n_matches", "active_overflow", "match_overflow")


def make_cases(path: str) -> None:
    """The three cases' tables and batches, saved to ``path``."""
    sys.path.insert(0, HERE)
    import importlib

    from emqx_tpu_torch.ops import encode_topics
    from emqx_tpu_torch.ops.tiered import (_pow2, bench_tiered_workload,
                                           route)

    dm = importlib.import_module("emqx_tpu_torch.ops.dense_match")
    out = {}

    def put(name, dense, batches):
        for i, a in enumerate(dense.device_arrays()):
            # the two 0/1 matrices as their nonzero positions
            out[f"{name}.table.{i}"] = (np.stack(np.nonzero(a)).astype(
                np.int32) if i < 2 else a)
        for j, b in enumerate(batches):
            for i, a in enumerate(b):
                out[f"{name}.batch{j}.{i}"] = a

    B = 8192
    _filters, tiered, topics = bench_tiered_workload(batch=4 * B)
    hot = []
    for i in range(4):
        part = topics[i * B:(i + 1) * B]
        hi, _ = route(part, tiered.hot_roots)
        hot.append(encode_topics(tiered.hot, [part[j] for j in hi],
                                 batch=_pow2(len(hi))))
    put("hot", dm.build_dense(tiered.hot), hot)
    _f, table, dense, topics = dm.bench_dense_workload(batch=4 * 4096)
    put("bench_dense", dense, [encode_topics(
        table, topics[i * 4096:(i + 1) * 4096], batch=4096)
        for i in range(4)])
    put("random_4096", dm.random_dense(4096 * 10 + 2, 4096, 2),
        [dm.random_dense_batch(4096 + 2, 4096, 8)])
    np.savez(path, **out)


def load_cases(path: str):
    data = np.load(path)
    cases = {}
    for key in data.files:
        name, part, i = key.split(".")
        c = cases.setdefault(name, {"table": {}, "batches": {}})
        if part == "table":
            c["table"][int(i)] = data[key]
        else:
            c["batches"].setdefault(int(part[5:]), {})[int(i)] = data[key]
    for c in cases.values():
        S = c["table"][2].shape[0]
        for i in (0, 1):
            m = np.zeros((S, S), np.float32)
            m[tuple(c["table"][i])] = 1.0
            c["table"][i] = m
    return {name: ([c["table"][i] for i in range(5)],
                   [[b[i] for i in range(3)] for _, b in
                    sorted(c["batches"].items())])
            for name, c in cases.items()}


def child(root: str, cases_path: str) -> dict:
    """One turn: the package under ``root`` on every case."""
    sys.path.insert(0, root)
    import importlib

    import torch

    dm = importlib.import_module("emqx_tpu_torch.ops.dense_match")
    dev = torch.device("cuda", 0)
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
    for name, (table, batches) in load_cases(cases_path).items():
        dense = [torch.from_numpy(a).to(dev) for a in table]
        bs = [[torch.from_numpy(a).to(dev) for a in b] for b in batches]
        for b in bs:
            got = dm.dense_match(*b, *dense, max_matches=K)
            want = dm.dense_match_plain(*b, *dense, max_matches=K)
            for f in FIELDS:
                if not torch.equal(getattr(got, f), getattr(want, f)):
                    raise SystemExit(f"{root}: {name} field {f} differs "
                                     "from dense_match_plain")
        turn = [0]

        def rotate():
            turn[0] += 1
            dm.dense_match(*bs[turn[0] % len(bs)], *dense, max_matches=K)

        warm = timed(lambda: dm.dense_match(*bs[0], *dense, max_matches=K),
                     200)
        rot = timed(rotate, 50 * len(bs))
        out["cases"][name] = {
            "S": int(table[2].shape[0]), "B": int(batches[0][0].shape[0]),
            "D": int(batches[0][0].shape[1]), "batches": len(bs),
            "ms_warm": warm["ms"], "ms": rot["ms"],
            "covered": warm["covered"] and rot["covered"], "equal": True}
    return out


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
    import torch

    if not torch.cuda.is_available():
        print("torch_dense_compare: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = args.out or tempfile.mkdtemp(prefix="dense_compare_")
    os.makedirs(out, exist_ok=True)
    cases = os.path.join(out, "dense_compare_cases.npz")
    try:
        return _turns(args, card, cases)
    finally:
        if os.path.exists(cases):
            os.remove(cases)


def _turns(args, card: str, cases: str) -> int:
    t0 = time.perf_counter()
    make_cases(cases)
    print(json.dumps({"cases_s": time.perf_counter() - t0}), flush=True)
    old, new = os.path.abspath(args.old), HERE
    turns = []
    for label, root in (("old", old), ("new", new), ("new", new),
                        ("old", old)):
        got = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root,
             "--cases", cases], capture_output=True, text=True, check=True)
        turn = {"turn": label, **json.loads(got.stdout.splitlines()[-1])}
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    summary = {name: {label: [t["cases"][name]["ms"] for t in turns
                              if t["turn"] == label]
                      for label in ("old", "new")}
               for name in turns[0]["cases"]}
    print(json.dumps({"card": card, "ms_rotating": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
