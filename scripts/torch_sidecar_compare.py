"""The exhook sidecar phase of ``chip_smoke.py`` (``exhook_sidecar``) for
two checkouts of the port on one card, in turns: old, new, new, old.

    python scripts/torch_sidecar_compare.py --old <root of another checkout>

Each turn is a child process that imports ``chip_smoke`` from its root
(the sidecar process it spawns imports that root's package), builds the
root's kernels and native libraries, makes the shared 1M workload
(BASELINE config 2, seed 0) and runs ``phase_exhook_sidecar`` on it.
The card's name and power limit, each turn's ``exhook_sidecar`` line and
a summary (``OnMessagePublish`` calls/s and mean micro-batch,
``MatchBatch`` topics/s, by turn) are printed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root: str) -> None:
    """One turn: ``exhook_sidecar`` of the checkout at ``root``."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from emqx_tpu_torch.ops import cuda_build

    cuda_build.build()
    cs._native_build()
    shared = cs.shared_workload(1_000_000, cs.SERVE_BATCHES
                                + cs.JOIN_SMALL_BATCHES + cs.AFTER_BATCHES)
    cs.phase_exhook_sidecar(torch, torch.device("cuda", 0), shared,
                            cs.nvidia_smi())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="root of the other checkout")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_sidecar_compare: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    turns = []
    for label, root in (("old", os.path.abspath(args.old)), ("new", HERE),
                        ("new", HERE), ("old", os.path.abspath(args.old))):
        got = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root],
            capture_output=True, text=True, check=True, cwd=root)
        line = next(json.loads(ln) for ln in got.stdout.splitlines()
                    if ln.startswith('{"phase": "exhook_sidecar"'))
        print(json.dumps({"turn": label, "root": root, **line}), flush=True)
        turns.append((label, line))
    summary = {label: [{
        "publish_calls_per_s": ln["publish_burst"]["calls_per_s"],
        "mean_micro_batch": ln["publish_burst"]["mean_micro_batch"],
        "match_batch_topics_per_s": ln["match_batch"]["topics_per_s"]}
        for lab, ln in turns if lab == label] for label in ("old", "new")}
    print(json.dumps({"card": card, "exhook_sidecar": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
