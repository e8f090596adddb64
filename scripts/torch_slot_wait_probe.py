#!/usr/bin/env python3
"""Where the event loop stalls while a pipelined slot waits on the card.

Runs the scenario of ``tests/test_torch_cuda.py::
test_pipeline_slot_wait_keeps_the_loop_responsive`` (2,000 workload
filters, a ``MatchService(pipeline=True)``, a ``prefetch_many`` of 256
topics behind ~0.3 s of ``torch.cuda._sleep``, a heartbeat task on the
same loop) in fresh processes, several rounds in each, beside two
controls with the same heartbeat and no service work:

* ``idle``: the heartbeat alone for 0.3 s;
* ``card_wait``: ``torch.cuda._sleep`` and the service's own event poll
  (``match_service._event_done``) on an event recorded behind it;
* ``slot_wait``: the test's scenario.

Each runs with two heartbeats: ``timer`` sleeps 1 ms between beats, as
the test's does, so a gap also holds the timer's overshoot; ``yield``
only yields (``asyncio.sleep(0)``), so the loop never waits on a timer
and a gap is the time other callbacks, or the OS, held the loop's
thread.  Every gap over ``--gap-ms`` of ``slot_wait`` lists the spans of
the service's steps it overlaps, timed by wrapping them: encode and
dispatch (``_encode_dispatch``, ``put_batch``, ``match``), the slot
(``_make_slot``, ``_take_bufs``), the event polls (``Event.query``),
the readback copies (``fetch_flat_*``), the rows and hints
(``_rows_from_twophase``, ``_collect_rows``, ``_mint_hints``), and the
collector's pauses (``gc.callbacks``).  Beside them, the overshoot of
200 ``time.sleep(0.001)`` calls measures the host's timer.

Run it on a machine with a CUDA card, from the root of a checkout::

    python scripts/torch_slot_wait_probe.py [--procs 6] [--rounds 4]
        [--gap-ms 2] [--out trace/slot_wait_probe.json]

It prints one JSON summary line and writes every round's gaps to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SCENARIOS = ("idle", "card_wait", "slot_wait")
BEATS = ("timer", "yield")


def _child(rounds: int, gap_ms: float) -> dict:
    import asyncio
    import gc

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from emqx_tpu_torch.broker import match_service as msmod
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.broker.match_service import MatchService
    from emqx_tpu_torch.observe import Metrics
    from emqx_tpu_torch.workload import build_workload

    spans = []      # (name, t0, t1)
    gcs = []        # (generation, t0, t1)

    def timed(name, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spans.append((name, t0, time.perf_counter()))
        return wrapped

    gc_start = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            gcs.append((info["generation"], gc_start[0],
                        time.perf_counter()))
    gc.callbacks.append(on_gc)

    torch.cuda.Event.query = timed("event.query", torch.cuda.Event.query)
    for name in ("fetch_flat_prefix", "fetch_flat_ragged"):
        setattr(msmod, name, timed(name, getattr(msmod, name)))

    filters, topics = build_workload(np.random.default_rng(7), 2000, 512)
    _f, extra = build_workload(np.random.default_rng(8), 10,
                               256 * 2 * rounds)
    batches = [topics[256:]] + [extra[256 * k:256 * (k + 1)]
                                for k in range(2 * rounds - 1)]
    sleeps = []
    for _ in range(200):
        t0 = time.perf_counter()
        time.sleep(0.001)
        sleeps.append((time.perf_counter() - t0) * 1e3)

    async def main():
        loop = asyncio.get_running_loop()
        b = Broker()
        b.open_session("c")
        for f in filters:
            b.subscribe("c", f)
        ms = MatchService(b, Metrics(), bypass_rate=0, debounce_s=0.01,
                          prefetch_timeout_s=30, pipeline=True)
        for name in ("_encode_dispatch", "_make_slot", "_take_bufs",
                     "_rows_from_twophase", "_collect_rows", "_mint_hints"):
            setattr(ms, name, timed(name, getattr(ms, name)))
        await ms.start()
        out = []
        try:
            for _ in range(2000):
                if ms.ready:
                    break
                await asyncio.sleep(0.01)
            assert ms.ready
            for name in ("put_batch", "match"):
                setattr(ms.dev, name, timed(name, getattr(ms.dev, name)))
            await ms.prefetch_many(topics[:256])   # buffers allocated

            async def run(scenario: str, beat_kind: str, batch):
                beats = []
                stop = asyncio.Event()
                pause = 0.001 if beat_kind == "timer" else 0

                async def heartbeat():
                    last = loop.time()
                    while not stop.is_set():
                        await asyncio.sleep(pause)
                        now = loop.time()
                        beats.append((last, now))
                        last = now
                beat = asyncio.ensure_future(heartbeat())
                await asyncio.sleep(0.01)
                del spans[:], gcs[:]
                t0 = loop.time()
                if scenario == "idle":
                    await asyncio.sleep(0.3)
                else:
                    torch.cuda._sleep(600_000_000)  # ~0.3 s at boost clock
                    if scenario == "card_wait":
                        ev = torch.cuda.Event()
                        ev.record()
                        await msmod._event_done(ev)
                    else:
                        await ms.prefetch_many(batch)
                waited = loop.time() - t0
                stop.set()
                await beat
                gaps = []
                for a, z in beats:
                    if (z - a) * 1e3 < gap_ms:
                        continue

                    def inside(t0_, t1_):
                        return t1_ > a and t0_ < z
                    gaps.append({
                        "gap_ms": (z - a) * 1e3, "at_ms": (a - t0) * 1e3,
                        "span_ms": {n: sum((t1_ - t0_) * 1e3
                                           for m, t0_, t1_ in spans
                                           if m == n and inside(t0_, t1_))
                                    for n in {s[0] for s in spans}},
                        "gc": [(g, (t1_ - t0_) * 1e3) for g, t0_, t1_ in gcs
                               if inside(t0_, t1_)]})
                return {"scenario": scenario, "beat": beat_kind,
                        "waited_s": waited, "beats": len(beats),
                        "max_gap_ms": max((z - a) for a, z in beats) * 1e3,
                        "gaps": gaps}

            k = 0
            for _r in range(rounds):
                for beat_kind in BEATS:
                    for scenario in SCENARIOS:
                        batch = None
                        if scenario == "slot_wait":
                            batch, k = batches[k], k + 1
                        out.append(await run(scenario, beat_kind, batch))
        finally:
            await ms.stop()
            gc.unfreeze()
        return out

    return {"sleep_1ms_ms": {"p50": statistics.median(sleeps),
                             "p99": sorted(sleeps)[197],
                             "max": max(sleeps)},
            "runs": asyncio.run(main())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--gap-ms", type=float, default=2.0)
    ap.add_argument("--out", default="trace/slot_wait_probe.json")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(_child(args.rounds, args.gap_ms)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_slot_wait_probe: no CUDA device", file=sys.stderr)
        return 2
    procs = []
    for _k in range(args.procs):
        cmd = [sys.executable, __file__, "--child", "--rounds",
               str(args.rounds), "--gap-ms", str(args.gap_ms)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600, cwd=ROOT)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        procs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(procs, indent=1))
    summary = {"probe": "slot_wait", "procs": len(procs),
               "rounds_per_proc": args.rounds,
               "sleep_1ms_ms": [p["sleep_1ms_ms"] for p in procs],
               "out": args.out}
    for scenario in SCENARIOS:
        for beat_kind in BEATS:
            runs = [r for p in procs for r in p["runs"]
                    if r["scenario"] == scenario and r["beat"] == beat_kind]
            gaps = [g for r in runs for g in r["gaps"] if g["gap_ms"] >= 5]
            causes = {}
            for g in gaps:
                shares = dict(g["span_ms"])
                shares["gc"] = sum(ms for _g, ms in g["gc"])
                top = max(shares.items(), key=lambda kv: kv[1],
                          default=("none", 0.0))
                key = top[0] if top[1] >= 0.5 * g["gap_ms"] else "none"
                causes[key] = causes.get(key, 0) + 1
            summary[f"{scenario}.{beat_kind}"] = {
                "runs": len(runs),
                "runs_with_gap_over_5ms": sum(r["max_gap_ms"] >= 5
                                              for r in runs),
                "max_gap_ms": [round(r["max_gap_ms"], 2) for r in runs],
                "gaps_over_5ms": len(gaps),
                "gaps_over_5ms_by_cause": causes,
                "median_beats": statistics.median(r["beats"] for r in runs)}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
