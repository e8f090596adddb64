"""Host seconds of the two builds of ``prefix_ep.build_partitions`` on
BASELINE config 2's 1M filters (seed 0) over four partitions at depth
16, as chip_smoke's ``multichip_fanout`` builds them: the ``NativeNfa``
tables it takes from ``NATIVE_FROM`` filters on, then the Python
``IncrementalNfa`` tables (byte for byte the reference's) that it takes
below.  Host only (no card); prints one JSON line.

    python scripts/torch_ep_build_time.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from emqx_tpu_torch.parallel import prefix_ep  # noqa: E402
from emqx_tpu_torch.workload import build_workload  # noqa: E402

N_FILTERS, PARTS, DEPTH = 1_000_000, 4, 16


def main() -> int:
    filters, _ = build_workload(np.random.default_rng(0), N_FILTERS, 1)
    out = {"filters": len(filters), "parts": PARTS, "depth": DEPTH,
           "native_from": prefix_ep.NATIVE_FROM, "cpus": os.cpu_count()}
    for name, native_from in (("native", 0), ("python", N_FILTERS + 1)):
        prefix_ep.NATIVE_FROM = native_from
        t0 = time.perf_counter()
        tabs = prefix_ep.build_partitions(filters, PARTS, depth=DEPTH)
        out[name + "_s"] = time.perf_counter() - t0
        out[name + "_shape"] = [list(tabs.node_tabs.shape),
                                list(tabs.edge_tabs.shape)]
        print(json.dumps({name: out[name + "_s"]}), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
