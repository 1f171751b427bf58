"""The knee of a ``serve_open`` cell: the highest rate the service
sustains, found once by a sweep on the chip.

    python -m benchmark.tools.knee --workload <cell> --seed <n> --seconds <s> --rates 20 40 ...

First each kind and size alone (``--lone`` requests one at a time, closed
loop): the latency limit is ``--limit_factor`` times the slowest of their
medians.  Then, for each rate, the cell's open loop for ``--seconds``:
p50 and p95 from due time to resolution, the rate served, and whether the
backlog grew (the median latency of the last third of the requests over
that of the first third).  The knee is the highest rate whose p95 is
under the limit and whose backlog did not grow (ratio under
``--growth``).  Prints one JSON line per rate and a summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import run
from ..drivers import serve_open as drv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--lone", type=int, default=10)
    ap.add_argument("--limit_factor", type=float, default=4.0)
    ap.add_argument("--growth", type=float, default=1.5)
    args = ap.parse_args(argv)
    spec = run.spec_of()
    cell = run.cell_of(spec, args.workload)
    config, p = run.config_of(spec, cell), run.traffic_of(cell)
    dev = torch.device("cuda", 0)
    svc, _, _, _, images, streams = drv.build(config, p, args.seed, dev)
    svc.start()
    try:
        lone = {}
        for kind in ("c", "d"):
            for s, (h, w) in enumerate(p["sizes"]):
                lat = []
                for k in range(args.lone):
                    t = time.perf_counter()
                    if kind == "c":
                        svc.submit_compress(images[s][k % len(images[s])]).result()
                    else:
                        svc.submit_decompress(streams[s][k % len(streams[s])]).result()
                    lat.append((time.perf_counter() - t) * 1e3)
                lone[f"{kind}{h}x{w}"] = float(np.median(lat))
        limit = args.limit_factor * max(lone.values())
        print(json.dumps({"lone_median_ms": lone, "latency_limit_ms": limit}), flush=True)
        rows = []
        for rate in args.rates:
            q = dict(p, rate_per_s=rate)
            sched = drv.schedule(q, args.seed, args.seconds)
            loop = drv.OpenLoop(svc, sched, images, streams)
            t0 = time.perf_counter()
            loop.run(t0)
            horizon = t0 + args.seconds + 60.0
            loop.wait(horizon)
            lat, failed = loop.latencies_ms(t0, horizon)
            third = max(1, len(lat) // 3)
            growth = float(np.median(lat[-third:]) / max(np.median(lat[:third]), 1e-9))
            row = {"rate_per_s": rate, "requests": len(lat), "failed": failed,
                   "p50_ms": float(np.percentile(lat, 50)), "p95_ms": drv._p95(lat),
                   "served_per_s": (len(lat) - failed) / (max(loop.done, key=lambda v: v or 0)
                                                          - t0),
                   "backlog_growth": growth,
                   "sustained": drv._p95(lat) < limit and growth < args.growth and not failed}
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        svc.stop()
    ok = [r["rate_per_s"] for r in rows if r["sustained"]]
    print(json.dumps({"knee_per_s": max(ok) if ok else None, "latency_limit_ms": limit}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
