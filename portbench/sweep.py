#!/usr/bin/env python3
"""Find the highest rate an open-loop serving cell's system sustains, on
the card, by a sweep of offered rates in one process:

    python3 portbench/sweep.py --workload bert_large.squad_s384_server \
        --seed 7 --seconds 8 --rates 300,400,500,550,600,650

One JSON line a rate: requests due, replies a second, the median, 95th and
99th percentile from due to reply, how late the submitting thread ran,
and the replies still owed when the rate's window closed (a backlog that
grows with the window means the rate is not sustained). The benchmark's
runs never run this; the cell's fixed rate is set from it (PERF.md).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    from portbench import run
    run.cache_env(ROOT, 0)
    from portbench.core import device, serve, spec
    cell = spec.Cell(args.workload)
    dev = device.Device(args.device)
    reg, name, ids, types = serve.serve_setup(cell, args.seed, dev)
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            traffic = dict(cell.traffic, rate_per_s=rate)
            loop = serve.OpenLoop(reg, name, ids, types,
                                   serve.arrival_gaps(traffic, args.seed),
                                   keep=False)
            t = time.perf_counter()
            loop.run(t, t + 1.0)
            t0 = time.perf_counter()
            end = t0 + args.seconds
            recs = loop.run(t0, end)
            ok = [r for r in recs if r[4] is not None]
            times = sorted(r[3] - r[1] for r in ok)
            q = statistics.quantiles(times, n=100)
            print(json.dumps({
                "rate_per_s": rate, "due": len(recs),
                "failed": len(recs) - len(ok),
                "replies_per_s": sum(1 for r in ok if r[3] <= end)
                / args.seconds,
                "p50_ms": 1e3 * q[49], "p95_ms": 1e3 * q[94],
                "p99_ms": 1e3 * q[98],
                "late_p99_ms": 1e3 * statistics.quantiles(
                    [r[2] - r[1] for r in recs], n=100)[98],
                "owed_at_close": sum(1 for r in recs if r[3] > end)}),
                flush=True)
    finally:
        reg.close()
    return 0


if __name__ == "__main__":
    sys.path[:] = [ROOT] + [q for q in sys.path
                            if os.path.abspath(q or ".") not in (HERE, ROOT)]
    sys.exit(main())
