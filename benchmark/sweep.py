"""Find a serving cell's knee: offer its traffic at several fixed rates, one
after another in one process, and print one JSON line a rate.

    python3 -m benchmark.sweep --workload xfmr-serve-poisson \
        --rates 4,6,8,10 --seconds 20 --seed 1

Each line gives the offered and achieved rate, p50 / p95 latency from due
time, and the backlog (requests due and not yet answered) at the middle
and at the end of the arrivals. The knee is the highest rate whose backlog
does not grow over the window. Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def backlog(window, t0: float, at: float) -> int:
    return sum(1 for due, done in zip(window.due, window.done)
               if due <= at and done > t0 + at)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    from benchmark import run
    from benchmark.jobs.serve import Server
    from benchmark.yardstick import load

    if not torch.cuda.is_available():
        print("the sweep runs on the card only", file=sys.stderr)
        return 2
    cell = run.Cell(args.workload)
    srv = Server(run.Context(cell, args.seed, args.seconds, False),
                 torch.device("cuda"))
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            srv.traffic = dict(cell.traffic, rate=rate)
            window = srv.requests(args.seconds, args.seed)
            t0, groups, requests = srv.offer(window)
            lat = window.latencies(t0)
            done = np.asarray(window.done) - t0
            print(json.dumps({
                "rate": rate, "requests": len(lat),
                "answered_in_window": int(np.sum(done <= args.seconds)),
                "achieved_per_s": float(np.sum(done <= args.seconds))
                / args.seconds,
                "p50_ms": 1e3 * float(np.median(lat)),
                "p95_ms": 1e3 * load.p95(lat),
                "backlog_mid": backlog(window, t0, args.seconds / 2),
                "backlog_end": backlog(window, t0, args.seconds),
                "mean_group": requests / max(groups, 1)}), flush=True)
    finally:
        srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
