"""The highest rate a serving cell sustains, found once by a sweep:

    python3 bench/sweep_rate.py --workload <cell> --rates 20,40,60 \\
        [--seconds 10] [--seeds 1,2,3]

One process builds the cell and serves ``--seconds`` of its traffic at
each rate in turn, once a seed.  A rate is sustained when, for every
seed, the queue does not grow:
the last third of the requests waits no longer at the median than the
first third by more than half, and every request is served within
``drain_s`` of the close.  It prints each rate's line and the highest
sustained rate with four fifths of it, the rate a cell below the knee
takes.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import harness as H  # noqa: E402
from bench.drivers import serve as D  # noqa: E402
from bench.yardstick import tails  # noqa: E402
from bench.yardstick import traffic as TR  # noqa: E402


def one_rate(engine, cell, seed: int, rate: float, seconds: float,
             device: str) -> dict:
    reqs = TR.serve_requests(cell.model["vocab_size"], cell.traffic, seed,
                             rate, seconds)
    t0, due, done, _, steps, end = D.serve_window(
        engine, reqs, seconds, cell.workload["drain_s"], None, device)
    lat = tails.latencies([d - t0 for d in due],
                          {i: v - t0 for i, v in done.items()}, end - t0)
    close = t0 + seconds
    waiting = sum(1 for i, d in enumerate(due)
                  if d < close and done.get(i, end) > close)
    third = max(1, len(lat) // 3)
    first, last = np.median(lat[:third]), np.median(lat[-third:])
    ok = len(done) == len(reqs) and last <= 1.5 * first
    return {"rate": rate, "requests": len(reqs), "served": len(done),
            "steps": len(steps), "waiting_at_close": waiting,
            "ttft_p50_ms": tails.percentile(lat, 50) * 1e3,
            "ttft_p95_ms": tails.percentile(lat, 95) * 1e3,
            "first_third_p50_ms": float(first) * 1e3,
            "last_third_p50_ms": float(last) * 1e3,
            "tokens_per_s": sum(len(reqs[i][0]) for i in done) /
            max(end - t0, 1e-9), "sustained": bool(ok)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = H.cell(args.workload)
    print(f"sweep: {args.workload} on {H.smi()}", flush=True)
    seeds = [int(x) for x in args.seeds.split(",")]
    engine, _ = D.build(cell, seeds[0], args.device, False)
    D.warm_up(engine, cell, seeds[0])
    best = None
    for rate in (float(r) for r in args.rates.split(",")):
        ok = True
        for seed in seeds:
            t = time.perf_counter()
            row = one_rate(engine, cell, seed, rate, args.seconds,
                           args.device)
            row.update(seed=seed, seconds=time.perf_counter() - t)
            print(json.dumps(row), flush=True)
            ok = ok and row["sustained"]
        if ok and (best is None or rate > best):
            best = rate
    print(json.dumps({"highest_sustained": best,
                      "four_fifths": None if best is None else 0.8 * best}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
