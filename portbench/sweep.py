"""The service's knee: the highest offered rate it sustains without a
growing backlog, by one sweep of open-loop windows in one process.

    python3 portbench/sweep.py --rates 0.6,0.9,1.2,1.5,1.8 --seconds 30 \
        [--config fftb-paper-256] [--traffic service-overload] [--seed N]

One service, warmed once; at each rate a window of ``--seconds`` of the
mix (its schedule at that rate), every request waited for.  For
each rate it prints the rate completed, p50 and p95 latency from due, and
the median latency of the window's last third against its first third: a
ratio well above 1 means the queue grew all through the window.  A cell
below the knee offers about 4/5 of the highest rate that keeps up.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def sweep(ctx, rates, seconds: float, drain: float = 60.0) -> list[dict]:
    from portbench.drivers.service import inputs, open_loop, start_service
    from portbench.inputs import percentile, schedule
    inp = inputs(ctx)
    svc, submit = start_service(ctx, inp)
    rows = []
    try:
        for k, rate in enumerate(rates):
            reqs = schedule(rate, seconds, ctx.traffic, ctx.rng(10 + k))
            svc.metrics.reset()
            t0 = time.perf_counter()
            lat, _, late, _, errors = open_loop(submit, reqs, t0,
                                             t0 + seconds + drain)
            done_at = time.perf_counter() - t0
            summ = svc.metrics.summary()
            ok = [x for x in lat if x is not None]
            third = max(len(reqs) // 3, 1)
            head = [x for x in lat[:third] if x is not None]
            tail = [x for x in lat[-third:] if x is not None]
            row = {"rate": rate, "requests": len(reqs), "done": len(ok),
                   "completed_per_s": len(ok) / max(done_at, seconds),
                   "p50_ms": 1e3 * percentile(ok, 50),
                   "p95_ms": 1e3 * percentile(ok, 95),
                   "growth": (percentile(tail, 50)
                              / max(percentile(head, 50), 1e-9)),
                   "late_p95_ms": 1e3 * percentile(late, 95),
                   "rows_per_dispatch": (summ["rows"]
                                         / max(summ["dispatches"], 1)),
                   "hit_rate": summ.get("plan_cache", {}).get("hit_rate"),
                   "errors": errors}
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
    finally:
        svc.stop(drain=False)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="fftb-paper-256")
    ap.add_argument("--traffic", default="service-overload")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=2_147_480_000)
    args = ap.parse_args(argv)
    import torch
    from portbench import registry
    from portbench.run import Context
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = registry.load_benchmark()
    cell = {"name": "sweep", "config": args.config,
            "traffic": args.traffic, "chips": 1}
    ctx = Context(cell, registry.load_config(bench, args.config),
                  registry.load_traffic(args.traffic), args.seed,
                  args.seconds, torch.device("cuda", 0), False)
    rates = [float(r) for r in args.rates.split(",")]
    print(json.dumps(sweep(ctx, rates, args.seconds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
