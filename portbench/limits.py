"""Readings that set a cell's correctness limits: the program's numbers
over many seeds and the control's over a few, in one process.

    python3 portbench/limits.py --workload paper-pair --seeds 12 \
        --control-seeds 3 --seconds 3 [--first-seed N] [--out FILE]

Each program reading is a whole run of the cell (:func:`run_cell`, a short
window at the cell's own size and load); each control reading puts the
reference, computed one precision lower (TF32 transforms), in the
program's place and judges it the same way (the driver's ``control``).
The lower reading of a number is the program's largest, the upper the
control's smallest; the limit lies between them.  Needs the card unless
``--device cpu`` (the tests run this at toy sizes).
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


def readings(bench: dict, workload: str, seeds, control_seeds,
             seconds: float, device, config=None, traffic=None) -> dict:
    """{"program": {seed: {number: value}}, "control": {...},
    "lower": {number: max}, "upper": {number: min}}."""
    from portbench import registry
    from portbench.run import Context, run_cell
    cell = registry.cell(bench, workload)
    config = config or registry.load_config(bench, cell["config"])
    traffic = traffic or registry.load_traffic(cell["traffic"])
    out = {"program": {}, "control": {}}
    for seed in seeds:
        line, _ = run_cell(bench, workload, seed, seconds, False, device,
                           config=config, traffic=traffic)
        out["program"][seed] = {k: v["value"]
                                for k, v in line["checks"].items()}
        print(f"program seed {seed}: {out['program'][seed]}",
              file=sys.stderr, flush=True)
    for seed in control_seeds:
        ctx = Context(cell, config, traffic, seed, seconds, device, False)
        registry.driver(traffic).control(ctx)
        out["control"][seed] = {n: v for n, v, _ in ctx.checks}
        print(f"control seed {seed}: {out['control'][seed]}",
              file=sys.stderr, flush=True)
        del ctx
    names = sorted({k for r in out["program"].values() for k in r}
                   | {k for r in out["control"].values() for k in r})
    out["lower"] = {k: max(r[k] for r in out["program"].values())
                    for k in names if out["program"]}
    out["upper"] = {k: min(r[k] for r in out["control"].values())
                    for k in names if out["control"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_147_483_000)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from portbench import registry
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    s0 = args.first_seed
    t = time.time()
    out = readings(registry.load_benchmark(), args.workload,
                   range(s0, s0 + args.seeds),
                   range(s0 + 100, s0 + 100 + args.control_seeds),
                   args.seconds, torch.device(args.device))
    out["seconds"] = time.time() - t
    text = json.dumps(out, indent=1, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(json.dumps({"lower": out["lower"], "upper": out["upper"],
                      "seconds": out["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
