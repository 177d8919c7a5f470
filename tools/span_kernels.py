"""Device time of the kernels launched inside named host ranges of a
``torch.profiler`` chrome trace.

    python3 tools/span_kernels.py TRACE.json [--name relayout] [--per N]

A launch belongs to a range when its runtime call (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ...) starts inside the range on the same host thread;
its device work is found by the profiler's ``correlation`` id.  Prints one
JSON object: the ranges found, the launches in them, the device
milliseconds of their kernels, copies and fills (divided by ``--per``, a
pair count, when given), and the kernels by name.  The port's spans enter
the profile as such ranges while a profiler records, so this checks the
device time the port's tracer reports for a span name against the device
trace itself.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys

#: chrome-trace categories of device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def ranges_by_thread(events, name: str) -> dict:
    """(starts, ends) of the host ranges named ``name``, per thread,
    sorted by start (the ranges of one name do not overlap)."""
    out: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name") == name \
                and e.get("cat") not in DEVICE_CATS:
            out.setdefault((e["pid"], e["tid"]), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return {k: ([a for a, _ in sorted(v)], [b for _, b in sorted(v)])
            for k, v in out.items()}


def kernels_in(events, name: str) -> dict:
    """The device work launched inside the ranges named ``name``."""
    ranges = ranges_by_thread(events, name)
    inside = set()
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if (e.get("ph") != "X" or corr is None
                or e.get("cat") not in ("cuda_runtime", "cuda_driver")):
            continue
        starts, ends = ranges.get((e["pid"], e["tid"]), ((), ()))
        i = bisect.bisect_right(starts, float(e["ts"])) - 1
        if i >= 0 and float(e["ts"]) < ends[i]:
            inside.add(corr)
    by_name: dict[str, float] = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                and e.get("args", {}).get("correlation") in inside):
            by_name[e["name"]] = by_name.get(e["name"], 0.0) \
                + float(e["dur"]) / 1e3
    return {"ranges": sum(len(s) for s, _ in ranges.values()),
            "launches": len(inside),
            "device_ms": sum(by_name.values()), "by_kernel": by_name}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--name", default="relayout")
    ap.add_argument("--per", type=int, default=None,
                    help="divide the device milliseconds by this count")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        events = json.load(f)["traceEvents"]
    out = kernels_in(events, args.name)
    if args.per:
        out["device_ms_per"] = out["device_ms"] / args.per
    json.dump(out, sys.stdout)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
