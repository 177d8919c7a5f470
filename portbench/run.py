"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell, its configuration, its traffic mix
and its per-layer metrics are found by name (:mod:`portbench.registry`).
Set-up (imports, CUDA context, kernel build or load, inputs made on the
card from the seed, plans, warm-up) is timed from process start to the
window's start; the window measures for ``--seconds``; then the window's
outputs are judged against the plain reference (:mod:`portbench.reference`)
and one JSON line is printed last on standard output.  Without a CUDA
device the run fails and prints no result.
"""
from __future__ import annotations

import time

_T_FIRST_LINE = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: top-level module names the run may never hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _process_age() -> float:
    """Seconds since this process started (the kernel's start time), or
    since the first line of this file where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_FIRST_LINE


#: perf_counter() reading of the process's start
PROCESS_START = time.perf_counter() - _process_age()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


class Context:
    """What a driver gets: the cell, its configuration and traffic, the
    seed, the window's length, the device and the tracer; and where it
    records set-up, the memory peak and each number it compares."""

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 seconds: float, device, trace: bool,
                 process_start: float = None):
        import torch
        from portbench.tracing import Tracer
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed = int(seed) & (2 ** 63 - 1)
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.tracer = Tracer(trace, self.device)
        self.process_start = (PROCESS_START if process_start is None
                              else process_start)
        self.setup_s = None
        self.memory_peak = 0
        self.checks: list[tuple[str, float, float]] = []
        self.notes: dict = {"setup": {}}
        self._mark = self.process_start
        self.mark("start, imports, CUDA context")

    # -- inputs from the seed
    def generator(self, stream: int = 0):
        """A torch generator on the device, from (seed, stream)."""
        import torch
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1_000_003 + stream) & (2 ** 63 - 1))
        return g

    def rng(self, stream: int = 0):
        """A numpy generator from (seed, stream)."""
        import numpy as np
        return np.random.default_rng([self.seed, stream])

    # -- timing and memory
    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, piece: str) -> None:
        """Time the set-up piece that ends now (into the notes)."""
        self.sync()
        now = time.perf_counter()
        self.notes["setup"][piece] = now - self._mark
        self._mark = now

    def start_window(self) -> float:
        """Ends set-up; returns the window's start (perf_counter)."""
        self.mark("warm-up")
        now = self._mark
        self.setup_s = now - self.process_start
        return now

    def read_memory_peak(self) -> None:
        import torch
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(
                self.device))

    def release(self) -> None:
        """Free what the program left cached, before the reference runs."""
        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    # -- correctness
    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.checks)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False).stdout.strip()
        return out.splitlines()[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device, *, config: dict | None = None,
             traffic: dict | None = None,
             profile_out: str | None = None) -> tuple[dict, dict]:
    """Run cell ``name`` once on ``device``; the result line as a dict
    (its ``checks`` last) and the driver's notes (printed apart).

    ``config``/``traffic`` replace the files the cell names (the CPU
    tests run the same path at toy sizes)."""
    from portbench import registry
    cell = registry.cell(bench, name)
    config = config or registry.load_config(bench, cell["config"])
    traffic = traffic or registry.load_traffic(cell["traffic"])
    ctx = Context(cell, config, traffic, seed, seconds, device, trace)
    facts = registry.driver(traffic).run(ctx)
    if profile_out:
        Path(profile_out).parent.mkdir(parents=True, exist_ok=True)
        ctx.tracer.export(profile_out)
    facts["setup_s"] = ctx.setup_s
    facts["trace"] = ctx.tracer.result
    if trace:
        wanted = registry.per_layer(bench, name)
        metrics = {}
        for m in wanted:
            v = registry.reader(m["name"])(facts)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        wanted = registry.end_to_end(bench, name)
        metrics = {m["name"]: {"value": float(facts[m["name"]]),
                               "unit": m["unit"]}
                   for m in wanted if facts.get(m["name"]) is not None}
    line = {"correct": ctx.correct, "attempted": int(facts["attempted"]),
            "failed": int(facts["failed"]), "metrics": metrics,
            "device": {"platform": "gpu" if ctx.device.type == "cuda"
                       else ctx.device.type,
                       "kind": _device_name(ctx.device),
                       "count": 1, "memory_peak_bytes": ctx.memory_peak}}
    tr = ctx.tracer.result
    if tr is not None:
        line["device"]["busy_s"] = tr.busy_s
        line["device"]["window_s"] = tr.window_s
        line["breakdown"] = tr.breakdown()
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in ctx.checks}
    return line, ctx.notes


def _device_name(dev) -> str:
    import torch
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--profile-out", default=None,
                    help="with --trace 1, write the window's chrome trace "
                         "to this file")
    args = ap.parse_args(argv)

    from portbench import registry
    bench = registry.load_benchmark()
    cell = registry.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card and does "
              "not fall back to the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    line, notes = run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0),
                           profile_out=args.profile_out)
    notes["card"] = power_limit()
    bad = forbidden_modules()
    if bad:
        print("JAX or the JAX package was loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    print("notes " + json.dumps(notes), file=sys.stderr)
    for n, c in line["checks"].items():
        print(f"check {n} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
