"""Open loop of tenants' requests through the port's transform service.

Not a cell of ``BENCHMARK.json`` yet: with ~2 s of host work a dispatch,
a 51 s window holds too few dispatches for a rate or a tail to stay
within a bound (``PERF.md``, Open questions); the driver stays for the
cell's return, and the CPU tests run it at toy size.

The end-to-end metric is the bands whose requests completed inside the
window, over the window: offered above the service's capacity, the queue
stays full and the rate is the service's capacity (the tail latency, which
then grows through the run, is a per-layer reading).

Requests arrive on a fixed schedule (:func:`portbench.inputs.schedule`):
Poisson gaps at the mix's rate, tenants, band counts and k-shifts in the
mix's shares.  Each asks for the round trip ``pack(F(v * F^-1(unpack(c))))``
of its bands with its tenant's potential.  The generator submits each
request when it is due, whatever the service is doing; a collector waits
for the handles in order.  A request's latency runs from when it was due
to when its handle resolved on the host, so a stall also delays the
requests behind it.

Judged once every request has resolved (or ``drain_s`` past the window):
a seeded sample of the requests, the largest among them, each against the
reference's round trip in float64.
"""
from __future__ import annotations

import math
import queue
import threading
import time

import numpy as np
import torch

from ..inputs import monkhorst_pack, percentile, schedule, seeded_wells
from ..reference import GapMeter, Sphere, Transforms


def inputs(ctx) -> dict:
    """The coefficient pool of each k-shifted sphere (host arrays: tenants
    send their bands from the host), each tenant's potential (resident on
    the card, as a tenant's SCF state is), both made on the device from
    the seed, and the window's requests."""
    cfg, mix = ctx.config, ctx.traffic
    n, d = int(cfg["n"]), int(cfg["diameter"])
    kpts = monkhorst_pack(mix["kpoint_mesh"])
    gen = ctx.generator()
    pool = [torch.randn((int(mix["pool_rows"]), Sphere(d, k).npacked),
                        dtype=torch.complex64, device=ctx.device,
                        generator=gen).cpu().numpy() for k in kpts]
    w = mix["wells"]
    rng = ctx.rng(1)
    pots = [seeded_wells(n, w["centers"], float(w["depth"]),
                         float(w["width_over_n"]) * n, rng, ctx.device)
            for _ in mix["tenants"]]
    reqs = schedule(float(mix["rate_per_s"]), ctx.seconds, mix, ctx.rng(2))
    nreq = len(reqs)
    sample = set(ctx.rng(3).choice(
        nreq, size=min(nreq, int(mix["check_requests"])),
        replace=False).tolist())
    sample.add(max(range(nreq), key=lambda i: (reqs[i]["bands"], -i)))
    return {"kpts": kpts, "pool": pool, "pots": pots, "reqs": reqs,
            "sample": sample}


def judge(ctx, inp: dict, sample, out_of) -> None:
    """Each sampled request's output (``out_of(i)``, None when it failed)
    against the reference's round trip in float64: the widest gap of any
    request, against that request's largest value."""
    cfg, mix = ctx.config, ctx.traffic
    n, d = int(cfg["n"]), int(cfg["diameter"])
    dev = ctx.device
    ref = Transforms(n, d, dev, "float64")
    lanes = [Sphere(d, k) for k in inp["kpts"]]
    block = int(mix.get("check_block", 4))
    worst, seen = 0.0, 0
    for i in sample:
        r = inp["reqs"][i]
        out = out_of(i)
        if out is None:
            continue                    # failed: counted in ``failed``
        seen += 1
        c = torch.as_tensor(inp["pool"][r["sphere"]][r["row"]:r["row"]
                                                    + r["bands"]],
                            device=dev)
        v = inp["pots"][r["tenant"]]
        meter = GapMeter()
        for b0 in range(0, r["bands"], block):
            want = ref.round_trip(c[b0:b0 + block], lanes[r["sphere"]], v)
            meter.add(torch.as_tensor(out[b0:b0 + block], device=dev), want)
        worst = max(worst, meter.value)
    if not seen:
        worst = math.inf                # nothing came back to judge
    ctx.check("round_trip_gap", worst, mix["limits"]["round_trip_gap"])


def control(ctx) -> None:
    """The judge's numbers with the reference's round trip in TF32 in the
    service's place, on the same sampled requests."""
    cfg = ctx.config
    n, d = int(cfg["n"]), int(cfg["diameter"])
    inp = inputs(ctx)
    low = Transforms(n, d, ctx.device, "tf32")
    lanes = [Sphere(d, k) for k in inp["kpts"]]
    block = int(ctx.traffic.get("check_block", 4))

    def out_of(i):
        r = inp["reqs"][i]
        c = torch.as_tensor(inp["pool"][r["sphere"]][r["row"]:r["row"]
                                                    + r["bands"]],
                            device=ctx.device)
        v = inp["pots"][r["tenant"]]
        return torch.cat([low.round_trip(c[b0:b0 + block],
                                         lanes[r["sphere"]], v)
                          for b0 in range(0, r["bands"], block)])
    judge(ctx, inp, sorted(inp["sample"]), out_of)


def start_service(ctx, inp: dict):
    """The service on the cell's grid, every bucket warmed, one request
    of each size run through the whole path, its loop started; and the
    function that submits one scheduled request."""
    from repro_torch.core import ProcGrid
    from repro_torch.core.planewave import kpoint_sphere
    from repro_torch.serve import TransformService

    cfg, mix = ctx.config, ctx.traffic
    n, d = int(cfg["n"]), int(cfg["diameter"])
    pool, pots = inp["pool"], inp["pots"]
    spheres = [kpoint_sphere(d, k) for k in inp["kpts"]]
    grid = ProcGrid.create(list(cfg["grid"]), device=ctx.device)
    svc = TransformService(grid, n, max_rows=int(mix["max_rows"]),
                           backend=cfg["backend"],
                           warm_async=bool(mix["warm_async"]))

    def submit(r):
        c = pool[r["sphere"]][r["row"]:r["row"] + r["bands"]]
        return svc.submit(f"tenant{r['tenant']}", c, spheres[r["sphere"]],
                          v_eff=pots[r["tenant"]])

    b = 1
    while b <= svc.max_rows:
        svc.warm(spheres[0], nbands=b)
        b *= 2
    for size in sorted({int(k) for k in mix["bands"]}):
        submit({"sphere": 0, "row": 0, "bands": size, "tenant": 0})
    svc.run_until_idle(timeout=600.0)
    svc.start()
    return svc, submit


def open_loop(submit, reqs, t0: float, close_at: float, keep=()):
    """Submit each request when it is due (``t0 + due``) and wait for
    every handle, until ``close_at`` at the latest.  Returns (latency from
    due or None, completion time or None, generator lateness, kept
    outputs of ``keep``, errors by kind)."""
    nreq = len(reqs)
    lat = [None] * nreq
    done_at = [None] * nreq
    late = [0.0] * nreq
    kept: dict[int, np.ndarray] = {}
    errors: dict[str, int] = {}
    handed: queue.Queue = queue.Queue()

    def collect():
        while True:
            item = handed.get()
            if item is None:
                return
            i, due, h = item
            if h is None:
                errors["refused"] = errors.get("refused", 0) + 1
                continue
            try:
                out = h.result(timeout=max(close_at - time.perf_counter(),
                                           0.001))
            except Exception as err:       # a failed or lost request
                name = type(err).__name__
                errors[name] = errors.get(name, 0) + 1
                continue
            lat[i] = h.completed_at - due
            done_at[i] = h.completed_at
            if i in keep:
                kept[i] = out

    collector = threading.Thread(target=collect, daemon=True)
    collector.start()
    for i, r in enumerate(reqs):
        due = t0 + r["due"]
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        try:
            h = submit(r)
        except Exception:                  # refused at the door
            h = None
        late[i] = time.perf_counter() - due
        handed.put((i, due, h))
    handed.put(None)
    collector.join(timeout=max(close_at - time.perf_counter(), 0.0) + 30.0)
    if collector.is_alive():
        raise RuntimeError("the collector did not finish")
    return lat, done_at, late, kept, errors


def run(ctx) -> dict:
    mix = ctx.traffic
    inp = inputs(ctx)
    ctx.mark("inputs")
    reqs, sample = inp["reqs"], inp["sample"]
    svc, submit = start_service(ctx, inp)
    try:
        svc.metrics.reset()
        ctx.tracer.start()
        t0 = ctx.start_window()
        lat, done_at, late, kept, errors = open_loop(
            submit, reqs, t0, t0 + ctx.seconds + float(mix["drain_s"]),
            keep=sample)
        ctx.sync()
        window = time.perf_counter() - t0
        summary = svc.metrics.summary()
        ctx.tracer.stop()
    finally:
        svc.stop(drain=False)
    ctx.read_memory_peak()
    del svc, submit
    ctx.release()

    t_check = time.perf_counter()
    judge(ctx, inp, sorted(sample), kept.get)
    ctx.notes["check_s"] = time.perf_counter() - t_check
    nreq = len(reqs)
    done = [x for x in lat if x is not None]
    if not done:
        raise RuntimeError(f"none of {nreq} requests completed: {errors}")
    ctx.notes["generator_late_ms"] = {
        "p50": 1e3 * percentile(late, 50), "p95": 1e3 * percentile(late, 95),
        "max": 1e3 * max(late)}
    ctx.notes["errors"] = errors
    ctx.notes["checked_requests"] = len(kept)
    close = t0 + ctx.seconds
    bands = sum(r["bands"] for r, at in zip(reqs, done_at)
                if at is not None and at <= close)
    return {"attempted": nreq, "failed": nreq - len(done),
            "service_bands_per_s": bands / ctx.seconds,
            "service_p95_ms": 1e3 * percentile(done, 95),
            "service_p50_ms": 1e3 * percentile(done, 50),
            "window_s": window, "requests": nreq,
            "service": summary}
