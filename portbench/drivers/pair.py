"""Closed loop of sphere -> cube -> sphere pairs on one band set.

Each pair runs ``unpack_transform`` then ``transform_pack`` of the port's
plane-wave pair on every band, ``band_batch`` bands a call, back to back;
the host only keeps one pair in flight ahead of the device (it waits for
pair i - 1 before it queues pair i + 1), so the device never waits for it.
The window ends at the first pair end after ``--seconds``.

Judged once the window has closed: the last call's real-space cube against
the reference's ``ifftn`` in float64, every band, and the last pair's
packed output against the coefficients themselves (the reference round
trip is the identity on the sphere's lanes).
"""
from __future__ import annotations

import time

import torch

from ..reference import GapMeter, Sphere, Transforms
from ..roofline import pair_calls, pair_work


def inputs(ctx):
    """The band coefficients, made on the device from the seed."""
    from repro_torch.core.planewave import kpoint_sphere
    cfg = ctx.config
    npk = kpoint_sphere(int(cfg["diameter"])).npacked
    return torch.randn((int(cfg["nb"]), npk), dtype=torch.complex64,
                       device=ctx.device, generator=ctx.generator())


def judge(ctx, coeffs, batch: int, cube_of, out_of) -> None:
    """The last call's cube (``cube_of(b0, b1)``: its bands b0..b1) against
    the reference's ``ifftn`` in float64, and each call's packed output
    (``out_of(h)``) against the coefficients."""
    cfg, mix = ctx.config, ctx.traffic
    n, d = int(cfg["n"]), int(cfg["diameter"])
    calls = int(cfg["nb"]) // batch
    ref = Transforms(n, d, ctx.device, "float64")
    lanes = Sphere(d)
    block = int(mix.get("check_block", 4))
    cube_gap = GapMeter()
    last = (calls - 1) * batch
    for b0 in range(0, batch, block):
        b1 = min(b0 + block, batch)
        want = ref.inverse(coeffs[last + b0:last + b1], lanes)
        cube_gap.add(cube_of(b0, b1), want)
        del want
    rt_gap = GapMeter()
    for h in range(calls):
        rt_gap.add(out_of(h), coeffs[h * batch:(h + 1) * batch])
    limits = mix["limits"]
    ctx.check("cube_gap", cube_gap.value, limits["cube_gap"])
    ctx.check("round_trip_gap", rt_gap.value, limits["round_trip_gap"])


def control(ctx) -> None:
    """The judge's numbers with the reference in TF32 in the program's
    place."""
    cfg = ctx.config
    n, d = int(cfg["n"]), int(cfg["diameter"])
    batch = int(cfg["band_batch"])
    calls = int(cfg["nb"]) // batch
    coeffs = inputs(ctx)
    low = Transforms(n, d, ctx.device, "tf32")
    lanes = Sphere(d)
    last = (calls - 1) * batch
    block = int(ctx.traffic.get("check_block", 4))

    def out_of(h):
        rows = coeffs[h * batch:(h + 1) * batch]
        return torch.cat([low.round_trip(rows[b0:b0 + block], lanes)
                          for b0 in range(0, batch, block)])
    judge(ctx, coeffs, batch,
          lambda b0, b1: low.inverse(coeffs[last + b0:last + b1], lanes),
          out_of)


def run(ctx) -> dict:
    from repro_torch.core import ProcGrid, make_planewave_pair
    from repro_torch.core.planewave import kpoint_sphere

    cfg = ctx.config
    n, d, nb = int(cfg["n"]), int(cfg["diameter"]), int(cfg["nb"])
    batch = int(cfg["band_batch"])
    if nb % batch:
        raise ValueError(f"{nb} bands do not split into calls of {batch}")
    calls = nb // batch
    dev = ctx.device
    grid = ProcGrid.create(list(cfg["grid"]), device=dev)
    sphere = kpoint_sphere(d)
    inv, fwd = make_planewave_pair(grid, n, sphere, batch,
                                   backend=cfg["backend"])
    ctx.mark("plans")
    coeffs = inputs(ctx)
    ctx.mark("inputs")

    def one_pair():
        outs, cube = [], None
        for h in range(calls):
            cube = None
            cube = inv.unpack_transform(coeffs[h * batch:(h + 1) * batch])
            outs.append(fwd.transform_pack(cube))
        return outs, cube

    outs, cube = one_pair()                 # builds and warms every shape
    outs = cube = None
    cuda = dev.type == "cuda"
    ctx.tracer.start()
    t0 = ctx.start_window()
    pairs = 0
    try:
        prev = None
        while True:
            outs = cube = None
            outs, cube = one_pair()
            pairs += 1
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                if prev is not None:
                    prev.synchronize()
                prev = ev
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        ctx.sync()
        window = time.perf_counter() - t0
    finally:
        ctx.tracer.stop()
    ctx.read_memory_peak()
    del inv, fwd
    ctx.release()

    t_check = time.perf_counter()
    judge(ctx, coeffs, batch, lambda b0, b1: cube[b0:b1],
          lambda h: outs[h])
    ctx.notes["check_s"] = time.perf_counter() - t_check
    lanes = Sphere(d)
    work = pair_work(n, lanes.npacked, nb)
    per_call = pair_calls(n, d, lanes.npacked, lanes.ncols, batch)
    return {"attempted": pairs, "failed": 0,
            "pair_ms": 1e3 * window / pairs,
            "pairs": pairs, "window_s": window, "calls_per_pair": calls,
            "pair_work": work,
            "kernel_calls": {k: v * calls for k, v in per_call.items()}}
