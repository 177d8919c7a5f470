"""Closed loop of Γ-point pairs: real bands on half the G-sphere, two a
complex transform.

Each pair runs the port's Γ-point pair (``repro_torch.core.gamma_plans``)
on every real band, ``band_batch`` real bands a call (``band_batch / 2``
complex rows): ``unpack_transform`` (the fold, then the Γ sphere's
plane-wave inverse) and ``transform_pack`` (the forward, then the unfold),
back to back.  The host keeps one pair in flight ahead of the device (it
waits for pair i - 1 before it queues pair i + 1).  The window ends at the
first pair end after ``--seconds``.

Judged once the window has closed, against the plain reference in float64
(:mod:`portbench.reference_gamma`): every complex row of the last call's
cube times e^{−2πi s·r/n} (``(−i)^{x+y+z}`` at n = 2d), its real part
against ψ_{2k} and its imaginary part against ψ_{2k+1}, max |Δ| / max |ref|
(``cube_gap``); and every real band's half-sphere output against its
coefficients (``round_trip_gap``).
"""
from __future__ import annotations

import time

import torch

from ..reference import GapMeter
from ..reference_gamma import GammaSphere, GammaTransforms, unphase
from ..roofline import COMPLEX64, fft_flops, pair_calls

#: bytes of a real float32 value
FLOAT32 = 4


def gamma_work(n: int, nhalf: int, bands: int) -> tuple[float, float]:
    """(bytes, operations) of one pair of ``bands`` real bands: per
    direction each band's half sphere (complex64) and its real cube
    (float32), once each; one real 3D FFT of n³ a band and a direction,
    half a complex one's operations (2.5 N log2 N, benchFFT)."""
    per_dir = bands * (nhalf * COMPLEX64 + n ** 3 * FLOAT32)
    return 2.0 * per_dir, 2.0 * bands * fft_flops(n ** 3) / 2.0


def fold_work(nhalf: int, npacked: int, bands: int) -> float:
    """Bytes of the fold and the unfold of one pair: the bands' half
    spheres and the ⌈bands/2⌉ complex rows of the full sphere, each read
    once and written once (complex64)."""
    rows = -(-bands // 2)
    return 2.0 * (bands * nhalf + rows * npacked) * COMPLEX64


def _sizes(cfg):
    n, d = int(cfg["n"]), int(cfg["diameter"])
    nb, batch = int(cfg["nb"]), int(cfg["band_batch"])
    if nb % batch or (batch % 2 and batch != nb):
        raise ValueError(f"{nb} real bands do not split into calls of "
                         f"{batch} (whole pairs a call)")
    return n, d, nb, batch


def _counters() -> dict:
    """The program's ``gamma`` probe: its numeric counters now."""
    from repro_torch.obs.metrics import global_metrics
    snap = global_metrics().snapshot().get("gamma", {})
    return {k: x for k, x in snap.items() if isinstance(x, (int, float))}


def inputs(ctx):
    """The real bands' half-sphere coefficients, made on the device from
    the seed; the G = 0 lane (the half's first) real."""
    _, d, nb, _ = _sizes(ctx.config)
    sphere = GammaSphere(d)
    c = torch.randn((nb, sphere.nhalf), dtype=torch.complex64,
                    device=ctx.device, generator=ctx.generator())
    g0 = int((sphere.g_half() == 0).all(1).nonzero()[0][0])
    c[:, g0] = c[:, g0].real.to(c.dtype)
    return c


def judge(ctx, coeffs, cube_of, out_of) -> None:
    """The last call's cube (``cube_of(r0, r1)``: its complex rows r0..r1)
    against real ψ from the reference in float64, and each call's output
    (``out_of(h)``) against the coefficients."""
    n, d, nb, batch = _sizes(ctx.config)
    calls = nb // batch
    ref = GammaTransforms(n, d, ctx.device, "float64")
    s = ref.sphere.s
    block = int(ctx.traffic.get("check_block", 4))
    last = (calls - 1) * batch
    rows = -(-batch // 2)
    cube_gap = GapMeter()
    for r0 in range(0, rows, block):
        r1 = min(r0 + block, rows)
        b0, b1 = last + 2 * r0, min(last + 2 * r1, last + batch)
        psi = ref.inverse(coeffs[b0:b1])
        got = unphase(cube_of(r0, r1), s)
        want_b = torch.zeros_like(got.real)      # an odd band's partner
        want_b[:psi[1::2].shape[0]] = psi[1::2]
        cube_gap.add(got.real, psi[0::2])
        cube_gap.add(got.imag, want_b)
        del psi, got, want_b
    rt_gap = GapMeter()
    for h in range(calls):
        rt_gap.add(out_of(h), coeffs[h * batch:(h + 1) * batch])
    limits = ctx.traffic["limits"]
    ctx.check("cube_gap", cube_gap.value, limits["cube_gap"])
    ctx.check("round_trip_gap", rt_gap.value, limits["round_trip_gap"])


def control(ctx) -> None:
    """The judge's numbers with the reference in TF32 in the program's
    place."""
    n, d, nb, batch = _sizes(ctx.config)
    calls = nb // batch
    coeffs = inputs(ctx)
    low = GammaTransforms(n, d, ctx.device, "tf32")
    last = (calls - 1) * batch
    block = int(ctx.traffic.get("check_block", 4))

    def cube_of(r0, r1):
        return low.cube(coeffs[last + 2 * r0:min(last + 2 * r1,
                                                 last + batch)])

    def out_of(h):
        rows = coeffs[h * batch:(h + 1) * batch]
        return torch.cat([low.round_trip(rows[b0:b0 + 2 * block])
                          for b0 in range(0, batch, 2 * block)])
    judge(ctx, coeffs, cube_of, out_of)


def run(ctx) -> dict:
    from repro_torch.core import ProcGrid, gamma_plans

    cfg = ctx.config
    n, d, nb, batch = _sizes(cfg)
    calls = nb // batch
    dev = ctx.device
    grid = ProcGrid.create(list(cfg["grid"]), device=dev)
    inv, fwd = gamma_plans(grid, n, d, batch, backend=cfg["backend"])
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
    before = _counters()
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
    after = _counters()
    ctx.read_memory_peak()
    del inv, fwd
    ctx.release()

    t_check = time.perf_counter()
    judge(ctx, coeffs, lambda r0, r1: cube[r0:r1], lambda h: outs[h])
    ctx.notes["check_s"] = time.perf_counter() - t_check
    sphere = GammaSphere(d)
    rows = -(-batch // 2)
    per_call = pair_calls(n, d, sphere.npacked, sphere.ncols, rows)
    return {"attempted": pairs, "failed": 0,
            "pair_ms": 1e3 * window / pairs,
            "pairs": pairs, "window_s": window, "calls_per_pair": calls,
            "pair_work": gamma_work(n, sphere.nhalf, nb),
            "fold_work": fold_work(sphere.nhalf, sphere.npacked, nb),
            "kernel_calls": {k: v * calls for k, v in per_call.items()},
            "gamma_window": {k: x - before.get(k, 0)
                             for k, x in after.items()}}
