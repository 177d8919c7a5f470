"""Closed loop of GW matrix-element pairs: one valence band against the
conduction block.

A pair takes the next of the ``nv`` valence bands in turn and runs the
port's pair-density entry (``repro_torch.dft.pair_density``) on all ``nb``
conduction bands, ``band_batch`` bands a call: the inverse on the
``diameter`` sphere, the product with conj(ψ_v), the forward onto the
``diameter_eps`` sphere.  The valence conjugates are made in set-up through
the port's helper (``valence_conjugates``) from the seed, untimed.  The
forward's sphere is the cut-off sphere about G = 0
(``repro_torch.dft.cutoff_sphere``; the reference's own is
:func:`portbench.reference_mtxel.cutoff_sphere`).  One
pair is kept in flight, as the pair generator does (it waits for pair
i - 1 before it queues pair i + 1).  The window ends at the first pair end
after ``--seconds``.

Judged once the window has closed: every packed output of the last pair
against the plain reference in float64 (:mod:`portbench.reference_mtxel`),
max |Δ| / max |ref| (``mtxel_gap``).
"""
from __future__ import annotations

import time

import torch

from ..reference import GapMeter, Sphere
from ..reference_mtxel import MatrixElements, cutoff_sphere
from ..roofline import COMPLEX64, pair_calls, pair_work


def mtxel_work(n: int, npacked: int, npacked_eps: int,
               bands: int) -> tuple[float, float]:
    """(bytes, operations) of one pair, leg by leg: the inverse of
    ``bands`` bands from the sphere (the packed rows and the cubes, once
    each), one valence cube read, the forward onto the cut-off sphere (the
    cubes and the packed rows, once each); one 3D FFT of n³ a band and a
    leg."""
    b_inv, f_inv = pair_work(n, npacked, bands)
    b_fwd, f_fwd = pair_work(n, npacked_eps, bands)
    return (b_inv + b_fwd) / 2.0 + n ** 3 * COMPLEX64, (f_inv + f_fwd) / 2.0


def mtxel_calls(n: int, d: int, d_eps: int, rows: int
                ) -> dict[str, list[tuple[float, float]]]:
    """The kernel calls of one call of ``rows`` bands, by kernel, as
    :func:`portbench.roofline.pair_calls` counts them: the inverse's
    ``unpack_dft`` and two line stages on the d-sphere's shapes, the
    forward's two line stages and ``dft_pack`` on the d_eps-sphere's, and
    ``dft_pack``'s tail (no padded lane on one sphere: no bytes)."""
    s, e = Sphere(d), cutoff_sphere(d_eps)
    inv = pair_calls(n, d, s.npacked, s.ncols, rows)
    fwd = pair_calls(n, d_eps, e.npacked, e.ncols, rows)
    return {"dft_matmul": inv["dft_matmul"][:2] + fwd["dft_matmul"][2:],
            "sphere_pack": [inv["sphere_pack"][0], fwd["sphere_pack"][1]],
            "sphere_pack_tail": [(0.0, 0.0)]}


def _sizes(cfg):
    n, d, d_eps = int(cfg["n"]), int(cfg["diameter"]), int(cfg["diameter_eps"])
    nb, batch, nv = int(cfg["nb"]), int(cfg["band_batch"]), int(cfg["nv"])
    if nb % batch:
        raise ValueError(f"{nb} bands do not split into calls of {batch}")
    return n, d, d_eps, nb, batch, nv


def _counters() -> dict:
    """The program's ``mtxel`` probe: its numeric counters now."""
    from repro_torch.obs.metrics import global_metrics
    snap = global_metrics().snapshot().get("mtxel", {})
    return {k: x for k, x in snap.items() if isinstance(x, (int, float))}


def inputs(ctx):
    """The conduction and valence coefficients on the d-sphere, made on the
    device from the seed."""
    n, d, _, nb, _, nv = _sizes(ctx.config)
    npk = Sphere(d).npacked
    c = torch.randn((nb, npk), dtype=torch.complex64, device=ctx.device,
                    generator=ctx.generator(0))
    v = torch.randn((nv, npk), dtype=torch.complex64, device=ctx.device,
                    generator=ctx.generator(1))
    return c, v


def judge(ctx, c, v, iv: int, outs) -> None:
    """The matrix elements of valence band ``iv`` against every conduction
    band (``outs``: the pair's calls in order) against the reference in
    float64."""
    n, d, d_eps, _, batch, _ = _sizes(ctx.config)
    ref = MatrixElements(n, d, d_eps, ctx.device, "float64",
                         int(ctx.traffic.get("check_block", 4)))
    vconj = ref.valence(v[iv])
    meter = GapMeter()
    for h, out in enumerate(outs):
        meter.add(out, ref(c[h * batch:(h + 1) * batch], vconj))
    ctx.check("mtxel_gap", meter.value, ctx.traffic["limits"]["mtxel_gap"])


def control(ctx) -> None:
    """The judge's number with the reference in TF32 in the program's
    place."""
    n, d, d_eps, nb, batch, _ = _sizes(ctx.config)
    c, v = inputs(ctx)
    low = MatrixElements(n, d, d_eps, ctx.device, "tf32",
                         int(ctx.traffic.get("check_block", 4)))
    vconj = low.valence(v[0])
    outs = [low(c[h * batch:(h + 1) * batch], vconj)
            for h in range(nb // batch)]
    judge(ctx, c, v, 0, outs)


def run(ctx) -> dict:
    from repro_torch.core import ProcGrid
    from repro_torch.core.planewave import kpoint_sphere
    from repro_torch.dft import (cutoff_sphere as eps_sphere, mtxel_plans,
                                 pair_density, valence_conjugates)

    cfg = ctx.config
    n, d, d_eps, nb, batch, nv = _sizes(cfg)
    calls = nb // batch
    dev = ctx.device
    grid = ProcGrid.create(list(cfg["grid"]), device=dev)
    inv, fwd = mtxel_plans(grid, n, kpoint_sphere(d), eps_sphere(d_eps),
                           batch, backend=cfg["backend"])
    ctx.mark("plans")
    c, v = inputs(ctx)
    ctx.mark("inputs")
    vconj = valence_conjugates(inv, fwd, v)
    ctx.mark("valence conjugates")

    def one_pair(iv):
        return [pair_density(inv, fwd, c[h * batch:(h + 1) * batch],
                             vconj[iv]) for h in range(calls)]

    outs = one_pair(0)                      # builds and warms every shape
    outs = None
    cuda = dev.type == "cuda"
    before = _counters()
    ctx.tracer.start()
    t0 = ctx.start_window()
    pairs = 0
    try:
        prev = None
        while True:
            outs = None
            outs = one_pair(pairs % nv)
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
    del inv, fwd, vconj
    ctx.release()

    t_check = time.perf_counter()
    judge(ctx, c, v, (pairs - 1) % nv, outs)
    ctx.notes["check_s"] = time.perf_counter() - t_check
    npk, npk_eps = Sphere(d).npacked, cutoff_sphere(d_eps).npacked
    per_call = mtxel_calls(n, d, d_eps, batch)
    return {"attempted": pairs, "failed": 0,
            "pair_ms": 1e3 * window / pairs,
            "pairs": pairs, "window_s": window, "calls_per_pair": calls,
            "pair_work": mtxel_work(n, npk, npk_eps, nb),
            "kernel_calls": {k: x * calls for k, x in per_call.items()},
            "mtxel_window": {k: x - before.get(k, 0)
                            for k, x in after.items()}}
