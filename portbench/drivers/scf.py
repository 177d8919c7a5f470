"""Steady iterations of the fused SCF step from a seeded start.

Not a cell of ``BENCHMARK.json`` yet: at the configuration's full size on
the card no number this window exposes separates the program from its
control (``PERF.md``, Open questions); the driver stays for the cell's
return, and the CPU tests run it at toy size.

One ``run_scf`` call with the configuration's settings (the fused step:
``jit_step=True``, CUDA graphs) on the benchmark's own external potential
and orthonormal starting bands.  Its first iteration (warm-up and graph
capture) is set-up; the window opens at its end and closes at the first
iteration end after ``--seconds``.  If the SCF converges inside the
window, a new solve starts from the next seeded start, and its first
iteration counts.

Judged once the window has closed: the first solve's first
``checked_iterations`` energies and density residuals, each against the
plain reference following the same algorithm from the same start in
float64 (:class:`portbench.reference.SCF`).
"""
from __future__ import annotations

import math
import time

import torch

from ..inputs import orthonormal_bands, seeded_wells
from ..reference import SCF, Sphere


class _WindowClosed(Exception):
    """Raised from the SCF's callback at the first iteration end after
    the window's length: the run stops there."""


def make_start(ctx, cfg: dict, mix: dict, stream: int):
    """(v_ext, per-k starting bands) of start ``stream``, on the device."""
    n, d = int(cfg["n"]), int(cfg["diameter"])
    w = mix["wells"]
    v = seeded_wells(n, w["centers"], float(w["depth"]),
                     float(w["width_over_n"]) * n, ctx.rng(stream),
                     ctx.device)
    gen = ctx.generator(stream)
    bands = [orthonormal_bands(int(cfg["nbands"]), Sphere(d, k).npacked,
                               gen, ctx.device) for k in cfg["kpts"]]
    return v, bands


def scf_config(cfg: dict):
    from repro_torch.dft import SCFConfig
    keys = ("n", "diameter", "nbands", "stack_k", "backend", "jit_step",
            "inner_steps", "mix_alpha", "mix_history", "mix_warmup", "xc",
            "max_iter", "e_tol", "r_tol")
    return SCFConfig(kpts=tuple(tuple(k) for k in cfg["kpts"]),
                     **{k: cfg[k] for k in keys})


def judge(ctx, start, first) -> None:
    """The first iterations' (energy, residual) pairs ``first`` against
    the reference's from the same ``start``: the widest relative gap of
    each over those iterations."""
    mix = ctx.traffic
    ref = SCF(ctx.config, start[0], start[1], ctx.device,
              precision="float64", block=int(mix.get("check_block", 8)))
    e_gap = r_gap = 0.0
    for e_got, r_got in first:
        e_ref, r_ref = ref.iterate()
        e_gap = max(e_gap, abs(e_got - e_ref) / abs(e_ref))
        r_gap = max(r_gap, abs(r_got - r_ref) / abs(r_ref))
    if len(first) < int(mix["checked_iterations"]):
        e_gap = math.inf                # fewer iterations than judged
    ctx.check("energy_gap", e_gap, mix["limits"]["energy_gap"])
    # the residual's gap is read, not compared: float32 cancellation in
    # |rho_out - rho_in| makes sound runs read as far as the control
    ctx.notes["residual_gap"] = r_gap


def control(ctx) -> None:
    """The judge's numbers with the reference in TF32 (transforms) and
    float32 (the rest) in the program's place."""
    mix = ctx.traffic
    start = make_start(ctx, ctx.config, mix, 0)
    low = SCF(ctx.config, start[0], start[1], ctx.device, precision="tf32",
              block=int(mix.get("check_block", 8)))
    first = [low.iterate() for _ in range(int(mix["checked_iterations"]))]
    del low
    judge(ctx, start, first)


def run(ctx) -> dict:
    from repro_torch.dft import run_scf

    cfg, mix = ctx.config, ctx.traffic
    checked = int(mix["checked_iterations"])
    scfc = scf_config(cfg)
    v_ext, bands = make_start(ctx, cfg, mix, 0)
    start = (v_ext.clone(), [b.clone() for b in bands])
    ctx.mark("inputs")
    first: list[tuple[float, float]] = []
    st = {"solve": 0, "t0": None, "t_end": None, "iters": 0}

    def callback(it, energy, resid):
        now = time.perf_counter()
        if st["solve"] == 0 and it < checked:
            first.append((float(energy), float(resid)))
        if st["t0"] is None:
            ctx.tracer.start()
            st["t0"] = ctx.start_window()
            return
        st["iters"] += 1
        st["t_end"] = now
        if (now - st["t0"] >= ctx.seconds
                and (st["solve"] > 0 or len(first) >= checked)):
            raise _WindowClosed

    try:
        while True:
            run_scf(scfc, device=ctx.device, v_ext=v_ext, coeffs=bands,
                    callback=callback)
            st["solve"] += 1
            v_ext, bands = make_start(ctx, cfg, mix, st["solve"])
    except _WindowClosed:
        pass
    ctx.tracer.stop()
    window = st["t_end"] - st["t0"]
    ctx.read_memory_peak()
    del v_ext, bands
    ctx.release()

    t_check = time.perf_counter()
    judge(ctx, start, first)
    ctx.notes["check_s"] = time.perf_counter() - t_check
    ctx.notes["solves"] = st["solve"] + 1
    ctx.notes["first_energies"] = [e for e, _ in first]
    return {"attempted": st["iters"], "failed": 0,
            "scf_iter_s": window / st["iters"], "iterations": st["iters"],
            "window_s": window}
