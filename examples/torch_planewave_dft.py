"""Plane-wave DFT on the PyTorch port — thin CLI over the
``repro_torch.dft`` SCF subsystem (``examples/planewave_dft.py`` on
``repro_torch``).

The paper's target application, end to end: a self-consistent Kohn-Sham
calculation where every hot operation is an FFTB plan — per-k-point sphere
transforms (a batch of *different* spheres, bands batched within each, one
plan per sphere served from the process-global PlanCache) interleaved with
full-cube density/potential transforms for the G-space Hartree solve.
The line DFTs run on the "matmul" route (plain torch GEMMs), as the
reference's defaults run them.

Run:  PYTHONPATH=src python examples/torch_planewave_dft.py \\
          [--n 16] [--bands 4] [--kpts "0,0,0;0.5,0.5,0.5"] [--grid 2x2] \\
          [--trace-out trace.json] [--device cpu]
      (the CUDA card unless ``--device`` says otherwise; a grid of several
       points needs ``torch.distributed`` with one rank per point;
       --grid auto picks 1D fft vs 2D batch×fft from the problem shape;
       --trace-out writes a Perfetto-loadable span trace — SCF iterations
       nest transforms nest per-stage FFT/all_to_all spans)
"""
import argparse

from repro_torch.core import (ExecPolicy, ProcGrid, global_plan_cache,
                              resolve_device)
from repro_torch.dft import SCFConfig, run_scf
from repro_torch.obs.trace import get_tracer
from repro_torch.sharding.grids import (DFT_AXES_1D, DFT_AXES_2D,
                                        DFT_AXES_3D, choose_dft_grid)


def parse_kpts(spec: str):
    """'0,0,0;0.5,0.5,0.5' → ((0,0,0), (0.5,0.5,0.5))."""
    return tuple(tuple(float(x) for x in part.split(","))
                 for part in spec.split(";") if part.strip())


def parse_grid(spec: str, cfg: SCFConfig, device):
    """'auto' | '4' | '2x2' | '2x2x2' → ProcGrid (1D fft-only, 2D
    batch×fft, 3D batch×fft×fft pencil — the PlaneWaveBasis convention:
    first axis batch, trailing axes decompose the fft)."""
    if spec == "auto":
        return choose_dft_grid(nbands=cfg.nbands, nk=len(cfg.kpts),
                               diameter=cfg.diameter or cfg.n // 2,
                               device=device)
    shape = [int(p) for p in spec.lower().split("x")]
    try:
        names = {1: DFT_AXES_1D, 2: DFT_AXES_2D, 3: DFT_AXES_3D}[len(shape)]
    except KeyError:
        raise SystemExit(f"--grid {spec!r}: at most 3 axes "
                         "(batch x fft x fft)")
    return ProcGrid.create(shape, list(names), device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=16, help="FFT cube width")
    ap.add_argument("--diameter", type=int, default=None,
                    help="cut-off sphere diameter (default n/2)")
    ap.add_argument("--bands", type=int, default=4)
    ap.add_argument("--kpts", default="0,0,0;0.5,0.5,0.5",
                    help="semicolon-separated reduced k-points")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--inner-steps", type=int, default=4)
    ap.add_argument("--mix-alpha", type=float, default=0.7)
    ap.add_argument("--depth", type=float, default=4.0)
    ap.add_argument("--no-xc", action="store_true",
                    help="drop the LDA exchange term")
    ap.add_argument("--policy", default="eager",
                    choices=["eager", "lazy", "lazy_bf16"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grid", default="auto",
                    help="processing grid: 'auto', '4' (1D fft), "
                         "'2x2' (batch×fft 2D), or '2x2x2' "
                         "(batch×fft×fft pencil)")
    ap.add_argument("--segment-padding", type=float, default=None,
                    metavar="FRAC",
                    help="per-segment padding budget for the stacked "
                         "route: split the ragged k-stack into segments "
                         "whose realized padding stays under FRAC "
                         "(default: one segment padded to the global "
                         "max sphere)")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="serial per-k loop instead of the double-buffered "
                         "k-point pipeline")
    ap.add_argument("--stack-k", default="auto",
                    choices=["auto", "on", "off"],
                    help="ragged k-stacked H applies + the batched "
                         "band-update engine: 'auto' engages when the "
                         "grid shards the nk·nbands batch evenly "
                         "(basis.stacks_k), 'on'/'off' force the route")
    ap.add_argument("--jit-step", action="store_true",
                    help="fuse mixing + band update + density into one "
                         "step per outer iteration, replayed as CUDA "
                         "graphs on the card (requires the stacked route; "
                         "combine with --stack-k on to force it on small "
                         "grids)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON of the run "
                         "(per-stage plan spans, device-synced at span "
                         "exit — slows the run, timings stay honest)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.trace_out:
        get_tracer().enable(sync=True, per_stage=True)

    cfg = SCFConfig(
        n=args.n, diameter=args.diameter, nbands=args.bands,
        kpts=parse_kpts(args.kpts), max_iter=args.iters, e_tol=args.tol,
        inner_steps=args.inner_steps, mix_alpha=args.mix_alpha,
        depth=args.depth, xc=not args.no_xc, seed=args.seed,
        pipeline=not args.no_pipeline,
        stack_k={"auto": None, "on": True, "off": False}[args.stack_k],
        jit_step=args.jit_step,
        segment_padding=args.segment_padding,
        policy=ExecPolicy.from_mode(args.policy))
    grid = parse_grid(args.grid, cfg, dev)

    print(f"device={dev}  grid={grid}  n={cfg.n}  "
          f"bands={cfg.nbands}  k-points={len(cfg.kpts)}")

    def progress(it, e, r):
        if it % 5 == 0:
            print(f"iter {it:3d}  E = {e:+.7f}  |Δρ| = {r:.3e}")

    res = run_scf(cfg, grid=grid, callback=progress)

    print(f"\n{'converged' if res.converged else 'NOT converged'} in "
          f"{res.iterations} iterations:  E = {res.energy:+.7f}")
    for ik, eps in enumerate(res.eigenvalues):
        print(f"  k[{ik}] eigenvalues: "
              + "  ".join(f"{e:+.4f}" for e in eps))
    route = (f"stacked band updates ({res.segments} segment(s), padding "
             f"{res.padding_fraction:.1%})" if res.stacked
             else "pipelined per-k H applies" if cfg.pipeline
             else "serial per-k H applies")
    if res.jitted:
        route += ", fused step"
    print(f"{res.transforms} per-band 3D transforms in {res.seconds:.2f}s "
          f"({res.transforms_per_s:.1f} transforms/s, batched over "
          f"{cfg.nbands} bands per plan call, {route})")
    c = res.cache_stats
    total = c["hits"] + c["misses"]
    print(f"plan cache: {c['misses']} builds, {c['hits']} hits "
          f"({c['hits'] / max(total, 1):.1%} hit rate) — "
          f"{global_plan_cache()!r}")
    if args.trace_out:
        tr = get_tracer()
        tr.disable()
        tr.export_chrome(args.trace_out)
        summ = tr.summary()
        top = sorted(summ.items(), key=lambda kv: -kv[1]["total_ms"])[:8]
        print(f"\ntrace: {len(tr.events())} spans -> {args.trace_out} "
              "(load in https://ui.perfetto.dev)")
        for name, s in top:
            print(f"  {name:28s} x{s['count']:<5d} {s['total_ms']:9.2f} ms")
    return res


if __name__ == "__main__":
    main()
