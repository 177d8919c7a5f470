"""Multi-tenant transform serving on the PyTorch port — replay a mixed
trace, print metrics (``examples/serve_transforms.py`` on
``repro_torch``).

Four tenants share one :class:`~repro_torch.serve.TransformService`: two
cutoffs × two k-shifts (three batch-compatibility classes — the two
k-shifts of the large cutoff coalesce into shared stacked dispatches, the
small cutoff rides its own), every request checked against per-request
eager dispatch.  The reference holds the two bitwise; the port's
coalesced dispatches run the fused sphere entry points and ``eager_apply``
the composed ones, which sum in another order, so here they agree within
``RTOL`` of the largest value.  Ends by printing the service's metrics
summary: per-tenant p50/p99 latency, requests/s, realized padding
fraction, and the shared PlanCache's hit rate over the trace.

Run:  PYTHONPATH=src python examples/torch_serve_transforms.py \\
          [--requests 32] [--n 16] [--d 8] [--grid 1] [--budget 0.5] \\
          [--trace-out trace.json] [--device cpu]
      (the CUDA card unless ``--device`` says otherwise; --grid 4 needs
       ``torch.distributed`` with four ranks, and d and n must divide it;
       --trace-out writes a Perfetto-loadable span trace — dispatch spans
       nest transforms nest per-stage FFT/all_to_all, with per-request
       queue-wait events on the side)
"""
import argparse
import json

import numpy as np

from repro_torch.core import (ProcGrid, global_plan_cache, kpoint_sphere,
                              resolve_device)
from repro_torch.obs.trace import get_tracer
from repro_torch.serve import TransformService

#: coalesced vs eager dispatch: fp32 sums in another order, relative to
#: the largest value (the port's limit for transforms, PERF.md §2)
RTOL = 1e-5


def build_trace(n, d, d_small, requests, rng):
    """(tenant, coeffs, sphere, v_eff) tuples: two cutoffs × two k-shifts."""
    shapes = [
        ("alpha", kpoint_sphere(d), 2),                    # Γ, large cutoff
        ("beta", kpoint_sphere(d, (0.5, 0.5, 0.5)), 2),    # k-shifted
        ("gamma", kpoint_sphere(d_small), 1),              # small cutoff, Γ
        ("delta", kpoint_sphere(d_small, (0.5, 0.0, 0.0)), 1),
    ]
    veff = rng.standard_normal((n,) * 3).astype(np.float32)
    trace = []
    for i in range(requests):
        tenant, sphere, nbands = shapes[i % len(shapes)]
        c = (rng.standard_normal((nbands, sphere.npacked))
             + 1j * rng.standard_normal((nbands, sphere.npacked))
             ).astype(np.complex64)
        trace.append((tenant, c, sphere, veff if i % 2 == 0 else None))
    return trace


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--n", type=int, default=16, help="FFT cube width")
    ap.add_argument("--d", type=int, default=8,
                    help="large cut-off sphere diameter")
    ap.add_argument("--d-small", type=int, default=None,
                    help="small cut-off diameter (default d/2)")
    ap.add_argument("--grid", type=int, default=1,
                    help="fft-axis process count")
    ap.add_argument("--budget", type=float, default=0.5,
                    help="padding-fraction budget for coalescing")
    ap.add_argument("--max-rows", type=int, default=8)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON of the run "
                         "(per-stage plan spans, device-synced at span "
                         "exit — slows the run, timings stay honest)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    d_small = args.d_small if args.d_small is not None else args.d // 2
    if args.trace_out:
        get_tracer().enable(sync=True, per_stage=True)

    grid = ProcGrid.create([args.grid], ["dft_f"],
                           device=resolve_device(args.device))
    global_plan_cache().clear()
    svc = TransformService(grid, args.n, padding_budget=args.budget,
                           max_rows=args.max_rows, warm_async=False)
    rng = np.random.default_rng(0)
    trace = build_trace(args.n, args.d, d_small, args.requests, rng)

    handles = [svc.submit(t, c, s, v_eff=v) for t, c, s, v in trace]
    svc.run_until_idle()

    results = [h.result(10) for h in handles]
    worst = 0.0
    for got, (_, c, s, v) in zip(results, trace):
        want = svc.eager_apply(c, s, v)
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        worst = max(worst, float(err))
    m = svc.metrics.summary()
    print(json.dumps(m, indent=2))
    print(f"coalesced {m['coalesced_dispatches']}/{m['dispatches']} "
          f"dispatches, padding ≤ {m['padding_fraction_max']:.3f} "
          f"(budget {args.budget})")
    assert worst <= RTOL, f"results differ from eager by {worst:.3e}"
    print(f"all results within {worst:.2e} of eager dispatch (limit "
          f"{RTOL:g}) ✓")
    if args.trace_out:
        tr = get_tracer()
        tr.disable()
        tr.export_chrome(args.trace_out)
        print(f"trace: {len(tr.events())} spans -> {args.trace_out} "
              "(load in https://ui.perfetto.dev)")
    return {"metrics": m, "results": results, "max_rel_err": worst}


if __name__ == "__main__":
    main()
