"""Quickstart on the PyTorch port — the paper's Fig. 6 walkthrough on the
builder API (``examples/quickstart.py`` on ``repro_torch``).

Creates a processing grid, declares the transform with one arrow-spec
string (input dims → output dims; renamed dims are transformed, annotated
dims are distributed), builds the plan, and runs it::

    g    = ProcGrid.create([nproc], device=dev)
    fx   = fftb("x{0} y z -> X Y Z{0}", domains=dom, grid=g)
    y    = fx(x)
    x2   = fx.inverse()(y)            # derived mirror — no second planning

One-shot calls can skip plan handling entirely — ``fftb.apply`` memoizes
plans in a process-global LRU cache::

    y = fftb.apply("x{0} y z -> X Y Z{0}", x, domains=dom, grid=g)

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
      (the CUDA card unless ``--device`` says otherwise; under
       ``torch.distributed`` with several ranks the grid spans them)
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (Domain, ProcGrid, fftb, global_plan_cache,
                              resolve_device)


def _nproc() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if (dist.is_available()
                                     and dist.is_initialized()) else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. processing grid (1D here; 2D/3D work the same way)
    g = ProcGrid.create([_nproc()], device=dev)
    print(f"grid: {g} on {dev}")

    # 2. declare the transform: 64³ cube, x-distributed in, z-distributed
    #    out — the planner derives the schedule from the spec alone
    n = 64
    dom = Domain((0, 0, 0), (n - 1, n - 1, n - 1))
    fx = fftb("x{0} y z -> X Y Z{0}", domains=dom, grid=g)
    print(fx.describe())
    print("comm per device:", fx.comm_stats())

    # 3. execute and validate
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((n, n, n))
         + 1j * rng.standard_normal((n, n, n))).astype(np.complex64)
    y = fx(torch.as_tensor(x, device=dev)).cpu().numpy()
    ref = np.fft.fftn(x)
    err = np.abs(y - ref).max() / np.abs(ref).max()
    print(f"max rel err vs numpy.fft: {err:.2e}")
    assert err < 1e-5

    # 4. the inverse is derived from the same stage list (no re-planning)
    x2 = fx.inverse()(torch.as_tensor(y, device=dev)).cpu().numpy()
    rt = np.abs(x2 - x).max()
    print(f"inverse()(fx(x)) roundtrip err: {rt:.2e}")
    assert rt < 1e-4

    # 5. one-shot cached form: same plan object on every repeat call
    xt = torch.as_tensor(x, device=dev)
    y2 = fftb.apply("x{0} y z -> X Y Z{0}", xt, domains=dom, grid=g)
    np.testing.assert_allclose(y2.cpu().numpy(), y, rtol=0, atol=0)
    fftb.apply("x{0} y z -> X Y Z{0}", xt, domains=dom, grid=g)
    print("plan cache:", global_plan_cache().stats)
    return {"err": float(err), "roundtrip": float(rt),
            "cache": dict(global_plan_cache().stats)}


if __name__ == "__main__":
    main()
