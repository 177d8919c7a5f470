#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version at the shapes of the stacked
plane-wave SCF at the paper's widths (grid n = 256, sphere diameter
d = 128: ``repro/configs/fftb_paper.py``), then runs that SCF through the
public entry point ``repro_torch.dft.run_scf`` on the kernel route
(``backend="cuda"``) and on the plain ``torch.matmul`` route, and compares
the two.  Every kernel of the path must have launched during the kernel
route's run.  Exits non-zero, printing no result line, on any failed check
or when no CUDA device is present.

Printed, in order: the card's name and power limit, the kernel build time,
per-kernel errors/exact-zero checks/times, the SCF comparison, one JSON
line ``{"kernels": [...]}``, and last the device JSON line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the slice's configuration: the paper's transform widths, cut in scale only
N, DIAMETER = 256, 128
KPTS = ((0.0, 0.0, 0.0), (0.5, 0.5, 0.5))
NBANDS, MAX_ITER, SEED = 16, 3, 0
REDUCED = {"nbands": "256 -> 16 per k-point", "scf_iterations": "~40 -> 3"}

# H100 SXM published peaks (NVIDIA data sheet): HBM and fp32 without
# tensor cores, the unit these kernels use
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# kernel vs plain version: both fp32, sums in another order; relative to
# the largest output magnitude
KERNEL_RTOL = 1e-5
# kernel route vs matmul route over the whole SCF: fp32 rounding of
# 1.1M-lane Gram sums and 16.7M-point cube reductions, carried through
# three mixed iterations (2e-6 relative measured at n = 16 on the CPU)
ENERGY_RTOL = 1e-4
EIG_ATOL = 1e-4
RHO_RTOL = 1e-3


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    print(("  ok   " if ok else "  FAIL ") + what, flush=True)
    if not ok:
        raise CheckFailed(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` launches."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOP_PER_S
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def rel_err(torch, got, want) -> tuple[float, float]:
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def is_plus_zero(torch, t) -> bool:
    """Every element exactly +0.0 (real and imaginary parts)."""
    f = torch.view_as_real(t) if t.is_complex() else t
    return bool(((f == 0) & ~torch.signbit(f)).all())


def crandn(torch, gen, shape, device):
    re = torch.randn(shape, generator=gen, device=device)
    im = torch.randn(shape, generator=gen, device=device)
    return torch.complex(re, im)


# ------------------------------------------------------------------ kernels
def check_dft_matmul(torch, dev, gen):
    from repro_torch.core.local_fft import dft_matrix_device
    from repro_torch.kernels.dft_matmul import dft_matmul, dft_matmul_plain
    print("dft_matmul (kernel #1): complex line-DFT GEMM", flush=True)
    # ragged edges (M, N not whole tiles, K not a whole chunk)
    x = crandn(torch, gen, (1000, 24), dev)
    _, _, w = dft_matrix_device(40, 24, True, dev)
    _, rel = rel_err(torch, dft_matmul(x, w), dft_matmul_plain(x, w))
    check(rel <= KERNEL_RTOL, f"ragged 1000x24->40: rel err {rel:.3e} "
          f"<= {KERNEL_RTOL:g}")
    # forward truncating y-stage shape of the stacked H apply
    x = crandn(torch, gen, (32 * 128 * 256, 256), dev)
    _, _, w = dft_matrix_device(128, 256, False, dev)
    _, rel = rel_err(torch, dft_matmul(x, w), dft_matmul_plain(x, w))
    check(rel <= KERNEL_RTOL, f"forward 1048576x256->128: rel err "
          f"{rel:.3e} <= {KERNEL_RTOL:g}")
    del x
    # the inverse x stage: the largest line-DFT stage of the H apply
    M, K, Nn = 32 * 256 * 256, 128, 256
    x = crandn(torch, gen, (M, K), dev)
    _, _, w = dft_matrix_device(Nn, K, True, dev)
    y = dft_matmul(x, w)
    yp = dft_matmul_plain(x, w)
    err, rel = rel_err(torch, y, yp)
    check(rel <= KERNEL_RTOL, f"inverse {M}x{K}->{Nn}: max abs err "
          f"{err:.3e}, rel {rel:.3e} <= {KERNEL_RTOL:g}")
    del y, yp
    ms = time_ms(torch, lambda: dft_matmul(x, w))
    plain = time_ms(torch, lambda: dft_matmul_plain(x, w), reps=5)
    lib = time_ms(torch, lambda: torch.matmul(x, w.T))
    b, by = bound_ms(8.0 * (M * K + Nn * K + M * Nn), 8.0 * M * Nn * K)
    print(f"  time {ms:.3f} ms, plain {plain:.3f} ms, complex64 "
          f"torch.matmul {lib:.3f} ms, bound {b:.3f} ms ({by})", flush=True)
    del x
    return {"name": "dft_matmul", "max_abs_err": err, "rel_err": rel,
            "tolerance": KERNEL_RTOL, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": lib,
            "shape": f"{M}x{K}->{Nn}"}


def check_unpack_dft(torch, dev, gen, spheres):
    from repro_torch.core.local_fft import dft_matrix_device
    from repro_torch.kernels import sphere_pack as sp
    print("unpack_dft (kernel #3): CSR gather + d->n line DFT", flush=True)
    start, zlo, cnt, flag = (torch.as_tensor(t, device=dev) for t in
                             sp.line_tables(spheres, NBANDS))
    B, nl = start.shape
    npk = max(s.npacked for s in spheres)
    packed = crandn(torch, gen, (B, npk), dev)
    # lanes past each row's sphere are untrusted: NaN proves they are
    # never read (a read would poison the row's outputs)
    for k, s in enumerate(spheres):
        packed[k * NBANDS:(k + 1) * NBANDS, s.npacked:] = float("nan")
    _, _, w = dft_matrix_device(N, DIAMETER, True, dev)
    y = sp.unpack_dft(packed, start, zlo, cnt, flag, w)
    yp = sp.unpack_dft_plain(packed, start, zlo, cnt, flag, w)
    err, rel = rel_err(torch, y, yp)
    check(bool(torch.isfinite(torch.view_as_real(y)).all()),
          "no padded (NaN) lane was read")
    check(rel <= KERNEL_RTOL, f"({B}, {npk}) -> {tuple(y.shape)}: max abs "
          f"err {err:.3e}, rel {rel:.3e} <= {KERNEL_RTOL:g}")
    empty = (cnt == 0).reshape(B, DIAMETER, DIAMETER)
    check(is_plus_zero(torch, y[empty]),
          f"{int(empty.sum())} lines with cnt=0 are bitwise +0.0")
    flag0 = flag.clone()
    planes = [0, 1, 3 * DIAMETER // 5]
    flag0[planes] = 0
    y0 = sp.unpack_dft(packed, start, zlo, cnt, flag0, w)
    check(is_plus_zero(torch, y0[:, planes]),
          f"flag=0 planes {planes} are bitwise +0.0")
    check(bool(torch.equal(y0[:, 2], y[:, 2])),
          "planes with flag=1 are unchanged by the zero-skip")
    del y, yp, y0
    ms = time_ms(torch, lambda: sp.unpack_dft(packed, start, zlo, cnt, flag,
                                              w))
    plain = time_ms(torch, lambda: sp.unpack_dft_plain(
        packed, start, zlo, cnt, flag, w), reps=5)
    lanes = float(cnt.sum())                       # this run's packed lanes
    nbytes = 8.0 * (lanes + N * DIAMETER + B * nl * N) + 4.0 * 3 * B * nl
    b, by = bound_ms(nbytes, 8.0 * N * lanes)
    print(f"  time {ms:.3f} ms, plain {plain:.3f} ms, bound {b:.3f} ms "
          f"({by}); no single torch call computes it", flush=True)
    return {"name": "unpack_dft", "max_abs_err": err, "rel_err": rel,
            "tolerance": KERNEL_RTOL, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "shape": f"({B},{npk})->({B},{DIAMETER},{DIAMETER},{N})"}


def check_dft_pack(torch, dev, gen, spheres):
    import numpy as np

    from repro_torch.core.local_fft import dft_matrix_device
    from repro_torch.kernels import sphere_pack as sp
    print("dft_pack (kernel #4): n->d line DFT + CSR pack", flush=True)
    start, zlo, cnt, _ = (torch.as_tensor(t, device=dev) for t in
                          sp.line_tables(spheres, NBANDS))
    B, nl = start.shape
    npk = max(s.npacked for s in spheres)
    nvalid = torch.as_tensor(np.repeat(np.asarray(
        [s.npacked for s in spheres], np.int32), NBANDS), device=dev)
    slab = crandn(torch, gen, (B, DIAMETER, DIAMETER, N), dev)
    _, _, w = dft_matrix_device(DIAMETER, N, False, dev)
    out = sp.dft_pack(slab, start, zlo, cnt, nvalid, w, npk)
    outp = sp.dft_pack_plain(slab, start, zlo, cnt, nvalid, w, npk)
    err, rel = rel_err(torch, out, outp)
    check(rel <= KERNEL_RTOL, f"{tuple(slab.shape)} -> ({B}, {npk}): max "
          f"abs err {err:.3e}, rel {rel:.3e} <= {KERNEL_RTOL:g}")
    pad = (torch.arange(npk, device=dev)[None, :]
           >= nvalid.long()[:, None])
    check(int(pad.sum()) > 0 and is_plus_zero(torch, out[pad]),
          f"{int(pad.sum())} padded lanes are bitwise +0.0")
    del out, outp
    ms = time_ms(torch, lambda: sp.dft_pack(slab, start, zlo, cnt, nvalid,
                                            w, npk))
    plain = time_ms(torch, lambda: sp.dft_pack_plain(
        slab, start, zlo, cnt, nvalid, w, npk), reps=5)
    lanes = float(nvalid.sum())                    # this run's valid lanes
    nbytes = (8.0 * (slab.numel() + DIAMETER * N + B * npk)
              + 4.0 * (3 * B * nl + B))
    b, by = bound_ms(nbytes, 8.0 * N * lanes)
    print(f"  time {ms:.3f} ms, plain {plain:.3f} ms, bound {b:.3f} ms "
          f"({by}); no single torch call computes it", flush=True)
    return {"name": "dft_pack", "max_abs_err": err, "rel_err": rel,
            "tolerance": KERNEL_RTOL, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "shape": f"({B},{DIAMETER},{DIAMETER},{N})->({B},{npk})"}


# ---------------------------------------------------------------------- SCF
def run_slice(torch, dev):
    import numpy as np

    from repro_torch.dft import SCFConfig, run_scf
    from repro_torch.dft.basis import PlaneWaveBasis
    from repro_torch.dft.hamiltonian import orthonormalize
    from repro_torch.kernels import sphere_pack
    from repro_torch.kernels.dft_matmul import dft_matmul

    print(f"SCF: n={N} d={DIAMETER} nbands={NBANDS} kpts={KPTS} "
          f"stack_k=True max_iter={MAX_ITER}", flush=True)
    print("reduced: " + json.dumps(REDUCED), flush=True)
    basis = PlaneWaveBasis(N, diameter=DIAMETER, kpts=KPTS, nbands=NBANDS,
                           device=dev)
    rng = np.random.default_rng(SEED)
    coeffs = []
    for ik in range(basis.nk):
        npk = basis.npacked(ik)
        c = (rng.standard_normal((NBANDS, npk))
             + 1j * rng.standard_normal((NBANDS, npk))).astype(np.complex64)
        coeffs.append(orthonormalize(torch.as_tensor(c, device=dev)))
    print(f"  stacked batch B={basis.nk * NBANDS}, npacked_max="
          f"{basis.npacked_max}", flush=True)

    def cfg(backend):
        # mix_warmup >= max_iter: a fixed trajectory, no early stop
        return SCFConfig(n=N, diameter=DIAMETER, nbands=NBANDS, kpts=KPTS,
                         stack_k=True, backend=backend, max_iter=MAX_ITER,
                         mix_warmup=MAX_ITER)

    wrappers = (dft_matmul, sphere_pack.unpack_dft, sphere_pack.dft_pack)
    for fn in wrappers:
        fn.launches = 0
    res_k = run_scf(cfg("cuda"), device=dev, coeffs=coeffs)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    res_m = run_scf(cfg("matmul"), device=dev, coeffs=coeffs)
    after = {fn.__name__: fn.launches for fn in wrappers}
    print(f"  kernel launches on the cuda route: {launches}", flush=True)
    for name, k in launches.items():
        check(k > 0, f"{name} launched {k} times on the cuda route")
        check(after[name] == k, f"{name} never launched on the matmul "
              "route")
    check(res_k.stacked and res_k.backend == "cuda"
          and res_m.backend == "matmul", "both runs rode the stacked route")
    for res in (res_k, res_m):
        per_it = [round(r["seconds"], 3) for r in res.iteration_records]
        print(f"  {res.backend:6s}: energies {res.energies}, "
              f"{res.seconds_per_iteration:.3f} s/iteration "
              f"(per iteration {per_it})", flush=True)
    ek, em = np.asarray(res_k.energies), np.asarray(res_m.energies)
    de = float(np.abs(ek - em).max())
    check(len(ek) == len(em) == MAX_ITER and np.isfinite(ek).all(),
          f"{MAX_ITER} finite energies per route")
    check(de <= ENERGY_RTOL * max(1.0, float(np.abs(em).max())),
          f"energies agree: max |dE| {de:.3e} <= {ENERGY_RTOL:g}·max(1,|E|)")
    deig = float(np.abs(res_k.eigenvalues - res_m.eigenvalues).max())
    check(res_k.eigenvalues.shape == (len(KPTS), NBANDS)
          and bool(np.all(np.diff(res_k.eigenvalues, axis=1) >= -1e-6)),
          "eigenvalues (nk, nbands), ascending per k")
    check(deig <= EIG_ATOL * max(1.0, float(np.abs(res_m.eigenvalues).max())),
          f"eigenvalues agree: max diff {deig:.3e} <= {EIG_ATOL:g}")
    drho = float((res_k.rho - res_m.rho).abs().max())
    rmax = float(res_m.rho.abs().max())
    check(tuple(res_k.rho.shape) == (N, N, N)
          and bool(torch.isfinite(res_k.rho).all()),
          f"rho is a finite ({N},{N},{N}) field")
    check(drho <= RHO_RTOL * rmax,
          f"rho agrees: max diff {drho:.3e} <= {RHO_RTOL:g}·{rmax:.3e}")
    return launches, {"cuda_s_per_iteration": res_k.seconds_per_iteration,
                      "matmul_s_per_iteration": res_m.seconds_per_iteration,
                      "energy_cuda": res_k.energy,
                      "energy_matmul": res_m.energy, "max_dE": de,
                      "max_deig": deig, "max_drho": drho}


def breakdown(torch, dev):
    """Host-clock time of each piece of one SCF iteration, per route.

    One iteration is 2 Hartree solves (v_eff and the energy), 2·inner_steps
    stacked H applies, inner_steps band-update linalg steps (descent
    direction + Rayleigh-Ritz), one density build and one mixing step;
    the model sums those against the measured iteration.
    """
    import numpy as np

    from repro_torch.dft import (HartreeSolver, PlaneWaveBasis,
                                 apply_hamiltonian_padded,
                                 density_from_orbitals)
    from repro_torch.dft.hamiltonian import (_descent_direction_stacked,
                                             _rayleigh_ritz_stacked)
    from repro_torch.dft.scf import AndersonMixer, SCFConfig

    steps = SCFConfig().inner_steps

    def wall_ms(fn, reps=2):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    v = torch.randn((N, N, N), generator=gen, device=dev)
    rho = torch.rand((N, N, N), generator=gen, device=dev)
    out = {}
    for backend in ("cuda", "matmul"):
        b = PlaneWaveBasis(N, diameter=DIAMETER, kpts=KPTS, nbands=NBANDS,
                           backend=backend, device=dev)
        inv, _ = b.stacked_hamiltonian_plans()
        c = crandn(torch, gen, (b.nk, NBANDS, b.npacked_max), dev)
        tab = b.stacked_band_tables()
        blocks = inv.split(c.reshape(-1, b.npacked_max))
        hart = HartreeSolver(b)
        occ = np.ones((b.nk, NBANDS))
        mixer = AndersonMixer(history=5, warmup=MAX_ITER)
        t = {"hartree_ms": wall_ms(lambda: hart(rho)),
             "h_apply_ms": wall_ms(
                 lambda: apply_hamiltonian_padded(b, c, v, tab.kinetic)),
             "linalg_step_ms": wall_ms(lambda: _rayleigh_ritz_stacked(
                 c, _descent_direction_stacked(c, c, tab.precond), c, c)),
             "density_ms": wall_ms(
                 lambda: density_from_orbitals(b, blocks, occ)),
             "mix_ms": wall_ms(lambda: mixer.mix(rho, rho))}
        t["model_iteration_ms"] = (2 * t["hartree_ms"]
                                   + 2 * steps * t["h_apply_ms"]
                                   + steps * t["linalg_step_ms"]
                                   + t["density_ms"] + t["mix_ms"])
        out[backend] = t
        print(f"  {backend:6s}: " + ", ".join(
            f"{k} {val:.1f}" for k, val in t.items()), flush=True)
        del c, blocks
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.dft.basis import PlaneWaveBasis
        from repro_torch.kernels import build
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable: {exc}",
              file=sys.stderr)
        return 2
    # full fp32 products in every plain version and library yardstick
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"gpu: {gpu_line()}", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    for stem, log in build.build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {stem}: {line.strip()}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    spheres = PlaneWaveBasis(N, diameter=DIAMETER, kpts=KPTS,
                             nbands=NBANDS, device=dev).spheres
    results = [check_dft_matmul(torch, dev, gen),
               check_unpack_dft(torch, dev, gen, spheres),
               check_dft_pack(torch, dev, gen, spheres)]
    torch.cuda.empty_cache()
    launches, scf = run_slice(torch, dev)
    print("scf: " + json.dumps(scf), flush=True)
    print("iteration breakdown (host clock, synchronized):", flush=True)
    scf["breakdown"] = breakdown(torch, dev)

    sources = {"dft_matmul": ("src/repro_torch/kernels/csrc/dft_matmul.cu",
                              "src/repro/kernels/dft_matmul.py:32"),
               "unpack_dft": ("src/repro_torch/kernels/csrc/sphere_pack.cu",
                              "src/repro/kernels/sphere_pack.py:134"),
               "dft_pack": ("src/repro_torch/kernels/csrc/sphere_pack.cu",
                            "src/repro/kernels/sphere_pack.py:175")}
    kernels = []
    for r in results:
        src, rep = sources[r["name"]]
        kernels.append({"name": r["name"], "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[r["name"]],
                        "passed": True, **{k: r[k] for k in (
                            "max_abs_err", "rel_err", "tolerance", "ms",
                            "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "shape")}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        sys.exit(1)
