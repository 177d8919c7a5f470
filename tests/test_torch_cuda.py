"""repro_torch on the card: each hand-written CUDA kernel against its plain
PyTorch version (the sphere kernels also on one rank's block of a
batch×fft grid), the four-step DFT against ``torch.fft``, the SCF on the
kernel route (also at the paper's widths, n = 256 and d = 128, against the
"matmul" route), the Γ-point fold and unfold against their plain versions
and the Γ pair at n = 256, d = 128 against ``portbench/reference_gamma.py``, the transform service against ``eager_apply`` and a
"matmul" service, the lazy executor against the eager one, the fused SCF
step replayed as CUDA graphs, the spectral layers, kernel #1's factored
mode against its plain version (and #3's and #4's, among the sphere
kernels' cases, within 2e-6), and four processes sharing the card on
the 2×2 batch×fft grid over gloo.  Where a case is "at the paper's
widths" it runs the stacked SCF's shapes: 2 k-points of 16 bands (B =
32), n = 256, d = 128.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  They import neither JAX nor the reference package, so they run
on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: the line-DFT kernels compute fp32-accurate split-TF32
products on the tensor cores, the plain versions fp32 GEMMs; they sum in
different orders and agree to 1e-5 relative to the largest magnitude.  Exact
zeros (padded lanes) are compared bitwise.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import kpoint_sphere
from repro_torch.core.local_fft import dft_matrix_device
from repro_torch.dft import SCFConfig, run_scf
from repro_torch.kernels import ops
from repro_torch.kernels import sphere_pack as sp
from repro_torch.kernels.dft_matmul import (dft_matmul, dft_matmul_plain,
                                            dft_matmul_twiddle,
                                            dft_matmul_twiddle_plain)
from repro_torch.kernels.ref import dft_apply_ref, twiddle_matrix

KPTS2 = ((0.0, 0.0, 0.0), (0.5, 0.5, 0.5))
RTOL = 1e-5
# an SCF run against another route's run of the same trajectory: fp32
# rounding of 1.1M-lane Gram sums and 16.7M-point cube reductions at the
# paper's widths, carried through three linearly mixed iterations
ENERGY_RTOL, EIG_ATOL, RHO_RTOL = 1e-4, 1e-4, 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _cx(rng, shape, dev):
    return torch.as_tensor((rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape)
                            ).astype(np.complex64), device=dev)


def _close(got, want, rtol=RTOL):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= rtol * max(float(want.abs().max()), 1e-30), err


# dft_matmul cases: (M, K, N, rows past M NaN-poisoned).  Odd K has a
# row pitch TMA cannot address and takes the kernel's gather path; M is
# never a whole number of 128-row tiles
GEMM_CASES = {
    "dft_matmul": (1000, 24, 40, False),
    "dft_matmul-odd-k5": (300, 5, 5, False),
    "dft_matmul-odd-k9-to-18": (300, 9, 18, False),
    "dft_matmul-k18-to-20": (300, 18, 20, False),
    "dft_matmul-k1": (77, 1, 3, False),
    "dft_matmul-n1": (77, 8, 1, False),
    "dft_matmul-m1": (1, 8, 8, False),
    "dft_matmul-ragged-m-128-to-256": (389, 128, 256, False),
    "dft_matmul-poisoned": (1000, 24, 40, True),
    "dft_matmul-poisoned-odd-k": (500, 9, 18, True),
    # the paper-width SCF's forward y stage, 32·128·256 lines 256 -> 128
    "dft_matmul-scf-dft-y-256-to-128": (1048576, 256, 128, False),
}


def _rows(rng, M, K, dev, poisoned):
    """(M, K) complex64 lines; poisoned: the first M rows of a larger
    buffer whose later rows are NaN, which a read would spread."""
    if not poisoned:
        return _cx(rng, (M, K), dev)
    buf = _cx(rng, (M + 77, K), dev)
    buf[M:] = float("nan")
    return buf[:M]


KPTS3 = ((0.25, 0.0, 0.5), (0.0, 0.0, 0.0), (0.5, 0.5, 0.0))

# sphere-kernel cases: (kernel, d, n, k-points, bands, slab layout, mode).
# d = 8 has ey = 8 lines a plane, so a 128-row tile straddles 16 planes;
# d = 6 has M = B·36 rows, never whole tiles, ey = 6, and 2d = 12 columns,
# less than one K chunk of 32; d = 40 has 2.5 K chunks, edge tiles that
# skip chunks, and ey = 40, which the strided read does not fit (the slab
# is copied); d = 128 has ey = 128, one plane a tile, as in the SCF.  Odd
# n gives dft_pack a row pitch TMA cannot address (the gather path).  Slab
# layouts: "rows" contiguous lines; "y-planes" each y plane z-major, as an
# x stage leaves it (the stacked SCF's forward plan), read in place;
# "x-planes" each x plane z-major, which the wrapper copies first;
# "z-major" each row's slab z-major, as the forward's x stage leaves it,
# read in place where a row's ey·ex lines fit the tile (not at d = 6).
# Mode: "dense" the product with the DFT matrix, at shapes the factored
# mode does not take and, called so, at d = 128; "factored" the two
# 16-point stages the cells' calls take (n = 256, d = 128 or 64), on 8
# bands of a ragged batch of two spheres
SPHERE_CASES = {
    "unpack_dft": ("unpack", 8, 16, KPTS2, 3, None, "dense"),
    "dft_pack": ("pack", 8, 16, KPTS2, 3, "rows", "dense"),
    "unpack_dft-ragged-m-d6": ("unpack", 6, 12, KPTS2, 3, None, "dense"),
    "unpack_dft-d40-chunk-skip": ("unpack", 40, 80, KPTS3, 2, None, "dense"),
    "unpack_dft-d128-plane-tiles": ("unpack", 128, 256, KPTS2, 1, None,
                                    "dense"),
    "unpack_dft-scf-d128": ("unpack", 128, 256, KPTS2, 16, None, "dense"),
    "dft_pack-ragged-m-d6": ("pack", 6, 12, KPTS2, 3, "rows", "dense"),
    "dft_pack-odd-n": ("pack", 6, 9, KPTS3, 2, "rows", "dense"),
    "dft_pack-x-planes-copied": ("pack", 8, 16, KPTS2, 3, "x-planes",
                                 "dense"),
    "dft_pack-y-planes": ("pack", 8, 16, KPTS2, 3, "y-planes", "dense"),
    "dft_pack-y-planes-odd-n": ("pack", 8, 15, KPTS3, 2, "y-planes",
                                "dense"),
    "dft_pack-y-planes-d128": ("pack", 128, 256, KPTS2, 1, "y-planes",
                               "dense"),
    "dft_pack-x-planes-d128-copied": ("pack", 128, 256, KPTS2, 1,
                                      "x-planes", "dense"),
    "dft_pack-y-planes-d40-copied": ("pack", 40, 80, KPTS3, 2, "y-planes",
                                     "dense"),
    "dft_pack-z-major-d6-copied": ("pack", 6, 12, KPTS2, 3, "z-major",
                                   "dense"),
    "dft_pack-z-major-d40": ("pack", 40, 80, KPTS3, 2, "z-major", "dense"),
    "unpack_dft-factored-d128": ("unpack", 128, 256, KPTS2, 4, None,
                                 "factored"),
    "unpack_dft-factored-d64": ("unpack", 64, 256, KPTS2, 4, None,
                                "factored"),
    "dft_pack-factored-d128-rows": ("pack", 128, 256, KPTS2, 4, "rows",
                                    "factored"),
    "dft_pack-factored-d128-y-planes": ("pack", 128, 256, KPTS2, 4,
                                        "y-planes", "factored"),
    "dft_pack-factored-d128-z-major": ("pack", 128, 256, KPTS2, 4,
                                       "z-major", "factored"),
    "dft_pack-factored-d64-rows": ("pack", 64, 256, KPTS2, 4, "rows",
                                   "factored"),
    "dft_pack-factored-d64-y-planes": ("pack", 64, 256, KPTS2, 4,
                                       "y-planes", "factored"),
    "dft_pack-factored-d64-z-major": ("pack", 64, 256, KPTS2, 4, "z-major",
                                      "factored"),
}
#: the factored mode against its plain version: 3xTF32 against complex64
#: products, two stages and a twiddle each
FACTORED_RTOL = 2e-6


def _mode_args(mode, n_in, n_out, inverse, lines, dev):
    """(wrapper keywords, tolerance) for a case's mode; the factored
    operands are those the plans choose by shape."""
    if mode == "dense":
        return {}, RTOL
    fo = sp.factored_for(n_in, n_out, inverse, lines, dev)
    assert fo is not None
    return {"factored": fo}, FACTORED_RTOL


def _modes():
    return dict(sp.MODES)


def _moved(before, side):
    """The calls of ``side`` ("unpack" or "pack") since ``before``, by
    mode."""
    return {m: sp.MODES[f"{side}_{m}"] - before[f"{side}_{m}"]
            for m in ("factored", "dense")}


def _slab(rng, B, d, n, layout, dev):
    """A (B, d, d, n) slab stored as ``layout`` says."""
    if layout == "rows":
        return _cx(rng, (B, d, d, n), dev)
    if layout == "x-planes":
        return _cx(rng, (B, d, n, d), dev).transpose(2, 3)
    if layout == "z-major":
        return _cx(rng, (B, n, d, d), dev).permute(0, 3, 2, 1)
    return _cx(rng, (B, d, n, d), dev).permute(0, 3, 1, 2)


def _plus_zero(t):
    f = torch.view_as_real(t)
    return bool(((f == 0) & ~torch.signbit(f)).all())


def _check_unpack(rng, dev, d, n, kpts, nb, mode="dense"):
    spheres = [kpoint_sphere(d, k) for k in kpts]
    npm = max(s.npacked for s in spheres)
    start, zlo, cnt, flag = (torch.as_tensor(t, device=dev)
                             for t in sp.line_tables(spheres, nb))
    packed = _cx(rng, (len(spheres) * nb, npm), dev)
    for k, s in enumerate(spheres):              # never read
        packed[k * nb:(k + 1) * nb, s.npacked:] = float("nan")
    _, _, w = dft_matrix_device(n, d, True, dev)
    kw, rtol = _mode_args(mode, d, n, True, start.shape[1], dev)
    # a plane with support switched off, beside the table's own flags
    flag0 = flag.clone()
    flag0[d // 2] = 0
    outs = []
    for fl in (flag, flag0):
        got = sp.unpack_dft(packed, start, zlo, cnt, fl, w, **kw)
        assert bool(torch.isfinite(torch.view_as_real(got)).all())
        _close(got, sp.unpack_dft_plain(packed, start, zlo, cnt, fl, w,
                                        kw.get("factored")), rtol)
        empty = (cnt == 0).reshape(got.shape[:3])
        assert _plus_zero(got[empty])
        outs.append(got)
    assert int(cnt.reshape(got.shape[:3])[:, d // 2].sum()) > 0
    assert _plus_zero(got[:, d // 2])
    # the planes with flag = 1 keep their bits when another is skipped
    others = [x for x in range(d) if x != d // 2]
    assert torch.equal(torch.view_as_real(outs[0][:, others]),
                       torch.view_as_real(outs[1][:, others]))
    return 2


def _check_pack(rng, dev, d, n, kpts, nb, layout, mode="dense"):
    spheres = [kpoint_sphere(d, k) for k in kpts]
    npm = max(s.npacked for s in spheres)
    start, zlo, cnt, _ = (torch.as_tensor(t, device=dev)
                          for t in sp.line_tables(spheres, nb))
    B = len(spheres) * nb
    slab = _slab(rng, B, d, n, layout, dev)
    fits = sp.cols_fit(d)
    assert sp.slab_layout(slab) == {
        "rows": 0, "x-planes": None, "y-planes": 1 if fits else None,
        "z-major": 2 if sp.cols_fit(d * d) else None}[layout]
    nvalid = torch.as_tensor(np.repeat(np.asarray(
        [s.npacked for s in spheres], np.int32), nb), device=dev)
    _, _, w = dft_matrix_device(d, n, False, dev)
    kw, rtol = _mode_args(mode, n, d, False, start.shape[1], dev)
    # poison the memory the output will take (the caching allocator hands
    # a freed block of the same size to the next allocation): every lane
    # must be written
    poison = torch.full((B, npm), float("nan"), dtype=torch.complex64,
                        device=dev)
    del poison
    got = sp.dft_pack(slab, start, zlo, cnt, nvalid, w, npm, **kw)
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    _close(got, sp.dft_pack_plain(slab, start, zlo, cnt, nvalid, w, npm,
                                  kw.get("factored")), rtol)
    pad = torch.arange(npm, device=dev)[None] >= nvalid[:, None]
    assert pad.any() and _plus_zero(got[pad])
    return 1


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [*SPHERE_CASES, *GEMM_CASES])
def test_cuda_kernel_matches_plain(kernel, cuda_device):
    dev = cuda_device
    rng = np.random.default_rng(11)
    if kernel in GEMM_CASES:
        before = dft_matmul.launches
        M, K, N, poisoned = GEMM_CASES[kernel]
        x = _rows(rng, M, K, dev, poisoned)
        _, _, w = dft_matrix_device(N, K, True, dev)
        y = dft_matmul(x, w)
        assert bool(torch.isfinite(torch.view_as_real(y)).all())
        _close(y, dft_matmul_plain(x, w))
        assert dft_matmul.launches == before + 1
        return
    which, d, n, kpts, nb, layout, mode = SPHERE_CASES[kernel]
    fn = sp.unpack_dft if which == "unpack" else sp.dft_pack
    before, modes = fn.launches, _modes()
    calls = (_check_unpack(rng, dev, d, n, kpts, nb, mode)
             if which == "unpack"
             else _check_pack(rng, dev, d, n, kpts, nb, layout, mode))
    # one launch per wrapper call on a CUDA tensor, each in the case's mode
    assert fn.launches == before + calls
    assert _moved(modes, which) == {"factored": 0, "dense": 0, mode: calls}


@pytest.mark.cuda
@pytest.mark.parametrize("B,n_in,n_out,inverse", [
    (4096, 128, 256, True), (4096, 256, 128, False), (2048, 256, 256, True),
    (2048, 256, 256, False), (1000, 24, 40, True), (300, 9, 18, False),
    (1048576, 128, 256, True), (1048576, 128, 256, False),
    (65536, 256, 256, True), (65536, 256, 256, False)])
def test_cuda_dft_apply_matches_fft_oracle(B, n_in, n_out, inverse,
                                           cuda_device):
    """Kernel #1 through ``ops.dft_apply`` against ``dft_apply_ref``
    (``torch.fft`` of the padded or truncated line, no DFT matrix): the
    SCF's line shapes (d = 128 → n = 256 and n = 256 → n = 256, both
    directions; the last four on the paper-width SCF's lines, 32·128·256
    and 256²) and two ragged ones."""
    rng = np.random.default_rng(B + n_in + n_out)
    x = _cx(rng, (B, n_in), cuda_device)
    before = dft_matmul.launches
    y = ops.dft_apply(x, n_out, inverse=inverse)
    assert dft_matmul.launches == before + 1
    _close(y, dft_apply_ref(x, n_out, inverse=inverse))


# one rank's blocks on a batch×fft grid, as the multi-rank fused route
# hands them to the kernels: its rows [r0, r1) of the stacked batch and
# its x planes [x0, x1), the line tables cut to both (kernel, d, n,
# k-points, bands, rows, x planes, slab layout, mode); the factored cases
# are a rank's block of the 2×2 grid at the paper's widths (ex = d / 2)
RANK_CASES = {
    "unpack_dft-rank-block-d8": ("unpack", 8, 16, KPTS2, 4, (4, 8), (4, 8),
                                 None, "dense"),
    "unpack_dft-rank-block-d128": ("unpack", 128, 256, KPTS2, 2, (0, 2),
                                   (64, 128), None, "dense"),
    "dft_pack-rank-block-d8": ("pack", 8, 16, KPTS2, 4, (4, 8), (0, 4),
                               "rows", "dense"),
    "dft_pack-rank-block-y-planes-d128": ("pack", 128, 256, KPTS2, 2,
                                          (2, 4), (64, 128), "y-planes",
                                          "dense"),
    "unpack_dft-rank-block-d128-factored": ("unpack", 128, 256, KPTS2, 2,
                                            (0, 2), (64, 128), None,
                                            "factored"),
    "dft_pack-rank-block-rows-d128-factored": ("pack", 128, 256, KPTS2, 2,
                                               (2, 4), (0, 64), "rows",
                                               "factored"),
    "dft_pack-rank-block-y-planes-d128-factored": ("pack", 128, 256, KPTS2,
                                                   2, (2, 4), (64, 128),
                                                   "y-planes", "factored"),
}


def _rank_tables(spheres, nb, rows, xs, dev):
    """The line tables of rows ``rows`` and x planes ``xs``, and the flag
    column of those planes."""
    ey = spheres[0].extents[1]
    start, zlo, cnt, flag = sp.line_tables(spheres, nb)
    r, lines = slice(*rows), slice(xs[0] * ey, xs[1] * ey)
    return [torch.as_tensor(np.ascontiguousarray(t[r, lines]), device=dev)
            for t in (start, zlo, cnt)] + \
        [torch.as_tensor(np.ascontiguousarray(flag[slice(*xs)]), device=dev)]


def _check_rank_unpack(rng, dev, d, n, kpts, nb, rows, xs, mode):
    spheres = [kpoint_sphere(d, k) for k in kpts]
    npm = max(s.npacked for s in spheres)
    start, zlo, cnt, flag = _rank_tables(spheres, nb, rows, xs, dev)
    packed = _cx(rng, (rows[1] - rows[0], npm), dev)
    _, _, w = dft_matrix_device(n, d, True, dev)
    kw, rtol = _mode_args(mode, d, n, True, start.shape[1], dev)
    got = sp.unpack_dft(packed, start, zlo, cnt, flag, w, **kw)
    assert tuple(got.shape) == (rows[1] - rows[0], xs[1] - xs[0], d, n)
    _close(got, sp.unpack_dft_plain(packed, start, zlo, cnt, flag, w,
                                    kw.get("factored")), rtol)
    # the rank's block of the unpack over every row and plane
    full = [torch.as_tensor(t, device=dev)
            for t in sp.line_tables(spheres, nb)]
    whole = torch.zeros((len(spheres) * nb, npm), dtype=torch.complex64,
                        device=dev)
    whole[slice(*rows)] = packed
    _close(got, sp.unpack_dft_plain(whole, *full, w)[slice(*rows),
                                                     slice(*xs)])


def _check_rank_pack(rng, dev, d, n, kpts, nb, rows, xs, layout, mode):
    spheres = [kpoint_sphere(d, k) for k in kpts]
    npm = max(s.npacked for s in spheres)
    start, zlo, cnt, _ = _rank_tables(spheres, nb, rows, xs, dev)
    B, ex = rows[1] - rows[0], xs[1] - xs[0]
    slab = _slab(rng, B, d, n, layout, dev)
    if layout == "rows":
        slab = slab[:, :ex].contiguous()
    else:                # the rank's x planes, each y plane z-major
        slab = slab.permute(0, 2, 3, 1)[..., :ex].contiguous() \
            .permute(0, 3, 1, 2)
    assert sp.slab_layout(slab) == {"rows": 0, "y-planes": 1}[layout]
    nvalid = torch.as_tensor(np.repeat(np.asarray(
        [s.npacked for s in spheres], np.int32), nb)[slice(*rows)],
        device=dev)
    _, _, w = dft_matrix_device(d, n, False, dev)
    kw, rtol = _mode_args(mode, n, d, False, start.shape[1], dev)
    # poison the memory the output will take: the caching allocator hands
    # a freed block of the same size to the next allocation
    poison = torch.full((B, npm), float("nan"), dtype=torch.complex64,
                        device=dev)
    del poison
    got = sp.dft_pack(slab, start, zlo, cnt, nvalid, w, npm, partial=True,
                      **kw)
    _close(got, sp.dft_pack_plain(slab, start, zlo, cnt, nvalid, w, npm,
                                  kw.get("factored")), rtol)
    # every lane outside the rank's lines (other planes, padding) is +0.0
    mine = torch.zeros((B, npm), dtype=torch.bool, device=dev)
    z = torch.arange(d, device=dev)
    lane = start.long()[..., None] + z
    inside = z < cnt.long()[..., None]
    rr = torch.arange(B, device=dev)[:, None, None].expand_as(lane)
    mine[rr[inside], lane[inside]] = True
    assert (~mine).any() and _plus_zero(got[~mine])


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RANK_CASES))
def test_cuda_sphere_kernels_on_a_rank_block(case, cuda_device):
    which, d, n, kpts, nb, rows, xs, layout, mode = RANK_CASES[case]
    rng = np.random.default_rng(13)
    fn = sp.unpack_dft if which == "unpack" else sp.dft_pack
    before, modes = fn.launches, _modes()
    if which == "unpack":
        _check_rank_unpack(rng, cuda_device, d, n, kpts, nb, rows, xs, mode)
    else:
        _check_rank_pack(rng, cuda_device, d, n, kpts, nb, rows, xs, layout,
                         mode)
    assert fn.launches == before + 1
    assert _moved(modes, which) == {"factored": 0, "dense": 0, mode: 1}


#: the stacked SCF's sizes: the README's, and the paper's widths with 16
#: bands a k-point
SCF_SIZES = {"n16": {"n": 16, "nbands": 4},
             "n256-d128": {"n": 256, "diameter": 128, "nbands": 16}}
WRAPPERS = (dft_matmul, sp.unpack_dft, sp.dft_pack)


def _scf_cfg(size, **kw):
    """The stacked SCF of 2 k-points on the kernel route at ``size``; by
    default mix_warmup >= max_iter: a fixed, linearly mixed trajectory of
    3 iterations."""
    return SCFConfig(**{"kpts": KPTS2, "max_iter": 3, "mix_warmup": 3,
                        "stack_k": True, "backend": "cuda",
                        **SCF_SIZES[size], **kw})


def _launches():
    return [f.launches for f in WRAPPERS]


def _launched(before):
    """Kernels #1, #3 and #4 launched since ``before`` (``_launches()``)."""
    return [f.launches - b for f, b in zip(WRAPPERS, before)]


def _trajectory(res):
    """(energies, eigenvalues, rho) of an SCF run, on the host."""
    return (np.asarray(res.energies), np.asarray(res.eigenvalues),
            res.rho.cpu().numpy())


def _agree(got, want):
    """An SCF trajectory (``_trajectory``) against another of the same
    run: as many finite energies within ENERGY_RTOL·max(1, |E|),
    eigenvalues ascending and within EIG_ATOL·max(1, |ε|), ρ finite and
    within RHO_RTOL of max ρ."""
    (e, eig, rho), (er, eigr, rhor) = got, want
    assert len(e) == len(er) and np.isfinite(e).all()
    assert np.abs(e - er).max() <= ENERGY_RTOL * max(1.0, np.abs(er).max())
    assert eig.shape == eigr.shape and np.all(np.diff(eig, axis=1) >= -1e-6)
    assert np.abs(eig - eigr).max() <= EIG_ATOL * max(1.0,
                                                      np.abs(eigr).max())
    assert rho.shape == rhor.shape and np.isfinite(rho).all()
    assert np.abs(rho - rhor).max() <= RHO_RTOL * np.abs(rhor).max()


@pytest.mark.cuda
@pytest.mark.parametrize("size", list(SCF_SIZES))
def test_scf_on_cuda_launches_every_kernel_and_matches_cpu(size,
                                                           cuda_device):
    """The stacked SCF on the kernel route launches kernels #1, #3 and
    #4.  At n = 16 it matches the same run on the CPU (the kernels' plain
    versions); at the paper's widths it matches the "matmul" route on the
    card, which launches none of them."""
    cfg = _scf_cfg(size)
    before = _launches()
    gpu = run_scf(cfg)                       # the default device is CUDA
    assert gpu.device.startswith("cuda") and gpu.stacked
    launched = _launched(before)
    assert all(k > 0 for k in launched)
    if size == "n16":
        cpu = run_scf(cfg, device="cpu")
        np.testing.assert_allclose(gpu.energies, cpu.energies, rtol=0,
                                   atol=3e-5)
        return
    assert gpu.iterations == 3 and gpu.eigenvalues.shape == (2, 16)
    ref = run_scf(dataclasses.replace(cfg, backend="matmul"))
    assert _launched(before) == launched
    assert (gpu.backend, ref.backend, ref.stacked) == ("cuda", "matmul",
                                                       True)
    _agree(_trajectory(gpu), _trajectory(ref))


# general twiddle cases: (M, K, N, rows past M NaN-poisoned), T = M
TWIDDLE_CASES = {
    "general": (1000, 24, 40, False),
    "general-odd-k5": (300, 5, 5, False),
    "general-odd-k9-to-18": (300, 9, 18, False),
    "general-m1": (1, 8, 8, False),
    "general-poisoned": (1000, 24, 40, True),
    "general-ragged-m-128-to-256": (389, 128, 256, False),
    "general-poisoned-odd-k": (500, 9, 18, True),
}
# four-step stage-1 cases: (n, lines of n), M = lines·n1 rows of n2
FOUR_STEP_CASES = {
    "four_step": (2048, 50),
    "four_step-n15": (15, 50),
    "four_step-n4096-4096-lines": (4096, 4096),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*TWIDDLE_CASES, *FOUR_STEP_CASES])
def test_cuda_twiddle_kernel_matches_plain(case, cuda_device):
    dev = cuda_device
    rng = np.random.default_rng(12)
    if case in TWIDDLE_CASES:                  # ragged, a (M, N) table
        M, K, N, poisoned = TWIDDLE_CASES[case]
        x = _rows(rng, M, K, dev, poisoned)
        _, _, w = dft_matrix_device(N, K, False, dev)
        t = _cx(rng, (M, N), dev)
    else:            # stage 1 of n = 64·32, 3·5 (K = 5) or 64·64
        n, lines = FOUR_STEP_CASES[case]
        n1, n2 = ops._factor(n)
        x = _cx(rng, (lines * n1, n2), dev)
        _, _, w = dft_matrix_device(n2, n2, True, dev)
        t = torch.as_tensor(np.ascontiguousarray(
            twiddle_matrix(n1, n2, True).T), device=dev)
    before = dft_matmul_twiddle.launches
    y = dft_matmul_twiddle(x, w, t)
    assert bool(torch.isfinite(torch.view_as_real(y)).all())
    _close(y, dft_matmul_twiddle_plain(x, w, t))
    assert dft_matmul_twiddle.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,lines", [(64, 33), (360, 33), (4096, 33),
                                     (4096, 4096)])
def test_cuda_four_step_matches_torch_fft(n, lines, inverse, cuda_device):
    rng = np.random.default_rng(n)
    x = _cx(rng, (lines, n), cuda_device)
    before = (dft_matmul_twiddle.launches, dft_matmul.launches)
    y = ops.four_step_dft(x, inverse=inverse)
    fn = torch.fft.ifft if inverse else torch.fft.fft
    _close(y, fn(x, dim=-1))
    assert (dft_matmul_twiddle.launches, dft_matmul.launches) == \
        (before[0] + 1, before[1] + 1)


def _padded_lanes(svc):
    """The padded lanes of every packed block ``svc`` makes, as its pair
    runs return them (on the device)."""
    seen = []
    run = svc._run_pair

    def watched(prepare):
        box = {}

        def prep():
            out = prepare()
            box["inv"] = out[0]
            return out
        packed = run(prep)
        pad = torch.as_tensor(~box["inv"].valid_lanes(),
                              device=packed.device)
        seen.append(packed[pad])
        return packed
    svc._run_pair = watched
    return seen


@pytest.mark.cuda
def test_cuda_transform_service_coalesces_and_matches_eager(cuda_device):
    """A started service on each route: requests coalesce, the late one
    fails, every result matches ``eager_apply`` and a round trip without
    a potential its input, and the padded lanes of every packed block are
    +0.0.  The "cuda" service's dispatches launch kernels #1, #3 and #4
    and match the "matmul" service's, which launch none."""
    from repro_torch.core import PlanCache, ProcGrid
    from repro_torch.serve import DeadlineExceeded, TransformService
    g = ProcGrid.create([1], device=cuda_device)
    rng = np.random.default_rng(13)
    veff = rng.standard_normal((16,) * 3).astype(np.float32)
    spheres = [kpoint_sphere(8, k) for k in KPTS2] + [kpoint_sphere(4)]
    work = [(f"t{i}", (rng.standard_normal((2, s.npacked))
                       + 1j * rng.standard_normal((2, s.npacked))
                       ).astype(np.complex64), s, veff if i % 2 else None)
            for i, s in enumerate(spheres + spheres)]
    served = {}
    for backend in ("cuda", "matmul"):
        svc = TransformService(g, 16, max_rows=8, backend=backend,
                               cache=PlanCache())
        padded = _padded_lanes(svc)
        before = _launches()
        svc.start()
        try:
            hs = [svc.submit(t, c, s, v_eff=v) for t, c, s, v in work]
            late = svc.submit("late", work[0][1], spheres[0], deadline=0.0)
            outs = [h.result(120) for h in hs]
            with pytest.raises(DeadlineExceeded):
                late.result(120)
        finally:
            svc.stop(timeout=120)
        served[backend] = (outs, _launched(before))
        m = svc.metrics.summary()
        assert m["dispatches"] < len(work) and m["coalesced_dispatches"] >= 1
        assert sum(p.numel() for p in padded) > 0
        assert all(_plus_zero(p) for p in padded)
        for out, (_, c, s, v) in zip(outs, work):
            want = svc.eager_apply(c, s, v)
            err = float(np.abs(out - want).max())
            assert err <= RTOL * float(np.abs(want).max()), err
            if v is None:
                assert float(np.abs(out - c).max()) <= RTOL * float(
                    np.abs(c).max())
    assert all(k > 0 for k in served["cuda"][1])
    assert served["matmul"][1] == [0, 0, 0]
    for out, want in zip(served["cuda"][0], served["matmul"][0]):
        assert float(np.abs(out - want).max()) <= RTOL * float(
            np.abs(want).max())


#: the lazy executor's cases, (mode, tolerance against eager, plan):
#: "cube-16" and "cube-256", a forward 3D FFT of 2 bands (at n = 256 the
#: whole-cube plan of the paper's Fig. 9 baseline), the eager result also
#: held to torch.fft; "scf-inverse-b32", the paper-width SCF's stacked
#: inverse plan (32 bands, d = 128 -> n = 256); "scf", that SCF under the
#: lazy fp32 policy against the eager run: the sphere kernels still unpack
#: and pack, every other stage is a lazy GEMM, so kernel #1 never launches
LAZY_CASES = [(mode, tol, plan)
              for plan in ("cube-16", "cube-256", "scf-inverse-b32")
              for mode, tol in (("lazy", RTOL), ("lazy_bf16", 3e-2))]
LAZY_CASES.append(("lazy", None, "scf"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,tol,case", LAZY_CASES)
def test_cuda_lazy_executor_matches_eager(mode, tol, case, cuda_device):
    from repro_torch.core import Domain, ProcGrid, fftb
    from repro_torch.core.policy import ExecPolicy
    from repro_torch.dft.basis import PlaneWaveBasis
    policy = ExecPolicy.from_mode(mode)
    if case == "scf":
        eager = run_scf(_scf_cfg("n256-d128"), device=cuda_device)
        before = _launches()
        lazy = run_scf(_scf_cfg("n256-d128", policy=policy),
                       device=cuda_device)
        n1, n3, n4 = _launched(before)
        assert n1 == 0 and n3 > 0 and n4 > 0
        _agree(_trajectory(lazy), _trajectory(eager))
        return
    g = ProcGrid.create([1], device=cuda_device)
    if case.startswith("cube"):
        n = int(case.split("-")[1])
        plan = fftb("b x{0} y z -> b X Y Z{0}",
                    domains=(Domain((0,), (1,)),
                             Domain((0, 0, 0), (n - 1,) * 3)),
                    grid=g, backend="cuda")
    else:
        plan = PlaneWaveBasis(256, diameter=128, kpts=KPTS2, nbands=16,
                              backend="cuda", device=cuda_device
                              ).stacked_inverse_plan()
    x = _cx(np.random.default_rng(3), tuple(plan.tin.shape), cuda_device)
    before = dft_matmul.launches
    eager = plan(x)
    if case.startswith("cube"):        # a launch of kernel #1 a stage
        assert dft_matmul.launches == before + 3
        _close(eager, torch.fft.fftn(x, dim=(1, 2, 3)))
    got = plan(x, policy=policy)
    assert got.device == x.device and got.is_contiguous()
    _close(got, eager, rtol=tol)


def _jit_cfg(size="n16", **kw):
    """The fused step's SCF at ``size``: linear mixing throughout."""
    return _scf_cfg(size, mix_warmup=99, mix_history=1, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("size", list(SCF_SIZES))
def test_cuda_jit_step_replays_graphs_and_matches_eager(size, cuda_device):
    """The fused step replays its graphs: plan calls and kernel launches
    happen in the warm-up and the capture only, and one steady iteration
    syncs the host at its named host syncs and the energy/residual read
    and nowhere else (the sync debug mode's warnings)."""
    from repro_torch.core import FftPlan

    def counts():
        return [FftPlan.executions, *_launches()]
    eager = run_scf(_jit_cfg(size, max_iter=6), device=cuda_device)
    marks = []

    def second_iteration(it, energy, resid):
        if it in (0, 1):
            torch.cuda.set_sync_debug_mode("warn" if it == 0 else 0)
            marks.append(len(caught))
    c0 = counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            jit6 = run_scf(_jit_cfg(size, max_iter=6, jit_step=True),
                           device=cuda_device, callback=second_iteration)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    d6 = [a - b for a, b in zip(counts(), c0)]
    c0 = counts()
    jit3 = run_scf(_jit_cfg(size, max_iter=3, jit_step=True),
                   device=cuda_device)
    # the same count for 3 and 6 iterations: the replays launch the
    # captured kernels again without a plan call or a wrapper
    assert [a - b for a, b in zip(counts(), c0)] == d6
    assert all(k > 0 for k in d6)
    assert jit6.jitted and jit3.jitted and jit6.iterations == 6
    st = jit6.graphs
    steps = SCFConfig().inner_steps
    assert st["host_syncs"] == ["linalg.eigh"] * steps
    assert st["graphs"] == steps + 1 and st["replays"] == 5
    syncs = [str(w.message) for w in caught[marks[0]:marks[1]]
             if "synchroniz" in str(w.message)
             and "prototype" not in str(w.message)]
    assert len(syncs) == steps + 1, syncs
    assert jit6.transforms == eager.transforms
    if size != "n16":
        _agree(_trajectory(jit6), _trajectory(eager))
        return
    assert abs(jit6.energy - eager.energy) < 1e-4
    assert np.abs(jit6.eigenvalues - eager.eigenvalues).max() < 1e-4
    assert float((jit6.rho - eager.rho).abs().max()) \
        < 1e-4 * float(eager.rho.max())


@pytest.mark.cuda
def test_cuda_jit_step_capture_failure_raises(cuda_device, monkeypatch):
    from repro_torch.dft import scf
    real = scf.total_energy_stacked

    def reads_host(*args, **kwargs):
        e = real(*args, **kwargs)
        float(e)                     # a host sync inside the step
        return e
    monkeypatch.setattr(scf, "total_energy_stacked", reads_host)
    with pytest.raises(RuntimeError, match="capturing the fused SCF step"):
        run_scf(_jit_cfg(max_iter=2, jit_step=True), device=cuda_device)
    monkeypatch.undo()
    # the card is usable afterwards, and the step captures again
    assert run_scf(_jit_cfg(max_iter=2, jit_step=True),
                   device=cuda_device).jitted


@pytest.mark.cuda
def test_cuda_jit_step_anderson_converges(cuda_device):
    res = run_scf(SCFConfig(n=16, nbands=4, kpts=KPTS2, max_iter=50,
                            stack_k=True, backend="cuda", jit_step=True),
                  device=cuda_device)
    assert res.converged, (res.energies, res.residuals)
    assert res.jitted and res.graphs["replays"] == res.iterations - 1
    assert abs(res.energy - (-1.9197)) < 5e-3, res.energy
    for eps in res.eigenvalues:
        assert np.all(np.diff(eps) >= -1e-6)


@pytest.mark.cuda
def test_cuda_moe_is_deterministic(cuda_device):
    """The MoE's output and gradients come out bit for bit the same on
    every run on the card: its combine gathers each token's slots and
    its dispatch's backward gathers them too, where a scatter-add's
    atomic adds sum in any order.  Model ranks that hold the experts
    whole (a "model" axis that does not divide them) compute the same
    loss and gradients only so."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                              n_experts=8, top_k=4, dtype="bfloat16")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = moe.MoE(cfg, torch.bfloat16, gen=gen, device=cuda_device)
    x0 = torch.randn((4, 256, cfg.d_model), generator=gen,
                     device=cuda_device).to(torch.bfloat16)
    runs = []
    for _ in range(3):
        p.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_(True)
        out = moe.moe_apply(p, x, cfg)
        out.float().square().sum().backward()
        runs.append([out.detach(), x.grad] +
                    [t.grad for t in (p.router, p.w_up, p.w_gate,
                                      p.w_down)])
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


# kernel #1's strided entry: (planes, K, L, N).  L below 64 (a box holds
# 64 / L planes), L = 64·k, and the paper pair's own stage layouts at
# reduced plane counts and at the paper-width SCF's: idft[x] (L =
# 32,768), idft[y] (L = 65,536) and dft[X] (L = 128)
COLS_CASES = {
    "l8-k128": (40, 128, 8, 256),
    "l32-k256": (12, 256, 32, 128),
    "l64-k128": (6, 128, 64, 256),
    "l192-k256": (3, 256, 192, 128),
    "l32768-k128-idft-x": (2, 128, 32768, 256),
    "l65536-k128-idft-y": (1, 128, 65536, 256),
    "l128-k256-dft-x": (64, 256, 128, 128),
    "l64-odd-k9": (5, 9, 64, 18),
    # the paper-width SCF's strided stages on all of their planes
    "scf-idft-x-32-planes": (32, 128, 32768, 256),
    "scf-idft-y-32-planes": (32, 128, 65536, 256),
    "scf-dft-x-8192-planes": (8192, 256, 128, 128),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(COLS_CASES))
def test_cuda_strided_entry_is_bitwise_the_rows_entry(case, cuda_device):
    """``dft_matmul_cols`` on the (planes, K, L) view against
    ``dft_matmul`` on the same lines copied into rows: the split operands
    reach each wgmma in the same order, chunk by chunk, so the results are
    equal bit for bit."""
    from repro_torch.kernels.dft_matmul import dft_matmul_cols
    P, K, L, N = COLS_CASES[case]
    rng = np.random.default_rng(P * K + L)
    x = _cx(rng, (P, K, L), cuda_device)
    _, _, w = dft_matrix_device(N, K, N > K, cuda_device)
    before = dft_matmul.launches
    got = dft_matmul_cols(x, w)
    assert dft_matmul.launches == before + 1
    want = dft_matmul(x.transpose(1, 2).reshape(P * L, K).contiguous(), w)
    torch.cuda.synchronize()
    assert got.shape == (P * L, N)
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))
    _close(got, dft_matmul_plain(x.transpose(1, 2).reshape(P * L, K), w))


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,kpts,nb", [(8, 16, KPTS2, 3),
                                         (128, 256, KPTS2, 1),
                                         (128, 256, KPTS2, 16)])
def test_cuda_dft_pack_z_major_slab_is_bitwise_the_other_layouts(
        d, n, kpts, nb, cuda_device):
    """One slab's values stored three ways: lines contiguous (layout 0),
    each y plane z-major (1) and each row's slab z-major (2, what the
    forward's x stage leaves): the packed lanes are equal bit for bit,
    and the padded ones +0.0."""
    spheres = [kpoint_sphere(d, k) for k in kpts]
    npm = max(s.npacked for s in spheres)
    start, zlo, cnt, _ = (torch.as_tensor(t, device=cuda_device)
                          for t in sp.line_tables(spheres, nb))
    B = len(spheres) * nb
    nvalid = torch.as_tensor(np.repeat(np.asarray(
        [s.npacked for s in spheres], np.int32), nb), device=cuda_device)
    _, _, w = dft_matrix_device(d, n, False, cuda_device)
    slab = _cx(np.random.default_rng(d), (B, d, d, n), cuda_device)
    outs = []
    for layout, order in ((0, (0, 1, 2, 3)), (1, (0, 2, 3, 1)),
                          (2, (0, 3, 2, 1))):
        held = slab.permute(*order).contiguous().permute(
            *np.argsort(order).tolist())
        assert sp.slab_layout(held) == layout
        before = sp.dft_pack.launches
        outs.append(sp.dft_pack(held, start, zlo, cnt, nvalid, w, npm))
        assert sp.dft_pack.launches == before + 1
    torch.cuda.synchronize()
    for other in outs[1:]:
        assert torch.equal(torch.view_as_real(outs[0]),
                           torch.view_as_real(other))
    _close(outs[2], sp.dft_pack_plain(slab, start, zlo, cnt, nvalid, w, npm))
    pad = torch.arange(npm, device=cuda_device)[None] >= nvalid[:, None]
    assert pad.any() and _plus_zero(outs[0][pad])


#: a line stage's span against the device time between its own CUDA
#: events: the span's exit synchronizes the card
SPAN_COVERAGE = 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(16, 8), (32, 16), (256, 128)])
def test_cuda_traced_pair_reads_every_line_in_place(n, d, cuda_device):
    """A pair on the card: no ``relayout`` span, one line stage a call
    pair reading rows and three reading strided lines, one launch of
    kernel #1 a line stage, of #3 for the unpack and of #4 for the pack,
    each line stage's span at least SPAN_COVERAGE of its device time (at
    the paper's widths a stage takes far longer on the card than its
    launch on the host), and the cube and packed lanes bitwise those of
    the same stages run with their inputs copied into rows first."""
    from repro_torch.core import ProcGrid, make_planewave_pair
    from repro_torch.core import local_fft
    from repro_torch.obs.metrics import global_metrics
    from repro_torch.obs.trace import get_tracer
    inv, fwd = make_planewave_pair(ProcGrid.create([1], device=cuda_device),
                                   n, kpoint_sphere(d), 4, backend="cuda")
    c = _cx(np.random.default_rng(n), (4, inv.sphere.npacked), cuda_device)
    tr = get_tracer()
    before = dict(global_metrics().snapshot()["fftb"])
    launches = _launches()
    tr.enable(sync=True)
    try:
        cube = inv.unpack_transform(c)
        out = fwd.transform_pack(cube)
        torch.cuda.synchronize()
        events = tr.events()
        device = tr.device_summary()
    finally:
        tr.disable()
        tr.clear()
    names = {e["name"] for e in events}
    assert _launched(launches) == [4, 1, 1]
    stages = [e for e in events if e["name"].startswith(("idft[", "dft["))]
    assert len(stages) == 4
    for e in stages:
        assert device[e["name"]]["count"] == 1
        span_ms = (e["t1"] - e["t0"]) * 1e3
        assert span_ms >= SPAN_COVERAGE * device[e["name"]]["device_ms"], (
            e["name"], span_ms, device[e["name"]])
    after = global_metrics().snapshot()["fftb"]
    assert "relayout" not in names and "fused:dft_pack" in names
    assert {k: after[k] - before[k] for k in
            ("line_reads_rows", "line_reads_strided",
             "line_reads_copied")} == {"line_reads_rows": 1,
                                       "line_reads_strided": 3,
                                       "line_reads_copied": 0}
    # the cube's memory order: (b, z, X, Y)
    assert cube.permute(0, 3, 1, 2).is_contiguous()
    _close(out, c)

    # the same stages with every input copied into rows (the strided
    # entry never taken): the same bits
    def copied(x, axis, n_in, n_out, inverse):
        rd = local_fft.line_read(x, axis, strided=False)
        xf = x.permute(*rd.order, axis).reshape(-1, n_in)
        yf = ops.dft_apply(xf, n_out=n_out, inverse=inverse)
        perm = rd.order + (axis,)
        y = yf.view(*(x.shape[k] for k in rd.order), n_out)
        return y.permute(*(perm.index(k) for k in range(x.ndim)))
    real = local_fft._cuda_backend
    local_fft._cuda_backend = copied
    try:
        cube0 = inv.unpack_transform(c)
        out0 = fwd.transform_pack(cube0)
    finally:
        local_fft._cuda_backend = real
    torch.cuda.synchronize()
    assert torch.equal(torch.view_as_real(cube), torch.view_as_real(cube0))
    assert torch.equal(torch.view_as_real(out), torch.view_as_real(out0))


# kernel #1's factored mode at the paper pair's four stage shapes and
# gw-mtxel's two 256→64 shapes, on fewer lines: (planes, n_in, L, n_out,
# inverse), L = 1 for rows (then "planes" is the rows, never whole tiles)
FACTORED_CASES = {
    "idft-x-128-to-256-l32768": (2, 128, 32768, 256, True),
    "idft-y-128-to-256-l65536": (1, 128, 65536, 256, True),
    "dft-y-256-to-128-rows": (40001, 256, 1, 128, False),
    "dft-x-256-to-128-l128": (300, 256, 128, 128, False),
    "mtxel-dft-y-256-to-64-rows": (40001, 256, 1, 64, False),
    "mtxel-dft-x-256-to-64-l64": (500, 256, 64, 64, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FACTORED_CASES))
def test_cuda_factored_kernel_matches_plain(case, cuda_device):
    """``ops.dft_apply`` at a factored shape: one launch of the factored
    kernel (counted in ``dft_matmul.launches``), within 2e-6 of its plain
    version (3xTF32 against complex64 products in another order), the
    strided entry bit for bit the rows entry on the same lines, and zero
    lines +0.0."""
    from repro_torch.kernels.dft_matmul import (dft_factored,
                                                dft_factored_plain,
                                                factored_split)
    P, n_in, L, n_out, inverse = FACTORED_CASES[case]
    assert factored_split(n_in, n_out) is not None
    rng = np.random.default_rng(P + n_in + L + n_out)
    x = _cx(rng, (P, n_in, L) if L > 1 else (P, n_in), cuda_device)
    x[0] = 0
    lines = (x.transpose(1, 2).reshape(-1, n_in).contiguous() if L > 1
             else x)
    fo = ops.factored_operands_device(n_out, n_in, inverse, cuda_device)
    before = dft_matmul.launches
    y = ops.dft_apply(x, n_out, inverse=inverse)
    assert dft_matmul.launches == before + 1
    torch.cuda.synchronize()
    assert y.shape == (lines.shape[0], n_out)
    assert bool(torch.isfinite(torch.view_as_real(y)).all())
    assert torch.equal(torch.view_as_real(y),
                       torch.view_as_real(dft_factored(lines, fo)))
    assert _plus_zero(y[:L])
    _close(y, dft_factored_plain(lines, fo), 2e-6)


@pytest.mark.cuda
def test_cuda_factored_kernel_is_kernel1_to_the_benchmark(cuda_device):
    """One factored line stage is one launch whose name the benchmark's
    trace reader classes as kernel #1 (``portbench.roofline.kernel_of``),
    so ``dft_matmul_roofline`` counts it."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench.roofline import kernel_of
    x = _cx(np.random.default_rng(1), (4, 128, 64), cuda_device)
    ops.dft_apply(x, 256, inverse=True)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ops.dft_apply(x, 256, inverse=True)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "cgemm_tc" in e.name]
    assert len(names) == 1 and "factored" in names[0], names
    assert kernel_of(names[0]) == "dft_matmul"


@pytest.mark.cuda
def test_cuda_factored_sphere_kernels_are_sphere_pack_to_the_benchmark(
        cuda_device):
    """A call pair of the paper's shapes (n = 256, d = 128) launches #3
    and #4 once each in the factored mode, under names the benchmark's
    trace reader classes as the sphere kernels
    (``portbench.roofline.kernel_of``), so ``sphere_pack_roofline`` counts
    them and ``dft_matmul_roofline`` does not."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench.roofline import kernel_of
    from repro_torch.core import ProcGrid, make_planewave_pair
    inv, fwd = make_planewave_pair(ProcGrid.create([1], device=cuda_device),
                                   256, kpoint_sphere(128), 1,
                                   backend="cuda")
    assert inv._fused_in_parts()["factored"] is not None
    assert fwd._fused_out_parts()["factored"] is not None
    c = _cx(np.random.default_rng(5), (1, inv.sphere.npacked), cuda_device)
    fwd.transform_pack(inv.unpack_transform(c))
    torch.cuda.synchronize()
    modes = _modes()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fwd.transform_pack(inv.unpack_transform(c))
        torch.cuda.synchronize()
    assert _moved(modes, "unpack") == {"factored": 1, "dense": 0}
    assert _moved(modes, "pack") == {"factored": 1, "dense": 0}
    kinds = [kernel_of(e.name) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel_of(e.name) is not None]
    assert sorted(kinds) == ["dft_matmul"] * 4 + ["sphere_pack"] * 2 + [
        "sphere_pack_tail"], kinds
    _close(out, c)


#: launches of each factored sphere kernel held bit for bit against the
#: first: the producer's table of line runs shares shared memory with the
#: stage ring and the barriers, so a run written astray shows as a fault or
#: a changed bit within a few hundred launches
REPEATS = 300


@pytest.mark.cuda
@pytest.mark.parametrize("which,d", [("unpack", 128), ("pack", 128),
                                     ("pack", 64)])
def test_cuda_factored_sphere_kernels_repeat_bitwise(which, d, cuda_device):
    """#3 and #4 in the factored mode at the cells' widths on 8 bands of a
    ragged batch, launched REPEATS times: every output bit for bit the
    first."""
    dev, n, nb = cuda_device, 256, 4
    spheres = [kpoint_sphere(d, k) for k in KPTS2]
    npm = max(s.npacked for s in spheres)
    start, zlo, cnt, flag = (torch.as_tensor(t, device=dev)
                             for t in sp.line_tables(spheres, nb))
    rng = np.random.default_rng(d)
    if which == "unpack":
        x = _cx(rng, (len(spheres) * nb, npm), dev)
        _, _, w = dft_matrix_device(n, d, True, dev)
        fo = sp.factored_for(d, n, True, start.shape[1], dev)
        fn = lambda: sp.unpack_dft(x, start, zlo, cnt, flag, w, factored=fo)
    else:
        x = _slab(rng, len(spheres) * nb, d, n, "z-major", dev)
        nvalid = torch.as_tensor(np.repeat(np.asarray(
            [s.npacked for s in spheres], np.int32), nb), device=dev)
        _, _, w = dft_matrix_device(d, n, False, dev)
        fo = sp.factored_for(n, d, False, start.shape[1], dev)
        fn = lambda: sp.dft_pack(x, start, zlo, cnt, nvalid, w, npm,
                                 factored=fo)
    first = torch.view_as_real(fn()).clone()
    for _ in range(REPEATS):
        assert torch.equal(torch.view_as_real(fn()), first)


@pytest.mark.cuda
def test_cuda_factored_unpack_takes_lanes_off_16_bytes(cuda_device):
    """Packed lanes the kernel's bulk copy cannot read in place (a base 8
    bytes off a 16-byte boundary and an odd count of lanes: 3 rows of
    npacked + 1) are copied first and give the plain version's result."""
    d, n, nb, dev = 64, 256, 3, cuda_device
    sphere = kpoint_sphere(d)
    npk = sphere.npacked + 1
    start, zlo, cnt, flag = (torch.as_tensor(t, device=dev)
                             for t in sp.line_tables([sphere], nb))
    buf = _cx(np.random.default_rng(6), (nb * npk + 1,), dev)
    x = buf[1:].view(nb, npk)
    assert x.data_ptr() % 16 == 8 and x.numel() % 2 == 1
    _, _, w = dft_matrix_device(n, d, True, dev)
    fo = sp.factored_for(d, n, True, start.shape[1], dev)
    y = sp.unpack_dft(x, start, zlo, cnt, flag, w, factored=fo)
    _close(y, sp.unpack_dft_plain(x, start, zlo, cnt, flag, w, fo),
           FACTORED_RTOL)


@pytest.mark.cuda
def test_cuda_factored_rows_off_16_bytes_are_copied_first(cuda_device):
    """Rows that start 8 bytes off a 16-byte boundary (a view one complex
    in), which TMA cannot address, give the same bits as the same rows on
    an aligned base."""
    from repro_torch.kernels.dft_matmul import dft_factored, factored_split
    assert factored_split(256, 128) is not None
    buf = _cx(np.random.default_rng(2), (1000 * 256 + 1,), cuda_device)
    x = buf[1:].view(1000, 256)
    assert x.data_ptr() % 16 == 8
    fo = ops.factored_operands_device(128, 256, False, cuda_device)
    y = dft_factored(x, fo)
    torch.cuda.synchronize()
    assert torch.equal(torch.view_as_real(y),
                       torch.view_as_real(dft_factored(x.clone(), fo)))


#: the spectral layers at their callers' widths: fourier_mixer on (B, S, D)
#: float32 (kernel #1 on lines of 1024 and 2048), fft_conv at Mamba-2
#: 370M's conv width (d_inner 2048 + 2 * ssm_state 128 channels, kernel
#: width 4: src/repro/configs/mamba2_370m.py), S = 1024 padded to L = 2048:
#: (shape, kernel width, launches of kernel #1)
SPECTRAL_CASES = {"fourier_mixer": ((8, 2048, 1024), None, 2),
                  "fft_conv": ((8, 1024, 2304), 4, 3)}


@pytest.mark.cuda
@pytest.mark.parametrize("layer", list(SPECTRAL_CASES))
def test_cuda_spectral_layers_match_the_other_routes(layer, cuda_device):
    """A spectral layer on the "cuda" route: one launch of kernel #1 a
    line DFT, within 1e-5 of the largest value of the "matmul" route's
    output and of torch.fft's (the "fft" route)."""
    from repro_torch.core import fft_conv, fourier_mixer
    shape, width, launches = SPECTRAL_CASES[layer]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda_device)
    k = (None if width is None else
         torch.randn((width, shape[-1]), generator=gen, device=cuda_device))

    def layer_on(backend):
        return (fourier_mixer(x, backend=backend) if k is None else
                fft_conv(x, k, backend=backend))
    before = dft_matmul.launches
    y = layer_on("cuda")
    assert dft_matmul.launches == before + launches
    for backend in ("matmul", "fft"):
        _close(y, layer_on(backend))


# ------------------------------------------- four processes on the card
#: four processes sharing the card on the 2×2 (batch × fft) grid over gloo
#: (which carries each collective through host memory), at the
#: reference's SCF size: n = 16, d = 8, 2 k-points of 4 bands, where every
#: rank launches kernels #1, #3 and #4 in each path; the SCF a fixed
#: linearly mixed trajectory of MR_ITERS iterations
MR_ITERS, MR_TIMEOUT = 3, 600.0


def _mr_cfg(**kw):
    return _scf_cfg("n16", max_iter=MR_ITERS, mix_warmup=MR_ITERS,
                    mix_history=1, **kw)


def _mr_work(data):
    """The service's requests: (tenant, coefficients, sphere, potential)."""
    spheres = [kpoint_sphere(8, k) for k in KPTS2]
    return [("t0", data["c0"], spheres[0], data["v"]),
            ("t1", data["c1"], spheres[1], None),
            ("t2", data["c0"][:2], spheres[0], None)]


def _cuda_2x2_rank(rank, path):
    """One rank of the 2×2 grid on the card: the stacked H apply, the SCF
    eager and as the fused step (its CUDA graphs captured around the
    gloo collectives' host syncs), then the service (front end rank 0,
    the others following), each with the rank's launches of kernels #1,
    #3 and #4."""
    from repro_torch.core import ProcGrid
    from repro_torch.dft import PlaneWaveBasis
    from repro_torch.dft.hamiltonian import apply_hamiltonian_padded
    from repro_torch.serve import TransformService
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    data = np.load(path)
    grid = ProcGrid.create([2, 2], ["dft_b", "dft_f"], device=dev)
    basis = PlaneWaveBasis(16, kpts=KPTS2, nbands=4, grid=grid,
                           backend="cuda")
    inv, _ = basis.stacked_hamiltonian_plans()
    coeffs = [torch.as_tensor(data[f"c{ik}"], device=dev)
              for ik in range(2)]
    c_pad = inv.stack(coeffs).reshape(2, 4, inv.npacked_max)
    v = basis.field.scatter(torch.as_tensor(data["v"], device=dev))
    d0, before = dict(sp.DISPATCHES), _launches()
    hc = apply_hamiltonian_padded(basis, c_pad, v)
    out = {"h": hc.cpu().numpy(), "h_launches": _launched(before),
           "h_dispatches": {k: sp.DISPATCHES[k] - d0[k] for k in d0}}
    for name, kw in (("eager", {}), ("fused", {"jit_step": True})):
        before = _launches()
        res = run_scf(_mr_cfg(**kw), grid=grid, coeffs=coeffs)
        out[name] = {"launches": _launched(before),
                     "trajectory": _trajectory(res),
                     "grid_shape": res.grid_shape, "stacked": res.stacked,
                     "jitted": res.jitted, "graphs": res.graphs}
    svc = TransformService(grid, 16, warm_async=False, backend="cuda",
                           batch_axes=(0,))
    work = _mr_work(data)
    before = _launches()
    handles = ([svc.submit(t, c, s, v_eff=ve) for t, c, s, ve in work]
               if svc.is_front else [])
    svc.run_until_idle()
    out["service"] = {"launches": _launched(before),
                      "results": [h.result(60) for h in handles],
                      "eager": [svc.eager_apply(c, s, ve)
                                for _, c, s, ve in work]}
    svc.stop()
    return out


@pytest.mark.cuda
def test_cuda_2x2_ranks_launch_every_kernel_and_replay_graphs(cuda_device,
                                                              tmp_path):
    """Four processes on the card, the 2×2 grid over gloo.  Every rank
    launches kernels #1, #3 and #4 in its H apply, its eager SCF, its
    fused step and its service dispatches.  The H apply takes the fused
    route and matches one rank's within 1e-5 of its largest value, padded
    lanes +0.0; the eager SCF and the fused step (graphs replayed on every
    rank) give every rank the same energies and match one rank's runs and
    each other; the front end's results match ``eager_apply``."""
    from repro_torch.dft import PlaneWaveBasis
    from repro_torch.dft.hamiltonian import apply_hamiltonian_padded
    from repro_torch.sharding.procs import run_ranks
    rng = np.random.default_rng(7)
    data = {}
    for ik, kpt in enumerate(KPTS2):
        npk = kpoint_sphere(8, kpt).npacked
        c = (rng.standard_normal((npk, 4))
             + 1j * rng.standard_normal((npk, 4)))
        data[f"c{ik}"] = np.linalg.qr(c)[0].T.astype(np.complex64)
    data["v"] = rng.standard_normal((16,) * 3).astype(np.float32)
    path = str(tmp_path / "inputs.npz")
    np.savez(path, **data)
    ranks = run_ranks(_cuda_2x2_rank, 4, args=(path,),
                      rendezvous_dir=str(tmp_path), timeout=MR_TIMEOUT,
                      threads=2)
    # one rank's runs from the same inputs
    basis = PlaneWaveBasis(16, kpts=KPTS2, nbands=4, device=cuda_device,
                           backend="cuda")
    inv, _ = basis.stacked_hamiltonian_plans()
    coeffs = [torch.as_tensor(data[f"c{ik}"], device=cuda_device)
              for ik in range(2)]
    c_pad = inv.stack(coeffs).reshape(2, 4, inv.npacked_max)
    hc = apply_hamiltonian_padded(basis, c_pad, torch.as_tensor(
        data["v"], device=cuda_device)).cpu().numpy()
    one = {name: _trajectory(run_scf(_mr_cfg(**kw), device=cuda_device,
                                     coeffs=coeffs))
           for name, kw in (("eager", {}), ("fused", {"jit_step": True}))}
    pad = np.broadcast_to(~inv.valid_lanes()[:, None, :], hc.shape)
    e0 = {name: ranks[0][name]["trajectory"][0]
          for name in ("eager", "fused")}
    for out in ranks:
        for launched in (out["h_launches"], out["eager"]["launches"],
                         out["fused"]["launches"],
                         out["service"]["launches"]):
            assert all(k > 0 for k in launched), launched
        assert out["h_dispatches"] == {"unpack_dft": 1, "dft_pack": 1}
        assert np.abs(out["h"] - hc).max() <= RTOL * np.abs(hc).max()
        assert pad.any() and _plus_zero(torch.as_tensor(out["h"][pad]))
        for name in ("eager", "fused"):
            run = out[name]
            assert tuple(run["grid_shape"]) == (2, 2) and run["stacked"]
            assert np.array_equal(run["trajectory"][0], e0[name])
        graphs = out["fused"]["graphs"]
        assert out["fused"]["jitted"]
        assert graphs["replays"] == MR_ITERS - 1
    eager, fused = ranks[0]["eager"]["trajectory"], ranks[0]["fused"][
        "trajectory"]
    _agree(eager, one["eager"])
    _agree(fused, one["fused"])
    _agree(fused, eager)
    front = ranks[0]["service"]
    assert len(front["results"]) == len(_mr_work(data))
    for got, want in zip(front["results"], front["eager"]):
        assert float(np.abs(got - want).max()) <= RTOL * float(
            np.abs(want).max())


# the Γ-point fold and unfold (kernels/gamma.py) against their plain
# versions: (n, d, real bands); d = 128 is the gamma-pair cell's sphere
GAMMA_CASES = {"d8-3-bands": (16, 8, 3), "d9-4-bands": (18, 9, 4),
               "d128-6-bands": (256, 128, 6), "d128-9-bands": (256, 128, 9)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GAMMA_CASES))
def test_cuda_gamma_fold_and_unfold_match_plain(case, cuda_device):
    """Both kernels bit for bit their plain versions (adds, negations and
    halvings only), on spheres of even and odd diameter and odd band
    counts (the last band paired with zeros); one launch each."""
    from repro_torch.core import gamma_sphere, half_lanes
    from repro_torch.kernels import gamma as gk
    from repro_torch.kernels.ref import gamma_fold_plain, gamma_unfold_plain
    _, d, nb = GAMMA_CASES[case]
    sphere = gamma_sphere(d)
    lane, mirror = (torch.as_tensor(t, device=cuda_device)
                    for t in half_lanes(sphere))
    rng = np.random.default_rng(d + nb)
    half = _cx(rng, (nb, lane.numel()), cuda_device)
    full = _cx(rng, (-(-nb // 2), sphere.npacked), cuda_device)
    launched = gk.fold.launches, gk.unfold.launches
    got_full = gk.fold(half, lane, mirror, sphere.npacked)
    got_half = gk.unfold(full, lane, mirror, nb)
    torch.cuda.synchronize()
    assert (gk.fold.launches - launched[0],
            gk.unfold.launches - launched[1]) == (1, 1)
    assert torch.equal(got_full, gamma_fold_plain(half, lane, mirror,
                                                  sphere.npacked))
    assert torch.equal(got_half, gamma_unfold_plain(full, lane, mirror, nb))


@pytest.mark.cuda
def test_cuda_gamma_pair_at_full_size_matches_the_reference(cuda_device):
    """The Γ-point pair at the paper's grid (n = 256, d = 128), 64 real
    bands in one call of 32 complex rows: the fused #3 and #4 and four
    launches of #1 on the Γ sphere, one fold and one unfold, no
    ``relayout`` copy; the cube times (−i)^{x+y+z} against real ψ from the
    plain float64 reference (``portbench/reference_gamma.py``) in blocks,
    and the round trip against the coefficients, both within RTOL."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench.reference import GapMeter
    from portbench.reference_gamma import GammaTransforms, unphase
    from repro_torch.core import ProcGrid, gamma_plans
    from repro_torch.kernels import gamma as gk
    from repro_torch.obs.trace import get_tracer
    n, d, nb = 256, 128, 64
    inv, fwd = gamma_plans(ProcGrid.create([1], device=cuda_device), n, d,
                           nb, backend="cuda")
    c = _cx(np.random.default_rng(38), (nb, inv.nhalf), cuda_device)
    c[:, 0] = c[:, 0].real.to(c.dtype)             # G = 0 is the first lane
    launches = _launches()
    folds = gk.fold.launches, gk.unfold.launches
    tr = get_tracer()
    tr.enable(sync=True)
    try:
        cube = inv.unpack_transform(c)
        out = fwd.transform_pack(cube)
        torch.cuda.synchronize()
        names = [e["name"] for e in tr.events()]
        device = tr.device_summary()
    finally:
        tr.disable()
        tr.clear()
    assert _launched(launches) == [4, 1, 1]
    assert (gk.fold.launches - folds[0],
            gk.unfold.launches - folds[1]) == (1, 1)
    assert "relayout" not in names and names.count("gamma") == 2
    for name in ("gamma:fold", "gamma:unfold"):
        assert device[name]["count"] == 1 and device[name]["device_ms"] > 0
    ref = GammaTransforms(n, d, cuda_device, "float64")
    meter = GapMeter()
    for r0 in range(0, nb // 2, 4):
        psi = ref.inverse(c[2 * r0:2 * r0 + 8])
        got = unphase(cube[r0:r0 + 4], ref.sphere.s)
        meter.add(got.real, psi[0::2])
        meter.add(got.imag, psi[1::2])
        del psi, got
    assert meter.value <= RTOL, meter.value
    _close(out, c)
