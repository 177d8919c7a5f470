"""repro_torch on the card: each hand-written CUDA kernel against its plain
PyTorch version (the sphere kernels also on one rank's block of a
batch×fft grid), the four-step DFT against ``torch.fft``, the SCF slice
on the kernel route, a small transform-service run, the lazy executor
against the eager one, the fused SCF step replayed as CUDA graphs, and
kernel #1's factored mode against its plain version.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  They import neither JAX nor the reference package, so they run
on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: the line-DFT kernels compute fp32-accurate split-TF32
products on the tensor cores, the plain versions fp32 GEMMs; they sum in
different orders and agree to 1e-5 relative to the largest magnitude.  Exact
zeros (padded lanes) are compared bitwise.
"""
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

# sphere-kernel cases: (kernel, d, n, k-points, bands, slab layout).  d = 8
# has ey = 8 lines a plane, so a 128-row tile straddles 16 planes; d = 6
# has M = B·36 rows, never whole tiles, ey = 6, and 2d = 12 columns, less
# than one K chunk of 32; d = 40 has 2.5 K chunks, edge tiles that skip
# chunks, and ey = 40, which the strided read does not fit (the slab is
# copied); d = 128 has ey = 128, one plane a tile, as in the SCF.  Odd n
# gives dft_pack a row pitch TMA cannot address (the gather path).  Slab
# layouts: "rows" contiguous lines; "y-planes" each y plane z-major, as
# an x stage leaves it (the stacked SCF's forward plan), read in place;
# "x-planes" each x plane z-major, which the wrapper copies first
SPHERE_CASES = {
    "unpack_dft": ("unpack", 8, 16, KPTS2, 3, None),
    "dft_pack": ("pack", 8, 16, KPTS2, 3, "rows"),
    "unpack_dft-ragged-m-d6": ("unpack", 6, 12, KPTS2, 3, None),
    "unpack_dft-d40-chunk-skip": ("unpack", 40, 80, KPTS3, 2, None),
    "unpack_dft-d128-plane-tiles": ("unpack", 128, 256, KPTS2, 1, None),
    "dft_pack-ragged-m-d6": ("pack", 6, 12, KPTS2, 3, "rows"),
    "dft_pack-odd-n": ("pack", 6, 9, KPTS3, 2, "rows"),
    "dft_pack-x-planes-copied": ("pack", 8, 16, KPTS2, 3, "x-planes"),
    "dft_pack-y-planes": ("pack", 8, 16, KPTS2, 3, "y-planes"),
    "dft_pack-y-planes-odd-n": ("pack", 8, 15, KPTS3, 2, "y-planes"),
    "dft_pack-y-planes-d128": ("pack", 128, 256, KPTS2, 1, "y-planes"),
    "dft_pack-x-planes-d128-copied": ("pack", 128, 256, KPTS2, 1,
                                      "x-planes"),
    "dft_pack-y-planes-d40-copied": ("pack", 40, 80, KPTS3, 2, "y-planes"),
}


def _slab(rng, B, d, n, layout, dev):
    """A (B, d, d, n) slab stored as ``layout`` says."""
    if layout == "rows":
        return _cx(rng, (B, d, d, n), dev)
    if layout == "x-planes":
        return _cx(rng, (B, d, n, d), dev).transpose(2, 3)
    return _cx(rng, (B, d, n, d), dev).permute(0, 3, 1, 2)


def _plus_zero(t):
    f = torch.view_as_real(t)
    return bool(((f == 0) & ~torch.signbit(f)).all())


def _check_unpack(rng, dev, d, n, kpts, nb):
    spheres = [kpoint_sphere(d, k) for k in kpts]
    npm = max(s.npacked for s in spheres)
    start, zlo, cnt, flag = (torch.as_tensor(t, device=dev)
                             for t in sp.line_tables(spheres, nb))
    packed = _cx(rng, (len(spheres) * nb, npm), dev)
    for k, s in enumerate(spheres):              # never read
        packed[k * nb:(k + 1) * nb, s.npacked:] = float("nan")
    _, _, w = dft_matrix_device(n, d, True, dev)
    # a plane with support switched off, beside the table's own flags
    flag0 = flag.clone()
    flag0[d // 2] = 0
    for fl in (flag, flag0):
        got = sp.unpack_dft(packed, start, zlo, cnt, fl, w)
        assert bool(torch.isfinite(torch.view_as_real(got)).all())
        _close(got, sp.unpack_dft_plain(packed, start, zlo, cnt, fl, w))
        empty = (cnt == 0).reshape(got.shape[:3])
        assert _plus_zero(got[empty])
    assert int(cnt.reshape(got.shape[:3])[:, d // 2].sum()) > 0
    assert _plus_zero(got[:, d // 2])
    return 2


def _check_pack(rng, dev, d, n, kpts, nb, layout):
    spheres = [kpoint_sphere(d, k) for k in kpts]
    npm = max(s.npacked for s in spheres)
    start, zlo, cnt, _ = (torch.as_tensor(t, device=dev)
                          for t in sp.line_tables(spheres, nb))
    B = len(spheres) * nb
    slab = _slab(rng, B, d, n, layout, dev)
    fits = d % 2 == 0 and (d % 64 == 0 or 64 % d == 0)
    assert sp.slab_layout(slab) == {"rows": 0, "x-planes": None,
                                    "y-planes": 1 if fits else None}[layout]
    nvalid = torch.as_tensor(np.repeat(np.asarray(
        [s.npacked for s in spheres], np.int32), nb), device=dev)
    _, _, w = dft_matrix_device(d, n, False, dev)
    got = sp.dft_pack(slab, start, zlo, cnt, nvalid, w, npm)
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    _close(got, sp.dft_pack_plain(slab, start, zlo, cnt, nvalid, w, npm))
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
    which, d, n, kpts, nb, layout = SPHERE_CASES[kernel]
    fn = sp.unpack_dft if which == "unpack" else sp.dft_pack
    before = fn.launches
    calls = (_check_unpack(rng, dev, d, n, kpts, nb) if which == "unpack"
             else _check_pack(rng, dev, d, n, kpts, nb, layout))
    # one launch per wrapper call on a CUDA tensor
    assert fn.launches == before + calls


@pytest.mark.cuda
@pytest.mark.parametrize("B,n_in,n_out,inverse", [
    (4096, 128, 256, True), (4096, 256, 128, False), (2048, 256, 256, True),
    (2048, 256, 256, False), (1000, 24, 40, True), (300, 9, 18, False)])
def test_cuda_dft_apply_matches_fft_oracle(B, n_in, n_out, inverse,
                                           cuda_device):
    """Kernel #1 through ``ops.dft_apply`` against ``dft_apply_ref``
    (``torch.fft`` of the padded or truncated line, no DFT matrix): the
    SCF's line shapes (d = 128 → n = 256 and n = 256 → n = 256, both
    directions) and two ragged ones."""
    rng = np.random.default_rng(B + n_in + n_out)
    x = _cx(rng, (B, n_in), cuda_device)
    before = dft_matmul.launches
    y = ops.dft_apply(x, n_out, inverse=inverse)
    assert dft_matmul.launches == before + 1
    _close(y, dft_apply_ref(x, n_out, inverse=inverse))


# one rank's blocks on a batch×fft grid, as the multi-rank fused route
# hands them to the kernels: its rows [r0, r1) of the stacked batch and
# its x planes [x0, x1), the line tables cut to both (kernel, d, n,
# k-points, bands, rows, x planes, slab layout)
RANK_CASES = {
    "unpack_dft-rank-block-d8": ("unpack", 8, 16, KPTS2, 4, (4, 8), (4, 8),
                                 None),
    "unpack_dft-rank-block-d128": ("unpack", 128, 256, KPTS2, 2, (0, 2),
                                   (64, 128), None),
    "dft_pack-rank-block-d8": ("pack", 8, 16, KPTS2, 4, (4, 8), (0, 4),
                               "rows"),
    "dft_pack-rank-block-y-planes-d128": ("pack", 128, 256, KPTS2, 2,
                                          (2, 4), (64, 128), "y-planes"),
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


def _check_rank_unpack(rng, dev, d, n, kpts, nb, rows, xs):
    spheres = [kpoint_sphere(d, k) for k in kpts]
    npm = max(s.npacked for s in spheres)
    start, zlo, cnt, flag = _rank_tables(spheres, nb, rows, xs, dev)
    packed = _cx(rng, (rows[1] - rows[0], npm), dev)
    _, _, w = dft_matrix_device(n, d, True, dev)
    got = sp.unpack_dft(packed, start, zlo, cnt, flag, w)
    assert tuple(got.shape) == (rows[1] - rows[0], xs[1] - xs[0], d, n)
    _close(got, sp.unpack_dft_plain(packed, start, zlo, cnt, flag, w))
    # the rank's block of the unpack over every row and plane
    full = [torch.as_tensor(t, device=dev)
            for t in sp.line_tables(spheres, nb)]
    whole = torch.zeros((len(spheres) * nb, npm), dtype=torch.complex64,
                        device=dev)
    whole[slice(*rows)] = packed
    _close(got, sp.unpack_dft_plain(whole, *full, w)[slice(*rows),
                                                     slice(*xs)])


def _check_rank_pack(rng, dev, d, n, kpts, nb, rows, xs, layout):
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
    # poison the memory the output will take: the caching allocator hands
    # a freed block of the same size to the next allocation
    poison = torch.full((B, npm), float("nan"), dtype=torch.complex64,
                        device=dev)
    del poison
    got = sp.dft_pack(slab, start, zlo, cnt, nvalid, w, npm, partial=True)
    _close(got, sp.dft_pack_plain(slab, start, zlo, cnt, nvalid, w, npm))
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
    which, d, n, kpts, nb, rows, xs, layout = RANK_CASES[case]
    rng = np.random.default_rng(13)
    fn = sp.unpack_dft if which == "unpack" else sp.dft_pack
    before = fn.launches
    if which == "unpack":
        _check_rank_unpack(rng, cuda_device, d, n, kpts, nb, rows, xs)
    else:
        _check_rank_pack(rng, cuda_device, d, n, kpts, nb, rows, xs, layout)
    assert fn.launches == before + 1


@pytest.mark.cuda
def test_scf_on_cuda_launches_every_kernel_and_matches_cpu(cuda_device):
    wrappers = (dft_matmul, sp.unpack_dft, sp.dft_pack)
    before = [f.launches for f in wrappers]
    cfg = SCFConfig(n=16, nbands=4, kpts=KPTS2, max_iter=3, stack_k=True,
                    backend="cuda")
    gpu = run_scf(cfg)                       # the default device is CUDA
    assert gpu.device.startswith("cuda")
    assert all(f.launches > n for f, n in zip(wrappers, before))
    cpu = run_scf(cfg, device="cpu")
    np.testing.assert_allclose(gpu.energies, cpu.energies, rtol=0,
                               atol=3e-5)


# general twiddle cases: (M, K, N, rows past M NaN-poisoned), T = M
TWIDDLE_CASES = {
    "general": (1000, 24, 40, False),
    "general-odd-k5": (300, 5, 5, False),
    "general-odd-k9-to-18": (300, 9, 18, False),
    "general-m1": (1, 8, 8, False),
    "general-poisoned": (1000, 24, 40, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*TWIDDLE_CASES, "four_step",
                                  "four_step-n15"])
def test_cuda_twiddle_kernel_matches_plain(case, cuda_device):
    dev = cuda_device
    rng = np.random.default_rng(12)
    if case in TWIDDLE_CASES:                  # ragged, a (M, N) table
        M, K, N, poisoned = TWIDDLE_CASES[case]
        x = _rows(rng, M, K, dev, poisoned)
        _, _, w = dft_matrix_device(N, K, False, dev)
        t = _cx(rng, (M, N), dev)
    else:                   # stage 1 of n = 64·32, or of n = 3·5 (K = 5)
        n1, n2 = ops._factor(2048 if case == "four_step" else 15)
        x = _cx(rng, (50 * n1, n2), dev)
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
@pytest.mark.parametrize("n", [64, 360, 4096])
def test_cuda_four_step_matches_torch_fft(n, inverse, cuda_device):
    rng = np.random.default_rng(n)
    x = _cx(rng, (33, n), cuda_device)
    before = (dft_matmul_twiddle.launches, dft_matmul.launches)
    y = ops.four_step_dft(x, inverse=inverse)
    fn = torch.fft.ifft if inverse else torch.fft.fft
    _close(y, fn(x, dim=-1))
    assert (dft_matmul_twiddle.launches, dft_matmul.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_cuda_transform_service_coalesces_and_matches_eager(cuda_device):
    from repro_torch.core import PlanCache, ProcGrid
    from repro_torch.serve import DeadlineExceeded, TransformService
    g = ProcGrid.create([1], device=cuda_device)
    svc = TransformService(g, 16, max_rows=8, backend="cuda",
                           cache=PlanCache())
    rng = np.random.default_rng(13)
    veff = rng.standard_normal((16,) * 3).astype(np.float32)
    spheres = [kpoint_sphere(8, k) for k in KPTS2] + [kpoint_sphere(4)]
    work = [(f"t{i}", (rng.standard_normal((2, s.npacked))
                       + 1j * rng.standard_normal((2, s.npacked))
                       ).astype(np.complex64), s, veff if i % 2 else None)
            for i, s in enumerate(spheres + spheres)]
    before = dft_matmul.launches
    svc.start()
    try:
        hs = [svc.submit(t, c, s, v_eff=v) for t, c, s, v in work]
        late = svc.submit("late", work[0][1], spheres[0], deadline=0.0)
        outs = [h.result(120) for h in hs]
        with pytest.raises(DeadlineExceeded):
            late.result(120)
    finally:
        svc.stop(timeout=120)
    assert dft_matmul.launches > before
    m = svc.metrics.summary()
    assert m["dispatches"] < len(work) and m["coalesced_dispatches"] >= 1
    for out, (_, c, s, v) in zip(outs, work):
        want = svc.eager_apply(c, s, v)
        err = float(np.abs(out - want).max())
        assert err <= RTOL * float(np.abs(want).max()), err
        if v is None:
            assert float(np.abs(out - c).max()) <= RTOL * float(
                np.abs(c).max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode,tol", [("lazy", RTOL), ("lazy_bf16", 3e-2)])
def test_cuda_lazy_executor_matches_eager(mode, tol, cuda_device):
    from repro_torch.core import Domain, ProcGrid, fftb
    from repro_torch.core.policy import ExecPolicy
    g = ProcGrid.create([1], device=cuda_device)
    plan = fftb("b x{0} y z -> b X Y Z{0}",
                domains=(Domain((0,), (1,)), Domain((0, 0, 0), (15,) * 3)),
                grid=g, backend="cuda")
    x = _cx(np.random.default_rng(3), (2, 16, 16, 16), cuda_device)
    eager = plan(x)
    got = plan(x, policy=ExecPolicy.from_mode(mode))
    assert got.device == x.device and got.is_contiguous()
    _close(got, eager, rtol=tol)


def _jit_cfg(**kw):
    return SCFConfig(n=16, nbands=3, kpts=KPTS2, stack_k=True,
                     backend="cuda", mix_warmup=99, mix_history=1, **kw)


@pytest.mark.cuda
def test_cuda_jit_step_replays_graphs_and_matches_eager(cuda_device):
    from repro_torch.core import FftPlan
    eager = run_scf(_jit_cfg(max_iter=6), device=cuda_device)
    ex0 = FftPlan.executions
    jit6 = run_scf(_jit_cfg(max_iter=6, jit_step=True), device=cuda_device)
    d6 = FftPlan.executions - ex0
    ex0 = FftPlan.executions
    jit3 = run_scf(_jit_cfg(max_iter=3, jit_step=True), device=cuda_device)
    # plan calls happen in the warm-up and the capture only: the same
    # count for 3 and 6 iterations
    assert FftPlan.executions - ex0 == d6 > 0
    assert jit6.jitted and jit3.jitted and jit6.iterations == 6
    st = jit6.graphs
    steps = SCFConfig().inner_steps
    assert st["host_syncs"] == ["linalg.eigh"] * steps
    assert st["graphs"] == steps + 1 and st["replays"] == 5
    assert jit6.transforms == eager.transforms
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
# reduced plane counts: idft[x] (L = 32,768), idft[y] (L = 65,536) and
# dft[X] (L = 128)
COLS_CASES = {
    "l8-k128": (40, 128, 8, 256),
    "l32-k256": (12, 256, 32, 128),
    "l64-k128": (6, 128, 64, 256),
    "l192-k256": (3, 256, 192, 128),
    "l32768-k128-idft-x": (2, 128, 32768, 256),
    "l65536-k128-idft-y": (1, 128, 65536, 256),
    "l128-k256-dft-x": (64, 256, 128, 128),
    "l64-odd-k9": (5, 9, 64, 18),
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
                                         (128, 256, KPTS2, 1)])
def test_cuda_dft_pack_z_major_slab_is_bitwise_the_other_layouts(
        d, n, kpts, nb, cuda_device):
    """One slab's values stored three ways: lines contiguous (layout 0),
    each y plane z-major (1) and each row's slab z-major (2, what the
    forward's x stage leaves): the packed lanes are equal bit for bit."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(16, 8), (32, 16)])
def test_cuda_traced_pair_reads_every_line_in_place(n, d, cuda_device):
    """A pair on the card: no ``relayout`` span, one line stage a call
    pair reading rows and three reading strided lines, and the cube and
    packed lanes bitwise those of the same stages run with their inputs
    copied into rows first."""
    from repro_torch.core import ProcGrid, make_planewave_pair
    from repro_torch.core import local_fft
    from repro_torch.obs.metrics import global_metrics
    from repro_torch.obs.trace import get_tracer
    inv, fwd = make_planewave_pair(ProcGrid.create([1], device=cuda_device),
                                   n, kpoint_sphere(d), 4, backend="cuda")
    c = _cx(np.random.default_rng(n), (4, inv.sphere.npacked), cuda_device)
    tr = get_tracer()
    before = dict(global_metrics().snapshot()["fftb"])
    tr.enable(sync=True)
    try:
        cube = inv.unpack_transform(c)
        out = fwd.transform_pack(cube)
        names = {e["name"] for e in tr.events()}
    finally:
        tr.disable()
        tr.clear()
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
