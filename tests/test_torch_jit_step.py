"""The port's fused SCF step (``jit_step=True``) against the JAX reference.

On the CPU the fused step runs eagerly each iteration (CUDA graphs are the
card's; ``tests/test_torch_cuda.py`` holds the replayed step).  Inputs are
made with numpy from a seed and handed to both packages.

Tolerances: the device mixer and the device energy against the
reference's, 1e-5 relative (f32, sums in another order); the fused step
against the port's eager loop under linear mixing as the reference holds
its own (energy and eigenvalues 1e-4, ρ 1e-4 of its maximum); against the
reference's fused step, iteration by iteration, ``SCF_ATOL`` of
``tests/test_torch_dft.py`` (3e-5 absolute).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.dft as RD
from repro.core import ProcGrid as RGrid
from repro.dft.scf import _init_coefficients as ref_init_coefficients
from repro.dft.scf import jit_mix as ref_jit_mix
from repro.dft.scf import jit_mixer_init as ref_jit_mixer_init
from repro_torch.core import FftPlan
from repro_torch.dft import (HartreeSolver, PlaneWaveBasis, SCFConfig,
                             coefficients_from_numpy, density_from_stacked,
                             run_scf, total_energy_stacked)
from repro_torch.dft.scf import jit_mix, jit_mixer_init

KPTS2 = ((0.0, 0.0, 0.0), (0.5, 0.5, 0.5))
SCF_ATOL = 3e-5
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    CPU thread pool would oversubscribe the cores the other workers'
    timing-sensitive tests share.  These tests are small: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


# ---------------------------------------------------------------- mixer
@pytest.mark.parametrize("history", [1, 4])
def test_jit_mix_matches_reference(history):
    """Six mixing steps (warm-up 2) on the same densities.  Steps 3 and 4
    feed ρ_out = ρ_in, so from step 4 the history holds two zero
    residuals: the bordered DIIS system is singular, its solve non-finite,
    and both mixers fall back to linear mixing."""
    rng = np.random.default_rng(21)
    nvol = 6 * 6 * 6
    st = jit_mixer_init(nvol, history, "cpu")
    rst = ref_jit_mixer_init(nvol, history)
    for k in range(6):
        rin = rng.random((6, 6, 6)).astype(np.float32)
        rout = rin if k in (3, 4) else \
            (rin + 0.1 * rng.standard_normal((6, 6, 6))).astype(np.float32)
        got = jit_mix(st, torch.as_tensor(rin), torch.as_tensor(rout),
                      alpha=0.7, warmup=2).numpy()
        rst, want = ref_jit_mix(rst, jnp.asarray(rin), jnp.asarray(rout),
                                alpha=0.7, warmup=2)
        assert np.all(np.isfinite(got))
        assert _rel(got, np.asarray(want)) <= RTOL, k
        if k == 4:
            # ρ_out = ρ_in: the linear fallback returns ρ_in itself
            np.testing.assert_array_equal(got, rin)
        assert int(st["seen"]) == int(rst["seen"]) == k + 1
    if history > 1:
        for key in ("rho_in", "res"):
            assert _rel(st[key].numpy(), np.asarray(rst[key])) <= RTOL


def test_jit_mix_updates_its_buffers_in_place():
    st = jit_mixer_init(8, 3, "cpu")
    bufs = {k: v.data_ptr() for k, v in st.items()}
    rin = torch.ones(2, 2, 2)
    jit_mix(st, rin, 2 * rin, alpha=0.5, warmup=0)
    assert {k: v.data_ptr() for k, v in st.items()} == bufs
    assert torch.equal(st["res"][-1], torch.ones(8))


# --------------------------------------------------------------- energy
def test_total_energy_stacked_matches_reference():
    rb = RD.PlaneWaveBasis(16, kpts=KPTS2, nbands=3,
                           grid=RGrid.create([1], ["torch_port_jit_e"]))
    b = PlaneWaveBasis(16, kpts=KPTS2, nbands=3, device="cpu")
    inv, _ = b.stacked_hamiltonian_plans()
    rng = np.random.default_rng(31)
    c = (rng.standard_normal((2, 3, inv.npacked_max))
         + 1j * rng.standard_normal((2, 3, inv.npacked_max))
         ).astype(np.complex64)
    for k, s in enumerate(b.spheres):
        c[k, :, s.npacked:] = 0
    occ = np.ones((2, 3))
    occ[1, 2] = 0.5
    rho = rng.random((16, 16, 16)).astype(np.float32)
    v_ext = rng.standard_normal((16, 16, 16)).astype(np.float32)
    want = RD.total_energy_stacked(rb, jnp.asarray(c), jnp.asarray(rho),
                                   jnp.asarray(v_ext), RD.HartreeSolver(rb),
                                   occ)
    got = total_energy_stacked(b, torch.as_tensor(c), torch.as_tensor(rho),
                               torch.as_tensor(v_ext), HartreeSolver(b), occ)
    assert got.dim() == 0 and got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= RTOL * abs(float(want))


def test_stacked_density_weights_live_on_the_device_once():
    b = PlaneWaveBasis(16, kpts=KPTS2, nbands=3, device="cpu")
    inv, _ = b.stacked_hamiltonian_plans()
    occ = np.ones((2, 3))
    c = torch.zeros((2, 3, inv.npacked_max), dtype=torch.complex64)
    density_from_stacked(b, c, occ)
    w = b.occupancy_weights(0, occ)
    density_from_stacked(b, c, occ)
    assert b.occupancy_weights(0, occ) is w and len(b._occ_weights) == 1
    np.testing.assert_array_equal(w.numpy(), np.full(6, 0.5, np.float32))


# ------------------------------------------------------------------ SCF
def _cfg(**kw):
    return SCFConfig(n=16, nbands=3, kpts=KPTS2, stack_k=True,
                     mix_warmup=99, mix_history=1, **kw)


def test_jit_step_matches_eager_route():
    eager = run_scf(_cfg(max_iter=6), device="cpu")
    ex0 = FftPlan.executions
    jit = run_scf(_cfg(max_iter=6, jit_step=True), device="cpu")
    assert FftPlan.executions > ex0         # the step's plans ran eagerly
    # on the CPU the step runs eagerly: no graph was replayed
    assert not jit.jitted and jit.graphs == {}
    assert jit.band_update == "stacked" and jit.iterations == 6
    assert jit.transforms == eager.transforms
    assert abs(jit.energy - eager.energy) < 1e-4
    assert np.abs(jit.eigenvalues - eager.eigenvalues).max() < 1e-4
    assert float((jit.rho - eager.rho).abs().max()) \
        < 1e-4 * float(eager.rho.max())


@pytest.mark.parametrize("backend", ["matmul", "cuda"])
def test_jit_step_matches_reference_jit_step(backend):
    """Same start coefficients, same config, linear mixing: the port's
    fused step (the "cuda" backend's kernels as plain versions here)
    against the reference's jitted step, iteration by iteration."""
    grid = RGrid.create([1], ["torch_port_jit_scf"])
    kw = {"n": 16, "nbands": 4, "kpts": KPTS2, "max_iter": 4,
          "stack_k": True, "jit_step": True, "mix_history": 1,
          "mix_warmup": 99}
    ref = RD.run_scf(RD.SCFConfig(**kw), grid=grid)
    start_basis = RD.PlaneWaveBasis(16, kpts=KPTS2, nbands=4, grid=grid)
    start = [np.asarray(c) for c in ref_init_coefficients(start_basis, 0)]
    res = run_scf(SCFConfig(**kw, backend=backend), device="cpu",
                  coeffs=coefficients_from_numpy(start, "cpu"))
    assert ref.jitted and res.iterations == ref.iterations == 4
    assert res.transforms == ref.transforms
    np.testing.assert_allclose(res.energies, ref.energies, rtol=0,
                               atol=SCF_ATOL)
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=0,
                               atol=SCF_ATOL)


def test_jit_step_anderson_converges():
    res = run_scf(SCFConfig(n=16, nbands=4, kpts=KPTS2, max_iter=50,
                            stack_k=True, jit_step=True), device="cpu")
    assert res.converged, (res.energies, res.residuals)
    assert res.stacked
    assert abs(res.energy - (-1.9197)) < 5e-3, res.energy
    for eps in res.eigenvalues:
        assert np.all(np.diff(eps) >= -1e-6)


def test_jit_step_requires_the_stacked_route():
    with pytest.raises(ValueError, match="jit_step=True requires"):
        run_scf(SCFConfig(n=16, nbands=3, kpts=KPTS2, stack_k=False,
                          jit_step=True, max_iter=1), device="cpu")
