"""repro_torch.dft against the JAX reference ``repro.dft``, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
port's kernel backend ("cuda") runs its kernels' plain versions here (CPU
tensors), through the same fused sphere-pack route it takes on the card.

Tolerances: torch's CPU GEMMs and XLA's dots sum in different orders, so
single transforms and H applies agree to ~1e-6 relative to the largest
value; the SCF slice carries that rounding through Rayleigh-Ritz solves and
mixing — measured ~4e-6 absolute in energy over 4 iterations — and is held
to 3e-5 absolute (energies ~2, eigenvalues ~0.3).  QR and ``eigh`` fix
phases differently in the two frameworks, so band updates are compared by
eigenvalues and subspace projectors c†c, never raw coefficients.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.dft as RD
from repro.core import ProcGrid as RGrid
from repro.dft import hamiltonian as RH
from repro.dft.scf import _init_coefficients as ref_init_coefficients
from repro_torch.dft import (HartreeSolver, PlaneWaveBasis, SCFConfig,
                             apply_hamiltonian, apply_hamiltonian_padded,
                             coefficients_from_numpy, density_from_orbitals,
                             run_scf, update_bands_all_k,
                             update_bands_stacked)
from repro_torch.dft.hamiltonian import orthonormalize

KPTS2 = ((0.0, 0.0, 0.0), (0.5, 0.5, 0.5))
RTOL = 2e-6
SCF_ATOL = 3e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    CPU thread pool would oversubscribe the cores the other workers'
    timing-sensitive tests share.  These tests are small: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


@pytest.fixture(scope="module")
def ref_basis():
    return RD.PlaneWaveBasis(16, kpts=KPTS2, nbands=3,
                             grid=RGrid.create([1], ["torch_port_dft"]))


def _basis(backend):
    return PlaneWaveBasis(16, kpts=KPTS2, nbands=3, backend=backend,
                          device="cpu")


def _bands(ref_basis, seed):
    """Orthonormal per-k blocks (numpy), orthonormalized by the reference."""
    rng = np.random.default_rng(seed)
    out = []
    for ik in range(ref_basis.nk):
        npk = ref_basis.npacked(ik)
        c = (rng.standard_normal((ref_basis.nbands, npk))
             + 1j * rng.standard_normal((ref_basis.nbands, npk))
             ).astype(np.complex64)
        out.append(np.array(RH.orthonormalize(jnp.asarray(c))))
    return out


def _veff(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((16, 16, 16)).astype(np.float32)


# ----------------------------------------------------------------- basis
def test_basis_tables_equal_reference(ref_basis):
    b = _basis("cuda")
    assert [s.npacked for s in b.spheres] == \
        [s.npacked for s in ref_basis.spheres]
    assert b.npacked_max == ref_basis.npacked_max
    assert b.pad_width(1) == ref_basis.pad_width(1)
    assert b.padding_fraction == ref_basis.padding_fraction
    assert not b.stacks_k and not ref_basis.stacks_k
    for ik in range(b.nk):
        assert np.array_equal(b.kinetic(ik).numpy(),
                              np.asarray(ref_basis.kinetic(ik)))
        assert np.array_equal(b.gvectors(ik), ref_basis.gvectors(ik))
    t, r = b.stacked_band_tables(), ref_basis.stacked_band_tables()
    for name in ("kinetic", "mask", "precond"):
        assert np.array_equal(getattr(t, name).numpy(),
                              np.asarray(getattr(r, name))), name
    assert b.stacked_band_tables() is t          # served from the cache


# --------------------------------------------------- hartree and density
@pytest.mark.parametrize("backend", ["fft", "matmul", "cuda"])
def test_hartree_matches_reference(backend, ref_basis):
    rng = np.random.default_rng(0)
    rho = rng.random((16, 16, 16)).astype(np.float32)
    got = HartreeSolver(_basis(backend))(torch.as_tensor(rho))
    want = RD.HartreeSolver(ref_basis)(jnp.asarray(rho))
    _close(got.numpy(), want)


@pytest.mark.parametrize("backend", ["matmul", "cuda"])
def test_density_matches_reference(backend, ref_basis):
    blocks = _bands(ref_basis, 1)
    occ = np.ones((2, 3))
    got = density_from_orbitals(_basis(backend),
                                coefficients_from_numpy(blocks, "cpu"), occ)
    want = RD.density_from_orbitals(ref_basis,
                                    [jnp.asarray(c) for c in blocks], occ)
    _close(got.numpy(), want)


# ----------------------------------------------------------- hamiltonian
@pytest.mark.parametrize("backend", ["fft", "matmul", "cuda"])
def test_apply_hamiltonian_padded_matches_reference(backend, ref_basis):
    b = _basis(backend)
    blocks = _bands(ref_basis, 2)
    v = _veff(3)
    inv, _ = b.stacked_hamiltonian_plans()
    assert (inv._fused_in_parts() is not None) == (backend == "cuda")
    c_pad = inv.stack(coefficients_from_numpy(blocks, "cpu")).reshape(
        2, 3, b.npacked_max)
    got = apply_hamiltonian_padded(b, c_pad, torch.as_tensor(v))
    rinv, _ = ref_basis.stacked_hamiltonian_plans()
    rc = rinv.stack([jnp.asarray(c) for c in blocks]).reshape(
        2, 3, ref_basis.npacked_max)
    want = RH.apply_hamiltonian_padded(ref_basis, rc, jnp.asarray(v))
    _close(got.numpy(), want)
    # padded lanes of H·c stay exact zeros
    pad = ~inv.valid_lanes()
    out = got.numpy()
    for k in range(2):
        assert np.all(out[k][:, pad[k]] == 0)


def test_apply_hamiltonian_per_k_matches_reference(ref_basis):
    b = _basis("cuda")
    blocks = _bands(ref_basis, 4)
    v = _veff(5)
    for ik in range(2):
        got = apply_hamiltonian(b, ik, torch.as_tensor(blocks[ik]),
                                torch.as_tensor(v))
        want = RH.apply_hamiltonian(ref_basis, ik, jnp.asarray(blocks[ik]),
                                    jnp.asarray(v))
        _close(got.numpy(), want)


def _projector(c):
    c = np.asarray(c, np.complex128)
    return c.conj().T @ c


@pytest.mark.parametrize("stacked", [True, False])
def test_band_update_matches_reference(stacked, ref_basis):
    b = _basis("cuda")
    blocks = _bands(ref_basis, 6)
    v = _veff(7) * 0.1
    cs, eps, nsweep = update_bands_all_k(
        b, coefficients_from_numpy(blocks, "cpu"), torch.as_tensor(v),
        steps=2, stacked=stacked)
    rcs, reps, rsweep = RH.update_bands_all_k(
        ref_basis, [jnp.asarray(c) for c in blocks], jnp.asarray(v),
        steps=2, stacked=True)
    assert nsweep == rsweep == 4
    for ik in range(2):
        np.testing.assert_allclose(eps[ik].numpy(), np.asarray(reps[ik]),
                                   rtol=0, atol=1e-5)
        _close(_projector(cs[ik].numpy()), _projector(rcs[ik]), rtol=1e-5)


def test_update_bands_stacked_keeps_padding_zero(ref_basis):
    b = _basis("cuda")
    inv, _ = b.stacked_hamiltonian_plans()
    c_pad = inv.stack(coefficients_from_numpy(_bands(ref_basis, 8), "cpu")
                      ).reshape(2, 3, b.npacked_max)
    c, eps, _ = update_bands_stacked(b, c_pad, torch.as_tensor(_veff(9)),
                                     steps=1)
    pad = ~inv.valid_lanes()
    for k in range(2):
        assert np.all(c[k].numpy()[:, pad[k]] == 0)
    assert np.all(np.diff(eps.numpy(), axis=1) >= -1e-6)


# ----------------------------------------------------------------- SCF
@pytest.fixture(scope="module")
def ref_scf(ref_basis):
    """Reference trajectory: 4 SCF iterations on the stacked matmul route,
    from the reference's own orthonormal start (returned as numpy)."""
    cfg = RD.SCFConfig(n=16, nbands=4, kpts=KPTS2, max_iter=4,
                       stack_k=True, backend="matmul")
    grid = RGrid.create([1], ["torch_port_scf"])
    start_basis = RD.PlaneWaveBasis(16, kpts=KPTS2, nbands=4, grid=grid)
    start = [np.asarray(c) for c in ref_init_coefficients(start_basis, 0)]
    return RD.run_scf(cfg, grid=grid), start


@pytest.mark.parametrize("stack_k,backend", [
    (True, "cuda"), (False, "cuda"), (True, "matmul")])
def test_scf_slice_matches_reference(stack_k, backend, ref_scf):
    """The slice end to end: ``run_scf`` on the kernel backend (plain
    versions on the CPU) against the reference's ``run_scf`` on "matmul",
    same start, same config, iteration by iteration."""
    ref, start = ref_scf
    res = run_scf(SCFConfig(n=16, nbands=4, kpts=KPTS2, max_iter=4,
                            stack_k=stack_k, backend=backend),
                  device="cpu", coeffs=coefficients_from_numpy(start, "cpu"))
    assert res.stacked == stack_k and res.backend == backend
    assert res.iterations == ref.iterations == 4
    assert res.transforms == ref.transforms
    np.testing.assert_allclose(res.energies, ref.energies, rtol=0,
                               atol=SCF_ATOL)
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=0,
                               atol=SCF_ATOL)
    _close(res.rho.numpy(), ref.rho, rtol=1e-4)
    assert res.device == "cpu"


def test_scf_refuses_unported_and_contradictory_routes():
    # the fused step needs the stacked route; one device stacks only when
    # asked (stack_k=True), so the default per-k route is refused
    with pytest.raises(ValueError, match="jit_step=True requires"):
        run_scf(SCFConfig(n=16, nbands=2, jit_step=True), device="cpu")
    with pytest.raises(ValueError, match="stack_k=True requires"):
        run_scf(SCFConfig(n=16, nbands=2, stack_k=True, pipeline=False,
                          max_iter=1), device="cpu")
    with pytest.raises(ValueError, match="coeffs"):
        run_scf(SCFConfig(n=16, nbands=2, max_iter=1), device="cpu",
                coeffs=[np.zeros((2, 5), np.complex64)])


def test_scf_default_start_is_orthonormal_and_converges_direction():
    res = run_scf(SCFConfig(n=16, nbands=2, kpts=KPTS2, max_iter=3,
                            stack_k=True, backend="cuda"), device="cpu")
    assert len(res.energies) == 3 and np.all(np.isfinite(res.energies))
    assert res.energies[-1] < res.energies[0]
    c = orthonormalize(torch.randn(3, 40, dtype=torch.complex64))
    np.testing.assert_allclose((c.conj() @ c.T).numpy(), np.eye(3),
                               atol=1e-5)
