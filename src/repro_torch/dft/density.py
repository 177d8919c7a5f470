"""Electron density from sphere-packed orbitals.

    ρ(r) = (n³/ΔV) Σ_k w_k Σ_b f_kb |ψ_kb(r)|²

with ψ = ifft(c) the *unnormalized* inverse transform of unit-norm packed
coefficients (Σ_G |c_G|² = 1 ⇒ Σ_r |ψ_r|² = 1/n³), so the prefactor makes
each occupied orbital integrate to one electron: Σ_r ρ ΔV = Σ w·f.

The per-k inverse plans come from the plan cache (one batched transform per
k-point, bands batched).  When the basis stacks k-points on its own
(``basis.stacks_k``), all k-points' padded coefficients ride one ragged
batch of nk·nbands through a single transform instead.

On a multi-process grid each rank transforms its rows of the (replicated)
coefficient blocks; the cubes come out as z-blocks, so ρ is the rank's
z-block (``basis.field``), its band sum an all-reduce over the batch axes.
"""
from __future__ import annotations

import numpy as np
import torch


def density_from_stacked(basis, c_pad, occ, seg: int = 0) -> torch.Tensor:
    """Segment ``seg``'s density contribution from its padded
    (nk_seg, nbands, pad_width) coefficient stack.

    One nk_seg·nbands-batched transform on the same ragged
    ``StackedPlaneWaveFFT`` pair as the stacked Hamiltonian apply.
    ``occ`` is the *full* (nk, nbands) table — the segment's rows are
    selected here, weights included, so summing the per-segment
    contributions gives exactly ρ.  Padded lanes never reach the cube (the
    unpack scatter routes them to the dump slot).  The weights come from
    ``basis.occupancy_weights`` (on the device, built once), so the call
    makes no host→device copy.
    """
    inv, _ = basis.stacked_hamiltonian_plans(seg)
    nks, nb, npm = c_pad.shape
    psi = inv(inv.unpack(inv.local_rows(c_pad.reshape(nks * nb, npm))))
    w = inv.local_rows(basis.occupancy_weights(seg, occ))
    rho = torch.tensordot(w, psi.abs() ** 2, dims=([0], [0]))
    rho = basis.grid.all_reduce(rho, basis.batch_axes,
                                name="density.all_reduce")
    return rho * float(np.float32(basis.n ** 3 / basis.dv))


def _density_stacked(basis, coeffs, occ) -> torch.Tensor:
    """Per-k blocks → stacked-batch density, one batch per segment."""
    rho = None
    for s, seg in enumerate(basis.segments):
        inv, _ = basis.stacked_hamiltonian_plans(s)
        c_pad = inv.stack([coeffs[ik] for ik in seg]).reshape(
            len(seg), basis.nbands, inv.npacked_max)
        part = density_from_stacked(basis, c_pad, occ, seg=s)
        rho = part if rho is None else rho + part
    return rho


def density_from_orbitals(basis, coeffs, occ) -> torch.Tensor:
    """ρ(r) on the n³ cube (f32) from per-k packed coefficient blocks.

    coeffs: list of (nbands, npacked_k) complex blocks, one per k-point
    occ:    (nk, nbands) occupation numbers f_kb
    """
    occ = np.asarray(occ, np.float64)
    if occ.shape != (basis.nk, basis.nbands):
        raise ValueError(
            f"occ shape {occ.shape} != (nk, nbands) = "
            f"({basis.nk}, {basis.nbands})")
    if getattr(basis, "stacks_k", False):
        return _density_stacked(basis, coeffs, occ)   # prefactor included
    rho = torch.zeros(basis.field.local_shape, dtype=torch.float32,
                      device=basis.device)
    for ik, c in enumerate(coeffs):
        inv, _ = basis.plans_for_k(ik)
        psi = inv(inv.unpack(inv.local_rows(c)))     # (nb, n, n, n)
        f = torch.as_tensor((basis.weights[ik] * occ[ik]).astype(np.float32),
                            device=psi.device)
        rho = rho + torch.tensordot(inv.local_rows(f), psi.abs() ** 2,
                                    dims=([0], [0]))
    rho = basis.grid.all_reduce(rho, basis.batch_axes,
                                name="density.all_reduce")
    return rho * float(np.float32(basis.n ** 3 / basis.dv))


def electron_count(basis, rho) -> float:
    """∫ ρ dr — sanity invariant (should equal Σ_k w_k Σ_b f_kb).  ``rho``
    is the rank's z-block (the whole cube on one process)."""
    return basis.field_sum(rho) * basis.dv
