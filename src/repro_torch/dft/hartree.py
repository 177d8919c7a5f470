"""G-space Hartree/Poisson solve on the full-cube plan pair.

    v_H(r) = ifft( 4π/|G|² · fft(ρ) ),   G = (2π/L)·fftfreq indices

The forward/inverse cube transforms are the FFTB plans from
``basis.cube_plans()`` — the full-cube traffic that interleaves with the
sphere-batch traffic in the paper's workload.  The G=0 (uniform) component
is dropped, i.e. a neutralizing background charge, as in any periodic
Coulomb solve.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.grid import resolve_device


def coulomb_kernel(n: int, L: float, device=None) -> torch.Tensor:
    """4π/|G|² on the n³ FFT cube in fft-index order, G=0 entry zeroed.

    ``device=None`` means CUDA and raises without it, as every entry
    point does (:func:`~repro_torch.core.grid.resolve_device`).
    """
    f = np.fft.fftfreq(n, d=1.0 / n)            # integer frequencies
    gx, gy, gz = np.meshgrid(f, f, f, indexing="ij")
    g2 = (gx ** 2 + gy ** 2 + gz ** 2) * (2 * np.pi / L) ** 2
    kern = np.where(g2 > 0.0, 4 * np.pi / np.where(g2 > 0.0, g2, 1.0), 0.0)
    return torch.as_tensor(kern.astype(np.float32),
                           device=resolve_device(device))


class HartreeSolver:
    """Poisson solve + Hartree energy over a PlaneWaveBasis's cube plans."""

    def __init__(self, basis):
        self.basis = basis
        # the rank's G-space block: the cube plans leave G space split as
        # real space is, its last dim over the fft axes
        self.kernel = basis.field.scatter(
            coulomb_kernel(basis.n, basis.L, basis.device))

    def __call__(self, rho):
        """ρ(r) → v_H(r), both real (n, n, n) fields (the rank's z-blocks
        on a multi-process grid).

        One forward full-cube plan, a diagonal multiply in G-space, one
        derived-inverse full-cube plan — two transforms.
        """
        fwd, inv = self.basis.cube_plans()
        rho_g = fwd(rho.to(torch.complex64))
        return inv(rho_g * self.kernel).real

    def energy(self, rho, vh) -> float:
        """E_H = ½ ∫ ρ v_H  (discretized with ΔV; summed over the ranks'
        blocks)."""
        return self.basis.field_sum(rho * vh) * 0.5 * self.basis.dv
