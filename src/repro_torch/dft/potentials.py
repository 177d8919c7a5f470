"""Local potentials: Gaussian wells (external) + LDA-style exchange.

The external potential is a sum of attractive Gaussian wells — smooth
pseudopotential-like cores without structure-factor machinery.  The
density-functional term is Slater exchange (the LDA X-only functional),
enough to make the SCF loop genuinely nonlinear in ρ.
"""
from __future__ import annotations

import numpy as np
import torch

#: Slater exchange constant C_x = (3/4)(3/π)^{1/3}
_CX = 0.75 * (3.0 / np.pi) ** (1.0 / 3.0)


def gaussian_wells(n: int, centers=None, depth: float = 4.0,
                   width: float | None = None) -> np.ndarray:
    """Sum of attractive Gaussians on the n³ grid (f32, numpy).

    Defaults: two wells on the cube diagonal at 0.3·n and 0.7·n, width
    n/16.
    """
    if centers is None:
        centers = [(n * 0.3,) * 3, (n * 0.7,) * 3]
    if width is None:
        width = n / 16.0
    xs = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
    v = np.zeros((n, n, n), np.float32)
    for c in centers:
        v -= depth * np.exp(-((xs - np.asarray(c)) ** 2).sum(-1)
                            / (2 * width ** 2)).astype(np.float32)
    return v


def lda_exchange(rho):
    """Slater exchange: energy density e_x(r) and potential v_x(r).

    e_x = −C_x ρ^{4/3} (energy per volume; integrate with ΔV for E_x),
    v_x = δE_x/δρ = −(4/3) C_x ρ^{1/3}.  ρ is clipped at 0 — it is a sum
    of |ψ|² terms, so negatives are only mixing artifacts.
    """
    r = torch.clamp(rho, min=0.0)
    r13 = torch.pow(r, 1.0 / 3.0)
    e_x = -_CX * r13 * r
    v_x = -(4.0 / 3.0) * _CX * r13
    return e_x, v_x
