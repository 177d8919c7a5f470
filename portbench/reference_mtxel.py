"""The plain reference of the GW matrix elements.

    M_vc(G) = F( conj(F⁻¹ unpack_d c_v) · F⁻¹ unpack_d c_c )(G)

for packed coefficients on the wave functions' sphere of diameter ``d``,
kept for the G of the screened-Coulomb sphere of diameter ``d_eps`` about
G = 0 (:func:`cutoff_sphere`; lane i holds the G of box index i minus the
centre): the inverse of :class:`portbench.reference.Transforms`, the
product, and the full spectrum by ``torch.fft.fftn``, read at the wrapped
index G mod n of each lane.  Plain PyTorch only, on
:mod:`portbench.reference`'s own spheres and transforms; nothing of the
program.

Two precisions, as there: ``"float64"`` (``torch.fft`` in complex128, the
product in complex128, TF32 off) and ``"tf32"``, the control: the staged
line DFTs as products of TF32-rounded operands, the product in complex64,
shifted by e^{2πi s·r/n} so that the truncated forward's box holds the
sphere's G.
"""
from __future__ import annotations

import contextlib
import math

import torch

from .reference import Sphere, Transforms


def cutoff_sphere(d_eps: int) -> Sphere:
    """The lanes of the cut-off sphere of diameter ``d_eps`` about G = 0,
    in the program's order: box [0, d_eps)³ with centre s = d_eps // 2 on
    each axis, so box index i holds G = i - s."""
    d_eps = int(d_eps)
    return Sphere(d_eps, (d_eps // 2 - (d_eps - 1) / 2.0,) * 3)


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class MatrixElements:
    """Pair densities from the d-sphere onto the d_eps-sphere at one
    precision, ``block`` conduction bands at a time."""

    def __init__(self, n: int, d: int, d_eps: int, device,
                 precision: str = "float64", block: int = 4):
        self.inv = Transforms(n, d, device, precision)
        self.fwd = Transforms(n, d_eps, device, precision)
        self.sphere, self.sphere_eps = Sphere(d), cutoff_sphere(d_eps)
        self.block = int(block)
        self.precision = precision
        n = int(n)
        g = torch.as_tensor(self.sphere_eps.gvectors()).round().long() % n
        #: flat index into the n³ spectrum of each lane's G (wrapped)
        self.wrapped = ((g[:, 0] * n + g[:, 1]) * n + g[:, 2]).to(device)
        if precision == "tf32":
            s = d_eps // 2
            r = torch.arange(n, dtype=torch.float64)
            k = (r[:, None, None] + r[None, :, None] + r[None, None, :]) * s % n
            self.shift = torch.polar(torch.ones_like(k), k * (2 * math.pi / n)
                                     ).to(torch.complex64).to(device)

    def valence(self, c_v):
        """conj(ψ_v), (n, n, n), of one packed valence row."""
        with _no_tf32():
            return self.inv.inverse(c_v.reshape(1, -1), self.sphere)[0].conj()

    def __call__(self, c_c, vconj):
        """(nb, npacked_eps) matrix elements of the rows of ``c_c`` against
        the valence band whose conjugate is ``vconj``."""
        out = []
        with _no_tf32():
            for b0 in range(0, c_c.shape[0], self.block):
                psi = self.inv.inverse(c_c[b0:b0 + self.block], self.sphere)
                if self.precision == "tf32":
                    out.append(self.fwd.forward(psi * vconj * self.shift,
                                                self.sphere_eps))
                else:
                    spec = torch.fft.fftn(psi * vconj, dim=(1, 2, 3))
                    out.append(spec.reshape(spec.shape[0], -1)[:, self.wrapped])
                    del spec
                del psi
        return torch.cat(out)
