"""The plain reference of the Γ-point transforms: real bands on half the
G-sphere.

At k = 0 a band is real, so its coefficients satisfy c(−G) = conj c(G)
and a band is given by the half of its sphere with lexicographic G ≥ 0.
Here each real band's spectrum is completed by that symmetry at the
wrapped index G mod n of the n³ grid, ``torch.fft.ifftn`` gives real ψ
(its imaginary part is asserted to be rounding), and the forward reads
``torch.fft.fftn`` of a real cube at the half's G mod n.  Plain PyTorch
and NumPy only, with its own sphere (:class:`GammaSphere`); nothing of
the program.

Two precisions, as :mod:`portbench.reference` has them: ``"float64"``
(``torch.fft`` in complex128, TF32 off) and ``"tf32"``, the control: two
real bands as one complex band ψ_a + iψ_b on the full sphere, through the
staged line DFTs of :class:`portbench.reference.Transforms` as products of
TF32-rounded operands, the bands separated again by
(F(G) ± conj F(−G)) / 2.  Its cube is e^{2πi s·r/n}(ψ_a + iψ_b), a box
index being its frequency; :func:`unphase` takes that factor off.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from .reference import Transforms


class GammaSphere:
    """The Γ sphere of diameter ``d``: the G with |G| < d/2, stored at box
    index G + s of [0, d)³, s = d // 2 on each axis, in CSR order (x, then
    y, then z ascending); its half, the G with G_x > 0, or G_x = 0 and
    G_y > 0, or G_x = G_y = 0 and G_z ≥ 0, in the same order."""

    def __init__(self, d: int):
        self.d = int(d)
        self.s = self.d // 2
        j = np.arange(self.d) - self.s
        gx, gy, gz = np.meshgrid(j, j, j, indexing="ij")
        inside = 4 * (gx ** 2 + gy ** 2 + gz ** 2) < self.d ** 2
        #: flat index into the d³ box of every lane, in lane order
        self.lanes = np.flatnonzero(inside.ravel())
        g = np.stack([a.ravel()[self.lanes] for a in (gx, gy, gz)], 1)
        #: (npacked, 3) integer G of every lane
        self.g = g
        half = ((g[:, 0] > 0) | ((g[:, 0] == 0) & (
            (g[:, 1] > 0) | ((g[:, 1] == 0) & (g[:, 2] >= 0)))))
        #: the lanes of the half, in lane order
        self.half = np.flatnonzero(half)
        where = np.full(self.d ** 3, -1, np.int64)
        where[self.lanes] = np.arange(self.lanes.shape[0])
        m = self.s - g[self.half]                 # the box index of −G
        #: the lane of −G for each lane of the half
        self.mirror = where[(m[:, 0] * self.d + m[:, 1]) * self.d + m[:, 2]]
        assert (self.mirror >= 0).all()

    @property
    def npacked(self) -> int:
        return int(self.lanes.shape[0])

    @property
    def nhalf(self) -> int:
        return int(self.half.shape[0])

    @property
    def ncols(self) -> int:
        """(x, y) columns that hold lanes: the z lines a transform needs."""
        return int(np.unique(self.lanes // self.d).shape[0])

    def g_half(self) -> np.ndarray:
        """(nhalf, 3) integer G of the half's lanes."""
        return self.g[self.half]


def fold(half, sphere: GammaSphere):
    """Real bands (nb, nhalf) → (⌈nb/2⌉, npacked) complex rows on the full
    sphere: bands 2k, 2k + 1 as a + i·b at G and conj(a) + i·conj(b) at −G
    (a zero band after an odd last one)."""
    nb = half.shape[0]
    rows = -(-nb // 2)
    pad = torch.zeros((2 * rows, half.shape[1]), dtype=half.dtype,
                      device=half.device)
    pad[:nb] = half
    a, b = pad[0::2], pad[1::2]
    full = torch.zeros((rows, sphere.npacked), dtype=half.dtype,
                       device=half.device)
    mirror = torch.as_tensor(sphere.mirror, device=half.device)
    lanes = torch.as_tensor(sphere.half, device=half.device)
    full[:, mirror] = torch.conj(a) + 1j * torch.conj(b)
    full[:, lanes] = a + 1j * b
    return full


def unfold(full, sphere: GammaSphere, nb: int):
    """(rows, npacked) complex rows on the full sphere → the nb real
    bands on the half: (F(G) + conj F(−G)) / 2, (F(G) − conj F(−G)) / 2i."""
    f = full[:, torch.as_tensor(sphere.half, device=full.device)]
    g = torch.conj(full[:, torch.as_tensor(sphere.mirror,
                                           device=full.device)])
    a, b = (f + g) / 2, (f - g) / 2j
    return torch.stack((a, b), 1).reshape(-1, f.shape[1])[:nb]


def unphase(cube, s: int):
    """``cube`` (rows, n, n, n) times e^{−2πi s·(x+y+z)/n}: the Γ pair's
    cube to ψ_{2k} + iψ_{2k+1}, in complex128."""
    n = cube.shape[-1]
    r = torch.arange(n, device=cube.device)
    k = (r[:, None, None] + r[None, :, None] + r[None, None, :]) * s % n
    if (4 * s) % n == 0:                # i^{-k}: exact quarter turns
        turns = torch.tensor([1, -1j, -1, 1j], dtype=torch.complex128,
                             device=cube.device)
        phase = turns[(k * 4 // n) % 4]
    else:
        phase = torch.polar(torch.ones_like(k, dtype=torch.float64),
                            k.to(torch.float64) * (-2 * math.pi / n))
    return cube.to(torch.complex128) * phase


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class GammaTransforms:
    """Real bands on the Γ sphere ↔ real cubes at one precision."""

    def __init__(self, n: int, d: int, device, precision: str = "float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.n, self.d = int(n), int(d)
        self.device = torch.device(device)
        self.precision = precision
        self.sphere = GammaSphere(d)
        g = torch.as_tensor(self.sphere.g_half(), device=self.device) % n
        #: flat index into the n³ grid of each half lane's G and −G
        self.at = (g[:, 0] * n + g[:, 1]) * n + g[:, 2]
        gm = (-torch.as_tensor(self.sphere.g_half(),
                               device=self.device)) % n
        self.at_mirror = (gm[:, 0] * n + gm[:, 1]) * n + gm[:, 2]
        if precision == "tf32":
            self.staged = Transforms(n, d, device, "tf32")

    def inverse(self, half):
        """(nb, nhalf) real bands' coefficients → (nb, n, n, n) real ψ
        (``ifftn`` scaled by 1/n³, as the pair's inverse)."""
        n = self.n
        if self.precision == "tf32":
            cube = self.cube(half)
            psi = unphase(cube, self.sphere.s)
            return torch.stack((psi.real, psi.imag), 1).reshape(
                -1, n, n, n)[:half.shape[0]]
        c = half.to(torch.complex128)
        spec = torch.zeros((c.shape[0], n ** 3), dtype=torch.complex128,
                           device=self.device)
        spec[:, self.at_mirror] = c.conj()
        spec[:, self.at] = c                  # G = 0 after its mirror
        with _no_tf32():
            psi = torch.fft.ifftn(spec.reshape(-1, n, n, n), dim=(1, 2, 3))
        del spec
        if psi.numel():
            assert float(psi.imag.abs().max()) <= 1e-12 * max(
                float(psi.real.abs().max()), 1e-300), (
                "a real band's spectrum is not Hermitian")
        return psi.real

    def cube(self, half):
        """The control's complex cube of the folded bands, (⌈nb/2⌉, n, n, n):
        e^{2πi s·r/n}(ψ_{2k} + iψ_{2k+1})."""
        if self.precision != "tf32":
            raise ValueError("cube is the control's (precision 'tf32')")
        full = fold(half.to(torch.complex64), self.sphere)
        with _no_tf32():
            return self.staged.inverse(full, self.sphere)

    def forward(self, psi):
        """(nb, n, n, n) real cubes → (nb, nhalf) coefficients at the half's
        G (unscaled ``fftn``, float64)."""
        if self.precision != "float64":
            raise ValueError("forward is the reference's (precision "
                             "'float64'); the control's is round_trip")
        with _no_tf32():
            spec = torch.fft.fftn(psi.to(torch.float64), dim=(1, 2, 3))
        return spec.reshape(spec.shape[0], -1)[:, self.at]

    def round_trip(self, half):
        """forward(inverse(half)): the identity on the half's lanes."""
        if self.precision == "tf32":
            with _no_tf32():
                full = self.staged.forward(self.cube(half), self.sphere)
            return unfold(full, self.sphere, half.shape[0])
        return self.forward(self.inverse(half))
