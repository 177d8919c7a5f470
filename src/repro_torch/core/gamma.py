"""Γ-point plane waves: two real bands per complex FFT on half the G-sphere.

At k = 0 a band is real in r-space, so its coefficients satisfy
c(−G) = conj c(G): a Γ-only plane-wave code stores half the G-sphere and
sends two real bands a, b through one complex transform as ψ_a + iψ_b
(Quantum ESPRESSO's ``K_POINTS gamma``, ``vloc_psi_gamma``; Giannozzi et
al., J. Phys.: Condens. Matter 21, 395502 (2009)).  The complex band's
spectrum on the full sphere is F(G) = c_a(G) + i c_b(G), and the forward
separates the two again, c_a(G) = (F(G) + conj F(−G))/2 and
c_b(G) = (F(G) − conj F(−G))/(2i).

The sphere.  :func:`gamma_sphere` is |G| < d/2 about the integer centre
s = d // 2 of the box [0, d)³, closed under G ↦ −G (box index j ↦ 2s − j);
its half (:func:`half_lanes`) is the lexicographic G ≥ 0: G_x > 0, or
G_x = 0 and G_y > 0, or G_x = G_y = 0 and G_z ≥ 0, in the sphere's lane
order, G = 0 stored once (its first lane).  At d = 128: 1,097,911 lanes in
12,849 columns, 548,956 of them in the half.

Where the phase goes.  A box index is its transform's frequency, so the
inverse's cube holds e^{2πi s·r/n}(ψ_a + iψ_b): i^{x+y+z} when n = 2d.  A
real potential commutes with that factor and the forward takes it off
again, so the transforms between the fold and the unfold are the Γ
sphere's ordinary plane-wave pair, from the plan cache: the fused
``unpack_dft`` and ``dft_pack`` and the line stages on the "cuda"
backend, as for any sphere.  ``|cube|²`` is ψ_a² + ψ_b², the pair's
density.

On a grid of processes the complex rows split over the batch axes as
usual; real bands 2k and 2k + 1 ride complex row k, so a band pair never
straddles a split.  The forward unfolds after the pack's merge over the
axes that split x, when every rank holds both G and −G.

While the tracer records, each call runs in a ``gamma`` span, and the
fold and the unfold in ``gamma:fold`` and ``gamma:unfold`` device spans
under it, carrying their ``bands`` and ``bytes``; the ``gamma`` probe
counts the complex rows folded or unfolded (``rows``) and the bytes each
pass reads and writes (``fold_bytes``, ``unfold_bytes``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..obs.metrics import global_metrics
from ..obs.trace import get_tracer
from .domain import Domain, SphereDomain
from .fft import fftb
from .planewave import planewave_spec
from .policy import ExecPolicy

#: the passes made around the transforms: complex rows folded or
#: unfolded, bytes read and written by each pass (the ``gamma`` probe)
FOLDS = {"rows": 0, "fold_bytes": 0, "unfold_bytes": 0}

global_metrics().register_probe("gamma", lambda: dict(FOLDS))


def gamma_sphere(d: int) -> SphereDomain:
    """The Γ sphere of diameter ``d``: |G| < d/2 about the centre
    s = d // 2 of the box [0, d)³, so j ↦ 2s − j maps it onto itself.  Its
    radius is set between the largest integer |G|² below (d/2)² and
    (d/2)², so no lane lies on the boundary."""
    d = int(d)
    s = float(d // 2)
    r2 = math.ceil(d * d / 4) - 1
    return SphereDomain(radius=math.sqrt(r2 + 0.5), center=(s, s, s),
                        lower=(0, 0, 0), upper=(d - 1,) * 3)


def half_lanes(sphere: SphereDomain) -> tuple[np.ndarray, np.ndarray]:
    """``(lane, mirror)``: for each G of the sphere's half (lexicographic
    G ≥ 0 about its centre, in lane order) the lane of G and the lane of
    −G, int32.  The centre must be a grid point and the sphere closed
    under G ↦ −G (as :func:`gamma_sphere` is)."""
    c = np.asarray(sphere.center, np.float64)
    if not np.array_equal(c, np.round(c)):
        raise ValueError(f"the sphere's centre {tuple(c)} is not a grid "
                         "point; make it with gamma_sphere")
    ext = np.asarray(sphere.extents)
    s = np.round(c).astype(np.int64) - np.asarray(sphere.lower)
    flat = sphere.pack_indices()
    ey, ez = ext[1], ext[2]
    box = np.stack([flat // (ey * ez), flat // ez % ey, flat % ez], 1)
    g = box - s
    m = 2 * s - box
    where = np.full(int(ext.prod()), -1, np.int64)
    where[flat] = np.arange(flat.size)
    inside = ((m >= 0) & (m < ext)).all(1)
    mirror = np.full(flat.size, -1, np.int64)
    mirror[inside] = where[(m[inside, 0] * ey + m[inside, 1]) * ez
                           + m[inside, 2]]
    if (mirror < 0).any():
        raise ValueError("the sphere is not closed under G -> -G about its "
                         "centre; make it with gamma_sphere")
    gx, gy, gz = g.T
    half = (gx > 0) | ((gx == 0) & ((gy > 0) | ((gy == 0) & (gz >= 0))))
    lane = np.flatnonzero(half)
    return lane.astype(np.int32), mirror[lane].astype(np.int32)


def _tables(plan) -> dict:
    """The device tables of ``plan``'s sphere, kept on the inverse plan
    (the plan cache's entry) and read by its mirror, so they are charged
    once, to that plan's ``private_bytes``."""
    owner = plan if plan.is_inverse else plan.inverse()

    def build():
        dev = owner.grid.device
        lane, mirror = (torch.as_tensor(t, device=dev)
                        for t in half_lanes(owner.sphere))
        return {"lane": lane, "mirror": mirror}

    return owner.private_tables("gamma", build)


class GammaPlaneWave:
    """One direction of the Γ-point transform of ``nbands`` real bands: the
    Γ sphere's :class:`~repro_torch.core.PlaneWaveFFT` ``plan`` with the
    fold before it (an inverse) or the unfold after it (a forward).

    Half-sphere rows are ``(bands, nhalf)`` complex64, the rank's real
    bands (:meth:`local_bands`); the cube is the plan's, ⌈nbands/2⌉
    complex rows (the rank's block of them)."""

    def __init__(self, plan, nbands: int):
        self.plan = plan
        self.nbands = int(nbands)
        side = plan.tin if plan.is_inverse else plan.tout
        rows = side.shape[0]
        if not 2 * rows - 1 <= self.nbands <= 2 * rows:
            raise ValueError(f"{self.nbands} real bands do not fill the "
                             f"plan's {rows} complex rows")
        tables = _tables(plan)
        self._lane, self._mirror = tables["lane"], tables["mirror"]
        r = side.local_slices()[0]
        self._bands = slice(min(2 * r.start, self.nbands),
                            min(2 * r.stop, self.nbands))

    @property
    def is_inverse(self) -> bool:
        return self.plan.is_inverse

    @property
    def sphere(self) -> SphereDomain:
        return self.plan.sphere

    @property
    def nhalf(self) -> int:
        return int(self._lane.shape[0])

    @property
    def local_nbands(self) -> int:
        """This rank's real bands: two a complex row, the last maybe one."""
        return self._bands.stop - self._bands.start

    def inverse(self) -> "GammaPlaneWave":
        """The other direction, on the plan's memoized mirror."""
        return GammaPlaneWave(self.plan.inverse(), self.nbands)

    def local_bands(self, half):
        """This rank's real bands of a replicated ``(nbands, …)`` block:
        the two bands of each of its complex rows."""
        if self._bands == slice(0, half.shape[0]):
            return half
        return half[self._bands]

    # ------------------------------------------------------------ passes
    def _fold(self, half):
        from ..kernels import gamma as gk
        nb = self.local_nbands
        if tuple(half.shape) != (nb, self.nhalf):
            raise ValueError(f"half-sphere rows {tuple(half.shape)}, "
                             f"expected {(nb, self.nhalf)}")
        npk = self.sphere.npacked
        rows = -(-nb // 2)
        nbytes = (nb * self.nhalf + rows * npk) * 8
        FOLDS["rows"] += rows
        FOLDS["fold_bytes"] += nbytes
        half = half.to(torch.complex64).contiguous()
        with get_tracer().device_span("gamma:fold", bands=nb,
                                      bytes=nbytes) as sp:
            return sp.sync(gk.fold(half, self._lane, self._mirror, npk))

    def _unfold(self, full):
        from ..kernels import gamma as gk
        nb = self.local_nbands
        rows = full.shape[0]
        nbytes = (full.numel() + nb * self.nhalf) * 8
        FOLDS["rows"] += rows
        FOLDS["unfold_bytes"] += nbytes
        full = full.to(torch.complex64).contiguous()
        with get_tracer().device_span("gamma:unfold", bands=nb,
                                      bytes=nbytes) as sp:
            return sp.sync(gk.unfold(full, self._lane, self._mirror, nb))

    # ------------------------------------------------------------ entries
    def unpack_transform(self, half, *, policy: ExecPolicy | None = None):
        """The rank's real bands ``(bands, nhalf)`` → the plan's cube block,
        e^{2πi s·r/n}(ψ_{2k} + iψ_{2k+1}) in row k: the fold, then the
        plan's ``unpack_transform``."""
        if not self.is_inverse:
            raise ValueError("unpack_transform runs on the inverse")
        with get_tracer().span("gamma", inverse=True,
                               bands=half.shape[0]) as sp:
            full = self._fold(half)
            return sp.sync(self.plan.unpack_transform(full, policy=policy))

    def transform_pack(self, cube, *, policy: ExecPolicy | None = None):
        """The plan's cube block → the rank's real bands ``(bands,
        nhalf)``: the plan's ``transform_pack``, then the unfold."""
        if self.is_inverse:
            raise ValueError("transform_pack runs on the forward")
        with get_tracer().span("gamma", inverse=False,
                               bands=self.local_nbands) as sp:
            full = self.plan.transform_pack(cube, policy=policy)
            return sp.sync(self._unfold(full))


def gamma_plans(grid, n: int, d: int, nbands: int, *,
                backend: str = "matmul", batch_axes: tuple[int, ...] = (),
                fft_axes: tuple[int, ...] | None = None,
                policy: ExecPolicy | None = None
                ) -> tuple[GammaPlaneWave, GammaPlaneWave]:
    """(inverse, forward) Γ-point transforms of ``nbands`` real bands on
    the Γ sphere of diameter ``d`` (:func:`gamma_sphere`) and the n³ grid:
    the sphere's plane-wave plan of ⌈nbands/2⌉ complex rows from the plan
    cache, laid out as :func:`~repro_torch.core.make_planewave_pair`'s,
    and its memoized mirror."""
    if fft_axes is None:
        fft_axes = tuple(a for a in range(grid.ndim) if a not in batch_axes)
    spec = planewave_spec(tuple(batch_axes), tuple(fft_axes))
    bdom = Domain((0,), (-(-int(nbands) // 2) - 1,))
    plan = fftb.plan_for(spec, domains=(bdom, gamma_sphere(d)), grid=grid,
                         sizes=(n,) * 3, inverse=True, backend=backend,
                         policy=policy)
    inv = GammaPlaneWave(plan, nbands)
    return inv, inv.inverse()
