"""GW matrix elements: valence-conduction pair densities on the FFT grid.

Plane-wave GW codes build the dielectric matrix from the matrix elements

    M_vc(G) = <v| e^{iG·r} |c>  =  pack_eps( F( conj(ψ_v) · ψ_c ) )

for the G inside the screened-Coulomb cut-off, a sphere about G = 0 smaller
than the wave functions' own (BerkeleyGW's epsilon, Deslippe et al.,
Comput. Phys. Commun. 183, 1269 (2012)): bring a block of conduction bands
to real space, multiply each by one valence band's conjugate on the grid,
transform the products forward and keep the lanes of the second sphere.
On a grid of n = 2d the product of two d-sphere functions is represented
exactly (no aliasing).

Where G lies.  A sphere's box index is its transform's frequency, so the
wave functions' sphere lies at frequencies [0, d).  For one wave function
that offset is only a phase; in conj(ψ_v)·ψ_c the two phases cancel, and
the product's spectrum lies about G = 0, its negative G at the top
indices (G mod n).  :func:`valence_conjugates` multiplies each conjugate
by e^{2πi s·r/n}, s the centre of the cut-off sphere's box, once in
set-up; that moves G onto index G + s, so the cut-off sphere
(:func:`cutoff_sphere`, centre s) holds the G about 0, at no cost per
call.

The two legs are the plane-wave plans of two spheres, served from the plan
cache (:func:`mtxel_plans`): the inverse of the wave functions' sphere and
the forward onto the cut-off sphere (the mirror of that sphere's inverse),
so with ``backend="cuda"`` both run the fused ``unpack_dft`` and
``dft_pack`` entries.  :func:`valence_conjugates` makes its factors
through the same inverse plan, in the memory layout the inverse leaves its
cubes in, so the product (:func:`pair_density`, in place on the inverse's
output) walks both operands in one order.

While the tracer records, a call runs in an ``mtxel`` span, and the
product in a ``mtxel:product`` device span under it, carrying its
``bands`` and ``bytes``; the ``mtxel`` probe counts the rows multiplied
and the bytes read and written (``product_bands``, ``product_bytes``).
"""
from __future__ import annotations

import math

import torch

from ..core import Domain, fftb, kpoint_sphere, planewave_spec
from ..obs.metrics import global_metrics
from ..obs.trace import get_tracer

#: the products made between the legs: rows multiplied, bytes read and
#: written (the ``mtxel`` probe)
PRODUCTS = {"product_bands": 0, "product_bytes": 0}

global_metrics().register_probe("mtxel", lambda: dict(PRODUCTS))


def cutoff_sphere(d_eps: int):
    """The screened-Coulomb sphere of diameter ``d_eps`` about G = 0: its
    box [0, d_eps)³ holds G + s with s = d_eps // 2 on each axis, the
    shift :func:`valence_conjugates` gives the product, and its centre is
    box index s (``kpoint_sphere``'s centre (d_eps - 1)/2 moved by ½ for
    an even diameter)."""
    d_eps = int(d_eps)
    return kpoint_sphere(d_eps, kpt=(d_eps // 2 - (d_eps - 1) / 2.0,) * 3)


def mtxel_plans(grid, n: int, sphere, sphere_eps, nb: int, *,
                backend: str = "matmul"):
    """(inverse, forward) of the pair densities, from the plan cache: the
    inverse of ``nb`` bands from ``sphere`` to the n³ grid, and the
    forward from the grid onto ``sphere_eps`` (:func:`cutoff_sphere`; the
    mirror of that sphere's inverse, which the plan memoizes).  Every grid
    axis splits the transform (x on the sphere side, Z on the grid), as in
    :func:`~repro_torch.core.make_planewave_pair`'s pair."""
    spec = planewave_spec(fft_axes=tuple(range(grid.ndim)))
    bdom = Domain((0,), (nb - 1,))

    def inverse(s):
        return fftb.plan_for(spec, domains=(bdom, s), grid=grid,
                             sizes=(n,) * 3, inverse=True, backend=backend)
    return inverse(sphere), inverse(sphere_eps).inverse()


def centring_phase(inv, fwd_eps):
    """e^{2πi s·r/n} on the rank's block of ``inv``'s cubes, (X, Y, Z)
    complex64, s the centre of ``fwd_eps``'s sphere: the factor that puts
    the product's G on that sphere's box index G + s.  The centre must lie
    on a grid point (as :func:`cutoff_sphere`'s does)."""
    shift = fwd_eps.sphere.center
    if any(c != round(c) for c in shift):
        raise ValueError(f"the cut-off sphere's centre {shift} is not a grid "
                         "point; make it with cutoff_sphere")
    cube = inv.tout
    n = cube.shape[1]
    dev = inv.grid.device
    k = 0
    for axis, (o, m, s) in enumerate(zip(cube.local_offsets()[1:],
                                         cube.local_shape[1:], shift)):
        r = torch.arange(o, o + m, device=dev) * int(round(s))
        k = k + r.view([-1 if a == axis else 1 for a in range(3)])
    angle = torch.arange(n, device=dev, dtype=torch.float64) * (2 * math.pi / n)
    table = torch.polar(torch.ones_like(angle), angle).to(torch.complex64)
    return table[k % n]


def _empty_as(x, rows: int):
    """An empty tensor of ``rows`` rows of ``x``'s trailing shape, laid
    out in memory as ``x`` is (its dims ordered by stride)."""
    shape = (rows,) + tuple(x.shape[1:])
    order = sorted(range(x.ndim), key=lambda d: -x.stride(d))
    t = torch.empty([shape[d] for d in order], dtype=x.dtype,
                    device=x.device)
    return t.permute(*(order.index(d) for d in range(x.ndim)))


def valence_conjugates(inv, fwd_eps, c_v):
    """conj(ψ_v)·e^{2πi s·r/n} of packed valence rows ``c_v`` (nv,
    npacked): the rank's block of the real-space cubes, (nv, n, n, n)
    complex64, through the inverse plan ``inv`` (its batch at a time, the
    last block padded with zero rows), times :func:`centring_phase` for
    the forward ``fwd_eps``, and laid out as ``inv`` leaves its cubes.

    The rows must be whole on each rank: a grid whose batch axes split
    them would give each rank only some of the valence bands."""
    side = inv.tin
    rows = side.shape[0]
    if side.local_shape[0] != rows:
        raise ValueError("valence_conjugates needs the plan's rows whole on "
                         "each rank; its batch axes split them")
    phase = centring_phase(inv, fwd_eps)
    nv = c_v.shape[0]
    out = None
    for v0 in range(0, nv, rows):
        blk = c_v[v0:v0 + rows]
        k = blk.shape[0]
        if k < rows:
            blk = torch.cat([blk, blk.new_zeros((rows - k, blk.shape[1]))])
        psi = inv.unpack_transform(blk)[:k]
        if out is None:
            out = _empty_as(psi, nv)
        out[v0:v0 + k].copy_(psi.conj_physical_().mul_(phase))
        del psi
    return out


def _product(psi, vconj):
    """psi · vconj, in place on ``psi`` where its dtype holds the result
    and no gradient is asked of it; counted, and timed on the device."""
    nbytes = (2 * psi.numel() + vconj.numel()) * psi.element_size()
    PRODUCTS["product_bands"] += psi.shape[0]
    PRODUCTS["product_bytes"] += nbytes
    in_place = (psi.dtype == torch.promote_types(psi.dtype, vconj.dtype)
                and not (psi.requires_grad and torch.is_grad_enabled()))
    with get_tracer().device_span("mtxel:product", bands=psi.shape[0],
                                  bytes=nbytes) as sp:
        return sp.sync(psi.mul_(vconj) if in_place else psi * vconj)


def pair_density(inv, fwd_eps, c_c, vconj):
    """M_vc on the cut-off sphere for a block of conduction bands against
    one valence band: ``pack_eps(F(vconj · F⁻¹(unpack(c_c))))``, lane i
    holding the G of the sphere's box index minus its centre.

    ``c_c``: (nb, npacked) packed conduction coefficients on ``inv``'s
    sphere (the plan's whole batch); ``vconj``: the rank's (n, n, n) block
    of one row of :func:`valence_conjugates` for ``fwd_eps``.  Returns
    (nb, npacked_eps).  The plans are :func:`mtxel_plans`'s; their fused
    entries run on the "cuda" backend, and the product is made in place
    on the inverse's output."""
    with get_tracer().span("mtxel", bands=c_c.shape[0]) as sp:
        psi = _product(inv.unpack_transform(c_c), vconj)
        return sp.sync(fwd_eps.transform_pack(psi))
