"""Kohn-Sham Hamiltonian apply + band updates — per k-point or k-stacked.

H is applied in the packed sphere basis:

    (H c)_G = ½|G+k|² c_G  +  pack( fft( v_eff(r) · ifft(unpack(c)) ) )

— kinetic is diagonal on packed coefficients, the local potential is a
batched sphere→cube→sphere round-trip (inverse plan, pointwise multiply,
derived forward plan).  Bands ride the plans' batch dimension, so one H
apply per k-point is two batched transforms regardless of the band count.
:func:`apply_hamiltonian_stacked` pushes *all* nk·nbands orbitals through
one ragged padded batch, so the whole sweep is two transforms regardless
of nk as well.

The band update is preconditioned all-band descent in its locally-optimal
form (LOBPCG without the history block): each step does a Rayleigh-Ritz
solve in the 2·nb-dimensional span of the current bands and their
preconditioned residuals.  The preconditioner is the Teter-style kinetic
damping 1/(1 + ½|G+k|²).

Two band-update engines share that math:

  * the **per-k** path (``update_bands`` / the pipelined loop inside
    ``update_bands_all_k``) runs the Gram builds, Rayleigh-Ritz solves
    and orthonormalizations k-point by k-point — the fallback and
    equivalence oracle;
  * the **stacked** engine (:func:`update_bands_stacked`) runs them as
    batched einsums / batched ``eigh``/``qr`` over one padded
    ``(nk, nbands, npacked_max)`` coefficient tensor, with the kinetic
    and preconditioner served as dense per-k tables.  Padded lanes hold
    exact zeros in coefficients, H·c blocks and tables alike.

On a multi-process grid the coefficient blocks are replicated (every rank
holds all of them and runs the same linear algebra); an H apply hands the
plans the rank's rows, multiplies the rank's z-block of ``v_eff``, and
gathers the packed result over the batch axes (the plan's
``gather_rows``: the reference pins every block it mixes with a plan's
output with ``grid.replicate``; here the plan's packed output is the
only block that is not already whole, so it is gathered once, where it
leaves the plan).
"""
from __future__ import annotations

import torch

from ..core.hostsync import host_sync
from ..obs.metrics import global_metrics
from ..obs.trace import get_tracer

#: process-wide count of per-k eager linalg calls (descent-direction
#: builds and Rayleigh-Ritz solves dispatched for a single k-point) —
#: lets tests assert the stacked engine performs zero of them.
PERK_LINALG_CALLS = 0

global_metrics().register_probe(
    "dft", lambda: {"per_k_linalg_calls": PERK_LINALG_CALLS})


def apply_hamiltonian(basis, ik: int, c, v_eff):
    """H·c for one k-point block c of shape (nbands, npacked_k).

    ``v_eff`` is the real effective local potential: the (n, n, n) cube,
    the rank's z-block of it on a multi-process grid.  Plans are fetched
    through the plan cache on every call.
    """
    inv, fwd = basis.plans_for_k(ik)
    kin = basis.kinetic(ik)
    psi = inv(inv.unpack(inv.local_rows(c)))  # sphere → real space, batched
    vpsi = fwd(psi * v_eff)                   # apply V, truncate back
    return kin[None, :] * c + inv.gather_rows(inv.pack(vpsi))


def apply_hamiltonian_pipelined(basis, blocks, v_eff):
    """H·c for *all* k-points, k+1's inverse transform issued before k's
    potential apply (on an asynchronous device the next k's transform is
    queued while the current k's cube multiply runs).  Per-k operations
    and their order are those of :func:`apply_hamiltonian`.

    ``blocks``: list of (nbands, npacked_k) coefficient blocks, one per k.
    Returns the list of H·c blocks in k order.
    """
    nk = len(blocks)
    if nk == 0:
        return []
    plans = [basis.plans_for_k(ik) for ik in range(nk)]

    def inverse(ik):
        inv = plans[ik][0]
        return inv(inv.unpack(inv.local_rows(blocks[ik])))

    psi = inverse(0)                          # prologue: k=0 in flight
    out = []
    for ik in range(nk):
        psi_next = None
        if ik + 1 < nk:                       # issue k+1's transform first …
            psi_next = inverse(ik + 1)
        inv, fwd = plans[ik]                  # … then apply V for k
        vpsi = fwd(psi * v_eff)
        out.append(basis.kinetic(ik)[None, :] * blocks[ik]
                   + inv.gather_rows(inv.pack(vpsi)))
        psi = psi_next
    return out


def apply_hamiltonian_padded(basis, c_pad, v_eff, kin_pad=None,
                             seg: int = 0):
    """H·c on one segment's padded ``(nk_seg, nbands, pad_width)`` stack.

    The core of the stacked route: one batched inverse transform, one
    cube-space ``v_eff`` multiply, one batched forward — two transforms
    for every k-point and band at once — plus the dense padded kinetic
    diagonal applied as a broadcast multiply.  Padded lanes stay exact
    zeros.

    The sphere↔cube legs go through the plans' fused entry points
    (``unpack_transform`` / ``transform_pack``): with ``backend="cuda"``
    these run the unpack + first iDFT stage and the last DFT stage + pack
    as the fused sphere-pack kernels (no d³ cube ever materialized); on
    every other backend they compose ``unpack``/plan/``pack``.  On a
    multi-process grid the plans run on the rank's rows of ``c_pad`` and
    its z-block ``v_eff``, and the packed result is gathered over the batch
    axes, so the H·c stack comes back replicated like ``c_pad``.
    """
    if kin_pad is None:
        kin_pad = basis.stacked_band_tables(seg).kinetic
    inv, fwd = basis.stacked_hamiltonian_plans(seg)
    nk, nb, npm = c_pad.shape
    psi = inv.unpack_transform(inv.local_rows(c_pad.reshape(nk * nb, npm)))
    vc = fwd.gather_rows(fwd.transform_pack(psi * v_eff))
    return kin_pad[:, None, :] * c_pad + vc.reshape(nk, nb, npm)


def apply_hamiltonian_stacked(basis, blocks, v_eff):
    """H·c for *all* k-points in ragged stacked batches, one per segment.

    Each segment's bands ride a single ``(nk_seg·nbands, pad_width)``
    padded batch through the basis's ``StackedPlaneWaveFFT`` pair
    (:func:`apply_hamiltonian_padded`).  Per-orbital math is that of
    :func:`apply_hamiltonian`.

    ``blocks``: list of (nbands, npacked_k) coefficient blocks, one per k.
    Returns the list of H·c blocks in k order.
    """
    if len(blocks) == 0:
        return []
    out = [None] * len(blocks)
    for s, seg in enumerate(basis.segments):
        inv, _ = basis.stacked_hamiltonian_plans(s)
        c_pad = inv.stack([blocks[ik] for ik in seg]).reshape(
            len(seg), inv.nbands, inv.npacked_max)
        hc = apply_hamiltonian_padded(basis, c_pad, v_eff, seg=s)
        hcs = inv.split(hc.reshape(len(seg) * inv.nbands, inv.npacked_max))
        for j, ik in enumerate(seg):
            out[ik] = hcs[j]
    return out


def orthonormalize(c):
    """QR re-orthonormalization; bands are rows of c."""
    q, r = torch.linalg.qr(c.T)
    # fix the phase so the update is continuous across iterations
    ph = torch.sign(torch.diagonal(r).real + 1e-30)
    return (q * ph[None, :]).T


def _pad_lanes(x, npm: int):
    """Zero-pad the packed-coefficient axis of ``x`` to ``npm`` lanes, so
    the per-k oracle contracts over the same lane count as the stacked
    engine."""
    return torch.nn.functional.pad(x, (0, npm - x.shape[-1]))


def _padded_precond(basis, ik: int):
    """Per-k Teter damping row, zero-padded to the k's segment lane width
    (the same f32 ``1/(1 + kinetic)`` arithmetic as the stacked
    ``precond`` table row)."""
    pre = 1.0 / (1.0 + basis.kinetic(ik))
    return torch.nn.functional.pad(pre, (0, basis.pad_width(ik)
                                         - pre.shape[0]))


def update_bands(basis, ik: int, c, v_eff, *, steps: int = 3):
    """Locally-optimal preconditioned band update for k-point ``ik``.

    Per step: residuals r_b = (H − λ_b)c_b, preconditioned and
    orthonormalized against the bands, then a Rayleigh-Ritz solve in
    span{c, P r} keeps the lowest ``nbands`` vectors.  Two batched H
    applies per step; the linalg runs as singleton-batch dispatches of the
    stacked kernels over lanes padded to the k's segment width.

    Returns (rotated coefficients, eigenvalues ascending, n_h_applies).
    """
    npm = basis.pad_width(ik)
    pre = _padded_precond(basis, ik)
    napply = 0
    eps = None
    for _ in range(steps):
        hc = apply_hamiltonian(basis, ik, c, v_eff)
        napply += 1
        d = _descent_direction(c, hc, pre, npm)
        hd = apply_hamiltonian(basis, ik, d, v_eff)
        napply += 1
        c, eps = _rayleigh_ritz(c, d, hc, hd, npm)
    return c, eps, napply


def _descent_direction(c, hc, pre, npm: int):
    """Per-k preconditioned residual block, orthogonal to the bands —
    a singleton-batch dispatch of :func:`_descent_direction_stacked`,
    counted by ``PERK_LINALG_CALLS``.  Returns the unpadded block."""
    global PERK_LINALG_CALLS
    PERK_LINALG_CALLS += 1
    npk = c.shape[-1]
    d = _descent_direction_stacked(_pad_lanes(c, npm)[None],
                                   _pad_lanes(hc, npm)[None], pre[None])
    return d[0, :, :npk]


def _rayleigh_ritz(c, d, hc, hd, npm: int):
    """Per-k lowest-nb Ritz vectors of span{c, d}; (c', eps ascending) —
    a singleton-batch dispatch of :func:`_rayleigh_ritz_stacked`, counted
    by ``PERK_LINALG_CALLS``."""
    global PERK_LINALG_CALLS
    PERK_LINALG_CALLS += 1
    npk = c.shape[-1]
    cp, eps = _rayleigh_ritz_stacked(
        _pad_lanes(c, npm)[None], _pad_lanes(d, npm)[None],
        _pad_lanes(hc, npm)[None], _pad_lanes(hd, npm)[None])
    return cp[0, :, :npk], eps[0]


# ------------------------------------------------- stacked (batched) engine
def _orthonormalize_stacked(c):
    """Batched QR re-orthonormalization over (nk, nbands, npacked_max).

    Householder QR keeps the zero rows of padded lanes exactly zero, so
    padding survives the batched solve untouched.
    """
    q, r = torch.linalg.qr(c.transpose(-1, -2))          # (nk, np, nb)
    ph = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1).real
                    + 1e-30)                             # (nk, nb)
    return (q * ph[:, None, :]).transpose(-1, -2)


def _descent_direction_stacked(c, hc, pre):
    """Batched preconditioned residuals, orthogonal to the current bands:
    Rayleigh quotients, the projected gradient, and the projection of
    span{c} out of the preconditioned block.  ``pre`` is the masked table,
    so padded lanes come out exact zeros."""
    lam = torch.sum(c.conj() * hc, dim=-1).real          # (nk, nb)
    grad = hc - lam[..., None] * c
    d = pre[:, None, :] * grad
    ovl = torch.einsum("kip,kjp->kij", c.conj(), d)      # ⟨c_i|d_j⟩ per k
    return _orthonormalize_stacked(
        d - torch.einsum("kij,kip->kjp", ovl, c))


def _rayleigh_ritz_stacked(c, d, hc, hd):
    """Batched lowest-nb Ritz vectors of span{c, d} for every k at once:
    one (nk, 2nb, 2nb) blocked Gram build, one nk-batched ``eigh``, one
    batched back-rotation.  Returns (c', eps) with eps ascending per k.

    ``torch.linalg.eigh`` reads its solver status on the host (its error
    check), so it is the band update's one host sync; it goes through
    :func:`~repro_torch.core.hostsync.host_sync`, which runs it between
    two CUDA graphs when the fused SCF step is captured."""
    nb = c.shape[1]
    bb = torch.cat([c, d], dim=1)                        # (nk, 2nb, np)
    hb = torch.cat([hc, hd], dim=1)
    hmat = torch.einsum("kip,kjp->kij", bb.conj(), hb)
    hmat = 0.5 * (hmat + hmat.transpose(-1, -2).conj())
    eps, vecs = host_sync("linalg.eigh", torch.linalg.eigh,
                          hmat)                          # nk-batched solve
    new = torch.einsum("kin,kip->knp", vecs[:, :, :nb], bb)
    return _orthonormalize_stacked(new), eps[:, :nb]


def update_bands_stacked(basis, c_pad, v_eff, *, steps: int = 3,
                         tables=None, seg: int = 0):
    """Locally-optimal band update on one segment's padded
    (nk_seg, nbands, pad_width) coefficient stack — every stage batched
    over the segment's k-points.

    Each step is two stacked H sweeps (:func:`apply_hamiltonian_padded`),
    one batched descent-direction build, and one nk-batched blocked
    Rayleigh-Ritz solve — none of them per-k.

    Returns (updated stack, eigenvalues (nk, nbands) ascending per k,
    H sweeps executed).
    """
    if tables is None:
        tables = basis.stacked_band_tables(seg)
    kin, pre = tables.kinetic, tables.precond
    c = c_pad
    eps = None
    nsweep = 0
    for _ in range(steps):
        hc = apply_hamiltonian_padded(basis, c, v_eff, kin, seg=seg)
        nsweep += 1
        d = _descent_direction_stacked(c, hc, pre)
        hd = apply_hamiltonian_padded(basis, d, v_eff, kin, seg=seg)
        nsweep += 1
        c, eps = _rayleigh_ritz_stacked(c, d, hc, hd)
    return c, eps, nsweep


def update_bands_all_k(basis, coeffs, v_eff, *, steps: int = 3,
                       stacked: bool | None = None):
    """All-k locally-optimal band update — stacked engine or pipelined per-k.

    ``stacked=None`` (the default) routes through
    :func:`update_bands_stacked` when ``basis.stacks_k`` and through the
    pipelined per-k loop otherwise; pass True/False to force a path.
    Because no arithmetic crosses k-points, both routes match running
    ``update_bands`` serially per k.

    Returns (new coefficient blocks, eigenvalues list [(nbands,)] per k,
    H sweeps executed — each sweep is one H apply per k-point).
    """
    nk = len(coeffs)
    if stacked is None:
        stacked = bool(getattr(basis, "stacks_k", False))
    if stacked:
        cs = [None] * nk
        eps_out = [None] * nk
        nsweep = 0
        with get_tracer().span("band_update", route="stacked", nk=nk,
                               steps=steps, segments=len(basis.segments)):
            for s, seg in enumerate(basis.segments):
                inv, _ = basis.stacked_hamiltonian_plans(s)
                c_pad = inv.stack([coeffs[ik] for ik in seg]).reshape(
                    len(seg), inv.nbands, inv.npacked_max)
                c_pad, eps, nsweep = update_bands_stacked(
                    basis, c_pad, v_eff, steps=steps, seg=s)
                outs = inv.split(c_pad.reshape(len(seg) * inv.nbands,
                                               inv.npacked_max))
                for j, ik in enumerate(seg):
                    cs[ik] = outs[j]
                    eps_out[ik] = eps[j]
        return cs, eps_out, nsweep
    cs = list(coeffs)
    npms = [basis.pad_width(ik) for ik in range(nk)]
    pres = [_padded_precond(basis, ik) for ik in range(nk)]
    eps_out = [None] * nk
    nsweep = 0
    for _ in range(steps):
        hcs = apply_hamiltonian_pipelined(basis, cs, v_eff)
        nsweep += 1
        ds = [_descent_direction(cs[ik], hcs[ik], pres[ik], npms[ik])
              for ik in range(nk)]
        hds = apply_hamiltonian_pipelined(basis, ds, v_eff)
        nsweep += 1
        for ik in range(nk):
            cs[ik], eps_out[ik] = _rayleigh_ritz(cs[ik], ds[ik], hcs[ik],
                                                 hds[ik], npms[ik])
    return cs, eps_out, nsweep
