"""Process-grid selection for the DFT workload (the port of the
reference's ``sharding/grids.py``): 1D fft, 2D batch×fft, or
3-axis (batch, fft, fft) pencil grids.

The paper's §3.3 argument: once the fft axes saturate what the sphere
diameter can absorb (an all_to_all needs the moved dim divisible by the
axis size, and message sizes shrink linearly with it), the *batch*
dimension — bands, and k-points stacked with them — is the axis that keeps
scaling.  A single fft axis saturates quickly though (``pf ≤
diameter / max_fft_fraction``), which is exactly why pencil-style 2D fft
decompositions are the canonical scale-out shape (P3DFFT, and the flexible
schedules this repo reproduces): splitting the transform over *two* grid
axes multiplies the feasible fft parallelism while each individual
all_to_all still moves dims divisible by its own (small) axis size.
``choose_dft_grid`` encodes that ladder so benchmarks, examples and
services don't each hand-roll mesh shapes:

  * few devices relative to the sphere diameter → 1D fft grid (one
    transpose, biggest messages);
  * more devices → (batch, fft) 2D grid with the largest fft factor that
    keeps per-device pencils thick, the rest of the machine on the batch
    axis — provided the band count divides it, and preferring splits whose
    batch factor also carries the ``nk·nbands`` *stacked* batch;
  * when a (batch, fft, fft) **pencil** split reaches strictly more fft
    parallelism than any single fft axis can (``pf1·pf2`` devices on the
    transforms instead of ``pf``), the 3-axis grid wins: each fft axis
    keeps the per-axis pencil rule ``pf_i · max_fft_fraction ≤ diameter``,
    the sphere dim carries both axes (so ``diameter % (pf1·pf2) == 0``),
    and the batch factor still divides ``nbands``.  Falling back: pencil →
    2D → 1D, with the same k-stackable preference at every tier.
"""
from __future__ import annotations

from ..core.grid import ProcGrid

#: default mesh-axis names for the DFT grids built here
DFT_AXES_3D = ("dft_b", "dft_f1", "dft_f2")
DFT_AXES_2D = ("dft_b", "dft_f")
DFT_AXES_1D = ("dft_f",)


def _fft_factors(diameter: int, max_fft_fraction: int) -> list[int]:
    """fft-axis sizes keeping per-device pencils ≥ max_fft_fraction lines."""
    return [f for f in range(diameter, 1, -1)
            if diameter % f == 0 and f * max_fft_fraction <= diameter]


def choose_dft_grid_shape(ndevices: int, *, nbands: int, diameter: int,
                          nk: int = 1,
                          max_fft_fraction: int = 4) -> tuple[int, ...]:
    """Pick a grid shape (1-, 2- or 3-tuple) for ``ndevices``.

    1D ``(ndevices,)`` while ``ndevices · max_fft_fraction ≤ diameter``
    (per-device pencils stay ≥ ``max_fft_fraction`` lines thick).  Beyond
    that, the 2D split ``(pb, pf)`` with the largest feasible fft factor
    ``pf`` (divides both ``ndevices`` and ``diameter``, keeps the pencil
    rule) whose batch factor ``pb = ndevices // pf`` divides ``nbands`` —
    the per-k sphere plans always batch exactly ``nbands`` bands, so this
    is a hard ``PlaneWaveBasis`` requirement.

    **Pencil tier**: when a 3-axis ``(pb, pf1, pf2)`` split puts strictly
    more devices on the transforms than the best single fft axis can
    (``pf1·pf2 > pf``), it wins.  Feasibility per candidate: each
    ``pf_i ≥ 2`` keeps the per-axis pencil rule
    ``pf_i · max_fft_fraction ≤ diameter`` and divides ``diameter``; the
    sphere dim is sharded over both axes on the input side, so
    ``diameter % (pf1·pf2) == 0``; and ``pb ≥ 2`` divides ``nbands``
    (a pencil split with ``pb == 1`` is never preferred over the 2D
    split — a second fft axis costs an extra all_to_all round, so it
    must buy parallelism the batch axis cannot).  Among candidates the
    largest ``pf1·pf2`` wins, squarer splits break ties.

    Among qualifying splits at every tier, one that satisfies the
    ``basis.stacks_k`` contract — ``nk | pb`` and ``pb | nk·nbands``, so
    the stacked nk·nbands Hamiltonian/density batch shards evenly — is
    preferred (it engages the batched band-update engine).  The
    degradation ladder when the preferences cannot be met: a qualifying
    split whose ``pb`` the k-point count does not divide still wins over
    the next tier down (the basis then runs the pipelined per-k fallback
    on it, ``stacks_k`` False — though segmented stacking often restores
    the stacked route anyway), and when no split divides at all — prime
    device counts, ``nbands`` smaller than or coprime to every feasible
    ``pb`` — the chooser falls back to ``(ndevices,)`` (the basis's own
    divisibility checks then produce the actionable error).
    """
    if ndevices < 1:
        raise ValueError(f"ndevices must be >= 1, got {ndevices}")
    if ndevices == 1 or ndevices * max_fft_fraction <= diameter:
        return (ndevices,)
    fft_cands = [f for f in range(ndevices, 0, -1)
                 if ndevices % f == 0 and diameter % f == 0
                 and f * max_fft_fraction <= diameter]
    valid: list[tuple[int, int]] = []
    best_pf = 0
    for pf in fft_cands:
        pb = ndevices // pf
        if pb == 1:
            return (pf,)                # whole machine fits on one fft axis
        if nbands % pb == 0:
            valid.append((pb, pf))
            best_pf = max(best_pf, pf)

    # pencil tier: (pb, pf1, pf2) beating the best single-axis fft factor
    pencil: list[tuple[int, int, int]] = []
    axis_cands = _fft_factors(diameter, max_fft_fraction)
    for pf1 in axis_cands:
        for pf2 in (f for f in axis_cands if f <= pf1):
            prod = pf1 * pf2
            if prod <= best_pf:
                continue                # no more fft parallelism than 2D
            if ndevices % prod or diameter % prod:
                continue                # sphere dim carries both axes
            pb = ndevices // prod
            if pb < 2 or nbands % pb:
                continue
            pencil.append((pb, pf1, pf2))
    # largest fft coverage first; squarer split (larger minor axis) on ties
    pencil.sort(key=lambda s: (-(s[1] * s[2]), -s[2]))
    for pb, pf1, pf2 in pencil:         # prefer k-stackable batch axes
        if nk > 1 and pb % nk == 0:
            return (pb, pf1, pf2)
    if pencil:
        return pencil[0]

    for pb, pf in valid:                # prefer k-stackable batch axes:
        # nk | pb puts whole k-points on each shard; pb | nk·nbands (the
        # stacked H/density batch) already follows from pb | nbands above,
        # so this is the full basis.stacks_k contract
        if nk > 1 and pb % nk == 0:
            return (pb, pf)
    if valid:
        return valid[0]
    return (ndevices,)


def _process_count() -> int:
    """Processes in the default process group, else 1.

    The port runs one process per card, so the grid's size is the number
    of processes, not ``torch.cuda.device_count()`` (one process on an
    eight-card box still drives one card).
    """
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def choose_dft_grid(ndevices: int | None = None, *, nbands: int,
                    diameter: int, nk: int = 1, max_fft_fraction: int = 4,
                    device=None) -> ProcGrid:
    """Build the ProcGrid ``choose_dft_grid_shape`` picks.

    ``ndevices`` defaults to the number of processes
    (``torch.distributed.get_world_size()`` when a process group is up,
    else 1).  A shape of several points is built over the default process
    group (:meth:`ProcGrid.create`: its world must have exactly that many
    ranks, and every rank calls this alike).  ``device`` is the rank's
    device (CUDA when omitted; see
    :func:`~repro_torch.core.grid.resolve_device`).
    """
    nd = int(ndevices) if ndevices is not None else _process_count()
    shape = choose_dft_grid_shape(nd, nbands=nbands, diameter=diameter,
                                  nk=nk, max_fft_fraction=max_fft_fraction)
    names = {1: DFT_AXES_1D, 2: DFT_AXES_2D, 3: DFT_AXES_3D}[len(shape)]
    return ProcGrid.create(list(shape), list(names), device=device)
