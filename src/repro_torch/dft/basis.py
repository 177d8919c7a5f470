"""Per-k-point plane-wave bases — a batch of *different* spheres.

Every k-point carries its own cut-off sphere: the Bloch factor e^{ik·r}
shifts the kinetic-energy paraboloid, so the set of plane waves with
½|G+k|² ≤ E_cut is a sphere whose *center* moves with k (paper §2.2 — "one
sphere per k-point, bands batched within each").  All spheres share one
d³ bounding box and one n³ FFT cube, so every k-point's transform has the
same data layout but a *different* static pack/unpack table — the
multi-plan traffic the process-global ``PlanCache`` exists for.

Processing grids (paper §3.3): the basis runs on 1D fft-only grids *or*
2D (batch × fft) and 3-axis pencil (batch, fft, fft) grids over several
processes.  The band batch is sharded over the batch axes and only the fft
axes carry the transforms' all-to-alls.  The tables built here (spheres,
kinetic ladders, pack tables) are the same on every rank, so each rank
builds them on its own, with no collective.

Units: cubic cell of side ``L`` (default: ``n`` grid spacings of 1), so a
reciprocal-lattice step is 2π/L.  k-points are given in reduced coordinates
(units of 2π/L).  The sphere is centered at c_k = c0 + k, and the kinetic
energy of packed coefficient at cube index ``idx`` is
½(2π/L)²|idx − c_k|².
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..check.diagnostics import raise_if_errors
from ..check.preflight import preflight_basis
from ..core import (Domain, ProcGrid, cube_spec, fftb, global_plan_cache,
                    kpoint_sphere, make_stacked_planewave_pair,
                    padded_kinetic_table, planewave_spec,
                    segment_padding_fraction, segment_spheres,
                    sphere_gvectors, sphere_kinetic_row)
from ..core.cache import domains_key, grid_key
from ..core.dtensor import DistTensor
from ..core.policy import ExecPolicy

#: sphere bounding-cube (bands, x, y, z) → real-space cube, x/Z sharded
PW_SPEC = planewave_spec()
#: full density/potential cube, real space (z-sharded) → G space (Z-sharded)
CUBE_SPEC = cube_spec()


@dataclasses.dataclass(frozen=True)
class StackedBandTables:
    """Dense per-k tables for the batched band-update engine.

    All three are ``(nk, npacked_max)`` float32 tensors with **exact zeros**
    on padded lanes, so padded lanes contribute exact zeros to every Gram
    matrix, energy and preconditioned residual without runtime masking:

      * ``kinetic``  — ½|G+k|² diagonal (bitwise-equal to the per-k
        :meth:`PlaneWaveBasis.kinetic` ladders on valid lanes),
      * ``mask``     — lane validity as {0.0, 1.0},
      * ``precond``  — the masked Teter-style damping mask/(1 + ½|G+k|²).
    """

    kinetic: torch.Tensor
    mask: torch.Tensor
    precond: torch.Tensor

    # ------------------------------------------- PlanCache accounting
    def private_bytes(self) -> int:
        return sum(int(a.nbytes)
                   for a in (self.kinetic, self.mask, self.precond))

    def shared_table_bytes(self) -> dict:
        return {}

    def estimated_bytes(self) -> int:
        return self.private_bytes()


class PlaneWaveBasis:
    """Shared FFT cube + per-k-point spheres, plans served from the cache.

    Plans are *not* stored on the instance: ``plans_for_k``/``cube_plans``
    go through ``fftb.plan_for`` (the process-global ``PlanCache``) on every
    call, so plan reuse across SCF iterations is the cache's hit counter.
    Derived mirrors are memoized on the plan itself (``inverse()``).

    ``device`` picks the device of the default one-device grid (CUDA when
    omitted; raises without CUDA).  A ``grid`` given explicitly brings its
    own device.
    """

    def __init__(self, n: int, *, diameter: int | None = None,
                 kpts=((0.0, 0.0, 0.0),), weights=None, nbands: int = 4,
                 L: float | None = None, grid: ProcGrid | None = None,
                 batch_axes: tuple[int, ...] | None = None,
                 fft_axes: tuple[int, ...] | None = None,
                 segment_padding: float | None = None,
                 policy: ExecPolicy | None = None,
                 backend: str | None = None, device=None):
        self.n = int(n)
        self.d = int(diameter) if diameter is not None else self.n // 2
        self.L = float(L) if L is not None else float(n)
        self.grid = grid if grid is not None else \
            ProcGrid.create([1], device=device)
        self.device = self.grid.device
        self.nbands = int(nbands)
        self.policy = policy
        # backend resolution ladder: explicit argument > policy preference
        # > the "matmul" default
        if backend is None:
            backend = policy.backend if policy is not None and \
                policy.backend is not None else "matmul"
        self.backend = backend

        if batch_axes is None:
            batch_axes = () if self.grid.ndim == 1 else (0,)
        self.batch_axes = tuple(batch_axes)
        if fft_axes is None:
            fft_axes = tuple(a for a in range(self.grid.ndim)
                             if a not in self.batch_axes)
        self.fft_axes = tuple(fft_axes)
        # coded preflight diagnostics (FFTB110–118, 120), as the
        # reference's constructor runs them; DiagnosticError is a
        # ValueError, so existing handlers keep working
        raise_if_errors(preflight_basis(
            self.n, diameter=self.d, kpts=kpts, nbands=self.nbands,
            grid=self.grid, batch_axes=self.batch_axes,
            fft_axes=self.fft_axes, segment_padding=segment_padding,
            backend=self.backend))
        self.batch_procs = math.prod(
            self.grid.axis_size(a) for a in self.batch_axes)
        self.fft_procs = math.prod(
            self.grid.axis_size(a) for a in self.fft_axes)
        self._pw_spec = planewave_spec(self.batch_axes, self.fft_axes)
        self._cube_spec = cube_spec(self.fft_axes)

        self.kpts = np.atleast_2d(np.asarray(kpts, np.float64))
        nk = self.kpts.shape[0]
        if weights is None:
            self.weights = np.full(nk, 1.0 / nk)
        else:
            self.weights = np.asarray(weights, np.float64)
            if self.weights.shape != (nk,):
                raise ValueError("one weight per k-point")
            self.weights = self.weights / self.weights.sum()

        self.spheres = [kpoint_sphere(self.d, kp) for kp in self.kpts]
        self.bdom = Domain((0,), (self.nbands - 1,))
        self.cube = Domain((0, 0, 0), (self.n - 1,) * 3)
        #: the real-space field's distribution (ρ, potentials): z over
        #: the fft axes, as the cube plans take it; replicated over the
        #: batch axes
        self.field = DistTensor.create(
            self.cube, self._cube_spec.split(" -> ")[0], self.grid)
        self._kin = [None] * nk
        self._gvec = [None] * nk
        self._occ_weights: dict[tuple, torch.Tensor] = {}

        self.segment_padding = (float(segment_padding)
                                if segment_padding is not None else None)
        if self.segment_padding is None:
            self.segments: tuple[tuple[int, ...], ...] = (tuple(range(nk)),)
        else:
            div = self.batch_procs if self.batch_procs > 1 else None
            self.segments = segment_spheres(
                self.spheres, self.segment_padding, size_divisor=div)
        self._seg_of = [0] * nk
        for s, seg in enumerate(self.segments):
            for i in seg:
                self._seg_of[i] = s

    # ----------------------------------------------------------------- size
    @property
    def nk(self) -> int:
        return self.kpts.shape[0]

    @property
    def cell_volume(self) -> float:
        return self.L ** 3

    @property
    def dv(self) -> float:
        """Real-space integration element ΔV = Ω / n³."""
        return (self.L / self.n) ** 3

    def npacked(self, ik: int) -> int:
        return self.spheres[ik].npacked

    @property
    def npacked_max(self) -> int:
        """max_k npacked(k) — the padded lane count of the stacked batch."""
        return max(s.npacked for s in self.spheres)

    # ------------------------------------------------------------ segments
    @property
    def nsegments(self) -> int:
        return len(self.segments)

    def seg_of(self, ik: int) -> int:
        """Index of the segment k-point ``ik`` stacks into."""
        return self._seg_of[ik]

    def pad_width(self, ik: int) -> int:
        """Padded lane count of k-point ``ik``'s segment — both band-update
        engines contract their linalg over exactly this many lanes."""
        seg = self.segments[self._seg_of[ik]]
        return max(self.spheres[i].npacked for i in seg)

    @property
    def padding_fraction(self) -> float:
        """Padded lanes / total lanes over all segments."""
        used = sum(s.npacked for s in self.spheres)
        lanes = sum(len(seg) * max(self.spheres[i].npacked for i in seg)
                    for seg in self.segments)
        return 1.0 - used / float(lanes)

    @property
    def segment_padding_fractions(self) -> tuple[float, ...]:
        """Realized per-segment padding — each ≤ ``segment_padding``."""
        return tuple(segment_padding_fraction(self.spheres, seg)
                     for seg in self.segments)

    @property
    def stacks_k(self) -> bool:
        """True when k-points stack into the transforms' batch dimension
        on their own (a batch×fft grid whose batch axes split every
        segment's stacked batch evenly).  On one device this is False;
        ``SCFConfig(stack_k=True)`` forces the stacked H sweeps anyway."""
        return (bool(self.batch_axes) and self.nk > 1
                and self.batch_procs > 1
                and all(self.batch_procs % len(seg) == 0
                        and (len(seg) * self.nbands) % self.batch_procs == 0
                        for seg in self.segments))

    def field_sum(self, x) -> float:
        """Σ over the whole cube of a field given as the rank's block
        (the sum over the fft axes of the local sums)."""
        return self.grid.all_reduce_host(float(torch.sum(x)), self.fft_axes)

    # ------------------------------------------------------- G bookkeeping
    def gvectors(self, ik: int) -> np.ndarray:
        """(npacked, 3) G+k offsets from the sphere center, in units 2π/L."""
        if self._gvec[ik] is None:
            self._gvec[ik] = sphere_gvectors(self.spheres[ik])
        return self._gvec[ik]

    def kinetic(self, ik: int):
        """½|G+k|² diagonal over packed coefficients (f32, on device)."""
        if self._kin[ik] is None:
            self._kin[ik] = torch.as_tensor(
                sphere_kinetic_row(self.spheres[ik], self.L),
                device=self.device)
        return self._kin[ik]

    # ----------------------------------------------------------------- plans
    def plans_for_k(self, ik: int):
        """(inverse, forward) sphere↔cube pair for k-point ``ik``, served
        from the process-global PlanCache."""
        inv = fftb.plan_for(
            self._pw_spec, domains=(self.bdom, self.spheres[ik]),
            grid=self.grid, sizes=(self.n,) * 3, inverse=True,
            backend=self.backend, policy=self.policy)
        return inv, inv.inverse()       # mirror is memoized on the plan

    def _seg_spheres(self, seg: int):
        """The segment's spheres, in segment (stack) order."""
        return tuple(self.spheres[i] for i in self.segments[seg])

    def stacked_inverse_plan(self, seg: int = 0):
        """One d³→n³ inverse plan batching segment ``seg``'s orbitals."""
        nks = len(self.segments[seg])
        bdom = Domain((0,), (nks * self.nbands - 1,))
        bbox = Domain((0, 0, 0), (self.d - 1,) * 3)
        return fftb.plan_for(
            self._pw_spec, domains=(bdom, bbox), grid=self.grid,
            sizes=(self.n,) * 3, inverse=True, backend=self.backend,
            policy=self.policy)

    def stacked_hamiltonian_plans(self, seg: int = 0):
        """(inverse, forward) ragged-batch stacked pair for the H apply.

        One ``StackedPlaneWaveFFT`` pair batching segment ``seg``'s
        nk_seg·nbands orbitals, served from the process-global PlanCache
        keyed by the segment's sphere set; the inner d³→n³ plan is
        :meth:`stacked_inverse_plan`.
        """
        spheres = self._seg_spheres(seg)
        cache = global_plan_cache()
        key = ("stacked-pw", self._pw_spec,
               domains_key(spheres), (len(spheres), self.nbands),
               grid_key(self.grid), (self.n,) * 3, self.backend,
               self.policy)
        inv = cache.get_or_build(
            key, lambda: make_stacked_planewave_pair(
                self.grid, self.n, list(spheres), self.nbands,
                backend=self.backend, batch_axes=self.batch_axes,
                fft_axes=self.fft_axes, policy=self.policy,
                plan=self.stacked_inverse_plan(seg))[0])
        return inv, inv.inverse()   # mirror is memoized on the plan

    def stacked_band_tables(self, seg: int = 0) -> StackedBandTables:
        """Dense kinetic/mask/precond tables for the stacked band update,
        per segment, served from the process-global PlanCache."""
        spheres = self._seg_spheres(seg)
        cache = global_plan_cache()
        key = ("stacked-band-tables", domains_key(spheres),
               (len(spheres), self.nbands), grid_key(self.grid), self.L)
        return cache.get_or_build(
            key, lambda: self._build_band_tables(spheres))

    def _build_band_tables(self, spheres) -> StackedBandTables:
        kin_np, valid = padded_kinetic_table(list(spheres), self.L)
        kin = torch.as_tensor(kin_np, device=self.device)
        mask = torch.as_tensor(valid.astype(np.float32), device=self.device)
        # same f32 ops as the per-k 1/(1 + kinetic(ik)) preconditioner, so
        # valid lanes agree bitwise; mask zeroes the padded lanes exactly
        precond = mask / (1.0 + kin)
        return StackedBandTables(kinetic=kin, mask=mask, precond=precond)

    def occupancy_weights(self, seg: int, occ) -> torch.Tensor:
        """Segment ``seg``'s f32 weights w_k·f_kb over its (nk_seg·nbands)
        stacked rows, on the basis device.

        Built once per segment and occupation table and kept here, beside
        the band tables, so the density and energy of the stacked route
        (and the fused SCF step, which a CUDA graph replays) make no
        host→device copy.  ``occ`` is the full (nk, nbands) table.
        """
        occ = np.asarray(occ, np.float64)
        key = (seg, occ.shape, occ.tobytes())
        w = self._occ_weights.get(key)
        if w is None:
            idx = list(self.segments[seg])
            w = torch.as_tensor(
                (self.weights[idx, None] * occ[idx]).reshape(-1)
                .astype(np.float32), device=self.device)
            self._occ_weights[key] = w
        return w

    def cube_plans(self):
        """(forward, inverse) full-cube pair for density/potential fields."""
        fwd = fftb.plan_for(
            self._cube_spec, domains=self.cube, grid=self.grid,
            backend=self.backend, policy=self.policy)
        return fwd, fwd.inverse()       # mirror is memoized on the plan

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"PlaneWaveBasis(n={self.n}, d={self.d}, nk={self.nk}, "
                f"nbands={self.nbands}, grid={self.grid}, "
                f"batch_axes={self.batch_axes}, fft_axes={self.fft_axes}, "
                f"segments={len(self.segments)})")
