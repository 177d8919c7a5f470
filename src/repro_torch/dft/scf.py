"""Mixing-driven SCF loop over the plane-wave basis.

Each outer iteration: build v_eff = v_ext + v_H[ρ] + v_xc[ρ], update all
bands at every k-point (batched H applies through cached plans), rebuild
the density from the new orbitals, evaluate the total energy

    E = Σ_k w_k Σ_b f ⟨c|T|c⟩ + ∫ρ v_ext + E_H[ρ] + E_xc[ρ]

and mix ρ_in/ρ_out — plain linear mixing for the warm-up iterations, then
Anderson/Pulay acceleration on the stored residual history.  Convergence is
declared when |ΔE| stays below ``e_tol`` (and the density residual below
``r_tol``) after the warm-up.

The orchestration is eager Python by default: every transform goes
through a plan fetched from the process-global ``PlanCache``, so the
cache's hit counter is the subsystem's plan-reuse ledger and
``SCFResult.transforms`` counts real batched 3D transforms.

``SCFConfig(jit_step=True)`` (requires the stacked band-update route)
fuses one whole outer iteration — v_eff build, the stacked band update,
density rebuild, total energy, residual, **and the density mixing** — into
one step on the device whose state (density, band and mixer buffers) is
updated in place.  On CUDA the step is captured as CUDA graphs
(:mod:`.graphs`) and replayed once per iteration: no per-k Python and no
plan call runs in a steady iteration, and the host reads only the energy
and the residual.  The band update's ``eigh`` reads its solver status on
the host, so the step is split there: ``inner_steps`` such syncs per
segment, each between two graphs.  On a grid of several processes every
collective of the step (the plans' all-to-alls, the pack's all-reduce
and row gather, the density's, energy's, residual's and mixer's
reductions) waits on the host under gloo, so each is a split point of
the same kind (:mod:`repro_torch.core.hostsync`): a steady iteration is
then many graphs with those collectives between them, and the stop
decision is all-reduced outside the step, as in the eager loop.  On the
CPU the same step function runs eagerly each iteration.  Plans and band
tables come from the PlanCache when the step's Python runs (the warm-up
and the capture on CUDA, every iteration on the CPU);
``SCFResult.transforms`` keeps the same analytic per-iteration count as
the eager path.  The mixer runs in f32 on the
device (the eager AndersonMixer keeps its history on the host in f64),
so the two agree to mixing precision; with plain linear mixing
(``mix_history<=1``) they do the same f32 arithmetic.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core import ProcGrid, global_plan_cache
from ..core.local_fft import full_fp32_matmul
from ..core.policy import ExecPolicy
from ..obs.trace import get_tracer
from .basis import PlaneWaveBasis
from .density import (density_from_orbitals, density_from_stacked,
                      electron_count)
from .graphs import StepGraphs
from .hamiltonian import (orthonormalize, update_bands, update_bands_all_k,
                          update_bands_stacked)
from .hartree import HartreeSolver
from .potentials import gaussian_wells, lda_exchange


# -------------------------------------------------------------------- mixing
class LinearMixer:
    """ρ ← ρ_in + α (ρ_out − ρ_in)."""

    def __init__(self, alpha: float = 0.5):
        self.alpha = float(alpha)

    def mix(self, rho_in, rho_out):
        return rho_in + self.alpha * (rho_out - rho_in)


class AndersonMixer:
    """Anderson/Pulay (DIIS) density mixing on the residual history.

    Minimizes |Σ_i β_i r_i|² over Σ β_i = 1 (r_i = ρ_out,i − ρ_in,i), then
    takes ρ ← Σ β_i (ρ_in,i + α r_i).  Falls back to linear mixing for the
    first ``warmup`` iterations and whenever the DIIS system is singular.
    The history is kept on the host in float64.  On a multi-process grid
    each rank mixes its z-block of ρ: the only sum over the whole cube,
    the DIIS Gram matrix, goes through ``reduce``, so every rank solves
    the same system.
    """

    def __init__(self, alpha: float = 0.5, history: int = 4,
                 warmup: int = 2, reduce=None):
        self.alpha = float(alpha)
        self.history = int(history)
        self.warmup = int(warmup)
        #: sums a host array over the ranks that hold the other blocks of
        #: ρ (a multi-process grid's fft axes); None on one process
        self.reduce = reduce
        self._rho_in: list[np.ndarray] = []
        self._res: list[np.ndarray] = []
        self._seen = 0

    def mix(self, rho_in, rho_out):
        rin = rho_in.detach().cpu().numpy().astype(np.float64).ravel()
        res = rho_out.detach().cpu().numpy().astype(np.float64).ravel() - rin
        self._rho_in.append(rin)
        self._res.append(res)
        if len(self._res) > self.history:
            self._rho_in.pop(0)
            self._res.pop(0)
        self._seen += 1
        m = len(self._res)
        if self._seen <= self.warmup or m < 2:
            mixed = rin + self.alpha * res
        else:
            r = np.stack(self._res)                       # (m, N)
            a = np.empty((m + 1, m + 1))
            gram = r @ r.T
            a[:m, :m] = gram if self.reduce is None else self.reduce(gram)
            a[m, :m] = a[:m, m] = 1.0
            a[m, m] = 0.0
            rhs = np.zeros(m + 1)
            rhs[m] = 1.0
            try:
                beta = np.linalg.solve(a, rhs)[:m]
            except np.linalg.LinAlgError:
                beta = None
            if beta is None or not np.all(np.isfinite(beta)):
                mixed = rin + self.alpha * res
            else:
                mixed = beta @ (np.stack(self._rho_in)
                                + self.alpha * r)
        return torch.as_tensor(
            mixed.astype(np.float32).reshape(tuple(rho_in.shape)),
            device=rho_in.device)


# ------------------------------------------------------------- jitted mixing
def jit_mixer_init(nvol: int, history: int, device) -> dict:
    """Mixer state for the fused SCF step, on ``device``.

    Linear mixing (``history <= 1``) needs only the iteration counter;
    Anderson/Pulay keeps fixed-size ρ_in/residual history buffers (rows
    ordered oldest→newest, zero-filled until ``seen`` fills them), so the
    state has fixed shapes that a CUDA graph can read and update in place.
    """
    state = {"seen": torch.zeros((), dtype=torch.int32, device=device)}
    if history > 1:
        state["rho_in"] = torch.zeros((history, nvol), dtype=torch.float32,
                                      device=device)
        state["res"] = torch.zeros((history, nvol), dtype=torch.float32,
                                   device=device)
    return state


def jit_mix(state: dict, rho_in, rho_out, *, alpha: float, warmup: int,
            reduce=None):
    """One mixing step inside the fused step; returns ρ_mixed.

    The device twin of ``AndersonMixer.mix``/``LinearMixer.mix``: the same
    bordered DIIS system with rows that are not yet (or no longer) in the
    history pinned to identity rows, the same linear-mixing fallback for
    the warm-up iterations and whenever the solve goes non-finite.  The
    solve is ``torch.linalg.solve_ex``, which neither raises nor waits for
    the host on a singular system (its solution comes out non-finite,
    which selects the fallback).  Runs in f32 (the eager mixer accumulates
    in f64); with ``history <= 1`` it is exactly the eager linear mixer's
    f32 arithmetic.  ``state``'s buffers are updated in place — the port's
    counterpart of the reference's donated buffers.  On a multi-process
    grid each rank mixes its z-block of ρ, and ``reduce`` sums the DIIS
    Gram matrix over the ranks that hold the other blocks (as
    ``AndersonMixer``'s ``reduce`` does), so every rank solves the same
    system.
    """
    a32 = float(np.float32(alpha))
    rin = rho_in.reshape(-1)
    res = rho_out.reshape(-1) - rin
    seen = state["seen"]
    seen.add_(1)
    linear = rin + a32 * res
    if "rho_in" not in state:                     # plain linear mixing
        return linear.reshape(rho_in.shape)
    rho_hist, res_hist = state["rho_in"], state["res"]
    h = rho_hist.shape[0]
    dev = rho_hist.device
    rho_hist.copy_(torch.cat([rho_hist[1:], rin[None]]))
    res_hist.copy_(torch.cat([res_hist[1:], res[None]]))
    m = torch.clamp(seen, max=h)
    valid = torch.arange(h, device=dev) >= h - m  # newest rows are valid
    vf = valid.to(torch.float32)
    r = res_hist * vf[:, None]
    with full_fp32_matmul(dev):
        a = r @ r.T
    if reduce is not None:
        a = reduce(a)
    a = a * (vf[:, None] * vf[None, :])           # invalid rows/cols → 0
    a = a + torch.diag(1.0 - vf)                  # … pinned to identity
    top = torch.cat([a, vf[:, None]], dim=1)
    bot = torch.cat([vf, torch.zeros(1, device=dev)])[None, :]
    # e_h, built on the device: an item assignment would copy a host
    # scalar, which a CUDA graph cannot hold
    rhs = (torch.arange(h + 1, device=dev) == h).to(torch.float32)
    beta = torch.linalg.solve_ex(torch.cat([top, bot], dim=0), rhs)[0][:h]
    beta = beta * vf
    with full_fp32_matmul(dev):
        mixed = beta @ (rho_hist + a32 * res_hist)
    use_linear = ((seen <= warmup) | (m < 2)
                  | ~torch.all(torch.isfinite(beta)))
    out = torch.where(use_linear, linear, mixed)
    return out.reshape(rho_in.shape)


# -------------------------------------------------------------------- config
@dataclasses.dataclass
class SCFConfig:
    n: int = 16                       # FFT cube width
    diameter: int | None = None       # sphere diameter (default n // 2)
    nbands: int = 4
    nocc: int | None = None           # occupied bands (default: all)
    kpts: tuple = ((0.0, 0.0, 0.0),)  # reduced coords, units 2π/L
    weights: tuple | None = None
    L: float | None = None            # cell side (default n, spacing 1)
    depth: float = 4.0                # Gaussian-well depth
    xc: bool = True                   # include the LDA exchange term
    max_iter: int = 50
    e_tol: float = 1e-5               # |ΔE| convergence threshold
    r_tol: float = 1e-4               # density-residual threshold (per elec)
    inner_steps: int = 4              # band-update steps per k per outer it
    mix_alpha: float = 0.7
    mix_history: int = 5
    mix_warmup: int = 2               # linear iterations before Anderson
    seed: int = 0
    pipeline: bool = True             # double-buffer the per-k transforms
    stack_k: bool | None = None       # ragged-stack the H apply across k
                                      # (None: auto via basis.stacks_k;
                                      # True requires pipeline=True)
    jit_step: bool = False            # fuse mixing + band update + density
                                      # into one step on the device, replayed
                                      # as CUDA graphs (requires the stacked
                                      # band-update route)
    batch_axes: tuple | None = None   # grid axes carrying the band batch
    fft_axes: tuple | None = None     # grid axes carrying the transforms
    segment_padding: float | None = None
                                      # per-segment padding budget for the
                                      # ragged k-stacking (None: one
                                      # global npacked_max segment)
    policy: ExecPolicy | None = None
    backend: str | None = None        # line-DFT backend preference; None
                                      # resolves explicit > policy.backend
                                      # > "matmul" (see PlaneWaveBasis)


@dataclasses.dataclass
class SCFResult:
    converged: bool
    iterations: int
    energy: float
    energies: list[float]             # total energy per outer iteration
    residuals: list[float]            # |ρ_out − ρ_in| per electron
    eigenvalues: np.ndarray           # (nk, nbands), ascending per k
    rho: torch.Tensor
    transforms: int                   # per-band 3D transforms executed
                                      # (plan calls batch nbands of them)
    seconds: float
    cache_stats: dict                 # global PlanCache counters (delta)
    grid_shape: tuple = ()            # processing-grid shape the run used
    stacked: bool = False             # H sweeps rode the k-stacked batch
    padding_fraction: float = 0.0     # padded lanes / total stacked lanes
    band_update: str = "per-k"        # band-update route: "stacked" (the
                                      # batched engine) or "per-k"
    backend: str = "matmul"           # resolved line-DFT backend the basis
                                      # ran (what plans were built with)
    segments: int = 1                 # ragged-stacking segment count
    segment_padding_fractions: tuple = ()
    device: str = "cpu"               # the device the run computed on
    jitted: bool = False              # iterations ran as the fused step's
                                      # CUDA graphs
    #: the fused step's graphs on CUDA: {"graphs": graphs per iteration,
    #: "replays": replays of the step, "host_syncs": the named syncs
    #: between graphs per iteration, "capture_seconds": capture time};
    #: empty for the eager loop and for the fused step on the CPU
    graphs: dict = dataclasses.field(default_factory=dict)
    #: per-iteration telemetry: one dict per outer iteration with
    #: {iteration, energy, residual, seconds, transforms}
    iteration_records: list = dataclasses.field(default_factory=list)

    @property
    def transforms_per_s(self) -> float:
        return self.transforms / max(self.seconds, 1e-9)

    @property
    def seconds_per_iteration(self) -> float:
        """Mean wall time of one outer SCF iteration."""
        return self.seconds / max(self.iterations, 1)


# -------------------------------------------------------------------- energy
def total_energy(basis, coeffs, rho, v_ext, hartree: HartreeSolver, occ,
                 *, xc: bool = True) -> tuple[float, dict]:
    """E[{ψ}, ρ] and its components; ρ should be the orbitals' density."""
    occ = np.asarray(occ, np.float64)
    e_kin = 0.0
    for ik, c in enumerate(coeffs):
        kin = basis.kinetic(ik)
        per_band = torch.sum(kin[None, :] * c.abs() ** 2, dim=1)
        e_kin += float(basis.weights[ik]
                       * (occ[ik] @ per_band.cpu().numpy()
                          .astype(np.float64)))
    dv = basis.dv
    e_ext = basis.field_sum(rho * v_ext) * dv
    vh = hartree(rho)
    e_h = hartree.energy(rho, vh)
    if xc:
        e_x, _ = lda_exchange(rho)
        e_xc = basis.field_sum(e_x) * dv
    else:
        e_xc = 0.0
    total = e_kin + e_ext + e_h + e_xc
    return total, {"kinetic": e_kin, "external": e_ext, "hartree": e_h,
                   "xc": e_xc, "total": total}


def total_energy_stacked(basis, c_pad, rho, v_ext, hartree: HartreeSolver,
                         occ, *, xc: bool = True, tables=None):
    """E[{ψ}, ρ] on the padded per-segment coefficient stacks, as a 0-d
    f32 tensor on the device (no host read).

    ``c_pad`` is either one (nk_seg, nbands, pad_width) stack (the
    single-segment case) or a tuple/list of them, one per basis segment
    in segment order.  The kinetic term is one masked reduction per
    segment against the dense padded kinetic table (padded lanes
    contribute exact zeros), everything else is cube arithmetic.
    Accumulates in f32 where the eager :func:`total_energy` reduces
    per-band terms in host f64; the two agree to f32 reduction precision.
    """
    if not isinstance(c_pad, (tuple, list)):
        c_pad = (c_pad,)
    if tables is None:
        # eager callers only: the fused step passes the tables it fetched
        # before its capture, so this lookup never runs inside a graph
        tables = [basis.stacked_band_tables(s)  # noqa: FFTB202
                  for s in range(len(c_pad))]
    elif not isinstance(tables, (tuple, list)):
        tables = (tables,)
    e_kin = 0.0
    for s, (cs, tab) in enumerate(zip(c_pad, tables)):
        w = basis.occupancy_weights(s, occ).reshape(cs.shape[:2])
        per_band = torch.sum(tab.kinetic[:, None, :] * cs.abs() ** 2,
                             dim=-1)
        e_kin = e_kin + torch.sum(w * per_band)
    dv = float(np.float32(basis.dv))
    e_ext = torch.sum(rho * v_ext) * dv
    vh = hartree(rho)
    e_h = torch.sum(rho * vh) * (0.5 * dv)
    e_xc = torch.sum(lda_exchange(rho)[0]) * dv if xc else 0.0
    # the cube terms of the ranks' z-blocks (no collective on one process)
    return e_kin + basis.grid.all_reduce(e_ext + e_h + e_xc, basis.fft_axes,
                                         name="energy.all_reduce")


# -------------------------------------------------------------------- driver
def _jit_scf_loop(cfg: "SCFConfig", basis, v_ext, hartree, occ,
                  nelec: float, coeffs, callback):
    """The fused SCF loop: one step on the device per outer iteration.

    Everything the eager loop does per iteration — v_eff build, the
    stacked band update, density rebuild, total energy, residual, density
    mixing — runs as one step function whose state (the density, the
    padded band stacks, the mixer buffers) it updates in place.  On CUDA
    the step is warmed up once on a side stream (kernel builds and every
    cache fill there), captured once as CUDA graphs split at its host
    syncs (:class:`~.graphs.StepGraphs`), and replayed once per
    iteration; iteration 0 is the capture's own run.  On the CPU the step
    runs eagerly each iteration.  The host reads the energy and the
    residual once per iteration, in one copy.

    Returns (energies, residuals, records, eigs, ρ_out, transforms,
    converged, seconds, graph stats) with the same accounting semantics as
    the eager loop.
    """
    dev = basis.device
    segs = basis.segments
    invs = [basis.stacked_hamiltonian_plans(s)[0] for s in range(len(segs))]
    tables = [basis.stacked_band_tables(s) for s in range(len(segs))]
    c_segs = [invs[s].stack([coeffs[ik] for ik in seg]).reshape(
        len(seg), basis.nbands, invs[s].npacked_max)
        for s, seg in enumerate(segs)]
    rho = sum(density_from_stacked(basis, c_segs[s], occ, seg=s)
              for s in range(len(segs)))
    # the rank's z-block of ρ (the whole cube on one process)
    mix_state = jit_mixer_init(rho.numel(), cfg.mix_history, dev)
    grid = basis.grid
    fft_axes = basis.fft_axes
    inelec = 1.0 / max(nelec, 1e-9)
    rscale = float(np.float32(basis.dv ** 0.5 * inelec))

    def step(rho, c_segs, mix_state):
        """One iteration on the state buffers, updated in place; returns
        (ρ_out, eigenvalues per segment, [energy, residual])."""
        vh = hartree(rho)
        v_eff = v_ext + vh
        if cfg.xc:
            v_eff = v_eff + lda_exchange(rho)[1]
        c_new, eps_segs = [], []
        for s in range(len(segs)):
            c_s, eps_s, _ = update_bands_stacked(
                basis, c_segs[s], v_eff, steps=cfg.inner_steps,
                tables=tables[s], seg=s)
            c_new.append(c_s)
            eps_segs.append(eps_s)
        rho_out = sum(density_from_stacked(basis, c_new[s], occ, seg=s)
                      for s in range(len(segs)))
        energy = total_energy_stacked(basis, c_new, rho_out, v_ext,
                                      hartree, occ, xc=cfg.xc,
                                      tables=tables)
        # ‖ρ_out − ρ‖ over the ranks' z-blocks
        dr = rho_out - rho
        resid = torch.sqrt(grid.all_reduce(
            torch.sum(dr * dr), fft_axes, name="residual")) * rscale
        rho_next = jit_mix(
            mix_state, rho, rho_out, alpha=cfg.mix_alpha,
            warmup=cfg.mix_warmup,
            reduce=lambda a: grid.all_reduce(a, fft_axes, name="mix.gram"))
        rho.copy_(rho_next)
        for c, cn in zip(c_segs, c_new):
            c.copy_(cn)
        return rho_out, eps_segs, torch.stack([energy, resid])

    graphs = None
    if dev.type == "cuda":
        graphs = StepGraphs(dev)

    energies: list[float] = []
    residuals: list[float] = []
    records: list[dict] = []
    transforms = 0
    converged = False
    rho_out, eps_segs = rho, None
    # per-iteration analytic transform count, matching the eager loop:
    # Hartree pair + band-update sweeps + density + the energy's Hartree
    per_iter = (2 + 2 * cfg.inner_steps * basis.nk * 2 * basis.nbands
                + basis.nk * basis.nbands + 2)
    tr = get_tracer()
    _sync(dev)
    t0 = time.perf_counter()
    for it in range(cfg.max_iter):
        it_t0 = time.perf_counter()
        with tr.span("scf_iteration", iteration=it,
                     route="jit" if graphs is not None else "jit-eager"):
            if graphs is None:
                out = step(rho, c_segs, mix_state)
            elif it == 0:
                # warm up on copies, so the capture's own run is iteration 0
                graphs.warmup(step, rho.clone(),
                              [c.clone() for c in c_segs],
                              {k: v.clone() for k, v in mix_state.items()})
                out = graphs.capture(step, rho, c_segs, mix_state)
            else:
                graphs.replay()
            rho_out, eps_segs, er = out
            # the one host read of the iteration: it waits for the step
            energy, resid = er.tolist()
        transforms += per_iter
        energies.append(energy)
        residuals.append(resid)
        records.append({"iteration": it, "energy": energy,
                        "residual": resid,
                        "seconds": time.perf_counter() - it_t0,
                        "transforms": per_iter})
        if callback is not None:
            callback(it, energy, resid)
        done = (it > cfg.mix_warmup
                and abs(energies[-1] - energies[-2]) < cfg.e_tol
                and resid < cfg.r_tol)
        # one decision for every rank, outside the captured step
        if grid.all_reduce_host(float(done), range(grid.ndim), "min"):
            converged = True
            break
    _sync(dev)
    seconds = time.perf_counter() - t0
    eigs = np.zeros((basis.nk, basis.nbands))
    if eps_segs is not None:
        for s, seg in enumerate(segs):
            eigs[list(seg)] = eps_segs[s].cpu().numpy()
    stats = {}
    if graphs is not None:
        stats = {"graphs": graphs.graph_count, "replays": graphs.replays,
                 "host_syncs": graphs.sync_names,
                 "capture_seconds": graphs.capture_seconds}
    return (energies, residuals, records, eigs, rho_out.clone(), transforms,
            converged, seconds, stats)


def coefficients_from_numpy(blocks, device=None):
    """Per-k ``(nbands, npacked_k)`` coefficient blocks as numpy (e.g. the
    reference package's start) → the port's complex64 tensors on
    ``device`` (CUDA when omitted; raises without CUDA)."""
    from ..core.grid import resolve_device
    dev = resolve_device(device)
    return [torch.as_tensor(np.array(b, np.complex64), device=dev)
            for b in blocks]


def _init_coefficients(basis, seed: int):
    rng = np.random.default_rng(seed)
    coeffs = []
    for ik in range(basis.nk):
        npk = basis.npacked(ik)
        c = (rng.standard_normal((basis.nbands, npk))
             + 1j * rng.standard_normal((basis.nbands, npk))
             ).astype(np.complex64)
        coeffs.append(orthonormalize(torch.as_tensor(c,
                                                     device=basis.device)))
    return coeffs


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_scf(cfg: SCFConfig, *, device=None, grid: ProcGrid | None = None,
            v_ext=None, coeffs=None, callback=None) -> SCFResult:
    """Run the SCF loop; see module docstring for the iteration structure.

    ``device`` is where the run computes (CUDA when omitted; raises
    without CUDA); a ``grid`` brings its own device.  ``coeffs`` optionally
    gives the starting per-k coefficient blocks (see
    :func:`coefficients_from_numpy`); by default they are random
    orthonormal blocks from ``cfg.seed``.  ``callback(it, energy,
    residual)`` is invoked after every outer iteration.
    """
    basis = PlaneWaveBasis(
        cfg.n, diameter=cfg.diameter, kpts=cfg.kpts, weights=cfg.weights,
        nbands=cfg.nbands, L=cfg.L, grid=grid,
        batch_axes=cfg.batch_axes, fft_axes=cfg.fft_axes,
        segment_padding=cfg.segment_padding,
        policy=cfg.policy, backend=cfg.backend, device=device)
    dev = basis.device
    cache0 = dict(global_plan_cache().stats)
    if v_ext is None:
        v_ext = gaussian_wells(cfg.n, depth=cfg.depth)
    # every field of the run is the rank's z-block (the cube on one process)
    v_ext = basis.field.scatter(torch.as_tensor(v_ext, dtype=torch.float32,
                                                device=dev))
    hartree = HartreeSolver(basis)

    if cfg.inner_steps < 1:
        raise ValueError(f"inner_steps must be >= 1, got {cfg.inner_steps}")
    nocc = cfg.nbands if cfg.nocc is None else int(cfg.nocc)
    if not 0 < nocc <= cfg.nbands:
        raise ValueError(f"nocc {nocc} not in (0, nbands={cfg.nbands}]")
    occ = np.zeros((basis.nk, basis.nbands))
    occ[:, :nocc] = 1.0
    nelec = float(basis.weights.sum() * nocc)

    # route the H sweeps through the ragged k-stacked batch when the grid
    # supports it (or the caller forces it); pipelined per-k is the fallback
    stack_k = basis.stacks_k if cfg.stack_k is None else bool(cfg.stack_k)
    if cfg.stack_k and not cfg.pipeline:
        raise ValueError("stack_k=True requires pipeline=True (the "
                         "stacked route sweeps all k-points per step; "
                         "pipeline=False runs the serial per-k loop)")
    stacked = bool(stack_k and cfg.pipeline)
    if cfg.jit_step and not stacked:
        # the fused step is built on the padded stacked engine — running
        # it per-k would re-introduce the dispatch overhead it removes
        raise ValueError("jit_step=True requires the stacked band-update "
                         "route (stack_k=True, or a grid satisfying "
                         "basis.stacks_k with stack_k left on auto)")

    grid = basis.grid
    every_axis = range(grid.ndim)

    def fft_sum(a):
        return grid.all_reduce_host(a, basis.fft_axes)

    if coeffs is None:
        coeffs = _init_coefficients(basis, cfg.seed)
    else:
        coeffs = [torch.as_tensor(c, dtype=torch.complex64, device=dev)
                  for c in coeffs]
        for ik, c in enumerate(coeffs):
            if tuple(c.shape) != (basis.nbands, basis.npacked(ik)):
                raise ValueError(
                    f"coeffs[{ik}] shape {tuple(c.shape)} != (nbands, "
                    f"npacked) = ({basis.nbands}, {basis.npacked(ik)})")

    if cfg.jit_step:
        (energies, residuals, iteration_records, eigs, rho, transforms,
         converged, seconds, graph_stats) = _jit_scf_loop(
            cfg, basis, v_ext, hartree, occ, nelec, coeffs, callback)
    else:
        graph_stats = {}
        rho = density_from_orbitals(basis, coeffs, occ)
        mixer = AndersonMixer(cfg.mix_alpha, cfg.mix_history,
                              cfg.mix_warmup, reduce=fft_sum) \
            if cfg.mix_history > 1 else LinearMixer(cfg.mix_alpha)

        energies: list[float] = []
        residuals: list[float] = []
        iteration_records: list[dict] = []
        eigs = np.zeros((basis.nk, basis.nbands))
        # counter and timer both cover the SCF loop only: the warm-up
        # density build above (plan construction, first kernel builds) is
        # excluded
        transforms = 0
        converged = False
        _sync(dev)
        t0 = time.perf_counter()

        tr = get_tracer()
        for it in range(cfg.max_iter):
            it_t0 = time.perf_counter()
            it_transforms0 = transforms
            with tr.span("scf_iteration", iteration=it,
                         route="stacked" if stacked else "per-k"):
                vh = hartree(rho)
                transforms += 2                    # cube fwd + derived inv
                v_eff = v_ext + vh
                if cfg.xc:
                    _, v_x = lda_exchange(rho)
                    v_eff = v_eff + v_x
                if cfg.pipeline:
                    # all-k loop: the batched stacked engine when stacking,
                    # the pipelined per-k dispatch otherwise
                    coeffs, eps_list, nsweep = update_bands_all_k(
                        basis, coeffs, v_eff, steps=cfg.inner_steps,
                        stacked=stack_k)
                    for ik in range(basis.nk):
                        eigs[ik] = eps_list[ik].cpu().numpy()
                    transforms += nsweep * basis.nk * 2 * basis.nbands
                else:
                    for ik in range(basis.nk):
                        coeffs[ik], eps, napply = update_bands(
                            basis, ik, coeffs[ik], v_eff,
                            steps=cfg.inner_steps)
                        eigs[ik] = eps.cpu().numpy()
                        transforms += napply * 2 * basis.nbands
                rho_out = density_from_orbitals(basis, coeffs, occ)
                transforms += basis.nk * basis.nbands
                energy, _ = total_energy(basis, coeffs, rho_out, v_ext,
                                         hartree, occ, xc=cfg.xc)
                transforms += 2                    # energy's Hartree solve
                # float() waits for rho_out, so the iteration's time (and
                # the span) is real work
                resid = (basis.field_sum((rho_out - rho) ** 2)
                         * basis.dv) ** 0.5 / max(nelec, 1e-9)
            energies.append(energy)
            residuals.append(resid)
            iteration_records.append({
                "iteration": it, "energy": energy, "residual": resid,
                "seconds": time.perf_counter() - it_t0,
                "transforms": transforms - it_transforms0})
            if callback is not None:
                callback(it, energy, resid)
            done = (it > cfg.mix_warmup
                    and abs(energies[-1] - energies[-2]) < cfg.e_tol
                    and resid < cfg.r_tol)
            # one decision for every rank: each stops only when all do
            if grid.all_reduce_host(float(done), every_axis, "min"):
                converged = True
                break
            rho = mixer.mix(rho, rho_out)

        _sync(dev)                             # drain the last mix
        seconds = time.perf_counter() - t0
        # return the density the orbitals actually produced (not the mixed
        # guess) — coeffs are unchanged since the loop's last rho_out
        rho = rho_out if energies else density_from_orbitals(basis, coeffs,
                                                              occ)

    cache1 = global_plan_cache().stats
    delta = {k: cache1[k] - cache0.get(k, 0)
             for k in ("hits", "misses", "evictions")}
    delta["size"] = cache1["size"]
    ne = electron_count(basis, rho)
    if abs(ne - nelec) >= 1e-3 * max(nelec, 1.0):
        raise RuntimeError(f"density integrates to {ne} electrons, "
                           f"expected {nelec}")
    rho = basis.field.gather(rho)
    padding = basis.padding_fraction if stacked else 0.0
    return SCFResult(
        converged=converged, iterations=len(energies),
        energy=energies[-1] if energies else float("nan"),
        energies=energies, residuals=residuals, eigenvalues=eigs, rho=rho,
        transforms=transforms, seconds=seconds, cache_stats=delta,
        grid_shape=tuple(basis.grid.shape), stacked=stacked,
        padding_fraction=padding,
        band_update="stacked" if stacked else "per-k",
        backend=basis.backend,
        segments=basis.nsegments,
        segment_padding_fractions=basis.segment_padding_fractions,
        device=str(dev), jitted=bool(graph_stats.get("graphs")),
        graphs=graph_stats,
        iteration_records=iteration_records)
