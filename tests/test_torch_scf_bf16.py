"""The port's lazy-bf16 SCF held to the port's own eager SCF.

The reference's lazy-bf16 ``run_scf`` on this probe fails its own
electron-count assertion, so it cannot be the oracle; the port's eager
run is.  The probe: ``SCFConfig(n=16, nbands=4, kpts=((0,0,0),
(0.5,0.5,0.5)), max_iter=6)``, seed 0, on the CPU.

The limit, :func:`energy_bound`, carries the per-transform bf16 error
through the probe's 6 iterations to first order:

* The kinetic energy is summed over the coefficients, which no transform
  touches.  The external, Hartree and exchange terms are integrals of the
  density ρ = Σ|F⁻¹c|², built from bf16 transforms.
* A transform whose DFT matrices are rounded to bf16 does not keep
  Parseval's norm exactly, and every line of a stage shares the same
  rounded matrix: the error does not average out over the grid, it
  scales ρ by (1 + δ).  ``run_scf``'s own check bounds the scale: a run
  that completes has |δ| = |ΔN / N| < ``DENSITY_TOL`` (1e-3).  To first
  order the terms move by δ·E_ext, 2δ·E_H (quadratic in ρ) and
  (4/3)·δ·E_xc (ρ^(4/3)).
* The orbitals' path through the iterations: each band update moves the
  energy by E_i − E_(i−1), computed through transforms whose outputs
  are off by ``TRANSFORM_ERR`` of their largest value, so the path can
  end up to ``TRANSFORM_ERR`` · Σ|E_i − E_(i−1)| away.  The eager
  energies fall monotonically here, so the sum is |E_6 − E_1|.

``TRANSFORM_ERR`` is the larger of the measured per-transform errors of
a lazy-bf16 plan against the eager one, relative to the largest output:
6.7e-3 on an NVIDIA H100 80GB HBM3 at 700 W (the stacked SCF's inverse
plan at n = 256, d = 128, 32 bands: the plan of the card case
``test_torch_cuda.py::test_cuda_lazy_executor_matches_eager[lazy_bf16-0.03-scf-inverse-b32]``)
and 6.2e-3 on the CPU (the 16³ plan of
``test_torch_exec_modes.py::test_lazy_bf16_executor_precision_bounded``).  On this probe (CPU) the lazy-bf16 density holds 4.00376
electrons of 4 (δ = 9.4e-4); the density terms' bound is 3.97e-3 and
they move by 2.85e-3 together (external −3.09e-3, Hartree +8.7e-4,
exchange −6.3e-4: 1.14, 1.48 and 0.94 times δ of themselves, the rest
the density's shape along the path); the path's bound is 8.3e-4 and
the kinetic term moves by 2.7e-4; the energy ends 2.58e-3 from the
eager run's −1.91518 (1.35e-3 relative) within the bound's 4.80e-3.
At seed 1 the same run stops at ``run_scf``'s electron-count check
(4.0041 electrons), as the reference's does at seed 0: the check, not
this bound, decides whether a lazy-bf16 run completes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.policy import ExecPolicy
from repro_torch.dft import scf

PROBE = dict(n=16, nbands=4, kpts=((0.0, 0.0, 0.0), (0.5, 0.5, 0.5)),
             max_iter=6, seed=0)
#: run_scf's electron-count check: |ΔN| < 1e-3 · N
DENSITY_TOL = 1e-3
#: the per-transform bf16 error, of the largest output (see above)
TRANSFORM_ERR = 6.7e-3


def energy_bound(parts: dict, energies) -> tuple[float, float]:
    """The first-order bound on |E_lazy_bf16 − E_eager|, from the eager
    run's final energy terms ``parts`` and its per-iteration
    ``energies``: (the density terms' part, the path's part)."""
    density = DENSITY_TOL * (abs(parts["external"])
                             + 2 * abs(parts["hartree"])
                             + 4 / 3 * abs(parts["xc"]))
    path = TRANSFORM_ERR * sum(abs(b - a)
                               for a, b in zip(energies, energies[1:]))
    return density, path


def _run(policy, monkeypatch):
    """run_scf on the CPU with ``policy``; its result and its final
    energy terms."""
    seen = []
    real = scf.total_energy

    def spy(*args, **kw):
        total, parts = real(*args, **kw)
        seen.append(parts)
        return total, parts
    monkeypatch.setattr(scf, "total_energy", spy)
    res = scf.run_scf(scf.SCFConfig(**PROBE, policy=policy), device="cpu")
    monkeypatch.undo()
    return res, seen[-1]


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return (_run(None, mp),
                _run(ExecPolicy.from_mode("lazy_bf16"), mp))
    finally:
        torch.set_num_threads(n)


def test_lazy_bf16_scf_within_its_derived_bound_of_eager(runs):
    (eager, parts), (bf16, _) = runs
    assert eager.iterations == bf16.iterations == PROBE["max_iter"]
    assert np.isfinite(bf16.energies).all()
    diff = abs(bf16.energy - eager.energy)
    assert 0.0 < diff <= sum(energy_bound(parts, eager.energies)), diff


def test_lazy_bf16_scf_each_part_within_its_bound(runs):
    """The model's two parts on their own: the density terms (external,
    Hartree, exchange) within the density part, the kinetic term (the
    coefficients' path alone) within the path's part."""
    (eager, want), (_, got) = runs
    density, path = energy_bound(want, eager.energies)
    moved = sum(got[k] - want[k] for k in ("external", "hartree", "xc"))
    assert abs(moved) <= density, (moved, density)
    assert abs(got["kinetic"] - want["kinetic"]) <= path, \
        (got["kinetic"] - want["kinetic"], path)
