"""repro_torch.dft — the plane-wave SCF workload, in PyTorch.

  * ``basis``       per-k-point cut-off spheres, G-vector / |G+k|²
                    bookkeeping, plan retrieval through the ``PlanCache``
  * ``hamiltonian`` kinetic on packed coefficients + local-potential apply
                    via band-batched sphere→cube→sphere round-trips
  * ``density``     ρ(r) = Σ_{k,b} w_k f_b |ψ_kb(r)|²
  * ``hartree``     Poisson solve in G-space on the full-cube plan pair
  * ``potentials``  Gaussian-well external potential + LDA-style exchange
  * ``scf``         the mixing-driven SCF driver (linear + Anderson/Pulay)
  * ``mtxel``       GW matrix elements: valence-conduction pair densities,
                    inverse on one sphere, product, forward onto another

Quickstart::

    from repro_torch.dft import SCFConfig, run_scf
    res = run_scf(SCFConfig(n=16, nbands=4, stack_k=True, backend="cuda",
                            kpts=((0, 0, 0), (0.5, 0.5, 0.5))))
    print(res.energy, res.converged, res.cache_stats)
"""

from .basis import CUBE_SPEC, PW_SPEC, PlaneWaveBasis, StackedBandTables
from .density import density_from_orbitals, density_from_stacked
from .hamiltonian import (apply_hamiltonian, apply_hamiltonian_padded,
                          apply_hamiltonian_pipelined,
                          apply_hamiltonian_stacked, update_bands,
                          update_bands_all_k, update_bands_stacked)
from .hartree import HartreeSolver, coulomb_kernel
from .mtxel import (centring_phase, cutoff_sphere, mtxel_plans, pair_density,
                    valence_conjugates)
from .potentials import gaussian_wells, lda_exchange
from .scf import (AndersonMixer, LinearMixer, SCFConfig, SCFResult,
                  coefficients_from_numpy, run_scf, total_energy,
                  total_energy_stacked)

__all__ = [
    "PlaneWaveBasis", "StackedBandTables", "PW_SPEC", "CUBE_SPEC",
    "density_from_orbitals", "density_from_stacked",
    "apply_hamiltonian", "apply_hamiltonian_padded",
    "apply_hamiltonian_pipelined", "apply_hamiltonian_stacked",
    "update_bands", "update_bands_all_k", "update_bands_stacked",
    "HartreeSolver", "coulomb_kernel", "gaussian_wells", "lda_exchange",
    "centring_phase", "cutoff_sphere", "mtxel_plans", "pair_density",
    "valence_conjugates",
    "SCFConfig", "SCFResult", "run_scf", "total_energy",
    "total_energy_stacked", "coefficients_from_numpy", "LinearMixer", "AndersonMixer",
]
