"""FFTB core — flexible multi-dimensional FFTs (the paper's contribution),
the plane-wave sphere transform and spectral model ops, in PyTorch."""

from .cache import PlanCache, global_plan_cache
from .domain import Domain, SphereDomain, sphere_for_cutoff
from .dtensor import (DistTensor, dims_string, parse_dims,
                      parse_transform_spec)
from .fft import Transform, fftb
from .gamma import GammaPlaneWave, gamma_plans, gamma_sphere, half_lanes
from .grid import ProcGrid, resolve_device
from .local_fft import dft_matrix, local_dft
from .plan import FftPlan, Plan
from .planewave import (PlaneWaveFFT, StackedPlaneWaveFFT, cube_spec,
                        kpoint_sphere, make_planewave_pair,
                        make_stacked_planewave_pair, padded_kinetic_table,
                        padded_pack_tables, planewave_spec,
                        segment_padding_fraction, segment_spheres,
                        sphere_gvectors, sphere_kinetic_row)
from .policy import ExecPolicy
from .spectral import fft_conv, fourier_mixer

__all__ = [
    "Domain", "SphereDomain", "sphere_for_cutoff", "DistTensor",
    "parse_dims", "parse_transform_spec", "dims_string", "Transform",
    "fftb", "ProcGrid", "resolve_device", "dft_matrix", "local_dft", "Plan",
    "FftPlan", "PlaneWaveFFT", "StackedPlaneWaveFFT", "kpoint_sphere",
    "make_planewave_pair",
    "make_stacked_planewave_pair", "padded_kinetic_table",
    "padded_pack_tables", "planewave_spec", "cube_spec",
    "segment_padding_fraction", "segment_spheres",
    "sphere_gvectors", "sphere_kinetic_row",
    "ExecPolicy", "PlanCache", "global_plan_cache", "fft_conv",
    "fourier_mixer", "GammaPlaneWave", "gamma_plans", "gamma_sphere",
    "half_lanes",
]
