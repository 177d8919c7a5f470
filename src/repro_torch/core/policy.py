"""ExecPolicy — declarative execution policy for FFTB plans.

A plan carries a default policy, any call may override it, and
``plan.tune(x)`` times the candidate policies and pins the fastest one on
the plan.

  mode           "eager" (interleaved complex, transposes materialized) or
                 "lazy"  (split re/im planes, permutation applied once at
                 exit)
  compute_dtype  matmul operand dtype on the lazy path ("float32" or
                 "bfloat16"; accumulation stays f32 either way)
  check_shapes   validate call-time input shape against the plan's input
                 descriptor
  backend        preferred line-DFT backend for plans built under this
                 policy (None = let the builder default, conventionally
                 "matmul"; "cuda" routes the line DFTs and the sphere hot
                 path through the hand-written kernels).  A *preference*,
                 resolved at plan-build boundaries (e.g. PlaneWaveBasis) —
                 an explicit ``backend=`` argument always wins.

The dataclass is frozen/hashable so policies can key the PlanCache.
"""
from __future__ import annotations

import dataclasses

import torch

MODES = ("eager", "lazy")
COMPUTE_DTYPES = ("float32", "bfloat16")
BACKENDS = ("fft", "matmul", "cuda")

# legacy mode= strings accepted at config boundaries, mapped to policies
_LEGACY_MODES = {
    "eager": ("eager", "float32"),
    "lazy": ("lazy", "float32"),
    "lazy_bf16": ("lazy", "bfloat16"),
}


@dataclasses.dataclass(frozen=True)
class ExecPolicy:
    mode: str = "eager"
    compute_dtype: str = "float32"
    check_shapes: bool = True
    backend: str | None = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"mode {self.mode!r} not in {MODES} (legacy strings like "
                f"'lazy_bf16' go through ExecPolicy.from_mode)")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype {self.compute_dtype!r} not in "
                f"{COMPUTE_DTYPES}")
        if self.backend is not None and self.backend not in BACKENDS:
            raise ValueError(
                f"backend {self.backend!r} not in {BACKENDS}")

    @staticmethod
    def from_mode(mode: "str | ExecPolicy", *,
                  check_shapes: bool = True) -> "ExecPolicy":
        """Accept a legacy mode string ('eager'/'lazy'/'lazy_bf16')."""
        if isinstance(mode, ExecPolicy):
            return mode
        if mode not in _LEGACY_MODES:
            raise ValueError(f"unknown execution mode {mode!r}; expected one "
                             f"of {tuple(_LEGACY_MODES)}")
        m, dt = _LEGACY_MODES[mode]
        return ExecPolicy(mode=m, compute_dtype=dt, check_shapes=check_shapes)

    @property
    def legacy_mode(self) -> str:
        """The old call-site string naming this policy's executor."""
        if self.mode == "lazy" and self.compute_dtype == "bfloat16":
            return "lazy_bf16"
        return self.mode

    def torch_compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else \
            torch.float32


#: candidates plan.tune() races against each other
TUNE_CANDIDATES = (
    ExecPolicy(mode="eager"),
    ExecPolicy(mode="lazy"),
    ExecPolicy(mode="lazy", compute_dtype="bfloat16"),
)
