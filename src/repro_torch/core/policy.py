"""ExecPolicy — declarative execution policy for FFTB plans.

A plan carries a default policy and any call may override it.

  mode           "eager" (interleaved complex, transposes materialized) or
                 "lazy"  (split re/im planes, permutation applied once at
                 exit).  Only the eager executor is ported so far; a plan
                 asked to run "lazy" raises ``NotImplementedError``.
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


@dataclasses.dataclass(frozen=True)
class ExecPolicy:
    mode: str = "eager"
    compute_dtype: str = "float32"
    check_shapes: bool = True
    backend: str | None = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype {self.compute_dtype!r} not in "
                f"{COMPUTE_DTYPES}")
        if self.backend is not None and self.backend not in BACKENDS:
            raise ValueError(
                f"backend {self.backend!r} not in {BACKENDS}")

    def torch_compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else \
            torch.float32
