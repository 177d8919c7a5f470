"""Line-DFT entry point of the "cuda" backend.

``dft_apply`` turns a batch of lines into one launch of the complex-GEMM
kernel with the cached rectangular DFT matrix.  Rectangular
n_in ≠ n_out fuses zero-padding (n_in < n_out) or spectrum truncation
(n_in > n_out) into the GEMM shape.  Unlike the reference's wrapper it pads
nothing to whole tiles: the kernel masks its ragged edges itself.
"""
from __future__ import annotations

import torch

from ..core.local_fft import dft_matrix_device
from .dft_matmul import dft_matmul


def dft_apply(x, n_out: int | None = None, *, inverse: bool = False):
    """Batched line DFT via the kernel: (B, n_in) → (B, n_out) complex64."""
    n_in = x.shape[1]
    n_out = n_in if n_out is None else n_out
    _, _, w = dft_matrix_device(n_out, n_in, inverse, x.device)
    return dft_matmul(x.to(torch.complex64).contiguous(), w)
