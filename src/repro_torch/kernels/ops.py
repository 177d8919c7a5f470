"""Line-DFT entry points of the "cuda" backend.

``dft_apply`` turns a batch of lines into one launch of the complex-GEMM
kernel with the cached rectangular DFT matrix and, on a CUDA device, its
cached split-TF32 embedding (:func:`dft_operand_device`).  Rectangular
n_in ≠ n_out fuses zero-padding (n_in < n_out) or spectrum truncation
(n_in > n_out) into the GEMM shape.  Unlike the reference's wrapper it pads
nothing to whole tiles: the kernel masks its ragged edges itself.  Where
the shape allows (:func:`~.dft_matmul.factored_split`: the longer length
256), the launch is the kernel's factored mode instead, the same operator
as two 16-point stages (:func:`factored_operands_device`).

``four_step_dft`` factors a long composite line n = n1·n2 into two short
GEMM stages (Bailey's four-step): DFT_n2 with the W_N^{j1·k2} twiddle
fused into the epilogue of the twiddle kernel (``dft_matmul_twiddle``),
then DFT_n1 through ``dft_apply``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.local_fft import dft_matrix_device
from ..obs.trace import relayout
from .dft_matmul import (Factored, dft_factored, dft_factored_cols,
                         dft_matmul, dft_matmul_cols, dft_matmul_twiddle,
                         embed_operand, factored_operands, factored_split)
from .ref import twiddle_matrix


@functools.lru_cache(maxsize=128)
def dft_operand_device(n_out: int, n_in: int, inverse: bool,
                       device: torch.device) -> torch.Tensor:
    """The kernel's split operand ``embed_operand(W)`` for
    ``dft_matrix_device(n_out, n_in, inverse, device)``, cached per
    ``(n_out, n_in, inverse, device)`` beside it: built once per DFT
    matrix on the main path."""
    _, _, w = dft_matrix_device(n_out, n_in, inverse, device)
    return embed_operand(w)


def _matrix(n_out: int, n_in: int, inverse: bool, device):
    """(W, its cached split operand or None on the CPU, which needs none)."""
    _, _, w = dft_matrix_device(n_out, n_in, inverse, device)
    if device.type != "cuda":
        return w, None
    return w, dft_operand_device(n_out, n_in, inverse, w.device)


@functools.lru_cache(maxsize=64)
def factored_operands_device(n_out: int, n_in: int, inverse: bool,
                             device: torch.device) -> Factored:
    """:func:`~.dft_matmul.factored_operands`, cached per ``(n_out, n_in,
    inverse, device)``: built once per line shape on the main path."""
    return factored_operands(n_out, n_in, inverse, device)


def dft_apply(x, n_out: int | None = None, *, inverse: bool = False):
    """Batched line DFT via the kernel: (B, n_in) rows → (B, n_out), or
    (P, n_in, L) lines strided in n_in → (P·L, n_out) through the kernel's
    strided entry (:func:`~.dft_matmul.dft_matmul_cols`); complex64.  The
    factored mode where :func:`~.dft_matmul.factored_split` takes the
    shape, the dense product elsewhere: one launch either way."""
    n_in = x.shape[1]
    n_out = n_in if n_out is None else n_out
    if factored_split(n_in, n_out) is not None:
        fo = factored_operands_device(n_out, n_in, bool(inverse), x.device)
        if x.ndim == 3:
            return dft_factored_cols(x.to(torch.complex64), fo)
        return dft_factored(relayout(x.to(torch.complex64)), fo)
    w, ws = _matrix(n_out, n_in, inverse, x.device)
    if x.ndim == 3:
        return dft_matmul_cols(x.to(torch.complex64), w, wsplit=ws)
    return dft_matmul(relayout(x.to(torch.complex64)), w, wsplit=ws)


@functools.lru_cache(maxsize=64)
def _factor(n: int) -> tuple[int, int]:
    """n = n1·n2 with n1 ≈ n2 (n1 the outer/output-major factor)."""
    best = (1, n)
    for n1 in range(2, int(math.isqrt(n)) + 1):
        if n % n1 == 0:
            best = (n1, n // n1)
    n1, n2 = best
    if n1 == 1:
        raise ValueError(f"four-step needs composite n, got prime {n}")
    return n1, n2


@functools.lru_cache(maxsize=64)
def _twiddle_table(n1: int, n2: int, inverse: bool,
                   device: torch.device) -> torch.Tensor:
    """The (n1, n2) twiddle table of stage 1: row j1 holds W^{j1·k2}."""
    tw = twiddle_matrix(n1, n2, inverse)                  # (n2, n1)
    return torch.as_tensor(np.ascontiguousarray(tw.T), device=device)


def four_step_dft(x, *, inverse: bool = False):
    """Long-line DFT: two short GEMM stages + fused twiddle (Bailey).

    x: (B, n) with composite n = n1·n2 (raises ``ValueError`` for a prime
    n).  The line is read as (n2, n1) with j = j1 + n1·j2.  Stage 1:
    DFT_n2 over j2 for each (b, j1) row, times the twiddle W_N^{j1·k2},
    in one twiddle-kernel launch.  Stage 2: DFT_n1 over j1 for each
    (b, k2) row.  Output in natural order k = k2 + n2·k1.  Inverse: each
    stage scales by 1/n2 and 1/n1, so 1/n in total.
    """
    B, n = x.shape
    n1, n2 = _factor(n)
    x = x.to(torch.complex64)
    # (B, n) -> (B, n2, n1) -> rows (b, j1), columns j2
    s1 = x.reshape(B, n2, n1).transpose(1, 2).reshape(B * n1, n2)
    w2, ws2 = _matrix(n2, n2, inverse, x.device)
    t = dft_matmul_twiddle(s1.contiguous(), w2,
                           _twiddle_table(n1, n2, inverse, x.device),
                           wsplit=ws2)
    # rows (b, k2), columns j1
    z = t.reshape(B, n1, n2).transpose(1, 2).reshape(B * n2, n1)
    z = dft_apply(z, inverse=inverse)                     # (B·n2, n1)
    # output index k = k2 + n2·k1 → (B, k1, k2) ravel
    return z.reshape(B, n2, n1).transpose(1, 2).reshape(B, n)
