"""Oracles for the kernels: numpy and ``torch.fft``, independent of the
DFT-matrix construction the kernels use.  ``twiddle_matrix`` is the one
table both the four-step composition and its tests read.  The Γ-point
fold and unfold (``kernels/gamma.py``) have their plain versions here:
they are gathers, with no DFT matrix to be independent of."""
from __future__ import annotations

import numpy as np
import torch


def dft_apply_ref(x, n_out: int | None = None, *, inverse: bool = False):
    """Oracle for ``kernels.ops.dft_apply``: (B, n_in) complex → (B, n_out).

    ``torch.fft`` of the zero-padded or truncated line, so the oracle does
    not depend on the DFT matrices the kernel multiplies by.
    """
    n_in = x.shape[1]
    n_out = n_in if n_out is None else n_out
    fn = torch.fft.ifft if inverse else torch.fft.fft
    if n_in <= n_out:
        return fn(torch.nn.functional.pad(x, (0, n_out - n_in)), dim=-1)
    return fn(x, dim=-1)[:, :n_out]


def complex_matmul_ref(xr, xi, wr, wi):
    """Oracle for the raw GEMM: y = x @ w.T in split re/im form."""
    yr = xr @ wr.T - xi @ wi.T
    yi = xr @ wi.T + xi @ wr.T
    return yr, yi


def four_step_ref(x, *, inverse: bool = False):
    """Oracle for ``kernels.ops.four_step_dft`` — plain ``torch.fft``."""
    fn = torch.fft.ifft if inverse else torch.fft.fft
    return fn(x, dim=-1)


def twiddle_matrix(n1: int, n2: int, inverse: bool) -> np.ndarray:
    """W_N^{j1·k2} twiddles for the four-step split N = n1·n2.

    Convention (kernels/ops.py): input line reshaped to (n2, n1) with j1
    fast; inner DFT_n2 over axis 0 → T[k2, j1]; T *= W[k2, j1]; outer DFT_n1
    over axis 1 → Z[k2, k1]; output = Z.T.ravel().  Returns the
    ``(n2, n1)`` complex64 table, bit for bit the reference's.
    """
    n = n1 * n2
    j1 = np.arange(n1)
    k2 = np.arange(n2)
    sign = 2j if inverse else -2j
    w = np.exp(sign * np.pi * np.outer(k2, j1) / n)
    return w.astype(np.complex64)


def gamma_fold_plain(half, lane, mirror, npacked: int):
    """Plain version of ``kernels.gamma.fold``: real-band half-sphere rows
    ``half`` (nb, nhalf) to (⌈nb/2⌉, npacked) complex full-sphere rows,
    bands 2k and 2k + 1 as a + i·b at each G (``lane``) and conj(a) +
    i·conj(b) at −G (``mirror``); an odd last band pairs with zeros."""
    nb, nhalf = half.shape
    rows = -(-nb // 2)
    pairs = torch.zeros((2 * rows, nhalf), dtype=half.dtype,
                        device=half.device)
    pairs[:nb] = half
    a, b = pairs[0::2], pairs[1::2]
    lane, mirror = lane.long(), mirror.long()
    out = torch.zeros((rows, npacked), dtype=half.dtype, device=half.device)
    out[:, mirror] = a.conj() + 1j * b.conj()
    out[:, lane] = a + 1j * b        # after the mirror: G = 0 is a + i·b
    return out


def gamma_unfold_plain(full, lane, mirror, nb: int):
    """Plain version of ``kernels.gamma.unfold``: complex full-sphere rows
    ``full`` (rows, npacked) to the nb real bands on the half sphere,
    (F(G) + conj F(−G)) / 2 and (F(G) − conj F(−G)) / (2i)."""
    f = full[:, lane.long()]
    g = full[:, mirror.long()].conj()
    a, b = (f + g) * 0.5, (f - g) * -0.5j
    return torch.stack((a, b), 1).reshape(-1, f.shape[1])[:nb]
