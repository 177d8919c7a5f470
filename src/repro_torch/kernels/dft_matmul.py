"""Batched rectangular complex line DFT as one hand-written CUDA GEMM.

    y = x · Wᵀ        x (B, K), W (N, K), y (B, N), complex64

The kernel (``csrc/dft_matmul.cu`` on the shared tiled GEMM of
``csrc/cgemm.cuh``) replaces the TPU kernel ``_kernel`` of the reference's
``kernels/dft_matmul.py``: the same four real products
``yr = xr·Wrᵀ − xi·Wiᵀ``, ``yi = xr·Wiᵀ + xi·Wrᵀ`` with fp32 accumulation,
read and written as interleaved complex64.

``dft_matmul`` launches the kernel for CUDA tensors and runs the plain
PyTorch version, :func:`dft_matmul_plain`, for CPU tensors.  There is no
fallback: a CUDA tensor either launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import build


def dft_matmul_plain(x, w):
    """The kernel's arithmetic in plain PyTorch: four real fp32 GEMMs."""
    xr, xi = x.real, x.imag
    wr, wi = w.real, w.imag
    yr = xr @ wr.T - xi @ wi.T
    yi = xr @ wi.T + xi @ wr.T
    return torch.complex(yr, yi)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dft_matmul(x, w):
    """y = x · Wᵀ for x (B, K) and W (N, K), complex64 → (B, N) complex64.

    CUDA tensors launch the hand-written kernel (counted in
    ``dft_matmul.launches``); CPU tensors run :func:`dft_matmul_plain`.
    """
    B, K = x.shape
    N = w.shape[0]
    if x.device.type != "cuda":
        _check("w", w, torch.complex64, (N, K), x.device)
        return dft_matmul_plain(x.to(torch.complex64), w)
    _check("x", x, torch.complex64, (B, K), x.device)
    _check("w", w, torch.complex64, (N, K), x.device)
    y = torch.empty((B, N), dtype=torch.complex64, device=x.device)
    if B == 0:
        return y
    lib = build.library("dft_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        status = lib.dft_matmul_launch(x.data_ptr(), w.data_ptr(),
                                       y.data_ptr(), B, N, K, stream)
    build.check(status, "dft_matmul")
    dft_matmul.launches += 1
    return y


dft_matmul.launches = 0
