"""Batched rectangular complex line DFT as one hand-written CUDA GEMM.

    y = x · Wᵀ              x (M, K), W (N, K), y (M, N), complex64
    y = (x · Wᵀ) ⊙ t        the twiddle entry: row r times row r mod T
                            of a (T, N) complex64 table

The kernels (``csrc/dft_matmul.cu`` on the shared tiled GEMM of
``csrc/cgemm.cuh``) replace the TPU kernels ``_kernel`` and
``_kernel_twiddle`` of the reference's ``kernels/dft_matmul.py``: the same
four real products ``yr = xr·Wrᵀ − xi·Wiᵀ``, ``yi = xr·Wiᵀ + xi·Wrᵀ`` with
fp32 accumulation, read and written as interleaved complex64; the twiddle
entry multiplies each result by ``tr + i·ti`` in the GEMM's epilogue.

``dft_matmul`` / ``dft_matmul_twiddle`` launch their kernel for CUDA
tensors and run the plain PyTorch version (:func:`dft_matmul_plain`,
:func:`dft_matmul_twiddle_plain`) for CPU tensors.  There is no fallback:
a CUDA tensor either launches the kernel or raises.
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


def dft_matmul_twiddle_plain(x, w, t):
    """The twiddle kernel's arithmetic in plain PyTorch: the four real
    GEMMs, then ``yr·tr − yi·ti``, ``yr·ti + yi·tr`` with row r of y
    taking row ``r mod T`` of the ``(T, N)`` table."""
    y = dft_matmul_plain(x, w)
    M, N = y.shape
    T = t.shape[0]
    yr = y.real.reshape(M // T, T, N)
    yi = y.imag.reshape(M // T, T, N)
    tr, ti = t.real, t.imag
    return torch.complex(yr * tr - yi * ti,
                         yr * ti + yi * tr).reshape(M, N)


def dft_matmul_twiddle(x, w, t):
    """y = (x · Wᵀ) ⊙ t for x (M, K), W (N, K) and a (T, N) twiddle table
    whose row ``r mod T`` multiplies row r of y (T must divide M);
    complex64 → (M, N) complex64.

    ``T = M`` is a general per-row twiddle; the four-step DFT passes its
    ``(n1, n2)`` table, whose rows repeat over the batch.  CUDA tensors
    launch the hand-written kernel (counted in
    ``dft_matmul_twiddle.launches``); CPU tensors run
    :func:`dft_matmul_twiddle_plain`.
    """
    M, K = x.shape
    N = w.shape[0]
    T = t.shape[0]
    if T < 1 or M % T:
        raise ValueError(f"twiddle table rows {T} must divide the {M} "
                         "rows of x")
    if x.device.type != "cuda":
        _check("w", w, torch.complex64, (N, K), x.device)
        _check("t", t, torch.complex64, (T, N), x.device)
        return dft_matmul_twiddle_plain(x.to(torch.complex64), w, t)
    _check("x", x, torch.complex64, (M, K), x.device)
    _check("w", w, torch.complex64, (N, K), x.device)
    _check("t", t, torch.complex64, (T, N), x.device)
    y = torch.empty((M, N), dtype=torch.complex64, device=x.device)
    if M == 0:
        return y
    lib = build.library("dft_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        status = lib.dft_matmul_twiddle_launch(
            x.data_ptr(), w.data_ptr(), t.data_ptr(), y.data_ptr(), M, N, K,
            T, stream)
    build.check(status, "dft_matmul_twiddle")
    dft_matmul_twiddle.launches += 1
    return y


dft_matmul_twiddle.launches = 0
