"""Model-facing spectral ops built on the FFTB local backends (the port of
the reference's ``core/spectral.py``).

  * ``fft_conv``      — FFT long convolution (Mamba-2's depthwise temporal
                        conv when ``conv_impl="fft"``); causal, linear-time
                        in the kernel, O(S log S) overall.
  * ``fourier_mixer`` — FNet-style token mixer.

Both operate on local data through :func:`~.local_fft.local_dft`, so the
backend names are the port's: ``"fft"`` (``torch.fft``, the default, as
the reference's ``"jnp"``), ``"matmul"`` and ``"cuda"``, whose lines up to
``MATMUL_MAX_N`` are each one launch of the line-DFT kernel.
"""
from __future__ import annotations

import torch

from .local_fft import local_dft
from .policy import ExecPolicy


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _pre_cast(x, policy: ExecPolicy | None):
    """Apply the policy's compute dtype to a *real* input before the
    complex promotion (bf16 operands, f32 accumulation — same contract as
    the plans' lazy_bf16 executor)."""
    if policy is not None and policy.compute_dtype == "bfloat16":
        return x.to(torch.bfloat16)
    return x


def fft_conv(x, kernel, axis: int = 1, backend: str = "fft",
             policy: ExecPolicy | None = None):
    """Causal depthwise convolution via frequency domain.

    x: (..., S, ...) real; kernel: (K, C) or (K,) with K ≤ S; convolves along
    ``axis`` (sequence).  Zero-padding to 2·next_pow2 avoids circular
    wrap-around — the same pad-to-avoid-aliasing requirement as the paper's
    n = 2d rule for plane-wave grids.
    """
    S = x.shape[axis]
    K = kernel.shape[0]
    if policy is not None and policy.check_shapes:
        if kernel.ndim not in (1, 2):
            raise ValueError(f"kernel must be (K,) or (K, C), "
                             f"got {tuple(kernel.shape)}")
        if kernel.ndim == 2 and kernel.shape[1] != x.shape[-1]:
            raise ValueError(
                f"kernel channels {kernel.shape[1]} != input channels "
                f"{x.shape[-1]}")
    out_dtype = x.dtype
    x = _pre_cast(x, policy)
    kernel = _pre_cast(kernel, policy)
    L = _next_pow2(S + K - 1)
    xm = torch.movedim(x, axis, -1)                      # sequence last
    Xf = local_dft(xm.to(torch.complex64), -1, L, backend=backend)
    if kernel.ndim == 1:
        k = kernel[None, :]
    else:
        k = torch.movedim(kernel, 0, -1)                 # (C, K)
    Kf = local_dft(k.to(torch.complex64), -1, L, backend=backend)
    Yf = Xf * Kf
    y = local_dft(Yf, -1, L, inverse=True, backend=backend)
    y = y[..., :S].real.to(out_dtype)
    return torch.movedim(y, -1, axis)


def fourier_mixer(x, backend: str = "fft",
                  policy: ExecPolicy | None = None):
    """FNet token mixing: Re(FFT_seq(FFT_hidden(x))). x: (B, S, D)."""
    if policy is not None and policy.check_shapes and x.ndim != 3:
        raise ValueError(f"fourier_mixer expects (B, S, D), got "
                         f"{tuple(x.shape)}")
    out_dtype = x.dtype
    h = local_dft(_pre_cast(x, policy).to(torch.complex64), -1,
                  backend=backend)
    s = local_dft(h, -2, backend=backend)
    return s.real.to(out_dtype)
