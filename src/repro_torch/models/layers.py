"""Shared neural-net building blocks (the reference's ``models/layers.py``).

Functions take tensors; the blocks that own weights are ``nn.Module``s
whose parameter names are the reference's parameter-dict keys, in its
layout (``(in, out)``, applied as ``x @ w``), so a reference parameter
tree loads by name (:func:`~.model_zoo.params_from_numpy`).  The modules
hold parameters only: the functions apply them with the config, as the
reference's functions apply its parameter dicts, so one set of weights
can run under two configs (the chip check runs bf16 weights with and
without capacity drops).

Random weights are drawn from an explicit ``torch.Generator`` on the
device they live on; ``gen=None`` leaves them uninitialised
(``torch.empty``) for a caller that loads them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding import tp


def dense_init(gen, shape, scale: float | None = None,
               dtype=torch.float32, *, device=None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = (1.0 / np.sqrt(fan_in)) if scale is None else scale
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def weight(gen, shape, scale: float | None = None, dtype=torch.float32,
           *, device=None) -> nn.Parameter:
    """A parameter drawn as :func:`dense_init` draws it."""
    return nn.Parameter(dense_init(gen, shape, scale, dtype, device=device))


def zeros(n: int, device) -> nn.Parameter:
    """A float32 norm scale (``1 + scale`` multiplies), zero at init."""
    return nn.Parameter(torch.zeros((n,), dtype=torch.float32,
                                    device=device))


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dt)


# ------------------------------------------------------------------ RoPE
def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (B, S) integers."""
    d = x.shape[-1]
    freqs = torch.tensor(rope_freqs(d, theta), dtype=torch.float32,
                         device=x.device)
    ang = positions[..., None].float() * freqs               # (B,S,D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def sinusoidal_pos(seq: int, d: int, device=None):
    pos = np.arange(seq)[:, None]
    div = np.exp(-np.log(10000.0) * np.arange(0, d, 2) / d)
    out = np.zeros((seq, d), np.float32)
    out[:, 0::2] = np.sin(pos * div)
    out[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(out).to(device)


# ------------------------------------------------------------------- MLP
class MLP(nn.Module):
    """``w_up``, ``w_down`` and, for the gated activations, ``w_gate``;
    applied by :func:`mlp_apply`."""

    def __init__(self, d_model: int, d_ff: int, activation: str, dtype,
                 *, gen=None, device=None):
        super().__init__()
        self.w_up = weight(gen, (d_model, d_ff), dtype=dtype, device=device)
        self.w_down = weight(gen, (d_ff, d_model), dtype=dtype,
                             device=device)
        if activation in ("swiglu", "geglu"):
            self.w_gate = weight(gen, (d_model, d_ff), dtype=dtype,
                                 device=device)


def mlp_apply(p, x, activation: str):
    """The MLP; on placed weights whose "model" axis splits ``d_ff``,
    column-parallel ``w_up``/``w_gate`` (the input through
    ``copy_to_model``) and row-parallel ``w_down`` (its partial sums
    reduced over "model")."""
    split = tp.model_split(p, "w_up", 1)
    if split != tp.model_split(p, "w_down", 0):
        raise ValueError("w_up and w_down split d_ff differently")
    if split:
        x = tp.copy_to_model(x)
    up = x @ p.w_up
    if activation == "swiglu":
        h = F.silu(x @ p.w_gate) * up
    elif activation == "geglu":
        h = gelu(x @ p.w_gate) * up
    elif activation == "relu2":
        h = torch.square(F.relu(up))
    elif activation == "gelu":
        h = gelu(up)
    else:
        raise ValueError(activation)
    out = h @ p.w_down
    return tp.reduce_from_model(out) if split else out


def _left_context(x, cache, K: int):
    if cache is None:
        return F.pad(x, (0, 0, K - 1, 0))
    return torch.cat([cache.to(x.dtype), x], dim=1)


def causal_conv1d(x, w, cache=None):
    """Depthwise causal conv. x: (B, S, C), w: (K, C).

    Returns (y, new_cache) where cache holds the trailing K-1 inputs for
    single-step decode.  With cache=None the left context is zeros (train /
    full prefill).
    """
    K = w.shape[0]
    xp = _left_context(x, cache, K)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    new_cache = xp[:, -(K - 1):, :] if K > 1 else None
    return y, new_cache


def fft_causal_conv1d(x, w, cache=None):
    """FFTB-backed depthwise causal conv (paper integration point).

    Identical contract to causal_conv1d; uses frequency-domain convolution
    via the port's :func:`repro_torch.core.spectral.fft_conv` on its
    default ``"fft"`` backend (the reference's ``"jnp"``).
    """
    from repro_torch.core.spectral import fft_conv
    K = w.shape[0]
    xp = _left_context(x, cache, K)
    kernel = w.flip(0)                     # correlation → convolution flip
    y = fft_conv(xp, kernel, axis=1)[:, K - 1:, :]
    new_cache = xp[:, -(K - 1):, :] if K > 1 else None
    return y, new_cache
