"""Mamba-2 (SSD — state-space duality) blocks, chunked matmul form (the
reference's ``models/ssm.py``).

The SSD dual form computes attention-free sequence mixing as chunk-local
quadratic matmuls plus a linear inter-chunk state recurrence.  The
depthwise temporal conv optionally routes through FFTB's ``fft_conv``
(``conv_impl="fft"``), the paper-technique integration point for this
family; decode always runs the direct conv against its carried state.

On placed weights whose "model" axis splits the block (training only;
``sharding/rules.py::place_params``) each model rank runs its
``tp.head_range`` of the SSD heads, H/M when M divides H
(:func:`_ssm_block_tp`): the SSD scan is independent per head and
B, C are one group that every head shares.  The stored column blocks of
``in_proj`` (x | gate | B | C | dt) and ``conv_w`` (x | B | C) do not
fall on heads, so both are gathered whole over "model" and each rank
takes its heads' columns of x, gate and dt and all of B and C;
``out_proj`` is row-parallel: its row block when that block is the
rank's heads, else its rows of the whole weight taken over "model".
The gated RMSNorm normalises over the whole ``d_inner``: its sum of
squares is summed over "model" by ``tp.sum_over_model`` (the ranks'
channels cover ``d_inner`` once, evenly split or not).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding import tp

from .layers import causal_conv1d, fft_causal_conv1d, rms_norm, weight


class SSMBlock(nn.Module):
    """``in_proj``, ``conv_w``, ``out_proj`` (model dtype) and the float32
    ``A_log``, ``D_skip``, ``dt_bias``, ``norm_scale``."""

    def __init__(self, cfg, dtype, *, gen=None, device=None):
        super().__init__()
        D, din, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, \
            cfg.ssm_nheads
        conv_dim = din + 2 * N                  # conv over (x, B, C)

        def f32(value, n=H):
            return nn.Parameter(torch.full((n,), value, dtype=torch.float32,
                                           device=device))

        self.in_proj = weight(gen, (D, 2 * din + 2 * N + H), dtype=dtype,
                              device=device)
        self.conv_w = weight(gen, (cfg.conv_kernel, conv_dim), 0.5, dtype,
                             device=device)
        self.out_proj = weight(gen, (din, D), dtype=dtype, device=device)
        self.A_log = f32(0.0)
        self.D_skip = f32(1.0)
        self.dt_bias = f32(0.0)
        self.norm_scale = f32(0.0, din)


def _split_proj(z, cfg):
    din, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    zx, gate, Bm, Cm, dt = torch.split(z, [din, din, N, N, H], dim=-1)
    return zx, gate, Bm, Cm, dt


def _segsum(dA):
    """(..., Q) → (..., Q, Q) lower-triangular cumulative sums:
    out[i, j] = sum_{j < k <= i} dA[k]."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=dA.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """SSD sequence mixing.

    xh: (B,S,H,P) inputs, dt: (B,S,H) positive step sizes, A: (H,) < 0,
    Bm/Cm: (B,S,N) shared across heads (ngroups=1).  Returns (B,S,H,P).
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    nc = S // Q
    xc = xh.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)
    dA = dtc * A                                             # (B,nc,Q,H)

    # ---- intra-chunk (quadratic within Q) ----
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))        # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)         # (B,nc,Q,Q)
    M = scores[:, :, None] * Lmat                            # (B,nc,H,Q,Q)
    y_intra = torch.einsum("bchqk,bckh,bckhp->bcqhp", M, dtc, xc)

    # ---- chunk states ----
    dA_cum = torch.cumsum(dA, dim=2)                         # (B,nc,Q,H)
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # (B,nc,Q,H)
    states = torch.einsum("bckn,bckh,bckhp->bchnp",
                          Bc, dtc * decay_to_end, xc)        # (B,nc,H,N,P)

    # ---- inter-chunk recurrence over nc ----
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])             # (B,nc,H)
    s = torch.zeros((Bsz, H, N, P), dtype=states.dtype, device=xh.device)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_in = torch.stack(s_in, dim=1)                          # (B,nc,H,N,P)

    decay_from_start = torch.exp(dA_cum)                     # (B,nc,Q,H)
    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp",
                           Cc, decay_from_start, s_in)
    return (y_intra + y_inter).reshape(Bsz, S, H, P)


def ssm_block(p, x, cfg, *, state=None):
    """One Mamba-2 block. x: (B,S,D).

    state: None (train/prefill from scratch) or dict with "conv"
    (B, K-1, conv_dim) and "ssm" (B, H, N, P): the carried state for a
    single-step decode (S == 1), the initial conv context for a prefill.
    Returns (y, new_state).
    """
    if state is None and _model_split(p):
        return _ssm_block_tp(p, x, cfg), None
    B, S, D = x.shape
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, \
        cfg.ssm_headdim
    z = x @ p.in_proj
    zx, gate, Bm, Cm, dt = _split_proj(z, cfg)
    conv_in = torch.cat([zx, Bm, Cm], dim=-1)

    decode = state is not None and S == 1
    conv = fft_causal_conv1d if cfg.conv_impl == "fft" and not decode \
        else causal_conv1d
    conv_out, conv_cache = conv(
        conv_in, p.conv_w, None if state is None else state["conv"])
    conv_out = F.silu(conv_out)
    zx, Bm, Cm = torch.split(conv_out, [din, N, N], dim=-1)

    dt = F.softplus(dt.float() + p.dt_bias)                      # (B,S,H)
    A = -torch.exp(p.A_log)                                      # (H,)
    xh = zx.reshape(B, S, H, P)

    if decode:
        s_prev = state["ssm"]                                    # (B,H,N,P)
        dA = torch.exp(dt[:, 0] * A)                             # (B,H)
        upd = torch.einsum("bn,bh,bhp->bhnp", Bm[:, 0].float(),
                           dt[:, 0], xh[:, 0].float())
        s_new = s_prev * dA[..., None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), s_new)
        # bf16 xh promotes against f32 y, as in the reference
        y = y[:, None] + p.D_skip[None, None, :, None] * xh
        new_state = {"conv": conv_cache, "ssm": s_new}
    else:
        y = ssd_chunked(xh.float(), dt, A, Bm.float(), Cm.float(),
                        cfg.ssm_chunk)
        y = y + p.D_skip[None, None, :, None] * xh.float()
        if state is not None:       # prefill: also emit final state
            new_state = {"conv": conv_cache,
                         "ssm": _final_state(xh, dt, A, Bm, Cm)}
        else:
            new_state = None
    y = y.reshape(B, S, din).to(x.dtype)
    y = rms_norm(y * F.silu(gate), p.norm_scale, cfg.norm_eps)
    return y @ p.out_proj, new_state


def _model_split(p) -> bool:
    return any(tp.model_split(p, n, d) for n, d in (
        ("in_proj", 1), ("conv_w", 1), ("out_proj", 0)))


def _ssm_block_tp(p, x, cfg):
    """The training block on this model rank's SSD heads
    (``tp.head_range``; the module docstring); ``x`` is whole on every
    model rank."""
    B, S, D = x.shape
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, \
        cfg.ssm_headdim
    h0, h1 = tp.head_range(H)
    Hl = h1 - h0
    heads = slice(h0, h1)
    # this rank's columns of x | gate | B | C | dt, and of the conv's x | B | C
    c0, c1 = h0 * P, h1 * P
    w_in = _columns(tp.whole_over_model(p, "in_proj", 1), (
        (c0, c1), (din + c0, din + c1), (2 * din, 2 * din + 2 * N),
        (2 * din + 2 * N + h0, 2 * din + 2 * N + h1)))
    w_conv = _columns(tp.whole_over_model(p, "conv_w", 1),
                      ((c0, c1), (din, din + 2 * N)))
    if H % tp.model_size() == 0 and tp.model_split(p, "out_proj", 0):
        w_out = p.out_proj                # the row block is these heads
    else:
        w_out = tp.whole_over_model(p, "out_proj", 0)[c0:c1]
    z = tp.copy_to_model(x) @ w_in
    zx, gate, Bm, Cm, dt = torch.split(z, [Hl * P, Hl * P, N, N, Hl],
                                       dim=-1)
    conv = fft_causal_conv1d if cfg.conv_impl == "fft" else causal_conv1d
    conv_out, _ = conv(torch.cat([zx, Bm, Cm], dim=-1), w_conv)
    zx, Bm, Cm = torch.split(F.silu(conv_out), [Hl * P, N, N], dim=-1)

    dt = F.softplus(dt.float() + tp.copy_to_model(p.dt_bias)[heads])
    A = -torch.exp(tp.copy_to_model(p.A_log)[heads])
    xh = zx.reshape(B, S, Hl, P)
    y = ssd_chunked(xh.float(), dt, A, Bm.float(), Cm.float(),
                    cfg.ssm_chunk)
    y = y + tp.copy_to_model(p.D_skip)[None, None, heads, None] * \
        xh.float()
    y = y.reshape(B, S, Hl * P).to(x.dtype)
    y = _rms_norm_tp(y * F.silu(gate), tp.copy_to_model(p.norm_scale)[c0:c1],
                     din, cfg.norm_eps)
    return tp.reduce_from_model(y @ w_out)


def _columns(w, ranges):
    """The columns ``[a, b)`` of ``w`` for each range, side by side."""
    return torch.cat([w[:, a:b] for a, b in ranges], dim=1)


def _rms_norm_tp(x, scale, n: int, eps: float):
    """``rms_norm`` over a feature dim of ``n`` whose this rank's part is
    ``x`` (``scale`` its part of the scale): the sum of squares summed
    over "model" (forward and backward: ``tp.sum_over_model``)."""
    dt = x.dtype
    x = x.float()
    var = tp.sum_over_model(torch.sum(torch.square(x), dim=-1,
                                      keepdim=True)) / n
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def _final_state(xh, dt, A, Bm, Cm):
    """Final SSM state after a full sequence (for prefill → decode).

    As in the reference, any initial state is ignored: prefill starts
    from zeros."""
    dA = dt * A                                              # (B,S,H)
    dA_cum = torch.cumsum(dA, dim=1)
    decay_to_end = torch.exp(dA_cum[:, -1:, :] - dA_cum)     # (B,S,H)
    return torch.einsum("bsn,bsh,bshp->bhnp", Bm.float(),
                        dt * decay_to_end, xh.float())


def ssm_init_state(cfg, batch: int, dtype=torch.float32, *, device=None):
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_state,
                            cfg.ssm_headdim), dtype=torch.float32,
                           device=device),
    }
