"""RG-LRU recurrent blocks (RecurrentGemma) — gated linear recurrence (the
reference's ``models/rglru.py``).

    r_t = σ(W_r x_t)            (recurrence gate)
    i_t = σ(W_i x_t)            (input gate)
    a_t = exp(-c · softplus(Λ) ⊙ r_t)
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

Train/prefill composes the affine maps (a, b) with a log-depth doubling
scan (:func:`affine_scan`; the reference uses
``jax.lax.associative_scan``, which torch lacks).  Decode is the
single-step recurrence with a carried state.

On placed weights whose "model" axis splits R (training only;
``sharding/rules.py::place_params``) each model rank runs its contiguous
block of R: ``w_x``, ``w_gate_in`` and ``conv_w`` give its block of u,
the gate and the conv; the gates' products with ``w_r``/``w_i`` (this
rank's columns) contract over the whole R, so u is gathered over "model"
for them; the product ``i ⊙ u``, the scan (elementwise in R) and
``hs ⊙ gate`` stay local, and ``w_out``'s row block is row-parallel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding import tp

from .layers import causal_conv1d, gelu, weight

_C = 8.0     # RecurrentGemma's fixed temperature


class RGLRU(nn.Module):
    """``w_x``, ``w_gate_in``, ``conv_w``, ``w_r``, ``w_i``, ``w_out``
    (model dtype) and the float32 ``lam`` (Λ)."""

    def __init__(self, cfg, dtype, *, gen=None, device=None):
        super().__init__()
        D = cfg.d_model
        R = cfg.d_rnn or D

        def dense(shape, scale=None):
            return weight(gen, shape, scale, dtype, device=device)

        self.w_x = dense((D, R))                   # input branch
        self.w_gate_in = dense((D, R))             # gating branch
        self.conv_w = dense((cfg.conv_kernel, R), scale=0.5)
        self.w_r = dense((R, R))
        self.w_i = dense((R, R))
        self.lam = nn.Parameter(torch.full((R,), 0.7, dtype=torch.float32,
                                           device=device))   # Λ init
        self.w_out = dense((R, D))


def _gates(p, u, u_whole=None, lam=None):
    """(a, b) of the recurrence for the channels of ``u``; ``u_whole``
    (every channel, for the gates' products) and ``lam`` (Λ of ``u``'s
    channels) default to ``u`` and ``p.lam``."""
    uf = u.float()
    uw = uf if u_whole is None else u_whole.float()
    r = torch.sigmoid(uw @ p.w_r.float())
    i = torch.sigmoid(uw @ p.w_i.float())
    log_a = -_C * F.softplus(p.lam if lam is None else lam) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * uf)
    return a, b


def affine_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along axis 1,
    in log2(S) doubling steps: after the step of span s, entry t holds the
    composition of the maps t-2s+1..t, the later map applied last, as the
    reference's ``combine``: (a1, b1) then (a2, b2) is (a2 a1, a2 b1 + b2).
    Returns (a_s, b_s); b_s is the state sequence."""
    S = a.shape[1]
    span = 1
    while span < S:
        a_prev, b_prev = a[:, :-span], b[:, :-span]
        a_cur, b_cur = a[:, span:], b[:, span:]
        a = torch.cat([a[:, :span], a_cur * a_prev], dim=1)
        b = torch.cat([b[:, :span], a_cur * b_prev + b_cur], dim=1)
        span *= 2
    return a, b


def rglru_block(p, x, cfg, *, state=None):
    """One recurrent block. x: (B,S,D) → (B,S,D); state carries
    {"conv": (B,K-1,R), "h": (B,R)} for decode."""
    S = x.shape[1]
    split = state is None and tp.model_split(p, "w_x", 1)
    if split:                            # this model rank's block of R
        x = tp.copy_to_model(x)
    u = x @ p.w_x
    gate = gelu(x @ p.w_gate_in)
    u, conv_cache = causal_conv1d(
        u, p.conv_w, None if state is None else state["conv"])

    if split:
        r0, r1 = tp.model_rank() * u.shape[-1], \
            (tp.model_rank() + 1) * u.shape[-1]
        a, b = _gates(p, u, tp.gather(u, {2: ("model",)}),
                      tp.copy_to_model(p.lam)[r0:r1])
    else:
        a, b = _gates(p, u)                               # (B,S,R) f32
    if state is not None and S == 1:
        h = a[:, 0] * state["h"] + b[:, 0]
        hs = h[:, None]
        new_state = {"conv": conv_cache, "h": h}
    else:
        if state is not None:
            # the carried state folds into the first map's offset
            b = torch.cat([b[:, :1] + (a[:, 0] * state["h"])[:, None],
                           b[:, 1:]], dim=1)
        _, hs = affine_scan(a, b)
        new_state = None if state is None else \
            {"conv": conv_cache, "h": hs[:, -1]}
    y = (hs * gate.float()).to(x.dtype) @ p.w_out
    return (tp.reduce_from_model(y) if split else y), new_state


def rglru_init_state(cfg, batch: int, dtype=torch.float32, *, device=None):
    R = cfg.d_rnn or cfg.d_model
    return {"conv": torch.zeros((batch, cfg.conv_kernel - 1, R), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, R), dtype=torch.float32,
                             device=device)}
