"""Decoder-only transformer LM (dense / MoE / VLM backbones): the
reference's ``models/transformer.py``.

The model is an ``nn.Module`` of parameters named as the reference's
parameter tree: ``embed``, ``layers`` (an ``nn.ModuleList`` of
:class:`Layer`, where the reference stacks them on a leading axis and
scans), ``ln_f`` and, untied, ``lm_head``.  The functions below take it
as ``params`` with the config, as the reference's do.

The KV cache is layer-leading, ``(L, B, capacity, Kh, hd)``, as in the
reference.  Prefill and decode write it in place (the reference returns a
new cache from a jitted call that donates the old one) and return it.
Serving runs under ``torch.inference_mode()``.  The training forward
rematerialises each layer body by ``cfg.remat`` (:func:`_remat`, the
reference's ``jax.checkpoint`` of its scan body); with gradients off
(serving) remat does nothing.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.sharding import ctx

from . import moe as moe_mod
from .attention import blocked_attention, decode_attention
from .layers import MLP, apply_rope, mlp_apply, rms_norm, weight, zeros


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------- params
class Layer(nn.Module):
    """One attention + MLP (or MoE) layer: ``ln1``, ``wq``, ``wk``,
    ``wv``, ``wo``, ``ln2``, ``q_norm``/``k_norm`` (qk-norm), ``mlp`` or
    ``moe``."""

    def __init__(self, cfg, *, gen=None, device=None):
        super().__init__()
        dt = _dtype(cfg)
        D, H, Kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
        self.ln1 = zeros(D, device)
        self.wq = weight(gen, (D, H * hd), dtype=dt, device=device)
        self.wk = weight(gen, (D, Kh * hd), dtype=dt, device=device)
        self.wv = weight(gen, (D, Kh * hd), dtype=dt, device=device)
        self.wo = weight(gen, (H * hd, D), dtype=dt, device=device)
        self.ln2 = zeros(D, device)
        if cfg.qk_norm:
            self.q_norm = zeros(hd, device)
            self.k_norm = zeros(hd, device)
        if cfg.family == "moe":
            self.moe = moe_mod.MoE(cfg, dt, gen=gen, device=device)
        else:
            self.mlp = MLP(D, cfg.d_ff, cfg.activation, dt, gen=gen,
                           device=device)


def embedding(cfg, gen, device):
    """The (vocab, d_model) token embedding."""
    return weight(gen, (cfg.vocab, cfg.d_model), 0.02, _dtype(cfg),
                  device=device)


def lm_head(cfg, gen, device):
    """The untied (d_model, vocab) output head."""
    return weight(gen, (cfg.d_model, cfg.vocab), 0.02, _dtype(cfg),
                  device=device)


class TransformerLM(nn.Module):
    def __init__(self, cfg, *, gen=None, device=None):
        super().__init__()
        self.embed = embedding(cfg, gen, device)
        self.layers = nn.ModuleList(
            Layer(cfg, gen=gen, device=device) for _ in range(cfg.n_layers))
        self.ln_f = zeros(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.lm_head = lm_head(cfg, gen, device)


# ----------------------------------------------------------------- layer
def attn_apply(p, x, cfg, positions, *, window: int = 0, cache=None,
               lengths=None):
    """Self-attention sublayer.  cache: (k, v) of (B, Smax, Kh, hd) → decode
    (S==1, the new k/v written at ``lengths``) or prefill (the first S
    positions written).  Returns (out, cache)."""
    B, S, D = x.shape
    H, Kh, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    q = (h @ p.wq).reshape(B, S, H, hd)
    k = (h @ p.wk).reshape(B, S, Kh, hd)
    v = (h @ p.wv).reshape(B, S, Kh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        o = blocked_attention(q, k, v, causal=True, window=window)
    elif S == 1:                                   # decode step
        ck, cv = cache
        bidx = torch.arange(B, device=x.device)
        ck[bidx, lengths] = k[:, 0].to(ck.dtype)
        cv[bidx, lengths] = v[:, 0].to(cv.dtype)
        o = decode_attention(q, ck, cv, lengths + 1, window=window)
    else:                                          # prefill, cache filled
        ck, cv = cache
        ck[:, :S] = k.to(ck.dtype)
        cv[:, :S] = v.to(cv.dtype)
        o = blocked_attention(q, k, v, causal=True, window=window)
    out = o.reshape(B, S, H * hd) @ p.wo
    return out, cache


def layer_apply(p, x, cfg, positions, *, window: int = 0, cache=None,
                lengths=None):
    a, cache = attn_apply(p, x, cfg, positions, window=window, cache=cache,
                          lengths=lengths)
    x = x + a
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    if cfg.family == "moe":
        f = moe_mod.moe_apply(p.moe, h, cfg)
    else:
        f = mlp_apply(p.mlp, h, cfg.activation)
    return x + f, cache


def _save_dots(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of matrix
    products with no batch dimension (``aten.mm``: an activation times a
    weight), recompute everything else (``aten.bmm`` of attention and
    the expert einsums included)."""
    from torch.utils.checkpoint import CheckpointPolicy
    del ctx, args, kwargs
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg):
    """``fn`` rematerialised in the backward by ``cfg.remat`` (the
    reference's ``_remat``): ``"none"`` keeps every activation, ``"full"``
    keeps only ``fn``'s inputs, ``"dots"`` also keeps the outputs of
    :func:`_save_dots`' products.  With gradients off ``fn`` runs as it
    is."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def _body(cfg, positions):
    """One layer of the training forward, as :func:`_remat` wraps it."""
    def body(lp, x):
        x, _ = layer_apply(lp, x, cfg, positions)
        return ctx.constrain_act(x)
    return _remat(body, cfg)


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device).expand(B, S)


def _embed(params, tokens, embeds=None):
    x = params.embed[tokens]
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return ctx.constrain_act(x)


# --------------------------------------------------------------- forward
def forward(params, tokens, cfg, *, embeds=None):
    """tokens: (B, S) → final hidden states (B, S, D).

    embeds: optional (B, S_img, D) precomputed frontend embeddings (VLM stub)
    prepended to the token embeddings.
    """
    x = _embed(params, tokens, embeds)
    B, S, _ = x.shape
    body = _body(cfg, _positions(B, S, x.device))
    for lp in params.layers:
        x = body(lp, x)
    return rms_norm(x, params.ln_f, cfg.norm_eps)


def logits_fn(params, h, cfg):
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    return (h @ w.to(h.dtype)).float()


# ------------------------------------------------------------- serving
def init_cache(cfg, batch: int, capacity: int, dtype=torch.bfloat16, *,
               device=None):
    L, Kh, hd = cfg.n_layers, cfg.n_kv, cfg.head_dim
    shape = (L, batch, capacity, Kh, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill(params, tokens, cfg, cache, *, embeds=None):
    """Forward pass that also fills the KV cache. Returns (hidden, cache)."""
    x = _embed(params, tokens, embeds)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    for i, lp in enumerate(params.layers):
        x, _ = layer_apply(lp, x, cfg, positions,
                           cache=(cache["k"][i], cache["v"][i]))
        x = ctx.constrain_act(x)
    return rms_norm(x, params.ln_f, cfg.norm_eps), cache


def decode_step(params, tokens, cfg, cache, lengths):
    """tokens: (B, 1); lengths: (B,) current context lengths.
    Returns (logits (B,1,V), cache)."""
    x = params.embed[tokens]
    positions = lengths[:, None]
    for i, lp in enumerate(params.layers):
        x, _ = layer_apply(lp, x, cfg, positions,
                           cache=(cache["k"][i], cache["v"][i]),
                           lengths=lengths)
    h = rms_norm(x, params.ln_f, cfg.norm_eps)
    return logits_fn(params, h, cfg), cache
