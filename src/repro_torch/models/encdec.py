"""Whisper-style encoder–decoder (the reference's ``models/encdec.py``).

The conv audio frontend is a stub, as in the reference: the model consumes
precomputed frame embeddings (B, enc_seq, d_model).  Encoder layers use
bidirectional blocked attention with sinusoidal positions; decoder layers
use causal self-attention (RoPE, the reference's documented deviation
from Whisper's learned positions) plus cross-attention over the encoder
output.  The cache holds the decoder's self-attention k/v and the
cross-attention k/v of the encoder states, layer-leading.

On placed weights whose "model" axis splits the attention (training
only; ``sharding/rules.py::place_params``) the encoder's and the
cross-attention's heads split over it as the decoder's self-attention's
(``transformer._attn_tp``): this rank's ``wq`` columns and KV heads, and
``wo``'s rows summed over "model"; when the axis does not split the
heads evenly (Whisper-small's 12 heads on 16, or on 8), each rank takes
its ``tp.head_range`` of the whole weights (``transformer.local_q_o``).
The encoder states enter the decoder's cross-attention through
``copy_to_model`` once, so their gradient sums over "model" once for
every layer.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.sharding import ctx, tp

from .attention import blocked_attention, decode_attention
from .layers import mlp_apply, rms_norm, sinusoidal_pos, weight, zeros
from .transformer import Layer, _attn_tp, _dtype, _embed, _positions, \
    _remat, attn_apply, attn_split, embedding, lm_head, local_heads, \
    local_kv, local_q_o, logits_fn


class Cross(nn.Module):
    """Cross-attention weights: ``ln``, ``wq``, ``wk``, ``wv``, ``wo``."""

    def __init__(self, cfg, dtype, *, gen=None, device=None):
        super().__init__()
        D, H, Kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim

        self.ln = zeros(D, device)
        self.wq = weight(gen, (D, H * hd), dtype=dtype, device=device)
        self.wk = weight(gen, (D, Kh * hd), dtype=dtype, device=device)
        self.wv = weight(gen, (D, Kh * hd), dtype=dtype, device=device)
        self.wo = weight(gen, (H * hd, D), dtype=dtype, device=device)


class EncDec(nn.Module):
    def __init__(self, cfg, *, gen=None, device=None):
        super().__init__()
        dt = _dtype(cfg)
        self.embed = embedding(cfg, gen, device)
        self.enc_layers = nn.ModuleList(
            Layer(cfg, gen=gen, device=device)
            for _ in range(cfg.enc_layers))
        self.dec_layers = nn.ModuleList(
            Layer(cfg, gen=gen, device=device) for _ in range(cfg.n_layers))
        self.cross = nn.ModuleList(
            Cross(cfg, dt, gen=gen, device=device)
            for _ in range(cfg.n_layers))
        self.ln_enc = zeros(cfg.d_model, device)
        self.ln_f = zeros(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.lm_head = lm_head(cfg, gen, device)


# ---------------------------------------------------------------- encoder
def encode(params, frames, cfg):
    """frames: (B, enc_seq, D) stub embeddings → encoder states."""
    B, S, D = frames.shape
    dt = _dtype(cfg)
    x = frames.to(dt) + sinusoidal_pos(S, D, frames.device).to(dt)

    def body(lp, x):
        if attn_split(lp):               # this model rank's heads
            x = x + _attn_tp(lp, x, cfg, None, causal=False, rope=False)
        else:
            h = rms_norm(x, lp.ln1, cfg.norm_eps)
            q = (h @ lp.wq).reshape(B, S, cfg.n_heads, cfg.head_dim)
            k = (h @ lp.wk).reshape(B, S, cfg.n_kv, cfg.head_dim)
            v = (h @ lp.wv).reshape(B, S, cfg.n_kv, cfg.head_dim)
            o = blocked_attention(q, k, v, causal=False)
            x = x + o.reshape(B, S, -1) @ lp.wo
        h = rms_norm(x, lp.ln2, cfg.norm_eps)
        return ctx.constrain_act(x + mlp_apply(lp.mlp, h, cfg.activation))

    x = ctx.constrain_act(x)
    body = _remat(body, cfg)
    for lp in params.enc_layers:
        x = body(lp, x)
    return rms_norm(x, params.ln_enc, cfg.norm_eps)


def _cross_kv(xp, enc, cfg):
    """The cross-attention's k/v of the encoder states; on a model split,
    those of this rank's heads (``enc`` went through ``copy_to_model``)."""
    if attn_split(xp):
        return local_kv(xp, enc, cfg, *local_heads(cfg))
    B, Se, _ = enc.shape
    k = (enc @ xp.wk).reshape(B, Se, cfg.n_kv, cfg.head_dim)
    v = (enc @ xp.wv).reshape(B, Se, cfg.n_kv, cfg.head_dim)
    return k, v


def _cross_apply(xp, x, k, v, cfg):
    B, S, D = x.shape
    split = attn_split(xp)
    h = rms_norm(x, xp.ln, cfg.norm_eps)
    if split:                            # this model rank's heads
        h = tp.copy_to_model(h)
        h0, Hl = local_heads(cfg)
        wq, wo = local_q_o(xp, cfg, h0, Hl)
    else:
        Hl, wq, wo = cfg.n_heads, xp.wq, xp.wo
    q = (h @ wq).reshape(B, S, Hl, cfg.head_dim)
    o = blocked_attention(q, k, v, causal=False)
    out = o.reshape(B, S, Hl * cfg.head_dim) @ wo
    return tp.reduce_from_model(out) if split else out


def _decoder(params, x, enc, cfg, positions, cache=None):
    """The decoder stack over (B, S) positions; with ``cache``, each
    layer's self-attention k/v and cross k/v are written into it.  With
    no cache (the teacher-forced training pass) each layer body is
    rematerialised by ``cfg.remat``."""
    def body(lp, xp, x, enc, i=None):
        kv = None if i is None else (cache["k"][i], cache["v"][i])
        a, _ = attn_apply(lp, x, cfg, positions, cache=kv)
        x = x + a
        k, v = _cross_kv(xp, enc, cfg)
        if i is not None:
            cache["xk"][i] = k.to(cache["xk"].dtype)
            cache["xv"][i] = v.to(cache["xv"].dtype)
        x = x + _cross_apply(xp, x, k, v, cfg)
        h = rms_norm(x, lp.ln2, cfg.norm_eps)
        return ctx.constrain_act(x + mlp_apply(lp.mlp, h, cfg.activation))

    train = _remat(body, cfg)
    if cache is None and any(attn_split(xp) for xp in params.cross):
        enc = tp.copy_to_model(enc)
    for i, (lp, xp) in enumerate(zip(params.dec_layers, params.cross)):
        x = train(lp, xp, x, enc) if cache is None else \
            body(lp, xp, x, enc, i)
    return rms_norm(x, params.ln_f, cfg.norm_eps)


# ---------------------------------------------------------------- decoder
def decode_train(params, tokens, enc, cfg):
    """Teacher-forced decoder pass. tokens: (B, S) → hidden (B, S, D)."""
    B, S = tokens.shape
    return _decoder(params, _embed(params, tokens), enc, cfg,
                    _positions(B, S, tokens.device))


def init_cache(cfg, batch: int, capacity: int, dtype=torch.bfloat16, *,
               device=None):
    L, Kh, hd = cfg.n_layers, cfg.n_kv, cfg.head_dim

    def z(S):
        return torch.zeros((L, batch, S, Kh, hd), dtype=dtype, device=device)

    return {"k": z(capacity), "v": z(capacity),
            "xk": z(cfg.enc_seq), "xv": z(cfg.enc_seq)}


def prefill(params, tokens, frames, cfg, cache):
    """Encode + teacher-forced decoder prefill; fills self & cross caches."""
    enc = encode(params, frames, cfg)
    B, S = tokens.shape
    h = _decoder(params, params.embed[tokens], enc, cfg,
                 _positions(B, S, tokens.device), cache)
    return h, cache


def decode_step(params, tokens, cfg, cache, lengths):
    x = params.embed[tokens]
    B = x.shape[0]
    for i, (lp, xp) in enumerate(zip(params.dec_layers, params.cross)):
        a, _ = attn_apply(lp, x, cfg, lengths[:, None],
                          cache=(cache["k"][i], cache["v"][i]),
                          lengths=lengths)
        x = x + a
        h = rms_norm(x, xp.ln, cfg.norm_eps)
        q = (h @ xp.wq).reshape(B, 1, cfg.n_heads, cfg.head_dim)
        xk, xv = cache["xk"][i], cache["xv"][i]
        xo = decode_attention(
            q, xk.to(x.dtype), xv.to(x.dtype),
            torch.full((B,), xk.shape[1], dtype=torch.long,
                       device=x.device))
        x = x + xo.reshape(B, 1, -1) @ xp.wo
        h = rms_norm(x, lp.ln2, cfg.norm_eps)
        x = x + mlp_apply(lp.mlp, h, cfg.activation)
    h = rms_norm(x, params.ln_f, cfg.norm_eps)
    return logits_fn(params, h, cfg), cache
