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

On placed weights (``sharding/rules.py::place_params``) each layer body
first gathers its FSDP-split weights (``sharding/tp.py``, inside the
remat region), and the "model" axis runs Megatron's tensor parallelism:
each rank computes its heads (:func:`attn_apply`; ``tp.head_range``
names them, and when the axis does not split them evenly the attention
weights are taken whole over "model" and sliced) and its columns of the
MLP, the row-parallel ``wo``/``w_down`` sums go through an all-reduce,
the embedding looks up its vocab block (:func:`_embed`) and
:func:`logits_fn` gives this rank's vocab columns.  An MoE layer keeps
its E/M experts a model rank (expert parallelism): ``moe_apply`` reads
the placement from the layer's ``moe`` module and sums its partial
combines over "model" (``models/moe.py``).
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.sharding import ctx, tp

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
    if cache is None and attn_split(p):
        return _attn_tp(p, x, cfg, positions, window), None
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


def attn_split(p) -> bool:
    """Whether the "model" axis splits any of the attention weights
    ``wq``/``wk``/``wv`` (columns) or ``wo`` (rows) of module ``p``."""
    return any(tp.model_split(p, n, d) for n, d in (
        ("wq", 1), ("wk", 1), ("wv", 1), ("wo", 0)))


def heads_even(p, cfg) -> bool:
    """Whether the stored blocks of ``wq`` (columns) and ``wo`` (rows)
    are this model rank's heads: the "model" axis (M) divides the H
    query heads and splits both."""
    return cfg.n_heads % tp.model_size() == 0 and \
        tp.model_split(p, "wq", 1) and tp.model_split(p, "wo", 0)


def local_heads(cfg) -> tuple[int, int]:
    """(h0, Hl): the first query head a model rank computes and how many
    (``tp.head_range``: H/M each when M divides H; 0 on some ranks when
    H < M)."""
    h0, h1 = tp.head_range(cfg.n_heads)
    return h0, h1 - h0


def local_q_o(p, cfg, h0: int, Hl: int):
    """(``wq``'s columns, ``wo``'s rows) of the query heads ``[h0, h0 +
    Hl)``: the stored blocks when they are those heads
    (:func:`heads_even`), else slices of the weights taken whole over
    "model" (``tp.whole_over_model``: gathered inside the remat region,
    the gradient reduce-scattered back to the block)."""
    if heads_even(p, cfg):
        return p.wq, p.wo
    cols = slice(h0 * cfg.head_dim, (h0 + Hl) * cfg.head_dim)
    return tp.whole_over_model(p, "wq", 1)[:, cols], \
        tp.whole_over_model(p, "wo", 0)[cols]


def local_kv(p, h, cfg, h0: int, Hl: int):
    """(k, v) of (B, S, ·, hd) for the query heads ``[h0, h0 + Hl)`` from
    ``h`` (which went through ``copy_to_model``): ``wk``/``wv``'s column
    blocks give the matching KV heads when M divides Kh (and so H), else
    each query head's KV head (by its global index) comes from the whole
    ``wk``/``wv`` (:func:`~repro_torch.sharding.tp.whole_over_model`)."""
    B, S, _ = h.shape
    H, Kh, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    M = tp.model_size()
    if Kh % M == 0 and tp.model_split(p, "wk", 1):
        k = (h @ p.wk).reshape(B, S, Kh // M, hd)
        v = (h @ p.wv).reshape(B, S, Kh // M, hd)
        return k, v
    kv = torch.arange(h0, h0 + Hl, device=h.device) // (H // Kh)
    k = (h @ tp.whole_over_model(p, "wk", 1)).reshape(B, S, Kh, hd)
    v = (h @ tp.whole_over_model(p, "wv", 1)).reshape(B, S, Kh, hd)
    return k[:, :, kv], v[:, :, kv]


def _attn_tp(p, x, cfg, positions, window: int = 0, *, causal: bool = True,
             rope: bool = True):
    """The training attention on this rank's heads (tensor parallelism
    over "model"): :func:`local_heads` names them, :func:`local_q_o`
    gives their ``wq`` columns and ``wo`` rows (the stored blocks, or
    slices of the whole weights when M does not split the heads evenly),
    :func:`local_kv` their KV heads; ``wo``'s partial sum is reduced over
    "model".  A rank with no heads runs the same collectives on empty
    heads and adds zeros.  ``causal`` and ``rope`` False: the encoder's
    bidirectional attention without positions (``models/encdec.py``)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    h0, Hl = local_heads(cfg)
    h = tp.copy_to_model(rms_norm(x, p.ln1, cfg.norm_eps))
    wq, wo = local_q_o(p, cfg, h0, Hl)
    q = (h @ wq).reshape(B, S, Hl, hd)
    k, v = local_kv(p, h, cfg, h0, Hl)
    if cfg.qk_norm:              # every model rank scales its own heads
        q = rms_norm(q, tp.copy_to_model(p.q_norm), cfg.norm_eps)
        k = rms_norm(k, tp.copy_to_model(p.k_norm), cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = blocked_attention(q, k, v, causal=causal, window=window)
    return tp.reduce_from_model(o.reshape(B, S, Hl * hd) @ wo)


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
    is.  ``fn(module, ...)`` of placed modules runs on their FSDP-gathered
    weights (:func:`~repro_torch.sharding.tp.with_gathered`), gathered
    inside the remat region."""
    fn = tp.with_gathered(fn)
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


def _vocab_block(n: int, ids):
    """(ids within this rank's block of ``n`` vocab rows, clamped; the
    mask of the ids the block holds)."""
    local = ids - tp.model_rank() * n
    hit = (local >= 0) & (local < n)
    return local.clamp(0, n - 1), hit


def _embed(params, tokens, embeds=None):
    if tp.model_split(params, "embed", 0):
        # vocab-parallel: this rank's rows, zeros elsewhere, summed
        local, hit = _vocab_block(params.embed.shape[0], tokens)
        x = params.embed[local] * hit[..., None].to(params.embed.dtype)
        x = tp.reduce_from_model(x)
    else:
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


def head_weight(params, cfg):
    """(the (D, V) output projection, or this rank's vocab columns of it;
    whether the "model" axis splits its vocab)."""
    if cfg.tie_embeddings:
        return params.embed.T, tp.model_split(params, "embed", 0)
    return params.lm_head, tp.model_split(params, "lm_head", 1)


def logits_fn(params, h, cfg):
    w, split = head_weight(params, cfg)
    if split:                     # each model rank's columns
        h = tp.copy_to_model(h)
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
