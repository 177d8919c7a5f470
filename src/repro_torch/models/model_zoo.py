"""build(cfg) → ModelBundle: one uniform interface over all families (the
reference's ``models/model_zoo.py``).

batch dicts (tensors on the bundle's device; token ids are integers):
  dense/moe/ssm/hybrid : {"tokens", "labels"}
  vlm                  : + {"image_embeds" (B, n_img, D)}  (stub frontend)
  encdec               : {"frames" (B, enc_seq, D), "tokens", "labels"}

``params`` is the family's ``nn.Module``.  ``bundle.init(gen)`` draws it
from the ``torch.Generator`` ``gen`` (on the bundle's device; ``None``
leaves the weights uninitialised for a caller that loads them), and
:func:`params_from_numpy` loads the reference's parameter tree into it.
Caches are dicts of layer-leading tensors, written in place by prefill
and decode.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from repro_torch.core.grid import resolve_device
from repro_torch.sharding import ctx, tp

from . import encdec, rglru, ssm, transformer
from .attention import blocked_attention, decode_attention
from .layers import MLP, apply_rope, mlp_apply, rms_norm, zeros
from .transformer import Layer, _dtype, _remat, embedding, head_weight, \
    layer_apply, lm_head, logits_fn


# ------------------------------------------------------------------ loss
def chunked_xent(params, h, labels, cfg, chunk: int = 512, mask=None):
    """Sequence-chunked softmax cross-entropy; never materializes
    (B, S, V): logits are built per chunk, and with gradients on each
    chunk's body is rematerialised in the backward (the reference's
    ``jax.checkpoint``), so the backward holds one chunk's (B, chunk, V)
    float32 logits at a time.  ``labels`` are int64 (``torch.gather``).

    On placed weights whose "model" axis splits the vocab, each rank
    builds its vocab columns of the logits: the max and the sum of
    exponentials are all-reduced over "model", and the gold logit comes
    from the rank that holds it (zeros elsewhere, summed)."""
    B, S, D = h.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    w, split = head_weight(params, cfg)
    if split:
        h = tp.copy_to_model(h)

    def body(hc, lc, mc):
        logits = (hc @ w.to(hc.dtype)).float()              # (B,chunk,V) f32
        if split:
            lse, gold = _vocab_parallel_terms(logits, lc)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, lc[..., None])[..., 0]
        nll = lse - gold
        if mc is not None:
            nll = nll * mc
        return nll.sum()

    if torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint
        run = functools.partial(checkpoint, body, use_reentrant=False)
    else:
        run = body
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for idx in range(S // chunk):
        sl = slice(idx * chunk, (idx + 1) * chunk)
        total = total + run(h[:, sl], labels[:, sl],
                            None if mask is None else mask[:, sl])
    if mask is None:
        return total / (B * S)
    return total / torch.clamp(mask.sum(), min=1.0)


def _vocab_parallel_terms(logits, labels):
    """(log-sum-exp, gold logit) of each row from this rank's vocab
    columns ``logits``."""
    local, hit = transformer._vocab_block(logits.shape[-1], labels)
    m = tp.max_over_model(logits.detach().amax(-1))
    se = torch.exp(logits - m[..., None]).sum(-1)
    gold = torch.gather(logits, -1, local[..., None])[..., 0] * hit
    se, gold = tp.reduce_from_model(torch.stack([se, gold])).unbind(0)
    return m + torch.log(se), gold


def _state(tree, i: int):
    """Layer ``i`` of a layer-leading state dict (views)."""
    return {k: v[i] for k, v in tree.items()}


def _store(tree, i: int, new) -> None:
    """Write a layer's new state into slot ``i`` of the cache, in place
    (cast to the cache's dtype)."""
    for k, v in new.items():
        tree[k][i].copy_(v)


def _stacked(state, n: int, device):
    """Zeros shaped as the state dict ``state`` (built on the meta
    device), with a leading axis of ``n``, on ``device``."""
    return {k: torch.zeros((n,) + v.shape, dtype=v.dtype, device=device)
            for k, v in state.items()}


# ------------------------------------------------------------ SSM family
class SSMLayer(nn.Module):
    def __init__(self, cfg, *, gen=None, device=None):
        super().__init__()
        self.ln = zeros(cfg.d_model, device)
        self.ssm = ssm.SSMBlock(cfg, _dtype(cfg), gen=gen, device=device)


class SSMLM(nn.Module):
    def __init__(self, cfg, *, gen=None, device=None):
        super().__init__()
        self.embed = embedding(cfg, gen, device)
        self.layers = nn.ModuleList(
            SSMLayer(cfg, gen=gen, device=device)
            for _ in range(cfg.n_layers))
        self.ln_f = zeros(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.lm_head = lm_head(cfg, gen, device)


def ssm_forward(params, tokens, cfg):
    x = transformer._embed(params, tokens)

    def body(lp, x):
        h = rms_norm(x, lp.ln, cfg.norm_eps)
        y, _ = ssm.ssm_block(lp.ssm, h, cfg)
        return ctx.constrain_act(x + y)

    body = _remat(body, cfg)
    for lp in params.layers:
        x = body(lp, x)
    return rms_norm(x, params.ln_f, cfg.norm_eps)


def ssm_init_cache(cfg, batch: int, capacity: int, dtype=torch.bfloat16,
                   *, device=None):
    return _stacked(ssm.ssm_init_state(cfg, batch, dtype, device="meta"),
                    cfg.n_layers, device)


def _ssm_run(params, tokens, cfg, cache):
    x = params.embed[tokens]
    for i, lp in enumerate(params.layers):
        h = rms_norm(x, lp.ln, cfg.norm_eps)
        y, new_st = ssm.ssm_block(lp.ssm, h, cfg, state=_state(cache, i))
        _store(cache, i, new_st)
        x = x + y
    return rms_norm(x, params.ln_f, cfg.norm_eps)


def ssm_prefill(params, tokens, cfg, cache):
    return _ssm_run(params, tokens, cfg, cache), cache


def ssm_decode(params, tokens, cfg, cache, lengths):
    del lengths                      # the state carries the position
    h = _ssm_run(params, tokens, cfg, cache)
    return logits_fn(params, h, cfg), cache


# --------------------------------------------------------- hybrid family
def _hybrid_counts(cfg):
    pat = cfg.block_pattern
    n_groups = cfg.n_layers // len(pat)
    n_tail = cfg.n_layers - n_groups * len(pat)
    return n_groups, n_tail


class RecBlock(nn.Module):
    def __init__(self, cfg, *, gen=None, device=None):
        super().__init__()
        dt = _dtype(cfg)
        self.ln = zeros(cfg.d_model, device)
        self.rglru = rglru.RGLRU(cfg, dt, gen=gen, device=device)
        self.ln2 = zeros(cfg.d_model, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.activation, dt, gen=gen,
                       device=device)


class HybridGroup(nn.Module):
    """One period of the pattern: two recurrent blocks, then local
    attention."""

    def __init__(self, cfg, *, gen=None, device=None):
        super().__init__()
        self.rec1 = RecBlock(cfg, gen=gen, device=device)
        self.rec2 = RecBlock(cfg, gen=gen, device=device)
        self.attn = Layer(cfg, gen=gen, device=device)


class HybridLM(nn.Module):
    def __init__(self, cfg, *, gen=None, device=None):
        super().__init__()
        n_groups, n_tail = _hybrid_counts(cfg)
        self.embed = embedding(cfg, gen, device)
        self.groups = nn.ModuleList(
            HybridGroup(cfg, gen=gen, device=device)
            for _ in range(n_groups))
        self.ln_f = zeros(cfg.d_model, device)
        if n_tail:
            self.tail = nn.ModuleList(
                RecBlock(cfg, gen=gen, device=device)
                for _ in range(n_tail))
        if not cfg.tie_embeddings:
            self.lm_head = lm_head(cfg, gen, device)


def _rec_apply(p, x, cfg, state=None):
    h = rms_norm(x, p.ln, cfg.norm_eps)
    y, new_state = rglru.rglru_block(p.rglru, h, cfg, state=state)
    x = x + y
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + mlp_apply(p.mlp, h, cfg.activation), new_state


def hybrid_forward(params, tokens, cfg):
    x = transformer._embed(params, tokens)
    B, S = tokens.shape
    positions = transformer._positions(B, S, x.device)

    def body(gp, x):
        x, _ = _rec_apply(gp.rec1, x, cfg)
        x, _ = _rec_apply(gp.rec2, x, cfg)
        x, _ = layer_apply(gp.attn, x, cfg, positions,
                           window=cfg.local_window)
        return ctx.constrain_act(x)

    def tbody(tp, x):
        return _rec_apply(tp, x, cfg)[0]

    body, tbody = _remat(body, cfg), _remat(tbody, cfg)
    for gp in params.groups:
        x = body(gp, x)
    for tp in getattr(params, "tail", ()):
        x = tbody(tp, x)
    return rms_norm(x, params.ln_f, cfg.norm_eps)


def hybrid_init_cache(cfg, batch: int, capacity: int, dtype=torch.bfloat16,
                      *, device=None):
    n_groups, n_tail = _hybrid_counts(cfg)
    W = min(cfg.local_window or capacity, capacity)
    rec = rglru.rglru_init_state(cfg, batch, device="meta")
    kv = (n_groups, batch, W, cfg.n_kv, cfg.head_dim)
    cache = {"rec1": _stacked(rec, n_groups, device),
             "rec2": _stacked(rec, n_groups, device),
             "k": torch.zeros(kv, dtype=dtype, device=device),
             "v": torch.zeros(kv, dtype=dtype, device=device)}
    if n_tail:
        cache["tail"] = _stacked(rec, n_tail, device)
    return cache


def _attn_qkv(lp, x, cfg, positions):
    B, S, _ = x.shape
    H, Kh, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    q = (h @ lp.wq).reshape(B, S, H, hd)
    k = (h @ lp.wk).reshape(B, S, Kh, hd)
    v = (h @ lp.wv).reshape(B, S, Kh, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _attn_out(lp, x, o, cfg):
    B, S, _ = x.shape
    x = x + o.reshape(B, S, -1) @ lp.wo
    h2 = rms_norm(x, lp.ln2, cfg.norm_eps)
    return x + mlp_apply(lp.mlp, h2, cfg.activation)


def _hybrid_attn_prefill(lp, x, cfg, positions, ck, cv):
    """Local-attention sub-block; fills the ring cache (capacity W) with the
    last W roped keys/values at slots = position % W (ring invariant)."""
    S = x.shape[1]
    W = ck.shape[1]
    q, k, v = _attn_qkv(lp, x, cfg, positions)
    o = blocked_attention(q, k, v, causal=True, window=cfg.local_window)
    tail = min(W, S)
    slots = torch.arange(S - tail, S, device=x.device) % W
    ck[:, slots] = k[:, -tail:].to(ck.dtype)
    cv[:, slots] = v[:, -tail:].to(cv.dtype)
    return _attn_out(lp, x, o, cfg)


def _hybrid_attn_decode(lp, x, cfg, ck, cv, lengths):
    """Single-token local attention against the ring cache."""
    B = x.shape[0]
    W = ck.shape[1]
    q, k, v = _attn_qkv(lp, x, cfg, lengths[:, None])
    slot = lengths % W
    bidx = torch.arange(B, device=x.device)
    ck[bidx, slot] = k[:, 0].to(ck.dtype)
    cv[bidx, slot] = v[:, 0].to(cv.dtype)
    filled = torch.clamp(lengths + 1, max=W)
    o = decode_attention(q, ck, cv, filled)
    return _attn_out(lp, x, o, cfg)


def _hybrid_run(params, tokens, cfg, cache, lengths=None):
    """Prefill (``lengths`` None: every position of ``tokens``) or one
    decode step, writing every layer's state into ``cache``."""
    x = params.embed[tokens]
    B, S = tokens.shape
    positions = transformer._positions(B, S, x.device)
    for g, gp in enumerate(params.groups):
        for name in ("rec1", "rec2"):
            x, st = _rec_apply(getattr(gp, name), x, cfg,
                               state=_state(cache[name], g))
            _store(cache[name], g, st)
        ck, cv = cache["k"][g], cache["v"][g]
        if lengths is None:
            x = _hybrid_attn_prefill(gp.attn, x, cfg, positions, ck, cv)
        else:
            x = _hybrid_attn_decode(gp.attn, x, cfg, ck, cv, lengths)
    for t, tp in enumerate(getattr(params, "tail", ())):
        x, st = _rec_apply(tp, x, cfg, state=_state(cache["tail"], t))
        _store(cache["tail"], t, st)
    return rms_norm(x, params.ln_f, cfg.norm_eps)


def hybrid_prefill(params, tokens, cfg, cache):
    return _hybrid_run(params, tokens, cfg, cache), cache


def hybrid_decode(params, tokens, cfg, cache, lengths):
    h = _hybrid_run(params, tokens, cfg, cache, lengths)
    return logits_fn(params, h, cfg), cache


# ---------------------------------------------------------------- bundles
@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: Any
    device: torch.device
    init: Callable                    # (gen) -> params (nn.Module)
    forward: Callable                 # (params, batch) -> hidden
    loss: Callable                    # (params, batch) -> scalar
    init_cache: Callable              # (batch, capacity, dtype) -> cache
    prefill: Callable                 # (params, batch, cache) -> (lg, cache)
    decode: Callable                  # (params, tok, cache, len) -> (lg, c)


def _bundle(cfg, device, model_cls, fwd, init_cache, prefill, decode,
            loss=None):
    def default_loss(params, batch):
        return chunked_xent(params, fwd(params, batch), batch["labels"],
                            cfg)

    def prefill_fn(params, batch, cache):
        h, cache = prefill(params, batch, cache)
        return logits_fn(params, h[:, -1:], cfg), cache

    return ModelBundle(
        cfg=cfg, device=device,
        init=lambda gen: model_cls(cfg, gen=gen, device=device),
        forward=fwd, loss=loss or default_loss,
        init_cache=functools.partial(init_cache, cfg, device=device),
        prefill=prefill_fn, decode=decode)


def _lm_bundle(cfg, device):
    def fwd(params, batch):
        return transformer.forward(params, batch["tokens"], cfg,
                                   embeds=batch.get("image_embeds"))

    def loss(params, batch):
        h = fwd(params, batch)
        labels = batch["labels"]
        if cfg.family == "vlm":
            h = h[:, -labels.shape[1]:]       # loss over text positions only
        return chunked_xent(params, h, labels, cfg)

    return _bundle(
        cfg, device, transformer.TransformerLM, fwd, transformer.init_cache,
        lambda params, batch, cache: transformer.prefill(
            params, batch["tokens"], cfg, cache,
            embeds=batch.get("image_embeds")),
        lambda params, tokens, cache, lengths: transformer.decode_step(
            params, tokens, cfg, cache, lengths),
        loss)


def _ssm_bundle(cfg, device):
    return _bundle(
        cfg, device, SSMLM,
        lambda params, batch: ssm_forward(params, batch["tokens"], cfg),
        ssm_init_cache,
        lambda params, batch, cache: ssm_prefill(
            params, batch["tokens"], cfg, cache),
        lambda params, tokens, cache, lengths: ssm_decode(
            params, tokens, cfg, cache, lengths))


def _hybrid_bundle(cfg, device):
    return _bundle(
        cfg, device, HybridLM,
        lambda params, batch: hybrid_forward(params, batch["tokens"], cfg),
        hybrid_init_cache,
        lambda params, batch, cache: hybrid_prefill(
            params, batch["tokens"], cfg, cache),
        lambda params, tokens, cache, lengths: hybrid_decode(
            params, tokens, cfg, cache, lengths))


def _encdec_bundle(cfg, device):
    def fwd(params, batch):
        enc = encdec.encode(params, batch["frames"], cfg)
        return encdec.decode_train(params, batch["tokens"], enc, cfg)

    return _bundle(
        cfg, device, encdec.EncDec, fwd, encdec.init_cache,
        lambda params, batch, cache: encdec.prefill(
            params, batch["tokens"], batch["frames"], cfg, cache),
        lambda params, tokens, cache, lengths: encdec.decode_step(
            params, tokens, cfg, cache, lengths))


_BUILDERS = {
    "dense": _lm_bundle,
    "moe": _lm_bundle,
    "vlm": _lm_bundle,
    "ssm": _ssm_bundle,
    "encdec": _encdec_bundle,
    "hybrid": _hybrid_bundle,
}


def build(cfg, *, device=None) -> ModelBundle:
    """The family's bundle on ``device`` (CUDA when omitted; raises
    without a CUDA device, as every entry point of the port does)."""
    return _BUILDERS[cfg.family](cfg, resolve_device(device))


# ------------------------------------------------- reference state trees
# The reference's parameter tree stacks each layer group on a leading
# axis; the port holds the same tensors as entries of an ``nn.ModuleList``
# of that name.  These functions carry trees across by name: a stacked
# leaf's layer ``i`` is entry ``i`` of the list.

def stacked_lists(model) -> set[str]:
    """The model's top-level ``nn.ModuleList``s: the reference's stacked
    layer groups."""
    return {name for name, m in model.named_children()
            if isinstance(m, nn.ModuleList)}


def reference_name(name: str, lists) -> tuple[str, int | None]:
    """``(the reference leaf's dotted path, layer index or None)`` of the
    port parameter ``name`` ("layers.3.moe.w_up" → ("layers.moe.w_up",
    3))."""
    top, _, rest = name.partition(".")
    if top in lists:
        idx, _, rest = rest.partition(".")
        return f"{top}.{rest}", int(idx)
    return name, None


def reference_ndims(model) -> dict[str, int]:
    """Each parameter's rank in the reference's tree: its own, plus 1
    inside a stacked layer group (the reference's optimizer decays a leaf
    by that rank)."""
    lists = stacked_lists(model)
    return {n: p.ndim + (reference_name(n, lists)[1] is not None)
            for n, p in model.named_parameters()}


def tree_of(model, named: dict, combine=list) -> dict:
    """The nested reference-shaped tree of ``named`` (values keyed by the
    model's parameter names): a stacked leaf is ``combine`` of its layers'
    values, in layer order (a list by default)."""
    lists = stacked_lists(model)
    flat: dict[str, object] = {}
    layers: dict[str, dict[int, object]] = {}
    for name, value in named.items():
        ref, idx = reference_name(name, lists)
        if idx is None:
            flat[ref] = value
        else:
            layers.setdefault(ref, {})[idx] = value
    for ref, by_idx in layers.items():
        flat[ref] = combine([by_idx[i] for i in range(len(by_idx))])
    tree: dict = {}
    for ref, value in flat.items():
        *path, leaf = ref.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _as_tensor(x) -> torch.Tensor:
    """A host tensor of a leaf: a tensor as it is; a numpy array as a
    tensor (a numpy bfloat16, which torch cannot wrap, through float32:
    exact)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr)
    return torch.from_numpy(arr)


def split_tree(model, tree) -> dict:
    """``tree`` (reference-shaped) as values keyed by the model's
    parameter names; every leaf must match a parameter and every
    parameter a leaf."""
    lists = stacked_lists(model)
    leaves = dict(_flatten(tree))
    out, used = {}, set()
    for name, _ in model.named_parameters():
        ref, idx = reference_name(name, lists)
        if ref not in leaves:
            raise KeyError(f"no leaf {ref!r} for parameter {name!r}")
        used.add(ref)
        leaf = _as_tensor(leaves[ref])
        out[name] = leaf if idx is None else leaf[idx]
    extra = set(leaves) - used
    if extra:
        raise KeyError(f"leaves with no parameter: {sorted(extra)}")
    return out


def load_tree(model, tree) -> None:
    """Copy the reference-shaped parameter tree ``tree`` (numpy arrays or
    tensors) into ``model``'s parameters, in place (cast to each
    parameter's dtype and device)."""
    values = split_tree(model, tree)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(values[name])


def params_from_numpy(cfg, tree, *, device):
    """The port's model holding the reference's parameter tree ``tree``
    (nested dicts of arrays, as ``repro.models`` builds them; leaves of
    the stacked layer groups carry the layer on axis 0).  A copy by name:
    the layouts are the same, and a stacked leaf's layer ``i`` goes to
    entry ``i`` of the ``nn.ModuleList`` of that name."""
    model = build(cfg, device=device).init(None)
    load_tree(model, tree)
    return model


def opt_state_from_numpy(model, tree) -> dict:
    """The port's optimizer state from the reference's ``{"m", "v",
    "step"[, "residuals"]}`` tree (numpy arrays or tensors): each tree of
    moments split by parameter name as :func:`params_from_numpy` splits
    the parameters, on the model's device, in the leaves' dtypes."""
    dev = next(model.parameters()).device
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = {n: t.to(dev, copy=True)
                        for n, t in split_tree(model, value).items()}
        else:
            out[key] = _as_tensor(value).to(dev, torch.int32, copy=True)
    return out


def _to_numpy(t) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)      # never a view of live state
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def state_to_numpy(model, state=None) -> dict:
    """The inverse of :func:`opt_state_from_numpy` (and, with ``state``
    None, of :func:`params_from_numpy`): reference-shaped trees of numpy
    arrays, stacked leaves stacked again (bfloat16 as float32, exact)."""
    if state is None:
        return tree_of(model, {n: _to_numpy(p) for n, p in
                               model.named_parameters()}, np.stack)
    return {k: tree_of(model, {n: _to_numpy(t) for n, t in v.items()},
                       np.stack) if isinstance(v, dict) else _to_numpy(v)
            for k, v in state.items()}
