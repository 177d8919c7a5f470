"""Top-k MoE with capacity-based static dispatch (the reference's
``models/moe.py``).

Dispatch uses scatter/gather index tables instead of the T×E×C one-hot:
per-(token, k) slot positions come from a cumulative count in token-major,
then-k order, tokens beyond an expert's capacity are dropped
(``capacity_factor``, 1.25 as published), and the expert FFNs run as one
batched einsum over the expert dim.  Every dropped entry is written to a
spare slot E·C of an (E·C + 1)-long table, which is then cut off, as the
reference's ``mode="drop"`` writes do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding import ctx

from .layers import gelu, weight


class MoE(nn.Module):
    """``router`` (D, E) float32; ``w_up``/``w_gate`` (E, D, F) and
    ``w_down`` (E, F, D) in the model dtype.  Applied by
    :func:`moe_apply` with the config."""

    def __init__(self, cfg, dtype, *, gen=None, device=None):
        super().__init__()
        D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = weight(gen, (D, E), device=device)
        self.w_up = weight(gen, (E, D, Fd), dtype=dtype, device=device)
        self.w_down = weight(gen, (E, Fd, D), dtype=dtype, device=device)
        if cfg.activation in ("swiglu", "geglu"):
            self.w_gate = weight(gen, (E, D, Fd), dtype=dtype, device=device)


def _capacity(T: int, k: int, E: int, factor: float) -> int:
    c = int(T * k * factor / E) + 1
    return max(8, -(-c // 8) * 8)             # round up to 8


def _top_k(logits, K: int):
    """``lax.top_k``: the K largest, ties toward the lower index (a stable
    descending sort keeps equal values in index order)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :K], idx[..., :K]


def _dispatch_group(xt, p, cfg, C):
    """Dispatch/FFN/combine for one token group. xt: (T, D) → (T, D)."""
    T, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    dev = xt.device
    logits = xt.float() @ p.router                             # (T, E)
    top_vals, top_idx = _top_k(logits, K)                      # (T, K)
    weights = torch.softmax(top_vals, dim=-1)                  # (T, K)

    e_flat = top_idx.reshape(-1)                               # (T·K,)
    w_flat = weights.reshape(-1)
    tok_flat = torch.arange(T, device=dev).repeat_interleave(K)

    # position of each (token, k) inside its expert's buffer
    oh = F.one_hot(e_flat, E)                                  # (T·K, E)
    pos = torch.cumsum(oh, dim=0) - 1
    pos = torch.gather(pos, 1, e_flat[:, None])[:, 0]
    keep = pos < C
    slot = torch.where(keep, e_flat * C + pos, E * C)          # drop → spare

    # gather tokens into (E·C, D) expert buffers
    tok_of_slot = torch.zeros((E * C + 1,), dtype=torch.long, device=dev)
    tok_of_slot[slot] = tok_flat
    valid = torch.zeros((E * C + 1,), dtype=torch.bool, device=dev)
    valid[slot] = keep
    tok_of_slot = tok_of_slot[:-1]
    valid = valid[:-1]
    xe = (xt[tok_of_slot] * valid[:, None].to(xt.dtype)).reshape(E, C, D)

    # batched expert FFN
    up = torch.einsum("ecd,edf->ecf", xe, p.w_up)
    if cfg.activation == "swiglu":
        h = F.silu(torch.einsum("ecd,edf->ecf", xe, p.w_gate)) * up
    elif cfg.activation == "geglu":
        h = gelu(torch.einsum("ecd,edf->ecf", xe, p.w_gate)) * up
    else:
        h = torch.square(F.relu(up))
    ye = torch.einsum("ecf,efd->ecd", h, p.w_down).reshape(E * C, D)

    # combine: weighted scatter-add back to tokens
    w_of_slot = torch.zeros((E * C + 1,), dtype=w_flat.dtype, device=dev)
    w_of_slot[slot] = w_flat
    w_of_slot = w_of_slot[:-1]
    contrib = ye * (w_of_slot * valid).to(ye.dtype)[:, None]
    return torch.zeros((T, D), dtype=ye.dtype, device=dev).index_add_(
        0, tok_of_slot, contrib)


def moe_apply(p, x, cfg, groups: int | None = None):
    """x: (B, S, D) → (B, S, D).

    Tokens route in ``groups`` independent batches, each with its own
    capacity.  Policy as the reference's: per-batch-row grouping when the
    expert count divides the grid's "model" axis, one global dispatch
    otherwise; with no grid installed (serving) ``ctx.axis_size`` is None
    and every token routes in one group."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    if groups is None:
        tp = ctx.axis_size("model")
        groups = B if (tp and E % tp == 0) else 1
    G = min(groups, B)
    while B % G:
        G -= 1
    Tg = B * S // G
    C = _capacity(Tg, K, E, cfg.capacity_factor)
    xg = x.reshape(G, Tg, D)
    out = torch.stack([_dispatch_group(xg[g], p, cfg, C) for g in range(G)])
    return out.reshape(B, S, D).to(x.dtype)


def aux_load_balance_loss(router_logits, top_idx, E: int):
    """Switch-style auxiliary loss (fraction·probability per expert): the
    reference's, which no model calls in either package."""
    probs = torch.softmax(router_logits, dim=-1)
    frac = torch.mean(F.one_hot(top_idx[..., 0], E).float(), dim=0)
    prob = torch.mean(probs, dim=0)
    return E * torch.sum(frac * prob)
