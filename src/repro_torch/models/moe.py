"""Top-k MoE with capacity-based static dispatch (the reference's
``models/moe.py``).

Dispatch uses scatter/gather index tables instead of the T×E×C one-hot:
per-(token, k) slot positions come from a cumulative count in token-major,
then-k order, tokens beyond an expert's capacity are dropped
(``capacity_factor``, 1.25 as published), and the expert FFNs run as one
batched einsum over the expert dim.  Every dropped entry is written to a
spare slot E·C of an (E·C + 1)-long table, which is then cut off, as the
reference's ``mode="drop"`` writes do.  The combine gathers each token's
K slots and sums them; no step adds by scatter, so the sums run in one
order on every run (CUDA's atomic adds do not).

The groups are the reference's, over the microbatch's global rows
(:func:`moe_apply`): where a group spans the row blocks of several
ranks, the ranks exchange their per-expert counts so that positions,
capacity and drops are the whole group's.  On a grid whose "model" axis
splits the experts (expert parallelism) every model rank routes alike
and runs only its own experts; the partial combines are summed over
"model", as the reference's compiled step does on that layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding import ctx, tp

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
    return _dispatch(xt[None], p.router, p, cfg, C)[0]


def _row_block() -> tuple[int, int, tuple[int, ...]]:
    """(this rank's block of the batch's rows, the number of blocks, the
    grid axes that split them): the installed batch axes, major→minor
    (``train/trainer.py::data_shard``'s order), when several processes
    hold disjoint rows; else (0, 1, ())."""
    g, axes = ctx.grid(), ctx.batch_axes()
    if g is None or not g.multi_process or not axes:
        return 0, 1, ()
    shard, n = 0, 1
    for a in axes:
        i = g.axis_index(a)
        shard = shard * g.shape[i] + g.coordinate[i]
        n *= g.shape[i]
    return shard, n, tuple(g.axis_index(a) for a in axes)


def _peer_offsets(counts, C: int, peers):
    """The global dispatch of a group whose rows ``span`` consecutive row
    blocks hold: each block's per-expert counts gathered over the batch
    axes (rank order is token order), and (the (token, k) pairs of the
    earlier blocks of this group, by expert; this rank's slots per
    expert, the most it keeps of any expert, at least 1)."""
    shard, span, axes = peers
    every = tp.grid().replicate(counts[None], axes, 0,
                                name="moe.expert_counts")   # (blocks, E)
    base = every[shard - shard % span:shard].sum(0)
    kept = torch.minimum((C - base).clamp(min=0), counts)
    return base, max(int(kept.max()), 1)


class _TakeRows(torch.autograd.Function):
    """``xg``'s rows ``src`` (G, N) of each group, the tokens of the expert
    slots.  The backward sums each token's gradient over its K slots by
    a gather through ``slot`` (G, T·K: each (token, k)'s slot, the spare
    row N for a dropped one), not by a scatter-add: it adds in one order
    on every run and rank, where CUDA's atomic adds do not (model ranks
    that hold the experts whole must compute the same gradient)."""

    @staticmethod
    def forward(ctx, xg, src, slot):
        ctx.save_for_backward(slot)
        ctx.T = xg.shape[1]
        return torch.gather(xg, 1, src[..., None].expand(-1, -1,
                                                         xg.shape[-1]))

    @staticmethod
    def backward(ctx, grad):
        slot, = ctx.saved_tensors
        G, _, D = grad.shape
        grad = torch.cat([grad, grad.new_zeros((G, 1, D))], 1)
        picked = torch.gather(grad, 1, slot[..., None].expand(-1, -1, D))
        return picked.reshape(G, ctx.T, -1, D).sum(2), None, None


def _dispatch(xg, router, p, cfg, C, *, ep: bool = False, peers=None):
    """Dispatch/FFN/combine of ``G`` token groups. xg: (G, T, D) → this
    rank's part of (G, T, D).

    With ``peers`` (one group spread over several ranks) the positions
    are offset by the earlier ranks' counts (:func:`_peer_offsets`) and
    the buffers hold this rank's kept slots only.  With ``ep`` the rank
    holds experts [r·E/M, (r+1)·E/M) of the "model" axis (``p``'s
    blocks): every model rank routes alike and runs its own experts'
    slots, and the combine is its partial sum."""
    G, T, D = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    dev = xg.device
    logits = xg.float() @ router                               # (G, T, E)
    top_vals, top_idx = _top_k(logits, K)                      # (G, T, K)
    weights = torch.softmax(top_vals, dim=-1)

    e = top_idx.reshape(G, T * K)
    w = weights.reshape(G, T * K)
    tok = torch.arange(T, device=dev).repeat_interleave(K).expand(G, -1)

    # position of each (token, k) inside its expert's buffer
    oh = F.one_hot(e, E)                                       # (G, T·K, E)
    pos = torch.gather(torch.cumsum(oh, dim=1) - 1, 2, e[..., None])[..., 0]
    if peers is None:
        cap = C
        keep = pos < C
    else:
        base, cap = _peer_offsets(oh.sum(1)[0], C, peers)
        keep = pos + base[e] < C
    El = p.w_up.shape[0]
    e0 = tp.model_rank() * El if ep else 0
    keep = keep & (e >= e0) & (e < e0 + El)
    spare = El * cap
    slot = torch.where(keep, (e - e0) * cap + pos, spare)     # drop → spare

    # gather tokens into (El·cap, D) expert buffers
    def table(dtype, src):
        out = torch.zeros((G, spare + 1), dtype=dtype, device=dev)
        return out.scatter(1, slot, src)[:, :-1]
    tok_of_slot = table(torch.long, tok)
    valid = table(torch.bool, keep)
    xe = _TakeRows.apply(xg, tok_of_slot, slot) * \
        valid[..., None].to(xg.dtype)
    xe = xe.reshape(G, El, cap, D)

    # batched expert FFN
    up = torch.einsum("gecd,edf->gecf", xe, p.w_up)
    if cfg.activation == "swiglu":
        h = F.silu(torch.einsum("gecd,edf->gecf", xe, p.w_gate)) * up
    elif cfg.activation == "geglu":
        h = gelu(torch.einsum("gecd,edf->gecf", xe, p.w_gate)) * up
    else:
        h = torch.square(F.relu(up))
    ye = torch.einsum("gecf,efd->gecd", h, p.w_down).reshape(G, spare, D)

    # combine: each token's K slots gathered and weighted, summed over K
    ye = torch.cat([ye, ye.new_zeros((G, 1, D))], 1)    # the spare: zeros
    picked = torch.gather(ye, 1, slot[..., None].expand(-1, -1, D))
    picked = picked * (w * keep).to(ye.dtype)[..., None]
    return picked.reshape(G, T, K, D).sum(2)


def moe_apply(p, x, cfg, groups: int | None = None):
    """x: (B, S, D) → (B, S, D).

    Tokens route in ``groups`` independent batches of the microbatch's
    *global* rows, each with its own capacity.  Policy as the
    reference's: per-batch-row grouping when the expert count divides
    the grid's "model" axis, one global dispatch otherwise; with no grid
    installed (serving) ``ctx.axis_size`` is None and every token routes
    in one group.  When the batch axes split the rows over processes
    (each rank a contiguous block, in rank order), a group held by
    several ranks dispatches globally: the positions and the capacity
    are the whole group's (:func:`_peer_offsets`).  On a grid whose
    "model" axis splits the experts (``place_params``), each model rank
    runs its own experts' slots and the partial combines are summed over
    "model"; the input and the router enter through ``copy_to_model``,
    so their gradients, partial per model rank, sum over it."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    shard, shards, axes = _row_block()
    rows = B * shards
    if groups is None:
        m = ctx.axis_size("model")
        groups = rows if (m and E % m == 0) else 1
    G = min(groups, rows)
    while rows % G:
        G -= 1
    per = rows // G                                   # rows of a group
    C = _capacity(per * S, K, E, cfg.capacity_factor)
    ep = tp.model_split(p, "w_up", 0)
    h, router = x, p.router
    if ep:
        h, router = tp.copy_to_model(h), tp.copy_to_model(router)
    if B % per == 0:                                  # groups of own rows
        out = _dispatch(h.reshape(B // per, per * S, D), router, p, cfg, C,
                        ep=ep)
    elif per % B == 0:                                # one group, shared
        out = _dispatch(h.reshape(1, B * S, D), router, p, cfg, C, ep=ep,
                        peers=(shard, per // B, axes))
    else:
        raise NotImplementedError(
            f"{G} MoE groups of {per} rows straddle the ranks' blocks of "
            f"{B} rows")
    out = out.reshape(B, S, D)
    if ep:
        out = tp.reduce_from_model(out)
    return out.to(x.dtype)


def aux_load_balance_loss(router_logits, top_idx, E: int):
    """Switch-style auxiliary loss (fraction·probability per expert): the
    reference's, which no model calls in either package."""
    probs = torch.softmax(router_logits, dim=-1)
    frac = torch.mean(F.one_hot(top_idx[..., 0], E).float(), dim=0)
    prob = torch.mean(probs, dim=0)
    return E * torch.sum(frac * prob)
