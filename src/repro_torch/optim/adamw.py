"""AdamW with cosine schedule and global-norm clipping (the reference's
``optim/adamw.py``), as plain functions over a model's named parameters.

``params`` is an ``nn.Module`` or a dict of tensors keyed by name; the
state is ``{"m": {name: tensor}, "v": {name: tensor}, "step": int32
tensor}``, on the parameters' device.  The update runs in float32 and is
written back in place, cast to each tensor's dtype (the port's
counterpart of the reference's donated buffers).

Decoupled weight decay applies to a tensor whose rank *in the reference's
parameter tree* is at least 2.  The reference stacks every layer group on
a leading axis, so its per-layer norm scales and vectors (``layers.ln1``
of shape (L, D), the SSM's ``A_log``/``D_skip``/``dt_bias`` of shape
(L, H)) are decayed, and only the unstacked ones (``ln_f``) are not.  The
port holds a stacked group as an ``nn.ModuleList``, where the same
tensors have one dimension less, so the rule counts that dimension back
(:func:`~repro_torch.models.model_zoo.reference_ndims`).

On placed parameters (``sharding/rules.py::place_params``) every tensor
here is this rank's block: the update is elementwise, so each rank
updates its blocks, and only the global norm needs the grid
(:func:`global_norm`).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def named_tensors(params) -> tuple[dict, dict]:
    """``({name: tensor}, {name: rank in the reference's tree})`` of an
    ``nn.Module`` (stacked groups count their layer axis) or of a dict of
    tensors (each its own rank)."""
    if isinstance(params, nn.Module):
        from repro_torch.models.model_zoo import reference_ndims
        return dict(params.named_parameters()), reference_ndims(params)
    return dict(params), {n: t.ndim for n, t in params.items()}


def init_state(params, dtype=torch.float32) -> dict:
    """dtype=bfloat16 gives memory-reduced states, as in the reference."""
    named, _ = named_tensors(params)
    dev = next(iter(named.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=dtype, device=p.device)
                for n, p in named.items()}
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def schedule(cfg: AdamWConfig, step):
    """Learning rate at ``step`` (a tensor): linear warmup, then cosine
    down to ``min_lr_frac``; float32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree, placement=None):
    """√(Σ x²) over every tensor of the dict ``tree``, in float32.

    With a :class:`~repro_torch.sharding.rules.Placement`, ``tree`` holds
    this rank's blocks: each leaf's sum of squares is summed over exactly
    the grid axes that split it (one all-reduce per set of axes), so a
    leaf that several ranks hold whole counts once (a model rank's block
    of experts, split over "model" and "data", once over both)."""
    leaves = list(tree.values())
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    if placement is None:
        for x in leaves:
            total = total + torch.sum(torch.square(x.float()))
        return torch.sqrt(total)
    groups: dict[tuple, torch.Tensor] = {}
    for name, x in tree.items():
        axes = placement.split_axes(name)
        groups[axes] = groups.get(axes, total) + \
            torch.sum(torch.square(x.float()))
    for axes in sorted(groups):
        total = total + placement.grid.all_reduce(
            groups[axes].reshape(1), axes, name="adamw.global_norm")[0]
    return torch.sqrt(total)


#: elements of a leaf updated at once: the update's float32 temporaries
#: are a few copies of such a slice, not of the whole leaf (a 49155-row
#: embedding's would be 302 MB each)
UPDATE_CHUNK = 1 << 24


def _chunks(*tensors):
    """Matching flat slices of ``tensors`` (a parameter, its gradient, its
    moments) of UPDATE_CHUNK elements, views that the update writes
    through; the tensors whole when one is not contiguous."""
    if not all(t.is_contiguous() for t in tensors):
        yield tensors
        return
    flat = [t.view(-1) for t in tensors]
    for i in range(0, flat[0].numel(), UPDATE_CHUNK):
        yield tuple(t[i:i + UPDATE_CHUNK] for t in flat)


def _moment(x, beta, term):
    """beta·x + term in float32: in place when the moment ``x`` is float32
    (the same products and sum, so the same bits, without a copy of
    ``x`` beside it)."""
    if x.dtype == torch.float32:
        return x.mul_(beta).add_(term)
    return (beta * x.float()).add_(term)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig):
    """One AdamW step, in place: ``params`` and the state's moments are
    overwritten.  Returns (params, state, metrics) as the reference's
    does, ``metrics = {"grad_norm", "lr"}`` (tensors)."""
    named, ndims = named_tensors(params)
    step = state["step"] + 1
    gnorm = global_norm(grads, getattr(params, "_placement", None))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    t = step.float()
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)
    for name, leaf in named.items():
        for p, g, m, v in _chunks(leaf, grads[name], state["m"][name],
                                  state["v"][name]):
            g = g.float() * scale
            m_new = _moment(m, b1, (1 - b1) * g)
            v_new = _moment(v, b2, torch.square(g).mul_(1 - b2))
            del g
            delta = (m_new / c1).div_(torch.sqrt(v_new / c2).add_(cfg.eps))
            if ndims[name] >= 2:              # decoupled decay on matrices
                delta.add_(cfg.weight_decay * p.float())
            p.copy_(p.float().sub_(delta.mul_(lr)))
            m.copy_(m_new)
            v.copy_(v_new)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
