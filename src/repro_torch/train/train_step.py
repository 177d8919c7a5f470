"""The train step: loss → grad → (optional compression) → AdamW (the
reference's ``train/train_step.py``).

``make_train_step`` closes over the bundle and returns
``step(params, opt_state, batch) → (params, opt_state, metrics)``; the
reference jits it with params and state donated, the port runs it
eagerly and updates both in place (``donate=False`` works on copies and
leaves the caller's untouched).

Microbatching (gradient accumulation) uses the reference's strided
split: row i of microbatch m is row ``i*mb + m``.  Each microbatch's
gradients come from ``torch.autograd.grad`` in the parameters' dtype and
are summed into float32 buffers (the reference's float32 accumulator;
``.grad`` would add in bfloat16 at the published configs), then divided
by ``mb``, as is the loss.

On a grid whose batch axes span several processes each rank runs its
rows of the batch, and the gradients and the loss are averaged over
those axes before compression, so every rank compresses and applies the
global gradient, as the reference's GSPMD step does.  With whole weights
(data parallel: each rank holds the weights and the optimizer state) that
is one all-reduce of one flat buffer.  On placed weights
(``sharding/rules.py::place_params``: each rank holds its blocks of the
weights and of the optimizer state) a leaf that the batch axes split
gets its gradient block from the FSDP gather's backward reduce-scatter
(a sum over the batch axes; ``sharding/tp.py``), divided here by their
size; only the leaves they do not split, and the loss, take the flat
all-reduce (the dry run's ``grad_all_reduce`` set).  Nothing here sums
over "model": a leaf split over it (a tensor-parallel block, a model
rank's experts) has its own gradient on each model rank, and a whole
leaf that each model rank uses on its own part (a qk-norm scale, the
MoE router and input, Mamba-2's and the RG-LRU's float32 vectors) had
its gradient summed over "model" by ``tp.copy_to_model``'s backward.
The loss runs with
the model's top-level weights (embedding, head, final norm) gathered
over the batch axes once per microbatch; each layer gathers its own.
"""
from __future__ import annotations

import contextlib
import copy
import math

import torch

from repro_torch.optim import adamw
from repro_torch.optim.compression import compress_grads, decompress_grads
from repro_torch.sharding import rules, tp


def _dp_axes(grid) -> list[int]:
    """The grid's batch axes (pod, data) that span several processes."""
    if grid is None or not grid.multi_process:
        return []
    return [grid.axis_index(a) for a in ("pod", "data")
            if a in grid.axes and grid.shape[grid.axis_index(a)] > 1]


def _mean_over(grid, axes, grads: dict, loss):
    """The gradients (float32) and the loss averaged over grid ``axes``,
    in one all-reduce of one flat buffer."""
    n = 1
    for a in axes:
        n *= grid.shape[a]
    names = list(grads)
    flat = torch.cat([grads[k].float().reshape(-1) for k in names]
                     + [loss.float().reshape(1)])
    flat = grid.all_reduce(flat, axes, name="train.grad_all_reduce") / n
    out, at = {}, 0
    for k in names:
        size = grads[k].numel()
        out[k] = flat[at:at + size].view(grads[k].shape)
        at += size
    return out, flat[at]


def _reduce_placed(grid, axes, placement, grads: dict, loss):
    """Placed weights: the FSDP-split leaves' reduce-scattered sums
    divided by the batch axes' size; the other leaves and the loss
    averaged by :func:`_mean_over`."""
    n = math.prod(grid.shape[a] for a in axes)
    split = {k for k in grads if placement.fsdp_split(k)}
    rest, loss = _mean_over(grid, axes, {k: v for k, v in grads.items()
                                         if k not in split}, loss)
    out = {k: grads[k].float() / n if k in split else rest[k]
           for k in grads}
    return out, loss


def _top_level_gathered(params):
    """The placed model's weights outside its stacked layers gathered over
    the batch axes for the loss (``tp.gathered``); nothing to do on whole
    weights."""
    if rules.placement_of(params) is None:
        return contextlib.nullcontext()
    from repro_torch.models.model_zoo import stacked_lists
    return tp.gathered(params, skip=stacked_lists(params))


def _check_placement(placement, grid) -> None:
    if placement is not None and placement.grid is not grid:
        raise ValueError("the parameters are placed on another grid than "
                         "the train step's")


def _device_batch(batch: dict) -> dict:
    """Token ids as int64 (``torch.gather`` and embedding lookups)."""
    return {k: v.long() if not v.is_floating_point() else v
            for k, v in batch.items()}


def make_train_step(bundle, opt_cfg: adamw.AdamWConfig, grid=None, *,
                    microbatches: int = 1, compress: bool = False,
                    donate: bool = True):
    """Returns train_step(params, opt_state, batch) → (params, state,
    metrics), ``metrics = {"loss", "grad_norm", "lr"}`` (tensors).

    With compress=True, gradients pass through int8 error-feedback
    quantization; the residual state lives in opt_state["residuals"].
    ``grid``: the processes of the run, whose parameters are whole or
    placed on it (see the module docstring); ``batch`` holds this rank's
    rows."""
    dp = _dp_axes(grid)

    def value_and_grad(params, names, plist, batch):
        with _top_level_gathered(params):
            loss = bundle.loss(params, batch)
        gs = torch.autograd.grad(loss, plist)
        return loss.detach(), dict(zip(names, gs))

    def step(params, opt_state, batch):
        if not donate:
            params = copy.deepcopy(params)
            opt_state = {k: ({n: t.clone() for n, t in v.items()}
                             if isinstance(v, dict) else v.clone())
                         for k, v in opt_state.items()}
        batch = _device_batch(batch)
        placement = rules.placement_of(params)
        _check_placement(placement, grid)
        named = dict(params.named_parameters())
        names, plist = list(named), list(named.values())
        if microbatches > 1:
            g = {n: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for n, p in named.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=plist[0].device)
            for m in range(microbatches):
                mb = {k: v[m::microbatches] for k, v in batch.items()}
                lm, gm = value_and_grad(params, names, plist, mb)
                for n in names:
                    g[n].add_(gm[n])
                del gm
                loss = loss + lm.float()
            for n in names:
                g[n].div_(microbatches)
            loss = loss / microbatches
        else:
            loss, g = value_and_grad(params, names, plist, batch)
        if dp and placement is not None:
            g, loss = _reduce_placed(grid, dp, placement, g, loss)
        elif dp:
            g, loss = _mean_over(grid, dp, g, loss)

        if compress:
            comp, res = compress_grads(g, opt_state["residuals"],
                                       placement)
            g = decompress_grads(comp)
            opt_state = {**opt_state, "residuals": res}

        inner = {k: v for k, v in opt_state.items() if k != "residuals"}
        params, inner, metrics = adamw.apply_updates(params, g, inner,
                                                     opt_cfg)
        if compress:
            inner["residuals"] = opt_state["residuals"]
        metrics["loss"] = loss
        return params, inner, metrics

    return step


def init_opt_state(params, *, compress: bool = False, dtype=None) -> dict:
    st = adamw.init_state(params, dtype or torch.float32)
    if compress:
        from repro_torch.optim.compression import init_residuals
        st["residuals"] = init_residuals(params)
    return st
