"""Explicit weight placement on a grid of processes: the autograd
functions of FSDP and tensor parallelism, and the gathers a placed
model's layers run.

A model placed by :func:`repro_torch.sharding.rules.place_params` holds,
on each rank, only its block of every parameter (the reference's
``device_put(params, param_shardings(params, mesh))``).  Each module that
owns placed parameters records their specs in ``_tp_specs`` (a tuple of
axis names per dim, only the axes of more than one process).  The grid is
the one installed by :func:`repro_torch.sharding.ctx.use`.

Three functions carry the placement through autograd, each a no-op when
its axes hold one process:

* :func:`gather`: all-gather along dims over grid axes in forward,
  reduce-scatter (sum) in backward: an FSDP weight gathered over the batch
  axes ("pod", "data"), whose gradient each rank computed from its own
  rows, or a weight gathered over "model" whose every rank uses a part;
* :func:`copy_to_model`: identity in forward, all-reduce over "model" in
  backward (Megatron's f): the input of a column-parallel product, whose
  gradient each model rank computes from its own columns, and a weight
  that whole is used by every model rank on its own part;
* :func:`reduce_from_model`: all-reduce over "model" in forward,
  identity in backward (Megatron's g): the partial sums of a row-parallel
  product;
* :func:`sum_over_model`: all-reduce over "model" in forward and in
  backward: a statistic of a whole feature dim built from each rank's
  part (the sum of squares of Mamba-2's gated RMSNorm), which every
  model rank then uses on its own part.

:func:`whole_over_model` gives a weight whole on every model rank (a
gather, or the replicated weight through :func:`copy_to_model`), for a
layer whose stored blocks are not the columns each rank computes with:
Mamba-2's ``in_proj``, and every attention weight when the "model" axis
does not split the heads evenly (:func:`head_range` gives each rank its
heads, whatever the stored blocks).

:func:`gathered` wraps a layer body: every parameter of the layer's
module split over the batch axes is gathered over them before the body
runs (inside the remat region, so the recompute gathers again and the
whole weights are never saved), and the body reads it by its usual name.
That is FSDP for every family.  The "model" split stays: the layers
written for it read a model-split weight (the attention and MLP of every
family, the vocab-parallel embedding, logits and loss, the MoE's
experts, Mamba-2's SSD block and the RG-LRU block).
"""
from __future__ import annotations

import contextlib
import functools

import torch

from . import ctx

#: the batch axes, over which a weight's FSDP split gathers
FSDP_AXES = ("pod", "data")


# --------------------------------------------------------------- queries
def specs(module) -> dict | None:
    """``{parameter name: spec}`` of ``module``'s own placed parameters
    (None when it holds none)."""
    return module.__dict__.get("_tp_specs")


def placed(module) -> bool:
    return bool(specs(module))


def grid():
    """The installed grid; raises when a placed model runs without one."""
    g = ctx.grid()
    if g is None:
        raise RuntimeError("a placed model runs under sharding.ctx.use("
                           "grid, ...) of the grid it was placed on")
    return g


def model_size() -> int:
    return ctx.axis_size("model") or 1


def model_rank() -> int:
    g = ctx.grid()
    if g is None or "model" not in g.axes:
        return 0
    return g.coordinate[g.axis_index("model")]


def head_range(n: int) -> tuple[int, int]:
    """``[h0, h1)``: the heads of ``n`` this model rank computes.  Rank r
    of M takes ``[r·n // M, (r+1)·n // M)``: n/M heads each when M
    divides n, else one more or less, and none on some ranks when n < M
    (such a rank still joins every collective of the layer, with
    zeros).  Attention and Mamba-2's SSD take their heads by it."""
    M, r = model_size(), model_rank()
    return r * n // M, (r + 1) * n // M


def model_split(module, name: str, dim: int) -> bool:
    """Whether the "model" axis splits dim ``dim`` of ``module.name``."""
    sp = (specs(module) or {}).get(name)
    return bool(sp) and "model" in sp[dim]


def _axis_ids(g, names) -> tuple[int, ...]:
    return tuple(g.axis_index(a) for a in names if a in g.axes
                 and g.shape[g.axis_index(a)] > 1)


# ------------------------------------------------------------- functions
class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(c, x, g, dims):
        c.g, c.dims = g, dims
        for dim, axes in dims:
            x = g.replicate(x, axes, dim, name="tp.all_gather")
        return x

    @staticmethod
    def backward(c, dy):
        for dim, axes in reversed(c.dims):
            dy = c.g.reduce_scatter(dy, axes, dim, name="tp.reduce_scatter")
        return dy, None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(c, x, g, axes):
        c.g, c.axes = g, axes
        return x.view_as(x)

    @staticmethod
    def backward(c, dy):
        dy = dy.clone(memory_format=torch.contiguous_format)
        return c.g.all_reduce(dy, c.axes, name="tp.copy_to_model"), \
            None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(c, x, g, axes):
        out = x.clone(memory_format=torch.contiguous_format)
        return g.all_reduce(out, axes, name="tp.reduce_from_model")

    @staticmethod
    def backward(c, dy):
        return dy, None, None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(c, x, g, axes):
        c.g, c.axes = g, axes
        out = x.clone(memory_format=torch.contiguous_format)
        return g.all_reduce(out, axes, name="tp.sum_over_model")

    @staticmethod
    def backward(c, dy):
        dy = dy.clone(memory_format=torch.contiguous_format)
        return c.g.all_reduce(dy, c.axes, name="tp.sum_over_model_grad"), \
            None, None


def gather(x, dims: dict[int, tuple[str, ...]]):
    """``x`` (a block) gathered along each dim over its grid axes (names),
    blocked as ``rules.param_specs`` splits it; reduce-scatter (sum) of
    the gradient in backward.  ``x`` itself when no axis has several
    processes."""
    g = grid()
    live = tuple((d, ids) for d, names in sorted(dims.items())
                 if (ids := _axis_ids(g, names)))
    if not live:
        return x
    return _Gather.apply(x, g, live)


def copy_to_model(x):
    """Identity; all-reduce of the gradient over "model"."""
    g = ctx.grid()
    ids = _axis_ids(g, ("model",)) if g is not None else ()
    return _CopyToModel.apply(x, g, ids) if ids else x


def reduce_from_model(x):
    """All-reduce (sum) over "model"; identity on the gradient."""
    g = ctx.grid()
    ids = _axis_ids(g, ("model",)) if g is not None else ()
    return _ReduceFromModel.apply(x, g, ids) if ids else x


def sum_over_model(x):
    """All-reduce (sum) over "model", and all-reduce of the gradient: each
    model rank's gradient of the sum differs (it uses the sum on its own
    part), and each part's gradient is their sum."""
    g = ctx.grid()
    ids = _axis_ids(g, ("model",)) if g is not None else ()
    return _SumOverModel.apply(x, g, ids) if ids else x


def whole_over_model(module, name: str, dim: int):
    """``module.name`` whole along ``dim`` on every model rank: gathered
    over "model" when it splits that dim (the gradient reduce-scattered),
    else the replicated weight through :func:`copy_to_model` (each rank
    uses part of it, so the gradient sums over the model axis)."""
    w = getattr(module, name)
    if model_split(module, name, dim):
        return gather(w, {dim: ("model",)})
    return copy_to_model(w)


def max_over_model(x):
    """The elementwise max of ``x`` over "model", outside autograd (a
    softmax's shift: no gradient flows through it)."""
    g = ctx.grid()
    ids = _axis_ids(g, ("model",)) if g is not None else ()
    if not ids:
        return x
    return g.all_reduce(x.detach().clone(), ids, "max",
                        name="tp.max_over_model")


# ------------------------------------------------------------ FSDP swap
def _fsdp_dims(spec) -> dict[int, tuple[str, ...]]:
    return {d: tuple(a for a in axes if a in FSDP_AXES)
            for d, axes in enumerate(spec)
            if any(a in FSDP_AXES for a in axes)}


@contextlib.contextmanager
def gathered(module, *, skip=()):
    """Within the block, every FSDP-split parameter of ``module`` and of
    its submodules (none under a child named in ``skip``) reads as its
    gathered tensor under its own name: what
    ``torch.func.functional_call`` does for a module's ``forward``, here
    for the functions that apply a module.  The parameters come back
    when the block ends."""
    swapped = []
    try:
        for path, mod in module.named_modules():
            if path.split(".")[0] in skip:
                continue
            for name, sp in (specs(mod) or {}).items():
                dims = _fsdp_dims(sp)
                if dims:
                    w = mod._parameters[name]
                    mod._parameters[name] = gather(w, dims)
                    swapped.append((mod, name, w))
        yield module
    finally:
        for mod, name, w in reversed(swapped):
            mod._parameters[name] = w


def with_gathered(fn):
    """``fn(...)`` run inside :func:`gathered` of each module among its
    positional arguments that holds placed parameters (a layer body takes
    its layer's modules); ``fn`` as it is when none does."""
    @functools.wraps(fn)
    def run(*args, **kw):
        mods = [a for a in args if isinstance(a, torch.nn.Module)
                and _any_placed(a)]
        if not mods:
            return fn(*args, **kw)
        with contextlib.ExitStack() as stack:
            for m in mods:
                stack.enter_context(gathered(m))
            return fn(*args, **kw)
    return run


def _any_placed(module) -> bool:
    return any(placed(m) for m in module.modules())
