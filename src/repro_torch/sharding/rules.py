"""Parallelism rules: DP(pod,data) × TP/EP(model) × FSDP(data) (the
reference's ``sharding/rules.py``), over a :class:`ProcGrid`.

A spec is a tuple with one entry per dimension: ``None`` (not split), an
axis name, or a tuple of axis names (split over them, major→minor);
``()`` means replicated.  Param specs are derived from leaf *path names*
(the same rule table covers every family since modules share naming
conventions).  Weights: 2-D leaves shard (in_dim → "data" [FSDP],
out_dim → "model" [TP]) or the transpose for output projections, vocab
over "model"; stacked-layer leading dims are unsharded.  ``pod`` is pure
DP.  :func:`param_specs` gives each parameter of a port model the spec
of its *reference* leaf, stacked layer axis included.

The port applies them as the reference's ``jax.device_put(params,
param_shardings(params, mesh))`` does: :func:`place_params` keeps, on
each rank of a grid of processes, only its block of every parameter (the
slices ``spec`` gives its grid coordinates), in place and under the same
names, and records the placement on the model (:class:`Placement`).  The
AdamW moments made from placed parameters are blocks too.  The layers
then gather what they use (``sharding/tp.py``: FSDP over the batch axes
and tensor parallelism over "model" for every family: the attention and
MLP heads and columns, Mamba-2's SSD heads (``models/ssm.py``), the
RG-LRU's block of R (``models/rglru.py``), the encoder's and the
cross-attention's heads (``models/encdec.py``), and the MoE's E/M
experts per model rank by ``_MOE_RULES``: expert parallelism,
``models/moe.py``), and the train step reduces each gradient by its
placement (``train/train_step.py``).  The blocks are the reference's
whatever the heads: a "model" axis that divides H·hd but not the H heads
(Whisper-small's 12 on 16) splits ``wq`` by columns off head
boundaries, and each rank then computes its ``tp.head_range`` of the
heads from the weights taken whole over "model".
:func:`gather_params` is the inverse, for checkpoints and tests.  There is no counterpart of ``logical_axis_env``:
the port names no logical axes for a compiler.  A grid whose batch axes
do not divide the batch replicates the batch (:func:`batch_axis`), and
each rank then runs every row.
"""
from __future__ import annotations

import dataclasses
import re

import torch

from repro_torch.sharding.tp import FSDP_AXES

# leaf-name → spec for the *trailing* dims (leading stack dims padded None).
# "fsdp" resolves to ("pod","data") on multi-pod grids (ZeRO spans pods),
# plain "data" otherwise.
_RULES: list[tuple[str, tuple]] = [
    (r"^(embed)$",                       ("model", "fsdp")),
    (r"^(lm_head)$",                     ("fsdp", "model")),
    # column-parallel (input proj): in_dim FSDP, out_dim TP
    (r"^(wq|wk|wv|w_up|w_gate|w_x|w_gate_in|in_proj|w_r|w_i)$",
     ("fsdp", "model")),
    # row-parallel (output proj): in_dim TP, out_dim FSDP
    (r"^(wo|w_down|out_proj|w_out)$",    ("model", "fsdp")),
    (r"^(router)$",                      ("fsdp", None)),
    (r"^(conv_w)$",                      (None, "model")),
]
# MoE expert-stacked tensors (E, D, F)/(E, F, D): experts over "model" (EP)
_MOE_RULES = {
    "w_up": ("model", "fsdp", None),
    "w_gate": ("model", "fsdp", None),
    "w_down": ("model", None, "fsdp"),
}


def _resolve(entry, grid):
    if entry != "fsdp":
        return entry
    if grid is not None and "pod" in grid.axes:
        return ("pod", "data")
    return "data"


def _axes_size(entry, grid) -> int:
    if entry is None:
        return 1
    axes = entry if isinstance(entry, tuple) else (entry,)
    n = 1
    for a in axes:
        n *= grid.shape[grid.axis_index(a)]
    return n


def _present(entry, grid):
    """``entry`` without the axes ``grid`` lacks (None if none is left)."""
    if entry is None:
        return None
    axes = tuple(a for a in (entry if isinstance(entry, tuple) else (entry,))
                 if a in grid.axes)
    if not axes:
        return None
    return axes if isinstance(entry, tuple) else axes[0]


def drop_indivisible(spec: tuple, shape, grid) -> tuple:
    """Replicate every dim that its axes do not divide evenly (e.g.
    granite's vocab 49155 or 8 KV heads on a 16-way model axis).  An
    axis the grid lacks splits nothing and is dropped (the reference's
    mesh lookup raises there: a data-only grid has no "model" axis)."""
    if grid is None:
        return spec
    ent = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, ent):
        e = _present(e, grid)
        e = e if (e is None or dim % _axes_size(e, grid) == 0) else None
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(e)
    return tuple(out)


def leaf_spec(names, shape, grid=None) -> tuple:
    """The spec of a leaf at path ``names`` (its keys, last one the
    leaf's) with the reference's ``shape``."""
    name = names[-1]
    ndim = len(shape)
    base = None
    if "moe" in names and name in _MOE_RULES:
        base = _MOE_RULES[name]
    else:
        for pat, spec in _RULES:
            if re.match(pat, name):
                base = spec
                break
    if base is None or ndim < len(base):
        return ()                                    # replicate (norms etc.)
    pad = (None,) * (ndim - len(base))
    spec = pad + tuple(_resolve(e, grid) for e in base)
    return drop_indivisible(spec, tuple(shape), grid)


def param_specs(model, grid=None) -> dict:
    """``{parameter name: spec of its reference leaf}`` for the port's
    ``model``: a parameter of a stacked group gets the spec of the
    stacked leaf, leading ``None`` included.  A placed model's parameters
    count with their whole shapes."""
    from repro_torch.models.model_zoo import reference_name, stacked_lists
    lists = stacked_lists(model)
    sizes = {name: len(getattr(model, name)) for name in lists}
    pl = placement_of(model)
    out = {}
    for n, p in model.named_parameters():
        ref, idx = reference_name(n, lists)
        whole = pl.shapes[n] if pl is not None else tuple(p.shape)
        shape = whole if idx is None else \
            (sizes[ref.partition(".")[0]],) + tuple(whole)
        out[n] = leaf_spec(ref.split("."), shape, grid)
    return out


# -------------------------------------------------------------- placement
@dataclasses.dataclass
class Placement:
    """What :func:`place_params` did to a model: the grid, each
    parameter's spec over its own dims (a tuple of the grid axes of more
    than one process that split each dim; the stacked layer axis of the
    reference's leaf left out) and each parameter's whole shape."""

    grid: object
    specs: dict
    shapes: dict

    def __deepcopy__(self, memo):      # a model copy shares its grid
        return self

    def split_axes(self, name: str) -> tuple[int, ...]:
        """The grid axes (indices) that split parameter ``name``."""
        return tuple(sorted({self.grid.axis_index(a)
                             for axes in self.specs[name] for a in axes}))

    def fsdp_split(self, name: str) -> bool:
        """Whether the batch axes split parameter ``name`` (its gradient
        then comes reduce-scattered from the FSDP gather's backward)."""
        return any(a in FSDP_AXES for axes in self.specs[name]
                   for a in axes)


def placement_of(model) -> Placement | None:
    """The model's :class:`Placement`, or None when it holds whole
    weights."""
    return getattr(model, "_placement", None)


def _live_spec(spec, grid, ndim: int) -> tuple:
    """``spec`` over ``ndim`` dims as one tuple of axis names per dim,
    keeping only the axes of more than one process."""
    ent = list(spec) + [None] * (ndim - len(spec))
    out = []
    for e in ent:
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        out.append(tuple(a for a in axes if a in grid.axes
                         and grid.shape[grid.axis_index(a)] > 1))
    return tuple(out)


def place_params(model, grid) -> Placement | None:
    """Keep on this rank only its block of each of ``model``'s parameters
    under :func:`param_specs` on ``grid``, in place: the same parameter
    objects and names, each holding the slices of its spec at the rank's
    grid coordinates.  An entry that :func:`drop_indivisible` replicates
    stays whole; a block need not fall on head boundaries (the layers
    take such weights whole over "model", ``sharding/tp.py``).  Returns
    the :class:`Placement` (also kept on the model), or None when no axis
    of ``grid`` splits any parameter."""
    from repro_torch.ckpt.checkpoint import _block
    from repro_torch.models.model_zoo import reference_name, stacked_lists
    if placement_of(model) is not None:
        raise ValueError("the model is placed already")
    lists = stacked_lists(model)
    ref = param_specs(model, grid)
    specs, shapes = {}, {}
    for n, p in model.named_parameters():
        spec = ref[n]
        if reference_name(n, lists)[1] is not None:
            spec = spec[1:]                   # the stacked layer axis
        specs[n] = _live_spec(spec, grid, p.ndim)
        shapes[n] = tuple(p.shape)
    if not any(a for sp in specs.values() for a in sp):
        return None
    with torch.no_grad():
        for n, p in model.named_parameters():
            sp = specs[n]
            if any(sp):
                p.data = p.data[_block(shapes[n], sp, grid)].clone()
    owners = dict(model.named_modules())
    for n, sp in specs.items():
        if any(sp):
            mod, _, leaf = n.rpartition(".")
            owner = owners[mod]
            owner.__dict__.setdefault("_tp_specs", {})[leaf] = sp
    pl = Placement(grid, specs, shapes)
    model._placement = pl
    return pl


def gather_named(model, named: dict, *, device=None,
                 keep: bool = True) -> dict:
    """``named`` (tensors keyed by ``model``'s parameter names, each this
    rank's block as the parameter of that name is placed: the parameters,
    the AdamW moments) gathered whole, one at a time, each copied to
    ``device`` at once (by default it stays where it is, and a tensor
    that no axis splits comes back as it is, detached).  A collective:
    every rank calls it; with ``keep`` False this rank drops what it
    gathered and gets ``{}``."""
    pl = placement_of(model)
    out = {}
    for n, t in named.items():
        t = t.detach()
        sp = pl.specs[n] if pl is not None else ()
        for dim, axes in enumerate(sp):
            ids = tuple(pl.grid.axis_index(a) for a in axes)
            if ids:
                t = pl.grid.replicate(t, ids, dim, name="rules.gather")
        if keep:
            out[n] = t if device is None else t.to(device, copy=True)
    return out


def gather_params(model, grid=None) -> dict:
    """``{name: whole tensor}`` of a placed ``model`` on every rank (the
    inverse of :func:`place_params`; its own grid when ``grid`` is None).
    A collective: every rank calls it."""
    pl = placement_of(model)
    if grid is not None and pl is not None and grid is not pl.grid:
        raise ValueError("gather_params: the model is placed on another "
                         "grid")
    return gather_named(model, dict(model.named_parameters()))


# ------------------------------------------------------------- activations
def _dp_axes(grid) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in grid.axes)


def batch_axis(grid, batch: int):
    """The batch axes (pod, data) when they divide the batch, else None
    (replicate)."""
    axes = _dp_axes(grid)
    n = 1
    for a in axes:
        n *= grid.shape[grid.axis_index(a)]
    return axes if (batch % n == 0 and batch >= n) else None


def data_specs(cfg, shape, grid) -> dict:
    """Specs of one batch of inputs for (cfg × shape)."""
    b = batch_axis(grid, shape.batch)
    specs = {"tokens": (b, None), "labels": (b, None)}
    if cfg.family == "vlm":
        specs["image_embeds"] = (b, None, None)
    if cfg.family == "encdec":
        specs["frames"] = (b, None, None)
    return specs


def cache_specs(cfg, batch: int, grid, cache) -> dict:
    """KV/state cache specs: batch over DP axes, heads/features over model.

    KV-head counts often don't divide the model axis (GQA kv=8 on 16) —
    fall back to sharding head_dim, then replicate (drop_indivisible)."""
    del cfg
    b = batch_axis(grid, batch)
    model = grid.shape[grid.axis_index("model")]

    def spec(name, leaf):
        nd = len(leaf.shape)
        if name in ("k", "v", "xk", "xv"):      # (L, B, S, Kh, hd)
            s = (None, b, None, "model", None)
            if leaf.shape[3] % model:
                s = (None, b, None, None, "model")
        elif name == "ssm":                     # (L, B, H, N, P)
            s = (None, b, "model", None, None)
        elif name == "conv":                    # (L, B, K-1, C)
            s = (None, b, None, "model")
        elif name == "h":                       # (L, B, R)
            s = (None, b, "model")
        else:
            s = (None,) * nd
        return drop_indivisible(s, tuple(leaf.shape), grid)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else spec(k, v)
                for k, v in tree.items()}
    return walk(cache)
