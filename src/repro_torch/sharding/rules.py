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

The specs describe placements; the port applies none of them to
weights.  Its training path is data parallel: weights and optimizer
state are replicated on every rank, each rank runs its rows of the
batch, and the train step all-reduces the gradients over the batch
axes (:func:`batch_axis`).  So the reference's ``param_shardings`` and
``logical_axis_env``, which hand specs to XLA, have no counterpart; the
specs go into the checkpoint manifest, from which a spec'd restore reads
each rank's block.
"""
from __future__ import annotations

import re

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
    stacked leaf, leading ``None`` included."""
    from repro_torch.models.model_zoo import reference_name, stacked_lists
    lists = stacked_lists(model)
    sizes = {name: len(getattr(model, name)) for name in lists}
    out = {}
    for n, p in model.named_parameters():
        ref, idx = reference_name(n, lists)
        shape = tuple(p.shape) if idx is None else \
            (sizes[ref.partition(".")[0]],) + tuple(p.shape)
        out[n] = leaf_spec(ref.split("."), shape, grid)
    return out


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
