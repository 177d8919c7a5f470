"""Ambient sharding context (the reference's ``sharding/ctx.py``): lets
model code ask about the placement without threading grid objects
through every layer.

The reference installs a GSPMD mesh here, and ``constrain*`` pin
activation shardings with ``with_sharding_constraint``, from which XLA
derives the collectives.  The port places explicitly: a placed model's
ranks hold blocks of its weights (``sharding/rules.py::place_params``),
and its layers run the gathers and the model-axis reductions themselves
(``sharding/tp.py``), finding the "model" and batch-axis process groups
through the grid recorded here.  So ``use()`` records the
:class:`~repro_torch.core.grid.ProcGrid` and its batch axes, ``grid()``
returns it, the sizes (``axis_size``, ``batch_size``) answer from it, and
every ``constrain*`` returns its input: each rank's activations already
are its block.  Only a training run installs a grid; on the serving path
nothing is installed, as in the reference, so ``axis_size`` answers None
(and ``moe_apply`` routes in one group).  ``batch_axes`` tells
``moe_apply`` which ranks hold disjoint rows of the batch.
"""
from __future__ import annotations

import contextlib

_GRID = None             # ProcGrid | None
_BATCH_AXES = None       # tuple[str, ...] | None
_SEQ_AXIS = None         # str | None — sequence parallelism (Megatron-SP)


@contextlib.contextmanager
def use(grid, batch_axes, seq_axis=None):
    global _GRID, _BATCH_AXES, _SEQ_AXIS
    old = (_GRID, _BATCH_AXES, _SEQ_AXIS)
    _GRID, _BATCH_AXES, _SEQ_AXIS = grid, batch_axes, seq_axis
    try:
        yield
    finally:
        _GRID, _BATCH_AXES, _SEQ_AXIS = old


def active() -> bool:
    return _GRID is not None


def grid():
    """The installed :class:`~repro_torch.core.grid.ProcGrid`, or None."""
    return _GRID


def constrain(x, *entries):
    """The reference's sharding constraint; the port's placement is
    explicit (each rank's tensor is its block), so ``x`` comes back as it
    is."""
    del entries
    return x


def axis_size(name: str):
    """Size of a grid axis, or None when no grid is installed."""
    if _GRID is None or name not in _GRID.axes:
        return None
    return _GRID.shape[_GRID.axis_index(name)]


def batch_axes():
    """The installed batch axes (a tuple of names), or None when no grid
    is installed or the batch is replicated."""
    return _BATCH_AXES if _GRID is not None else None


def batch_size():
    if _GRID is None or not _BATCH_AXES:
        return None
    n = 1
    for a in _BATCH_AXES:
        n *= _GRID.shape[_GRID.axis_index(a)]
    return n


def constrain_batch(x):
    """Dim 0 over the batch axes in the reference; here ``x`` itself."""
    return x


def constrain_act(x):
    """Layer-boundary activations (B, S, D) in the reference; here ``x``
    itself."""
    return x
