"""Split points of a captured step: operations that wait for the host.

A CUDA graph cannot hold an operation that synchronizes with the host —
a solver that reads its status there, or a collective over gloo, which
copies through host memory and waits on the host.  Such an operation
goes through :func:`host_sync`.  Outside a capture that is a plain call.
Inside one (``repro_torch.dft.graphs.StepGraphs.capture``) the graph
captured so far ends, the operation runs eagerly, and the next graph
begins; each replay runs it again at the same place.

The grid's collectives (``ProcGrid.all_reduce``/``replicate``) and the
plans' all-to-alls route themselves through here whenever a collective
runs, so a step captured on several processes splits at each of them,
and a step on one process, where they return early, does not split.
"""
from __future__ import annotations

import threading

_LOCAL = threading.local()


def host_sync(name: str, fn, *args):
    """``fn(*args)``, an operation that synchronizes with the host.

    Outside a capture this is ``fn(*args)``.  Inside one the capture in
    progress splits here (see the module docstring): ``fn`` runs eagerly
    on copies of its tensor arguments, and each replay runs it again at
    the same place; what comes back are copies of its results, made by
    the next graph (``StepGraphs._split``).  ``fn`` returns a tensor or a
    tuple of tensors and may work in place on its arguments; its caller
    uses the results it returns.  A ``host_sync`` reached while ``fn``
    runs is a plain call.
    """
    cap = getattr(_LOCAL, "active", None)
    if cap is None:
        return fn(*args)
    _LOCAL.active = None
    try:
        return cap._split(name, fn, args)
    finally:
        _LOCAL.active = cap


def set_capture(cap) -> None:
    """Make ``cap`` (an object with ``_split(name, fn, args)``) the
    capture in progress on this thread; None ends it."""
    _LOCAL.active = cap
