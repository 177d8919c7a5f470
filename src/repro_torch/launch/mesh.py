"""Production grids (the reference's ``launch/mesh.py``), as
:class:`ProcGrid`s over the processes of a ``torch.distributed`` run.

Single pod: 16×16 = 256 ranks ("data", "model"); multi-pod: 2×16×16 =
512 ranks ("pod", "data", "model") — "pod" is pure data parallelism.
Functions, never module-level constants, so importing this module
touches no process group.  :func:`make_abstract_production_grid` gives the
same shapes and axes as device-less grids, for the dry run's accounting.
"""
from __future__ import annotations

import math

from repro_torch.core.grid import ProcGrid


def _production_layout(multi_pod: bool):
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_grid(*, multi_pod: bool = False, device=None):
    """The production grid over the world's ranks; raises unless
    ``torch.distributed`` runs a world of exactly that many ranks (one per
    card), as the reference raises without its 256 or 512 devices."""
    shape, axes = _production_layout(multi_pod)
    need = math.prod(shape)
    import torch.distributed as dist
    world = dist.get_world_size() if (dist.is_available()
                                      and dist.is_initialized()) else 1
    if world != need:
        raise RuntimeError(
            f"grid {shape} needs {need} ranks, found {world}: start one "
            "process per card with torch.distributed initialized")
    return ProcGrid.create(shape, axes, device=device)


def make_abstract_production_grid(*, multi_pod: bool = False):
    """The production grid's shape and axis names as an abstract
    (device-less) :class:`ProcGrid`: what ``ProcGrid.create_abstract``
    gives, with no process group and no card."""
    return ProcGrid.create_abstract(*_production_layout(multi_pod))


def make_host_grid(shape=(1, 1), axes=("data", "model"), *, device=None):
    """A small grid of ``shape`` (one process per point; one point needs
    no process group) for tests and single-card runs."""
    return ProcGrid.create(shape, axes, device=device)
