"""Production grids (the reference's ``launch/mesh.py``), as
:class:`ProcGrid`s over the processes of a ``torch.distributed`` run.

Single pod: 16×16 = 256 ranks ("data", "model"); multi-pod: 2×16×16 =
512 ranks ("pod", "data", "model") — "pod" is pure data parallelism.
Functions, never module-level constants, so importing this module
touches no process group.
"""
from __future__ import annotations

import math

from repro_torch.core.grid import ProcGrid


def make_production_grid(*, multi_pod: bool = False, device=None):
    """The production grid over the world's ranks; raises unless
    ``torch.distributed`` runs a world of exactly that many ranks (one per
    card), as the reference raises without its 256 or 512 devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    import torch.distributed as dist
    world = dist.get_world_size() if (dist.is_available()
                                      and dist.is_initialized()) else 1
    if world != need:
        raise RuntimeError(
            f"grid {shape} needs {need} ranks, found {world}: start one "
            "process per card with torch.distributed initialized")
    return ProcGrid.create(shape, axes, device=device)


def make_host_grid(shape=(1, 1), axes=("data", "model"), *, device=None):
    """A small grid of ``shape`` (one process per point; one point needs
    no process group) for tests and single-card runs."""
    return ProcGrid.create(shape, axes, device=device)
