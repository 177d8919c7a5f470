"""Processing grids — FFTB's `grid` object over torch devices.

The paper creates 1D/2D/3D processing grids over an MPI communicator::

    std::vector<int> procs{16};
    grid g = grid(procs, MPI_COMM_WORLD);

Here a ProcGrid is either *concrete* — every axis of size 1, all of it on
one torch device — or *abstract*: any shape, no device, for plan
construction and inspection (costing a schedule for a 1024-GPU run from a
laptop, as the paper's planner does).  Grids whose axes span several
processes belong to the distributed slice of the port (ROADMAP §1 item 2)
and are refused by :meth:`ProcGrid.create`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else CUDA.

    Never falls back to the CPU silently: with no ``device`` and no CUDA
    device present this raises, so a caller that wants the CPU says so.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        # one spelling per card, so per-device caches never split in two
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class ProcGrid:
    """A 1D/2D/3D processing grid: axis names, sizes and (maybe) a device."""

    axes: tuple[str, ...]           # axis names, grid dim 0..k-1
    shape: tuple[int, ...]
    device: torch.device | None     # None: abstract (device-less) grid

    # ---------------------------------------------------------------- build
    @staticmethod
    def create(procs: Sequence[int] = (1,),
               axis_names: Sequence[str] | None = None, *,
               device=None) -> "ProcGrid":
        """Single-device grid (every axis of size 1) on ``device``.

        ``device`` defaults to CUDA and raises when CUDA is missing (see
        :func:`resolve_device`).
        """
        procs = tuple(int(p) for p in procs)
        if math.prod(procs) != 1:
            raise NotImplementedError(
                f"grid {procs} spans {math.prod(procs)} processes; "
                "multi-rank grids are the distributed slice of the port "
                "(ROADMAP §1 item 2) — use ProcGrid.create_abstract to "
                "inspect such a plan")
        names = tuple(axis_names) if axis_names else tuple(
            f"g{i}" for i in range(len(procs)))
        return ProcGrid(names, procs, resolve_device(device))

    @staticmethod
    def create_abstract(procs: Sequence[int],
                        axis_names: Sequence[str] | None = None
                        ) -> "ProcGrid":
        """Device-less grid for plan construction/inspection — execution
        requires a concrete grid."""
        names = tuple(axis_names) if axis_names else tuple(
            f"g{i}" for i in range(len(procs)))
        return ProcGrid(names, tuple(int(p) for p in procs), None)

    # ---------------------------------------------------------------- query
    @property
    def ndim(self) -> int:
        return len(self.axes)

    @property
    def nprocs(self) -> int:
        return math.prod(self.shape)

    @property
    def is_abstract(self) -> bool:
        return self.device is None

    def axis_name(self, i: int) -> str:
        return self.axes[i]

    def axis_size(self, i: int) -> int:
        return self.shape[i]

    # ------------------------------------------------------------ placement
    def replicate(self, x):
        """Replicated placement of ``x`` on this grid: on one device every
        tensor already is, so this returns ``x`` unchanged."""
        return x

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        dims = "x".join(str(s) for s in self.shape)
        return f"ProcGrid({dims}, axes={self.axes})"
