"""Processing grids — FFTB's `grid` object over torch devices and processes.

The paper creates 1D/2D/3D processing grids over an MPI communicator::

    std::vector<int> procs{16};
    grid g = grid(procs, MPI_COMM_WORLD);

Here a ProcGrid is one of three kinds:

* *one process*: every axis of size 1, all of it on one torch device;
* *multi-process*: the grid's points are the ranks of a
  ``torch.distributed`` process group, row-major (the last axis
  fastest), one process per point; each axis has its own process group
  (the ranks that differ only in that axis' coordinate), over which the
  plans' all-to-alls and the reductions of the DFT layer run.  Each rank
  names its own device, and ranks may share one card;
* *abstract*: any shape, no device, for plan construction and inspection
  (costing a schedule for a 1024-GPU run from a laptop, as the paper's
  planner does).

The caller's process group decides the communication backend (NCCL,
gloo, ...); the grid only builds sub-groups of it.

Every collective the grid runs adds its per-device *operand* bytes to
:data:`COLLECTIVE_BYTES`, under the dry run's names and operand convention
(``launch/dryrun.py``): an all-gather's operand is this rank's block (the
result over the participants), a reduce-scatter's the whole input (the
result times the participants), an all-reduce's its buffer, an
all-to-all's its send buffer.  A collective over several axes counts once,
as the one operation of the reference's HLO would.  Read and reset it
with :func:`collective_bytes`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from .hostsync import host_sync

#: per-device operand bytes of the collectives this process ran, by kind
#: (the module docstring's convention)
COLLECTIVE_BYTES = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0,
                    "all-to-all": 0}


def collective_bytes(reset: bool = False) -> dict:
    """A copy of :data:`COLLECTIVE_BYTES`; with ``reset`` every count is
    set to 0 after it is read."""
    out = dict(COLLECTIVE_BYTES)
    if reset:
        for k in COLLECTIVE_BYTES:
            COLLECTIVE_BYTES[k] = 0
    return out


def count_collective(kind: str, x: torch.Tensor) -> None:
    """Add ``x``'s bytes to the ``kind`` count (``x`` the operand)."""
    COLLECTIVE_BYTES[kind] += x.numel() * x.element_size()


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


#: per-axis process groups already built for one world group, by grid
#: shape and axis: ``dist.new_group`` is a collective of the whole world,
#: so every rank must build the same groups in the same order — building
#: each once keeps repeated ``ProcGrid.create`` calls from issuing new
#: ones.  ``[world, groups]``: the world object itself is held, and a new
#: world (after ``destroy_process_group`` and a new init) empties the cache
_GROUPS: list = [None, {}]


def _world_groups(dist) -> dict:
    """The group cache of the current world group (emptied when the world
    group is not the one it was built for)."""
    if _GROUPS[0] is not dist.group.WORLD:
        _GROUPS[:] = [dist.group.WORLD, {}]
    return _GROUPS[1]


def _axis_lines(ranks: tuple[int, ...], shape: tuple[int, ...],
                axis: int) -> list[list[int]]:
    """Every line of the rank array along ``axis`` (all of them, in a
    fixed order, as ``new_group`` needs every rank to create each)."""
    arr = torch.tensor(ranks).reshape(shape).movedim(axis, -1)
    return arr.reshape(-1, shape[axis]).tolist()


def _check_ascending(line: list[int], axis: str) -> None:
    # a process group orders its members by global rank; the moves send
    # block j to the group's j-th member, which must be coordinate j
    if line != sorted(line):
        raise ValueError(
            f"grid axis {axis!r} runs over ranks {line}, which are not "
            "ascending: a process group orders its members by rank, so "
            "each axis must list its ranks in ascending order")


@dataclasses.dataclass(frozen=True)
class ProcGrid:
    """A 1D/2D/3D processing grid: axis names, sizes, device and ranks."""

    axes: tuple[str, ...]           # axis names, grid dim 0..k-1
    shape: tuple[int, ...]
    device: torch.device | None     # None: abstract (device-less) grid
    #: global ranks of the grid's points, row-major; () on one process
    ranks: tuple[int, ...] = ()
    #: this rank's coordinate on the grid; zeros on one process
    coordinate: tuple[int, ...] = ()
    #: one process group per axis (None for an axis of size 1)
    groups: tuple = dataclasses.field(default=(), compare=False,
                                      repr=False)

    def __post_init__(self):
        if not self.coordinate:
            object.__setattr__(self, "coordinate", (0,) * len(self.shape))

    # ---------------------------------------------------------------- build
    @staticmethod
    def create(procs: Sequence[int] = (1,),
               axis_names: Sequence[str] | None = None, *,
               device=None) -> "ProcGrid":
        """Grid of ``procs`` over the default process group (the paper's
        ``grid(procs, MPI_COMM_WORLD)``), on ``device``.

        One point needs no process group.  More points need
        ``torch.distributed`` initialized with a world of exactly
        ``prod(procs)`` processes: rank r is the row-major point r.  Every
        rank must call this with the same arguments (it builds a process
        group per axis line, a collective of the world).  ``device``
        defaults to CUDA and raises when CUDA is missing (see
        :func:`resolve_device`).
        """
        procs = tuple(int(p) for p in procs)
        names = tuple(axis_names) if axis_names else tuple(
            f"g{i}" for i in range(len(procs)))
        dev = resolve_device(device)
        if math.prod(procs) == 1:
            return ProcGrid(names, procs, dev)
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                f"grid {procs} spans {math.prod(procs)} processes: "
                "initialize torch.distributed first (one process per grid "
                "point), or use ProcGrid.create_abstract to inspect a plan")
        world = dist.get_world_size()
        if world != math.prod(procs):
            raise ValueError(
                f"grid {procs} has {math.prod(procs)} points but the "
                f"process group has {world} ranks; use ProcGrid.from_mesh "
                "for a grid over part of the world")
        ranks = tuple(range(world))
        built = _world_groups(dist)
        groups = []
        for i in range(len(procs)):
            key = (procs, i)
            if procs[i] > 1 and key not in built:
                mine = None
                for line in _axis_lines(ranks, procs, i):
                    # every rank creates every line's group, in one order
                    grp = dist.new_group(line)
                    if dist.get_rank() in line:
                        mine = grp
                built[key] = mine
            groups.append(built.get(key))
        coord = tuple(int(c) for c in torch.tensor(ranks).reshape(procs)
                      .eq(dist.get_rank()).nonzero()[0])
        return ProcGrid(names, procs, dev, ranks, coord, tuple(groups))

    @staticmethod
    def from_mesh(mesh, axes: Sequence[str], *, device=None) -> "ProcGrid":
        """View ``axes`` of a ``torch.distributed.device_mesh.DeviceMesh``
        as the processing grid (the reference's ``from_mesh``): grid axis
        i is the mesh dim named ``axes[i]``, and its process group is the
        mesh's.  The grid's points are the ranks of this rank's sub-mesh
        over those dims.  ``device`` as in :meth:`create`."""
        names = tuple(mesh.mesh_dim_names or ())
        for a in axes:
            if a not in names:
                raise ValueError(f"axis {a!r} not in mesh {names}")
        dims = [names.index(a) for a in axes]
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        arr = mesh.mesh
        index = tuple(slice(None) if d in dims else coord[d]
                      for d in range(arr.ndim))
        kept = [d for d in range(arr.ndim) if d in dims]
        sub = arr[index].permute([kept.index(d) for d in dims])
        shape = tuple(int(s) for s in sub.shape)
        ranks = tuple(int(r) for r in sub.reshape(-1))
        for i, a in enumerate(axes):
            for line in _axis_lines(ranks, shape, i):
                _check_ascending(line, a)
        groups = tuple(mesh.get_group(a) if s > 1 else None
                       for a, s in zip(axes, shape))
        return ProcGrid(tuple(axes), shape, resolve_device(device),
                        ranks if math.prod(shape) > 1 else (),
                        tuple(coord[d] for d in dims), groups)

    @staticmethod
    def create_abstract(procs: Sequence[int],
                        axis_names: Sequence[str] | None = None
                        ) -> "ProcGrid":
        """Device-less grid for plan construction/inspection — execution
        requires a concrete grid."""
        names = tuple(axis_names) if axis_names else tuple(
            f"g{i}" for i in range(len(procs)))
        shape = tuple(int(p) for p in procs)
        return ProcGrid(names, shape, None)

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

    @property
    def multi_process(self) -> bool:
        """True when the grid's points are several processes."""
        return bool(self.ranks)

    def axis_name(self, i: int) -> str:
        return self.axes[i]

    def axis_size(self, i: int) -> int:
        return self.shape[i]

    def axis_index(self, name: str) -> int:
        return self.axes.index(name)

    def group(self, i: int):
        """The process group of grid axis ``i`` (None when the axis has
        one process)."""
        return self.groups[i] if self.groups else None

    # ---------------------------------------------------------- collectives
    def _live(self, axes) -> list[int]:
        return [a for a in axes if self.shape[a] > 1 and self.group(a)]

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum", *,
                   name: str = "grid.all_reduce"):
        """``x`` reduced over grid ``axes`` (sum, max or min), in place
        where a collective runs; ``x`` itself when every axis has one
        process.  Complex tensors travel as their real view.  A collective
        that runs is a split point ``name`` of a captured step
        (:func:`~repro_torch.core.hostsync.host_sync`)."""
        live = self._live(axes)
        if not live:
            return x
        count_collective("all-reduce", x)
        return host_sync(name, self._all_reduce, x, live, op)

    def _all_reduce(self, x, live, op):
        import torch.distributed as dist
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]
        x = x.contiguous()
        buf = torch.view_as_real(x) if x.is_complex() else x
        for a in live:
            dist.all_reduce(buf, op=red, group=self.group(a))
        return x

    def all_reduce_host(self, value, axes, op: str = "sum"):
        """A host float or float64 numpy array reduced over ``axes``
        (every rank gets the same value back); it travels on the grid's
        device, which every backend can reduce."""
        if not self._live(axes):
            return value
        t = torch.as_tensor(np.asarray(value, np.float64),
                            device=self.device)
        out = self.all_reduce(t.reshape(-1), axes, op).cpu().numpy()
        return float(out[0]) if np.ndim(value) == 0 else \
            out.reshape(np.shape(value))

    def replicate(self, x: torch.Tensor, axes=(), dim: int = 0, *,
                  name: str = "grid.replicate"):
        """Replicated placement of a block sharded over grid ``axes``
        along ``dim``: its blocks concatenated, blocked major→minor in the
        order given (the distribution ``x{a,b}`` describes; the minor axis
        is gathered first).  With no sharded axis (one process) every
        tensor already is replicated, and ``x`` comes back unchanged.  A
        gather that runs is a split point ``name`` of a captured step, as
        in :meth:`all_reduce`."""
        live = self._live(axes)
        if not live:
            return x
        count_collective("all-gather", x)
        return host_sync(name, self._replicate, x, live, dim)

    def _replicate(self, x, live, dim):
        import torch.distributed as dist
        for a in reversed(live):
            x = x.contiguous()
            real = x.is_complex()
            buf = torch.view_as_real(x) if real else x
            parts = [torch.empty_like(buf) for _ in range(self.shape[a])]
            dist.all_gather(parts, buf, group=self.group(a))
            if real:
                parts = [torch.view_as_complex(p) for p in parts]
            x = torch.cat(parts, dim=dim)
        return x

    def reduce_scatter(self, x: torch.Tensor, axes=(), dim: int = 0, *,
                       name: str = "grid.reduce_scatter"):
        """The inverse of :meth:`replicate` for sums: ``x`` summed over
        grid ``axes``, of which this rank keeps its block along ``dim``
        (blocked major→minor in the order given, as :meth:`replicate`
        concatenates).  ``x`` itself when every axis has one process.  A
        reduce-scatter that runs is a split point ``name``, as in
        :meth:`all_reduce`."""
        live = self._live(axes)
        if not live:
            return x
        n = math.prod(self.shape[a] for a in live)
        if x.shape[dim] % n:
            raise ValueError(
                f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not "
                f"split into {n} blocks")
        count_collective("reduce-scatter", x)
        return host_sync(name, self._reduce_scatter, x, live, dim)

    def _reduce_scatter(self, x, live, dim):
        import torch.distributed as dist
        for a in live:                      # major axis first
            # dim leading: this axis' blocks follow one another
            parts = x.movedim(dim, 0).contiguous()
            out = torch.empty((parts.shape[0] // self.shape[a],)
                              + tuple(parts.shape[1:]), dtype=x.dtype,
                              device=x.device)
            dist.reduce_scatter_tensor(out, parts, group=self.group(a))
            x = out.movedim(0, dim)
        return x.contiguous()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        dims = "x".join(str(s) for s in self.shape)
        return f"ProcGrid({dims}, axes={self.axes})"
