"""Distributed tensor descriptors — the paper's `tensor(dom, "b x{0} y z", g)`.

A dims-string names each logical dimension and annotates distribution over
processing-grid axes::

    "x{0} y z"      x distributed over grid axis 0; y, z local
    "b x{0} y{1} z" batched, 2D processing grid
    "X Y Z{0}"      output tensor distributed in z

Multiple grid axes on one dim ("x{0,1}") shard it over both, major→minor in
the order written.  The distribution is *blocked*; a tensor's local block
shape follows from the global shape and the grid axis sizes
(:attr:`DistTensor.local_shape`).

What each rank holds (one process per grid point).  Every rank holds the
*local block* of a distributed tensor: along a dim sharded over axes
``{a, b}`` the block at index ``c_a · size_b + c_b`` (its coordinates
``c``), and along every other dim the whole extent.  A grid axis that no
dim names replicates the tensor: every rank along it holds the same block.
Plans and the plane-wave entry points take and return local blocks.  The
rule the DFT layer keeps on top of that:

* packed coefficient blocks ``(bands, lanes)`` outside a plan are
  replicated (what the reference's ``grid.replicate`` pins); a plan
  reads the rank's rows of them (:meth:`DistTensor.scatter` along the
  batch dim) and its packed result is gathered back over the batch axes;
* real-space and G-space cubes (orbitals, ρ, potentials) stay sharded —
  z-blocks over the fft axes — from the inverse transform to the forward
  one; a reduction over a cube (an energy, a norm, ρ's band sum) is an
  all-reduce over the axes that split it.

:meth:`DistTensor.scatter` and :meth:`DistTensor.gather` convert between
the global tensor and the local block; on one process both are the
identity.
"""
from __future__ import annotations

import dataclasses
import re

from .domain import Domain
from .grid import ProcGrid

_TOKEN = re.compile(r"^([A-Za-z_][A-Za-z_0-9]*)(?:\{(\d+(?:,\d+)*)\})?$")


def parse_dims(spec: str) -> tuple[tuple[str, ...], dict[str, tuple[int, ...]]]:
    """Parse a dims-string → (dim names, {dim: grid-axis indices})."""
    if "->" in spec:
        raise ValueError(
            f"{spec!r} is an arrow spec — one side expected here "
            "(use parse_transform_spec / Transform.parse for 'in -> out')")
    names: list[str] = []
    dist: dict[str, tuple[int, ...]] = {}
    for tok in spec.split():
        m = _TOKEN.match(tok)
        if not m:
            raise ValueError(f"bad dim token {tok!r} in {spec!r}")
        name, axes = m.group(1), m.group(2)
        if name in names:
            raise ValueError(f"duplicate dim {name!r} in {spec!r}")
        names.append(name)
        if axes:
            dist[name] = tuple(int(a) for a in axes.split(","))
    return tuple(names), dist


def dims_string(names, dist) -> str:
    """Inverse of ``parse_dims``: render (names, {dim: axes}) as a spec."""
    toks = []
    for nm in names:
        axes = dist.get(nm, ())
        toks.append(nm + ("{%s}" % ",".join(map(str, axes)) if axes else ""))
    return " ".join(toks)


def parse_transform_spec(spec: str):
    """Parse an arrow spec ``"b x{0} y z -> b X Y Z{0}"``.

    Returns ``((in_names, in_dist), (out_names, out_dist))``.  Dims pair up
    positionally; a dim whose name is identical on both sides is a *batch*
    dim, a renamed dim is *transformed* (the paper's lower→upper convention,
    though any renaming counts).
    """
    parts = spec.split("->")
    if len(parts) != 2:
        raise ValueError(
            f"transform spec must contain exactly one '->': {spec!r}")
    lhs, rhs = parts
    if not lhs.strip() or not rhs.strip():
        raise ValueError(f"empty side in transform spec {spec!r}")
    in_names, in_dist = parse_dims(lhs)
    out_names, out_dist = parse_dims(rhs)
    if len(in_names) != len(out_names):
        raise ValueError(
            f"rank mismatch in {spec!r}: {len(in_names)} input dims vs "
            f"{len(out_names)} output dims")
    if not any(i != o for i, o in zip(in_names, out_names)):
        raise ValueError(
            f"no transformed dims in {spec!r}: rename at least one dim "
            "(e.g. 'x -> X') to mark it transformed")
    return (in_names, in_dist), (out_names, out_dist)


@dataclasses.dataclass(frozen=True)
class DistTensor:
    """Descriptor: domains × dims-string × processing grid (paper Fig. 6/8).

    ``domains`` are composed by cross product, in order, one logical dim per
    domain *axis* — a 1D batch domain contributes dim 0, a 3D cuboid domain
    contributes three dims, mirroring the paper's `dom_in.push_back(...)`.
    """

    domains: tuple[Domain, ...]
    dims: tuple[str, ...]
    layout: dict[str, tuple[int, ...]]       # dim -> grid axes (major→minor)
    grid: ProcGrid

    @staticmethod
    def create(domains, dims_spec: str, grid: ProcGrid) -> "DistTensor":
        if isinstance(domains, Domain):
            domains = (domains,)
        names, dist = parse_dims(dims_spec)
        rank = sum(d.ndim for d in domains)
        if rank != len(names):
            raise ValueError(
                f"dims {names} rank {len(names)} != domain rank {rank}")
        for dim, axes in dist.items():
            for a in axes:
                if a >= grid.ndim:
                    raise ValueError(
                        f"dim {dim!r} references grid axis {a} but grid has "
                        f"{grid.ndim} axes")
        return DistTensor(tuple(domains), names, dist, grid)

    # ---------------------------------------------------------------- shape
    @property
    def shape(self) -> tuple[int, ...]:
        out: list[int] = []
        for d in self.domains:
            out.extend(d.extents)
        return tuple(out)

    def dim_index(self, name: str) -> int:
        return self.dims.index(name)

    def dim_size(self, name: str) -> int:
        return self.shape[self.dim_index(name)]

    # ------------------------------------------------------------- sharding
    @property
    def local_shape(self) -> tuple[int, ...]:
        """Shape of one process's block under the blocked distribution."""
        out = []
        for name, n in zip(self.dims, self.shape):
            for a in self.layout.get(name, ()):
                s = self.grid.axis_size(a)
                if n % s:
                    raise ValueError(
                        f"dim {name} size {n} not divisible by grid axis "
                        f"{a} (size {s})")
                n //= s
            out.append(n)
        return tuple(out)

    def local_offsets(self) -> tuple[int, ...]:
        """Global index of this rank's block's first element, per dim."""
        out = []
        for name, n in zip(self.dims, self.shape):
            block, loc = 0, n
            for a in self.layout.get(name, ()):
                s = self.grid.axis_size(a)
                block = block * s + self.grid.coordinate[a]
                loc //= s
            out.append(block * loc)
        return tuple(out)

    def local_slices(self) -> tuple[slice, ...]:
        """This rank's block of the global tensor, as one slice per dim."""
        return tuple(slice(o, o + n) for o, n in
                     zip(self.local_offsets(), self.local_shape))

    def scatter(self, x):
        """Global tensor (every rank holds all of it) → this rank's local
        block (a contiguous copy, or ``x`` itself when nothing is
        sharded)."""
        if tuple(x.shape) != self.shape:
            raise ValueError(f"scatter: shape {tuple(x.shape)} != "
                             f"{self.shape}")
        if self.local_shape == self.shape:
            return x
        return x[self.local_slices()].contiguous()

    def gather(self, x):
        """This rank's local block → the global tensor, gathered from every
        rank's block (each dim over its axes, major→minor)."""
        if tuple(x.shape) != self.local_shape:
            raise ValueError(f"gather: shape {tuple(x.shape)} != local "
                             f"{self.local_shape}")
        for i, name in enumerate(self.dims):
            x = self.grid.replicate(x, self.layout.get(name, ()), dim=i)
        return x
