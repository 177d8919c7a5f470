"""fftb() — the user-facing constructor around one arrow-spec string.

The entry points::

    fx = fftb("x{0} y z -> X Y Z{0}", domains=dom, grid=g)     # build a plan
    y  = fftb.apply("b x{0} y z -> b X Y Z{0}", x,             # cached apply
                    domains=(b, dom), grid=g)
    tr = Transform.parse("b x{0} y z -> b X Y Z{0}")           # reusable spec

Dims pair up positionally across the arrow; a dim with the same name on both
sides is a batch dim, a renamed dim ("x -> X") is transformed.  Transformed
sizes are inferred from the declared domains (same-size transforms) unless
``sizes=``/``out_domains=`` override them — a SphereDomain among the input
domains selects the plane-wave staged-padding path automatically.

``fftb.apply``/``fftb.plan_for`` memoize built plans in a process-global LRU
``PlanCache`` keyed by (spec, domains, grid, policy, ...), so SCF code never
re-runs the schedule search for a transform it has already used.
"""
from __future__ import annotations

import dataclasses

from .cache import PlanCache, domains_key, global_plan_cache, grid_key
from .domain import Domain, SphereDomain
from .dtensor import DistTensor, dims_string, parse_transform_spec
from .plan import FftPlan, Plan
from .planewave import PlaneWaveFFT
from .policy import ExecPolicy


def _as_domains(domains) -> tuple[Domain, ...]:
    if isinstance(domains, Domain):
        return (domains,)
    return tuple(domains)


@dataclasses.dataclass(frozen=True)
class Transform:
    """A parsed arrow spec — the declarative half of a plan.

    Hashable (layouts stored as sorted item tuples), so a Transform can be
    parsed once at module import and reused to build plans against many
    (domains, grid) combinations.
    """

    spec: str
    in_dims: tuple[str, ...]
    in_layout: tuple[tuple[str, tuple[int, ...]], ...]
    out_dims: tuple[str, ...]
    out_layout: tuple[tuple[str, tuple[int, ...]], ...]

    @staticmethod
    def parse(spec: str) -> "Transform":
        (in_names, in_dist), (out_names, out_dist) = \
            parse_transform_spec(spec)
        return Transform(spec, in_names, tuple(sorted(in_dist.items())),
                         out_names, tuple(sorted(out_dist.items())))

    # ------------------------------------------------------------- queries
    @property
    def rank(self) -> int:
        return len(self.in_dims)

    @property
    def fft_pairs(self) -> list[tuple[str, str]]:
        """(input dim, output dim) for every transformed dim, in order."""
        return [(i, o) for i, o in zip(self.in_dims, self.out_dims)
                if i != o]

    @property
    def batch_dims(self) -> tuple[str, ...]:
        return tuple(i for i, o in zip(self.in_dims, self.out_dims)
                     if i == o)

    @property
    def in_spec(self) -> str:
        return dims_string(self.in_dims, dict(self.in_layout))

    @property
    def out_spec(self) -> str:
        return dims_string(self.out_dims, dict(self.out_layout))

    # ------------------------------------------------------------ building
    def _infer_out_domains(self, domains: tuple[Domain, ...],
                           sizes: dict[str, int]) -> tuple[Domain, ...]:
        """Output domains: input domains with transformed extents replaced.

        A SphereDomain whose dims are transformed opens up to its cuboid
        (the inverse plane-wave direction); producing a sphere *output*
        (forward truncation) needs explicit ``out_domains`` — or just
        derive it as ``plan.inverse()``.
        """
        fft_in = {i for i, _ in self.fft_pairs}
        out: list[Domain] = []
        cursor = 0
        for dom in domains:
            names = self.in_dims[cursor:cursor + dom.ndim]
            cursor += dom.ndim
            touched = any(n in fft_in for n in names)
            if not touched:
                out.append(dom)
                continue
            extents = tuple(sizes.get(n, e)
                            for n, e in zip(names, dom.extents))
            if isinstance(dom, SphereDomain) or extents != dom.extents:
                out.append(Domain((0,) * dom.ndim,
                                  tuple(e - 1 for e in extents)))
            else:
                out.append(dom)
        return tuple(out)

    def _norm_sizes(self, sizes) -> dict[str, int]:
        pairs = self.fft_pairs
        if sizes is None:
            return {}
        if isinstance(sizes, dict):
            bad = set(sizes) - {i for i, _ in pairs}
            if bad:
                raise ValueError(f"sizes name non-transformed dims {bad}")
            return dict(sizes)
        sizes = tuple(sizes)
        if len(sizes) != len(pairs):
            raise ValueError(
                f"{len(sizes)} sizes for {len(pairs)} transformed dims")
        return {i: n for (i, _), n in zip(pairs, sizes)}

    def build(self, domains, grid, *, out_domains=None, sizes=None,
              inverse: bool = False, backend: str = "matmul",
              policy: ExecPolicy | None = None) -> Plan:
        """Construct the plan for this spec over concrete domains/grid."""
        domains = _as_domains(domains)
        rank = sum(d.ndim for d in domains)
        if rank != self.rank:
            raise ValueError(
                f"spec {self.spec!r} has rank {self.rank} but domains have "
                f"rank {rank}")
        size_map = self._norm_sizes(sizes)
        if out_domains is None:
            out_domains = self._infer_out_domains(domains, size_map)
        else:
            out_domains = _as_domains(out_domains)
        tin = DistTensor.create(domains, self.in_spec, grid)
        tout = DistTensor.create(out_domains, self.out_spec, grid)
        pairs = self.fft_pairs
        for i, o in pairs:
            if i in size_map and tout.dim_size(o) != size_map[i]:
                raise ValueError(
                    f"output dim {o} extent {tout.dim_size(o)} != "
                    f"size {size_map[i]}")
        sphere = [d for t in (tin, tout) for d in t.domains
                  if isinstance(d, SphereDomain)]
        if sphere:
            n = tuple(max(tin.dim_size(i), tout.dim_size(o))
                      for i, o in pairs)
            return PlaneWaveFFT(sphere[0], n, tin, tout, inverse=inverse,
                                backend=backend, pairs=pairs, policy=policy)
        return FftPlan(tin, tout, pairs, inverse=inverse, backend=backend,
                       policy=policy)


# ----------------------------------------------------------------- builders
def _plan_cache_key(spec: str, domains, grid, *, out_domains, sizes,
                    inverse, backend, policy) -> tuple:
    if isinstance(sizes, dict):
        sizes = tuple(sorted(sizes.items()))
    elif sizes is not None:
        sizes = tuple(sizes)
    return (spec, domains_key(domains), grid_key(grid),
            domains_key(out_domains), sizes, inverse, backend, policy)


def plan_for(spec: str, *, domains, grid, out_domains=None, sizes=None,
             inverse: bool = False, backend: str = "matmul",
             policy: ExecPolicy | None = None,
             cache: PlanCache | None = None) -> Plan:
    """Cached plan lookup — builds (schedule search and all) only on miss.

    A miss first runs the transform preflight: a bad spec, domain or grid
    raises :class:`~repro_torch.check.DiagnosticError` with its
    ``FFTB1xx`` code before any plan work.
    """
    cache = cache if cache is not None else global_plan_cache()
    key = _plan_cache_key(spec, domains, grid, out_domains=out_domains,
                          sizes=sizes, inverse=inverse, backend=backend,
                          policy=policy)

    def _build():
        # coded preflight diagnostics before any plan work — runs on
        # cache misses only, so the hot (hit) path pays nothing
        from ..check.preflight import check_transform
        check_transform(spec, domains=domains, grid=grid, sizes=sizes,
                        out_domains=out_domains)
        return Transform.parse(spec).build(
            domains, grid, out_domains=out_domains, sizes=sizes,
            inverse=inverse, backend=backend, policy=policy)

    return cache.get_or_build(key, _build)


def apply(spec: str, x, *, domains, grid, out_domains=None, sizes=None,
          inverse: bool = False, backend: str = "matmul",
          policy: ExecPolicy | None = None, cache: PlanCache | None = None):
    """One-shot cached transform: ``fftb.apply(spec, x, domains=, grid=)``.

    Repeated calls with the same (spec, domains, grid, policy) reuse the
    cached plan — no second schedule search.
    """
    plan = plan_for(spec, domains=domains, grid=grid,
                    out_domains=out_domains, sizes=sizes, inverse=inverse,
                    backend=backend, policy=policy, cache=cache)
    return plan(x)


# ------------------------------------------------------------- entry point
def fftb(spec, *args, **kwargs):
    """Create a distributed (batched) multi-dimensional Fourier transform.

    One form — arrow spec plus domains/grid::

        fftb("b x{0} y z -> b X Y Z{0}", domains=(b, dom), grid=g)

    Returns a Plan (FftPlan or PlaneWaveFFT) exposing ``__call__``,
    ``inverse()``, ``adjoint()``, ``describe()``, ``flop_count()`` and
    ``comm_stats()``.
    """
    if not isinstance(spec, str):
        raise TypeError(
            "fftb takes one arrow spec string plus domains and grid, e.g. "
            "fftb('x{0} y z -> X Y Z{0}', domains=dom, grid=g)")
    return Transform.parse(spec).build(*args, **kwargs)


def _preflight(target, **kwargs):
    """``fftb.preflight(...)`` — static feasibility diagnostics.

    A spec string routes to the transform checks, a service config dict
    to the service checks; returns the
    :class:`~repro_torch.check.diagnostics.Diagnostic` list, never raises
    on a bad configuration.
    """
    from ..check.preflight import preflight
    return preflight(target, **kwargs)


fftb.apply = apply
fftb.plan_for = plan_for
fftb.cache = global_plan_cache
fftb.preflight = _preflight
