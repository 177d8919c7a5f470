"""Preflight feasibility diagnostics — reject infeasible work *before*
any device work.

The paper's flexibility (arbitrary specs, non-regular sphere domains,
1D/2D/3D process grids) is exactly where configurations go wrong: an
indivisible extent otherwise surfaces as a shape error deep inside plan
execution.  Every check here is static host arithmetic over the declared
configuration; each finding is a
:class:`~repro_torch.check.diagnostics.Diagnostic` with the reference
package's stable ``FFTB1xx`` code, message and fix hint.

Entry points
------------
* :func:`preflight_transform` — an arrow spec against domains/grid:
  DSL well-formedness, grid-axis references, rank, sharded-extent
  divisibility.  ``fftb.plan_for`` runs it (:func:`check_transform`) on
  every cache miss.
* :func:`preflight_service` / :func:`preflight_request` — a
  ``TransformService`` configuration / one submit call.  Coefficients may
  be numpy arrays or torch tensors.
* :func:`preflight` — the umbrella ``fftb.preflight``: a spec string
  routes to the transform checks, a service config dict to the service
  checks.  SCF-basis configs (``preflight_basis`` and its feasibility
  model for the fused kernels) are not ported yet.

All functions *return* the diagnostics list; they never raise.  Library
call sites wrap them in
:func:`~repro_torch.check.diagnostics.raise_if_errors`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .diagnostics import Diagnostic, error, raise_if_errors

__all__ = [
    "preflight",
    "preflight_transform",
    "preflight_service",
    "preflight_request",
    "preflight_config",
    "check_transform",
]


# --------------------------------------------------------------- helpers
def _grid_shape(grid, grid_shape) -> tuple[int, ...] | None:
    if grid is not None:
        return tuple(grid.shape)
    if grid_shape is not None:
        return tuple(int(s) for s in grid_shape)
    return None


def _axes_split(shape, batch_axes, fft_axes, *, where: str
                ) -> tuple[tuple, tuple, int, int, list[Diagnostic]]:
    """Resolve (batch, fft) axes over ``shape`` with basis defaults."""
    ndim = len(shape)
    if batch_axes is None:
        batch_axes = () if ndim == 1 else (0,)
    batch_axes = tuple(batch_axes)
    if fft_axes is None:
        fft_axes = tuple(a for a in range(ndim) if a not in batch_axes)
    fft_axes = tuple(fft_axes)
    used = batch_axes + fft_axes
    if len(set(used)) != len(used) or not fft_axes or any(
            a >= ndim or a < 0 for a in used):
        return batch_axes, fft_axes, 1, 1, [error(
            "FFTB113",
            f"batch_axes {batch_axes} / fft_axes {fft_axes} must be "
            f"disjoint valid axes of the {ndim}-axis grid {shape} with "
            "at least one fft axis",
            location=where,
            hint="leave batch_axes/fft_axes unset for the "
                 "(batch, fft, ...) default split",
        )]
    bp = math.prod(shape[a] for a in batch_axes) if batch_axes else 1
    fp = math.prod(shape[a] for a in fft_axes)
    return batch_axes, fft_axes, bp, fp, []


# ------------------------------------------------------------- transform
def preflight_transform(spec: str, *, domains=None, grid=None, sizes=None,
                        out_domains=None) -> list[Diagnostic]:
    """Static checks for one arrow spec against concrete domains/grid."""
    from ..core.domain import Domain, SphereDomain
    from ..core.dtensor import parse_transform_spec

    diags: list[Diagnostic] = []
    try:
        (in_names, in_dist), (out_names, out_dist) = \
            parse_transform_spec(spec)
    except ValueError as err:
        return [error("FFTB101", str(err), location=repr(spec),
                      hint="spec is 'in dims -> out dims', dims "
                           "space-separated, '{i}' tags grid axes, "
                           "rename a dim (x -> X) to transform it")]

    shape = tuple(grid.shape) if grid is not None else None
    if shape is not None:
        for side, dist in (("input", in_dist), ("output", out_dist)):
            for dim, axes in sorted(dist.items()):
                for a in axes:
                    if a >= len(shape):
                        diags.append(error(
                            "FFTB102",
                            f"{side} dim {dim!r} references grid axis "
                            f"{a} but the grid has {len(shape)} axes",
                            location=repr(spec),
                            hint="match the '{i}' tags to the grid's "
                                 "axis count"))

    if domains is None:
        return diags
    if isinstance(domains, Domain):
        domains = (domains,)
    domains = tuple(domains)
    rank = sum(d.ndim for d in domains)
    if rank != len(in_names):
        diags.append(error(
            "FFTB103",
            f"spec {spec!r} has rank {len(in_names)} but the domains "
            f"have rank {rank}",
            hint="one spec dim per domain axis, domains composed in "
                 "order"))
        return diags

    # dim -> (extent, is-sphere-bbox) on the input side
    in_ext: dict[str, tuple[int, bool]] = {}
    cursor = 0
    for dom in domains:
        sphere = isinstance(dom, SphereDomain)
        for name, e in zip(in_names[cursor:cursor + dom.ndim],
                           dom.extents):
            in_ext[name] = (int(e), sphere)
        cursor += dom.ndim

    pairs = [(i, o) for i, o in zip(in_names, out_names) if i != o]
    size_map: dict[str, int] = {}
    if sizes is not None:
        if isinstance(sizes, dict):
            size_map = {k: int(v) for k, v in sizes.items()}
        else:
            sizes = tuple(sizes)
            if len(sizes) != len(pairs):
                diags.append(error(
                    "FFTB103",
                    f"{len(sizes)} sizes for {len(pairs)} transformed "
                    f"dims in {spec!r}",
                    hint="pass one size per renamed dim, in spec order"))
                return diags
            size_map = {i: int(n) for (i, _), n in zip(pairs, sizes)}

    out_ext: dict[str, tuple[int, bool]] = {}
    for i, o in zip(in_names, out_names):
        e, sphere = in_ext[i]
        if i != o:
            out_ext[o] = (size_map.get(i, e), False)
        else:
            out_ext[o] = (e, sphere)
    if out_domains is not None:
        if isinstance(out_domains, Domain):
            out_domains = (out_domains,)
        ext = [e for d in out_domains for e in d.extents]
        if len(ext) == len(out_names):
            sph = [isinstance(d, SphereDomain) for d in out_domains
                   for _ in d.extents]
            out_ext = {n: (int(e), s)
                       for n, e, s in zip(out_names, ext, sph)}

    if shape is None:
        return diags
    for side, dist, ext in (("input", in_dist, in_ext),
                            ("output", out_dist, out_ext)):
        for dim, axes in sorted(dist.items()):
            if any(a >= len(shape) for a in axes):
                continue                        # already FFTB102
            div = math.prod(shape[a] for a in axes)
            e, sphere = ext[dim]
            if e % div == 0:
                continue
            if sphere:
                diags.append(error(
                    "FFTB111",
                    f"sphere bounding-box extent {e} of {side} dim "
                    f"{dim!r} must divide over the fft-axis size {div} "
                    f"(grid axes {axes} of {shape})",
                    location=repr(spec),
                    hint="choose a cutoff diameter divisible by the "
                         "fft-axis process count"))
            else:
                diags.append(error(
                    "FFTB110",
                    f"{side} dim {dim!r} extent {e} must divide over "
                    f"grid axes {axes} (size {div}) of {shape}",
                    location=repr(spec),
                    hint="pad the extent or re-shape the process grid"))
    return diags


# --------------------------------------------------------------- service
def preflight_service(n: int, *, grid=None, grid_shape=None,
                      batch_axes=(), fft_axes=None, max_rows: int = 8,
                      padding_budget: float = 0.5,
                      diameters=()) -> list[Diagnostic]:
    """Feasibility of a ``TransformService`` configuration."""
    diags: list[Diagnostic] = []
    n = int(n)
    shape = _grid_shape(grid, grid_shape)
    if shape is None:
        shape = (1,)
    batch_axes, fft_axes, _, fp, axis_diags = _axes_split(
        shape, batch_axes if batch_axes is not None else (), fft_axes,
        where="grid")
    diags.extend(axis_diags)
    if axis_diags:
        return diags

    if n % fp:
        diags.append(error(
            "FFTB110",
            f"cube width {n} must divide over the fft-axis size {fp} "
            f"of the grid {shape}",
            location="n",
            hint="choose n as a multiple of the fft-axis process "
                 "count"))
    if int(max_rows) < 1:
        diags.append(error(
            "FFTB122", f"max_rows must be >= 1, got {max_rows}",
            location="max_rows",
            hint="max_rows caps the coalesced batch's row bucket"))
    if not 0.0 <= float(padding_budget) < 1.0:
        diags.append(error(
            "FFTB117",
            f"padding_budget must be in [0, 1), got {padding_budget}",
            location="padding_budget",
            hint="it is a padded-lane *fraction* budget"))
    for raw in diameters:
        d = int(raw)
        if not 0 < d <= n:
            diags.append(error(
                "FFTB116", f"sphere diameter {d} not in (0, {n}]",
                location="diameters",
                hint="request cutoffs must fit the service's cube"))
        elif d % fp:
            diags.append(error(
                "FFTB111",
                f"sphere diameter {d} must divide over the fft-axis "
                f"size {fp} of the grid {shape}",
                location="diameters",
                hint="this cutoff cannot shard on the service's grid"))
    return diags


def _is_complex(coeffs) -> tuple[bool, object]:
    """(complex?, dtype) of a numpy array, torch tensor or array-like."""
    if isinstance(coeffs, torch.Tensor):
        return torch.is_complex(coeffs), coeffs.dtype
    dt = np.asarray(coeffs).dtype if not hasattr(coeffs, "dtype") \
        else np.dtype(coeffs.dtype)
    return bool(np.issubdtype(dt, np.complexfloating)), dt


def preflight_request(sphere, *, n: int, fft_procs: int,
                      max_rows: int | None = None,
                      nbands: int | None = None,
                      coeffs=None) -> list[Diagnostic]:
    """Feasibility of one ``TransformService.submit`` call."""
    diags: list[Diagnostic] = []
    if any(e % int(fft_procs) for e in sphere.extents):
        diags.append(error(
            "FFTB111",
            f"sphere extents {sphere.extents} must divide over the "
            f"fft-axis size {int(fft_procs)} — this cutoff cannot "
            "shard on the service's grid",
            location="sphere",
            hint="choose a cutoff diameter divisible by the fft-axis "
                 "process count"))
    if (max_rows is not None and nbands is not None
            and int(nbands) > int(max_rows)):
        diags.append(error(
            "FFTB122",
            f"request has {int(nbands)} bands > max_rows "
            f"{int(max_rows)}; split it",
            location="nbands",
            hint="submit several <= max_rows requests — the scheduler "
                 "coalesces them back"))
    if coeffs is not None:
        shp = tuple(coeffs.shape) if hasattr(coeffs, "shape") \
            else tuple(np.shape(coeffs))
        if len(shp) != 2 or shp[1] != sphere.npacked or (
                nbands is not None and shp[0] != int(nbands)):
            diags.append(error(
                "FFTB120",
                f"coeffs shape {shp} does not match "
                f"(nbands, npacked={sphere.npacked})",
                location="coeffs",
                hint="pack coefficients in the sphere's CSR order"))
        ok, dt = _is_complex(coeffs)
        if not ok:
            diags.append(error(
                "FFTB121",
                f"coefficients must be complex, got dtype {dt}",
                location="coeffs",
                hint="plane-wave coefficients are complex64"))
    return diags


# ------------------------------------------------------------- umbrella
def preflight_config(cfg: dict, *, name: str = "",
                     grid_shape=None) -> list[Diagnostic]:
    """Audit one service config dict (``tenants``/``max_rows`` keys or
    ``kind: "service"``) through :func:`preflight_service`.

    SCF-basis configs need ``preflight_basis``, which is not ported yet:
    they raise ``NotImplementedError``.
    """
    cfg = dict(cfg)
    if not ("tenants" in cfg or cfg.get("kind") == "service"):
        raise NotImplementedError(
            "preflight of SCF-basis configs (preflight_basis) is not "
            "ported yet; only transform specs and service configs are")
    shape = grid_shape or cfg.get("grid_shape")
    if shape is None and cfg.get("devices"):
        shape = (int(cfg["devices"]),)
    loc = name or "config"
    diams = [cfg[k] for k in ("d", "d_small") if cfg.get(k)]
    diags = preflight_service(
        cfg["n"], grid_shape=shape,
        batch_axes=tuple(cfg.get("batch_axes", ())),
        fft_axes=cfg.get("fft_axes"),
        max_rows=cfg.get("max_rows", 8),
        padding_budget=cfg.get("padding_budget", 0.5),
        diameters=diams)
    return [Diagnostic(dg.code, dg.severity, dg.message,
                       f"{loc}: {dg.location}" if dg.location else loc,
                       dg.hint) for dg in diags]


def preflight(target, **kwargs) -> list[Diagnostic]:
    """Umbrella entry point, exposed as ``fftb.preflight``.

    * ``preflight("b x{0} ... -> ...", domains=, grid=, sizes=)`` —
      transform-spec checks (:func:`preflight_transform`);
    * ``preflight({"n": 16, "tenants": 3, ...})`` — service config
      checks (:func:`preflight_config`).

    Returns the diagnostics list (possibly empty); never raises on a bad
    configuration.
    """
    if isinstance(target, str):
        return preflight_transform(target, **kwargs)
    if isinstance(target, dict):
        return preflight_config(target, **kwargs)
    raise TypeError(
        f"preflight expects an arrow-spec string or a config dict, "
        f"got {type(target).__name__}")


def check_transform(spec: str, *, domains=None, grid=None, sizes=None,
                    out_domains=None) -> None:
    """Raise :class:`DiagnosticError` on any transform preflight error.

    The ``fftb.plan_for`` hook — runs on cache misses only.
    """
    raise_if_errors(preflight_transform(
        spec, domains=domains, grid=grid, sizes=sizes,
        out_domains=out_domains))
