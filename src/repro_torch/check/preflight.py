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
* :func:`preflight_basis` — a ``PlaneWaveBasis`` configuration, from a
  live :class:`~repro_torch.core.grid.ProcGrid` **or** a bare
  ``grid_shape`` tuple (so an 8-process scenario audits from one card).
  With ``deep=True`` it also builds the k-point spheres host-side and
  checks segmentation, stackability and plan-cache byte feasibility.
  ``PlaneWaveBasis`` runs it on construction.
* :func:`preflight_service` / :func:`preflight_request` — a
  ``TransformService`` configuration / one submit call.  Coefficients may
  be numpy arrays or torch tensors.
* :func:`preflight` — the umbrella ``fftb.preflight``: a spec string
  routes to the transform checks, a config dict (e.g. one scenario from
  ``benchmarks/baseline.json``) to the basis/service checks;
  :func:`preflight_scenario` audits one full baseline record.

All functions *return* the diagnostics list; they never raise.  Library
call sites wrap them in
:func:`~repro_torch.check.diagnostics.raise_if_errors`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .diagnostics import Diagnostic, error, raise_if_errors, warning

__all__ = [
    "preflight",
    "preflight_transform",
    "preflight_basis",
    "preflight_service",
    "preflight_request",
    "preflight_config",
    "preflight_scenario",
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


# ----------------------------------------------------------------- basis
def _basis_plan_bytes(spheres, segments, nbands: int, n: int, d: int
                      ) -> int:
    """Static byte estimate of a basis's full plan-cache working set.

    Per-k pack tables + mask cubes, per-segment stacked pack tables and
    band tables, plus the shared rectangular DFT operand matrices — the
    same quantities the cache bills at runtime, computed from extents
    alone.
    """
    per_k = sum(s.npacked * 4 + d ** 3 for s in spheres)
    stacked = 0
    for seg in segments:
        pad = max(spheres[i].npacked for i in seg)
        lanes = len(seg) * pad
        stacked += lanes * 5                   # int32 idx + bool valid
        stacked += 3 * lanes * 4               # kinetic/mask/precond f32
    dft = 2 * (3 * n * d * 8 + n * n * 8)      # fwd+inv operand tables
    return per_k + stacked + dft


def preflight_basis(n: int, *, diameter: int | None = None,
                    kpts=((0.0, 0.0, 0.0),), nbands: int = 4,
                    grid=None, grid_shape=None, batch_axes=None,
                    fft_axes=None, segment_padding: float | None = None,
                    cache_max_bytes: int | None = None,
                    backend: str | None = None,
                    deep: bool = False) -> list[Diagnostic]:
    """Feasibility of a ``PlaneWaveBasis`` configuration.

    Cheap arithmetic checks always run; ``deep=True`` additionally
    builds the k-point spheres host-side (still no device work) for
    segmentation, stackability (FFTB114/115) and cache-budget (FFTB130)
    analysis — the CLI/self-audit mode.  ``backend`` (the resolved
    line-DFT backend) enables the FFTB118 checks: an unknown backend, or
    a "cuda" request whose line lengths exceed the dense-DFT crossover,
    is an error *here*, not a silent downgrade at plan-build time.
    """
    diags: list[Diagnostic] = []
    n = int(n)
    d = int(diameter) if diameter is not None else n // 2
    if not 0 < d <= n:
        diags.append(error(
            "FFTB116", f"sphere diameter {d} not in (0, {n}]",
            location="diameter",
            hint="the cutoff sphere must fit the FFT cube "
                 "(conventionally d = n/2)"))

    shape = _grid_shape(grid, grid_shape)
    if shape is None:
        shape = (1,)
    batch_axes, fft_axes, bp, fp, axis_diags = _axes_split(
        shape, batch_axes, fft_axes, where="grid")
    diags.extend(axis_diags)
    if axis_diags:
        return diags

    if int(nbands) % bp:
        diags.append(error(
            "FFTB112",
            f"nbands {int(nbands)} not divisible by the batch-axis "
            f"size {bp} of the grid {shape}",
            location="nbands",
            hint="round nbands up to a multiple of the batch-axis "
                 "process count"))
    if n % fp:
        diags.append(error(
            "FFTB110",
            f"cube width {n} must divide over the fft-axis size {fp} "
            f"of the grid {shape}",
            location="n",
            hint="choose n as a multiple of the fft-axis process "
                 "count"))
    if d > 0 and d % fp:
        diags.append(error(
            "FFTB111",
            f"sphere diameter {d} must divide over the fft-axis size "
            f"{fp} of the grid {shape}",
            location="diameter",
            hint="choose a cutoff diameter divisible by the fft-axis "
                 "process count"))

    kpts = np.atleast_2d(np.asarray(kpts, np.float64))
    if kpts.ndim != 2 or kpts.shape[1] != 3:
        diags.append(error(
            "FFTB120", f"kpts must be (nk, 3), got shape {kpts.shape}",
            location="kpts",
            hint="one reduced-coordinate 3-vector per k-point"))
        return diags
    nk = kpts.shape[0]

    if segment_padding is not None and not 0.0 <= segment_padding < 1.0:
        diags.append(error(
            "FFTB117",
            f"segment_padding must be in [0, 1), got {segment_padding}",
            location="segment_padding",
            hint="it is a padded-lane *fraction* budget"))

    if backend is not None:
        from ..core.local_fft import _BACKENDS, MATMUL_MAX_N
        if backend not in _BACKENDS:
            diags.append(error(
                "FFTB118",
                f"unknown line-DFT backend {backend!r}",
                location="backend",
                hint=f"choose one of {_BACKENDS}"))
        elif backend == "cuda" and d > 0 and max(n, d) > MATMUL_MAX_N:
            diags.append(error(
                "FFTB118",
                f"backend 'cuda' requested but the line lengths "
                f"(n={n}, d={d}) exceed the dense-DFT crossover "
                f"{MATMUL_MAX_N} — the fused sphere-pack kernels "
                "would silently realize as 'fft'",
                location="backend",
                hint="shrink the cube/cutoff below the crossover or "
                     "request backend='fft' explicitly"))
        # No working-set rule beside it, unlike the reference's TPU VMEM
        # budget: a block of the CUDA kernels uses a fixed SMEM =
        # SRC_OFFSET + BM*16 + 1024 bytes of shared memory (BM = BN = 128,
        # STAGES = 3; kernels/csrc/cgemm_tc.cuh:96-110), whatever nbands,
        # nk or d, so no problem size can overflow it.

    if not deep or any(dg.is_error for dg in diags):
        return diags

    # ---- deep mode: build spheres host-side, no device work ----------
    from ..core.planewave import kpoint_sphere, segment_spheres

    spheres = [kpoint_sphere(d, kp) for kp in kpts]
    if segment_padding is None:
        segments = (tuple(range(nk)),)
    else:
        div = bp if bp > 1 else None
        segments = segment_spheres(spheres, segment_padding,
                                   size_divisor=div)

    if bp > 1:
        bad = [seg for seg in segments
               if bp % len(seg) or (len(seg) * int(nbands)) % bp]
        if bad and segment_padding is not None:
            diags.append(error(
                "FFTB115",
                f"segment sizes {[len(s) for s in bad]} violate the "
                f"batch-axis size_divisor contract (batch procs {bp}, "
                f"nbands {int(nbands)})",
                location="segment_padding",
                hint="segment lengths must divide the batch-axis size "
                     "and nk_seg*nbands must be divisible by it"))
        elif bad and nk > 1:
            diags.append(warning(
                "FFTB114",
                f"nk={nk} does not stack over the batch-axis size "
                f"{bp} (nbands {int(nbands)}) — the stacked route "
                "falls back to per-k dispatch",
                location="kpts",
                hint="set segment_padding to let the segmenter emit "
                     "divisor-sized segments, or choose nk so "
                     "nk*nbands splits over the batch axes"))

    est = _basis_plan_bytes(spheres, segments, int(nbands), n, d)
    if cache_max_bytes is None:
        from ..core.cache import global_plan_cache
        cache_max_bytes = global_plan_cache().max_bytes
    if est > int(cache_max_bytes):
        diags.append(error(
            "FFTB130",
            f"estimated plan working set ~{est} bytes exceeds the "
            f"plan-cache byte budget {int(cache_max_bytes)} — every "
            "SCF iteration would rebuild evicted plans",
            location="cache.max_bytes",
            hint="raise PlanCache(max_bytes=...) or shrink "
                 "nk/diameter"))
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
    batch_axes, fft_axes, bp, fp, axis_diags = _axes_split(
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
    elif int(max_rows) % bp:
        diags.append(error(
            "FFTB122",
            f"max_rows {max_rows} must split over the batch-axis size "
            f"{bp} of the grid {shape}: a bucket's rows are sharded "
            "over the batch axes",
            location="max_rows",
            hint="choose max_rows as a multiple of the batch-axis "
                 "process count"))
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
    """Audit one scenario/config dict (``benchmarks/baseline.json``).

    ``scf``-style records route to :func:`preflight_basis` (deep),
    ``serve``-style records (``tenants``/``max_rows`` keys) to
    :func:`preflight_service`.  A record's ``backend`` is taken as the
    port's backend name.
    """
    cfg = dict(cfg)
    shape = grid_shape or cfg.get("grid_shape")
    if shape is None and cfg.get("devices"):
        shape = (int(cfg["devices"]),)
    loc = name or "config"
    if "tenants" in cfg or cfg.get("kind") == "service":
        diams = [cfg[k] for k in ("d", "d_small") if cfg.get(k)]
        diags = preflight_service(
            cfg["n"], grid_shape=shape,
            batch_axes=tuple(cfg.get("batch_axes", ())),
            fft_axes=cfg.get("fft_axes"),
            max_rows=cfg.get("max_rows", 8),
            padding_budget=cfg.get("padding_budget", 0.5),
            diameters=diams)
    else:
        diags = preflight_basis(
            cfg["n"], diameter=cfg.get("diameter"),
            kpts=cfg.get("kpts", ((0.0, 0.0, 0.0),)),
            nbands=cfg.get("nbands", 4), grid_shape=shape,
            batch_axes=cfg.get("batch_axes"),
            fft_axes=cfg.get("fft_axes"),
            segment_padding=cfg.get("segment_padding"),
            cache_max_bytes=cfg.get("cache_max_bytes"),
            backend=cfg.get("backend"), deep=True)
    return [Diagnostic(dg.code, dg.severity, dg.message,
                       f"{loc}: {dg.location}" if dg.location else loc,
                       dg.hint) for dg in diags]


#: the reference's backend names in its benchmark records, as the port's
#: (a record of ``benchmarks/baseline.json`` says "jnp" or "pallas")
_REFERENCE_BACKENDS = {"jnp": "fft", "pallas": "cuda"}


def preflight_scenario(name: str, record: dict) -> list[Diagnostic]:
    """Audit one full baseline.json record (scenario + grid_shape).

    The record's reference backend name is translated to the port's
    (:data:`_REFERENCE_BACKENDS`); nothing else translates it.
    """
    cfg = dict(record.get("scenario", record))
    if cfg.get("backend") in _REFERENCE_BACKENDS:
        cfg["backend"] = _REFERENCE_BACKENDS[cfg["backend"]]
    return preflight_config(cfg, name=name,
                            grid_shape=record.get("grid_shape"))


def preflight(target, **kwargs) -> list[Diagnostic]:
    """Umbrella entry point, exposed as ``fftb.preflight``.

    * ``preflight("b x{0} ... -> ...", domains=, grid=, sizes=)`` —
      transform-spec checks (:func:`preflight_transform`);
    * ``preflight({"n": 16, "kpts": ..., ...})`` — config/scenario
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
