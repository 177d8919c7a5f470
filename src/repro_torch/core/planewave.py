"""Plane-wave (sphere-batched) FFT — the paper's §2.2/§3.3.

Wavefunction coefficients live inside a cut-off sphere of diameter d inside
an FFT grid of width n (conventionally n = 2d, Fig. 2).  Instead of padding
every sphere to the n³ cube up front (≈16× redundant data), the transform
pads **in stages**, fusing each pad with that dimension's line DFTs
(rectangular DFT matmuls) and scheduling the distributed transpose while
the moved dims are still small.

Stage schedule (inverse, sphere → real space; forward is the exact mirror
with truncating DFTs):

    in   (b, x{F}, y, z)  bounding cube d³, x sharded over fft axes F
    iDFT z : d→n   (local rectangular matmul — pad fused)
    a2a  over F    : gather x, split z       [moves b·d·d·n/F, the minimum]
    iDFT y : d→n
    iDFT x : d→n
    out  (b, X, Y, Z{F})  real-space cube, z sharded — paper Fig. 5 layout

All of this reuses FftPlan's machinery: the comm-cost schedule search finds
this order automatically; this module adds the sphere bookkeeping (CSR
offset arrays → static pack/unpack index tables) and, on the "cuda"
backend, the fused sphere-pack kernels at both ends of the stage list.

On a multi-process grid every entry point works on the rank's local block
(``DistTensor``'s rule): packed coefficients ``(rows, lanes)`` hold the
rank's batch rows and *every* lane; the bounding cube holds the rank's
rows and x planes.  ``unpack`` scatters only the lanes of the rank's x
planes; ``pack`` gathers them, writes +0.0 to the other lanes, and sums
the blocks over the axes that split x (each lane lives on exactly one x
plane, so the sum is that lane's value, and a padded lane stays +0.0).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..obs.trace import get_tracer
from .domain import Domain, SphereDomain
from .dtensor import DistTensor
from .local_fft import dft_matrix_device, realized_backend
from .plan import FFTStage, FftPlan, Plan
from .policy import ExecPolicy


# ---------------------------------------------------------- fused kernels
def _split_operand(st, dev):
    """The kernels' cached split operand of stage ``st``'s DFT matrix, or
    None on the CPU (the plain versions need none)."""
    if dev.type != "cuda":
        return None
    from ..kernels.ops import dft_operand_device
    return dft_operand_device(st.n_out, st.n_in, st.inverse, dev)


def _local_lines(sphere_side: DistTensor):
    """The rank's part of the ``(rows, ex·ey)`` line tables of the sphere
    side ``(b, x, y, z)``: (row slice, line slice, x-plane slice).  Lines
    are x-major, so the rank's x planes are one run of lines."""
    rows, xs = sphere_side.local_slices()[:2]
    ey = sphere_side.shape[2]
    return rows, slice(xs.start * ey, xs.stop * ey), xs


def _lane_tables(idx: np.ndarray, sphere_side: DistTensor):
    """Pack tables cut to the rank's x planes.

    ``idx`` holds flat bounding-cube indices (``prod(extents)`` marks a
    padded lane).  Returns ``(local, cells)``: each lane's flat index in
    the rank's block of x planes, ``cells`` (the block's dump slot) for a
    lane outside them or padded, and the block's cell count."""
    _, ex, ey, ez = sphere_side.shape
    xs = sphere_side.local_slices()[1]
    plane = ey * ez
    cells = (xs.stop - xs.start) * plane
    x = idx // plane
    inside = (idx < ex * plane) & (x >= xs.start) & (x < xs.stop)
    return np.where(inside, idx - xs.start * plane, cells), cells


def _fused_unpack_parts(wrapper, spheres, nbands: int, npacked: int):
    """Build the fused unpack+first-stage dispatcher for ``wrapper``.

    Fusion applies when the wrapper runs the "cuda" backend and its plan
    opens with a local line-DFT stage on the trailing (z) dim — the staged
    schedule's d→n pad-fused stage.  That stage is replaced by the
    ``sphere_pack.unpack_dft`` kernel reading packed CSR lanes directly
    (the zero-padded bounding cube is never materialized); the remaining
    stages become a derived *remainder* plan (no second schedule search)
    whose execution keeps the dispatch-count accounting of the composed
    route.  Returns None when the plan shape doesn't allow it — callers
    fall back to ``unpack`` + the full plan.
    """
    from ..kernels import sphere_pack

    p = wrapper.plan
    tin, tout, grid = p.tin, p.tout, wrapper.grid
    if len(tin.dims) != 4 or not p.stages or p.scale != 1.0:
        return None
    st = p.stages[0]
    ex, ey, ez = tin.shape[1:]
    if not (isinstance(st, FFTStage) and st.index == 3 and st.n_in == ez):
        return None
    if realized_backend(st.n_in, st.n_out, wrapper.backend) != "cuda":
        return None
    bdim, xdim, ydim, zdim = tin.dims
    lay = tin.layout
    if lay.get(ydim, ()) or lay.get(zdim, ()):
        return None
    B = tin.shape[0]
    if B != len(spheres) * nbands:
        return None

    dev = grid.device
    # the rank's rows and x planes of the line tables (the reference's
    # P(b, x) split of them): a line's start stays an offset inside its row
    rows, lines, xs = _local_lines(tin)
    start, zlo, cnt, flag = sphere_pack.line_tables(spheres, nbands)
    start, zlo, cnt = (t[rows, lines] for t in (start, zlo, cnt))
    start, zlo, cnt, flag = (torch.as_tensor(np.ascontiguousarray(t),
                                             device=dev)
                             for t in (start, zlo, cnt, flag[xs]))
    _, _, w = dft_matrix_device(st.n_out, st.n_in, st.inverse, dev)
    # the factored mode where the shape takes it, else the dense one with
    # its chunk ranges and split operand
    fo = sphere_pack.factored_for(st.n_in, st.n_out, st.inverse,
                                  start.shape[1], dev)
    chunks = ws = None
    if fo is None:
        chunks = sphere_pack.chunk_ranges(zlo, cnt, flag)
        ws = _split_operand(st, dev)
    mid = DistTensor(tin.domains[:-1]
                     + (Domain((0, 0, 0), (ex - 1, ey - 1, st.n_out - 1)),),
                     tin.dims, tin.layout, grid)
    rem = FftPlan(mid, tout,
                  [pr for pr in p.fft_pairs if pr[0] != st.dim],
                  inverse=p.is_inverse, backend=wrapper.backend,
                  policy=wrapper.policy, _stages=p.stages[1:],
                  _scale=p.scale)

    def fn(packed):
        return sphere_pack.unpack_dft(
            packed.to(torch.complex64).contiguous(), start, zlo, cnt, flag,
            w, chunks=chunks, wsplit=ws, factored=fo)

    private = (start, zlo, cnt, flag) + (() if chunks is None else (chunks,))
    return {"fn": fn, "rem": rem, "in_shape": (tin.local_shape[0], npacked),
            "private": private, "w": w, "wsplit": ws, "factored": fo}


def _fused_pack_parts(wrapper, spheres, nbands: int, npacked: int):
    """Build the fused last-stage+pack dispatcher for ``wrapper``.

    The mirror of :func:`_fused_unpack_parts`: when the plan *closes* with
    a local truncating line-DFT on the trailing dim, a derived *lead* plan
    runs every stage but the last, and ``sphere_pack.dft_pack`` fuses that
    final n→d stage with the CSR gather to ``(rows, npacked)``; padded
    lanes come out exactly +0.0.  With x sharded, the kernel reads the
    rank's x planes with its rows' line tables cut to them, writes +0.0
    to every lane it does not own (``partial=True``), and an all-reduce
    over the axes that split x merges the blocks, as the reference's
    ``psum`` does: each lane is made on exactly one rank, so the sum is
    its value, and padded lanes stay +0.0.
    """
    from ..kernels import sphere_pack

    p = wrapper.plan
    tin, tout, grid = p.tin, p.tout, wrapper.grid
    if len(tout.dims) != 4 or not p.stages or p.scale != 1.0:
        return None
    st = p.stages[-1]
    ex, ey, ez = tout.shape[1:]
    if not (isinstance(st, FFTStage) and st.index == 3 and st.n_out == ez):
        return None
    if realized_backend(st.n_in, st.n_out, wrapper.backend) != "cuda":
        return None
    bdim, xdim, ydim, zdim = tout.dims
    lay = tout.layout
    if lay.get(ydim, ()) or lay.get(zdim, ()):
        return None
    B = tout.shape[0]
    if B != len(spheres) * nbands:
        return None
    partial = any(grid.shape[a] > 1 for a in lay.get(xdim, ()))

    dev = grid.device
    rows, lines, _ = _local_lines(tout)
    start, zlo, cnt, _ = sphere_pack.line_tables(spheres, nbands)
    nvalid = np.repeat(np.asarray([s.npacked for s in spheres], np.int32),
                       nbands)
    start, zlo, cnt = (t[rows, lines] for t in (start, zlo, cnt))
    start, zlo, cnt, nvalid = (torch.as_tensor(np.ascontiguousarray(t),
                                               device=dev)
                               for t in (start, zlo, cnt, nvalid[rows]))
    _, _, w = dft_matrix_device(st.n_out, st.n_in, st.inverse, dev)
    fo = sphere_pack.factored_for(st.n_in, st.n_out, st.inverse,
                                  start.shape[1], dev)
    ws = _split_operand(st, dev) if fo is None else None
    mid = DistTensor(tout.domains[:-1]
                     + (Domain((0, 0, 0), (ex - 1, ey - 1, st.n_in - 1)),),
                     tout.dims, tout.layout, grid)
    lead = FftPlan(tin, mid,
                   [pr for pr in p.fft_pairs if pr[0] != st.dim],
                   inverse=p.is_inverse, backend=wrapper.backend,
                   policy=wrapper.policy, _stages=p.stages[:-1],
                   _scale=1.0)

    def fn(slab):
        # the kernel reads the slab where the lead plan's x stage left it
        out = sphere_pack.dft_pack(slab.to(torch.complex64), start, zlo,
                                   cnt, nvalid, w, npacked, wsplit=ws,
                                   partial=partial, factored=fo)
        return _merge_x_blocks(wrapper, out)

    return {"fn": fn, "lead": lead,
            "out_shape": (tout.local_shape[0], npacked),
            "private": (start, zlo, cnt, nvalid), "w": w, "wsplit": ws,
            "factored": fo, "partial": partial}


def _merge_x_blocks(wrapper, packed):
    """Sum packed lanes over the grid axes that split the sphere side's
    x (each lane was written on one rank, +0.0 on the others)."""
    side = wrapper._sphere_side
    return wrapper.grid.all_reduce(packed, side.layout.get(side.dims[1], ()),
                                   name="pack.all_reduce")


class _FusedTransformMixin:
    """Fused pack/unpack entry points shared by the plane-wave wrappers.

    ``unpack_transform``/``transform_pack`` are the hot-path API: on the
    "cuda" backend they route the trailing-dim line-DFT stage through the
    fused sphere-pack kernels; on every other backend (or when the plan
    shape rules fusion out) they compose the existing ``unpack``/``pack``
    with the full plan — the same result to rounding.  The call's policy
    runs the plan's other stages (the remainder or lead plan), so under a
    lazy policy the kernels still unpack and pack and only those stages
    change executor.  (The reference composes ``unpack``/plan/``pack``
    under a lazy policy; the results agree to rounding.)
    """

    def _fused_in_parts(self):
        memo = self.__dict__.get("_fused_in_memo", "unset")
        if memo == "unset":
            memo = _fused_unpack_parts(self, self._fusion_spheres,
                                       self._fusion_nbands,
                                       self._fusion_npacked)
            self.__dict__["_fused_in_memo"] = memo
        return memo

    def _fused_out_parts(self):
        memo = self.__dict__.get("_fused_out_memo", "unset")
        if memo == "unset":
            memo = _fused_pack_parts(self, self._fusion_spheres,
                                     self._fusion_nbands,
                                     self._fusion_npacked)
            self.__dict__["_fused_out_memo"] = memo
        return memo

    def unpack_transform(self, packed, *, policy: ExecPolicy | None = None):
        """``unpack`` + transform in one go — fused on the "cuda" backend.

        The fused route needs the exact ``(B, npacked)`` hot-path shape;
        anything else takes the composed route.
        """
        pol = self.resolve_policy(policy=policy)
        parts = self._fused_in_parts()
        if parts is None or tuple(packed.shape) != parts["in_shape"]:
            return self(self.unpack(packed), policy=pol)
        from ..kernels import sphere_pack
        sphere_pack.DISPATCHES["unpack_dft"] += 1
        with get_tracer().device_span("fused:unpack_dft", backend="cuda",
                                      npacked=parts["in_shape"][1]) as sp:
            mid = sp.sync(parts["fn"](packed))
        return parts["rem"](mid, policy=pol)

    def transform_pack(self, cube, *, policy: ExecPolicy | None = None):
        """Transform + ``pack`` in one go — fused on the "cuda" backend."""
        pol = self.resolve_policy(policy=policy)
        parts = self._fused_out_parts()
        if parts is None:
            return self.pack(self(cube, policy=pol))
        from ..kernels import sphere_pack
        sphere_pack.DISPATCHES["dft_pack"] += 1
        mid = parts["lead"](cube, policy=pol)
        with get_tracer().device_span("fused:dft_pack", backend="cuda",
                                      npacked=parts["out_shape"][1]) as sp:
            return sp.sync(parts["fn"](mid))

    def local_rows(self, packed):
        """This rank's rows of a replicated ``(B, …)`` packed block (the
        batch dim of the sphere side, split over its grid axes); the block
        itself on one process."""
        rows = self._sphere_side.local_slices()[0]
        if rows == slice(0, packed.shape[0]):
            return packed
        return packed[rows]

    def gather_rows(self, packed):
        """The replicated ``(B, …)`` block from every rank's rows (the
        inverse of :meth:`local_rows`)."""
        side = self._sphere_side
        return self.grid.replicate(packed, side.layout.get(side.dims[0], ()),
                                   name="rows.replicate")

    @property
    def _sphere_side(self) -> DistTensor:
        """The sphere side ``(b, x, y, z)`` of the transform: the input of
        an inverse wrapper, the output of a forward one."""
        return self.tin if self.is_inverse else self.tout

    def _fused_table_bytes(self) -> int:
        tot = 0
        for key in ("_fused_in_memo", "_fused_out_memo"):
            parts = self.__dict__.get(key)
            if isinstance(parts, dict):
                tot += sum(int(t.nbytes) for t in parts["private"])
        return tot


class PlaneWaveFFT(_FusedTransformMixin, Plan):
    """Batched sphere ↔ real-space transform."""

    def __init__(self, sphere: SphereDomain, n: tuple[int, ...],
                 tin: DistTensor, tout: DistTensor, *, inverse: bool,
                 backend: str = "matmul",
                 pairs: list[tuple[str, str]] | None = None,
                 policy: ExecPolicy | None = None,
                 plan: FftPlan | None = None):
        self.sphere = sphere
        self.n = tuple(n)
        self.is_inverse = inverse
        self.backend = backend
        self.tin, self.tout = tin, tout
        self.grid = tin.grid
        self.policy = policy if policy is not None else ExecPolicy()
        if pairs is None:
            # transformed dims default to the trailing three (batch leads)
            pairs = list(zip(tin.dims[-3:], tout.dims[-3:]))
        if plan is None:
            plan = FftPlan(tin, tout, pairs, inverse=inverse,
                           backend=backend, policy=self.policy)
        self.plan = plan
        dev = self.grid.device
        side = self._sphere_side
        # pack tables of the rank's x planes (all of them on one process):
        # the lanes that live there and their flat index in the block
        local, cells = _lane_tables(np.asarray(sphere.pack_indices()), side)
        sel = np.flatnonzero(local < cells)
        split = side.local_shape[1] != side.shape[1]
        self._lane_sel = torch.as_tensor(sel, device=dev) if split else None
        self._pack_idx = torch.as_tensor(local[sel], device=dev)
        self._block = side.local_shape[1:]
        xs = side.local_slices()[1]
        self._mask = torch.as_tensor(sphere.mask()[xs], device=dev)

    # ------------------------------------------------------------- execute
    def _execute(self, x, pol: ExecPolicy):
        return self.plan._execute(x, pol)

    def _execute_traced(self, x, pol: ExecPolicy, tr):
        # wrap the inner plan's (possibly per-stage) spans in one
        # transform-level span tagged with the sphere shape
        with tr.span("planewave", inverse=self.is_inverse,
                     d=self.sphere.extents[0], n=self.n[0]) as sp:
            return sp.sync(self.plan._execute_traced(x, pol, tr))

    @property
    def stages(self):
        return self.plan.stages

    @property
    def dims(self):
        return self.plan.dims

    @property
    def fft_pairs(self):
        return self.plan.fft_pairs

    # ------------------------------------------------------------- mirrors
    def _mirror(self, plan: FftPlan) -> "PlaneWaveFFT":
        return PlaneWaveFFT(self.sphere, self.n, self.tout, self.tin,
                            inverse=not self.is_inverse,
                            backend=self.backend, pairs=plan.fft_pairs,
                            policy=self.policy, plan=plan)

    def _derive_inverse(self) -> "PlaneWaveFFT":
        """Derived mirror transform (no second schedule search): the
        inverse of a staged-pad plan is the staged-truncate plan."""
        return self._mirror(self.plan.inverse())

    def _derive_adjoint(self) -> "PlaneWaveFFT":
        return self._mirror(self.plan.adjoint())

    # ------------------------------------------------- sphere pack/unpack
    def unpack(self, packed):
        """(…, npacked) CSR coefficients → (…, d, d, d) bounding cube (the
        rank's x planes of it)."""
        d = self._block
        flat = torch.zeros(packed.shape[:-1] + (math.prod(d),),
                           dtype=packed.dtype, device=packed.device)
        if self._lane_sel is not None:
            packed = packed[..., self._lane_sel]
        flat[..., self._pack_idx] = packed
        return flat.reshape(packed.shape[:-1] + d)

    def pack(self, cube):
        """(…, d, d, d) bounding cube → (…, npacked) CSR coefficients (the
        rank's x planes, summed over the ranks that split x)."""
        flat = cube.reshape(cube.shape[:-3] + (math.prod(self._block),))
        vals = flat[..., self._pack_idx]
        if self._lane_sel is None:
            return vals
        out = torch.zeros(cube.shape[:-3] + (self.sphere.npacked,),
                          dtype=vals.dtype, device=vals.device)
        out[..., self._lane_sel] = vals
        return _merge_x_blocks(self, out)

    def mask_cube(self, cube):
        """Zero out everything outside the cut-off sphere (cube form)."""
        return cube * self._mask.to(cube.dtype)

    # ------------------------------------------------------- fused kernels
    @property
    def _fusion_spheres(self):
        return [self.sphere]

    @property
    def _fusion_nbands(self) -> int:
        # the whole batch dim rides one sphere
        return int(self.tin.shape[0])

    @property
    def _fusion_npacked(self) -> int:
        return self.sphere.npacked

    # ---------------------------------------------------------- accounting
    def private_bytes(self) -> int:
        """The per-sphere pack index and mask tables — what makes distinct
        spheres expensive cache entries (DFT-matrix operands are shared
        across plans and accounted via ``shared_table_bytes``)."""
        return (int(self._pack_idx.nbytes) + int(self._mask.nbytes)
                + self._fused_table_bytes() + super().private_bytes())

    def describe(self) -> str:
        return ("PlaneWaveFFT sphere d=%d -> grid n=%d\n" %
                (self.sphere.extents[0], self.n[0])) + self.plan.describe()


def kpoint_sphere(diameter: int, kpt=(0.0, 0.0, 0.0)) -> SphereDomain:
    """Cut-off sphere of a k-point: diameter ``d``, center shifted by ``k``.

    The Bloch factor moves the cut-off sphere's *center* to c0 + k (c0 the
    bounding-cube center, k in reduced coordinates), the bounding box stays
    the d³ cube — so every k-shift of one cutoff is batch-compatible (same
    extents, different pack tables).
    """
    d = int(diameter)
    kpt = tuple(float(k) for k in kpt)
    if len(kpt) != 3:
        raise ValueError(f"kpt must have 3 components, got {kpt}")
    c0 = (d - 1) / 2.0
    return SphereDomain(radius=d / 2.0,
                        center=tuple(c0 + k for k in kpt),
                        lower=(0, 0, 0), upper=(d - 1,) * 3)


def planewave_spec(batch_axes: tuple[int, ...] = (),
                   fft_axes: tuple[int, ...] = (0,)) -> str:
    """Arrow spec for the batched sphere↔cube transform on a given grid.

    The batch dim rides ``batch_axes`` (bands — and k-points, when the
    caller stacks them), the transform dims ride ``fft_axes``: x carries
    every fft axis on the sphere side, Z on the cube side, so the staged
    schedule's all-to-alls all run over the fft axes and the batch axes
    never communicate.  ``planewave_spec()`` with no batch axes is the 1D
    layout ``"b x{0} y z -> b X Y Z{0}"``.
    """
    from .dtensor import dims_string
    bspec = {"b": tuple(batch_axes)} if batch_axes else {}
    in_s = dims_string(("b", "x", "y", "z"),
                       {**bspec, "x": tuple(fft_axes)})
    out_s = dims_string(("b", "X", "Y", "Z"),
                        {**bspec, "Z": tuple(fft_axes)})
    return f"{in_s} -> {out_s}"


def cube_spec(fft_axes: tuple[int, ...] = (0,)) -> str:
    """Arrow spec for the unbatched full-cube transform (density fields).

    Only the fft axes appear — on a (batch, fft) 2D grid the cube transform
    is replicated over the batch axes.
    """
    from .dtensor import dims_string
    in_s = dims_string(("x", "y", "z"), {"z": tuple(fft_axes)})
    out_s = dims_string(("X", "Y", "Z"), {"Z": tuple(fft_axes)})
    return f"{in_s} -> {out_s}"


def make_planewave_pair(grid, n: int, sphere: SphereDomain, nb: int, *,
                        backend: str = "matmul",
                        batch_axes: tuple[int, ...] = (),
                        fft_axes: tuple[int, ...] | None = None,
                        policy: ExecPolicy | None = None
                        ) -> tuple[PlaneWaveFFT, PlaneWaveFFT]:
    """(inverse, forward) plane-wave transforms sharing one data layout.

    inverse: sphere bounding-cube (b, x{F}, y, z) → real cube (b, X, Y, Z{F})
    forward: the derived mirror (``inv.inverse()``) — exact adjoint layouts,
    so `forward(inverse(c))` round-trips without extra movement, and the
    pair costs a single schedule search.
    """
    if fft_axes is None:
        fft_axes = tuple(a for a in range(grid.ndim) if a not in batch_axes)
    bdom = Domain((0,), (nb - 1,))
    cube = Domain((0, 0, 0), (n - 1, n - 1, n - 1))
    in_s, out_s = planewave_spec(
        tuple(batch_axes), tuple(fft_axes)).split(" -> ")
    in_i = DistTensor.create((bdom, sphere), in_s, grid)
    out_i = DistTensor.create((bdom, cube), out_s, grid)
    inv = PlaneWaveFFT(sphere, (n, n, n), in_i, out_i, inverse=True,
                       backend=backend, policy=policy)
    return inv, inv.inverse()


# --------------------------------------------------------- ragged k batches
def padded_pack_tables(spheres) -> tuple[np.ndarray, np.ndarray]:
    """Index tables for a ragged batch of spheres sharing one bounding box.

    Every sphere's CSR pack order is padded to ``npacked_max = max_k
    npacked_k``.  The per-k validity mask is baked into the table itself:
    padded lanes carry the *dump-slot* index ``prod(extents)`` — one flat
    cell past the bounding cube — so an unpack scatter routes whatever sits
    in a padded lane into a slot that is dropped, and a pack gather reads
    padded lanes from a slot that is always zero.

    Returns ``(idx, valid)``: ``idx`` is ``(nk, npacked_max)`` int32 flat
    bounding-cube indices (dump slot for padded lanes), ``valid`` the
    matching boolean lane mask.
    """
    spheres = list(spheres)
    if not spheres:
        raise ValueError("padded_pack_tables needs at least one sphere")
    ext = spheres[0].extents
    for s in spheres[1:]:
        if s.extents != ext:
            raise ValueError(
                f"ragged sphere batch must share one bounding box; got "
                f"extents {s.extents} vs {ext}")
    npmax = max(s.npacked for s in spheres)
    dump = math.prod(ext)
    idx = np.full((len(spheres), npmax), dump, np.int32)
    valid = np.zeros((len(spheres), npmax), bool)
    for k, s in enumerate(spheres):
        idx[k, :s.npacked] = s.pack_indices()
        valid[k, :s.npacked] = True
    return idx, valid


def segment_spheres(spheres, max_padding: float = 0.25,
                    size_divisor: int | None = None
                    ) -> tuple[tuple[int, ...], ...]:
    """Partition a ragged sphere batch into similar-``npacked`` segments.

    Spheres are ordered by descending ``npacked`` and greedily grouped so
    every segment's realized padding fraction ``1 − Σ npacked / (len · max
    npacked)`` stays ≤ ``max_padding`` (each segment pads only to its *own*
    maximum).  ``size_divisor`` (> 1) constrains segment sizes to divisors
    of it; a closed run is then emitted as divisor-sized chunks, each
    re-checked against the budget (singletons pad nothing, so the bound
    stays hard).

    Returns a tuple of index tuples: a partition of ``range(len)``,
    descending ``npacked`` within and across segments.
    """
    spheres = list(spheres)
    if not spheres:
        raise ValueError("segment_spheres needs at least one sphere")
    if not 0.0 <= max_padding < 1.0:
        raise ValueError(f"max_padding must be in [0, 1), got {max_padding}")
    sizes = [s.npacked for s in spheres]
    order = sorted(range(len(spheres)), key=lambda i: (-sizes[i], i))
    tol = max_padding + 1e-12

    def pad_of(run: list[int], upto: int) -> float:
        """Padding of run[:upto] padded to its own head's npacked."""
        return 1.0 - (sum(sizes[j] for j in run[:upto])
                      / (upto * sizes[run[0]]))

    segs: list[tuple[int, ...]] = []

    def flush(run: list[int]) -> None:
        while run:
            keep = len(run)
            if size_divisor and size_divisor > 1:
                keep = max(k for k in range(1, len(run) + 1)
                           if size_divisor % k == 0
                           and pad_of(run, k) <= tol)
            segs.append(tuple(run[:keep]))
            run = run[keep:]

    cur: list[int] = []
    for i in order:
        if cur and pad_of(cur + [i], len(cur) + 1) > tol:
            flush(cur)
            cur = []
        cur.append(i)
    if cur:
        flush(cur)
    return tuple(segs)


def segment_padding_fraction(spheres, segment) -> float:
    """Realized padding of one segment: 1 − Σ npacked / (len · max)."""
    sizes = [spheres[i].npacked for i in segment]
    return 1.0 - sum(sizes) / float(len(sizes) * max(sizes))


def sphere_gvectors(sphere) -> np.ndarray:
    """(npacked, 3) G+k offsets from the sphere center, in units 2π/L.

    CSR (pack) order — aligned with the packed coefficient vector.
    """
    ex, ey, ez = sphere.extents
    flat = sphere.pack_indices()
    idx = np.stack([flat // (ey * ez), (flat // ez) % ey,
                    flat % ez], axis=1).astype(np.float64)
    return idx - np.asarray(sphere.center)


def sphere_kinetic_row(sphere, box_length: float) -> np.ndarray:
    """½|G+k|² over the packed coefficients (float32, CSR pack order).

    The one f64→f32 pipeline behind every kinetic ladder — per-k and
    padded-dense alike — so the two agree bitwise on valid lanes.
    """
    g = sphere_gvectors(sphere)
    g2 = (g ** 2).sum(1) * (2 * np.pi / float(box_length)) ** 2
    return 0.5 * g2.astype(np.float32)


def padded_kinetic_table(spheres, box_length: float
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Dense per-k kinetic diagonal over the padded lanes, plus the mask.

    Returns ``(kinetic, valid)``: ``kinetic`` is ``(nk, npacked_max)``
    float32 holding ½|G+k|² per packed coefficient, exactly **zero** on
    padded lanes; ``valid`` is the matching boolean lane mask.  Padded
    lanes therefore contribute exact zeros to every batched reduction.
    """
    spheres = list(spheres)
    _, valid = padded_pack_tables(spheres)      # also checks bounding boxes
    kin = np.zeros(valid.shape, np.float32)
    for k, s in enumerate(spheres):
        kin[k, :s.npacked] = sphere_kinetic_row(s, box_length)
    return kin, valid


class StackedPlaneWaveFFT(_FusedTransformMixin, Plan):
    """One sphere↔cube transform over a ragged batch of k-point spheres.

    All ``nk`` spheres share the d³ bounding box, so their transforms
    differ only in the static pack tables — the staged-padding FFT itself
    can run once with batch ``nk·nbands`` instead of ``nk`` times with
    batch ``nbands``.  Packed coefficients are padded per k to
    ``(nk·nbands, npacked_max)`` with the validity masks baked into the
    pack/unpack tables (see :func:`padded_pack_tables`): padded lanes are
    zeros on the transform side and never read back.

    The inner ``FftPlan`` is the same d³→n³ stacked plan the density build
    uses (pass it via ``plan=`` to share the cached object).
    """

    def __init__(self, spheres, n: tuple[int, ...], nbands: int,
                 tin: DistTensor, tout: DistTensor, *, inverse: bool,
                 backend: str = "matmul",
                 pairs: list[tuple[str, str]] | None = None,
                 policy: ExecPolicy | None = None,
                 plan: FftPlan | None = None):
        self.spheres = list(spheres)
        self.n = tuple(n)
        self.nbands = int(nbands)
        self.is_inverse = inverse
        self.backend = backend
        self.tin, self.tout = tin, tout
        self.grid = tin.grid
        self.policy = policy if policy is not None else ExecPolicy()
        if pairs is None:
            pairs = list(zip(tin.dims[-3:], tout.dims[-3:]))
        if plan is None:
            plan = FftPlan(tin, tout, pairs, inverse=inverse,
                           backend=backend, policy=self.policy)
        self.plan = plan
        dev = self.grid.device
        idx, valid = padded_pack_tables(self.spheres)
        # validity is fully baked into the dump slots of _pad_idx; the
        # host mask is kept for introspection/tests
        self._valid = valid
        self.npacked_max = int(idx.shape[1])
        # the rank's x planes (all of them on one process): a lane outside
        # them goes to the block's dump slot, like a padded lane
        local, cells = _lane_tables(idx, self._sphere_side)
        self._block = self._sphere_side.local_shape[1:]
        self._pad_idx = torch.as_tensor(local.astype(np.int64), device=dev)
        # pack-side gather table: the dump slot is clipped back into the
        # block and masked with the lane's validity there instead
        self._pack_gather_idx = torch.as_tensor(
            np.minimum(local, cells - 1).astype(np.int64), device=dev)
        self._valid_dev = torch.as_tensor(local < cells, device=dev)
        self._rows = self._row_blocks()

    # ------------------------------------------------------------- queries
    @property
    def nk(self) -> int:
        return len(self.spheres)

    @property
    def extents(self) -> tuple[int, ...]:
        return self.spheres[0].extents

    @property
    def padding_fraction(self) -> float:
        """Fraction of the (nk, npacked_max) lanes that are padding."""
        used = sum(s.npacked for s in self.spheres)
        return 1.0 - used / float(self.nk * self.npacked_max)

    def valid_lanes(self) -> np.ndarray:
        """(nk, npacked_max) boolean lane-validity mask (host-side copy)."""
        return self._valid.copy()

    # ------------------------------------------------------------- execute
    def _execute(self, x, pol: ExecPolicy):
        return self.plan._execute(x, pol)

    def _execute_traced(self, x, pol: ExecPolicy, tr):
        with tr.span("stacked_planewave", inverse=self.is_inverse,
                     nk=self.nk, npacked_max=self.npacked_max,
                     padding=round(self.padding_fraction, 4)) as sp:
            return sp.sync(self.plan._execute_traced(x, pol, tr))

    @property
    def stages(self):
        return self.plan.stages

    @property
    def dims(self):
        return self.plan.dims

    @property
    def fft_pairs(self):
        return self.plan.fft_pairs

    # ------------------------------------------------------------- mirrors
    def _mirror(self, plan: FftPlan) -> "StackedPlaneWaveFFT":
        return StackedPlaneWaveFFT(self.spheres, self.n, self.nbands,
                                   self.tout, self.tin,
                                   inverse=not self.is_inverse,
                                   backend=self.backend,
                                   pairs=plan.fft_pairs,
                                   policy=self.policy, plan=plan)

    def _derive_inverse(self) -> "StackedPlaneWaveFFT":
        return self._mirror(self.plan.inverse())

    def _derive_adjoint(self) -> "StackedPlaneWaveFFT":
        return self._mirror(self.plan.adjoint())

    # ----------------------------------------------- ragged stack helpers
    def stack(self, blocks):
        """Per-k ``(nbands, npacked_k)`` blocks → ``(nk·nbands, npacked_max)``.

        Ragged tails are zero-padded — matching the pack/unpack contract
        that padded lanes hold zeros.
        """
        if len(blocks) != self.nk:
            raise ValueError(f"{len(blocks)} blocks for {self.nk} spheres")
        pads = [torch.nn.functional.pad(c, (0, self.npacked_max
                                            - c.shape[-1]))
                for c in blocks]
        return torch.cat(pads, dim=0)

    def split(self, padded):
        """``(nk·nbands, npacked_max)`` → per-k ``(nbands, npacked_k)``."""
        c = padded.reshape(self.nk, self.nbands, self.npacked_max)
        return [c[ik, :, :s.npacked] for ik, s in enumerate(self.spheres)]

    # ------------------------------------------------- sphere pack/unpack
    def _row_blocks(self) -> tuple[int, int, int]:
        """The rank's rows of the stacked batch as ``(k0, kk, nbb)``: kk
        k-blocks of nbb rows each, from sphere k0 on.  The batch splits
        into whole k-blocks, or into parts of one (the basis's stacking
        contract); anything else is refused."""
        rows = self._sphere_side.local_slices()[0]
        r0, nr, nb = rows.start, rows.stop - rows.start, self.nbands
        if r0 % nb == 0 and nr % nb == 0:
            return r0 // nb, nr // nb, nb
        if r0 // nb == (rows.stop - 1) // nb:
            return r0 // nb, 1, nr
        raise ValueError(f"rows [{r0}, {rows.stop}) of this rank straddle "
                         f"k-blocks of {nb} bands")

    def unpack(self, padded):
        """``(rows, npacked_max)`` coefficients → ``(rows, d³)`` (the rank's
        rows and x planes).

        Each k-block scatters through its own pack table; padded lanes (and
        lanes of other ranks' x planes) land in the dump slot and are
        dropped, so garbage there never reaches the bounding cube.
        """
        d = self._block
        cells = math.prod(d)
        k0, kk, nbb = self._rows
        c = padded.reshape(kk, nbb, self.npacked_max)
        flat = torch.zeros((kk, nbb, cells + 1),
                           dtype=padded.dtype, device=padded.device)
        idx = self._pad_idx[k0:k0 + kk, None, :].expand(kk, nbb,
                                                        self.npacked_max)
        flat.scatter_(2, idx, c)
        return flat[..., :cells].reshape((kk * nbb,) + d)

    def pack(self, cube):
        """``(rows, d, d, d)`` cubes → ``(rows, npacked_max)``.

        Padded lanes come out exactly +0.0, whatever the cube holds: the
        gather table clips their dump slot back into the cube and the
        precomputed validity mask zeroes the result.  With x split over
        ranks, each rank's lanes of the other x planes are +0.0 too, and
        the blocks are summed over the axes that split x.
        """
        k0, kk, nbb = self._rows
        flat = cube.reshape(kk, nbb, math.prod(self._block))
        idx = self._pack_gather_idx[k0:k0 + kk, None, :].expand(
            kk, nbb, self.npacked_max)
        out = torch.gather(flat, 2, idx)
        out = torch.where(self._valid_dev[k0:k0 + kk, None, :], out,
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device))
        return _merge_x_blocks(self, out.reshape(kk * nbb,
                                                 self.npacked_max))

    # ------------------------------------------------------- fused kernels
    @property
    def _fusion_spheres(self):
        return self.spheres

    @property
    def _fusion_nbands(self) -> int:
        return self.nbands

    @property
    def _fusion_npacked(self) -> int:
        return self.npacked_max

    # ---------------------------------------------------------- accounting
    def private_bytes(self) -> int:
        """The ragged pack tables are per-sphere-set — never shared."""
        return (int(self._pad_idx.nbytes) + int(self._valid.nbytes)
                + int(self._pack_gather_idx.nbytes)
                + int(self._valid_dev.nbytes)
                + self._fused_table_bytes() + super().private_bytes())

    def describe(self) -> str:
        return ("StackedPlaneWaveFFT %d spheres d=%d -> grid n=%d "
                "(npacked_max=%d, padding %.1f%%)\n" %
                (self.nk, self.extents[0], self.n[0], self.npacked_max,
                 100 * self.padding_fraction)) + self.plan.describe()


def make_stacked_planewave_pair(grid, n: int, spheres, nbands: int, *,
                                backend: str = "matmul",
                                batch_axes: tuple[int, ...] = (),
                                fft_axes: tuple[int, ...] | None = None,
                                policy: ExecPolicy | None = None,
                                plan: FftPlan | None = None
                                ) -> tuple["StackedPlaneWaveFFT",
                                           "StackedPlaneWaveFFT"]:
    """(inverse, forward) ragged-batch stacked pair over nk·nbands orbitals.

    Layouts match :func:`make_planewave_pair` with the batch dim widened to
    ``nk·nbands`` and the sphere side opened to the shared d³ bounding box
    (the raggedness lives in the pack tables, not the plan).  Pass ``plan=``
    to wrap an already-built (cached) d³→n³ inverse ``FftPlan``.
    """
    spheres = list(spheres)
    if fft_axes is None:
        fft_axes = tuple(a for a in range(grid.ndim) if a not in batch_axes)
    nk = len(spheres)
    ext = spheres[0].extents
    if plan is not None:
        tin, tout = plan.tin, plan.tout
    else:
        bdom = Domain((0,), (nk * nbands - 1,))
        bbox = Domain((0, 0, 0), tuple(e - 1 for e in ext))
        cube = Domain((0, 0, 0), (n - 1, n - 1, n - 1))
        in_s, out_s = planewave_spec(
            tuple(batch_axes), tuple(fft_axes)).split(" -> ")
        tin = DistTensor.create((bdom, bbox), in_s, grid)
        tout = DistTensor.create((bdom, cube), out_s, grid)
    inv = StackedPlaneWaveFFT(spheres, (n, n, n), nbands, tin, tout,
                              inverse=True, backend=backend, policy=policy,
                              plan=plan)
    return inv, inv.inverse()
