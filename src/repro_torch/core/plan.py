"""FftPlan — stitches local-compute and data-movement stages (paper Fig. 4).

Given input/output DistTensors and the set of transformed dims, the planner
emits an alternating sequence of

  * ``FFTStage``   — local (possibly rectangular) line DFTs on a dim that the
                     current layout keeps fully local, and
  * ``MoveStage``  — one all-to-all over a single grid axis, moving that
                     axis between two dims (a distributed transpose),

reproducing slab-pencil (1 move on a 1D grid), pencil-pencil-pencil (2 moves
on a 2D grid) and volumetric (3D grid) schedules from the declared
distributions alone.  The schedule search and the mirrors are the
reference's, line for line.  Execution is SPMD, one process per grid point:
each rank runs the same stage list on its local block (``DistTensor``'s
rule), by one of two executors that ``ExecPolicy.mode`` picks: the eager
stage walk (``_raw_apply``) or the lazy split-plane executor
(``_raw_apply_lazy``).  A move is a tiled ``all_to_all_single`` over its
axis' process group; over an axis of size 1 it is the identity.

``Plan`` is the common base of ``FftPlan`` and ``PlaneWaveFFT``: execution
policy resolution, ``tune()``, tracing and the flop/comm accounting shared
by both.  With the tracer on (``repro_torch.obs.get_tracer().enable()``, or
following a running ``torch.profiler``) a plan records a ``plan:`` span and
one span per stage from whichever executor the policy names; a stage that
launches device work is timed on the device, and a span is synchronized
with the card at exit only when the tracer was enabled with ``sync``.
Every plan can *derive* its mirror transforms — ``plan.inverse()`` and
``plan.adjoint()`` reverse the stage list (each stage knows its own mirror)
instead of running a second schedule search.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from functools import cached_property

import torch

from . import layout as L
from .grid import count_collective
from ..obs.metrics import global_metrics
from ..obs.trace import NOOP_SPAN, drain, get_tracer, relayout
from .dtensor import DistTensor
from .hostsync import host_sync
from .local_fft import (LINE_DFTS, LINE_READS, dft_flops, dft_matrix_planes,
                        full_fp32_matmul, local_dft, realized_backend)
from .policy import TUNE_CANDIDATES, ExecPolicy


@dataclasses.dataclass(frozen=True)
class FFTStage:
    dim: str
    index: int                   # position in the logical dim order
    n_in: int
    n_out: int
    inverse: bool
    backend: str

    def apply(self, x):
        return local_dft(x, self.index, self.n_out, inverse=self.inverse,
                         backend=self.backend)

    def mirrored(self) -> "FFTStage":
        """The stage of the derived inverse/adjoint plan.

        A square stage mirrors to its exact inverse (DFT_n ↔ iDFT_n).  A
        rectangular pad-fused stage (d→n) mirrors to the truncating stage
        (n→d) — the identity holds on the retained subspace, which is
        exactly the plane-wave sphere contract.
        """
        return FFTStage(self.dim, self.index, self.n_out, self.n_in,
                        not self.inverse, self.backend)

    @property
    def transform_size(self) -> int:
        """The full DFT length N the (possibly sliced) matrix comes from."""
        return max(self.n_in, self.n_out)

    @property
    def realized_backend(self) -> str:
        """The backend this stage actually runs (``local_dft`` downgrades
        dense backends above the MATMUL_MAX_N crossover) — what flop
        accounting must report."""
        return realized_backend(self.n_in, self.n_out, self.backend)


def _exchange(send, group):
    """The blocks of ``send`` (block index leading) exchanged over
    ``group``: block j to its j-th rank, block i of the result from its
    i-th.  A new tensor, so that a captured step's later graphs read it."""
    import torch.distributed as dist
    recv = torch.empty_like(send)
    count_collective("all-to-all", send)
    real = send.is_complex()
    dist.all_to_all_single(torch.view_as_real(recv) if real else recv,
                           torch.view_as_real(send) if real else send,
                           group=group)
    return recv


def all_to_all(x, group, size: int, split_dim: int, concat_dim: int, *,
               name: str = "all_to_all"):
    """Tiled all-to-all of a local block over one grid axis.

    What ``jax.lax.all_to_all(x, axis, split_axis=split_dim,
    concat_axis=concat_dim, tiled=True)`` does: ``split_dim`` is cut into
    ``size`` blocks, block j goes to the axis' j-th rank, and the blocks
    received are concatenated along ``concat_dim`` in rank order.  Complex
    data travels as its real view.  The exchange is a split point
    ``name`` of a captured step
    (:func:`~repro_torch.core.hostsync.host_sync`); the copies around it
    are device work of the graphs on either side.
    """
    if size == 1:
        return x
    shp = list(x.shape)
    if shp[split_dim] % size:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(shp)} does "
                         f"not split into {size} blocks")
    # blocks of split_dim, block index leading: (size, ..., S/size, ...)
    send = x.reshape(shp[:split_dim] + [size, shp[split_dim] // size]
                     + shp[split_dim + 1:]).movedim(split_dim, 0)
    recv = host_sync(name, _exchange, send.contiguous(), group)
    # received block i (from rank i) lands before concat_dim's extent
    out = recv.movedim(0, concat_dim)
    shp = list(out.shape)
    return out.reshape(shp[:concat_dim] + [size * shp[concat_dim + 1]]
                       + shp[concat_dim + 2:])


@dataclasses.dataclass(frozen=True)
class MoveStage:
    axis_name: str               # grid axis
    axis_size: int
    src: str
    dst: str
    src_index: int
    dst_index: int
    #: the axis' process group (None on one process or an abstract grid)
    group: object = dataclasses.field(default=None, compare=False,
                                      repr=False)

    def apply(self, x, split_dim: int | None = None,
              concat_dim: int | None = None):
        """The distributed transpose on a local block: ``dst`` splits
        over the axis, ``src`` gathers (at the given positions when the
        block's dims are permuted)."""
        return all_to_all(
            x, self.group, self.axis_size,
            self.dst_index if split_dim is None else split_dim,
            self.src_index if concat_dim is None else concat_dim,
            name=f"all_to_all[{self.axis_name}]")

    def mirrored(self) -> "MoveStage":
        """The opposite distributed transpose (all_to_all is a permutation,
        so the mirror is both its inverse and its adjoint)."""
        return MoveStage(self.axis_name, self.axis_size, self.dst, self.src,
                         self.dst_index, self.src_index, self.group)


class Plan:
    """Common protocol + shared accounting of FFTB plans.

    Concrete plans provide ``tin``/``tout``/``grid``/``dims``/``stages`` and
    ``_execute``; the base supplies policy resolution, ``tune()``, and the
    stage-walking flop/comm accounting.
    """

    tin: DistTensor
    tout: DistTensor
    policy: ExecPolicy

    # ----------------------------------------------------------- execution
    def __call__(self, x, *, policy: ExecPolicy | None = None):
        pol = self.resolve_policy(policy=policy)
        if self.grid.is_abstract:
            raise RuntimeError("an abstract (device-less) grid cannot "
                               "execute a plan; build it on ProcGrid.create")
        if pol.check_shapes and tuple(x.shape) != self.tin.local_shape:
            raise ValueError(f"input shape {tuple(x.shape)} != "
                             f"{self.tin.local_shape} (the local block of "
                             f"{self.tin.shape})")
        tr = get_tracer()
        if tr.enabled:
            return self._execute_traced(x, pol, tr)
        return self._execute(x, pol)

    def _execute_traced(self, x, pol: ExecPolicy, tr):
        """Execution with a span around it (device-synchronized)."""
        with tr.span(f"transform:{type(self).__name__}",
                     shape=list(self.tin.shape), mode=pol.mode) as sp:
            return sp.sync(self._execute(x, pol))

    def resolve_policy(self, *,
                       policy: ExecPolicy | None = None) -> ExecPolicy:
        """The call-time policy: an explicit ``policy=`` wins, otherwise
        the plan's default."""
        return policy if policy is not None else self.policy

    def _execute(self, x, pol: ExecPolicy):
        raise NotImplementedError

    def tune(self, x, *, candidates=TUNE_CANDIDATES, warmup: int = 1,
             iters: int = 3) -> ExecPolicy:
        """Time candidate policies on ``x`` and pin the fastest.

        Returns the winning policy (also set as the plan's default, so
        subsequent plain ``plan(x)`` calls use it).  Each candidate's mean
        seconds per call stay in ``plan.tune_seconds`` (legacy mode name →
        seconds), in candidate order.  On a multi-process grid a
        candidate's time is the largest over the grid's ranks (an
        all-reduce), so every rank pins the same policy: the executors
        issue their collectives differently, and ranks that chose apart
        would wait on each other forever.
        """
        best, best_t = None, None
        times = {}
        for cand in candidates:
            pol = dataclasses.replace(
                cand, check_shapes=self.policy.check_shapes)
            for _ in range(warmup):
                drain(self(x, policy=pol))
            t0 = time.perf_counter()
            for _ in range(iters):
                # drain inside the timed window: the clock must stop only
                # after the card finished, or tune() would rank candidates
                # by launch latency
                drain(self(x, policy=pol))
            dt = self.grid.all_reduce_host(
                (time.perf_counter() - t0) / iters, range(self.grid.ndim),
                "max")
            times[pol.legacy_mode] = dt
            if best_t is None or dt < best_t:
                best, best_t = pol, dt
        self.policy = best
        self.tune_seconds = times
        m = global_metrics()
        m.counter("fftb.tunes").inc()
        m.histogram("fftb.tune_best_us").record(best_t * 1e6)
        # memoized mirrors inherited the pre-tune policy — keep the pair
        # in sync, as a freshly derived mirror would be
        for attr in ("_inverse_memo", "_adjoint_memo"):
            memo = getattr(self, attr, None)
            if memo is not None:
                memo.policy = best
        return best

    # ------------------------------------------------------------- mirrors
    def inverse(self) -> "Plan":
        """The mirror transform tout→tin, derived by reversing stages (no
        second schedule search).  Exact inverse for square transforms; for
        rectangular (pad/truncate) stages it is the mirror on the retained
        subspace.

        Memoized, with the mirror back-linked: repeated calls return the
        same object and ``plan.inverse().inverse() is plan``.
        """
        memo = getattr(self, "_inverse_memo", None)
        if memo is None:
            memo = self._derive_inverse()
            memo._inverse_memo = self
            self._inverse_memo = memo
        return memo

    def adjoint(self) -> "Plan":
        """The conjugate-transpose operator tout→tin, same derived stage
        list as ``inverse()`` with the DFT normalization factors flipped
        (adjoint of unnormalized DFT_N is N·iDFT_N).  Memoized and
        back-linked like ``inverse()``."""
        memo = getattr(self, "_adjoint_memo", None)
        if memo is None:
            memo = self._derive_adjoint()
            memo._adjoint_memo = self
            self._adjoint_memo = memo
        return memo

    def _derive_inverse(self) -> "Plan":
        raise NotImplementedError

    def _derive_adjoint(self) -> "Plan":
        raise NotImplementedError

    # ---------------------------------------------------------- accounting
    def private_tables(self, name: str, build) -> dict:
        """Device tables a wrapper keeps on this plan: ``build()``'s dict
        of tensors, built once under ``name`` and counted in
        :meth:`private_bytes`."""
        memo = self.__dict__.setdefault("_private_tables", {})
        if name not in memo:
            memo[name] = build()
        return memo[name]

    def private_bytes(self) -> int:
        """Bytes owned by this plan alone — descriptors, the tables of
        :meth:`private_tables` and (in subclasses) the sphere pack/mask
        or ragged-batch tables.  Never shared with other plans, so the
        cache bills them per entry."""
        extra = self.__dict__.get("_private_tables", {})
        return 4096 + sum(int(t.nbytes) for tables in extra.values()
                          for t in tables.values())

    def shared_table_bytes(self) -> dict[tuple, int]:
        """Device bytes of the ``dft_matrix_device`` operand tables the
        plan's FFT stages reference, keyed by ``(n_out, n_in, inverse)``.

        The tables are memoized process-wide (real, imaginary and sum f32
        planes plus the interleaved complex64 matrix: 20 bytes per entry),
        so two plans with the same key share one device allocation; the
        PlanCache refcounts these keys and charges each table once.
        """
        out: dict[tuple, int] = {}
        for st in self.stages:
            if isinstance(st, FFTStage):
                out.setdefault((st.n_out, st.n_in, st.inverse),
                               20 * st.n_in * st.n_out)
        return out

    def estimated_bytes(self) -> int:
        """Resident bytes this plan pins while cached, considered alone:
        private bytes plus each *distinct* DFT-matrix table it
        references."""
        return self.private_bytes() + sum(self.shared_table_bytes().values())

    def flop_count(self) -> int:
        total = 0
        sizes = {d: n for d, n in zip(self.tin.dims, self.tin.shape)}
        for st in self.stages:
            if isinstance(st, FFTStage):
                batch = math.prod(sizes[d] for d in self.dims if d != st.dim)
                total += dft_flops(st.n_out, st.n_in, batch, st.backend)
                sizes[st.dim] = st.n_out
        return total

    def comm_stats(self, itemsize: int = 8) -> list[dict]:
        """Per-MoveStage communication volume (bytes sent per device)."""
        return self._comm_stats_for(self.stages, itemsize)

    def _comm_stats_for(self, stages, itemsize: int = 8) -> list[dict]:
        out = []
        sizes = {d: n for d, n in zip(self.tin.dims, self.tin.shape)}
        lay = L.normalize(self.tin.layout)
        grid_shape = self.grid.shape
        for st in stages:
            if isinstance(st, FFTStage):
                sizes[st.dim] = st.n_out
                continue
            local_elems = math.prod(
                L.local_size(d, sizes[d], lay, grid_shape)
                for d in self.dims)
            p = st.axis_size
            out.append({
                "axis": st.axis_name, "procs": p,
                "bytes_per_device": local_elems * itemsize * (p - 1) // p,
                "move": f"{st.src}->{st.dst}",
            })
            # replay the move on the tracking layout
            ax = [a for a in range(len(grid_shape))
                  if self.grid.axis_name(a) == st.axis_name][0]
            lay = L.apply_move(lay, L.Move(ax, st.src, st.dst))
        return out

    def describe(self) -> str:
        lines = [f"{type(self).__name__} over {self.grid}: "
                 f"{self.tin.dims} {self.tin.layout} -> "
                 f"{self.tout.dims} {self.tout.layout}"]
        for st in self.stages:
            if isinstance(st, FFTStage):
                kind = "iDFT" if st.inverse else "DFT"
                rb = st.realized_backend
                be = st.backend if rb == st.backend else \
                    f"{st.backend}->{rb}"
                lines.append(f"  {kind}[{st.dim}] {st.n_in}->{st.n_out} "
                             f"({be})")
            else:
                lines.append(f"  a2a[{st.axis_name}] {st.src}->{st.dst}")
        scale = getattr(self, "scale", 1.0)
        if scale != 1.0:
            lines.append(f"  scale ×{scale:g}")
        return "\n".join(lines)


class FftPlan(Plan):
    """A distributed multi-dimensional (batched) FFT."""

    #: process-wide count of schedule searches — lets tests (and the plan
    #: cache) assert that derived/cached plans never re-plan.
    searches = 0

    #: process-wide count of transform dispatches (one per executor
    #: invocation) — instrumentation for "exactly two transforms per
    #: stacked sweep" assertions.
    executions = 0

    def __init__(self, tin: DistTensor, tout: DistTensor,
                 fft_dims: list[tuple[str, str]], *, inverse: bool = False,
                 backend: str = "matmul", policy: ExecPolicy | None = None,
                 _stages: list | None = None, _scale: float = 1.0):
        if tin.grid != tout.grid:
            raise ValueError("input and output tensors live on different "
                             "grids")
        self.tin, self.tout, self.grid = tin, tout, tin.grid
        self.is_inverse, self.backend = inverse, backend
        self.policy = policy if policy is not None else ExecPolicy()
        self.scale = _scale
        self.dims = tin.dims
        self.fft_pairs = list(fft_dims)

        # map output dim names onto input dim names (batch dims by position)
        o2i = {o: i for i, o in fft_dims}
        in_batch = [d for d in tin.dims if d not in {i for i, _ in fft_dims}]
        out_batch = [d for d in tout.dims if d not in o2i]
        if len(in_batch) != len(out_batch):
            raise ValueError("batch dims of input/output do not match")
        o2i.update(dict(zip(out_batch, in_batch)))
        if [o2i[d] for d in tout.dims] != list(tin.dims):
            raise ValueError(
                "output dims must correspond to input dims in order "
                f"(got {tout.dims} vs {tin.dims})")

        self._final_layout = L.normalize(
            {o2i[d]: ax for d, ax in tout.layout.items()})
        if _stages is not None:
            self.stages = list(_stages)     # derived plan: no search
        else:
            self._search()

    # ------------------------------------------------------------ planning
    def _search(self) -> None:
        """Pick the transform order minimizing communicated bytes.

        Rectangular (padding) transforms grow dims, so *when* a dim is
        transposed matters: the paper's staged-padding win is precisely
        scheduling the all-to-all before the moved dims are padded.  The
        planner enumerates transform orders (≤ 3! for 3D), prices each
        schedule with the comm model, and keeps the cheapest — the
        "framework decides on the most suited implementation" behaviour
        of the paper's intermediate block.
        """
        FftPlan.searches += 1
        fft_in = [i for i, _ in self.fft_pairs]
        dim_pos = {d: k for k, d in enumerate(self.dims)}
        innermost = max(fft_in, key=lambda d: dim_pos[d])
        best = None
        for perm in itertools.permutations(fft_in):
            try:
                stages = self._build(list(perm))
            except RuntimeError:
                continue
            cost = sum(s["bytes_per_device"]
                       for s in self._comm_stats_for(stages))
            moves = sum(isinstance(s, MoveStage) for s in stages)
            # comm-equal tie-break: transform the innermost (contiguous)
            # dim first — the paper's canonical z-first order, and the
            # stage the fused sphere-pack kernels can absorb.  Matters on
            # single-device grids where every schedule prices to zero.
            key = (cost, moves, perm.index(innermost))
            if best is None or key < best[0]:
                best = (key, stages)
        if best is None:
            raise RuntimeError("no feasible FFT schedule found")
        self.stages = best[1]

    def _build(self, order: list[str]) -> list:
        grid_shape = self.grid.shape
        sizes = {d: n for d, n in zip(self.tin.dims, self.tin.shape)}
        # n_out per input fft dim
        pair_out = {i: self.tout.dim_size(o) for i, o in self.fft_pairs}
        lay = L.normalize(self.tin.layout)
        stages: list[FFTStage | MoveStage] = []
        done: set[str] = set()
        fft_in_dims = [i for i, _ in self.fft_pairs]
        batch_dims = [d for d in self.dims if d not in fft_in_dims]
        idx = {d: k for k, d in enumerate(self.dims)}

        def emit_move(axis: int, src: str, dst: str):
            stages.append(MoveStage(
                self.grid.axis_name(axis), grid_shape[axis], src, dst,
                idx[src], idx[dst], self.grid.group(axis)))

        def local(d):
            return L.local_size(d, sizes[d], lay, grid_shape)

        def pick_park(d: str, axis: int) -> str:
            """Destination for an axis that must leave fft dim ``d``."""
            cands = [t for t in self.dims if t != d
                     and local(t) % grid_shape[axis] == 0]
            if not cands:
                raise RuntimeError(
                    f"cannot free dim {d}: no dim can absorb grid axis "
                    f"{axis} (layout {lay}, sizes {sizes})")

            def score(t):
                tgt = self._final_layout.get(t, ())
                cur = lay.get(t, ())
                wants = (len(cur) < len(tgt) and tgt[: len(cur)] == cur
                         and tgt[len(cur)] == axis)
                return (
                    0 if wants else 1,                       # final home first
                    0 if (t in done or t in batch_dims) else 1,  # no re-free
                    -local(t),                               # roomiest
                )
            return min(cands, key=score)

        for d in order:
            while lay.get(d, ()):
                axis = lay[d][-1]
                dst = pick_park(d, axis)
                emit_move(axis, d, dst)
                lay = L.apply_move(lay, L.Move(axis, d, dst))
            stages.append(FFTStage(d, idx[d], sizes[d], pair_out[d],
                                   self.is_inverse, self.backend))
            sizes[d] = pair_out[d]
            done.add(d)

        for mv in L.plan_redistribution(lay, self._final_layout, sizes,
                                        grid_shape):
            emit_move(mv.axis, mv.src, mv.dst)
            lay = L.apply_move(lay, mv)
        return stages

    # ------------------------------------------------------------- mirrors
    def _mirror(self, scale: float) -> "FftPlan":
        # stage dim names live in the input-side namespace; the mirrored
        # plan's input is our output, so rename positionally (x → X) or
        # the mirror's accounting would key sizes/layouts by unknown dims
        ren = dict(zip(self.tin.dims, self.tout.dims))
        stages = []
        for st in reversed(self.stages):
            m = st.mirrored()
            if isinstance(m, FFTStage):
                m = dataclasses.replace(m, dim=ren[m.dim])
            else:
                m = dataclasses.replace(m, src=ren[m.src], dst=ren[m.dst])
            stages.append(m)
        pairs = [(o, i) for i, o in self.fft_pairs]
        return FftPlan(self.tout, self.tin, pairs,
                       inverse=not self.is_inverse, backend=self.backend,
                       policy=self.policy, _stages=stages, _scale=scale)

    def _derive_inverse(self) -> "FftPlan":
        return self._mirror(1.0 / self.scale if self.scale != 1.0 else 1.0)

    def _derive_adjoint(self) -> "FftPlan":
        # adjoint of sliced DFT_N is N · sliced iDFT_N (and vice versa):
        # the mirrored stage list times the product of flipped norms.
        scale = self.scale
        for st in self.stages:
            if isinstance(st, FFTStage):
                scale *= (1.0 / st.transform_size if st.inverse
                          else float(st.transform_size))
        return self._mirror(scale)

    # ----------------------------------------------------------- execution
    def _stage_span(self, tr, i: int):
        """Stage ``i``'s span on tracer ``tr`` (the no-op span without
        one), timed on the device where the stage launches work: a line
        DFT, or a move over an axis of several processes."""
        if tr is None:
            return NOOP_SPAN
        st, meta = self.stages[i], self._stage_meta[i]
        span = (tr.device_span if isinstance(st, FFTStage)
                or st.axis_size > 1 else tr.span)
        return span(meta["name"],
                    **{k: v for k, v in meta.items() if k != "name"})

    def _raw_apply(self, x, tr=None):
        """The stages in order, then the scale.  With a tracer ``tr``,
        each stage runs in its own span."""
        for i, st in enumerate(self.stages):
            with self._stage_span(tr, i) as ssp:
                x = ssp.sync(st.apply(x))
        if self.scale != 1.0:
            x = x * self.scale
        return x

    def _raw_apply_lazy(self, x, compute_dtype=torch.float32, tr=None):
        """Lazy-permutation, split-complex executor.

        The eager path pays, per stage, two transposes plus a complex
        interleave/deinterleave around the real GEMMs.  Here (a) each
        stage contracts its axis and the output axis lands at the end (a
        logical permutation undone once, at exit; torch's GEMM reads the
        contracted axis last, so a plane whose axis is not last is copied
        into that order first), and (b) data flows as separate (re, im)
        planes in ``compute_dtype`` from entry to exit, so nothing
        interleaves between stages.  Each complex
        product is Gauss's three real GEMMs with f32 results (for bf16
        operands too); the f32 differences are cast back to
        ``compute_dtype``.  Same stages as the eager walk, same result to
        rounding.  With a tracer ``tr``, each stage runs in its own span,
        as in the eager walk.
        """
        dev = x.device
        perm = list(range(x.ndim))        # perm[i] = logical dim at pos i
        x = x.to(torch.complex64)
        xr = x.real.to(compute_dtype)
        xi = x.imag.to(compute_dtype)
        with full_fp32_matmul(dev):
            for i, st in enumerate(self.stages):
                with self._stage_span(tr, i) as ssp:
                    if not isinstance(st, FFTStage):
                        # the move on each plane, at the dims' current
                        # places
                        sp, cp = perm.index(st.dst_index), perm.index(
                            st.src_index)
                        xr, xi = ssp.sync((st.apply(xr, sp, cp),
                                           st.apply(xi, sp, cp)))
                        continue
                    pos = perm.index(st.index)
                    wr, wi, ws = (w.to(compute_dtype)
                                  for w in dft_matrix_planes(
                                      st.n_out, st.n_in, st.inverse, dev))
                    ar = xr.movedim(pos, -1)
                    ai = xi.movedim(pos, -1)
                    shape = ar.shape[:-1] + (st.n_out,)
                    ar = relayout(ar, st.n_in)
                    ai = relayout(ai, st.n_in)
                    # Gauss 3-multiplication complex product: 3 real GEMMs
                    # instead of 4:
                    #   m1 = xr·wr, m2 = xi·wi, m3 = (xr+xi)·(wr+wi)
                    #   yr = m1 − m2, yi = m3 − m1 − m2
                    m1 = _gemm_f32(ar, wr)
                    m2 = _gemm_f32(ai, wi)
                    m3 = _gemm_f32((ar + ai).to(compute_dtype), ws)
                    xi = m3.sub_(m1).sub_(m2).to(compute_dtype).reshape(
                        shape)
                    xr = ssp.sync(
                        m1.sub_(m2).to(compute_dtype).reshape(shape))
                    perm = [p for j, p in enumerate(perm) if j != pos] \
                        + [st.index]
        out_axes = [perm.index(i) for i in range(len(perm))]
        xr = xr.permute(out_axes).to(torch.float32)
        xi = xi.permute(out_axes).to(torch.float32)
        if self.scale != 1.0:
            xr, xi = xr * self.scale, xi * self.scale
        # the exit permutation, materialized once: the complex result is
        # written in its logical (contiguous) order
        out = torch.empty(xr.shape, dtype=torch.complex64, device=dev)
        return torch.complex(xr, xi, out=out)

    def _check_executable(self) -> None:
        if self.grid.is_abstract:
            raise RuntimeError("an abstract (device-less) grid cannot "
                               "execute a plan; build it on ProcGrid.create")

    def _run(self, x, pol: ExecPolicy, tr=None):
        """The whole stage list by the executor ``pol.mode`` names (with
        one span per stage on tracer ``tr``)."""
        if pol.mode == "lazy":
            return self._raw_apply_lazy(x, pol.torch_compute_dtype(), tr)
        return self._raw_apply(x, tr)

    def _execute(self, x, pol: ExecPolicy, tr=None):
        self._check_executable()
        FftPlan.executions += 1
        if tr is None:
            return self._run(x, pol)
        name = ("ifft" if self.is_inverse else "fft") \
            + f"{len(self.fft_pairs)}d"
        with tr.span(f"plan:{name}", shape=list(self.tin.shape),
                     mode=pol.mode, stages=len(self.stages)) as sp:
            return sp.sync(self._run(x, pol, tr if tr.per_stage else None))

    # -------------------------------------------------- traced execution
    @cached_property
    def _stage_meta(self) -> list[dict]:
        """Span name and attributes of every stage, in order.

        Line-DFT stages are ``idft[z] 8->16`` (kind, realized backend);
        moves are ``a2a[axis] x->z`` with the comm model's
        ``bytes_per_device``/``procs``, so traces hold measured and
        modeled comm side by side.
        """
        comm = iter(self.comm_stats())
        out = []
        for st in self.stages:
            if isinstance(st, FFTStage):
                kind = "idft" if st.inverse else "dft"
                out.append({"name": f"{kind}[{st.dim}] {st.n_in}->"
                                    f"{st.n_out}",
                            "kind": "fft", "backend": st.realized_backend})
            else:
                stats = next(comm)
                out.append({"name": f"a2a[{st.axis_name}] {st.src}->"
                                    f"{st.dst}",
                            "kind": "a2a", "procs": stats["procs"],
                            "model_bytes_per_device":
                                stats["bytes_per_device"]})
        return out

    def _execute_traced(self, x, pol: ExecPolicy, tr):
        return self._execute(x, pol, tr)


def _gemm_f32(a, w):
    """``a @ w.T`` with f32 results: (M, K) by (N, K) → (M, N).

    f32 operands multiply in fp32 (the caller holds
    :func:`~.local_fft.full_fp32_matmul`).  bf16 operands on CUDA take
    cuBLAS's bf16 GEMM with an f32 output (``out_dtype``), so the Gauss
    differences run in f32 as the reference's
    ``preferred_element_type=float32`` asks; on the CPU, which has no such
    GEMM, they are widened to f32 first, which is exact for bf16 values,
    and multiplied in f32.
    """
    if a.dtype == torch.float32:
        return a @ w.T
    if a.is_cuda:
        return torch.mm(a, w.T, out_dtype=torch.float32)
    return a.float() @ w.float().T


global_metrics().register_probe(
    "fftb", lambda: {"executions": FftPlan.executions,
                     "searches": FftPlan.searches,
                     **{f"line_reads_{k}": v
                        for k, v in LINE_READS.items()},
                     **{f"line_dfts_{k}": v
                        for k, v in LINE_DFTS.items()}})
