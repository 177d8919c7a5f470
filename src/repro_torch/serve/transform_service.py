"""Multi-tenant transform service over the shared PlanCache.

The long-lived serving counterpart of the dft SCF loop: many tenants
submit heterogeneous sphere-batch requests — per-request cutoff diameter,
k-shift (both folded into the request's ``SphereDomain``), band count and
optional local potential — and a continuous-batching loop coalesces
compatible requests into single ragged stacked dispatches.

Each request computes the potential-apply round trip

    out = pack( F( v_eff · F⁻¹( unpack(coeffs) ) ) )

(identity round trip when ``v_eff`` is None) — the local part of one
Hamiltonian application, i.e. the transform pair every SCF-style workload
spends its time in.  A dispatch runs the pair through its fused entry
points (``unpack_transform`` / ``transform_pack``): on ``backend="cuda"``
the sphere-pack kernels unpack and pack and every other line-DFT stage of
the plans runs the hand-written ``dft_matmul`` kernel; on the other
backends they compose ``unpack`` → plan → ``pack``.

**Coalescing**: requests whose spheres share a bounding box become *rows*
of one ``StackedPlaneWaveFFT`` (one sphere row per band, ``nbands=1``),
padded to the batch's ``npacked_max`` by the pack tables — so a
mixed-tenant batch is exactly two transforms, like a single big one.  Row
counts are **bucketed** to the next power of two (capped at ``max_rows``,
short rows filled with inert zero-coefficient repeats of the first
sphere), so the inner d³→n³ ``FftPlan`` is shared across every batch
composition of a bucket; only the cheap pack-table wrapper is
per-composition.  Both layers live in the (by default process-global)
``PlanCache``: the wrapper entries churn through byte-weighted eviction,
the inner plans are the hot shared state, and concurrent tenants exercise
the cache's build-race semantics for real.

**Admission control** keeps cold builds off the latency path: a batch
whose ``(compat, bucket)`` plans are not yet warm is requeued at the
queue fronts while a background thread builds the pair and runs it once
on a zero round trip (building the kernels on first use); the batch
dispatches on a later step, warm.  (``warm_async=False`` builds inline
instead — first dispatch pays.)

**Several processes.**  On a ``ProcGrid`` of several ``torch.distributed``
processes the service runs one instance per rank, and rank
``grid.ranks[0]`` is its *front end*: requests are submitted there, its
scheduler decides alone (deadlines, batches, warming) and sends each
decision to the other ranks, the *followers*, which run in lockstep
(``run_until_idle``, ``start``/``stop`` on a follower follow the front
end until its idle or stop message).  Each rank runs the pair on its own
rows of the batch (the batch axes) and its own x planes and z-block (the
fft axes); the front end sends each follower only its rows of the
coefficients and the z-blocks of the potentials those rows use, as host
arrays, point to point.  The packed rows are summed over the fft axes
(the pack's all-reduce) and gathered over the batch axes, and the
handles resolve on the front end.  Three hazards of several ranks shape
this:

* decisions that read the clock (deadlines) or a thread (warming) are
  made on the front end only: ranks deciding alone would diverge, and a
  rank would wait forever in a collective the others never enter;
* a cold batch is warmed on the dispatch thread of every rank, at the
  step the front end chooses, never on a warming thread: the warm run's
  collectives would interleave with the dispatch thread's in another
  order on each rank (``warm_async=True`` still requeues the batch, so
  nothing blocks the submitter);
* a failure is never swallowed: every rank prepares its part of a
  dispatch (plans, uploads) and the ranks agree it worked before any
  collective; otherwise the batch's handles fail on the front end and
  every rank stops with an error.

The coefficient buffer and the potential are assembled on the service's
device; results resolve as host numpy arrays, so a handle's completion is
a real completion of the device work.

Robustness is the scheduler's: round-robin tenant fairness, queue-depth
backpressure (``QueueFull``), per-request deadlines resolved as
``DeadlineExceeded`` errors.  ``ServiceMetrics`` records what happened.
"""
from __future__ import annotations

import dataclasses
import pickle
import threading
import time

import numpy as np
import torch

from ..check.diagnostics import raise_if_errors
from ..check.locks import TrackedLock, check_dispatch_hazard
from ..check.preflight import preflight_request, preflight_service
from ..core import (Domain, fftb, global_plan_cache,
                    make_stacked_planewave_pair, planewave_spec)
from ..core.cache import domains_key, grid_key
from ..core.domain import SphereDomain
from ..core.policy import ExecPolicy
from ..obs.metrics import global_metrics, register_weak_probe
from ..obs.trace import get_tracer
from .metrics import ServiceMetrics
from .scheduler import (CoalescingScheduler, DeadlineExceeded, QueueFull,
                        ServeError, ServiceStopped, TransformHandle,
                        TransformRequest, compat_key)

__all__ = ["TransformService", "TransformRequest", "TransformHandle",
           "DeadlineExceeded", "QueueFull", "ServiceStopped", "ServeError"]


def _next_pow2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


def _host(a) -> np.ndarray:
    """A numpy array or a tensor on any device, as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _sphere_spec(s: SphereDomain) -> tuple:
    """What rebuilds ``s`` on another rank (``SphereDomain(*spec)``)."""
    return (s.radius, s.center, s.lower, s.upper)


def _row_block(reqs, rows: slice, width: int, zeros, put):
    """Rows ``rows`` of a batch's ``(bucket, width)`` coefficient buffer:
    each request's bands in turn, zero-padded lanes and inert rows.
    ``zeros(shape)`` makes the block, ``put(a)`` converts a request's
    coefficients for it."""
    buf = zeros((rows.stop - rows.start, width))
    r0 = 0
    for r in reqs:
        lo, hi = max(r0, rows.start), min(r0 + r.nbands, rows.stop)
        if lo < hi:
            buf[lo - rows.start:hi - rows.start, :r.sphere.npacked] = put(
                r.coeffs[lo - r0:hi - r0])
        r0 += r.nbands
    return buf


def _potential_rows(reqs, rows: slice):
    """For the batch rows ``rows``: each row's index among the distinct
    potentials its requests use (-1: none), and those potentials."""
    pots: list = []
    seen: dict[int, int] = {}
    index = [-1] * (rows.stop - rows.start)
    r0 = 0
    for r in reqs:
        if r.v_eff is not None:
            for row in range(max(r0, rows.start),
                             min(r0 + r.nbands, rows.stop)):
                if id(r.v_eff) not in seen:
                    seen[id(r.v_eff)] = len(pots)
                    pots.append(r.v_eff)
                index[row - rows.start] = seen[id(r.v_eff)]
        r0 += r.nbands
    return index, pots


def _rank_slices(inv, coord=None) -> tuple[slice, slice]:
    """The batch rows and the cube's z-block of the rank at grid
    coordinate ``coord`` (this rank when None) for the pair ``inv``."""
    tin, tout = inv.tin, inv.tout
    if coord is not None:
        g = dataclasses.replace(inv.grid, coordinate=coord)
        tin = dataclasses.replace(tin, grid=g)
        tout = dataclasses.replace(tout, grid=g)
    return tin.local_slices()[0], tout.local_slices()[-1]


class TransformService:
    """Continuous-batching sphere-transform server on one process grid.

    One service instance serves one ``ProcGrid`` (and its device) and one
    FFT cube width ``n``; requests vary freely in sphere (cutoff/k-shift),
    band count, potential and deadline.  Drive it synchronously
    (``submit`` + ``run_until_idle``) or as a background loop
    (``start``/``stop``).  On a grid of several processes every rank
    builds the service with the same arguments; see the module docstring
    for the front end and its followers.
    """

    def __init__(self, grid, n: int, *, padding_budget: float = 0.5,
                 max_rows: int = 8, max_queue_per_tenant: int = 64,
                 backend: str = "matmul",
                 batch_axes: tuple[int, ...] = (),
                 fft_axes: tuple[int, ...] | None = None,
                 policy: ExecPolicy | None = None, cache=None,
                 coalesce: bool = True, warm_async: bool = True):
        self.grid = grid
        self.device = grid.device
        self.n = int(n)
        self.backend = backend
        self.batch_axes = tuple(batch_axes)
        if fft_axes is None:
            fft_axes = tuple(a for a in range(grid.ndim)
                             if a not in self.batch_axes)
        self.fft_axes = tuple(fft_axes)
        self.policy = policy
        self.fft_procs = 1
        for a in self.fft_axes:
            self.fft_procs *= grid.axis_size(a)
        self.batch_procs = 1
        for a in self.batch_axes:
            self.batch_procs *= grid.axis_size(a)
        # coded preflight diagnostics (FFTB110/113/117/122); a
        # DiagnosticError is a ValueError
        raise_if_errors(preflight_service(
            self.n, grid=grid, batch_axes=self.batch_axes,
            fft_axes=self.fft_axes, max_rows=max_rows,
            padding_budget=padding_budget))
        self.coalesce = bool(coalesce)
        self.warm_async = bool(warm_async)
        self.max_rows = int(max_rows)
        self.cache = cache if cache is not None else global_plan_cache()
        self._pw_spec = planewave_spec(self.batch_axes, self.fft_axes)
        self.scheduler = CoalescingScheduler(
            padding_budget=padding_budget,
            max_rows=max_rows if self.coalesce else 1,
            max_queue_per_tenant=max_queue_per_tenant)
        self.metrics = ServiceMetrics(self.cache)
        # snapshots read the live summary through a weak probe — the
        # registry never keeps a dead service alive
        register_weak_probe(global_metrics(), "serve", self.metrics)
        self._warmed: set = set()
        self._inflight: set = set()
        self._warm_lock = TrackedLock("serve.warm")
        self._stopped = False
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        # several processes: the front end's global rank, and on the
        # front end each follower's global rank and grid coordinate
        self.front = None
        self.is_front = True
        self._followers: dict[int, tuple[int, ...]] = {}
        #: the failure that stopped a service on several processes
        self.error: BaseException | None = None
        self._spheres: dict[tuple, SphereDomain] = {}
        if grid.multi_process:
            import torch.distributed as dist
            self.front = grid.ranks[0]
            self.is_front = dist.get_rank() == self.front
            if self.is_front:
                self._followers = {
                    r: tuple(int(c) for c in np.unravel_index(i, grid.shape))
                    for i, r in enumerate(grid.ranks) if i}

    # ------------------------------------------------------------- submit
    def submit(self, tenant: str, coeffs, sphere: SphereDomain, *,
               v_eff=None, deadline: float | None = None
               ) -> TransformHandle:
        """Enqueue one request; returns a handle to block on.

        ``coeffs``: ``(nbands, sphere.npacked)`` complex, numpy or torch;
        ``v_eff``: ``(n, n, n)`` real or None; ``deadline`` is *relative*
        seconds from now (``None`` = no deadline).  Raises
        :class:`QueueFull` past the tenant's depth cap and
        :class:`ServiceStopped` after :meth:`stop`; on several processes
        only the front end takes requests.
        """
        if not self.is_front:
            raise ServeError(f"submit on the front end (rank {self.front}):"
                             " the other ranks follow its decisions")
        if self._stopped:
            raise ServiceStopped("service is stopped")
        abs_deadline = (None if deadline is None
                        else time.perf_counter() + float(deadline))
        req = TransformRequest(tenant=tenant, coeffs=coeffs, sphere=sphere,
                               n=self.n, v_eff=v_eff, deadline=abs_deadline)
        # FFTB111 (unshardable extents) / FFTB122 (bands > max_rows)
        raise_if_errors(preflight_request(
            sphere, n=self.n, fft_procs=self.fft_procs,
            max_rows=self.max_rows, nbands=req.nbands))
        handle = self.scheduler.submit(req)
        self._wake.set()
        return handle

    def bucket_for(self, rows: int) -> int:
        """Bucketed row count: the next power of two, rounded up to a
        multiple of the batch axes' process count (so the rows split over
        them), capped at ``max_rows``."""
        b = _next_pow2(max(int(rows), 1))
        b = -(-b // self.batch_procs) * self.batch_procs
        return min(b, self.max_rows)

    # -------------------------------------------------------------- plans
    def _inner_plan(self, sphere: SphereDomain, bucket: int):
        """The shared d³→n³ inverse ``FftPlan`` of a ``(compat, bucket)``.

        Served through ``fftb.plan_for``'s own cache key — every batch
        composition of the same bucket hits this one plan; the
        per-composition state is only the wrapper below.
        """
        bdom = Domain((0,), (bucket - 1,))
        bbox = Domain((0, 0, 0), tuple(e - 1 for e in sphere.extents))
        return fftb.plan_for(self._pw_spec, domains=(bdom, bbox),
                             grid=self.grid, sizes=(self.n,) * 3,
                             inverse=True, backend=self.backend,
                             policy=self.policy, cache=self.cache)

    def _pair_for(self, spheres: tuple, bucket: int):
        """(inverse, forward) stacked pair for one row composition.

        One sphere per row, ``nbands=1``.  The wrapper (pack tables) is
        cached per composition; the inner plan is shared per bucket.
        """
        key = ("serve-stacked", self._pw_spec, domains_key(spheres),
               bucket, grid_key(self.grid), (self.n,) * 3, self.backend,
               self.policy)
        inv = self.cache.get_or_build(
            key, lambda: make_stacked_planewave_pair(
                self.grid, self.n, list(spheres), 1, backend=self.backend,
                batch_axes=self.batch_axes, fft_axes=self.fft_axes,
                policy=self.policy,
                plan=self._inner_plan(spheres[0], bucket))[0])
        return inv, inv.inverse()

    # ---------------------------------------------------- admission control
    def _ensure_warm(self, batch) -> bool:
        """True when the batch's plans are warm enough to dispatch now.

        Cold + ``warm_async``: kick one background build per
        ``(compat, bucket)`` and report False — the caller requeues the
        batch, keeping the build off the latency path.  Cold without
        ``warm_async``: build inline and report True.  On several
        processes the build runs here, on the dispatch thread of every
        rank (see the module docstring), and ``warm_async`` only decides
        whether the batch waits for the next step.
        """
        seed = batch[0].request
        rows = sum(h.request.nbands for h in batch)
        wk = (seed.compat, self.bucket_for(rows))
        if wk in self._warmed:
            return True
        if self._followers:
            self._send({r: ("warm", _sphere_spec(seed.sphere), wk[1])
                        for r in self._followers})
            self._warm_build(seed.sphere, wk)
            return not self.warm_async
        if not self.warm_async:
            self._warm_build(seed.sphere, wk)
            return True
        with self._warm_lock:
            if wk in self._warmed:
                return True
            if wk not in self._inflight:
                self._inflight.add(wk)
                threading.Thread(target=self._warm_build,
                                 args=(seed.sphere, wk),
                                 daemon=True).start()
        return False

    def _warm_build(self, sphere: SphereDomain, wk) -> None:
        """Build the bucket's pair and run it once on a zero input.

        Runs on the warm thread too: every tensor names the service's
        device explicitly, never a thread's current device.
        """
        _, bucket = wk

        def zeros():
            inv, fwd = self._pair_for((sphere,) * bucket, bucket)
            rows, _ = _rank_slices(inv)
            return inv, fwd, torch.zeros(
                (rows.stop - rows.start, inv.npacked_max),
                dtype=torch.complex64, device=self.device), None
        try:
            self._run_pair(zeros).cpu()
        finally:
            with self._warm_lock:
                self._warmed.add(wk)
                self._inflight.discard(wk)
            self._wake.set()

    def warm(self, sphere: SphereDomain, nbands: int = 1) -> None:
        """Pre-warm the plans a ``(sphere, nbands)`` request would use.

        On several processes only the front end warms, with its followers
        following, and only while its loop is not running (``start``): the
        warm run's collectives would interleave with the loop's in another
        order on each rank.  A failure stops every rank, as a failed
        dispatch does."""
        if self.grid.multi_process:
            if not self.is_front:
                raise ServeError(f"warm on the front end (rank "
                                 f"{self.front}): the other ranks follow it")
            if self._stopped:
                raise ServiceStopped("service is stopped")
            if self._thread is not None:
                raise ServeError("warm() while the loop runs: on several "
                                 "processes warm before start() (or let "
                                 "the loop warm each batch)")
        wk = (compat_key(sphere, self.n), self.bucket_for(nbands))
        try:
            if self._followers:
                self._send({r: ("warm", _sphere_spec(sphere), wk[1])
                            for r in self._followers})
            self._warm_build(sphere, wk)
        except Exception as err:
            if self._followers:
                self._fail_stop(err)
            raise

    # ------------------------------------------------------------ dispatch
    def step(self) -> int:
        """One scheduler turn: expire deadlines, dispatch ≤ one batch.

        Returns the number of requests *resolved* this step (results or
        deadline errors); 0 means idle or stalled on a warming plan.  On
        several processes this is the front end's turn (a follower
        follows with ``run_until_idle``, ``start`` or ``stop``).
        """
        if not self.is_front:
            raise ServeError("step() on a follower: the front end steps, "
                             "the followers follow it")
        tr = get_tracer()
        resolved = 0
        for _h in self.scheduler.expire():
            self.metrics.record_error("deadline")
            resolved += 1
        t0 = time.perf_counter()
        batch = self.scheduler.next_batch()
        if not batch:
            return resolved
        # only non-empty batches get a coalesce event — idle polls would
        # flood the trace with zero-length noise
        tr.event("serve.coalesce", t0, time.perf_counter(),
                 requests=len(batch),
                 rows=sum(h.request.nbands for h in batch))
        try:
            warm = self._ensure_warm(batch)
            if warm:
                self._dispatch(batch)
        except Exception as err:   # fail the batch, never hang waiters
            for h in batch:
                h._fail(ServeError(f"dispatch failed: {err!r}"))
            self.metrics.record_error("dispatch")
            if self._followers:
                self._fail_stop(err)
            raise
        if not warm:
            self.scheduler.requeue_front(batch)
            return resolved
        return resolved + len(batch)

    def _device_tensor(self, a, dtype):
        return torch.as_tensor(a, device=self.device).to(dtype)

    def _dispatch(self, batch) -> None:
        check_dispatch_hazard("serve.dispatch")
        tr = get_tracer()
        now = time.perf_counter()
        for h in batch:
            h.dispatched_at = now
        reqs = [h.request for h in batch]
        rows = sum(r.nbands for r in reqs)
        bucket = self.bucket_for(rows)
        padding = CoalescingScheduler.batch_padding(batch)
        with tr.span("serve.dispatch", requests=len(reqs), rows=rows,
                     bucket=bucket, padding=round(padding, 4)):
            spheres: list = []
            for r in reqs:
                spheres.extend([r.sphere] * r.nbands)
            spheres.extend([spheres[0]] * (bucket - rows))  # inert rows
            inv, fwd = self._pair_for(tuple(spheres), bucket)
            parts = {r: self._follower_part(inv, reqs, spheres, c)
                     for r, c in self._followers.items()}
            if parts:
                with tr.span("serve.send", bytes=sum(
                        p[-1] for p in parts.values())):
                    self._send({r: p[:-1] for r, p in parts.items()})

            def upload():
                # one child span per piece (the plans record their own);
                # with the tracer's sync on, each covers its device work
                mine, zs = _rank_slices(inv)
                with tr.device_span("serve.upload_coeffs") as sp:
                    buf = sp.sync(_row_block(
                        reqs, mine, inv.npacked_max,
                        lambda s: torch.zeros(s, dtype=torch.complex64,
                                              device=self.device),
                        lambda a: self._device_tensor(a, torch.complex64)))
                index, pots = _potential_rows(reqs, mine)
                return inv, fwd, buf, self._potential_block(index, [
                    p[..., zs] for p in pots], zs)

            packed = self._run_pair(upload)
            # the host copy waits for the device: the span end is an
            # honest completion time without an extra sync
            with tr.device_span("serve.download"):
                out = packed.cpu().numpy()

        self.metrics.record_dispatch(len(reqs), rows, padding)
        r0 = 0
        for h, r in zip(batch, reqs):
            h._resolve(out[r0:r0 + r.nbands, :r.sphere.npacked].copy())
            r0 += r.nbands
            self.metrics.record_request(
                r.tenant, h.latency, r.nbands,
                queue_wait_s=h.queue_wait)
            tr.event("serve.request", h.submitted_at, h.completed_at,
                     tenant=r.tenant, rid=r.rid, nbands=r.nbands,
                     queue_wait_ms=round(h.queue_wait * 1e3, 3))

    def _follower_part(self, inv, reqs, spheres, coord) -> tuple:
        """The dispatch message for the follower at ``coord``: the batch's
        spheres (each distinct one once, by index per row), its rows of
        the coefficients, the z-blocks of the potentials its rows use and
        their row index; last, the bytes of those arrays."""
        rows, zs = _rank_slices(inv, coord)
        specs: dict[tuple, int] = {}
        row_sphere = [specs.setdefault(_sphere_spec(s), len(specs))
                      for s in spheres]
        buf = _row_block(reqs, rows, inv.npacked_max,
                         lambda s: np.zeros(s, np.complex64),
                         lambda a: _host(a).astype(np.complex64))
        index, pots = _potential_rows(reqs, rows)
        blocks = [np.ascontiguousarray(_host(p)[..., zs], np.float32)
                  for p in pots]
        return ("dispatch", list(specs), row_sphere, len(spheres), buf,
                index, blocks, buf.nbytes + sum(b.nbytes for b in blocks))

    def _potential_block(self, index, blocks, zs):
        """The potential of this rank's rows on the device: each row's
        z-block (``blocks[index[row]]``), ones for a row without one;
        None when no row has one."""
        if not blocks:
            return None
        with get_tracer().device_span("serve.upload_potential") as sp:
            v = torch.ones((len(index), self.n, self.n,
                            zs.stop - zs.start),
                           dtype=torch.float32, device=self.device)
            for k, blk in enumerate(blocks):
                sel = [i for i, j in enumerate(index) if j == k]
                v[sel] = self._device_tensor(blk, torch.float32)
            return sp.sync(v)

    def _run_pair(self, prepare):
        """The transform pair on this rank's part of a batch; the packed
        ``(bucket, npacked_max)`` result (every rank's rows).

        ``prepare()`` returns the pair ``(inv, fwd)``, this rank's
        coefficient rows and its potential block (or None).  On several
        processes the ranks first agree that every one prepared its part:
        the collectives follow only then, so a rank that failed stops
        every rank instead of leaving them in a collective.
        """
        tr = get_tracer()
        try:
            inv, fwd, rows, v = prepare()
            failed = None
        except Exception as err:
            failed = err
        if self.grid.multi_process:
            ok = self.grid.all_reduce_host(float(failed is None),
                                           range(self.grid.ndim), "min")
            if failed is None and not ok:
                raise ServeError("another rank failed to prepare its part "
                                 "of the dispatch")
        if failed is not None:
            raise failed
        with tr.span("serve.unpack_transform") as sp:
            psi = sp.sync(inv.unpack_transform(rows))
        if v is not None:
            with tr.device_span("serve.times_v") as sp:
                psi = sp.sync(psi * v)
        with tr.span("serve.transform_pack") as sp:
            packed = sp.sync(fwd.transform_pack(psi))
        if self.grid.multi_process:
            with tr.device_span("serve.gather_rows") as sp:
                packed = sp.sync(fwd.gather_rows(packed))
        return packed

    # ----------------------------------------------------- several ranks
    def _send(self, messages: dict) -> None:
        """Send each follower its message (``{rank: object}``), all at
        once, point to point over the default process group; returns when
        every follower has received its own."""
        import torch.distributed as dist
        works = []
        for rank, obj in messages.items():
            data = torch.frombuffer(bytearray(pickle.dumps(
                obj, protocol=pickle.HIGHEST_PROTOCOL)), dtype=torch.uint8)
            size = torch.tensor([data.numel()], dtype=torch.int64)
            works += [dist.isend(size, rank), dist.isend(data, rank)]
        for w in works:
            w.wait()

    def _receive(self):
        """The front end's next message to this follower."""
        import torch.distributed as dist
        size = torch.empty(1, dtype=torch.int64)
        dist.recv(size, self.front)
        data = torch.empty(int(size[0]), dtype=torch.uint8)
        dist.recv(data, self.front)
        return pickle.loads(data.numpy().tobytes())

    def _sphere(self, spec) -> SphereDomain:
        s = self._spheres.get(spec)
        if s is None:
            s = self._spheres[spec] = SphereDomain(*spec)
        return s

    def _follow(self, *, until_idle: bool) -> int:
        """Run the front end's decisions on this follower until its stop
        message (or its idle message, with ``until_idle``); the number of
        dispatches run.  A dispatch or warm-up runs exactly as on the
        front end, on this rank's part."""
        done = 0
        while True:
            msg = self._receive()
            op = msg[0]
            if op == "stop":
                self._stopped = True
                return done
            if op == "idle":
                if until_idle:
                    return done
            elif op == "error":
                self._stopped = True
                raise ServeError(f"the service failed on the front end: "
                                 f"{msg[1]}")
            else:
                try:
                    self._follow_one(msg)
                except Exception as err:
                    # the ranks agreed that the step failed before its
                    # collectives: the front end's error message follows
                    self._stopped = True
                    nxt = self._receive()
                    if nxt[0] != "error":
                        raise ServeError(f"this rank failed alone: "
                                         f"{err!r}") from err
                    raise ServeError(
                        f"the service failed on the front end: {nxt[1]}; "
                        f"on this rank: {err!r}") from err
                if op == "dispatch":
                    done += 1

    def _follow_one(self, msg) -> None:
        """One warm-up or dispatch message, run on this follower's part."""
        if msg[0] == "warm":
            sphere = self._sphere(msg[1])
            self._warm_build(sphere, (compat_key(sphere, self.n), msg[2]))
        else:
            self._run_pair(lambda: self._follower_upload(*msg[1:]))

    def _follower_upload(self, specs, row_sphere, bucket, buf, index,
                         blocks):
        """A follower's part of a dispatch (:meth:`_follower_part`'s
        message): the batch's pair, its rows and potential on the
        device."""
        inv, fwd = self._pair_for(
            tuple(self._sphere(specs[i]) for i in row_sphere), bucket)
        _, zs = _rank_slices(inv)
        with get_tracer().device_span("serve.upload_coeffs") as sp:
            rows = sp.sync(self._device_tensor(buf, torch.complex64))
        return inv, fwd, rows, self._potential_block(index, blocks, zs)

    def _fail_stop(self, err: BaseException) -> None:
        """The front end of a service on several processes after a failed
        step: every queued request fails, the service stops, and every
        follower gets the error message in place of a stop.  Wherever the
        step failed, each follower is then waiting for a message: in
        ``_receive`` when its part ran (or never started), or, when the
        ranks agreed that a part failed, for this error (``_follow``)."""
        self.error = err
        self._stopped = True
        followers, self._followers = self._followers, {}
        for _ in self.scheduler.fail_all(ServiceStopped(
                f"service stopped after a failed dispatch: {err!r}")):
            self.metrics.record_error("stopped")
        self._send({r: ("error", repr(err)) for r in followers})

    # ------------------------------------------------------- eager oracle
    def eager_apply(self, coeffs, sphere: SphereDomain, v_eff=None
                    ) -> np.ndarray:
        """Per-request dispatch, no coalescing — the correctness oracle.

        Same math as one dispatched request (cached per-sphere
        ``PlaneWaveFFT`` pair, batch = the request's own bands), through
        the composed ``unpack`` → plan → ``pack`` route; the coalesced
        path matches it to fp32 rounding.  On several processes every rank
        calls it with the same arguments (a collective of the grid, made
        while the service is not serving): each transforms its rows and
        z-block, and every rank gets the whole result.  The bands are
        padded with zero rows to a multiple of the batch axes' process
        count.
        """
        c = self._device_tensor(coeffs, torch.complex64)
        nb = c.shape[0]
        pad = -nb % self.batch_procs
        if pad:
            c = torch.cat([c, c.new_zeros((pad, c.shape[1]))])
        bdom = Domain((0,), (nb + pad - 1,))
        inv = fftb.plan_for(self._pw_spec, domains=(bdom, sphere),
                            grid=self.grid, sizes=(self.n,) * 3,
                            inverse=True, backend=self.backend,
                            policy=self.policy, cache=self.cache)
        fwd = inv.inverse()
        psi = inv(inv.unpack(inv.local_rows(c)))
        if v_eff is not None:
            _, zs = _rank_slices(inv)
            psi = psi * self._device_tensor(v_eff, torch.float32)[..., zs]
        out = inv.gather_rows(inv.pack(fwd(psi)))
        return out[:nb].cpu().numpy()

    # ----------------------------------------------------------- lifecycle
    def run_until_idle(self, timeout: float = 60.0) -> int:
        """Step until every queued request is resolved; returns count.

        On several processes the front end then sends its followers an
        idle message: a follower's ``run_until_idle`` follows the front
        end until that message (or its stop), with no timeout of its own.
        """
        if not self.is_front:
            return self._follow(until_idle=True)
        t0 = time.perf_counter()
        total = 0
        while len(self.scheduler):
            if time.perf_counter() - t0 > timeout:
                raise TimeoutError(
                    f"{len(self.scheduler)} requests still queued after "
                    f"{timeout}s")
            n = self.step()
            total += n
            if n == 0 and len(self.scheduler):
                # stalled on a warming plan (or racing submitters):
                # wait for a wake signal rather than spinning
                self._wake.wait(0.005)
                self._wake.clear()
        if self._followers:
            self._send({r: ("idle",) for r in self._followers})
        return total

    def start(self) -> None:
        """Run the dispatch loop on a background thread (until ``stop``);
        on a follower, follow the front end there until its stop."""
        if self._thread is not None:
            return
        if self.grid.multi_process and self._stopped:
            # its followers have stopped: the loop would dispatch alone
            raise ServiceStopped("service is stopped")
        self._stopped = False

        def loop():
            while not self._stopped:
                try:
                    n = self.step()
                except Exception:
                    if self.error is not None:
                        return     # several processes: every rank stops
                    continue       # one process: batch failed; serve on
                if n == 0:
                    self._wake.wait(0.005)
                    self._wake.clear()

        def follow():
            try:
                self._follow(until_idle=False)
            except Exception as err:   # stop() raises it
                self.error = err

        self._thread = threading.Thread(
            target=loop if self.is_front else follow, daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop serving; pending requests drain (default) or fail.

        With ``drain=False`` every queued request resolves immediately
        with :class:`ServiceStopped` — waiters never hang.  On several
        processes the front end then sends its followers the stop message,
        and a follower's ``stop`` returns once it has it (raising the
        error that stopped it, if one did).
        """
        if not self.is_front:
            if self._thread is not None:
                self._thread.join(timeout=timeout)
                if self._thread.is_alive():
                    raise TimeoutError(
                        f"no stop from the front end after {timeout}s")
                self._thread = None
            elif not self._stopped and self.error is None:
                self._follow(until_idle=False)
            self._stopped = True
            if self.error is not None:
                raise ServeError(f"the service stopped with an error: "
                                 f"{self.error!r}") from self.error
            return
        if drain and not self._stopped:
            if self._thread is not None:
                # the loop drains the queue: a second thread stepping
                # would issue its collectives beside the loop's
                t0 = time.perf_counter()
                while len(self.scheduler) and self.error is None:
                    if time.perf_counter() - t0 > timeout:
                        raise TimeoutError(
                            f"{len(self.scheduler)} requests still queued "
                            f"after {timeout}s")
                    self._wake.wait(0.005)
            else:
                self.run_until_idle(timeout=timeout)
        self._stopped = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=max(timeout, 10))
            self._thread = None
        for _ in self.scheduler.fail_all(
                ServiceStopped("service stopped with requests queued")):
            self.metrics.record_error("stopped")
        if self._followers:
            self._send({r: ("stop",) for r in self._followers})
            self._followers = {}
