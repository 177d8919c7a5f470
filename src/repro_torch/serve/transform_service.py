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
spends its time in.  The service composes ``unpack`` → plan → ``pack``:
on ``backend="cuda"`` every line-DFT stage of the plans runs the
hand-written ``dft_matmul`` kernel.

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

The coefficient buffer and the potential are assembled on the service's
device; results resolve as host numpy arrays, so a handle's completion is
a real completion of the device work.

Robustness is the scheduler's: round-robin tenant fairness, queue-depth
backpressure (``QueueFull``), per-request deadlines resolved as
``DeadlineExceeded`` errors.  ``ServiceMetrics`` records what happened.
"""
from __future__ import annotations

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


class TransformService:
    """Continuous-batching sphere-transform server on one process grid.

    One service instance serves one ``ProcGrid`` (and its device) and one
    FFT cube width ``n``; requests vary freely in sphere (cutoff/k-shift),
    band count, potential and deadline.  Drive it synchronously
    (``submit`` + ``run_until_idle``) or as a background loop
    (``start``/``stop``).
    """

    def __init__(self, grid, n: int, *, padding_budget: float = 0.5,
                 max_rows: int = 8, max_queue_per_tenant: int = 64,
                 backend: str = "matmul",
                 batch_axes: tuple[int, ...] = (),
                 fft_axes: tuple[int, ...] | None = None,
                 policy: ExecPolicy | None = None, cache=None,
                 coalesce: bool = True, warm_async: bool = True):
        if grid.multi_process:
            raise NotImplementedError(
                f"TransformService on a grid of {grid.nprocs} processes: "
                "the service runs on one process; on several ranks it is a "
                "later slice of the port (ROADMAP.md §1)")
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

    # ------------------------------------------------------------- submit
    def submit(self, tenant: str, coeffs, sphere: SphereDomain, *,
               v_eff=None, deadline: float | None = None
               ) -> TransformHandle:
        """Enqueue one request; returns a handle to block on.

        ``coeffs``: ``(nbands, sphere.npacked)`` complex, numpy or torch;
        ``v_eff``: ``(n, n, n)`` real or None; ``deadline`` is *relative*
        seconds from now (``None`` = no deadline).  Raises
        :class:`QueueFull` past the tenant's depth cap and
        :class:`ServiceStopped` after :meth:`stop`.
        """
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
        """Bucketed row count: next power of two, capped at ``max_rows``."""
        return min(_next_pow2(max(int(rows), 1)), self.max_rows)

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
        ``warm_async``: build inline and report True.
        """
        seed = batch[0].request
        rows = sum(h.request.nbands for h in batch)
        wk = (seed.compat, self.bucket_for(rows))
        if wk in self._warmed:
            return True
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
        try:
            inv, fwd = self._pair_for((sphere,) * bucket, bucket)
            z = torch.zeros((bucket, inv.npacked_max), dtype=torch.complex64,
                            device=self.device)
            inv.pack(fwd(inv(inv.unpack(z)))).cpu()
        finally:
            with self._warm_lock:
                self._warmed.add(wk)
                self._inflight.discard(wk)
            self._wake.set()

    def warm(self, sphere: SphereDomain, nbands: int = 1) -> None:
        """Pre-warm the plans a ``(sphere, nbands)`` request would use."""
        wk = (compat_key(sphere, self.n), self.bucket_for(nbands))
        self._warm_build(sphere, wk)

    # ------------------------------------------------------------ dispatch
    def step(self) -> int:
        """One scheduler turn: expire deadlines, dispatch ≤ one batch.

        Returns the number of requests *resolved* this step (results or
        deadline errors); 0 means idle or stalled on a warming plan.
        """
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
        if not self._ensure_warm(batch):
            self.scheduler.requeue_front(batch)
            return resolved
        try:
            self._dispatch(batch)
        except Exception as err:   # fail the batch, never hang waiters
            for h in batch:
                h._fail(ServeError(f"dispatch failed: {err!r}"))
            self.metrics.record_error("dispatch")
            raise
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

            # one child span per piece (the plans record their own); with
            # the tracer's sync on, each covers its piece's device work
            with tr.span("serve.upload_coeffs") as sp:
                buf = torch.zeros((bucket, inv.npacked_max),
                                  dtype=torch.complex64, device=self.device)
                r0 = 0
                for r in reqs:
                    buf[r0:r0 + r.nbands, :r.sphere.npacked] = \
                        self._device_tensor(r.coeffs, torch.complex64)
                    r0 += r.nbands
                sp.sync(buf)
            with tr.span("serve.unpack") as sp:
                x = sp.sync(inv.unpack(buf))
            psi = inv(x)
            if any(r.v_eff is not None for r in reqs):
                with tr.span("serve.upload_potential") as sp:
                    v = torch.ones((bucket,) + (self.n,) * 3,
                                   dtype=torch.float32, device=self.device)
                    r0 = 0
                    for r in reqs:
                        if r.v_eff is not None:
                            v[r0:r0 + r.nbands] = self._device_tensor(
                                r.v_eff, torch.float32)
                        r0 += r.nbands
                    sp.sync(v)
                with tr.span("serve.times_v") as sp:
                    psi = sp.sync(psi * v)
            z = fwd(psi)
            with tr.span("serve.pack") as sp:
                packed = sp.sync(inv.pack(z))
            # the host copy waits for the device: the span end is an
            # honest completion time without an extra sync
            with tr.span("serve.download"):
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

    # ------------------------------------------------------- eager oracle
    def eager_apply(self, coeffs, sphere: SphereDomain, v_eff=None
                    ) -> np.ndarray:
        """Per-request dispatch, no coalescing — the correctness oracle.

        Same math as one dispatched request (cached per-sphere
        ``PlaneWaveFFT`` pair, batch = the request's own bands); the
        coalesced path matches it to fp32 rounding.
        """
        c = self._device_tensor(coeffs, torch.complex64)
        bdom = Domain((0,), (c.shape[0] - 1,))
        inv = fftb.plan_for(self._pw_spec, domains=(bdom, sphere),
                            grid=self.grid, sizes=(self.n,) * 3,
                            inverse=True, backend=self.backend,
                            policy=self.policy, cache=self.cache)
        fwd = inv.inverse()
        psi = inv(inv.unpack(c))
        if v_eff is not None:
            psi = psi * self._device_tensor(v_eff, torch.float32)
        return inv.pack(fwd(psi)).cpu().numpy()

    # ----------------------------------------------------------- lifecycle
    def run_until_idle(self, timeout: float = 60.0) -> int:
        """Step until every queued request is resolved; returns count."""
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
        return total

    def start(self) -> None:
        """Run the dispatch loop on a background thread (until ``stop``)."""
        if self._thread is not None:
            return
        self._stopped = False

        def loop():
            while not self._stopped:
                try:
                    n = self.step()
                except Exception:      # batch already failed; keep serving
                    continue
                if n == 0:
                    self._wake.wait(0.005)
                    self._wake.clear()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop serving; pending requests drain (default) or fail.

        With ``drain=False`` every queued request resolves immediately
        with :class:`ServiceStopped` — waiters never hang.
        """
        if drain and not self._stopped:
            self.run_until_idle(timeout=timeout)
        self._stopped = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        for _ in self.scheduler.fail_all(
                ServiceStopped("service stopped with requests queued")):
            self.metrics.record_error("stopped")
