"""Continuous-batching scheduler for the multi-tenant transform service.

Requests arrive from many tenants, each carrying its own cut-off sphere
(cutoff + k-shift), band count and optional deadline.  The scheduler's job
is the serving half of the paper's batching argument: transforms whose
spheres share one bounding box (same cutoff diameter ``d``, same FFT cube
``n``) differ only in their static pack tables, so they can ride a single
ragged stacked dispatch (``StackedPlaneWaveFFT``) — *if* the padding the
ragged batch introduces is worth it.  A configurable **padding budget**
decides: a candidate joins the batch only while

    1 − Σ_i bands_i · npacked_i / (rows · npacked_max)  ≤  budget

(rows = Σ bands_i; a batch of one request always has padding 0, so every
request is admissible alone and the budget can never deadlock).

Fairness is round-robin over tenants: each tenant holds a FIFO deque, the
batch *seed* rotates through non-empty tenants, and batch fill iterates
tenants in the same rotating order — a tenant flooding its queue cannot
starve the others.  Queue-depth backpressure (``QueueFull``) and absolute
per-request deadlines (``DeadlineExceeded``, resolved by ``expire`` as an
error on the handle, never a hang) bound the damage of overload.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque

import numpy as np
import torch

from ..check.locks import TrackedLock
from ..core.domain import SphereDomain


class ServeError(RuntimeError):
    """Base class of transform-service request failures."""


class DeadlineExceeded(ServeError):
    """The request's deadline passed before it was dispatched."""


class QueueFull(ServeError):
    """The tenant's queue is at ``max_queue_per_tenant`` — back off."""


class ServiceStopped(ServeError):
    """The service shut down with the request still queued."""


def compat_key(sphere: SphereDomain, n: int) -> tuple:
    """Batch-compatibility class of a request.

    Two requests can share one stacked dispatch iff their spheres share a
    bounding box (equal extents — same cutoff diameter, any k-shift or
    radius below it) and target the same FFT cube width ``n``: then the
    inner d³→n³ plan is identical and only the pack tables differ.
    """
    return (tuple(sphere.extents), int(n))


@dataclasses.dataclass
class TransformRequest:
    """One tenant's unit of work: packed coefficients through the service.

    ``coeffs`` is ``(nbands, sphere.npacked)`` complex64 — a numpy array
    or a torch tensor on any device (others are converted to numpy);
    ``v_eff`` an optional real ``(n, n, n)`` local potential (numpy or
    torch) applied point-wise in real space between the inverse and
    forward transforms (``None`` = pure round trip).  ``deadline`` is
    absolute ``time.perf_counter()`` seconds.
    """
    tenant: str
    coeffs: np.ndarray | torch.Tensor
    sphere: SphereDomain
    n: int
    v_eff: np.ndarray | torch.Tensor | None = None
    deadline: float | None = None
    rid: int = -1

    def __post_init__(self):
        if isinstance(self.coeffs, torch.Tensor):
            self.coeffs = self.coeffs.to(torch.complex64)
        else:
            self.coeffs = np.asarray(self.coeffs, np.complex64)
        if self.coeffs.ndim != 2:
            raise ValueError(
                f"coeffs must be (nbands, npacked), got "
                f"{tuple(self.coeffs.shape)}")
        if self.coeffs.shape[1] != self.sphere.npacked:
            raise ValueError(
                f"coeffs last dim {self.coeffs.shape[1]} != sphere "
                f"npacked {self.sphere.npacked}")
        if self.v_eff is not None:
            if not isinstance(self.v_eff, torch.Tensor):
                self.v_eff = np.asarray(self.v_eff)
            if tuple(self.v_eff.shape) != (self.n,) * 3:
                raise ValueError(
                    f"v_eff shape {tuple(self.v_eff.shape)} != "
                    f"{(self.n,) * 3}")

    @property
    def nbands(self) -> int:
        return int(self.coeffs.shape[0])

    @property
    def compat(self) -> tuple:
        return compat_key(self.sphere, self.n)


class TransformHandle:
    """Future-style result slot for a submitted request.

    ``result()`` blocks until the service resolves the handle, then
    returns the ``(nbands, npacked)`` output coefficients (a host numpy
    array) or raises the stored :class:`ServeError`.  Timestamps
    (``submitted_at`` / ``completed_at``, ``time.perf_counter()`` seconds)
    feed the latency metrics.
    """

    def __init__(self, request: TransformRequest):
        self.request = request
        self.submitted_at = time.perf_counter()
        self.dispatched_at: float | None = None
        self.completed_at: float | None = None
        self._event = threading.Event()
        self._result = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = 30.0):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request.rid} unresolved after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def latency(self) -> float | None:
        """Submit→resolve wall seconds (None while pending)."""
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at

    @property
    def queue_wait(self) -> float | None:
        """Submit→dispatch wall seconds (None until dispatch starts)."""
        if self.dispatched_at is None:
            return None
        return self.dispatched_at - self.submitted_at

    # ------------------------------------------------- service-side setters
    def _resolve(self, value) -> None:
        self._result = value
        self.completed_at = time.perf_counter()
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self.completed_at = time.perf_counter()
        self._event.set()


class CoalescingScheduler:
    """Round-robin fair, padding-budgeted request coalescer.

    Thread-safe: tenants submit from their own threads, the service loop
    pulls batches from its own.  All queue state lives behind one lock;
    dispatch itself happens outside (the scheduler only forms batches).
    """

    def __init__(self, *, padding_budget: float = 0.5, max_rows: int = 8,
                 max_queue_per_tenant: int = 64):
        if not 0.0 <= padding_budget < 1.0:
            raise ValueError(f"padding_budget {padding_budget} not in [0, 1)")
        if max_rows < 1:
            raise ValueError("max_rows must be >= 1")
        if max_queue_per_tenant < 1:
            raise ValueError("max_queue_per_tenant must be >= 1")
        self.padding_budget = float(padding_budget)
        self.max_rows = int(max_rows)
        self.max_queue_per_tenant = int(max_queue_per_tenant)
        self._queues: dict[str, deque] = {}
        self._rr: deque = deque()            # tenant round-robin order
        self._rid = itertools.count()
        self._lock = TrackedLock("serve.scheduler")

    # ---------------------------------------------------------- submission
    def submit(self, request: TransformRequest) -> TransformHandle:
        """Enqueue; raises :class:`QueueFull` at the tenant's depth cap."""
        with self._lock:
            q = self._queues.get(request.tenant)
            if q is None:
                q = self._queues[request.tenant] = deque()
                self._rr.append(request.tenant)
            if len(q) >= self.max_queue_per_tenant:
                raise QueueFull(
                    f"tenant {request.tenant!r} queue at depth "
                    f"{len(q)} (max {self.max_queue_per_tenant})")
            request.rid = next(self._rid)
            handle = TransformHandle(request)
            q.append(handle)
            return handle

    def __len__(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def depth(self, tenant: str) -> int:
        with self._lock:
            q = self._queues.get(tenant)
            return 0 if q is None else len(q)

    # ------------------------------------------------------------ deadlines
    def expire(self, now: float | None = None) -> list[TransformHandle]:
        """Fail (and drop) every queued request whose deadline passed.

        Deadlines resolve as :class:`DeadlineExceeded` errors on the
        handle — an expired request never hangs its waiter and never
        occupies batch rows.
        """
        now = time.perf_counter() if now is None else now
        expired: list[TransformHandle] = []
        with self._lock:
            for q in self._queues.values():
                keep = deque()
                while q:
                    h = q.popleft()
                    d = h.request.deadline
                    if d is not None and now > d:
                        expired.append(h)
                    else:
                        keep.append(h)
                q.extend(keep)
        for h in expired:
            h._fail(DeadlineExceeded(
                f"request {h.request.rid} (tenant "
                f"{h.request.tenant!r}) deadline passed before dispatch"))
        return expired

    def fail_all(self, err: BaseException) -> list[TransformHandle]:
        """Drain every queue, failing all pending handles (shutdown path)."""
        with self._lock:
            drained = [h for q in self._queues.values() for h in q]
            for q in self._queues.values():
                q.clear()
        for h in drained:
            h._fail(err)
        return drained

    # ------------------------------------------------------------- batching
    @staticmethod
    def batch_padding(handles) -> float:
        """Padding fraction of a would-be batch (one sphere row per band)."""
        rows = sum(h.request.nbands for h in handles)
        npmax = max(h.request.sphere.npacked for h in handles)
        used = sum(h.request.nbands * h.request.sphere.npacked
                   for h in handles)
        return 1.0 - used / float(rows * npmax)

    def next_batch(self) -> list[TransformHandle]:
        """Pop the next coalesced batch (empty list when idle).

        The seed is the front request of the next non-empty tenant in
        round-robin order; fill then walks tenants in the same rotating
        order, admitting each tenant's front request while it (a) shares
        the seed's compatibility class, (b) fits under ``max_rows`` and
        (c) keeps the batch padding within the budget.  Only queue fronts
        are considered — per-tenant FIFO order is preserved.
        """
        with self._lock:
            order = [t for t in self._rr if self._queues[t]]
            if not order:
                return []
            # rotate the round-robin cursor past the seed tenant
            seed_tenant = order[0]
            while self._rr[0] != seed_tenant:
                self._rr.rotate(-1)
            self._rr.rotate(-1)

            batch = [self._queues[seed_tenant].popleft()]
            rows = batch[0].request.nbands
            key = batch[0].request.compat
            progress = True
            while progress and rows < self.max_rows:
                progress = False
                for t in order:
                    q = self._queues[t]
                    if not q:
                        continue
                    cand = q[0]
                    if cand.request.compat != key:
                        continue
                    if rows + cand.request.nbands > self.max_rows:
                        continue
                    if (self.batch_padding(batch + [cand])
                            > self.padding_budget):
                        continue
                    q.popleft()
                    batch.append(cand)
                    rows += cand.request.nbands
                    progress = True
            return batch

    def requeue_front(self, handles) -> None:
        """Push a formed batch back to its queue fronts (FIFO preserved).

        The admission-control stall path: a batch whose plan is still
        warming goes back exactly where it came from, so deadlines keep
        ticking and the next ``next_batch`` re-forms it cheaply.
        """
        with self._lock:
            for h in reversed(handles):
                self._queues[h.request.tenant].appendleft(h)
