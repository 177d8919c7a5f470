"""Observability for the transform service.

Everything the serving story needs to be judged by: per-tenant latency
percentiles (p50/p99 over submit→resolve wall time), sustained request and
transform throughput, the *realized* padding fraction of coalesced
dispatches (the quantity the scheduler's budget bounds), and the shared
``PlanCache``'s hit rate / resident bytes over the measurement window.
``summary()`` emits the service's record (the same keys as the reference
package's ``ServiceMetrics.summary``); ``reset()`` restarts the window (a
measurement warms plans first, then measures a clean window).

Sample storage is **bounded**: latencies, queue waits and padding
fractions live in fixed-size :class:`~repro_torch.obs.metrics.Reservoir` ring
buffers (``max_samples`` per series), so a long-lived service never grows
its metrics without bound.  Percentiles are computed over the retained
window; counts (``requests``, per-tenant ``requests``) and
``padding_fraction_max`` are all-time within the window — a running max
survives ring-buffer wraparound.  Percentile math is safe on empty and
single-sample windows (0.0 / the sample).

Thread-safe: dispatch loop and tenant threads record concurrently.
"""
from __future__ import annotations

import time

from ..check.locks import TrackedLock
from ..obs.metrics import Reservoir, percentile


def _percentile_ms(samples, q: float) -> float:
    """q-th percentile of ``samples`` (seconds) in milliseconds.

    Empty → 0.0, single sample → that sample; linear interpolation
    otherwise (matches ``numpy.percentile``'s default).
    """
    return percentile(samples, q) * 1e3


class ServiceMetrics:
    """Rolling counters + bounded latency reservoirs for one service.

    ``max_samples`` caps the retained samples *per series* (per-tenant
    latency, queue wait, padding); beyond it the oldest samples fall off
    while all-time counts keep counting.
    """

    def __init__(self, cache=None, *, max_samples: int = 2048):
        if max_samples < 1:
            raise ValueError("max_samples must be >= 1")
        self._cache = cache
        self.max_samples = int(max_samples)
        self._lock = TrackedLock("serve.metrics")
        self.reset()

    def reset(self) -> None:
        """Restart the measurement window (counters, reservoirs, cache

        deltas and the wall clock all restart; plans already cached keep
        their warmth — that is the point of resetting after warmup)."""
        with self._lock:
            self._t0 = time.perf_counter()
            self._lat: dict[str, Reservoir] = {}
            self._queue_wait = Reservoir(self.max_samples)
            self._errors: dict[str, int] = {}
            self.requests = 0
            self.transforms = 0
            self.dispatches = 0
            self.coalesced_dispatches = 0
            self.rows = 0
            self._padding = Reservoir(self.max_samples)
            self._padding_max = 0.0
            if self._cache is not None:
                s = self._cache.stats
                self._cache0 = (s["hits"], s["misses"])
            else:
                self._cache0 = (0, 0)

    # ------------------------------------------------------------ recording
    def record_request(self, tenant: str, latency_s: float,
                       nbands: int, queue_wait_s: float | None = None
                       ) -> None:
        with self._lock:
            res = self._lat.get(tenant)
            if res is None:
                res = self._lat[tenant] = Reservoir(self.max_samples)
            res.record(float(latency_s))
            if queue_wait_s is not None:
                self._queue_wait.record(float(queue_wait_s))
            self.requests += 1
            self.transforms += int(nbands)

    def record_error(self, kind: str) -> None:
        with self._lock:
            self._errors[kind] = self._errors.get(kind, 0) + 1

    def record_dispatch(self, nreqs: int, rows: int,
                        padding_fraction: float) -> None:
        with self._lock:
            self.dispatches += 1
            self.rows += int(rows)
            if nreqs > 1:
                self.coalesced_dispatches += 1
            self._padding.record(float(padding_fraction))
            if padding_fraction > self._padding_max:
                self._padding_max = float(padding_fraction)

    # ------------------------------------------------------------- queries
    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def max_padding_fraction(self) -> float:
        """Worst realized dispatch padding — the number the budget bounds.

        All-time within the window: a running max, not a reservoir scan,
        so ring-buffer wraparound cannot forget the worst dispatch.
        """
        with self._lock:
            return self._padding_max

    def summary(self) -> dict:
        """The serving record: per-tenant percentiles + service rates.

        All latencies in milliseconds, rates over the window since the
        last ``reset()``.  Shape is stable: ``requests_per_s`` and
        ``latency_p99_ms`` sit at the top level.
        Per-tenant ``requests`` counts all-time within the window;
        percentiles cover the retained samples.
        """
        with self._lock:
            elapsed = max(time.perf_counter() - self._t0, 1e-9)
            all_lat = [v for res in self._lat.values()
                       for v in res.values()]
            per_tenant = {
                t: {"requests": res.count,
                    "latency_p50_ms": round(
                        _percentile_ms(res.values(), 50), 3),
                    "latency_p99_ms": round(
                        _percentile_ms(res.values(), 99), 3)}
                for t, res in sorted(self._lat.items())
            }
            pad = self._padding.values()
            out = {
                "requests": self.requests,
                "requests_per_s": round(self.requests / elapsed, 2),
                "transforms": self.transforms,
                "transforms_per_s": round(self.transforms / elapsed, 2),
                "latency_p50_ms": round(_percentile_ms(all_lat, 50), 3),
                "latency_p99_ms": round(_percentile_ms(all_lat, 99), 3),
                "dispatches": self.dispatches,
                "coalesced_dispatches": self.coalesced_dispatches,
                "rows": self.rows,
                "padding_fraction_mean": round(
                    sum(pad) / len(pad) if pad else 0.0, 4),
                "padding_fraction_max": round(self._padding_max, 4),
                "errors": dict(self._errors),
                "per_tenant": per_tenant,
            }
            if len(self._queue_wait):
                out["queue_wait_p50_ms"] = round(
                    _percentile_ms(self._queue_wait.values(), 50), 3)
                out["queue_wait_p99_ms"] = round(
                    _percentile_ms(self._queue_wait.values(), 99), 3)
            if self._cache is not None:
                s = self._cache.stats
                h = s["hits"] - self._cache0[0]
                m = s["misses"] - self._cache0[1]
                out["plan_cache"] = {
                    "hits": h, "misses": m,
                    "hit_rate": round(h / max(h + m, 1), 4),
                    "resident_bytes": s["resident_bytes"],
                }
            return out
