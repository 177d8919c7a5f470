"""Process-global metrics registry: counters, gauges, histograms, probes.

Instrumentation lives in many places — ``FftPlan.executions`` (a class
counter), ``PERK_LINALG_CALLS``, ``PlanCache.stats``, the kernels' launch
counts, the transform service's latency percentiles — each with its own
shape.  :class:`MetricsRegistry` is the one place to read them:

* ``counter(name)`` / ``gauge(name)`` / ``histogram(name)`` — named
  instruments, created on first use, thread-safe.
* ``register_probe(name, fn)`` — a callback snapshotting *existing*
  state, so the counters register onto the registry without changing
  their APIs: ``core.plan`` registers an ``fftb`` probe over its class
  counters, ``core.cache`` a ``plan_cache`` probe over the global cache's
  ``stats``, ``dft.hamiltonian`` a ``dft`` probe, ``kernels.sphere_pack``
  a ``sphere_pack`` probe over its fused-call counts, and each
  ``ServiceMetrics`` (weakly) a ``serve`` probe over its ``summary()``.
* ``snapshot()`` — one JSON-serializable dict of everything, so a run
  can attribute its time to a phase (plan builds?  cache churn?).

Histograms keep a bounded :class:`Reservoir` (ring buffer) of recent
samples — long-running services must not grow memory without bound — and
their percentile math is defined on empty (→ 0.0) and single-sample
windows (→ that sample).
"""
from __future__ import annotations

import math
import threading
import weakref
from collections import deque


def percentile(samples, q: float) -> float:
    """Linear-interpolated percentile, safe on empty/single windows.

    ``[] → 0.0``; one sample → that sample; otherwise the usual
    linear interpolation between closest ranks (numpy's default
    method, without requiring numpy).
    """
    xs = sorted(float(v) for v in samples)
    if not xs:
        return 0.0
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * (q / 100.0)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Reservoir:
    """Bounded sample window: a ring buffer plus a total count.

    ``record`` is O(1); once ``maxlen`` samples are held the oldest is
    dropped, so percentiles reflect the recent window while ``count``
    keeps the all-time total (request counts must not be capped by the
    sample bound).
    """

    __slots__ = ("_buf", "count")

    def __init__(self, maxlen: int = 2048):
        if maxlen < 1:
            raise ValueError("maxlen must be >= 1")
        self._buf: deque = deque(maxlen=int(maxlen))
        self.count = 0

    def record(self, value: float) -> None:
        self._buf.append(float(value))
        self.count += 1

    def values(self) -> list[float]:
        return list(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def maxlen(self) -> int:
        return self._buf.maxlen

    def percentile(self, q: float) -> float:
        return percentile(self._buf, q)

    def mean(self) -> float:
        return sum(self._buf) / len(self._buf) if self._buf else 0.0

    def max(self) -> float:
        return max(self._buf) if self._buf else 0.0


class Counter:
    """Monotonic named count (thread-safe)."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins named value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Bounded distribution of samples; summary is window percentiles."""

    __slots__ = ("_lock", "_res")

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._res = Reservoir(window)

    def record(self, value: float) -> None:
        with self._lock:
            self._res.record(value)

    @property
    def count(self) -> int:
        return self._res.count

    def summary(self) -> dict:
        with self._lock:
            return {
                "count": self._res.count,
                "window": len(self._res),
                "mean": round(self._res.mean(), 6),
                "p50": round(self._res.percentile(50), 6),
                "p99": round(self._res.percentile(99), 6),
                "max": round(self._res.max(), 6),
            }


class MetricsRegistry:
    """Named instruments + probes, snapshotted as one dict."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._probes: dict = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str, window: int = 2048) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(window)
            return h

    def register_probe(self, name: str, fn) -> None:
        """Register ``fn() -> dict`` snapshotted under ``name``.

        Re-registering replaces (module reloads, newest service wins).
        A probe that raises contributes ``{"error": ...}`` instead of
        breaking the snapshot.
        """
        with self._lock:
            self._probes[name] = fn

    def unregister_probe(self, name: str) -> None:
        with self._lock:
            self._probes.pop(name, None)

    def reset(self) -> None:
        """Drop every instrument (probes stay registered — they read
        external state the registry does not own)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    def snapshot(self) -> dict:
        """Everything, as one JSON-serializable dict."""
        with self._lock:
            counters = {k: v.value for k, v in self._counters.items()}
            gauges = {k: v.value for k, v in self._gauges.items()}
            hists = {k: v.summary() for k, v in self._histograms.items()}
            probes = dict(self._probes)
        out = {"counters": counters, "gauges": gauges,
               "histograms": hists}
        for name, fn in probes.items():
            try:
                val = fn()
            except Exception as err:   # a broken probe must not break obs
                val = {"error": repr(err)}
            if val is not None:
                out[name] = _plain(val)
        return out


def _plain(x):
    """Recursively coerce to JSON-serializable python scalars."""
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (str, bool, int, float)) or x is None:
        return x
    try:
        return x.item()                        # numpy scalar
    except AttributeError:
        return str(x)


def diff_snapshot(before: dict, after: dict) -> dict:
    """``after − before`` on numeric leaves; non-numeric keep ``after``.

    The per-run window: counters are process-cumulative, so a run's
    contribution is the delta across it.  Keys only in ``after`` pass
    through unchanged.
    """
    out = {}
    for k, av in after.items():
        bv = before.get(k)
        if isinstance(av, dict) and isinstance(bv, dict):
            out[k] = diff_snapshot(bv, av)
        elif (isinstance(av, (int, float)) and not isinstance(av, bool)
              and isinstance(bv, (int, float)) and not isinstance(bv, bool)):
            out[k] = av - bv
        else:
            out[k] = av
    return out


def register_weak_probe(registry: MetricsRegistry, name: str, obj,
                        method: str = "summary") -> None:
    """Probe ``getattr(obj, method)()`` without keeping ``obj`` alive.

    Long-lived registries must not pin short-lived services: the probe
    holds a weakref and reports ``None`` (dropped from snapshots) after
    the object is collected.
    """
    ref = weakref.ref(obj)

    def probe():
        target = ref()
        return None if target is None else getattr(target, method)()

    registry.register_probe(name, probe)


_GLOBAL = MetricsRegistry()


def global_metrics() -> MetricsRegistry:
    """The process-global registry every instrumented layer reports to."""
    return _GLOBAL
