"""Observability: span tracing + metrics registry (process-global).

``get_tracer()`` and ``global_metrics()`` are the two entry points; see
``obs/trace.py`` and ``obs/metrics.py``.  This package imports nothing
from the rest of ``repro_torch`` — every layer (core, kernels, dft,
serve) records *into* it, never the other way around.
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      Reservoir, diff_snapshot, global_metrics,
                      percentile, register_weak_probe)
from .trace import (NOOP_SPAN, Span, Tracer, drain, get_tracer, relayout,
                    timed_call)

__all__ = [
    "Tracer", "Span", "NOOP_SPAN", "get_tracer", "timed_call", "drain",
    "relayout",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "Reservoir",
    "global_metrics", "percentile", "diff_snapshot",
    "register_weak_probe",
]
