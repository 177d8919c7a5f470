"""Low-overhead span tracer with Chrome-trace/Perfetto export.

One process-global :class:`Tracer` (``get_tracer()``) records *complete*
spans — named wall-clock intervals with nesting tracked per thread — into
a bounded ring buffer.  The design constraints, in order:

* **Disabled is free.**  ``tracer.span(...)`` on a disabled tracer returns
  a shared no-op singleton: no span object is allocated, no lock is taken,
  no timestamp is read.  Instrumented hot paths guard on
  ``tracer.enabled`` (a plain attribute) before building attribute dicts.
* **Honest device timing.**  CUDA launches are asynchronous — a span that
  closes right after ``fn(x)`` times the *launch*, not the execution.
  ``span.sync(out)`` marks a value whose CUDA devices are synchronized
  (``torch.cuda.synchronize``) at span exit when ``tracer.sync`` is on,
  so the recorded duration covers the device work the span claims to
  measure.  CPU tensors need no synchronization: their work is done when
  the call returns.
* **Threads nest independently.**  Each thread has its own span stack;
  depth and parent are per-thread, and exported events carry a per-thread
  track id so Perfetto renders one lane per thread.

Export is the Chrome trace event format (``ph: "X"`` complete events,
timestamps in microseconds) — load the JSON in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

import torch


def _cuda_devices(value) -> set:
    """The CUDA devices of every tensor in ``value`` (nested lists, tuples
    and dict values are walked)."""
    found: set = set()
    stack = [value]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda":
                found.add(v.device)
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
    return found


def drain(value):
    """Wait until the device work producing ``value`` has finished.

    ``torch.cuda.synchronize`` on each CUDA device ``value`` lives on; a
    no-op for CPU tensors and non-tensor values.  Returns ``value``.
    """
    for dev in _cuda_devices(value):
        torch.cuda.synchronize(dev)
    return value


def timed_call(fn, *args, **kwargs):
    """``(result, seconds)`` of ``fn(*args)`` with the device drained.

    The one honest way to wall-clock a CUDA call: the clock stops only
    after :func:`drain` of the result, so asynchronous launches cannot
    make the call look faster than the device work it started.  Timing
    ``fn(x)`` bare measures launch latency, not execution.
    """
    t0 = time.perf_counter()
    out = drain(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


class _NoopSpan:
    """Shared do-nothing span — the disabled tracer's fast path.

    A singleton: tests assert ``tracer.span('a') is tracer.span('b')``
    to pin the no-allocation property.
    """

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def sync(self, value):
        return value


NOOP_SPAN = _NoopSpan()


class Span:
    """One live span: a context manager that records itself on exit."""

    __slots__ = ("_tracer", "name", "attrs", "t0", "t1", "depth", "parent",
                 "_sync_value", "_tid")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = self.t1 = None
        self.depth = 0
        self.parent = None
        self._sync_value = None
        self._tid = None

    def set(self, **attrs):
        """Attach attributes after entry (e.g. results known at exit)."""
        self.attrs.update(attrs)
        return self

    def sync(self, value):
        """Mark ``value`` for :func:`drain` at span exit.

        Returns ``value`` so call sites can write
        ``out = sp.sync(fn(x))``.  No-op when ``tracer.sync`` is off.
        """
        self._sync_value = value
        return value

    def __enter__(self):
        stack = self._tracer._stack()
        self.depth = len(stack)
        self.parent = stack[-1].name if stack else None
        self._tid = threading.get_ident()
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._sync_value is not None and self._tracer.sync:
            drain(self._sync_value)
            self._sync_value = None
        self.t1 = time.perf_counter()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._record(self.name, self.t0, self.t1, self._tid,
                             self.depth, self.parent, self.attrs)
        return False


class Tracer:
    """Bounded recorder of spans; export via :meth:`to_chrome`."""

    def __init__(self, max_events: int = 200_000):
        self.enabled = False
        self.sync = True          # drain marked values at span exit
        self.per_stage = True     # plans record one span per stage
        self._events: deque = deque(maxlen=max_events)
        self.dropped = 0
        self._local = threading.local()
        self._lock = threading.Lock()
        self._origin = time.perf_counter()

    # ------------------------------------------------------------ lifecycle
    def enable(self, *, sync: bool = True, per_stage: bool = True,
               clear: bool = True) -> "Tracer":
        """Start recording.  ``sync`` drains marked values at span exit
        (honest device timing); ``per_stage`` asks plans to record one
        span per stage so line DFTs and moves get separate spans."""
        if clear:
            self.clear()
        self.sync = bool(sync)
        self.per_stage = bool(per_stage)
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._origin = time.perf_counter()

    # ------------------------------------------------------------ recording
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **attrs):
        """A context manager timing the enclosed block (no-op singleton
        when disabled — guard attribute construction on ``enabled`` if
        the attrs themselves are expensive)."""
        if not self.enabled:
            return NOOP_SPAN
        return Span(self, name, attrs)

    def event(self, name: str, t0: float, t1: float, **attrs) -> None:
        """Record a complete event with explicit ``perf_counter`` bounds.

        For intervals that span threads (queue wait: submitted on a
        tenant thread, resolved on the dispatch thread) where a context
        manager cannot bracket the work.
        """
        if not self.enabled:
            return
        self._record(name, t0, t1, threading.get_ident(), 0, None, attrs)

    def instant(self, name: str, **attrs) -> None:
        """Record a zero-duration marker (cache miss, eviction, ...)."""
        if not self.enabled:
            return
        t = time.perf_counter()
        self._record(name, t, t, threading.get_ident(), 0, None, attrs)

    def _record(self, name, t0, t1, tid, depth, parent, attrs) -> None:
        ev = {"name": name, "t0": t0, "t1": t1, "tid": tid,
              "depth": depth, "parent": parent, "attrs": attrs}
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    # -------------------------------------------------------------- queries
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def summary(self) -> dict:
        """Per-name {count, total_ms} rollup of the recorded spans."""
        out: dict[str, dict] = {}
        for ev in self.events():
            s = out.setdefault(ev["name"], {"count": 0, "total_ms": 0.0})
            s["count"] += 1
            s["total_ms"] += (ev["t1"] - ev["t0"]) * 1e3
        for s in out.values():
            s["total_ms"] = round(s["total_ms"], 3)
        return out

    # --------------------------------------------------------------- export
    def to_chrome(self) -> dict:
        """The trace as a Chrome trace event object (Perfetto-loadable).

        Complete (``ph: "X"``) events with microsecond timestamps
        relative to the last ``clear()``; one track per thread (small
        sequential tids plus thread-name metadata events).
        """
        events = self.events()
        pid = os.getpid()
        tids: dict[int, int] = {}
        out = []
        for ev in events:
            tid = tids.setdefault(ev["tid"], len(tids))
            args = dict(ev["attrs"])
            if ev["parent"] is not None:
                args["parent"] = ev["parent"]
            args["depth"] = ev["depth"]
            out.append({
                "name": ev["name"], "cat": "repro_torch", "ph": "X",
                "ts": (ev["t0"] - self._origin) * 1e6,
                "dur": max((ev["t1"] - ev["t0"]) * 1e6, 0.0),
                "pid": pid, "tid": tid, "args": args,
            })
        meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": t,
                 "args": {"name": f"thread-{t}"}} for t in tids.values()]
        return {"traceEvents": meta + out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export_chrome(self, path: str) -> str:
        """Write :meth:`to_chrome` JSON to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, default=_jsonable)
            f.write("\n")
        return path


def _jsonable(x):
    """Fallback serializer: numpy/torch scalars → python, else str()."""
    try:
        return x.item()
    except (AttributeError, RuntimeError, ValueError):
        return str(x)


_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer every instrumented layer records into."""
    return _GLOBAL
