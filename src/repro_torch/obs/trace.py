"""Low-overhead span tracer with Chrome-trace/Perfetto export.

One process-global :class:`Tracer` (``get_tracer()``) records *complete*
spans — named wall-clock intervals with nesting tracked per thread — into
a bounded ring buffer.  The design constraints, in order:

* **Off is free.**  ``tracer.span(...)`` on a tracer that is off returns
  a shared no-op singleton: no span object is allocated, no lock is taken,
  no timestamp is read.  Instrumented hot paths guard on
  ``tracer.enabled`` before building attribute dicts.
* **Spans follow a running profiler.**  While a ``torch.profiler`` session
  records, the tracer records as if enabled, with ``sync`` off and one span
  per plan stage.  Following starts at the session's first span and clears
  the buffer, so it holds that session's spans only; it ends when the
  tracer is looked at (a span opened, its events read) with no profiler
  recording.  Each span recorded under a profiler also opens a profiler
  range of its own name, recorded as a CPU op (not a user annotation,
  which the profiler would mirror on the device timeline): the port's
  spans sit on the profiler's clock and own the operators and kernels
  launched inside them.
* **Device time without a sync.**  CUDA launches are asynchronous — a
  span that closes right after ``fn(x)`` times the *launch*, not the
  execution.  A span around device work launched in it
  (:meth:`Tracer.device_span`) records a timing event on the current
  stream at entry and at exit (none while the stream captures a graph);
  a span around other spans takes its device interval from theirs, from
  the first one's entry event to the last one's exit event, and records
  none: each event costs the card a few microseconds between kernels.
  :meth:`Tracer.device_summary` resolves the device time when it is
  read, after the caller's own sync.  ``span.sync(out)`` still marks a
  value whose CUDA devices are synchronized (``torch.cuda.synchronize``)
  at span exit when the tracer was enabled with ``sync`` on, for
  wall-clock spans that cover their device work.  CPU tensors need no
  synchronization: their work is done when the call returns.
* **Threads nest independently.**  Each thread has its own span stack;
  depth and parent are per-thread, and exported events carry a per-thread
  track id so Perfetto renders one lane per thread.

:func:`relayout` is the copy that lays lines out contiguously for a GEMM;
while the tracer records, a call that copies runs in a ``relayout`` span
carrying its ``bytes``.

Export is the Chrome trace event format (``ph: "X"`` complete events,
timestamps in microseconds) — load the JSON in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from collections import deque

import torch
import torch.autograd.profiler as _autograd_profiler

try:
    # a profiler range recorded as a CPU op (``record_function``'s is a
    # user annotation, which the profiler mirrors on the device timeline)
    from torch._C._profiler import _RecordFunctionFast as _ProfilerRange
except ImportError:                      # pragma: no cover - older torch
    _ProfilerRange = None


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


def _stream_event():
    """A timing event recorded on the current CUDA stream, or None: no
    CUDA context yet, or the stream is capturing a graph (an event
    recorded there would belong to the graph)."""
    if (not torch.cuda.is_initialized()
            or torch.cuda.is_current_stream_capturing()):
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _device_ms(ev: dict):
    """The device milliseconds between a recorded span's two timing events,
    or None when it has none.  Waits for the exit event; the result
    replaces the events in ``ev``."""
    dev = ev["device"]
    if isinstance(dev, tuple):
        start, end = dev
        end.synchronize()
        dev = ev["device"] = start.elapsed_time(end)
    return dev


class Span:
    """One live span: a context manager that records itself on exit."""

    __slots__ = ("_tracer", "name", "attrs", "t0", "t1", "depth", "parent",
                 "_sync_value", "_tid", "_range", "_timed", "_start",
                 "_inner")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict,
                 timed: bool = False):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = self.t1 = None
        self.depth = 0
        self.parent = None
        self._sync_value = None
        self._tid = None
        self._range = None
        self._timed = timed       # records its own timing events
        self._start = None        # its entry event
        self._inner = None        # (first entry, last exit) of its spans

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
        if (_autograd_profiler._is_profiler_enabled
                and _ProfilerRange is not None):
            self._range = _ProfilerRange(self.name)
            self._range.__enter__()
        if self._timed:
            self._start = _stream_event()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        device = self._inner
        if self._start is not None:
            end = _stream_event()
            device = None if end is None else (self._start, end)
        self._start = self._inner = None
        if self._sync_value is not None and self._tracer.sync:
            drain(self._sync_value)
        self._sync_value = None
        self.t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if device is not None and stack and not stack[-1]._timed:
            outer = stack[-1]
            outer._inner = (device[0] if outer._inner is None
                            else outer._inner[0], device[1])
        self._tracer._record(self.name, self.t0, self.t1, self._tid,
                             self.depth, self.parent, self.attrs, device)
        return False


class Tracer:
    """Bounded recorder of spans; export via :meth:`to_chrome`."""

    def __init__(self, max_events: int = 200_000):
        self._on = False          # enable() called
        self._following = False   # recording a profiler session
        self._suspended = 0
        self.sync = True          # drain marked values at span exit
        self.per_stage = True     # plans record one span per stage
        self._events: deque = deque(maxlen=max_events)
        self.dropped = 0
        self._local = threading.local()
        self._lock = threading.Lock()
        self._origin = time.perf_counter()

    # ------------------------------------------------------------ lifecycle
    @property
    def enabled(self) -> bool:
        """Whether spans record: after :meth:`enable`, or while a
        ``torch.profiler`` session records (following it), unless
        :meth:`suspended`."""
        if self._on:
            return True
        if not _autograd_profiler._is_profiler_enabled:
            self._following = False
            return False
        if self._suspended:
            return False
        if not self._following:
            self._follow()
        return True

    def _follow(self) -> None:
        """Start recording a profiler session: its spans only, no sync,
        one span per plan stage."""
        with self._lock:
            if self._following:
                return
            self._events.clear()
            self.dropped = 0
            self._origin = time.perf_counter()
            self.sync = False
            self.per_stage = True
            self._following = True

    def enable(self, *, sync: bool = True, per_stage: bool = True,
               clear: bool = True) -> "Tracer":
        """Start recording.  ``sync`` drains marked values at span exit
        (wall-clock spans that cover their device work); ``per_stage``
        asks plans to record one span per stage so line DFTs and moves
        get separate spans."""
        if clear:
            self.clear()
        self.sync = bool(sync)
        self.per_stage = bool(per_stage)
        self._on = True
        return self

    def disable(self) -> "Tracer":
        self._on = False
        return self

    @contextlib.contextmanager
    def suspended(self):
        """No span records inside, enabled or following (a CUDA graph
        capture: spans would time the capture, and a sync is not allowed
        in a graph)."""
        was, self._on = self._on, False
        self._suspended += 1
        try:
            yield self
        finally:
            self._suspended -= 1
            self._on = was

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._origin = time.perf_counter()
            self._following = False

    # ------------------------------------------------------------ recording
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **attrs):
        """A context manager timing the enclosed block (no-op singleton
        when off — guard attribute construction on ``enabled`` if the
        attrs themselves are expensive)."""
        if not self.enabled:
            return NOOP_SPAN
        return Span(self, name, attrs)

    def device_span(self, name: str, **attrs):
        """:meth:`span` around device work launched inside it: timed on
        the device by events on the current stream at entry and exit."""
        if not self.enabled:
            return NOOP_SPAN
        return Span(self, name, attrs, timed=True)

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

    def _record(self, name, t0, t1, tid, depth, parent, attrs,
                device=None) -> None:
        ev = {"name": name, "t0": t0, "t1": t1, "tid": tid,
              "depth": depth, "parent": parent, "attrs": attrs,
              "device": device}
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    # -------------------------------------------------------------- queries
    def events(self) -> list[dict]:
        if not _autograd_profiler._is_profiler_enabled:
            self._following = False     # the session followed has ended
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

    def device_summary(self) -> dict:
        """Per-name {count, device_ms, bytes} of the recorded spans.

        ``device_ms`` sums each span's device time (see
        :meth:`device_span`); it is None for a name none of whose spans
        has one (off CUDA, inside a graph capture, or no device span
        inside).  Reading it waits for the exit events, so read it after
        the caller's own sync.  ``bytes`` sums the spans' ``bytes``
        attributes.
        """
        out: dict[str, dict] = {}
        for ev in self.events():
            s = out.setdefault(ev["name"], {"count": 0, "device_ms": None,
                                            "bytes": 0})
            s["count"] += 1
            s["bytes"] += int(ev["attrs"].get("bytes", 0))
            ms = _device_ms(ev)
            if ms is not None:
                s["device_ms"] = (s["device_ms"] or 0.0) + ms
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


def relayout(x, lines: int | None = None):
    """``x.reshape(-1, lines)``, or ``x.contiguous()`` without ``lines``:
    the copy that lays a tensor's lines out contiguously for a GEMM.

    While the tracer records, a call that copies (the data does not
    already lie in that order) runs inside a ``relayout`` span with the
    copy's ``bytes`` (the tensor's size: read once and written once) and
    its ``stage``, the span it nests under.  A call that returns a view
    records nothing.
    """
    tr = _GLOBAL
    if not tr.enabled:
        return x.contiguous() if lines is None else x.reshape(-1, lines)
    if lines is None:
        if x.is_contiguous():
            return x
        make = x.contiguous
    else:
        try:
            return x.view(-1, lines)
        except RuntimeError:             # no view: reshape copies
            make = functools.partial(x.reshape, -1, lines)
    stack = tr._stack()
    with tr.device_span("relayout", bytes=x.numel() * x.element_size(),
                        stage=stack[-1].name if stack else None) as sp:
        return sp.sync(make())
