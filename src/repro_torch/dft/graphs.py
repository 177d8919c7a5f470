"""CUDA-graph capture of the fused SCF step, split at its host syncs.

The reference fuses one SCF iteration into a single ``jax.jit`` dispatch.
On the card the counterpart is a CUDA graph: the step is captured once
into static buffers and replayed once per iteration, so no Python and no
per-launch overhead run between its kernels.  A graph cannot hold an
operation that waits for the host.  Such an operation goes through
:func:`repro_torch.core.hostsync.host_sync`, which is a plain call
outside a capture; inside one it ends the graph being captured, runs the
operation eagerly between two graphs, and begins the next graph (on
several processes the grid's collectives and the plans' all-to-alls go
through it too).  A step with k host syncs becomes k + 1 graphs,
replayed in order with the k operations in between
(:meth:`StepGraphs.replay`).

A capture that fails raises: nothing falls back to running the step
eagerly.
"""
from __future__ import annotations

import time

import torch

from ..core.hostsync import set_capture
from ..obs.trace import get_tracer

__all__ = ["StepGraphs"]


class StepGraphs:
    """One step captured as CUDA graphs around its named host syncs.

    ``warmup(fn, *args)`` runs ``fn`` once on a side stream (kernel builds,
    library handles and caches fill there, outside any capture);
    ``capture(fn, *args)`` captures ``fn(*args)`` and runs it once,
    returning its outputs, which are static: every ``replay()`` recomputes
    them in place from the same argument buffers.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self._tape: list = []           # graphs and host syncs, in order
        #: the host syncs' argument and result buffers, by signature
        self._buffers: dict = {}
        self._graph = None
        self._stream_ctx = None
        self._outputs = None
        self.replays = 0                # replay() calls
        self.capture_seconds = 0.0

    # ------------------------------------------------------------ queries
    @property
    def graph_count(self) -> int:
        """The captured graphs, each replayed once per ``replay()``."""
        return sum(not isinstance(item, tuple) for item in self._tape)

    @property
    def sync_names(self) -> list[str]:
        """The host syncs between the graphs, in replay order."""
        return [item[0] for item in self._tape if isinstance(item, tuple)]

    # ---------------------------------------------------------- capture
    def warmup(self, fn, *args):
        """``fn(*args)`` once on the side stream, drained."""
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            out = fn(*args)
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        torch.cuda.synchronize(self.device)
        # the warm-up's blocks stay cached for the side stream, where the
        # capture's own pool cannot use them: hand them back first
        torch.cuda.empty_cache()
        return out

    def capture(self, fn, *args):
        """Capture ``fn(*args)`` as graphs split at its host syncs, and run
        it once (each graph is replayed as soon as it is captured, so the
        eager operations between them see real values).  The tracer is
        suspended meanwhile, also while it follows a profiler: spans would
        time the capture and their syncs are not allowed in a graph.
        Raises ``RuntimeError`` if the capture fails.
        """
        if self._tape:
            raise RuntimeError("this step is already captured")
        t0 = time.perf_counter()
        torch.cuda.synchronize(self.device)
        set_capture(self)
        try:
            with get_tracer().suspended():
                self._begin()
                out = fn(*args)
                self._end()
            self._outputs = out
        except Exception as exc:
            self._abort()
            raise RuntimeError(
                "capturing the fused SCF step as CUDA graphs failed (an "
                "operation that waits for the host must go through "
                f"core.hostsync.host_sync): {exc}") from exc
        finally:
            set_capture(None)
        torch.cuda.synchronize(self.device)
        self.capture_seconds = time.perf_counter() - t0
        return out

    def replay(self) -> None:
        """Run the captured step again: graphs and host syncs in order.

        With the tracer on, each graph records a ``step_graph`` span
        (``index`` in replay order) and each host sync a
        ``host_sync:<name>`` span, each timed on the device (and
        synchronized at exit when the tracer was enabled with ``sync``):
        the step's device time by piece, and what each sync costs.
        """
        tr = get_tracer()
        k = 0
        for item in self._tape:
            if isinstance(item, tuple):
                name, fn, args, outs = item
                with tr.device_span(f"host_sync:{name}") as sp:
                    new = fn(*args)
                    for o, n in zip(_as_tuple(outs), _as_tuple(new)):
                        o.copy_(n)
                    sp.sync(outs)
            else:
                with tr.device_span("step_graph", index=k) as sp:
                    item.replay()
                    sp.sync(self._outputs)
                k += 1
        self.replays += 1

    # --------------------------------------------------------- internals
    def _begin(self) -> None:
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        self._graph = torch.cuda.CUDAGraph()
        self._stream_ctx = torch.cuda.stream(self.stream)
        self._stream_ctx.__enter__()
        # thread_local: a sync from this thread breaks the capture, work
        # of other threads (a service's warming thread) does not
        self._graph.capture_begin(pool=self.pool,
                                  capture_error_mode="thread_local")

    def _end(self) -> None:
        g, self._graph = self._graph, None
        try:
            g.capture_end()
        finally:
            self._stream_ctx.__exit__(None, None, None)
            self._stream_ctx = None
        self._tape.append(g)
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        g.replay()

    def _split(self, name: str, fn, args):
        """End the graph at a host sync, run it, begin the next graph.

        The tensor arguments are copied into buffers of this host sync's
        signature (its name, the argument's position, shape and dtype)
        by the graph that ends here, ``fn`` reads those, its results are
        copied into result buffers of the same kind, and the caller gets
        copies of them made by the next graph.  Host syncs of one
        signature share their buffers — each is read before the next
        such sync writes it — so the buffers that outlive the capture
        are one set per signature, not one per call: the step's other
        tensors stay in the graphs' pool, free to be reused as in an
        eager step.
        """
        ins = tuple(self._buffer(("in", name, i), a).copy_(a)
                    if isinstance(a, torch.Tensor) else a
                    for i, a in enumerate(args))
        self._end()
        new = fn(*ins)
        outs = tuple(self._buffer(("out", name, i), t).copy_(t)
                     for i, t in enumerate(_as_tuple(new)))
        self._tape.append((name, fn, ins, outs))
        self._begin()
        res = tuple(o.clone() for o in outs)
        return res if isinstance(new, (tuple, list)) else res[0]

    def _buffer(self, key: tuple, like: torch.Tensor) -> torch.Tensor:
        key = key + (tuple(like.shape), like.dtype)
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = torch.empty(
                like.shape, dtype=like.dtype, device=like.device)
        return buf

    def _abort(self) -> None:
        """End a capture that failed, so the stream leaves capture mode."""
        if self._graph is not None:
            try:
                self._graph.capture_end()
            except RuntimeError:        # the capture is invalid already
                pass
            self._graph = None
        if self._stream_ctx is not None:
            self._stream_ctx.__exit__(None, None, None)
            self._stream_ctx = None
        self._tape.clear()
        self._buffers.clear()


def _as_tuple(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)
