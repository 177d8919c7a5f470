"""The traced run: a ``torch.profiler`` window reduced to what the
per-layer readers and the result line need.

Device time comes only from the device's own trace (CUPTI through the
profiler): kernel, copy and fill intervals, matched to the port's kernels
by name (:func:`portbench.roofline.kernel_of`).  Host-clock spans are
never read as device time.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from .roofline import kernel_of


@dataclasses.dataclass
class Trace:
    """A traced window, reduced."""

    window_s: float                       # host clock, start to the sync
    busy_s: float                         # union of device intervals
    ops: list[tuple[str, float, float]]   # (name, start_s, end_s), device
    host: list[tuple[str, float, float]]  # top-level host events
    by_kernel: dict[str, float]           # seconds by port kernel
    calls: dict[str, int]                 # launches by port kernel

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps, each named by the host event that covers most of it."""
        tot: dict[str, float] = {}
        for name, a, b in self.ops:
            tot[name] = tot.get(name, 0.0) + (b - a)
        ops = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        merged = _union(self.ops)
        edges = [0.0] + [x for iv in merged for x in iv] + [self.window_s]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((a, b))
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        named = [[self._host_during(a, b), b - a] for a, b in gaps[:top]]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": named}

    def _host_during(self, a: float, b: float) -> str:
        best, cover = "host idle", 0.0
        for name, s, e in self.host:
            c = min(b, e) - max(a, s)
            if c > cover:
                best, cover = name, c
        return best


def _union(ivs) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for _, a, b in sorted(ivs, key=lambda t: t[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Tracer:
    """Wraps a measured window in the profiler when tracing is on; a
    no-op otherwise.  ``start()`` and ``stop()`` bound the window; after
    it, ``result`` holds the :class:`Trace` (or None)."""

    def __init__(self, on: bool, device):
        self.on = bool(on)
        self.device = torch.device(device)
        self.result: Trace | None = None
        self._prof = None
        self._t0 = None

    def start(self) -> None:
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        """Waits for the device, closes the window and reduces it."""
        if self._prof is None or self._t0 is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window = time.perf_counter() - self._t0
        self._t0 = None
        self._prof.__exit__(None, None, None)
        self.result = reduce_profile(self._prof, window)

    def export(self, path) -> None:
        """Write the chrome trace of the window (``chrome://tracing``)."""
        if self._prof is not None and self.result is not None:
            self._prof.export_chrome_trace(str(path))


def reduce_profile(prof, window_s: float) -> Trace:
    """Device intervals and top-level host events of a profile, in
    seconds from the first host event of the window."""
    evs = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in evs:
        tr = e.time_range
        if e.device_type == cuda:
            dev.append((e.name, tr.start, tr.end))
        elif e.cpu_parent is None:
            host.append((e.name, tr.start, tr.end))
    t0 = min([s for _, s, _ in host] + [s for _, s, _ in dev], default=0.0)
    ops = [(n, (s - t0) * 1e-6, (e - t0) * 1e-6) for n, s, e in dev]
    hosts = [(n, (s - t0) * 1e-6, (e - t0) * 1e-6) for n, s, e in host]
    busy = sum(b - a for a, b in _union(ops))
    by_kernel: dict[str, float] = {}
    calls: dict[str, int] = {}
    for name, a, b in ops:
        k = kernel_of(name)
        if k is not None:
            by_kernel[k] = by_kernel.get(k, 0.0) + (b - a)
            calls[k] = calls.get(k, 0) + 1
    return Trace(window_s=window_s, busy_s=busy, ops=ops, host=hosts,
                 by_kernel=by_kernel, calls=calls)
