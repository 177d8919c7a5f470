"""Runtime lock-order checking for the serving path.

:class:`TrackedLock` wraps a ``threading.Lock``/``RLock`` and, when the
module-global monitor is enabled, records the per-thread held-lock stack
and a global acquired-while-holding order graph.  Two hazards are
detected the moment they are created:

* **FFTB301** — a lock-order cycle: thread A acquires ``x`` then ``y``
  while thread B (ever) acquired ``y`` then ``x``.  Reported when the
  second edge closes the cycle, without needing the actual deadlock to
  strike.
* **FFTB302** — a tracked lock held across a device-dispatch boundary:
  code calls :func:`check_dispatch_hazard` (placed at plan-build and
  service-dispatch sites) while holding any tracked lock, meaning a
  multi-second device operation would run under a lock other threads
  contend on.

Checking follows the observability layer's free-when-disabled pattern:
``_MONITOR`` is ``None`` by default, so the per-acquire overhead is a
single attribute load and ``is None`` test — no allocation, no
thread-local traffic.  Enable it in stress tests / CI with
:func:`enable_lock_checking`.

Violations either raise :class:`LockOrderError` immediately
(``mode="raise"``, the default for tests) or accumulate as
:class:`~repro_torch.check.diagnostics.Diagnostic` records retrievable via
:func:`lock_violations` (``mode="record"``, usable in long-running
services).
"""
from __future__ import annotations

import threading

from .diagnostics import Diagnostic, error

__all__ = [
    "TrackedLock",
    "LockOrderError",
    "enable_lock_checking",
    "disable_lock_checking",
    "check_dispatch_hazard",
    "lock_violations",
]


class LockOrderError(RuntimeError):
    """Raised by the monitor in ``raise`` mode; carries the diagnostic."""

    def __init__(self, diagnostic: Diagnostic):
        self.diagnostic = diagnostic
        super().__init__(diagnostic.render())


class _Monitor:
    """Global lock-order state: order graph + per-thread held stacks."""

    def __init__(self, mode: str = "raise"):
        if mode not in ("raise", "record"):
            raise ValueError(f"bad lock-checking mode {mode!r}")
        self.mode = mode
        self._held = threading.local()
        # edges[a] = {b: "siteinfo"} meaning some thread acquired b while
        # holding a.  Guarded by _graph_lock (a plain lock: the monitor
        # is infrastructure, not a subject of its own analysis).
        self._edges: dict[str, dict[str, str]] = {}
        self._graph_lock = threading.Lock()
        self.violations: list[Diagnostic] = []

    # -- per-thread held stack ------------------------------------------
    def _stack(self) -> list[str]:
        st = getattr(self._held, "stack", None)
        if st is None:
            st = []
            self._held.stack = st
        return st

    # -- events ---------------------------------------------------------
    def on_acquire(self, name: str, *, reentrant: bool) -> None:
        stack = self._stack()
        if reentrant and name in stack:
            # RLock re-entry by the same thread: no new ordering edge.
            stack.append(name)
            return
        holder = stack[-1] if stack else None
        stack.append(name)
        if holder is None or holder == name:
            return
        with self._graph_lock:
            self._edges.setdefault(holder, {})[name] = (
                f"thread {threading.current_thread().name}")
            cycle = self._find_cycle(name, holder)
        if cycle:
            self._report(error(
                "FFTB301",
                "lock-order cycle: " + " -> ".join(cycle),
                location=f"acquiring {name!r} while holding {holder!r}",
                hint="acquire these locks in one global order, or drop "
                     "the outer lock before taking the inner one",
            ))

    def on_release(self, name: str) -> None:
        stack = self._stack()
        # Release in LIFO discipline is the common case; tolerate
        # out-of-order release (remove the innermost matching entry).
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    def on_dispatch(self, tag: str) -> None:
        stack = self._stack()
        if stack:
            self._report(error(
                "FFTB302",
                f"device dispatch {tag!r} while holding lock(s) "
                f"{stack!r}",
                location=tag,
                hint="release the lock before building/dispatching; "
                     "PlanCache runs builders outside its lock for "
                     "exactly this reason",
            ))

    # -- graph ----------------------------------------------------------
    def _find_cycle(self, start: str, target: str):
        """Path start -> ... -> target in the edge graph (DFS), if any.

        Called with the new edge target->start already inserted, so a
        path start ->* target closes a cycle.  Caller holds _graph_lock.
        """
        seen = set()
        path = [start]

        def dfs(node: str):
            if node == target:
                return True
            seen.add(node)
            for nxt in self._edges.get(node, ()):
                if nxt in seen:
                    continue
                path.append(nxt)
                if dfs(nxt):
                    return True
                path.pop()
            return False

        if dfs(start):
            return [target, *path, target]
        return None

    def _report(self, diag: Diagnostic) -> None:
        self.violations.append(diag)
        if self.mode == "raise":
            raise LockOrderError(diag)


#: None when checking is disabled — the fast-path cost of TrackedLock is
#: then one global load and an `is None` test per acquire/release.
_MONITOR: _Monitor | None = None


def enable_lock_checking(mode: str = "raise") -> None:
    """Turn on lock-order checking process-wide (fresh state)."""
    global _MONITOR
    _MONITOR = _Monitor(mode)


def disable_lock_checking() -> None:
    global _MONITOR
    _MONITOR = None


def lock_violations() -> list[Diagnostic]:
    """Diagnostics recorded so far (``record`` mode); empty if disabled."""
    if _MONITOR is None:
        return []
    return list(_MONITOR.violations)


def check_dispatch_hazard(tag: str) -> None:
    """Assert no tracked lock is held at a device-dispatch boundary.

    Place this where multi-second device work starts (plan builds,
    batched dispatch).  Free when checking is disabled.
    """
    if _MONITOR is not None:
        _MONITOR.on_dispatch(tag)


class TrackedLock:
    """Drop-in ``threading.Lock``/``RLock`` that reports to the monitor.

    ``TrackedLock("plan_cache")`` is a plain lock;
    ``TrackedLock("plan_cache", reentrant=True)`` wraps an ``RLock``.
    Supports the context-manager protocol plus explicit
    ``acquire``/``release`` and ``locked`` like the stdlib types.
    """

    __slots__ = ("name", "reentrant", "_lock")

    def __init__(self, name: str, *, reentrant: bool = False):
        self.name = name
        self.reentrant = reentrant
        self._lock = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        mon = _MONITOR
        if mon is not None:
            # Record intent before blocking: the edge (held -> this)
            # exists whether or not we end up waiting.
            try:
                mon.on_acquire(self.name, reentrant=self.reentrant)
            except LockOrderError:
                mon.on_release(self.name)
                raise
        ok = self._lock.acquire(blocking, timeout)
        if not ok and mon is not None:
            mon.on_release(self.name)
        return ok

    def release(self) -> None:
        self._lock.release()
        mon = _MONITOR
        if mon is not None:
            mon.on_release(self.name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        lk = self._lock
        if hasattr(lk, "locked"):
            return lk.locked()
        # RLock pre-3.14 has no locked().  A non-blocking probe succeeds
        # when *this* thread owns the lock (reentrancy), so check
        # ownership first, then probe for other-thread holders.
        if getattr(lk, "_is_owned", lambda: False)():
            return True
        if lk.acquire(blocking=False):
            lk.release()
            return False
        return True

    def __repr__(self) -> str:
        kind = "RLock" if self.reentrant else "Lock"
        return f"TrackedLock({self.name!r}, {kind})"
