"""Process-global LRU plan cache, eviction weighed by resident bytes.

Schedule search + index-table construction make plan building the expensive
step of every FFTB transform, and SCF code requests the same handful of
transforms over and over.  ``PlanCache`` memoizes built plans behind a
hashable key of (spec, domains, grid, policy, ...) — ``fftb.apply`` /
``fftb.plan_for`` route through the process-global instance so callers never
rebuild a plan for a transform they have already used.

Eviction is LRU on *estimated bytes* (``plan.estimated_bytes()``), not on
entry count: a large-n plane-wave plan pins megabytes of sphere index
tables while a tiny cube plan is nearly free.  ``maxsize`` remains as a hard
entry-count ceiling.  Shared DFT-matrix operand tables
(``plan.shared_table_bytes()``, memoized process-wide by
``local_fft.dft_matrix_device``) are refcounted by their
``(n_out, n_in, inverse)`` key, so ``resident_bytes`` charges each table
once however many cached plans reference it.

Thread-safe.  Builders run outside the lock (they can take seconds), so two
threads racing on the same cold key may both build — the *first* insert
wins, later builders discard their duplicate and return the cached plan
(callers may already hold references to the winner, so it must never be
replaced under them).
"""
from __future__ import annotations

import time
from collections import OrderedDict

from ..check.locks import TrackedLock, check_dispatch_hazard
from ..obs.metrics import global_metrics
from ..obs.trace import get_tracer
from .domain import Domain, SphereDomain
from .grid import ProcGrid

#: fallback cost for objects without ``estimated_bytes`` (test doubles)
_DEFAULT_ENTRY_BYTES = 4096


def _entry_cost(plan) -> tuple[int, tuple]:
    """(private bytes, shared-table items) of a would-be cache entry.

    Private bytes are billed per entry; shared tables are billed through
    the cache's refcounts.  Objects without the Plan accounting protocol
    (test doubles) fall back to a flat private cost.
    """
    try:
        tables = tuple(sorted(plan.shared_table_bytes().items()))
    except AttributeError:
        tables = ()
    try:
        total = int(plan.estimated_bytes())
    except AttributeError:
        return _DEFAULT_ENTRY_BYTES, ()
    return max(total - sum(nb for _, nb in tables), 1), tables


class PlanCache:
    """An LRU mapping from plan keys to built Plan objects."""

    def __init__(self, maxsize: int = 128, max_bytes: int = 1 << 30):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        if max_bytes < 1:
            raise ValueError("max_bytes must be >= 1")
        self.maxsize = maxsize
        self.max_bytes = int(max_bytes)
        # key -> (plan, private_bytes, shared-table items)
        self._data: OrderedDict = OrderedDict()
        # (n_out, n_in, inverse) -> [refcount, nbytes] over cached plans
        self._table_refs: dict = {}
        self._bytes = 0
        self._lock = TrackedLock("plan_cache", reentrant=True)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.builds = 0
        self.build_seconds = 0.0

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._data

    def _add_entry_bytes(self, private: int, tables: tuple) -> None:
        self._bytes += private
        for tk, nb in tables:
            ref = self._table_refs.get(tk)
            if ref is None:
                self._table_refs[tk] = [1, nb]
                self._bytes += nb                # first reference pays
            else:
                ref[0] += 1

    def _drop_entry_bytes(self, private: int, tables: tuple) -> None:
        self._bytes -= private
        for tk, nb in tables:
            ref = self._table_refs[tk]
            ref[0] -= 1
            if ref[0] == 0:                      # last reference frees
                del self._table_refs[tk]
                self._bytes -= nb

    def get_or_build(self, key, builder):
        """Return the cached plan for ``key``, building it on a miss.

        Builders run outside the lock; when two threads race on a cold
        key the first insert wins — the later builder's duplicate is
        discarded (other callers may already hold the winner) and its
        caller is served the cached plan as a hit, not a miss.
        """
        tr = get_tracer()
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                tr.instant("plan_cache.hit")
                return self._data[key][0]
        tr.instant("plan_cache.miss")
        # builders can take seconds (schedule search, table uploads) —
        # holding any lock across one is the hazard the checker hunts
        check_dispatch_hazard("plan_cache.build")
        t0 = time.perf_counter()
        with tr.span("plan_build"):
            plan = builder()
        build_s = time.perf_counter() - t0
        global_metrics().histogram("plan_cache.build_ms").record(
            build_s * 1e3)
        evicted = 0
        with self._lock:
            self.builds += 1
            self.build_seconds += build_s
            won = self._data.get(key)
            if won is not None:                  # lost a build race
                self._data.move_to_end(key)
                self.hits += 1
                return won[0]
            self.misses += 1
            private, tables = _entry_cost(plan)
            self._data[key] = (plan, private, tables)
            self._add_entry_bytes(private, tables)
            # never evict the entry just inserted, even if it alone
            # overflows the byte budget
            while len(self._data) > 1 and (
                    self._bytes > self.max_bytes
                    or len(self._data) > self.maxsize):
                _, (_, priv, tabs) = self._data.popitem(last=False)
                self._drop_entry_bytes(priv, tabs)
                self.evictions += 1
                evicted += 1
        for _ in range(evicted):
            tr.instant("plan_cache.evict")
        return plan

    def peek(self, key):
        """The cached plan for ``key``, or ``None`` — without side effects
        (no hit/miss accounting, no LRU refresh)."""
        with self._lock:
            entry = self._data.get(key)
            return None if entry is None else entry[0]

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._table_refs.clear()
            self._bytes = 0
            self.hits = self.misses = self.evictions = 0
            self.builds = 0
            self.build_seconds = 0.0

    @property
    def resident_bytes(self) -> int:
        """Estimated bytes currently pinned by cached plans."""
        with self._lock:
            return self._bytes

    @property
    def stats(self) -> dict:
        with self._lock:
            return {"size": len(self._data), "maxsize": self.maxsize,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "builds": self.builds,
                    "build_seconds": round(self.build_seconds, 6),
                    "resident_bytes": self._bytes,
                    "max_bytes": self.max_bytes}

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        s = self.stats
        return (f"PlanCache(size={s['size']}/{s['maxsize']}, "
                f"hits={s['hits']}, misses={s['misses']})")


_GLOBAL = PlanCache()

# the cache keeps its own counters; the registry reads them through a
# probe so snapshots see cache behaviour without the cache changing shape
global_metrics().register_probe("plan_cache", lambda: _GLOBAL.stats)


def global_plan_cache() -> PlanCache:
    return _GLOBAL


# ------------------------------------------------------------------ keying
def domain_key(dom: Domain) -> tuple:
    """Hashable identity of a domain.

    SphereDomain's dataclass fields are only the bounding corners, so two
    spheres with equal bounding boxes but different radii would collide —
    include the sphere parameters explicitly.
    """
    if isinstance(dom, SphereDomain):
        return ("sphere", dom.lower, dom.upper, dom.radius, dom.center)
    return ("cuboid", dom.lower, dom.upper)


def domains_key(domains) -> tuple:
    if domains is None:
        return ()
    if isinstance(domains, Domain):
        domains = (domains,)
    return tuple(domain_key(d) for d in domains)


def grid_key(grid: ProcGrid) -> tuple:
    """Hashable identity of a grid: axes, shape, device, its ranks and
    its axis groups.

    The ranks name the grid's process group: plans built over two groups
    of one shape (say ranks 0–1 and 0–2 of a 2×2 world) hold different
    process groups in their moves, so they must not share an entry.  The
    groups' identities keep a plan of a destroyed world (the same ranks
    before ``destroy_process_group`` and a new init) from serving the new
    one; a cached plan holds its grid's groups, so their ids stay unique.
    """
    return (grid.axes, grid.shape, str(grid.device), grid.ranks,
            tuple(id(g) for g in grid.groups))
