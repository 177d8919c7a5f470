"""repro_torch.obs: tracer, metrics registry and the port's instrumentation.

Mirrors ``tests/test_obs.py`` for the port's copies:

* disabled tracing is free — ``span()`` returns a shared no-op singleton;
* enabled spans nest per thread with correct depth/parent, and the
  Chrome-trace export is valid, Perfetto-shaped JSON;
* ``timed_call`` and ``Span.sync`` synchronize the CUDA devices of their
  value before the clock stops (a no-op for CPU tensors);
* percentile/reservoir math is safe on empty and single-sample windows,
  and ``ServiceMetrics`` storage is bounded;
* the registry's probes expose the port's counters;
* traced plan execution returns the same values as untraced execution,
  and its per-stage span names and order equal the reference's for the
  same spec, domains and grid.

The threads test holds every thread inside its spans at once (a
``threading.Barrier``), so no thread ident can be reused by a later
thread.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
from repro.obs.trace import get_tracer as ref_get_tracer
import repro_torch.core as T
from repro_torch.obs import trace as trace_mod
from repro_torch.obs.metrics import (MetricsRegistry, Reservoir,
                                     diff_snapshot, global_metrics,
                                     percentile, register_weak_probe)
from repro_torch.obs.trace import (NOOP_SPAN, Tracer, drain, get_tracer,
                                   timed_call)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    CPU thread pool would oversubscribe the cores the other workers'
    timing-sensitive tests share.  These tests are small: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _quiet_global_tracers():
    """Tests drive the global tracers explicitly; leave them off after."""
    yield
    for tr in (get_tracer(), ref_get_tracer()):
        tr.disable()
        tr.clear()


def _cx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ------------------------------------------------------------------ tracer
def test_disabled_span_is_shared_noop_singleton():
    tr = Tracer()
    assert not tr.enabled
    assert tr.span("a") is tr.span("b") is NOOP_SPAN
    with tr.span("outer", key=1) as sp:
        assert sp.sync(42) == 42         # passthrough, no recording
        sp.set(more=2)
    tr.event("e", 0.0, 1.0)
    tr.instant("i")
    assert tr.events() == []


def test_disabled_overhead_no_allocation():
    tr = Tracer()
    spans = [tr.span(f"s{i}") for i in range(100)]
    assert all(s is NOOP_SPAN for s in spans)


def test_spans_nest_with_depth_and_parent():
    tr = Tracer().enable(sync=False)
    with tr.span("outer"):
        with tr.span("inner"):
            with tr.span("leaf", tag="x"):
                pass
    evs = {e["name"]: e for e in tr.events()}
    assert evs["outer"]["depth"] == 0 and evs["outer"]["parent"] is None
    assert evs["inner"]["depth"] == 1 and evs["inner"]["parent"] == "outer"
    assert evs["leaf"]["depth"] == 2 and evs["leaf"]["parent"] == "inner"
    assert evs["leaf"]["attrs"] == {"tag": "x"}
    assert all(e["t1"] >= e["t0"] for e in tr.events())


def test_threads_nest_independently():
    """Four threads inside their spans at the same moment: each inner span
    nests under its own thread's outer span, and each thread records on
    its own track (the barrier keeps all four alive together, so their
    idents are distinct)."""
    tr = Tracer().enable(sync=False)
    nthreads = 4
    inside = threading.Barrier(nthreads, timeout=10)
    errs = []

    def work(i):
        try:
            with tr.span(f"outer{i}"):
                with tr.span(f"inner{i}"):
                    inside.wait()
        except Exception as e:            # pragma: no cover - diagnostics
            errs.append(e)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not errs and not any(t.is_alive() for t in threads)
    evs = tr.events()
    assert len(evs) == 2 * nthreads
    for i in range(nthreads):
        inner = next(e for e in evs if e["name"] == f"inner{i}")
        outer = next(e for e in evs if e["name"] == f"outer{i}")
        assert inner["depth"] == 1 and inner["parent"] == f"outer{i}"
        assert outer["depth"] == 0 and inner["tid"] == outer["tid"]
    assert len({e["tid"] for e in evs}) == nthreads
    tids = {e["tid"] for e in tr.to_chrome()["traceEvents"]
            if e["ph"] == "X"}
    assert tids == set(range(nthreads))


def test_ring_buffer_bounds_and_dropped_counter():
    tr = Tracer(max_events=4).enable(sync=False)
    for i in range(10):
        tr.instant(f"m{i}")
    assert len(tr.events()) == 4
    assert tr.dropped == 6
    assert [e["name"] for e in tr.events()] == ["m6", "m7", "m8", "m9"]


def test_chrome_export_is_valid_perfetto_json(tmp_path):
    tr = Tracer().enable(sync=False)
    with tr.span("outer", bytes=8192, value=torch.tensor(3)):
        with tr.span("inner"):
            pass
    path = tr.export_chrome(str(tmp_path / "trace.json"))
    with open(path) as f:
        d = json.load(f)                   # round-trips as strict JSON
    assert d["displayTimeUnit"] == "ms"
    evs = [e for e in d["traceEvents"] if e.get("ph") == "X"]
    meta = [e for e in d["traceEvents"] if e.get("ph") == "M"]
    assert meta and meta[0]["name"] == "thread_name"
    assert {e["name"] for e in evs} == {"outer", "inner"}
    for e in evs:
        assert e["ts"] >= 0 and e["dur"] >= 0
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
    inner = next(e for e in evs if e["name"] == "inner")
    outer = next(e for e in evs if e["name"] == "outer")
    assert inner["args"]["parent"] == "outer"
    assert outer["args"]["bytes"] == 8192
    assert outer["args"]["value"] == 3     # a torch scalar, serialized
    assert inner["tid"] == outer["tid"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert d["otherData"]["dropped_events"] == 0


def test_summary_rollup():
    tr = Tracer().enable(sync=False)
    for _ in range(3):
        with tr.span("a"):
            pass
    with tr.span("b"):
        pass
    s = tr.summary()
    assert s["a"]["count"] == 3 and s["b"]["count"] == 1
    assert s["a"]["total_ms"] >= 0.0


# ------------------------------------------------- wall-clock honesty audit
@pytest.fixture
def slow_cuda_sync(monkeypatch):
    """A stand-in CUDA device whose synchronize takes a visible time: a
    clock that stops before the synchronize reads ~0, the honest one
    reads >= the delay."""
    calls = []

    def fake_devices(value):
        return {torch.device("cuda", 0)} if value == "on-cuda" else set()

    def fake_sync(dev):
        calls.append(dev)
        time.sleep(0.05)

    monkeypatch.setattr(trace_mod, "_cuda_devices", fake_devices)
    monkeypatch.setattr(torch.cuda, "synchronize", fake_sync)
    return calls


def test_timed_call_synchronizes_before_stopping_clock(slow_cuda_sync):
    out, seconds = timed_call(lambda: "on-cuda")
    assert out == "on-cuda" and slow_cuda_sync == [torch.device("cuda", 0)]
    assert seconds >= 0.05, (
        f"timed_call stopped the clock after {seconds * 1e3:.1f} ms — it "
        "measured the launch, not the execution")


def test_span_sync_synchronizes_at_exit(slow_cuda_sync):
    tr = Tracer().enable(sync=True)
    with tr.span("work") as sp:
        sp.sync("on-cuda")
    (ev,) = tr.events()
    assert ev["t1"] - ev["t0"] >= 0.05
    # sync off: the mark is ignored
    tr = Tracer().enable(sync=False)
    with tr.span("work") as sp:
        sp.sync("on-cuda")
    assert len(slow_cuda_sync) == 1


def test_drain_finds_nothing_to_synchronize_on_cpu(monkeypatch):
    def forbidden(dev):                    # pragma: no cover - the failure
        raise AssertionError("synchronize called for a CPU value")

    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    x = torch.ones(3)
    assert drain(x) is x
    assert drain({"a": [x, (x, 1)], "b": None})["b"] is None
    assert trace_mod._cuda_devices([x, {"k": x}]) == set()


# ----------------------------------------------------------------- metrics
def test_percentile_empty_and_single_sample():
    assert percentile([], 99) == 0.0
    assert percentile([7.0], 50) == 7.0
    assert percentile([7.0], 99) == 7.0
    assert percentile([1.0, 3.0], 50) == pytest.approx(2.0)
    xs = list(np.random.default_rng(0).standard_normal(101))
    assert percentile(xs, 50) == pytest.approx(
        float(np.percentile(np.asarray(xs), 50)))
    assert percentile(xs, 99) == pytest.approx(
        float(np.percentile(np.asarray(xs), 99)))


def test_reservoir_bounds_window_keeps_alltime_count():
    r = Reservoir(maxlen=4)
    for i in range(10):
        r.record(float(i))
    assert len(r) == 4
    assert r.count == 10
    assert r.values() == [6.0, 7.0, 8.0, 9.0]


def test_registry_instruments_and_snapshot():
    m = MetricsRegistry()
    m.counter("c").inc()
    m.counter("c").inc(2)
    m.gauge("g").set(1.5)
    for v in (1.0, 2.0, 3.0):
        m.histogram("h").record(v)
    m.register_probe("t", lambda: {"x": torch.tensor(2.5)})
    snap = m.snapshot()
    assert snap["counters"]["c"] == 3
    assert snap["gauges"]["g"] == 1.5
    assert snap["histograms"]["h"]["count"] == 3
    assert snap["histograms"]["h"]["p50"] == pytest.approx(2.0)
    assert snap["t"] == {"x": 2.5}         # torch scalars become floats
    json.dumps(snap)


def test_probe_errors_are_contained():
    m = MetricsRegistry()

    def bad():
        raise RuntimeError("boom")

    m.register_probe("bad", bad)
    m.register_probe("good", lambda: {"x": 1})
    snap = m.snapshot()
    assert snap["good"] == {"x": 1}
    assert "error" in snap["bad"]


def test_diff_snapshot_numeric_leaves():
    before = {"counters": {"c": 3}, "nested": {"a": 1.0, "s": "x"}}
    after = {"counters": {"c": 10}, "nested": {"a": 4.0, "s": "y"},
             "new": {"k": 2}}
    d = diff_snapshot(before, after)
    assert d["counters"]["c"] == 7
    assert d["nested"]["a"] == pytest.approx(3.0)
    assert d["nested"]["s"] == "y"
    assert d["new"]["k"] == 2


def test_weak_probe_dies_with_object():
    m = MetricsRegistry()

    class Obj:
        def summary(self):
            return {"alive": True}

    o = Obj()
    register_weak_probe(m, "obj", o)
    assert m.snapshot()["obj"] == {"alive": True}
    del o
    import gc
    gc.collect()
    assert "obj" not in m.snapshot()


# --------------------------------------------------- the port's probes
def test_global_registry_carries_the_ports_probes():
    from repro_torch.core import cache, plan  # noqa: F401
    from repro_torch.dft import hamiltonian  # noqa: F401
    from repro_torch.kernels import sphere_pack  # noqa: F401
    snap = global_metrics().snapshot()
    assert {"executions", "searches"} <= set(snap["fftb"])
    assert {"hits", "misses", "builds", "build_seconds"} <= \
        set(snap["plan_cache"])
    assert "per_k_linalg_calls" in snap["dft"]
    assert set(snap["sphere_pack"]) == {
        "unpack_dft", "dft_pack", "unpack_factored", "unpack_dense",
        "pack_factored", "pack_dense"}


def test_plan_cache_instrumentation():
    """Build accounting, the build-time histogram, and hit/miss/evict
    instants with a ``plan_build`` span around the builder."""
    c = T.PlanCache(maxsize=1)
    hist = global_metrics().histogram("plan_cache.build_ms")
    n0 = hist.count
    tr = get_tracer().enable(sync=False)
    c.get_or_build("k", lambda: object())
    c.get_or_build("k", lambda: object())
    c.get_or_build("k2", lambda: object())      # evicts "k"
    tr.disable()
    s = c.stats
    assert s["builds"] == 2 and s["build_seconds"] >= 0.0
    assert s["hits"] == 1 and s["misses"] == 2 and s["evictions"] == 1
    assert hist.count == n0 + 2
    names = [e["name"] for e in tr.events()]
    assert names.count("plan_cache.miss") == 2
    assert names.count("plan_cache.hit") == 1
    assert names.count("plan_cache.evict") == 1
    assert names.count("plan_build") == 2
    c.clear()
    assert c.stats["builds"] == 0


def test_fused_calls_counted_in_sphere_pack_probe():
    from repro_torch.kernels import sphere_pack
    g = T.ProcGrid.create([1], device="cpu")
    inv, fwd = T.make_planewave_pair(g, 8, T.kpoint_sphere(4), 2,
                                     backend="cuda")
    before = dict(sphere_pack.DISPATCHES)
    rng = np.random.default_rng(2)
    c = torch.as_tensor(_cx(rng, (2, inv.sphere.npacked)))
    out = fwd.transform_pack(inv.unpack_transform(c))
    assert tuple(out.shape) == (2, inv.sphere.npacked)
    assert sphere_pack.DISPATCHES["unpack_dft"] == before["unpack_dft"] + 1
    assert sphere_pack.DISPATCHES["dft_pack"] == before["dft_pack"] + 1
    assert global_metrics().snapshot()["sphere_pack"] == {
        **sphere_pack.DISPATCHES, **sphere_pack.MODES}


# ------------------------------------------------------- traced == untraced
def _stage_names(events):
    """Stage span names (children of a ``plan:`` span), in start order."""
    stages = [e for e in events
              if (e["parent"] or "").startswith("plan:")]
    return [e["name"] for e in sorted(stages, key=lambda e: e["t0"])]


def test_traced_plan_execution_matches_untraced():
    tr = get_tracer()
    g = T.ProcGrid.create([1], device="cpu")
    dom = T.Domain((0, 0, 0), (7, 7, 7))
    fx = T.fftb("x{0} y z -> X Y Z{0}", domains=dom, grid=g,
                sizes=(8, 8, 8))
    rng = np.random.default_rng(3)
    x = torch.as_tensor(_cx(rng, (8, 8, 8)))
    ref = fx(x)
    execs = T.FftPlan.executions
    tr.enable(sync=True, per_stage=True)
    traced = fx(x)
    tr.disable()
    assert T.FftPlan.executions == execs + 1
    np.testing.assert_allclose(traced.numpy(), ref.numpy(), atol=1e-5)
    names = {e["name"] for e in tr.events()}
    assert "plan:fft3d" in names
    assert any(n.startswith(("dft[", "idft[")) for n in names)
    stage = next(e for e in tr.events()
                 if e["name"].startswith(("dft[", "idft[", "a2a[")))
    assert stage["parent"].startswith("plan:")
    assert stage["attrs"]["backend"] == "matmul"
    # per_stage off: the plan span alone
    tr.enable(sync=True, per_stage=False)
    fx(x)
    tr.disable()
    assert [e["name"] for e in tr.events()] == ["plan:fft3d"]


@pytest.mark.parametrize("case", ["cube", "planewave", "planewave_2axis"])
def test_stage_span_names_equal_reference(case):
    """Both tracers on the same spec, domains and grid: the per-stage
    span names and their order must be the reference's, and so must the
    enclosing transform-level spans."""
    if case == "cube":
        spec, sizes, axes = "x{0} y z -> X Y Z{0}", (8, 8, 8), [1]
        doms = (T.Domain((0, 0, 0), (7, 7, 7)),)
        rdoms = (R.Domain((0, 0, 0), (7, 7, 7)),)
        shape = (8, 8, 8)
    else:
        spec = ("b x{0} y z -> b X Y Z{0}" if case == "planewave"
                else "b{0} x{1} y z -> b{0} X Y Z{1}")
        axes = [1] if case == "planewave" else [1, 1]
        sizes = (16, 16, 16)
        doms = (T.Domain((0,), (2,)), T.kpoint_sphere(8))
        rdoms = (R.Domain((0,), (2,)), R.kpoint_sphere(8))
        shape = (3, 8, 8, 8)
    rng = np.random.default_rng(5)
    x = _cx(rng, shape)
    plan = T.fftb(spec, domains=doms, grid=T.ProcGrid.create(
        axes, device="cpu"), sizes=sizes, inverse=True)
    rplan = R.fftb(spec, domains=rdoms, grid=R.ProcGrid.create(axes),
                   sizes=sizes, inverse=True)
    tr, rtr = get_tracer(), ref_get_tracer()
    tr.enable(sync=True, per_stage=True)
    y = plan(torch.as_tensor(x))
    tr.disable()
    rtr.enable(sync=True, per_stage=True)
    ry = rplan(jnp.asarray(x))
    rtr.disable()
    names, rnames = _stage_names(tr.events()), _stage_names(rtr.events())
    assert names == rnames and len(names) == len(plan.stages) >= 3
    top = sorted(e["name"] for e in tr.events() if e["depth"] == 0)
    rtop = sorted(e["name"] for e in rtr.events() if e["depth"] == 0)
    assert top == rtop
    got, want = y.numpy(), np.asarray(ry)
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


def test_scf_iteration_records_and_spans():
    from repro_torch.dft import SCFConfig, run_scf
    tr = get_tracer().enable(sync=False, per_stage=False)
    cfg = SCFConfig(n=8, nbands=2, kpts=((0, 0, 0), (0.5, 0.5, 0.5)),
                    max_iter=3, e_tol=0.0, r_tol=0.0, stack_k=True)
    res = run_scf(cfg, device="cpu")
    tr.disable()
    recs = res.iteration_records
    assert len(recs) == res.iterations == 3
    for i, r in enumerate(recs):
        assert r["iteration"] == i
        assert r["seconds"] >= 0.0 and r["transforms"] > 0
        assert np.isfinite(r["energy"]) and np.isfinite(r["residual"])
    assert sum(r["transforms"] for r in recs) == res.transforms
    evs = tr.events()
    its = [e for e in evs if e["name"] == "scf_iteration"]
    assert [e["attrs"]["iteration"] for e in its] == [0, 1, 2]
    assert all(e["attrs"]["route"] == "stacked" for e in its)
    bands = [e for e in evs if e["name"] == "band_update"]
    assert len(bands) == 3 and all(e["parent"] == "scf_iteration"
                                   for e in bands)
    assert any(e["name"] == "stacked_planewave" for e in evs)


def test_service_metrics_bounded_storage():
    from repro_torch.serve.metrics import ServiceMetrics
    m = ServiceMetrics(max_samples=8)
    for i in range(100):
        m.record_request("t", latency_s=i * 1e-3, nbands=1,
                         queue_wait_s=i * 1e-4)
    m.record_dispatch(2, 2, 0.25)
    m.record_dispatch(1, 1, 0.75)
    for _ in range(50):
        m.record_dispatch(1, 1, 0.0)
    s = m.summary()
    assert s["requests"] == 100
    assert s["per_tenant"]["t"]["requests"] == 100
    assert len(m._lat["t"]) == 8
    assert s["padding_fraction_max"] == 0.75
    assert s["queue_wait_p99_ms"] > 0.0
    e = ServiceMetrics()
    se = e.summary()
    assert se["latency_p99_ms"] == 0.0 and se["padding_fraction_max"] == 0.0
    e.record_request("x", 0.002, 1)
    assert e.summary()["latency_p50_ms"] == pytest.approx(2.0)


def test_summary_keys_equal_reference():
    from repro.serve.metrics import ServiceMetrics as RefMetrics
    from repro_torch.serve.metrics import ServiceMetrics
    a, b = ServiceMetrics(T.PlanCache()), RefMetrics(R.PlanCache())
    for m in (a, b):
        m.record_request("t", 0.001, 2, queue_wait_s=0.0005)
        m.record_dispatch(1, 2, 0.1)
    sa, sb = a.summary(), b.summary()
    assert set(sa) == set(sb)
    assert set(sa["plan_cache"]) == set(sb["plan_cache"])
    assert set(sa["per_tenant"]["t"]) == set(sb["per_tenant"]["t"])
