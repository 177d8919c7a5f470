"""repro_torch.serve: the multi-tenant transform service on the CPU.

Mirrors ``tests/test_transform_service.py`` (its 4-device test is
``tests/test_torch_dist_serve.py``'s, over four processes).  A
mixed-workload trace served concurrently must equal per-request eager
dispatch and the reference service's ``eager_apply`` on the same numpy
arrays — at a tolerance, not bitwise (the reference's own bitwise claim
fails in the reference):
rel. 1e-5 of the result's max.  Coalesced requests share one stacked
dispatch (two ``FftPlan.executions``); realized padding stays within the
configured budget; deadlines expire as errors, never hangs.

Every wait has a timeout and no sleep is longer than 0.1 s.
"""
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as R
from repro.serve import TransformService as RefTransformService
from repro_torch.core import (FftPlan, PlanCache, ProcGrid,
                              global_plan_cache, kpoint_sphere)
from repro_torch.serve import (DeadlineExceeded, QueueFull, ServiceStopped,
                               TransformService)

N = 16
D = 8
RTOL = 1e-5          # relative to the result's largest magnitude


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    CPU thread pool would oversubscribe the cores the other workers'
    timing-sensitive tests share.  These tests are small: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def g1():
    return ProcGrid.create([1], device="cpu")


@pytest.fixture()
def svc(g1):
    global_plan_cache().clear()
    return TransformService(g1, N, padding_budget=0.5, max_rows=8,
                            warm_async=False)


def _coeffs(rng, nbands, sphere):
    return (rng.standard_normal((nbands, sphere.npacked))
            + 1j * rng.standard_normal((nbands, sphere.npacked))
            ).astype(np.complex64)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


SPH_G = kpoint_sphere(D)                       # gamma point, cutoff d=8
SPH_K = kpoint_sphere(D, (0.5, 0.5, 0.5))      # k-shifted, same cutoff
SPH_S = kpoint_sphere(6)                       # smaller cutoff — other class
REF_SPHERES = {id(SPH_G): R.kpoint_sphere(D),
               id(SPH_K): R.kpoint_sphere(D, (0.5, 0.5, 0.5)),
               id(SPH_S): R.kpoint_sphere(6)}


# --------------------------------------------------------------- coalescing
def test_mixed_trace_matches_eager_and_reference(svc):
    """3 tenants × 2 sphere shapes, concurrent submits (numpy and torch
    inputs): every result equals the port's eager dispatch and the
    reference service's eager dispatch to rel. 1e-5."""
    rng = np.random.default_rng(0)
    veff = rng.standard_normal((N,) * 3).astype(np.float32)
    work = [("t0", _coeffs(rng, 2, SPH_G), SPH_G, veff),
            ("t1", _coeffs(rng, 2, SPH_K), SPH_K, None),
            ("t2", _coeffs(rng, 1, SPH_S), SPH_S, veff),
            ("t0", _coeffs(rng, 3, SPH_K), SPH_K, None),
            ("t2", _coeffs(rng, 2, SPH_S), SPH_S, None)]
    handles = [None] * len(work)

    def submit(i):
        t, c, s, v = work[i]
        if i % 2:                                 # tensors ride too
            c = torch.as_tensor(c)
            v = None if v is None else torch.as_tensor(v)
        handles[i] = svc.submit(t, c, s, v_eff=v)

    threads = [threading.Thread(target=submit, args=(i,))
               for i in range(len(work))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    svc.run_until_idle(timeout=60)
    ref = RefTransformService(R.ProcGrid.create([1]), N, padding_budget=0.5,
                              max_rows=8, warm_async=False,
                              cache=R.PlanCache())
    for h, (_, c, s, v) in zip(handles, work):
        out = h.result(5)
        assert isinstance(out, np.ndarray) and out.dtype == np.complex64
        _close(out, svc.eager_apply(c, s, v))
        _close(out, ref.eager_apply(c, REF_SPHERES[id(s)], v))
    m = svc.metrics.summary()
    assert m["requests"] == 5
    assert m["coalesced_dispatches"] >= 1       # the d=8 class coalesced


def test_round_trip_without_potential_returns_input(svc):
    rng = np.random.default_rng(11)
    c = _coeffs(rng, 2, SPH_K)
    h = svc.submit("rt", c, SPH_K)
    svc.run_until_idle(timeout=30)
    _close(h.result(5), c)


def test_coalesced_requests_share_one_stacked_dispatch(svc):
    """3 compatible requests → one dispatch → exactly 2 plan executions."""
    rng = np.random.default_rng(1)
    svc.warm(SPH_G, 6)                          # plans hot before measuring
    hs = [svc.submit(f"t{i}", _coeffs(rng, 2, s), s)
          for i, s in enumerate((SPH_G, SPH_K, SPH_G))]
    before = FftPlan.executions
    assert svc.step() == 3                      # all three in one batch
    assert FftPlan.executions - before == 2     # one inverse + one forward
    for h in hs:
        assert h.done()
    m = svc.metrics.summary()
    assert m["dispatches"] == 1 and m["coalesced_dispatches"] == 1


@pytest.mark.parametrize("with_potential", [False, True])
def test_traced_dispatch_records_its_pieces(svc, with_potential):
    """With the tracer on, one dispatch records a span per piece of
    ``_dispatch`` (the plans record their own), all nested inside the
    ``serve.dispatch`` span, in the order they run."""
    from repro_torch.obs import get_tracer
    rng = np.random.default_rng(5)
    svc.warm(SPH_G, 4)
    v = (rng.standard_normal((N,) * 3).astype(np.float32)
         if with_potential else None)
    for i in range(2):
        svc.submit(f"t{i}", _coeffs(rng, 2, SPH_G), SPH_G, v_eff=v)
    tr = get_tracer().enable(sync=True, per_stage=False)
    try:
        assert svc.step() == 2
    finally:
        tr.disable()
    evs = tr.events()
    tr.clear()
    (d,) = [e for e in evs if e["name"] == "serve.dispatch"]
    kids = sorted((e for e in evs if e["parent"] == "serve.dispatch"),
                  key=lambda e: e["t0"])
    assert all(d["t0"] <= e["t0"] <= e["t1"] <= d["t1"] for e in kids)
    want = (["serve.upload_coeffs"]
            + (["serve.upload_potential"] if with_potential else [])
            + ["serve.unpack_transform"]
            + (["serve.times_v"] if with_potential else [])
            + ["serve.transform_pack", "serve.download"])
    assert [e["name"] for e in kids] == want
    # each plan's own span nests in the piece that runs it
    plans = sorted((e for e in evs if e["name"] == "stacked_planewave"),
                   key=lambda e: e["t0"])
    assert [(e["parent"], e["attrs"]["inverse"]) for e in plans] == [
        ("serve.unpack_transform", True), ("serve.transform_pack", False)]


def test_eager_baseline_two_dispatches_per_request(svc):
    """coalesce=False serves the same 3 requests in 3 dispatches (6
    executions) — what the scheduler saves."""
    rng = np.random.default_rng(2)
    solo = TransformService(svc.grid, N, coalesce=False, warm_async=False)
    solo.warm(SPH_G, 2), solo.warm(SPH_K, 2)
    for i, s in enumerate((SPH_G, SPH_K, SPH_G)):
        solo.submit(f"t{i}", _coeffs(rng, 2, s), s)
    before = FftPlan.executions
    solo.run_until_idle(timeout=30)
    assert FftPlan.executions - before == 6
    assert solo.metrics.summary()["dispatches"] == 3


def test_incompatible_shapes_never_coalesce(svc):
    rng = np.random.default_rng(3)
    svc.submit("a", _coeffs(rng, 2, SPH_G), SPH_G)
    svc.submit("b", _coeffs(rng, 2, SPH_S), SPH_S)
    svc.run_until_idle(timeout=30)
    m = svc.metrics.summary()
    assert m["dispatches"] == 2 and m["coalesced_dispatches"] == 0


# ----------------------------------------------------------- padding budget
@pytest.mark.parametrize("budget,want_dispatches", [(0.05, 2), (0.9, 1)])
def test_padding_within_budget_and_split_when_exceeded(g1, budget,
                                                       want_dispatches):
    """A lean sphere (d=8 bounding box, radius 2) only joins a fat-sphere
    batch when the budget allows; realized padding respects the budget."""
    sph_s2 = type(SPH_G)(radius=2.0, lower=(0, 0, 0), upper=(D - 1,) * 3,
                         center=SPH_G.center)
    rng = np.random.default_rng(4)
    svc = TransformService(g1, N, padding_budget=budget, warm_async=False,
                           cache=PlanCache())
    ha = svc.submit("a", _coeffs(rng, 1, SPH_G), SPH_G)
    hb = svc.submit("b", _coeffs(rng, 1, sph_s2), sph_s2)
    svc.run_until_idle(timeout=30)
    assert ha.done() and hb.done()
    m = svc.metrics.summary()
    assert m["dispatches"] == want_dispatches
    assert m["padding_fraction_max"] <= budget


# ------------------------------------------------------------- robustness
def test_deadline_expires_as_error_not_hang(svc):
    rng = np.random.default_rng(5)
    h = svc.submit("t0", _coeffs(rng, 1, SPH_G), SPH_G, deadline=-0.001)
    svc.step()
    assert h.done()
    with pytest.raises(DeadlineExceeded):
        h.result(1)
    assert svc.metrics.summary()["errors"] == {"deadline": 1}


def test_deadline_spares_requests_still_in_time(svc):
    rng = np.random.default_rng(6)
    late = svc.submit("t0", _coeffs(rng, 1, SPH_G), SPH_G, deadline=-0.001)
    ok = svc.submit("t0", _coeffs(rng, 1, SPH_G), SPH_G, deadline=60.0)
    svc.run_until_idle(timeout=30)
    with pytest.raises(DeadlineExceeded):
        late.result(1)
    assert ok.result(1).shape == (1, SPH_G.npacked)


def test_queue_depth_backpressure(g1):
    svc = TransformService(g1, N, max_queue_per_tenant=2, warm_async=False)
    rng = np.random.default_rng(7)
    for _ in range(2):
        svc.submit("flood", _coeffs(rng, 1, SPH_G), SPH_G)
    with pytest.raises(QueueFull):
        svc.submit("flood", _coeffs(rng, 1, SPH_G), SPH_G)
    svc.submit("calm", _coeffs(rng, 1, SPH_G), SPH_G)
    assert svc.run_until_idle(timeout=30) == 3


def test_round_robin_fairness_across_tenants(svc):
    """With one request per batch the dispatch order interleaves tenants:
    the nice tenant resolves by the second dispatch, floods still queued."""
    rng = np.random.default_rng(8)
    svc.scheduler.max_rows = 1
    order = []
    flood = [svc.submit("flood", _coeffs(rng, 1, SPH_G), SPH_G)
             for _ in range(4)]
    nice = svc.submit("nice", _coeffs(rng, 1, SPH_G), SPH_G)
    t0 = time.perf_counter()
    while len(svc.scheduler) and time.perf_counter() - t0 < 30:
        svc.step()
        done = {id(h) for h in flood + [nice] if h.done()}
        order.append(("nice" if id(nice) in done else "flood", len(done)))
    assert any(t == "nice" and k <= 2 for t, k in order)


def test_stop_fails_pending_requests(g1):
    svc = TransformService(g1, N, warm_async=False)
    rng = np.random.default_rng(9)
    h = svc.submit("t0", _coeffs(rng, 1, SPH_G), SPH_G)
    svc.stop(drain=False, timeout=10)
    with pytest.raises(ServiceStopped):
        h.result(1)
    with pytest.raises(ServiceStopped):
        svc.submit("t0", _coeffs(rng, 1, SPH_G), SPH_G)
    assert svc.metrics.summary()["errors"] == {"stopped": 1}


def test_background_loop_with_async_admission(g1):
    """start()/stop() + warm_async: cold plans build off the loop thread,
    every request still resolves, and the plan cache saw real traffic."""
    cache = PlanCache()
    svc = TransformService(g1, N, cache=cache, warm_async=True)
    rng = np.random.default_rng(10)
    svc.start()
    work = [(f"t{i % 3}", _coeffs(rng, 2, s), s)
            for i, s in enumerate((SPH_G, SPH_K, SPH_G, SPH_K))]
    hs = [svc.submit(t, c, s) for t, c, s in work]
    try:
        for h, (_, c, s) in zip(hs, work):
            out = h.result(60)
            assert out.dtype == np.complex64
            _close(out, c)                       # no potential: round trip
    finally:
        svc.stop(timeout=30)
    assert svc._thread is None
    assert cache.stats["misses"] > 0
    assert svc.metrics.summary()["requests"] == 4


def test_bad_requests_raise_coded_diagnostics(svc):
    from repro_torch.check import DiagnosticError
    rng = np.random.default_rng(12)
    with pytest.raises(DiagnosticError) as exc:
        svc.submit("t", _coeffs(rng, 9, SPH_G), SPH_G)     # > max_rows
    assert exc.value.code == "FFTB122"
    with pytest.raises(ValueError, match="npacked"):
        svc.submit("t", np.zeros((1, 3), np.complex64), SPH_G)
    with pytest.raises(ValueError, match="v_eff shape"):
        svc.submit("t", _coeffs(rng, 1, SPH_G), SPH_G,
                   v_eff=np.zeros((N, N), np.float32))
