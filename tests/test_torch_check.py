"""repro_torch.check against the reference ``repro.check``.

* The preflights give the reference's codes on the same transform,
  basis, service and request inputs (torch tensors are accepted where the
  reference takes numpy arrays), and on every record of
  ``benchmarks/baseline.json``; ``PlaneWaveBasis`` raises them.
* ``fftb.plan_for`` runs the transform preflight on a cache miss, so a
  bad spec, size list or grid raises ``DiagnosticError`` with the
  reference's code before any plan work.
* ``TrackedLock`` reports a lock-order cycle (FFTB301) and a lock held
  across a dispatch boundary (FFTB302); ``PlanCache`` and the service
  hold tracked locks and never build under them.
"""
import json
import pathlib
import threading

import numpy as np
import pytest
import torch

import repro.check as RC
import repro.check.preflight as RP
import repro.core as R
import repro_torch.core as T
import repro.dft.basis as RB
from repro_torch.check import (CODES, DiagnosticError, LockOrderError,
                               TrackedLock, check_dispatch_hazard,
                               disable_lock_checking, enable_lock_checking,
                               lock_violations, preflight, preflight_basis,
                               preflight_config, preflight_request,
                               preflight_scenario, preflight_service,
                               preflight_transform)
from repro_torch.check.preflight import _basis_plan_bytes
from repro_torch.dft.basis import PlaneWaveBasis
from repro_torch.check.diagnostics import error, raise_if_errors, warning


def codes(diags):
    return [d.code for d in diags]


@pytest.fixture(autouse=True)
def _clean_monitor():
    disable_lock_checking()
    yield
    disable_lock_checking()


# ------------------------------------------------------------- Diagnostic
def test_code_registry_equals_reference():
    assert set(CODES) == set(RC.CODES)


def test_diagnostic_error_is_value_error_with_codes():
    e1 = error("FFTB110", "cube width 15 must divide over the fft-axis")
    e2 = error("FFTB112", "nbands 3 not divisible by the batch-axis size 4")
    err = DiagnosticError([e1, e2])
    assert isinstance(err, ValueError) and err.code == "FFTB110"
    assert str(err) == str(RC.DiagnosticError(
        [RC.diagnostics.error("FFTB110", e1.message),
         RC.diagnostics.error("FFTB112", e2.message)]))
    w = warning("FFTB114", "informational")
    assert raise_if_errors([w]) == [w]
    with pytest.raises(ValueError, match="unregistered"):
        error("FFTB999", "nope")


# ------------------------------------------------- preflight vs reference
def _grid(shape, ref):
    return (R if ref else T).ProcGrid.create_abstract(shape)


def _doms(kind, ref):
    M = R if ref else T
    return {"none": None,
            "cube15": M.Domain((0, 0, 0), (14, 14, 14)),
            "cube16": M.Domain((0, 0, 0), (15, 15, 15)),
            "sphere7": M.kpoint_sphere(7),
            "sphere16": M.kpoint_sphere(16),
            "sphere8": M.kpoint_sphere(8)}[kind]


TRANSFORM_CASES = [
    ("x y z", "none", (2,), None),                  # FFTB101: no arrow
    ("x -> x", "none", (2,), None),                 # FFTB101: no fft dim
    ("x{1} y -> X{1} Y", "none", (2,), None),       # FFTB102 twice
    ("x y -> X Y", "sphere8", (2,), None),          # FFTB103: rank
    ("x{0} y z -> X Y Z{0}", "cube16", (2,), (16, 16)),   # FFTB103: sizes
    ("x{0} y z -> X Y Z{0}", "cube15", (2,), None),       # FFTB110 twice
    ("x{0} y z -> X Y Z{0}", "sphere7", (2,), (16, 16, 16)),  # FFTB111
    ("x{0} y z -> X Y Z{0}", "sphere16", (2,), None),     # clean
    ("x{0} y{1} z -> X Y{1} Z{0}", "cube16", (2, 4), None),   # clean
    ("x{0} y{1} z -> X Y{1} Z{0}", "cube15", (2, 4), None),
]


@pytest.mark.parametrize("spec,dom,shape,sizes", TRANSFORM_CASES)
def test_transform_preflight_codes_equal_reference(spec, dom, shape, sizes):
    got = preflight_transform(spec, domains=_doms(dom, False),
                              grid=_grid(shape, False), sizes=sizes)
    want = RP.preflight_transform(spec, domains=_doms(dom, True),
                                  grid=_grid(shape, True), sizes=sizes)
    assert codes(got) == codes(want)
    assert [d.message for d in got] == [d.message for d in want]


SERVICE_CASES = [
    dict(n=15, grid_shape=(4,), diameters=(6, 20)),
    dict(n=16, grid_shape=(2, 2), batch_axes=(0, 1)),
    dict(n=16, grid_shape=(1,), max_rows=0, padding_budget=1.0),
    dict(n=16, grid_shape=(4,), diameters=(8, 4)),
    dict(n=16, grid_shape=(2, 2), batch_axes=(0,), diameters=(3,)),
]


@pytest.mark.parametrize("kw", SERVICE_CASES)
def test_service_preflight_codes_equal_reference(kw):
    assert codes(preflight_service(**kw)) == \
        codes(RP.preflight_service(**kw))


def _coeff_inputs(kind, npacked, as_torch):
    arr = {"ok": np.zeros((2, npacked), np.complex64),
           "shape": np.zeros((2, 3), np.complex64),
           "dtype": np.zeros((2, npacked), np.float32),
           "none": None}[kind]
    if arr is None or not as_torch:
        return arr
    return torch.as_tensor(arr)


@pytest.mark.parametrize("as_torch", [False, True])
@pytest.mark.parametrize("d,fft_procs,max_rows,nbands,coeffs", [
    (6, 4, 2, 5, "none"),          # FFTB111 + FFTB122
    (8, 1, None, None, "shape"),   # FFTB120
    (8, 1, None, None, "dtype"),   # FFTB121
    (8, 2, 8, 2, "ok"),            # clean
    (8, 1, 8, 3, "ok"),            # FFTB120: band count mismatch
])
def test_request_preflight_codes_equal_reference(d, fft_procs, max_rows,
                                                 nbands, coeffs, as_torch):
    sph, rsph = T.kpoint_sphere(d), R.kpoint_sphere(d)
    got = preflight_request(sph, n=16, fft_procs=fft_procs,
                            max_rows=max_rows, nbands=nbands,
                            coeffs=_coeff_inputs(coeffs, sph.npacked,
                                                 as_torch))
    want = RP.preflight_request(rsph, n=16, fft_procs=fft_procs,
                                max_rows=max_rows, nbands=nbands,
                                coeffs=_coeff_inputs(coeffs, rsph.npacked,
                                                     False))
    assert codes(got) == codes(want)


def test_fftb_preflight_routes_spec_and_service_config():
    g = T.ProcGrid.create_abstract([2])
    assert codes(T.fftb.preflight("x y z", grid=g)) == ["FFTB101"]
    cfg = {"n": 16, "d": 8, "d_small": 3, "tenants": 3, "max_rows": 8}
    diags = T.fftb.preflight(cfg, name="serve", grid_shape=(4,))
    assert codes(diags) == codes(RP.preflight_config(
        cfg, name="serve", grid_shape=(4,))) == ["FFTB111"]
    assert diags[0].location.startswith("serve")
    # SCF-basis configs route to the deep basis preflight, as the
    # reference's do
    for scf in ({"n": 16, "diameter": 8}, {"n": 16, "diameter": 0},
                {"n": 15, "diameter": 7, "nbands": 3}):
        assert codes(preflight(scf, grid_shape=(2, 2))) == codes(
            RP.preflight_config(scf, grid_shape=(2, 2)))
    assert codes(preflight({"n": 16, "diameter": 0})) == ["FFTB116"]
    with pytest.raises(TypeError, match="arrow-spec string or a config"):
        preflight(42)


# ------------------------------------------------ basis preflight vs reference
KP3 = [(0, 0, 0), (0.1, 0, 0), (0.2, 0, 0)]
KP4 = KP3 + [(0.3, 0, 0)]

BASIS_CASES = [
    # (n, keywords) — the reference's golden cases, each code in turn
    (15, dict(diameter=7, nbands=3, grid_shape=(2, 2))),     # 112 110 111
    (16, dict(grid_shape=(2, 2), batch_axes=(0, 1))),        # 113
    (16, dict(diameter=0)),                                  # 116
    (16, dict(diameter=17)),                                 # 116
    (16, dict(diameter=8, segment_padding=1.5)),             # 117
    (16, dict(diameter=8, kpts=((0, 0),))),                  # 120
    (16, dict(diameter=8, kpts=((0, 0, 0, 0),))),            # 120
    (16, dict(diameter=8, backend="fftw")),                  # 118
    (16, dict(diameter=8, backend="matmul")),                # clean
    (16, dict(diameter=8, nbands=2, grid_shape=(2, 2), kpts=KP3,
              deep=True)),                                   # 114 warning
    (16, dict(diameter=8, nbands=2, grid_shape=(2, 2), kpts=KP4,
              segment_padding=0.5, deep=True)),              # clean
    (16, dict(diameter=8, nbands=3, grid_shape=(2, 2), kpts=KP3,
              segment_padding=0.5, deep=True)),              # 112
    (16, dict(diameter=8, nbands=4, grid_shape=(4, 1), kpts=KP3,
              segment_padding=0.0, deep=True)),              # clean
    (16, dict(diameter=8, nbands=2, grid_shape=(1,),
              cache_max_bytes=1024, deep=True)),             # 130
    (16, dict(diameter=8, nbands=4, kpts=((0, 0, 0), (0.5, 0.5, 0.5)),
              grid_shape=(2, 2), deep=True)),                # clean
]


@pytest.mark.parametrize("n,kw", BASIS_CASES)
def test_basis_preflight_codes_equal_reference(n, kw):
    got = preflight_basis(n, **kw)
    want = RP.preflight_basis(n, **kw)
    assert codes(got) == codes(want)
    assert [d.severity for d in got] == [d.severity for d in want]
    assert [d.message for d in got] == [d.message for d in want]
    assert [d.location for d in got] == [d.location for d in want]


def test_basis_deep_segment_contract_is_fftb115(monkeypatch):
    """FFTB115 guards the segmenter's size_divisor contract, which
    ``segment_spheres`` itself keeps; a segmenter that broke it (one
    segment of 3 k-points over a batch axis of 2) is reported the same
    way by both packages."""
    import repro.core.planewave as RPW
    import repro_torch.core.planewave as TPW
    for mod in (RPW, TPW):
        monkeypatch.setattr(mod, "segment_spheres",
                            lambda spheres, pad, size_divisor=None: (
                                tuple(range(len(spheres))),))
    kw = dict(diameter=8, nbands=2, grid_shape=(2, 2), kpts=KP3,
              segment_padding=0.5, deep=True)
    got, want = preflight_basis(16, **kw), RP.preflight_basis(16, **kw)
    assert codes(got) == codes(want) == ["FFTB115"]
    assert got[0].message == want[0].message


def test_basis_preflight_covers_every_basis_code():
    seen = {c for n, kw in BASIS_CASES for c in codes(preflight_basis(n,
                                                                      **kw))}
    # FFTB115 has its own test above: no input reaches it through the
    # real segmenter
    assert seen == {"FFTB110", "FFTB111", "FFTB112", "FFTB113", "FFTB114",
                    "FFTB116", "FFTB117", "FFTB118", "FFTB120", "FFTB130"}


def test_basis_plan_bytes_equal_reference():
    sph = [T.kpoint_sphere(8, k) for k in KP4]
    rsph = [R.kpoint_sphere(8, k) for k in KP4]
    segs = ((0, 1), (2, 3))
    assert _basis_plan_bytes(sph, segs, 2, 16, 8) == \
        RP._basis_plan_bytes(rsph, segs, 2, 16, 8)


def test_basis_cuda_backend_over_crossover_is_fftb118():
    # n=4096 exceeds MATMUL_MAX_N: the fused kernels would realize 'fft'
    diags = preflight_basis(4096, diameter=2048, grid_shape=(1,),
                            backend="cuda")
    assert codes(diags) == ["FFTB118"]
    assert "dense-DFT crossover" in diags[0].message
    assert codes(RP.preflight_basis(4096, diameter=2048, grid_shape=(1,),
                                    backend="pallas")) == ["FFTB118"]
    assert preflight_basis(16, diameter=8, nbands=4,
                           kpts=[(0, 0, 0), (0.5, 0.5, 0.5)],
                           grid_shape=(1,), backend="cuda") == []
    # the reference's names are not the port's backends
    for name in ("pallas", "jnp"):
        assert codes(preflight_basis(16, diameter=8, backend=name)) == \
            ["FFTB118"]


def test_basis_cuda_has_no_vmem_rule():
    """The deliberate difference: the reference's VMEM-overflow case is
    an FFTB118 error on "pallas" and clean on "cuda", whose kernels use a
    fixed shared-memory footprint per block whatever the band batch."""
    kw = dict(diameter=64, nbands=64, grid_shape=(1,))
    assert "VMEM budget" in RP.preflight_basis(128, backend="pallas",
                                               **kw)[0].message
    assert preflight_basis(128, backend="cuda", **kw) == []
    assert preflight_basis(128, backend="cuda", deep=True, **kw) == []


def test_preflight_config_routes_backend_to_fftb118():
    cfg = {"n": 16, "diameter": 8, "nbands": 4, "backend": "fftw"}
    assert "FFTB118" in codes(preflight_config(cfg, grid_shape=(1,)))
    assert preflight_config(dict(cfg, backend="cuda"), grid_shape=(1,)) == []


def test_paper_config_is_clean_under_the_default_cache_budget():
    """Deep preflight of the paper's workload (n=256, d=128, 256 bands)
    on one process under the default PlanCache budget: no FFTB130."""
    from repro_torch.configs.fftb_paper import CONFIG
    assert preflight_basis(CONFIG.n, diameter=CONFIG.diameter,
                           nbands=CONFIG.nb, grid_shape=(1,),
                           backend="cuda", deep=True) == []


BASELINE = json.loads((pathlib.Path(__file__).parent.parent / "benchmarks"
                       / "baseline.json").read_text())["scenarios"]


@pytest.mark.parametrize("name", sorted(BASELINE))
def test_baseline_records_equal_reference(name):
    got = preflight_scenario(name, BASELINE[name])
    want = RP.preflight_scenario(name, BASELINE[name])
    assert codes(got) == codes(want) == []
    assert [d.location for d in got] == [d.location for d in want]


def test_scenario_translates_reference_backends_only_there():
    rec = {"grid_shape": [1], "scenario": {"n": 4096, "diameter": 2048,
                                           "backend": "pallas"}}
    assert codes(preflight_scenario("big", rec)) == ["FFTB118"]
    assert "backend 'cuda'" in preflight_scenario("big", rec)[0].message
    assert preflight_scenario("jnp", {"grid_shape": [1], "scenario": {
        "n": 16, "diameter": 8, "backend": "jnp"}}) == []
    assert rec["scenario"]["backend"] == "pallas"      # not mutated
    assert codes(preflight_config(rec["scenario"], grid_shape=(1,))) == \
        ["FFTB118"]
    assert "unknown" in preflight_config(rec["scenario"])[0].message


BASIS_RAISE_CASES = [dict(segment_padding=1.5), dict(kpts=((0, 0),)),
                     dict(diameter=0), dict(diameter=20)]


@pytest.mark.parametrize("kw", BASIS_RAISE_CASES)
def test_plane_wave_basis_raises_the_reference_code(kw):
    with pytest.raises(RC.DiagnosticError) as want:
        RB.PlaneWaveBasis(16, nbands=4, **kw)
    with pytest.raises(DiagnosticError) as got:
        PlaneWaveBasis(16, nbands=4, device="cpu", **kw)
    assert got.value.code == want.value.code
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


def test_plane_wave_basis_raises_fftb118_for_unknown_backend():
    with pytest.raises(DiagnosticError) as exc:
        PlaneWaveBasis(16, nbands=4, device="cpu", backend="pallas")
    assert exc.value.code == "FFTB118"
    assert PlaneWaveBasis(16, nbands=4, device="cpu",
                          backend="cuda").backend == "cuda"


# ------------------------------------------------ the plan_for repair
PLAN_FOR_CASES = [
    ("x{3} y z -> X Y Z{3}", "cube16", [1], None, False),     # FFTB102
    ("x{0} y z -> X Y", "cube16", [1], None, False),          # FFTB101
    ("x{0} y z -> X Y Z{0}", "cube16", [1], (16, 16), False),  # FFTB103
    ("x{0} y z -> X Y Z{0}", "cube15", [2], None, True),      # FFTB110
    ("x{0} y z -> X Y Z{0}", "sphere7", [2], (16, 16, 16), True),  # 111
]


@pytest.mark.parametrize("spec,dom,shape,sizes,abstract", PLAN_FOR_CASES)
def test_plan_for_raises_the_reference_code(spec, dom, shape, sizes,
                                            abstract):
    g = (T.ProcGrid.create_abstract(shape) if abstract
         else T.ProcGrid.create(shape, device="cpu"))
    rg = (R.ProcGrid.create_abstract(shape) if abstract
          else R.ProcGrid.create(shape))
    cache, rcache = T.PlanCache(), R.PlanCache()
    with pytest.raises(RC.DiagnosticError) as want:
        R.fftb.plan_for(spec, domains=_doms(dom, True), grid=rg,
                        sizes=sizes, cache=rcache)
    with pytest.raises(DiagnosticError) as got:
        T.fftb.plan_for(spec, domains=_doms(dom, False), grid=g,
                        sizes=sizes, cache=cache)
    assert got.value.code == want.value.code
    assert isinstance(got.value, ValueError)
    assert len(cache) == 0 and cache.stats["builds"] == 0


def test_plan_for_clean_spec_builds_once():
    g = T.ProcGrid.create([1], device="cpu")
    cache = T.PlanCache()
    dom = T.Domain((0, 0, 0), (7, 7, 7))
    p = T.fftb.plan_for("x{0} y z -> X Y Z{0}", domains=dom, grid=g,
                        cache=cache)
    assert T.fftb.plan_for("x{0} y z -> X Y Z{0}", domains=dom, grid=g,
                           cache=cache) is p
    assert cache.stats["misses"] == 1 and cache.stats["hits"] == 1


# ------------------------------------------------------------------ locks
def test_disabled_is_a_plain_lock():
    lk = TrackedLock("a")
    assert not lk.locked()
    with lk:
        assert lk.locked()
    assert lk.acquire(blocking=False)
    lk.release()
    check_dispatch_hazard("anywhere")
    assert lock_violations() == []


def test_lock_order_cycle_detected_fftb301():
    enable_lock_checking(mode="raise")
    a, b = TrackedLock("a"), TrackedLock("b")
    with a, b:
        pass
    with pytest.raises(LockOrderError) as exc, b:
        a.acquire()
    assert exc.value.diagnostic.code == "FFTB301"
    with a:                       # the failed acquire left no stale entry
        pass


def test_lock_order_cycle_across_threads_recorded():
    enable_lock_checking(mode="record")
    x, y = TrackedLock("x"), TrackedLock("y")

    def t1():
        with x, y:
            pass

    def t2():
        with y, x:
            pass

    for fn in (t1, t2):
        th = threading.Thread(target=fn)
        th.start()
        th.join(timeout=10)
    viol = lock_violations()
    assert [d.code for d in viol] == ["FFTB301"]
    assert "lock-order cycle" in viol[0].message


def test_lock_held_across_dispatch_fftb302():
    enable_lock_checking(mode="raise")
    lk = TrackedLock("serve.metrics")
    with pytest.raises(LockOrderError) as exc, lk:
        check_dispatch_hazard("plan_cache.build")
    assert exc.value.diagnostic.code == "FFTB302"
    check_dispatch_hazard("plan_cache.build")


def test_reentrant_lock_no_false_cycle():
    enable_lock_checking(mode="raise")
    lk = TrackedLock("cache", reentrant=True)
    with lk, lk:
        assert lk.locked()
    assert not lk.locked() and lock_violations() == []


def test_plan_cache_builds_outside_its_tracked_lock():
    enable_lock_checking(mode="raise")
    cache = T.PlanCache(maxsize=4)
    assert isinstance(cache._lock, TrackedLock) and cache._lock.reentrant

    class _P:
        def estimated_bytes(self):
            return 64

        def shared_table_bytes(self):
            return {}

    assert cache.get_or_build("k", _P) is cache.peek("k")


def test_service_runs_clean_under_lock_checking():
    """A whole coalesced service run with the checker raising: no tracked
    lock is ever held across a plan build or a dispatch, and no cycle."""
    from repro_torch.serve import TransformService
    from repro_torch.serve.metrics import ServiceMetrics
    from repro_torch.serve.scheduler import CoalescingScheduler
    assert isinstance(CoalescingScheduler()._lock, TrackedLock)
    assert isinstance(ServiceMetrics()._lock, TrackedLock)
    enable_lock_checking(mode="raise")
    g = T.ProcGrid.create([1], device="cpu")
    svc = TransformService(g, 8, cache=T.PlanCache(), warm_async=False)
    sph = T.kpoint_sphere(4)
    rng = np.random.default_rng(0)
    hs = [svc.submit(f"t{i}", (rng.standard_normal((1, sph.npacked))
                               + 0j).astype(np.complex64), sph)
          for i in range(3)]
    svc.run_until_idle(timeout=30)
    assert all(h.done() for h in hs) and lock_violations() == []
    with pytest.raises(DiagnosticError) as exc:
        TransformService(g, 8, padding_budget=1.5)
    assert exc.value.code == "FFTB117"
