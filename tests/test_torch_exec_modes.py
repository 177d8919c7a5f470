"""The port's executors against each other and against the JAX reference.

The lazy split-plane executor, ``ExecPolicy.from_mode``/``legacy_mode``,
``plan.tune()`` and the plan cache's policy key, on the CPU.  Inputs are
made with numpy from a seed and handed to both packages.

Tolerances: lazy fp32 against the eager executor as in the reference's own
test (rtol 1e-4, atol 1e-3); lazy fp32 against ``np.fft.fftn`` 2e-6 of the
largest output; against the reference's lazy executor 1e-5 of the largest
output (torch GEMMs and XLA dots sum in different orders, and Gauss's
three-product form cancels once per stage); bf16 operands with f32
results under 3e-2 relative, as the reference holds its own.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
from repro.core.policy import ExecPolicy as RPolicy
import repro_torch.core as T
from repro_torch.core.local_fft import full_fp32_matmul
from repro_torch.core.policy import TUNE_CANDIDATES, ExecPolicy
from repro_torch.kernels import sphere_pack
from repro_torch.obs import get_tracer
from repro_torch.obs.metrics import global_metrics

KPTS2 = ((0.0, 0.0, 0.0), (0.5, 0.5, 0.5))
LAZY = ExecPolicy(mode="lazy")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    CPU thread pool would oversubscribe the cores the other workers'
    timing-sensitive tests share.  These tests are small: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def g1():
    return T.ProcGrid.create([1], device="cpu")


def _cx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _cube_plan(grid, backend="matmul"):
    return T.fftb("b x{0} y z -> b X Y Z{0}",
                  domains=(T.Domain((0,), (1,)),
                           T.Domain((0, 0, 0), (15, 15, 15))),
                  grid=grid, backend=backend)


# ------------------------------------------------------------ executors
@pytest.mark.parametrize("backend", ["matmul", "cuda", "fft"])
def test_lazy_executor_matches_eager(backend, g1):
    plan = _cube_plan(g1, backend)
    x = torch.as_tensor(_cx(np.random.default_rng(3), (2, 16, 16, 16)))
    ye = plan(x).numpy()
    yl = plan(x, policy=LAZY)
    assert yl.dtype == torch.complex64 and yl.is_contiguous()
    np.testing.assert_allclose(yl.numpy(), ye, rtol=1e-4, atol=1e-3)


def test_lazy_executor_matches_numpy(g1):
    plan = _cube_plan(g1)
    x = _cx(np.random.default_rng(5), (2, 16, 16, 16))
    yl = plan(torch.as_tensor(x), policy=LAZY).numpy()
    assert _rel(yl, np.fft.fftn(x, axes=(1, 2, 3))) <= 2e-6
    # the derived inverse (scaled stages) runs lazily too
    back = plan.inverse()(torch.as_tensor(yl), policy=LAZY).numpy()
    assert _rel(back, x) <= 2e-6


@pytest.mark.parametrize("case", ["cube", "sphere"])
def test_lazy_executor_matches_reference_lazy(case, g1):
    rg = R.ProcGrid.create([1], ["torch_port_modes"])
    rng = np.random.default_rng(7)
    if case == "cube":
        doms = lambda M: (M.Domain((0,), (1,)),              # noqa: E731
                          M.Domain((0, 0, 0), (15, 15, 15)))
        kw = {}
        x = _cx(rng, (2, 16, 16, 16))
    else:                        # the staged-padding sphere plan, d=8→n=16
        doms = lambda M: (M.Domain((0,), (2,)),              # noqa: E731
                          M.kpoint_sphere(8, (0.5, 0.5, 0.5)))
        kw = {"sizes": (16, 16, 16), "inverse": True}
        x = _cx(rng, (3, 8, 8, 8))
    spec = "b x{0} y z -> b X Y Z{0}"
    ref = R.fftb(spec, domains=doms(R), grid=rg, **kw)
    plan = T.fftb(spec, domains=doms(T), grid=g1, **kw)
    want = np.asarray(ref(jnp.asarray(x), policy=RPolicy(mode="lazy")))
    got = plan(torch.as_tensor(x), policy=LAZY).numpy()
    assert _rel(got, want) <= 1e-5


def test_lazy_bf16_executor_precision_bounded(g1):
    plan = _cube_plan(g1)
    x = torch.as_tensor(_cx(np.random.default_rng(4), (2, 16, 16, 16)))
    ye = plan(x).numpy()
    yb = plan(x, policy=ExecPolicy.from_mode("lazy_bf16")).numpy()
    rel = _rel(yb, ye)
    assert 0.0 < rel < 3e-2, rel     # bf16 operands, f32 products


def test_lazy_under_per_stage_tracer_walks_eager_stages(g1, monkeypatch):
    """Tracing never changes the executor: a lazy call under the
    per-stage tracer runs the lazy executor (the eager walk is made to
    fail), records one span per line stage, and is bitwise the untraced
    lazy call."""
    plan = _cube_plan(g1)
    x = torch.as_tensor(_cx(np.random.default_rng(6), (2, 16, 16, 16)))
    want = plan(x, policy=LAZY)

    def eager_walk(*args, **kwargs):
        raise AssertionError("the eager walk ran under a lazy policy")

    monkeypatch.setattr(T.plan.FftPlan, "_raw_apply", eager_walk)
    tr = get_tracer()
    tr.clear()
    tr.enable(per_stage=True)
    try:
        y = plan(x, policy=LAZY)
    finally:
        tr.disable()
    events = tr.events()
    tr.clear()
    stages = [e for e in events if e["name"].startswith(("dft[", "idft["))]
    assert len(stages) == sum(isinstance(s, T.plan.FFTStage)
                              for s in plan.stages)
    assert all(e["parent"].startswith("plan:") for e in stages)
    assert {e["attrs"]["mode"] for e in events
            if e["name"].startswith("plan:")} == {"lazy"}
    np.testing.assert_array_equal(y.numpy(), want.numpy())


# --------------------------------------------------------------- policy
def test_policy_legacy_mode_mapping():
    assert ExecPolicy.from_mode("lazy_bf16") == \
        ExecPolicy(mode="lazy", compute_dtype="bfloat16")
    assert ExecPolicy.from_mode("lazy_bf16").legacy_mode == "lazy_bf16"
    assert ExecPolicy.from_mode("lazy").legacy_mode == "lazy"
    assert ExecPolicy().legacy_mode == "eager"
    assert ExecPolicy.from_mode(LAZY) is LAZY
    assert not ExecPolicy.from_mode("eager", check_shapes=False).check_shapes
    with pytest.raises(ValueError):
        ExecPolicy.from_mode("warp_speed")
    with pytest.raises(ValueError, match="from_mode"):
        ExecPolicy(mode="lazy_bf16")      # legacy strings only via from_mode
    assert [p.legacy_mode for p in TUNE_CANDIDATES] == \
        [RPolicy.from_mode(m).legacy_mode
         for m in ("eager", "lazy", "lazy_bf16")]


def test_tune_pins_fastest_policy(g1):
    plan = T.fftb("x{0} y z -> X Y Z{0}",
                  domains=T.Domain((0, 0, 0), (15, 15, 15)), grid=g1)
    x = _cx(np.random.default_rng(8), (16, 16, 16))
    m = global_metrics()
    tunes = m.counter("fftb.tunes").value
    recorded = m.histogram("fftb.tune_best_us").count
    best = plan.tune(torch.as_tensor(x), warmup=1, iters=1)
    assert isinstance(best, ExecPolicy) and plan.policy == best
    assert list(plan.tune_seconds) == ["eager", "lazy", "lazy_bf16"]
    assert plan.tune_seconds[best.legacy_mode] == min(
        plan.tune_seconds.values())
    assert m.counter("fftb.tunes").value == tunes + 1
    assert m.histogram("fftb.tune_best_us").count == recorded + 1
    ref = np.fft.fftn(x)
    assert _rel(plan(torch.as_tensor(x)).numpy(), ref) < 3e-2


def test_tune_resyncs_memoized_mirrors(g1):
    plan = T.fftb("x{0} y z -> X Y Z{0}",
                  domains=T.Domain((0, 0, 0), (15, 15, 15)), grid=g1)
    inv, adj = plan.inverse(), plan.adjoint()     # derived before tuning
    x = torch.as_tensor(_cx(np.random.default_rng(11), (16, 16, 16)))
    best = plan.tune(x, warmup=1, iters=1,
                     candidates=(ExecPolicy(mode="lazy"),))
    assert best == ExecPolicy(mode="lazy")
    assert plan.inverse() is inv and inv.policy == best
    assert plan.adjoint() is adj and adj.policy == best


def test_plan_cache_keeps_lazy_and_eager_apart(g1):
    cache = T.PlanCache()
    dom = T.Domain((0, 0, 0), (7, 7, 7))
    a = T.fftb.plan_for("x{0} y z -> X Y Z{0}", domains=dom, grid=g1,
                        cache=cache)
    c = T.fftb.plan_for("x{0} y z -> X Y Z{0}", domains=dom, grid=g1,
                        policy=LAZY, cache=cache)
    assert a is not c and c.policy == LAZY and a.policy == ExecPolicy()
    assert cache.stats["misses"] == 2 and cache.stats["size"] == 2
    assert T.fftb.plan_for("x{0} y z -> X Y Z{0}", domains=dom, grid=g1,
                           policy=LAZY, cache=cache) is c


def test_full_fp32_matmul_restores_the_callers_setting():
    flag = torch.backends.cuda.matmul
    saved = flag.allow_tf32
    try:
        flag.allow_tf32 = True
        with full_fp32_matmul("cuda"):
            assert flag.allow_tf32 is False
            with full_fp32_matmul("cuda"):          # nested
                assert flag.allow_tf32 is False
            assert flag.allow_tf32 is False
        assert flag.allow_tf32 is True
        with pytest.raises(KeyError), full_fp32_matmul("cuda"):
            raise KeyError("an error inside")
        assert flag.allow_tf32 is True
        with full_fp32_matmul("cpu"):               # CPU GEMMs: untouched
            assert flag.allow_tf32 is True
        # the "matmul" backend leaves the flag as it found it
        T.local_dft(torch.ones(4, 8, dtype=torch.complex64), 1,
                    backend="matmul")
        assert flag.allow_tf32 is True
    finally:
        flag.allow_tf32 = saved


# ----------------------------------------------- fused plane-wave route
@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-5),
                                               ("bfloat16", 3e-2)])
def test_fused_entry_points_under_lazy_match_reference(compute_dtype, tol,
                                                       g1):
    """The stacked pair on the "cuda" backend (its kernels' plain versions
    here) under a lazy policy: the fused unpack and pack still run, the
    plan's other stages run lazily; against the reference's lazy
    composition of unpack, plan and pack."""
    pol = ExecPolicy(mode="lazy", compute_dtype=compute_dtype)
    spheres = [T.kpoint_sphere(8, k) for k in KPTS2]
    rspheres = [R.kpoint_sphere(8, k) for k in KPTS2]
    inv, fwd = T.make_stacked_planewave_pair(g1, 16, spheres, 3,
                                             backend="cuda")
    rinv, rfwd = R.make_stacked_planewave_pair(
        R.ProcGrid.create([1], ["torch_port_fused_lazy"]), 16, rspheres, 3)
    rng = np.random.default_rng(9)
    c = _cx(rng, (6, inv.npacked_max))
    c[:3, spheres[0].npacked:] = 0
    c[3:, spheres[1].npacked:] = 0
    cube = _cx(rng, (6, 16, 16, 16))
    rpol = RPolicy(mode="lazy", compute_dtype=compute_dtype)
    want_psi = np.asarray(rinv.unpack_transform(jnp.asarray(c), policy=rpol))
    want_c = np.asarray(rfwd.transform_pack(jnp.asarray(cube), policy=rpol))
    before = dict(sphere_pack.DISPATCHES)
    psi = inv.unpack_transform(torch.as_tensor(c), policy=pol).numpy()
    got_c = fwd.transform_pack(torch.as_tensor(cube), policy=pol).numpy()
    assert sphere_pack.DISPATCHES["unpack_dft"] == before["unpack_dft"] + 1
    assert sphere_pack.DISPATCHES["dft_pack"] == before["dft_pack"] + 1
    assert _rel(psi, want_psi) <= tol
    assert _rel(got_c, want_c) <= tol
    pad = ~inv.valid_lanes().repeat(3, axis=0)
    assert np.all(got_c[pad] == 0)


def test_lazy_lead_plan_leaves_a_contiguous_slab(g1):
    """The slab the fused pack gets under a lazy policy: the lazy exit
    writes the lead plan's result in its logical order, so
    ``sphere_pack.slab_layout`` reads it in place (rows), no copy."""
    spheres = [T.kpoint_sphere(8, k) for k in KPTS2]
    _, fwd = T.make_stacked_planewave_pair(g1, 16, spheres, 2,
                                           backend="cuda")
    lead = fwd._fused_out_parts()["lead"]
    cube = torch.as_tensor(_cx(np.random.default_rng(2), (4, 16, 16, 16)))
    slab = lead(cube, policy=LAZY)
    assert tuple(slab.shape) == (4, 8, 8, 16)
    assert sphere_pack.slab_layout(slab) == 0
    np.testing.assert_allclose(slab.numpy(), lead(cube).numpy(), rtol=1e-5,
                               atol=1e-4)
