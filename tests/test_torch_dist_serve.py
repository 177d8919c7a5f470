"""repro_torch.serve on multi-process grids: 4 CPU processes over gloo.

The ``TransformService`` on a ``[4]`` fft-sharded grid and on a 2×2
(batch × fft) grid, each on the "matmul" route and on the "cuda" route
(the fused sphere kernels, their plain versions on the CPU), at the size
of the reference's ``test_service_bitwise_on_4_devices`` (n=16, d=8,
three tenants, one request with a potential).  Rank 0 is the front end;
the other ranks follow it.  The processes are spawned once
(``repro_torch.sharding.procs``, a ``file://`` rendezvous in
``tmp_path``, joined with a timeout) and run every case there.

* Every coalesced result is held against ``eager_apply`` on the same
  grid, against the port's service on one process and against the
  reference's service on 4 forced host devices (the ``dist`` fixture, the
  same inputs passed as ``.npz``), each within 1e-5 of the largest value.
* At least one dispatch coalesces, and the padded lanes of every packed
  block are exactly +0.0.
* Deadlines, ``stop(drain=False)``, ``warm_async`` with the background
  loop, ``warm()`` beside following ranks, a failing rank and a front end
  that fails after the collectives: each resolves on the front end while
  every follower stays in step, and no rank hangs.

The module imports no JAX: the ranks import it to find their functions;
the reference runs in the ``dist`` fixture's subprocess.
"""
import numpy as np
import pytest

N, D = 16, 8
KPT_B = (0.5, 0.5, 0.5)
RTOL = 1e-5
TIMEOUT = 240
#: the reference test's work: tenant, coefficients, sphere, potential
WORK = (("t0", "c0", "A", True), ("t1", "c1", "B", False),
        ("t2", "c2", "A", False))
#: name -> (grid shape, batch axes)
GRIDS = {"fft-4": ([4], ()), "2x2": ([2, 2], (0,))}
CASES = [(g, b) for g in GRIDS for b in ("matmul", "cuda")]


def _spawn(fn, nprocs, **kw):
    """``run_ranks`` of ``fn`` with each rank at the lowest CPU priority:
    the ranks share the host with the rest of the test suite, whose
    processes and threads should wait on them as little as possible."""
    from repro_torch.sharding.procs import run_ranks
    return run_ranks(fn, nprocs, nice=19, **kw)


def _inputs(path):
    """The work's coefficients and potential, from one numpy seed, saved
    for both packages."""
    from repro_torch.core import kpoint_sphere
    rng = np.random.default_rng(0)
    npk = {"A": kpoint_sphere(D).npacked,
           "B": kpoint_sphere(D, KPT_B).npacked}
    arrays = {"v": rng.standard_normal((N,) * 3).astype(np.float32)}
    for nb, (_, c, s, _) in zip((2, 2, 1), WORK):
        arrays[c] = (rng.standard_normal((nb, npk[s]))
                     + 1j * rng.standard_normal((nb, npk[s]))
                     ).astype(np.complex64)
    np.savez(path, **arrays)
    return arrays


def _spheres():
    from repro_torch.core import kpoint_sphere
    return {"A": kpoint_sphere(D), "B": kpoint_sphere(D, KPT_B)}


def _submit_work(svc, data, spheres, **kw):
    return [svc.submit(t, data[c], spheres[s],
                       v_eff=data["v"] if v else None, **kw)
            for t, c, s, v in WORK]


def _recording(svc):
    """Record every pair run on this rank: the lane validity of the pair's
    rows and the packed block it returned."""
    runs = []
    run = svc._run_pair

    def wrapped(prepare):
        box = {}

        def prep():
            out = prepare()
            box["inv"] = out[0]
            return out
        packed = run(prep)
        runs.append((box["inv"].valid_lanes(), packed.numpy()))
        return packed
    svc._run_pair = wrapped
    return runs


# ------------------------------------------------------------ rank bodies
def _serve_case(grid, backend, batch_axes, data, spheres):
    """The work through the service (front end: rank 0), then every
    request through ``eager_apply`` on every rank."""
    from repro_torch.serve import TransformService
    svc = TransformService(grid, N, warm_async=False, backend=backend,
                           batch_axes=batch_axes)
    runs = _recording(svc)
    handles = _submit_work(svc, data, spheres) if svc.is_front else []
    followed = svc.run_until_idle()
    out = {"runs": runs, "followed": followed}
    if svc.is_front:
        out["results"] = [h.result(10) for h in handles]
        out["summary"] = svc.metrics.summary()
    out["eager"] = [svc.eager_apply(data[c], spheres[s],
                                    data["v"] if v else None)
                    for _, c, s, v in WORK]
    svc.stop()
    return out


def _lifecycle(grid, data, spheres):
    """Deadlines, stop without draining and the background loop with
    asynchronous warming, on the 2×2 grid."""
    from repro_torch.serve import (DeadlineExceeded, ServeError,
                                   ServiceStopped, TransformService)
    sA = spheres["A"]
    out = {}
    # a request past its deadline, beside one that is served
    svc = TransformService(grid, N, warm_async=False, backend="cuda",
                           batch_axes=(0,))
    if svc.is_front:
        late = svc.submit("late", data["c2"], sA, deadline=0.0)
        ok = svc.submit("ok", data["c0"], sA)
    out["deadline_followed"] = svc.run_until_idle()
    if svc.is_front:
        try:
            late.result(10)
            out["late"] = None
        except DeadlineExceeded as err:
            out["late"] = type(err).__name__
        out["ok"] = ok.result(10)
        out["deadline_summary"] = svc.metrics.summary()
    out["ok_eager"] = svc.eager_apply(data["c0"], sA)
    svc.stop()

    # stop(drain=False): queued requests fail, every follower ends
    svc = TransformService(grid, N, backend="cuda", batch_axes=(0,))
    if svc.is_front:
        hs = _submit_work(svc, data, spheres)
        svc.stop(drain=False)
        errs = []
        for h in hs:
            try:
                h.result(10)
                errs.append(None)
            except ServiceStopped as err:
                errs.append(type(err).__name__)
        out["no_drain"] = errs
        try:
            svc.submit("t0", data["c0"], sA)
        except ServiceStopped:
            out["submit_after_stop"] = "ServiceStopped"
    else:
        try:
            svc.submit("t0", data["c0"], sA)
        except ServeError as err:
            out["follower_submit"] = str(err)
        svc.stop()
        out["no_drain"] = svc._stopped

    # the background loop, warming asynchronously: the cold batch is
    # requeued while every rank warms it, then served
    svc = TransformService(grid, N, backend="cuda", batch_axes=(0,),
                           warm_async=True)
    svc.start()
    if svc.is_front:
        hs = _submit_work(svc, data, spheres)
        out["async"] = [h.result(60) for h in hs]
    svc.stop()
    out["async_warmed"] = sorted(svc._warmed)
    out["async_eager"] = [svc.eager_apply(data[c], spheres[s],
                                          data["v"] if v else None)
                          for _, c, s, v in WORK]
    return out


def _warm_case(grid, data, spheres):
    """``warm()`` on the 2×2 grid: refused on a follower and while the
    front end's loop runs; before ``start()`` the followers, already in
    theirs, warm with the front end, and the request it warmed dispatches
    with no further warming."""
    from repro_torch.serve import ServeError, TransformService
    sA = spheres["A"]
    svc = TransformService(grid, N, backend="cuda", batch_axes=(0,))
    out = {}

    def refused(*args, **kw):
        try:
            svc.warm(*args, **kw)
        except ServeError as err:
            return str(err)
    if svc.is_front:
        svc.warm(sA, nbands=2)
        out["warmed_before"] = sorted(svc._warmed)
        svc.start()
        out["refused"] = refused(sA)
        out["result"] = svc.submit("t0", data["c0"], sA,
                                   v_eff=data["v"]).result(60)
    else:
        out["refused"] = refused(sA, nbands=2)
        svc.start()
    svc.stop()
    out["warmed"] = sorted(svc._warmed)
    out["eager"] = svc.eager_apply(data["c0"], sA, data["v"])
    return out


def _failing_rank(grid, data, spheres, bad: int, after: bool = False):
    """A dispatch whose preparation fails on rank ``bad`` (with ``after``:
    the front end's first pair fails once its collectives have run): the
    front end fails the batch's handles, and every rank stops with an
    error."""
    import torch.distributed as dist

    from repro_torch.serve import TransformService
    svc = TransformService(grid, N, warm_async=False, backend="cuda",
                           batch_axes=(0,))

    def fail(*_):
        raise RuntimeError("injected failure")
    run = svc._run_pair

    def fail_after(prepare):
        run(prepare)
        raise RuntimeError("injected failure after the collectives")
    if dist.get_rank() == bad:
        if after:
            svc._run_pair = fail_after
        else:
            svc._follower_upload = fail
    handles = _submit_work(svc, data, spheres) if svc.is_front else []
    try:
        svc.run_until_idle()
        raised = None
    except Exception as err:   # every rank must get here
        raised = f"{type(err).__name__}: {err}"
    out = {"raised": raised}
    if svc.is_front:
        errs = []
        for h in handles:
            try:
                h.result(10)
                errs.append(None)
            except Exception as err:
                errs.append(type(err).__name__)
        out["handles"] = errs
        out["error"] = repr(svc.error)
    svc.stop()          # returns on every rank: the error stopped each
    return out


def _four_ranks(rank, path):
    from repro_torch.check.diagnostics import DiagnosticError
    from repro_torch.core import ProcGrid
    from repro_torch.serve import ServeError, TransformService
    data = dict(np.load(path))
    spheres = _spheres()
    grids = {name: ProcGrid.create(shape, device="cpu")
             for name, (shape, _) in GRIDS.items()}
    out = {}
    for name, backend in CASES:
        out[(name, backend)] = _serve_case(
            grids[name], backend, GRIDS[name][1], data, spheres)
    g22 = grids["2x2"]
    svc = TransformService(g22, N, batch_axes=(0,))
    out["buckets"] = [svc.bucket_for(r) for r in (1, 2, 3, 5, 8)]
    try:
        svc.step()
        out["step"] = "stepped"
    except ServeError as err:
        out["step"] = "follower" if not svc.is_front else repr(err)
    try:
        TransformService(g22, N, batch_axes=(0,), max_rows=3)
        out["preflight"] = None
    except DiagnosticError as exc:
        out["preflight"] = exc.code
    out["lifecycle"] = _lifecycle(g22, data, spheres)
    out["warm"] = _warm_case(g22, data, spheres)
    out["failure"] = _failing_rank(g22, data, spheres, bad=2)
    out["failure_after"] = _failing_rank(g22, data, spheres, bad=0,
                                         after=True)
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("inputs") / "work.npz")
    return path, _inputs(path)


@pytest.fixture(scope="module")
def four(inputs, tmp_path_factory):
    return _spawn(_four_ranks, 4, args=(inputs[0],), timeout=TIMEOUT,
                  rendezvous_dir=str(tmp_path_factory.mktemp("rdv4")))


@pytest.fixture(scope="module")
def one_process(inputs):
    """The same work through the port's service on one process."""
    from repro_torch.core import ProcGrid
    from repro_torch.serve import TransformService
    data, spheres = inputs[1], _spheres()
    out = {}
    for backend in ("matmul", "cuda"):
        svc = TransformService(ProcGrid.create([1], device="cpu"), N,
                               warm_async=False, backend=backend)
        hs = _submit_work(svc, data, spheres)
        svc.run_until_idle()
        out[backend] = [h.result(10) for h in hs]
    return out


_REF_SERVE = """
import os; os.nice(19)  # the lowest CPU priority, as the ranks'
import numpy as np, jax
from repro.core import ProcGrid, kpoint_sphere
from repro.serve import TransformService
assert jax.device_count() == 4
d = np.load({path!r})
sp = {{"A": kpoint_sphere({D}), "B": kpoint_sphere({D}, {kpt!r})}}
svc = TransformService(ProcGrid.create([4]), {N}, warm_async=False)
hs = [svc.submit(t, d[c], sp[s], v_eff=d["v"] if v else None)
      for t, c, s, v in {work!r}]
svc.run_until_idle()
assert svc.metrics.summary()["coalesced_dispatches"] >= 1
np.savez({out!r}, **{{"r%d" % i: np.asarray(h.result(10))
                     for i, h in enumerate(hs)}})
print("OK")
"""


@pytest.fixture(scope="module")
def reference(dist, inputs, tmp_path_factory):
    """The reference's service on its 4-device fft-sharded grid, on the
    same inputs (its ``test_service_bitwise_on_4_devices`` setup)."""
    out = str(tmp_path_factory.mktemp("ref") / "served.npz")
    assert "OK" in dist(_REF_SERVE.format(path=inputs[0], D=D, kpt=KPT_B,
                                          N=N, work=WORK, out=out),
                        n_devices=4)
    ref = np.load(out)
    return [ref[f"r{i}"] for i in range(len(WORK))]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.complex64
    err = float(np.abs(got - want).max())
    assert err <= RTOL * float(np.abs(want).max()), err


def _is_plus_zero(x) -> bool:
    parts = np.concatenate([x.real.ravel(), x.imag.ravel()])
    return bool(np.all(parts == 0) and not np.signbit(parts).any())


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_service_matches_eager_and_one_process(case, four, one_process):
    front = four[0][case]
    for out in four:
        # every rank's eager oracle is the whole result, the same on all
        for got, want in zip(out[case]["eager"], front["eager"]):
            np.testing.assert_array_equal(got, want)
    for got, eager, one in zip(front["results"], front["eager"],
                               one_process[case[1]]):
        _close(got, eager)
        _close(got, one)


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_service_matches_reference_on_4_devices(case, four, reference):
    for got, want in zip(four[0][case]["results"], reference):
        _close(got, want)


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_coalesced_dispatch_with_plus_zero_padding(case, four):
    summary = four[0][case]["summary"]
    assert summary["requests"] == len(WORK)
    assert summary["coalesced_dispatches"] >= 1
    for out in four:
        # a warm run and the coalesced dispatch on every rank, in step
        runs = out[case]["runs"]
        assert len(runs) == len(four[0][case]["runs"]) >= 2
        padded = [(v, p) for v, p in runs if (~v).any()]
        assert padded            # the k-shifted sphere's rows are ragged
        for valid, packed in padded:
            assert packed.shape == valid.shape
            assert _is_plus_zero(packed[~valid])
    assert all(out[case]["followed"] == summary["dispatches"]
               for out in four[1:])


def test_buckets_split_over_the_batch_axes(four):
    for out in four:
        assert out["buckets"] == [2, 2, 4, 8, 8]
        assert out["preflight"] == "FFTB122"
    assert four[0]["step"] == "stepped"
    assert all(out["step"] == "follower" for out in four[1:])


def test_deadline_expires_on_the_front_end_in_step(four):
    front = four[0]["lifecycle"]
    assert front["late"] == "DeadlineExceeded"
    _close(front["ok"], front["ok_eager"])
    s = front["deadline_summary"]
    assert s["requests"] == 1 and s["dispatches"] == 1
    # the followers ran the one dispatch and came back with the front end
    assert all(out["lifecycle"]["deadline_followed"] == 1
               for out in four[1:])


def test_stop_without_drain_ends_every_follower(four):
    front = four[0]["lifecycle"]
    assert front["no_drain"] == ["ServiceStopped"] * len(WORK)
    assert front["submit_after_stop"] == "ServiceStopped"
    for out in four[1:]:
        assert out["lifecycle"]["no_drain"] is True
        assert "front end" in out["lifecycle"]["follower_submit"]


def test_warm_async_requeues_without_a_hang(four):
    front = four[0]["lifecycle"]
    for got, want in zip(front["async"], front["async_eager"]):
        _close(got, want)
    # every rank warmed the batch's bucket on its dispatch thread
    warmed = {tuple(out["lifecycle"]["async_warmed"]) for out in four}
    assert len(warmed) == 1 and warmed != {()}


def test_failed_rank_stops_every_rank_with_an_error(four):
    front = four[0]["failure"]
    assert front["handles"] == ["ServeError"] * len(WORK)
    assert "another rank failed" in front["error"]
    for r, out in enumerate(four):
        raised = out["failure"]["raised"]
        assert raised is not None, r
        if r == 2:
            assert "injected failure" in raised
        else:
            assert raised.startswith("ServeError"), raised


def test_warm_on_the_grid_is_the_front_ends_before_start(four):
    front = four[0]["warm"]
    assert "while the loop runs" in front["refused"]
    _close(front["result"], front["eager"])
    for out in four[1:]:
        assert "front end" in out["warm"]["refused"]
    # one bucket warmed, on every rank, by warm() alone
    assert len(front["warmed_before"]) == 1
    assert all(out["warm"]["warmed"] == front["warmed_before"]
               for out in four)


def test_front_end_failure_after_the_collectives_stops_every_rank(four):
    front = four[0]["failure_after"]
    assert front["handles"] == ["ServeError"] * len(WORK)
    assert "after the collectives" in front["error"]
    assert front["raised"].startswith("RuntimeError")
    for out in four[1:]:
        raised = out["failure_after"]["raised"]
        assert raised.startswith("ServeError"), raised
        assert "after the collectives" in raised
