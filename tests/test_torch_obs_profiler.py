"""The port's tracer following a running ``torch.profiler``.

While a profiler records, the global tracer records spans without being
enabled: with no sync, one span per plan stage from whichever executor the
policy names, and each span also a profiler range of its own name, recorded
as a CPU op (not a user annotation) that owns the operators launched inside
it.  The plan executor's and the kernel wrappers' copies of lines into GEMM
order are ``relayout`` spans whose ``bytes`` are the copied tensors' sizes;
here they are held against the bytes of every stage input that the line
stage cannot view in place, worked out from the stages' shapes alone.

CPU tests at toy sizes, the "cuda" backend running its kernels' plain
versions; the last test needs a CUDA device and skips without one.
"""
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core as T
from repro_torch.core.plan import FFTStage
from repro_torch.core.policy import ExecPolicy
from repro_torch.obs import trace as trace_mod
from repro_torch.obs.trace import NOOP_SPAN, get_tracer

LAZY = ExecPolicy(mode="lazy")
TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools", "span_kernels.py")


@pytest.fixture(autouse=True)
def _tracer_off():
    tr = get_tracer()
    tr.disable()
    tr.clear()
    yield
    tr.disable()
    tr.clear()


@pytest.fixture
def counted_sync(monkeypatch):
    """Every tensor reads as a CUDA tensor, and each
    ``torch.cuda.synchronize`` is counted: a span that drained its value
    would show here."""
    calls = []
    monkeypatch.setattr(trace_mod, "_cuda_devices",
                        lambda value: {torch.device("cuda", 0)})
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    return calls


def _cx(rng, shape):
    return torch.as_tensor((rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape))
                           .astype(np.complex64))


def _cube_plan(backend="cuda"):
    return T.fftb("b x{0} y z -> b X Y Z{0}",
                  domains=(T.Domain((0,), (1,)),
                           T.Domain((0, 0, 0), (15, 15, 15))),
                  grid=T.ProcGrid.create([1], device="cpu"),
                  backend=backend)


def _toy_pair():
    g = T.ProcGrid.create([1], device="cpu")
    return T.make_planewave_pair(g, 16, T.kpoint_sphere(8), 4,
                                 backend="cuda")


def _relayout_bytes(stages, shape, order=None):
    """(bytes, shape, memory order) after ``stages`` from a complex64
    block of ``shape`` whose dims lie in memory ``order`` (outermost
    first; contiguous when None).

    A line stage reads its lines as the other dims in logical order, then
    its own dim innermost; its input is copied unless it already lies so
    (dims of size 1 aside), and its output lies so either way.  A move
    over one process is the identity."""
    shape = list(shape)
    order = list(range(len(shape))) if order is None else list(order)
    total = 0
    for st in stages:
        if not isinstance(st, FFTStage):
            continue
        want = [d for d in range(len(shape)) if d != st.index] + [st.index]
        if ([d for d in order if shape[d] > 1]
                != [d for d in want if shape[d] > 1]):
            total += 8 * math.prod(shape)
        order = want
        shape[st.index] = st.n_out
    return total, shape, order


def _pair_relayout_bytes(inv, fwd, nb):
    """The relayout bytes of one ``unpack_transform`` + ``transform_pack``
    of ``nb`` bands: the inverse's stages after the fused unpack (whose
    slab is contiguous, z innermost), then the forward's before the fused
    pack, from the cube the inverse left."""
    ex, ey, _ = inv.sphere.extents
    z = inv.plan.stages[0]
    b_inv, cube, order = _relayout_bytes(inv.plan.stages[1:],
                                         (nb, ex, ey, z.n_out))
    b_fwd, _, _ = _relayout_bytes(fwd.plan.stages[:-1], cube, order)
    return b_inv + b_fwd


def _span_ops(prof, names):
    """The profiler's events named in ``names``, and the names of the
    operators nested directly under each."""
    out = {}
    for e in prof.events():
        if e.name in names:
            out.setdefault(e.name, []).append(e)
    kids = {}
    for e in prof.events():
        p = e.cpu_parent
        if p is not None and p.name in names:
            kids.setdefault(p.name, set()).add(e.name)
    return out, kids


def test_plan_call_under_profiler_records_spans_as_cpu_ops(counted_sync):
    plan = _cube_plan()
    x = _cx(np.random.default_rng(1), (2, 16, 16, 16))
    want = plan(x)
    tr = get_tracer()
    assert not tr.enabled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = plan(x)
    np.testing.assert_array_equal(y.numpy(), want.numpy())
    names = {e["name"] for e in tr.events()}
    stage_names = {m["name"] for m in plan._stage_meta}
    assert {"plan:fft3d", "relayout"} | stage_names <= names
    found, kids = _span_ops(prof, names)
    assert set(found) == names
    assert not any(e.is_user_annotation for evs in found.values()
                   for e in evs)
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               for evs in found.values() for e in evs)
    assert stage_names & set(kids["plan:fft3d"])
    assert any(k.startswith("aten::") for k in kids["relayout"])
    assert counted_sync == []
    assert tr.span("after") is NOOP_SPAN


def test_toy_pair_under_profiler_records_the_ports_spans(counted_sync):
    inv, fwd = _toy_pair()
    c = _cx(np.random.default_rng(2), (4, inv.sphere.npacked))
    want = fwd.transform_pack(inv.unpack_transform(c))
    tr = get_tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fwd.transform_pack(inv.unpack_transform(c))
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    top = [e["name"] for e in sorted(tr.events(), key=lambda e: e["t0"])
           if e["depth"] == 0]
    assert top == ["fused:unpack_dft", "plan:ifft2d", "plan:fft2d",
                   "fused:dft_pack"]
    found, kids = _span_ops(prof, set(top) | {"relayout"})
    assert set(found) == set(top) | {"relayout"}
    tops = [e.name for e in prof.events() if e.cpu_parent is None]
    assert tops == top
    assert not any(e.is_user_annotation for evs in found.values()
                   for e in evs)
    assert all(any(k.startswith("aten::") for k in kids[n])
               for n in ("fused:unpack_dft", "relayout"))
    assert counted_sync == []
    assert tr.span("after") is NOOP_SPAN
    assert tr.events()                    # the session's spans stay


def test_relayout_bytes_equal_the_stage_inputs_not_viewed():
    inv, fwd = _toy_pair()
    c = _cx(np.random.default_rng(3), (4, inv.sphere.npacked))
    tr = get_tracer()
    with profile(activities=[ProfilerActivity.CPU]):
        fwd.transform_pack(inv.unpack_transform(c))
    rel = [e for e in tr.events() if e["name"] == "relayout"]
    assert rel and all(e["attrs"]["stage"] == e["parent"] for e in rel)
    assert all(e["parent"].startswith(("idft[", "dft[")) for e in rel)
    got = sum(e["attrs"]["bytes"] for e in rel)
    assert got == _pair_relayout_bytes(inv, fwd, 4) > 0
    assert tr.device_summary()["relayout"] == {
        "count": len(rel), "device_ms": None, "bytes": got}
    # a plan call from a contiguous cube, each executor
    plan = _cube_plan()
    x = _cx(np.random.default_rng(4), (2, 16, 16, 16))
    want, _, _ = _relayout_bytes(plan.stages, x.shape)
    with profile(activities=[ProfilerActivity.CPU]):
        plan(x)
    assert want > 0 and tr.device_summary()["relayout"]["bytes"] == want
    with profile(activities=[ProfilerActivity.CPU]):
        plan(x, policy=LAZY)
    # the lazy executor copies its two float32 planes: half each
    assert tr.device_summary()["relayout"]["bytes"] == want


def test_following_keeps_one_session_and_explicit_tracing_its_own(
        counted_sync):
    tr = get_tracer()
    tr.enable(sync=False)
    with tr.span("before"):
        pass
    tr.disable()
    with profile(activities=[ProfilerActivity.CPU]):
        with tr.span("first") as sp:
            sp.sync(torch.ones(1))
    assert [e["name"] for e in tr.events()] == ["first"]
    with profile(activities=[ProfilerActivity.CPU]):
        assert tr.span("probe") is not NOOP_SPAN   # a new session
        with tr.span("second"):
            pass
    assert [e["name"] for e in tr.events()] == ["second"]
    assert tr.span("after") is NOOP_SPAN
    # enabled explicitly: no clearing, and its sync kept under a profiler
    tr.enable(sync=True)
    with tr.span("kept"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tr.span("synced") as sp:
            sp.sync(torch.ones(1))
    assert [e["name"] for e in tr.events()] == ["kept", "synced"]
    assert len(counted_sync) == 1
    tr.disable()
    # suspended: nothing records, following or not
    with profile(activities=[ProfilerActivity.CPU]):
        with tr.span("followed"):
            pass
        with tr.suspended():
            assert tr.span("hidden") is NOOP_SPAN
        assert tr.enabled
    assert [e["name"] for e in tr.events()] == ["followed"]


def test_lazy_call_under_profiler_runs_the_lazy_executor(monkeypatch):
    plan = _cube_plan("matmul")
    x = _cx(np.random.default_rng(5), (2, 16, 16, 16))
    want = plan(x, policy=LAZY)

    def eager_walk(*args, **kwargs):
        raise AssertionError("the eager walk ran under a lazy policy")

    monkeypatch.setattr(T.plan.FftPlan, "_raw_apply", eager_walk)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = plan(x, policy=LAZY)
    np.testing.assert_array_equal(y.numpy(), want.numpy())
    evs = get_tracer().events()
    stages = [e["name"] for e in sorted(evs, key=lambda e: e["t0"])
              if e["parent"] == "plan:fft3d"]
    assert stages == [m["name"] for m in plan._stage_meta]
    found, _ = _span_ops(prof, set(stages))
    assert set(found) == set(stages)


def test_relayout_view_records_nothing():
    x = torch.zeros(4, 6, 8, dtype=torch.complex64)
    tr = get_tracer()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace_mod.relayout(x, 8).data_ptr() == x.data_ptr()
        assert trace_mod.relayout(x) is x
        moved = x.movedim(1, -1)
        y = trace_mod.relayout(moved, 6)
        z = trace_mod.relayout(moved)
    assert torch.equal(y, moved.reshape(-1, 6))
    assert torch.equal(z, moved) and z.is_contiguous()
    rel = [e for e in tr.events() if e["name"] == "relayout"]
    assert [e["attrs"] for e in rel] == [{"bytes": x.nbytes, "stage": None}
                                         ] * 2


class _FakeEvent:
    """A stand-in for a CUDA timing event: each one made reads the next
    tick of a counter, and their distance is the elapsed time."""

    made: list = []

    def __init__(self):
        self.tick = float(len(_FakeEvent.made))
        _FakeEvent.made.append(self)

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.tick - self.tick


@pytest.fixture
def fake_events(monkeypatch):
    _FakeEvent.made = []
    monkeypatch.setattr(trace_mod, "_stream_event", _FakeEvent)
    return _FakeEvent.made


def test_device_spans_alone_record_events(fake_events):
    """Device spans record an event at entry and exit; a span around
    them takes its device interval from theirs and records none; a
    host span records none and has no device time."""
    tr = get_tracer()
    with profile(activities=[ProfilerActivity.CPU]):
        with tr.span("outer"):
            with tr.device_span("a"):
                pass
            with tr.span("host"):
                pass
            with tr.device_span("b", bytes=16):
                pass
    assert len(fake_events) == 4
    s = tr.device_summary()
    assert s["a"] == {"count": 1, "device_ms": 1.0, "bytes": 0}
    assert s["b"] == {"count": 1, "device_ms": 1.0, "bytes": 16}
    assert s["outer"]["device_ms"] == 3.0        # a's entry to b's exit
    assert s["host"]["device_ms"] is None
    # the toy pair: line stages, fused kernels and copies are timed; the
    # plans take theirs from their stages; a move over one process is
    # no device work
    inv, fwd = _toy_pair()
    c = _cx(np.random.default_rng(7), (4, inv.sphere.npacked))
    fake_events.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        fwd.transform_pack(inv.unpack_transform(c))
    s = tr.device_summary()
    timed = ("fused:", "idft[", "dft[", "relayout")
    assert len(fake_events) == 2 * sum(
        v["count"] for k, v in s.items() if k.startswith(timed))
    for name, v in s.items():
        if name.startswith(("a2a[",)):
            assert v["device_ms"] is None
        else:
            assert v["device_ms"] > 0, name


def _span_kernels():
    spec = importlib.util.spec_from_file_location("span_kernels", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_span_kernels_finds_device_work_by_correlation(tmp_path):
    """``tools/span_kernels.py``: a launch counts for a range when its
    runtime call starts inside the range on the same thread."""
    mod = _span_kernels()

    def x(cat, name, tid, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
             "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [x("cpu_op", "relayout", 1, 10, 10),
              x("cuda_runtime", "cudaLaunchKernel", 1, 12, 1, 5),
              x("cuda_runtime", "cudaLaunchKernel", 1, 25, 1, 6),
              x("cuda_runtime", "cudaLaunchKernel", 2, 12, 1, 7),
              x("kernel", "copy", 7, 30, 2000, 5),
              x("kernel", "gemm", 7, 40, 3000, 6),
              x("kernel", "other", 7, 40, 3000, 7)]
    assert mod.kernels_in(events, "relayout") == {
        "ranges": 1, "launches": 1, "device_ms": 2.0,
        "by_kernel": {"copy": 2.0}}
    # the port's spans as the profiler exports them (no device work here)
    inv, fwd = _toy_pair()
    c = _cx(np.random.default_rng(6), (4, inv.sphere.npacked))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fwd.transform_pack(inv.unpack_transform(c))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    n = get_tracer().device_summary()["relayout"]["count"]
    assert mod.main([path]) == 0
    with open(path) as f:
        got = mod.kernels_in(json.load(f)["traceEvents"], "relayout")
    assert got == {"ranges": n, "launches": 0, "device_ms": 0,
                   "by_kernel": {}}


@pytest.mark.cuda
def test_follow_span_in_graph_capture_records_no_event():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and timing events "
                    "have no CPU mode")
    x = torch.ones(1 << 20, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x * 2                             # warm-up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    tr = get_tracer()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with torch.cuda.graph(graph):
            with tr.device_span("captured"):
                y = x * 2
        graph.replay()
        with tr.device_span("eager"):
            y = x * 3
        torch.cuda.synchronize()
    s = tr.device_summary()
    assert s["captured"] == {"count": 1, "device_ms": None, "bytes": 0}
    assert s["eager"]["count"] == 1 and s["eager"]["device_ms"] > 0.0
    assert float(y[0]) == 3.0
