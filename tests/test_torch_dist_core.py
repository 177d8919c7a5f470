"""repro_torch.core on multi-process grids: 4 and 8 CPU processes over gloo.

Each run spawns its processes once (``repro_torch.sharding.procs``, a
``file://`` rendezvous in ``tmp_path``, every join bounded by a timeout),
and each rank runs every case of that world size; the tests then read the
cases.  The inputs are numpy arrays from a seed; every rank makes the same
global array and hands its local block (``DistTensor.scatter``) to the
plan, and the gathered output is held

* against ``numpy.fft`` within 2e-6 of the largest value (the reference's
  own limit, ``tests/test_fftb_core.py``), the plane-wave pair within
  5e-6 (``tests/test_planewave.py``);
* against the port on one process within 1e-6 (the same line DFTs, in
  batches of another shape).

The module imports no JAX: the ranks import it to find their functions.
"""
import math

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import ExecPolicy
from repro_torch.core.cache import grid_key
from repro_torch.core.plan import MoveStage
from repro_torch.kernels import sphere_pack
from repro_torch.sharding.procs import run_ranks

N, NB = 16, 4
FFT_RTOL, PW_RTOL, ONE_RANK_RTOL = 2e-6, 5e-6, 1e-6
TIMEOUT = 240


def _spawn(fn, nprocs, **kw):
    """``run_ranks`` of ``fn`` with each rank at the lowest CPU priority:
    the ranks share the host with the rest of the test suite, whose
    processes and threads should wait on them as little as possible."""
    return run_ranks(fn, nprocs, nice=19, **kw)


#: the reference's four distributed FFT grids (tests/test_fftb_core.py)
FFT_GRIDS = {
    "slab-8": ([8], "b x{0} y z -> b X Y Z{0}"),
    "pencil-4x2": ([4, 2], "b x{0} y{1} z -> b X Y{0} Z{1}"),
    "volumetric-2x2x2": ([2, 2, 2], "b x{0} y{1} z{2} -> b X{0} Y{1} Z{2}"),
    "batch-4": ([4], "b{0} x y z -> b{0} X Y Z"),
}


def _cube(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((NB, N, N, N))
            + 1j * rng.standard_normal((NB, N, N, N))).astype(np.complex64)


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _fft(grid, spec, x, policy=None):
    """The plan of ``spec`` on ``grid`` applied to the rank's block of the
    global ``x``; the gathered global result."""
    b = T.Domain((0,), (NB - 1,))
    dom = T.Domain((0, 0, 0), (N - 1,) * 3)
    plan = T.fftb(spec, domains=(b, dom), grid=grid)
    y = plan(plan.tin.scatter(torch.as_tensor(x)), policy=policy)
    assert tuple(y.shape) == plan.tout.local_shape
    return plan.tout.gather(y).numpy()


def _model_all_to_all(blocks, size, split, concat):
    """numpy model of a tiled all-to-all: rank r receives block r of each
    rank i's split dim and concatenates them along ``concat`` in i order."""
    parts = [np.split(b, size, axis=split) for b in blocks]
    return [np.concatenate([parts[i][r] for i in range(size)], axis=concat)
            for r in range(size)]


def _move_input(rank, shape):
    rng = np.random.default_rng(100 + rank)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _planewave(grid, batch_axes, backend):
    """The reference's plane-wave case (n=32, d=16, 4 bands) on ``grid``:
    the gathered inverse cube, the forward of it, the input."""
    sph = T.SphereDomain.from_diameter(16)
    inv, fwd = T.make_planewave_pair(grid, 32, sph, NB, backend=backend,
                                     batch_axes=batch_axes)
    rng = np.random.default_rng(1)
    packed = (rng.standard_normal((NB, sph.npacked))
              + 1j * rng.standard_normal((NB, sph.npacked))
              ).astype(np.complex64)
    rows = inv.local_rows(torch.as_tensor(packed))
    d0 = dict(sphere_pack.DISPATCHES)
    cube = inv.unpack_transform(rows)
    back = fwd.transform_pack(cube)
    fused = {k: sphere_pack.DISPATCHES[k] - d0[k] for k in d0}
    return (inv.tout.gather(cube).numpy(),
            inv.gather_rows(back).numpy(), packed, fused)


# ------------------------------------------------------------ rank bodies
def _eight_ranks(rank):
    out = {}
    x = _cube()
    for name, (shape, spec) in FFT_GRIDS.items():
        if math.prod(shape) == 8:
            out[name] = _fft(T.ProcGrid.create(shape, device="cpu"), spec, x)
    g8 = T.ProcGrid.create([8], device="cpu")
    out["lazy-8"] = _fft(g8, FFT_GRIDS["slab-8"][1], x,
                         ExecPolicy(mode="lazy"))
    # the per-stage traced walk: one span per stage, moves tagged with
    # the comm model
    from repro_torch.obs.trace import get_tracer
    tr = get_tracer().enable(per_stage=True)
    try:
        traced = _fft(g8, FFT_GRIDS["slab-8"][1], x)
        spans = [(e["name"], e["attrs"]) for e in tr.events()
                 if e["attrs"].get("kind") == "a2a"]
    finally:
        tr.disable()
    out["traced-8"] = (traced, spans)
    # batched ≡ unbatched: one plan per band on the same grid
    dom = T.Domain((0, 0, 0), (N - 1,) * 3)
    f1 = T.fftb("x{0} y z -> X Y Z{0}", domains=dom, grid=g8)
    out["unbatched-8"] = np.stack([
        f1.tout.gather(f1(f1.tin.scatter(torch.as_tensor(x[i])))).numpy()
        for i in range(NB)])
    # moves against the numpy model, over the 8-rank axis and over the
    # minor axis of a 4x2 grid
    g42 = T.ProcGrid.create([4, 2], device="cpu")
    cases = {"move-8": (g8, 0, (3, 16, 5), 1, 0),
             "move-4x2-minor": (g42, 1, (2, 3, 4, 6), 3, 2)}
    for name, (g, ax, shape, split, concat) in cases.items():
        mv = MoveStage(g.axis_name(ax), g.axis_size(ax), "u", "v", concat,
                       split, g.group(ax))
        got = mv.apply(torch.as_tensor(_move_input(rank, shape)))
        out[name] = (g.coordinate, got.numpy())
    # the plane-wave pair on [8] (x over all 8) and on [2, 4] (bands over
    # 2, x over 4): composed, and fused on the "cuda" route's plain kernels
    g24 = T.ProcGrid.create([2, 4], device="cpu")
    for name, (g, bax) in {"pw-8": (g8, ()), "pw-2x4": (g24, (0,))}.items():
        for backend in ("matmul", "cuda"):
            out[f"{name}-{backend}"] = _planewave(g, bax, backend)
    return out


class _SkewedClock:
    """``time`` for ``plan.tune``: reads 1 s late at the end of the
    candidates in ``slow`` (tune reads the clock twice per candidate)."""

    def __init__(self, real, slow):
        self.real, self.slow, self.calls = real, slow, 0

    def perf_counter(self):
        k, end = divmod(self.calls, 2)
        self.calls += 1
        return self.real.perf_counter() + (1.0 if end and k in self.slow
                                           else 0.0)


def _four_ranks(rank, reinit):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from repro_torch.core import plan as plan_mod
    out = {}
    shape, spec = FFT_GRIDS["batch-4"]
    x = _cube()
    out["batch-4"] = _fft(T.ProcGrid.create(shape, device="cpu"), spec, x)

    # a 2x2 grid by create() and by a device mesh: one coordinate rule
    g = T.ProcGrid.create([2, 2], ["b", "f"], device="cpu")
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("b", "f"))
    gm = T.ProcGrid.from_mesh(mesh, ["b", "f"], device="cpu")
    out["grid-2x2"] = (g.shape, g.coordinate, gm.coordinate, g.ranks,
                       gm.ranks, dist.get_rank())

    # scatter/gather of a dim split over both axes, major→minor
    b = T.Domain((0,), (NB - 1,))
    dom = T.Domain((0, 0, 0), (N - 1,) * 3)
    t = T.DistTensor.create((b, dom), "b x{0,1} y z", g)
    loc = t.scatter(torch.as_tensor(x))
    out["scatter-x01"] = (t.local_offsets(), loc.numpy(),
                          t.gather(loc).numpy())

    # two groups of one shape: rows (0,1)/(2,3) and columns (0,2)/(1,3)
    rows = DeviceMesh("cpu", torch.tensor([[0, 1], [2, 3]]),
                      mesh_dim_names=("b", "f"))
    cols = DeviceMesh("cpu", torch.tensor([[0, 2], [1, 3]]),
                      mesh_dim_names=("b", "f"))
    ga = T.ProcGrid.from_mesh(rows, ["f"], device="cpu")
    gb = T.ProcGrid.from_mesh(cols, ["f"], device="cpu")
    spec1 = "b x{0} y z -> b X Y Z{0}"
    pa = T.fftb.plan_for(spec1, domains=(b, dom), grid=ga)
    pb = T.fftb.plan_for(spec1, domains=(b, dom), grid=gb)
    out["groups"] = (ga.shape == gb.shape, grid_key(ga) != grid_key(gb),
                     pa is not pb, _fft(ga, spec1, x), _fft(gb, spec1, x))

    # tune(): rank 0's clock makes every candidate but lazy slow, rank 1's
    # every one but eager: alone they would choose apart
    plan = T.fftb(spec1, domains=(b, dom), grid=T.ProcGrid.create(
        [4], device="cpu"))
    slow = {0: {0, 2}, 1: {1, 2}}.get(rank, set())
    real = plan_mod.time
    plan_mod.time = _SkewedClock(real, slow)
    try:
        best = plan.tune(plan.tin.scatter(torch.as_tensor(x)), iters=1)
    finally:
        plan_mod.time = real
    y = plan.tout.gather(plan(plan.tin.scatter(torch.as_tensor(x))))
    out["tune"] = (best.legacy_mode, dict(plan.tune_seconds), y.numpy())

    # a new world in the same process (destroy, init again): the grid and
    # the plan cache build on the new world's groups, not the old ones
    spec2 = "b x{0} y{1} z -> b X Y{0} Z{1}"
    p1 = T.fftb.plan_for(spec2, domains=(b, dom), grid=g)
    dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"file://{reinit}",
                            world_size=4, rank=rank)
    g2 = T.ProcGrid.create([2, 2], ["b", "f"], device="cpu")
    p2 = T.fftb.plan_for(spec2, domains=(b, dom), grid=g2)
    sums = [float(g2.all_reduce(torch.ones(1), [a])[0]) for a in (0, 1)]
    y = p2.tout.gather(p2(p2.tin.scatter(torch.as_tensor(x))))
    out["reinit"] = (all(a is not b for a, b in zip(g.groups, g2.groups)),
                     p1 is not p2, sums, y.numpy())
    return out


_FAKE_NVCC = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(sys.argv[-1] + "\\n")
time.sleep(0.3)
open(out, "w").close()
"""


def _build_rank(rank, build_dir, nvcc):
    """``build_all`` with a stand-in compiler that logs each source it is
    run on (a rank that waited on the file lock finds the libraries)."""
    import pathlib

    from repro_torch.kernels import build
    build.BUILD_DIR = pathlib.Path(build_dir)
    build._nvcc = lambda: nvcc
    build._load = lambda stem, path: str(path)
    return sorted(build.build_all())


def test_kernel_build_compiles_once_across_ranks(tmp_path):
    import os
    import sys

    from repro_torch.kernels import build
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(log)))
    os.chmod(nvcc, 0o755)
    out = _spawn(_build_rank, 4, args=(str(tmp_path / "kernels"),
                                       str(nvcc)),
                 rendezvous_dir=str(tmp_path / "rdv"), timeout=TIMEOUT)
    assert out == [sorted(build.SOURCES)] * 4
    compiled = log.read_text().split()
    assert sorted(os.path.basename(c) for c in compiled) == sorted(
        f"{s}.cu" for s in build.SOURCES)


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    return _spawn(_eight_ranks, 8, timeout=TIMEOUT,
                  rendezvous_dir=str(tmp_path_factory.mktemp("rdv8")))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    rdv = tmp_path_factory.mktemp("rdv4")
    return _spawn(_four_ranks, 4, args=(str(rdv / "reinit"),),
                  timeout=TIMEOUT, rendezvous_dir=str(rdv))


@pytest.fixture(scope="module")
def one_rank():
    """The port on one process, every case (a grid of the case's rank,
    every axis of size 1)."""
    x = _cube()
    return {name: _fft(T.ProcGrid.create([1] * len(shape), device="cpu"),
                       spec, x)
            for name, (shape, spec) in FFT_GRIDS.items()}


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("name", list(FFT_GRIDS))
def test_fft_grids_match_numpy_and_one_rank(name, eight, four, one_rank):
    world = eight if name in eight[0] else four
    ref = np.fft.fftn(_cube(), axes=(1, 2, 3))
    for r, out in enumerate(world):
        assert _rel(out[name], ref) < FFT_RTOL, (name, r)
        assert _rel(out[name], one_rank[name]) < ONE_RANK_RTOL, (name, r)


def test_batched_equals_unbatched_on_8(eight):
    for out in eight:
        assert np.abs(out["slab-8"] - out["unbatched-8"]).max() < 1e-5


def test_traced_stage_walk_tags_moves_on_8(eight):
    for out in eight:
        traced, spans = out["traced-8"]
        np.testing.assert_array_equal(traced, out["slab-8"])
        assert spans, "no a2a span"
        # each rank holds NB·N³/8 complex64 and keeps 1/8 of it
        want = NB * N ** 3 // 8 * 8 * 7 // 8
        assert all(a["procs"] == 8 and a["model_bytes_per_device"] == want
                   for _, a in spans)


def test_lazy_executor_on_8(eight):
    ref = np.fft.fftn(_cube(), axes=(1, 2, 3))
    for out in eight:
        assert _rel(out["lazy-8"], ref) < FFT_RTOL


@pytest.mark.parametrize("case,shape,split,concat", [
    ("move-8", (3, 16, 5), 1, 0),
    ("move-4x2-minor", (2, 3, 4, 6), 3, 2),
])
def test_move_stage_matches_numpy_all_to_all(case, shape, split, concat,
                                             eight):
    # the axis' ranks, in coordinate order, by the coordinates the ranks
    # report: all 8 on "move-8", the two of each minor line on the 4x2
    lines = {}
    for r, out in enumerate(eight):
        coord, _ = out[case]
        key = coord[:-1] if case != "move-8" else ()
        lines.setdefault(key, {})[coord[-1]] = r
    for members in lines.values():
        ranks = [members[c] for c in sorted(members)]
        want = _model_all_to_all([_move_input(r, shape) for r in ranks],
                                 len(ranks), split, concat)
        for r, w in zip(ranks, want):
            np.testing.assert_array_equal(eight[r][case][1], w)


@pytest.mark.parametrize("case", ["pw-8", "pw-2x4"])
@pytest.mark.parametrize("backend", ["matmul", "cuda"])
def test_planewave_pair_on_multi_rank_grids(case, backend, eight):
    for out in eight:
        cube, back, packed, fused = out[f"{case}-{backend}"]
        full = np.zeros((NB, 32, 32, 32), np.complex64)
        sph = T.SphereDomain.from_diameter(16)
        flat = np.zeros((NB, 16 ** 3), np.complex64)
        flat[:, sph.pack_indices()] = packed
        full[:, :16, :16, :16] = flat.reshape(NB, 16, 16, 16)
        assert _rel(cube, np.fft.ifftn(full, axes=(1, 2, 3))) < PW_RTOL
        assert _rel(back, packed) < PW_RTOL          # the mirror round trip
        # the "cuda" route engages both fused kernels with x sharded
        want = 1 if backend == "cuda" else 0
        assert fused == {"unpack_dft": want, "dft_pack": want}


def test_grid_over_processes_and_mesh_agree(four):
    for out in four:
        shape, coord, mcoord, ranks, mranks, rank = out["grid-2x2"]
        assert shape == (2, 2) and ranks == mranks == (0, 1, 2, 3)
        assert coord == mcoord == divmod(rank, 2)


def test_scatter_gather_over_two_axes(four):
    x = _cube()
    for out in four:
        offsets, loc, back = out["scatter-x01"]
        r = offsets[1] // (N // 4)                    # block c0·2 + c1
        np.testing.assert_array_equal(loc, x[:, 4 * r:4 * r + 4])
        np.testing.assert_array_equal(back, x)


def test_grid_key_differs_between_groups_of_one_shape(four):
    ref = np.fft.fftn(_cube(), axes=(1, 2, 3))
    for out in four:
        same_shape, keys_differ, plans_differ, ya, yb = out["groups"]
        assert same_shape and keys_differ and plans_differ
        assert _rel(ya, ref) < FFT_RTOL and _rel(yb, ref) < FFT_RTOL


def test_tune_picks_one_policy_on_every_rank(four):
    modes = {out["tune"][0] for out in four}
    seconds = [out["tune"][1] for out in four]
    assert len(modes) == 1
    assert all(s == seconds[0] for s in seconds)      # the all-reduced times
    ref = np.fft.fftn(_cube(), axes=(1, 2, 3))
    for out in four:
        assert _rel(out["tune"][2], ref) < 3e-2       # lazy bf16 at worst


def test_grid_builds_on_a_new_world_after_reinit(four):
    ref = np.fft.fftn(_cube(), axes=(1, 2, 3))
    for out in four:
        new_groups, new_plan, sums, y = out["reinit"]
        assert new_groups and new_plan and sums == [2.0, 2.0]
        assert _rel(y, ref) < FFT_RTOL
