"""repro_torch.core against the JAX reference ``repro.core``.

Pure-Python layers (domains, specs, layouts, the schedule search and the
mirrors) must agree *exactly*: same index tables, same stage lists, same
``describe()``.  Numerical layers (line DFTs, plane-wave transforms) run
on the CPU and agree to ~1e-6 relative to the largest output: the port's
torch GEMMs and the reference's XLA dots sum in different orders.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
from repro.core.local_fft import local_dft as ref_local_dft
import repro_torch.core as T
from repro_torch.core import layout as TL
from repro_torch.core.local_fft import (MATMUL_MAX_N, dft_flops, local_dft,
                                        realized_backend)
from repro_torch.core.plan import FFTStage, FftPlan, MoveStage
from repro_torch.core.policy import ExecPolicy

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = 2e-6          # relative to the largest output magnitude
# the port's backend names for the reference's
REF_BACKEND = {"fft": "jnp", "matmul": "matmul", "cuda": "pallas"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    CPU thread pool would oversubscribe the cores the other workers'
    timing-sensitive tests share.  These tests are small: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


# ------------------------------------------------------- domains / specs
@pytest.mark.parametrize("d,kpt", [(8, (0, 0, 0)), (8, (0.5, 0.5, 0.5)),
                                   (7, (0.25, 0, 0.5)), (16, (0, 0.3, 0))])
def test_sphere_tables_equal_reference(d, kpt):
    a, b = T.kpoint_sphere(d, kpt), R.kpoint_sphere(d, kpt)
    assert (a.lower, a.upper, a.npacked) == (b.lower, b.upper, b.npacked)
    assert np.array_equal(a.pack_indices(), b.pack_indices())
    assert np.array_equal(a.mask(), b.mask())
    for k, v in b.offsets.items():
        assert np.array_equal(a.offsets[k], v)
    assert np.array_equal(T.sphere_gvectors(a), R.sphere_gvectors(b))
    assert np.array_equal(T.sphere_kinetic_row(a, 16.0),
                          R.sphere_kinetic_row(b, 16.0))


def test_ragged_tables_and_segments_equal_reference():
    kpts = ((0, 0, 0), (0.5, 0.5, 0.5), (0.3, 0, 0), (0, 0, 0.45))
    a = [T.kpoint_sphere(8, k) for k in kpts]
    b = [R.kpoint_sphere(8, k) for k in kpts]
    for x, y in zip(T.padded_pack_tables(a), R.padded_pack_tables(b)):
        assert np.array_equal(x, y)
    for x, y in zip(T.padded_kinetic_table(a, 16.0),
                    R.padded_kinetic_table(b, 16.0)):
        assert np.array_equal(x, y)
    for budget, div in [(0.0, None), (0.05, None), (0.25, 2)]:
        assert (T.segment_spheres(a, budget, div)
                == R.segment_spheres(b, budget, div))


@pytest.mark.parametrize("spec", [
    "b x{0} y z -> b X Y Z{0}", "x{0,1} y z -> X Y Z{1,0}",
    "b x{0} y{1} z -> b X Y{0} Z{1}", "x y -> X Y"])
def test_spec_parsing_equals_reference(spec):
    assert T.parse_transform_spec(spec) == R.parse_transform_spec(spec)
    lhs = spec.split("->")[0]
    names, dist = T.parse_dims(lhs)
    assert (names, dist) == R.parse_dims(lhs)
    assert T.dims_string(names, dist) == R.dims_string(names, dist)
    assert T.Transform.parse(spec).fft_pairs == \
        R.Transform.parse(spec).fft_pairs
    assert T.planewave_spec((0,), (1, 2)) == R.planewave_spec((0,), (1, 2))
    assert T.cube_spec((1,)) == R.cube_spec((1,))


def test_layout_planner_equals_reference():
    from repro.core import layout as RL
    sizes = {"b": 4, "x": 16, "y": 16, "z": 16}
    cases = [({"x": (0,)}, {"z": (0,)}, (4,)),
             ({"x": (0, 1)}, {"z": (1, 0)}, (2, 2)),
             ({"b": (0,), "x": (1,)}, {"b": (0,), "z": (1,)}, (2, 4))]
    for cur, tgt, gs in cases:
        got = TL.plan_redistribution(cur, tgt, sizes, gs)
        want = RL.plan_redistribution(cur, tgt, sizes, gs)
        assert [(m.axis, m.src, m.dst) for m in got] == \
            [(m.axis, m.src, m.dst) for m in want]
        for d in sizes:
            assert TL.local_size(d, sizes[d], cur, gs) == \
                RL.local_size(d, sizes[d], cur, gs)


# ------------------------------------------------ schedules and describe()
def _stage_tuple(st):
    if type(st).__name__ == "FFTStage":
        return ("fft", st.dim, st.index, st.n_in, st.n_out, st.inverse)
    return ("move", st.axis_name, st.axis_size, st.src, st.dst,
            st.src_index, st.dst_index)


@pytest.mark.parametrize("grid_shape,spec", [
    ((1,), "b x{0} y z -> b X Y Z{0}"),
    ((4,), "b x{0} y z -> b X Y Z{0}"),
    ((2, 2), "b x{0} y{1} z -> b X Y{0} Z{1}"),
    ((2, 2), "b{0} x{1} y z -> b{0} X Y Z{1}"),
    ((2, 2, 2), "b{0} x{1} y{2} z -> b{0} X Y{1} Z{2}"),
])
def test_stage_lists_and_describe_equal_reference(grid_shape, spec):
    b = (T.Domain((0,), (3,)), R.Domain((0,), (3,)))
    dom = (T.Domain((0, 0, 0), (15, 15, 15)),
           R.Domain((0, 0, 0), (15, 15, 15)))
    tp = T.fftb(spec, domains=(b[0], dom[0]),
                grid=T.ProcGrid.create_abstract(list(grid_shape)))
    rp = R.fftb(spec, domains=(b[1], dom[1]),
                grid=R.ProcGrid.create_abstract(list(grid_shape)))
    for a, r in ((tp, rp), (tp.inverse(), rp.inverse()),
                 (tp.adjoint(), rp.adjoint())):
        assert [_stage_tuple(s) for s in a.stages] == \
            [_stage_tuple(s) for s in r.stages]
        assert a.describe() == r.describe()
        assert a.flop_count() == r.flop_count()
        assert a.comm_stats() == r.comm_stats()
        assert a.scale == r.scale


@pytest.mark.parametrize("grid_shape", [(1,), (4,), (2, 2)])
def test_planewave_plans_describe_equal_reference(grid_shape):
    tg = T.ProcGrid.create_abstract(list(grid_shape))
    rg = R.ProcGrid.create_abstract(list(grid_shape))
    fft_axes = (len(grid_shape) - 1,)
    batch_axes = tuple(a for a in range(len(grid_shape))
                       if a not in fft_axes)
    tinv, tfwd = T.make_planewave_pair(tg, 32, T.sphere_for_cutoff(32), 4,
                                       batch_axes=batch_axes)
    rinv, rfwd = R.make_planewave_pair(rg, 32, R.sphere_for_cutoff(32), 4,
                                       batch_axes=batch_axes)
    assert tinv.describe() == rinv.describe()
    assert tfwd.describe() == rfwd.describe()
    spheres_t = [T.kpoint_sphere(8, k) for k in ((0, 0, 0), (0.5, 0, 0))]
    spheres_r = [R.kpoint_sphere(8, k) for k in ((0, 0, 0), (0.5, 0, 0))]
    sti, _ = T.make_stacked_planewave_pair(tg, 16, spheres_t, 2,
                                           batch_axes=batch_axes)
    sri, _ = R.make_stacked_planewave_pair(rg, 16, spheres_r, 2,
                                           batch_axes=batch_axes)
    assert sti.describe() == sri.describe()
    assert sti.npacked_max == sri.npacked_max
    assert sti.padding_fraction == sri.padding_fraction


def test_realized_backend_and_flops():
    assert realized_backend(16, 32, "cuda") == "cuda"
    assert realized_backend(16, 32, "matmul") == "matmul"
    big = MATMUL_MAX_N + 1
    assert realized_backend(big, big, "cuda") == "fft"
    assert realized_backend(16, big, "matmul") == "fft"
    with pytest.raises(ValueError):
        realized_backend(8, 8, "pallas")
    assert dft_flops(big, big, 4, "cuda") == dft_flops(big, big, 4, "fft")
    assert dft_flops(32, 16, 4, "cuda") == 8 * 32 * 16 * 4


# ----------------------------------------------------------- line DFTs
@pytest.mark.parametrize("backend", ["fft", "matmul", "cuda"])
@pytest.mark.parametrize("axis,n_out,inverse", [
    (2, 32, True), (1, 3, False), (0, 3, True), (2, 24, False)])
def test_local_dft_matches_reference(backend, axis, n_out, inverse):
    rng = np.random.default_rng(9 + axis)
    x = _cx(rng, (3, 5, 24))
    got = local_dft(torch.as_tensor(x), axis, n_out, inverse=inverse,
                    backend=backend)
    want = ref_local_dft(jnp.asarray(x), axis, n_out, inverse=inverse,
                         backend=REF_BACKEND[backend])
    _close(got.numpy(), want)


def test_cube_fft_matches_numpy_on_cpu_grid():
    g = T.ProcGrid.create([1], device="cpu")
    plan = T.fftb("b x{0} y z -> b X Y Z{0}",
                  domains=(T.Domain((0,), (1,)),
                           T.Domain((0, 0, 0), (7, 7, 7))), grid=g)
    rng = np.random.default_rng(0)
    x = _cx(rng, (2, 8, 8, 8))
    _close(plan(torch.as_tensor(x)).numpy(),
           np.fft.fftn(x, axes=(1, 2, 3)), rtol=1e-5)
    _close(plan.inverse()(plan(torch.as_tensor(x))).numpy(), x, rtol=1e-5)


# ------------------------------------- how the "cuda" route reads lines
def _held(shape, mem, offset=0):
    """A zero complex64 block of logical ``shape`` whose dims lie in
    memory in the order ``mem`` (outermost first), its base ``offset``
    elements into its buffer."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + offset, dtype=torch.complex64)[offset:]
    buf = buf.view([shape[d] for d in mem])
    return buf.permute(*[mem.index(d) for d in range(len(shape))])


def _memory_order(t):
    """The dims of ``t`` of size > 1, outermost in memory first."""
    return [d for d in sorted(range(t.ndim), key=lambda d: -t.stride(d))
            if t.shape[d] > 1]


def _fits(L):
    return L >= 2 and L % 2 == 0 and (L % 64 == 0 or 64 % L == 0)


@pytest.mark.parametrize("mem", [(0, 1, 2, 3), (0, 2, 3, 1), (0, 3, 2, 1),
                                 (3, 1, 0, 2)])
def test_line_read_views_lines_in_memory_order(mem):
    """For every axis of a dense 4D block: the other dims in memory order,
    split at the axis into (planes, K, L); rows when the axis is
    innermost, else strided where L fits the tile (on the card) and copied
    where it does not, or off the card."""
    from repro_torch.core.local_fft import line_read
    shape = (3, 4, 8, 16)
    x = _held(shape, list(mem))
    for axis in range(4):
        at = mem.index(axis)
        outer, inner = list(mem[:at]), list(mem[at + 1:])
        L = int(np.prod([shape[d] for d in inner]))
        card = line_read(x, axis, strided=True)
        host = line_read(x, axis, strided=False)
        for rd in (card, host):
            assert rd.order == tuple(outer + inner)
            assert rd.outer == len(outer) and rd.K == shape[axis]
            assert rd.planes == int(np.prod([shape[d] for d in outer]))
            assert rd.L == L
        want = "rows" if not inner else ("strided" if _fits(L)
                                         else "copied")
        assert card.route == want
        assert host.route == ("rows" if not inner else "copied")
        # the strided view is the block itself
        if card.route == "strided":
            v = x.permute(*outer, axis, *inner).view(card.planes, card.K,
                                                      card.L)
            assert v.data_ptr() == x.data_ptr()


@pytest.mark.parametrize("case", ["non-dense", "odd-l", "l-not-fit",
                                  "misaligned", "rows-non-dense"])
def test_line_read_falls_back_to_a_copy(case):
    """Lines the strided entry cannot take are copied into rows: a slice
    that is not dense, an odd L, an L that is neither a divisor nor a
    multiple of 64, a base off 16 bytes; the route still computes the
    DFT."""
    from repro_torch.core.local_fft import LINE_READS, line_read
    axis = 1
    if case == "non-dense":
        x = _held((2, 8, 4, 16), [0, 1, 2, 3])[:, :, :, ::2]
    elif case == "odd-l":
        x = _held((2, 8, 5, 3), [0, 1, 2, 3])
    elif case == "l-not-fit":
        x = _held((2, 8, 6, 8), [0, 1, 2, 3])
    elif case == "misaligned":
        x = _held((2, 8, 4, 16), [0, 1, 2, 3], offset=1)
        assert x.data_ptr() % 16
        assert line_read(_held((2, 8, 4, 16), [0, 1, 2, 3], offset=2),
                         axis, strided=True).route == "strided"
    else:
        x, axis = _held((2, 8, 4, 16), [0, 1, 2, 3])[:, ::2], 3
    assert line_read(x, axis, strided=True).route == "copied"
    x.copy_(torch.as_tensor(_cx(np.random.default_rng(3), tuple(x.shape))))
    before = LINE_READS["copied"]
    got = local_dft(x, axis, 2 * x.shape[axis], inverse=True,
                    backend="cuda")
    assert LINE_READS["copied"] == before + 1
    _close(got.numpy(), local_dft(x, axis, 2 * x.shape[axis], inverse=True,
                                  backend="fft").numpy())


# the paper pair's line stages at n = 16, d = 8, b = 4 (the toy pair):
# (input shape, its memory order as the executor leaves it, axis, n_out,
# inverse, route on the card, output memory order), dims b=0, x=1, y=2,
# z=3
PAIR_STAGES = {
    "idft[x]": ((4, 8, 8, 16), (0, 1, 2, 3), 1, 16, True, "strided",
                [0, 2, 3, 1]),
    "idft[y]": ((4, 16, 8, 16), (0, 2, 3, 1), 2, 16, True, "strided",
                [0, 3, 1, 2]),
    "dft[Y]": ((4, 16, 16, 16), (0, 3, 1, 2), 2, 8, False, "rows",
               [0, 3, 1, 2]),
    "dft[X]": ((4, 16, 8, 16), (0, 3, 1, 2), 1, 8, False, "strided",
               [0, 3, 2, 1]),
}


@pytest.mark.parametrize("stage", list(PAIR_STAGES))
def test_cuda_route_on_the_pair_stage_layouts(stage):
    """Each stage of the pair, its input held as the previous stage leaves
    it: the "cuda" route against the "fft" oracle, the route the card
    would take, and the memory order it leaves (the other dims as they
    lay, the new axis innermost)."""
    from repro_torch.core.local_fft import line_read
    shape, mem, axis, n_out, inverse, route, out_mem = PAIR_STAGES[stage]
    x = _held(shape, list(mem))
    x.copy_(torch.as_tensor(_cx(np.random.default_rng(len(stage)), shape)))
    assert line_read(x, axis, strided=True).route == route
    got = local_dft(x, axis, n_out, inverse=inverse, backend="cuda")
    want = local_dft(x.contiguous(), axis, n_out, inverse=inverse,
                     backend="fft")
    _close(got.numpy(), want.numpy())
    assert _memory_order(got) == out_mem


def _stage_walk(monkeypatch):
    """Every line stage's (input memory order, route on the card, output
    memory order), recorded as the stages run."""
    from repro_torch.core.local_fft import line_read
    seen = []
    real = FFTStage.apply

    def apply(self, x):
        y = real(self, x)
        seen.append((f"{'idft' if self.inverse else 'dft'}[{self.dim}]",
                     _memory_order(x),
                     line_read(x, self.index, strided=True).route,
                     _memory_order(y)))
        return y
    monkeypatch.setattr(FFTStage, "apply", apply)
    return seen


def test_toy_pair_layouts_step_by_step(monkeypatch):
    """The toy pair (n = 16, d = 8) through ``unpack_transform`` and
    ``transform_pack`` on the CPU: each line stage reads its input where
    the previous one left it, the cube lies (b, z, X, Y), and the slab
    the fused pack gets lies (b, z, y', x'), which the pack kernel reads
    in place (layout 2)."""
    from repro_torch.kernels import sphere_pack
    seen = _stage_walk(monkeypatch)
    slabs = []
    real_pack = sphere_pack.dft_pack

    def pack(slab, *args, **kwargs):
        slabs.append(slab)
        return real_pack(slab, *args, **kwargs)
    monkeypatch.setattr(sphere_pack, "dft_pack", pack)
    g = T.ProcGrid.create([1], device="cpu")
    inv, fwd = T.make_planewave_pair(g, 16, T.kpoint_sphere(8), 4,
                                     backend="cuda")
    c = torch.as_tensor(_cx(np.random.default_rng(8),
                            (4, inv.sphere.npacked)))
    cube = inv.unpack_transform(c)
    out = fwd.transform_pack(cube)
    b, x, y, z = 0, 1, 2, 3
    assert seen == [
        ("idft[x]", [b, x, y, z], "strided", [b, y, z, x]),
        ("idft[y]", [b, y, z, x], "strided", [b, z, x, y]),
        ("dft[Y]", [b, z, x, y], "rows", [b, z, x, y]),
        ("dft[X]", [b, z, x, y], "strided", [b, z, y, x])]
    assert _memory_order(cube) == [b, z, x, y]
    assert len(slabs) == 1 and sphere_pack.slab_layout(slabs[0]) == 2
    _close(out.numpy(), c.numpy(), rtol=1e-5)


def test_fftb_probe_counts_line_reads_by_route():
    """On the CPU a call pair reads one stage as rows and copies the
    other three (the plain version needs rows); no stage reads strided
    lines off the card."""
    from repro_torch.obs.metrics import global_metrics
    g = T.ProcGrid.create([1], device="cpu")
    inv, fwd = T.make_planewave_pair(g, 16, T.kpoint_sphere(8), 4,
                                     backend="cuda")
    c = torch.as_tensor(_cx(np.random.default_rng(9),
                            (4, inv.sphere.npacked)))
    keys = ("line_reads_rows", "line_reads_strided", "line_reads_copied")
    before = global_metrics().snapshot()["fftb"]
    for _ in range(2):
        fwd.transform_pack(inv.unpack_transform(c))
    after = global_metrics().snapshot()["fftb"]
    assert [after[k] - before[k] for k in keys] == [2, 0, 6]


# ---------------------------------------------------- plane-wave wrappers
KPTS2 = ((0.0, 0.0, 0.0), (0.5, 0.5, 0.5))


@pytest.fixture(scope="module")
def ref_grid():
    return R.ProcGrid.create([1], ["torch_port_ref"])


@pytest.mark.parametrize("backend", ["fft", "matmul", "cuda"])
def test_planewave_round_trip_matches_reference(backend, ref_grid):
    g = T.ProcGrid.create([1], device="cpu")
    sph_t, sph_r = T.kpoint_sphere(8, KPTS2[1]), R.kpoint_sphere(8, KPTS2[1])
    inv, fwd = T.make_planewave_pair(g, 16, sph_t, 3, backend=backend)
    rinv, rfwd = R.make_planewave_pair(ref_grid, 16, sph_r, 3)
    rng = np.random.default_rng(5)
    c = _cx(rng, (3, sph_t.npacked))
    psi = inv(inv.unpack(torch.as_tensor(c)))
    rpsi = rinv(rinv.unpack(jnp.asarray(c)))
    _close(psi.numpy(), rpsi)
    # forward ∘ inverse is the identity on the sphere
    back = inv.pack(fwd(psi))
    _close(back.numpy(), c, rtol=1e-5)
    _close(back.numpy(), rinv.pack(rfwd(rpsi)))


@pytest.mark.parametrize("backend", ["matmul", "cuda"])
def test_stacked_fused_entry_points_match_reference(backend, ref_grid):
    """``unpack_transform``/``transform_pack`` — on "cuda" the fused
    sphere-pack route (plain kernel versions on the CPU), elsewhere the
    composed route — against the reference's composed stacked pair."""
    g = T.ProcGrid.create([1], device="cpu")
    nb = 3
    st = [T.kpoint_sphere(8, k) for k in KPTS2]
    sr = [R.kpoint_sphere(8, k) for k in KPTS2]
    inv, fwd = T.make_stacked_planewave_pair(g, 16, st, nb, backend=backend)
    rinv, rfwd = R.make_stacked_planewave_pair(ref_grid, 16, sr, nb)
    assert (inv._fused_in_parts() is not None) == (backend == "cuda")
    assert (fwd._fused_out_parts() is not None) == (backend == "cuda")
    rng = np.random.default_rng(6)
    blocks = [_cx(rng, (nb, s.npacked)) for s in st]
    c = inv.stack([torch.as_tensor(b) for b in blocks])
    rc = rinv.stack([jnp.asarray(b) for b in blocks])
    # garbage in padded lanes must never reach the cube
    c[:nb, st[0].npacked:] = 7.0
    c[nb:, st[1].npacked:] = 7.0
    psi = inv.unpack_transform(c)
    rpsi = rinv(rinv.unpack(rc))
    _close(psi.numpy(), rpsi)
    rng2 = np.random.default_rng(7)
    cube = _cx(rng2, tuple(psi.shape))
    out = fwd.transform_pack(torch.as_tensor(cube)).numpy()
    _close(out, rinv.pack(rfwd(jnp.asarray(cube))))
    pad = ~np.repeat(inv.valid_lanes(), nb, axis=0)
    assert pad.any()
    assert np.all(out[pad] == 0) and not np.signbit(out[pad].real).any() \
        and not np.signbit(out[pad].imag).any()
    parts = inv.split(torch.as_tensor(out))
    assert [tuple(p.shape) for p in parts] == [(nb, s.npacked) for s in st]


# ------------------------------------------------- cache, grids, entry
def test_plan_cache_hits_and_first_insert_wins():
    cache = T.PlanCache(maxsize=4)
    g = T.ProcGrid.create_abstract([2])
    dom = T.Domain((0, 0, 0), (7, 7, 7))
    searches = FftPlan.searches
    p1 = T.fftb.plan_for("x{0} y z -> X Y Z{0}", domains=dom, grid=g,
                         cache=cache)
    p2 = T.fftb.plan_for("x{0} y z -> X Y Z{0}", domains=dom, grid=g,
                         cache=cache)
    assert p1 is p2 and FftPlan.searches == searches + 1
    assert cache.stats["hits"] == 1 and cache.stats["misses"] == 1
    assert cache.resident_bytes == p1.estimated_bytes()
    assert cache.get_or_build("k", lambda: "a") == "a"
    assert cache.get_or_build("k", lambda: "b") == "a"
    assert p1.inverse().inverse() is p1


def test_single_device_moves_and_refusals():
    mv = MoveStage("g0", 1, "x", "z", 1, 3)
    x = torch.ones(2, 3)
    assert mv.apply(x) is x
    # a move over 4 processes: its split dim must divide into 4 blocks,
    # and a grid of 4 points needs torch.distributed's 4 processes
    with pytest.raises(ValueError, match="does not split into 4"):
        MoveStage("g0", 4, "x", "z", 0, 1).apply(x)
    with pytest.raises(RuntimeError, match="initialize torch.distributed"):
        T.ProcGrid.create([4], device="cpu")
    g = T.ProcGrid.create([1], device="cpu")
    plan = T.fftb("x{0} y -> X Y{0}", domains=T.Domain((0, 0), (3, 3)),
                  grid=g)
    # the lazy executor runs on one device and matches the eager one
    x = torch.arange(16, dtype=torch.float32).reshape(4, 4).to(
        torch.complex64)
    np.testing.assert_allclose(
        plan(x, policy=ExecPolicy(mode="lazy")).numpy(), plan(x).numpy(),
        rtol=1e-4, atol=1e-3)
    ab = T.fftb("x{0} y -> X Y{0}", domains=T.Domain((0, 0), (3, 3)),
                grid=T.ProcGrid.create_abstract([2]))
    with pytest.raises(RuntimeError, match="abstract"):
        ab(torch.ones(4, 4, dtype=torch.complex64))
    assert all(isinstance(s, (FFTStage, MoveStage)) for s in plan.stages)


def test_entry_points_without_device_raise_when_cuda_absent(monkeypatch):
    from repro_torch.dft import PlaneWaveBasis, SCFConfig, run_scf
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.ProcGrid.create()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlaneWaveBasis(16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_scf(SCFConfig(n=16, nbands=2, max_iter=1))
    # asking for the CPU explicitly is the only way onto it
    assert PlaneWaveBasis(16, device="cpu").device == torch.device("cpu")


def test_device_helpers_without_device_raise_when_cuda_absent(monkeypatch):
    """``dft_matrix_device`` and ``coulomb_kernel`` resolve a missing
    device as every entry point does: CUDA, or raise."""
    from repro_torch.core.local_fft import dft_matrix_device
    from repro_torch.dft.hartree import coulomb_kernel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dft_matrix_device(16, 8, True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coulomb_kernel(8, 10.0)
    assert dft_matrix_device(16, 8, True, "cpu")[2].device.type == "cpu"
    assert coulomb_kernel(8, 10.0, "cpu").device.type == "cpu"


# ------------------------------------------------------------- isolation
def _port_sources():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_repro():
    bad = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for nm in names:
                root = nm.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.name}: {nm}")
    assert not bad, bad
    code = (
        "import sys, importlib, pkgutil, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=False)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
