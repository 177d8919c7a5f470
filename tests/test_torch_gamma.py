"""Γ-point plane waves (``repro_torch.core.gamma``): two real bands per
complex transform on half the G-sphere, against the plain reference of the
port's benchmark (``portbench/reference_gamma.py``, plain PyTorch in
float64), at n = 16, d = 8 with 2 and 3 real bands on seeded coefficients
(G = 0 real), on each line-DFT route the CPU has (the "cuda" route runs its
kernels' plain versions there), and on two processes of a (2,) fft grid.

The JAX package has no Γ-point mode; the complex pair this one runs on is
held against it by the other plane-wave tests, and here the Γ inverse is
held bit for bit to that pair on the Hermitian-completed rows.

Tolerance: the port transforms in float32 (the card's kernels in split
TF32, as accurate); against float64 its cubes and round trips agree to
~2e-7 of the largest value (a few float32 roundings through three line
stages a direction; the fold and the unfold add and halve only).
``TOL = 1e-5`` leaves fifty times that, as the benchmark's limits do, and
stays far below what a wrong answer gives: an unconjugated mirror, or an
unfold without its conj F(−G) term, is off by the order of the answer.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import GapMeter, gap  # noqa: E402
from portbench.reference_gamma import (GammaSphere,  # noqa: E402
                                       GammaTransforms, fold, unphase)
from repro_torch.core import (ProcGrid, gamma_plans,  # noqa: E402
                              gamma_sphere, half_lanes, kpoint_sphere,
                              make_planewave_pair)
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.obs.metrics import global_metrics  # noqa: E402
from repro_torch.obs.trace import get_tracer  # noqa: E402

N, D = 16, 8
TOL = 1e-5
BACKENDS = ["fft", "matmul", "cuda"]


def _coeffs(nb, d=D, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = torch.randn((nb, GammaSphere(d).nhalf), dtype=torch.complex64,
                    generator=g)
    c[:, 0] = c[:, 0].real.to(c.dtype)          # G = 0, the half's first
    return c


def _plans(backend, nb, grid=None):
    grid = grid or ProcGrid.create([1], device="cpu")
    return gamma_plans(grid, N, D, nb, backend=backend)


def _cube_gap(cube, c):
    """The cube times e^{−2πi s·r/n} against real ψ_{2k} (real part) and
    ψ_{2k+1} (imaginary part; zeros past an odd last band) from the
    float64 reference, as the benchmark's judge reads it."""
    psi = GammaTransforms(N, D, "cpu").inverse(c)
    got = unphase(cube, D // 2)
    want_b = torch.zeros_like(got.real)
    want_b[:psi[1::2].shape[0]] = psi[1::2]
    meter = GapMeter()
    meter.add(got.real, psi[0::2])
    meter.add(got.imag, want_b)
    return meter.value


@pytest.mark.parametrize("d", [8, 9, 16, 128])
def test_gamma_sphere_is_closed_and_its_half_holds_each_pair_once(d):
    sphere = gamma_sphere(d)
    s = d // 2
    assert sphere.center == (s,) * 3 and sphere.extents == (d,) * 3
    idx = sphere.pack_indices()
    g = np.stack([idx // d ** 2, idx // d % d, idx % d], 1) - s
    assert (4 * (g ** 2).sum(1) < d * d).all()
    # every integer G inside |G| < d/2 is a lane, and -G of each is one
    assert len(idx) == GammaSphere(d).npacked
    assert set(map(tuple, g)) == set(map(tuple, -g))
    lane, mirror = half_lanes(sphere)
    assert (np.array_equal(g[mirror], -g[lane]))
    pairs = {frozenset((int(a), int(b))) for a, b in zip(lane, mirror)}
    assert len(pairs) == len(lane) == (len(idx) + 1) // 2
    assert set().union(*pairs) == set(range(len(idx)))
    assert (g[lane[0]] == 0).all() and lane[0] == mirror[0]
    if d == 128:
        assert (sphere.npacked, sphere.ncols, len(lane)) == (
            1_097_911, 12_849, 548_956)


def test_spheres_not_closed_under_minus_g_are_refused():
    with pytest.raises(ValueError, match="not closed"):
        half_lanes(kpoint_sphere(8, kpt=(0.5, 0.5, 0.5)))
    with pytest.raises(ValueError, match="not a grid point"):
        half_lanes(kpoint_sphere(8))


@pytest.mark.parametrize("nb", [2, 3])
@pytest.mark.parametrize("backend", BACKENDS)
def test_gamma_pair_matches_the_reference(backend, nb):
    inv, fwd = _plans(backend, nb)
    c = _coeffs(nb, seed=nb)
    cube = inv.unpack_transform(c)
    assert tuple(cube.shape) == (-(-nb // 2), N, N, N)
    assert _cube_gap(cube, c) <= TOL
    out = fwd.transform_pack(cube)
    assert tuple(out.shape) == (nb, inv.nhalf)
    assert gap(out, c) <= TOL
    assert float(out[:, 0].imag.abs().max()) == 0.0     # G = 0 stays real


@pytest.mark.parametrize("nb", [2, 3])
def test_gamma_inverse_is_the_complex_pair_on_hermitian_rows(nb):
    """The Γ inverse's cube is bit for bit the Γ sphere's ordinary complex
    pair run on the folded rows (the reference's fold)."""
    inv, _ = _plans("cuda", nb)
    plain, _ = make_planewave_pair(ProcGrid.create([1], device="cpu"), N,
                                   gamma_sphere(D), -(-nb // 2),
                                   backend="cuda")
    c = _coeffs(nb, seed=10 + nb)
    full = fold(c, GammaSphere(D))
    assert torch.equal(full, ref.gamma_fold_plain(
        c, *(torch.as_tensor(t) for t in half_lanes(gamma_sphere(D))),
        gamma_sphere(D).npacked))
    assert torch.equal(inv.unpack_transform(c), plain.unpack_transform(full))


def test_reference_round_trip_and_realness():
    """The reference itself: real ψ (its imaginary part asserted away),
    forward(inverse) the identity, the TF32 control off by ~1e-4."""
    c = _coeffs(3, seed=4).to(torch.complex128)
    hi = GammaTransforms(N, D, "cpu", "float64")
    assert hi.inverse(c).dtype == torch.float64
    assert gap(hi.round_trip(c), c) <= 1e-12
    lo = GammaTransforms(N, D, "cpu", "tf32")
    assert 1e-5 < gap(lo.round_trip(c), c) < 1e-2


def test_planted_faults_fail_the_tolerance(monkeypatch):
    import repro_torch.kernels.gamma as gk
    c = _coeffs(2, seed=5)
    inv, fwd = _plans("cuda", 2)
    assert _cube_gap(inv.unpack_transform(c), c) <= TOL

    def unconjugated(half, lane, mirror, npacked):
        out = ref.gamma_fold_plain(half, lane, mirror, npacked)
        out[:, mirror.long()] = half[0::2] + 1j * half[1::2]
        out[:, lane.long()] = half[0::2] + 1j * half[1::2]
        return out
    monkeypatch.setattr(gk, "gamma_fold_plain", unconjugated)
    assert _cube_gap(inv.unpack_transform(c), c) > 100 * TOL
    monkeypatch.undo()

    def no_mirror_term(full, lane, mirror, nb):
        f = full[:, lane.long()]
        return torch.stack((f, f * -1j), 1).reshape(-1, f.shape[1])[:nb]
    monkeypatch.setattr(gk, "gamma_unfold_plain", no_mirror_term)
    assert gap(fwd.transform_pack(inv.unpack_transform(c)), c) > 100 * TOL


def test_odd_bands_and_wrong_shapes():
    inv, fwd = _plans("matmul", 3)
    assert inv.plan.tin.shape[0] == 2 and inv.nbands == 3
    with pytest.raises(ValueError, match="half-sphere rows"):
        inv.unpack_transform(_coeffs(2))
    with pytest.raises(ValueError, match="runs on the forward"):
        inv.transform_pack(torch.zeros((2, N, N, N), dtype=torch.complex64))
    with pytest.raises(ValueError, match="runs on the inverse"):
        fwd.unpack_transform(_coeffs(3))
    with pytest.raises(ValueError, match="do not fill"):
        type(inv)(inv.plan, 5)


def test_plans_come_from_the_cache_and_charge_their_tables():
    """The tables live on the cached inverse plan, are read by the
    forward, and are charged once: to the inverse's ``private_bytes``."""
    inv, fwd = _plans("cuda", 4)
    again, _ = _plans("cuda", 4)
    assert again.plan is inv.plan and fwd.plan is inv.plan.inverse()
    assert fwd._lane is inv._lane               # one table for both
    tables = 2 * inv.nhalf * 4
    kept = inv.plan.__dict__["_private_tables"]
    memo = kept.pop("gamma")
    assert sum(int(t.nbytes) for t in memo.values()) == tables
    bare = inv.plan.private_bytes()
    kept["gamma"] = memo
    assert inv.plan.private_bytes() - bare == tables
    assert "gamma" not in fwd.plan.__dict__.get("_private_tables", {})


def test_spans_and_counters():
    """A call pair records one ``gamma`` span a direction with its pass
    under it, and the ``gamma`` probe counts the rows and the bytes: 3
    real bands of 126 lanes in, 2 complex rows of 251 lanes out, and
    back."""
    inv, fwd = _plans("cuda", 3)
    c = _coeffs(3, seed=6)
    nbytes = (3 * 126 + 2 * 251) * 8
    before = global_metrics().snapshot()["gamma"]
    tr = get_tracer()
    tr.enable(sync=True)
    try:
        fwd.transform_pack(inv.unpack_transform(c))
        events = tr.events()
    finally:
        tr.disable()
        tr.clear()
    after = global_metrics().snapshot()["gamma"]
    assert {k: after[k] - before[k] for k in after} == {
        "rows": 4, "fold_bytes": nbytes, "unfold_bytes": nbytes}
    for name in ("gamma:fold", "gamma:unfold"):
        ev = [e for e in events if e["name"] == name]
        assert len(ev) == 1 and ev[0]["parent"] == "gamma"
        assert ev[0]["attrs"] == {"bands": 3, "bytes": nbytes}
    top = [e for e in events if e["name"] == "gamma"]
    assert [e["attrs"]["inverse"] for e in top] == [True, False]


# ------------------------------------------------------------ two ranks
def _two_ranks(rank):
    """Three real bands on a (2,) grid, split over the fft axis (x on the
    sphere side, Z on the cube's) and over the batch (complex row k on rank
    k: bands 0 and 1 on rank 0, band 2 and its zero partner on rank 1)."""
    from repro_torch.core import ProcGrid as Grid
    grid = Grid.create([2], device="cpu")
    c = _coeffs(3, seed=7)
    out = {}
    for name, axes in (("fft", ()), ("batch", (0,))):
        inv, fwd = gamma_plans(grid, N, D, 3, backend="cuda",
                               batch_axes=axes)
        mine = inv.local_bands(c)
        cube = inv.unpack_transform(mine)
        back = fwd.transform_pack(cube)
        out[name] = (inv.plan.tout.gather(cube).numpy(), mine.numpy(),
                     back.numpy())
    return out


def test_two_ranks_match_one(tmp_path):
    """Two gloo processes: on the fft split and on the batch split, the
    gathered cube within TOL of one rank's and of the reference, and each
    rank's round trip of its own bands within TOL (the pack's merge over x
    leaves every rank both G and −G; a band pair rides one rank)."""
    from repro_torch.sharding.procs import run_ranks
    ranks = run_ranks(_two_ranks, 2, rendezvous_dir=str(tmp_path),
                      timeout=240, nice=19)
    inv, _ = _plans("cuda", 3)
    c = _coeffs(3, seed=7)
    cube = inv.unpack_transform(c)
    for name, bands in (("fft", [3, 3]), ("batch", [2, 1])):
        for rank, out in enumerate(ranks):
            got_cube, mine, back = out[name]
            assert mine.shape[0] == bands[rank], (name, rank)
            assert gap(got_cube, cube) <= TOL
            assert _cube_gap(torch.as_tensor(got_cube), c) <= TOL
            assert gap(back, mine) <= TOL
