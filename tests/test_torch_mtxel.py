"""GW matrix elements (``repro_torch.dft.mtxel``) against the plain
reference of the port's benchmark (``portbench/reference_mtxel.py``, plain
PyTorch in float64), at n = 16, d = 8, d_eps = 4 with 3 valence and 6
conduction bands on seeded random coefficients, on each line-DFT route the
CPU has (the "cuda" route runs its kernels' plain versions there) and, in
a ``cuda``-marked test, on the card.

The cut-off sphere lies about G = 0 (``cutoff_sphere``): its G = 0 lane is
<v|c> / n³ (Parseval, the inverse carrying the 1/n³), checked on its own.

Tolerance: the port transforms and multiplies in float32 (the card's
kernels in split TF32, as accurate); against float64 its matrix elements
agree to ~1e-7 of the largest one (a few float32 roundings through three
line stages a leg).  ``TOL = 1e-5`` leaves two orders of magnitude of
room, as the benchmark's limit does, and stays far below what a wrong
answer gives: an unconjugated ψ_v, or the forward onto the d-sphere
instead of the d_eps-sphere, is off by the order of the answer itself.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import gap  # noqa: E402
from portbench.reference_mtxel import MatrixElements  # noqa: E402
from repro_torch.core import ProcGrid, kpoint_sphere  # noqa: E402
from repro_torch.dft import (centring_phase, cutoff_sphere,  # noqa: E402
                             mtxel_plans, pair_density, valence_conjugates)
from repro_torch.obs.metrics import global_metrics  # noqa: E402
from repro_torch.obs.trace import get_tracer  # noqa: E402

N, D, D_EPS, NV, NC = 16, 8, 4, 3, 6
TOL = 1e-5


def _coeffs(rows, d, seed, dev="cpu"):
    g = torch.Generator().manual_seed(seed)
    c = torch.randn((rows, kpoint_sphere(d).npacked), dtype=torch.complex64,
                    generator=g)
    return c.to(dev)


def _plans(backend, dev="cpu", n=N, d=D, d_eps=D_EPS, batch=NC):
    grid = ProcGrid.create([1], device=dev)
    return mtxel_plans(grid, n, kpoint_sphere(d), cutoff_sphere(d_eps),
                       batch, backend=backend)


def _reference(c_c, c_v, n=N, d=D, d_eps=D_EPS):
    ref = MatrixElements(n, d, d_eps, c_c.device)
    return [ref(c_c, ref.valence(c_v[iv])) for iv in range(c_v.shape[0])]


@pytest.mark.parametrize("backend", ["fft", "matmul", "cuda"])
def test_pair_densities_match_the_reference(backend):
    inv, fwd = _plans(backend)
    c_c, c_v = _coeffs(NC, D, 1), _coeffs(NV, D, 2)
    vconj = valence_conjugates(inv, fwd, c_v)
    assert vconj.shape == (NV, N, N, N)
    for iv, want in enumerate(_reference(c_c, c_v)):
        got = pair_density(inv, fwd, c_c, vconj[iv])
        assert got.shape == (NC, cutoff_sphere(D_EPS).npacked)
        assert gap(got, want) <= TOL, (iv, gap(got, want))


def test_cutoff_sphere_is_centred_on_g0():
    """Box index s = d_eps // 2 is the centre; the sphere holds G and -G
    alike but for the box's top face (G = +s is outside [0, d_eps))."""
    for d_eps in (4, 5, 64):
        s = cutoff_sphere(d_eps)
        assert s.center == (d_eps // 2,) * 3
        idx = s.pack_indices()
        g = np.stack([idx // d_eps ** 2, idx // d_eps % d_eps,
                      idx % d_eps], 1) - d_eps // 2
        assert (g ** 2).sum(1).max() <= (d_eps / 2) ** 2
        assert ((g == 0).all(1)).sum() == 1


@pytest.mark.parametrize("backend", ["fft", "matmul", "cuda"])
def test_g0_lane_is_the_overlap(backend):
    """M_vc(0) = sum_r conj(ψ_v) ψ_c = <v|c> / n³ on the coefficients."""
    inv, fwd = _plans(backend)
    c_c, c_v = _coeffs(NC, D, 10), _coeffs(2, D, 11)
    vconj = valence_conjugates(inv, fwd, c_v)
    g0 = int(np.flatnonzero(fwd.sphere.pack_indices()
                            == ((D_EPS // 2) * (D_EPS + 1)) * D_EPS
                            + D_EPS // 2)[0])
    for iv in range(2):
        got = pair_density(inv, fwd, c_c, vconj[iv])[:, g0]
        want = (c_v[iv].conj() * c_c).to(torch.complex128).sum(1) / N ** 3
        assert gap(got, want) <= TOL, (iv, gap(got, want))


def test_centring_phase_moves_the_spectrum():
    """e^{2πi s·r/n} with s the cut-off sphere's centre; a centre off the
    grid's points is refused."""
    inv, fwd = _plans("matmul")
    r = np.arange(N)
    k = (r[:, None, None] + r[None, :, None] + r[None, None, :]) * (D_EPS // 2)
    want = torch.as_tensor(np.exp(2j * np.pi * k / N))
    assert gap(centring_phase(inv, fwd), want) <= 1e-7
    with pytest.raises(ValueError, match="not a grid point"):
        centring_phase(inv, inv.inverse())


def test_valence_conjugates_in_blocks_keep_the_cube_layout():
    """Three valence bands through a plan of two rows: two blocks, the
    second padded; each conjugate as the reference's, in the memory order
    of the plan's own cubes."""
    inv, fwd = _plans("cuda", batch=2)
    c_v = _coeffs(NV, D, 3)
    got = valence_conjugates(inv, fwd, c_v)
    ref = MatrixElements(N, D, D_EPS, "cpu")
    phase = centring_phase(inv, fwd)
    for iv in range(NV):
        assert gap(got[iv], ref.valence(c_v[iv]) * phase) <= TOL
    cube = inv.unpack_transform(c_v[:2])
    order = sorted(range(4), key=lambda k: -cube.stride(k))
    assert got.permute(*order).is_contiguous()


@pytest.mark.parametrize("backend", ["matmul", "cuda"])
def test_wrong_answers_fail_the_tolerance(backend):
    inv, fwd = _plans(backend)
    c_c, c_v = _coeffs(NC, D, 4), _coeffs(NV, D, 5)
    want = _reference(c_c, c_v[:1])[0]
    vconj = valence_conjugates(inv, fwd, c_v[:1])[0]
    assert gap(pair_density(inv, fwd, c_c, vconj), want) <= TOL
    # ψ_v left unconjugated (the centring phase kept)
    unconj = vconj.conj() * centring_phase(inv, fwd) ** 2
    assert gap(pair_density(inv, fwd, c_c, unconj), want) > 100 * TOL
    # the forward onto the wave functions' own sphere (the inverse's
    # mirror), read as the cut-off sphere's lanes
    wrong = pair_density(inv, inv.inverse(), c_c, vconj)[:, :want.shape[1]]
    assert gap(wrong, want) > 100 * TOL


def test_product_is_in_place_when_the_dtype_holds_it():
    from repro_torch.dft.mtxel import _product
    psi = torch.randn((2, 4, 4, 4), dtype=torch.complex64)
    v = torch.randn((4, 4, 4), dtype=torch.complex64)
    want = psi * v
    out = _product(psi, v)
    assert out.data_ptr() == psi.data_ptr() and torch.equal(out, want)
    wide = _product(psi.clone(), v.to(torch.complex128))
    assert wide.dtype == torch.complex128


def test_product_span_and_counters():
    """One call records ``mtxel:product`` under its ``mtxel`` span, and
    the ``mtxel`` probe counts its 6 bands and its bytes: 6 cubes of 16^3
    read and written, the valence cube read once."""
    inv, fwd = _plans("cuda")
    c_c = _coeffs(NC, D, 6)
    vconj = valence_conjugates(inv, fwd, _coeffs(1, D, 7))[0]
    keys = ("product_bands", "product_bytes")
    before = global_metrics().snapshot()["mtxel"]
    tr = get_tracer()
    tr.enable(sync=True)
    try:
        pair_density(inv, fwd, c_c, vconj)
        events = tr.events()
    finally:
        tr.disable()
        tr.clear()
    after = global_metrics().snapshot()["mtxel"]
    assert {k: after[k] - before[k] for k in keys} == {
        "product_bands": NC, "product_bytes": (2 * NC + 1) * N ** 3 * 8}
    prod = [e for e in events if e["name"] == "mtxel:product"]
    assert len(prod) == 1
    assert prod[0]["parent"] == "mtxel"
    assert prod[0]["attrs"] == {"bands": NC,
                                "bytes": (2 * NC + 1) * N ** 3 * 8}
    assert [e["name"] for e in events].count("mtxel") == 1


@pytest.mark.cuda
def test_pair_densities_on_the_card():
    """The "cuda" route on the card: the fused kernels at both ends, the
    forward reading the product where it lies (no ``relayout`` copy), the
    matrix elements within TOL of the reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    dev = torch.device("cuda", torch.cuda.current_device())
    n, d, d_eps, nc = 64, 32, 16, 8
    inv, fwd = _plans("cuda", dev, n, d, d_eps, nc)
    c_c, c_v = _coeffs(nc, d, 8, dev), _coeffs(2, d, 9, dev)
    vconj = valence_conjugates(inv, fwd, c_v)
    tr = get_tracer()
    tr.enable(sync=True)
    try:
        got = [pair_density(inv, fwd, c_c, vconj[iv]) for iv in range(2)]
        names = [e["name"] for e in tr.events()]
        spans = tr.device_summary()
    finally:
        tr.disable()
        tr.clear()
    assert "relayout" not in names
    assert names.count("fused:unpack_dft") == names.count(
        "fused:dft_pack") == 2
    assert spans["mtxel:product"]["device_ms"] > 0
    for g, want in zip(got, _reference(c_c, c_v, n, d, d_eps)):
        assert gap(g, want) <= TOL
