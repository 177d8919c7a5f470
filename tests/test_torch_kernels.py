"""repro_torch.kernels: plain versions vs the JAX reference kernels.

On the CPU every wrapper runs its plain PyTorch version (a CPU tensor is
the only thing that selects it); the reference Pallas kernels run in
interpret mode, as ``tests/test_kernels.py`` runs them.  The hand-written
CUDA kernels themselves are held against the plain versions by
``tests/test_torch_cuda.py`` (skipped without a card).

Tolerances: the port and the reference sum the same fp32 products in
another order (torch's CPU GEMM vs XLA's dot), so values agree to ~1e-6
relative to the largest output (the two-stage four-step DFT to 1e-5);
exact-zero contracts stay bitwise.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import kpoint_sphere as ref_kpoint_sphere
from repro.core.local_fft import dft_matrix_device as ref_dft_matrix_device
from repro.kernels import ops as ref_ops
from repro.kernels import sphere_pack as ref_sp
from repro.kernels.dft_matmul import dft_matmul as ref_dft_matmul
from repro.kernels.ref import complex_matmul_ref as ref_complex_matmul_ref
from repro.kernels.ref import dft_apply_ref as ref_dft_apply_ref
from repro.kernels.ref import twiddle_matrix as ref_twiddle_matrix
from repro_torch.core import kpoint_sphere
from repro_torch.core.local_fft import dft_matrix_device
from repro_torch.kernels import build, ops
from repro_torch.kernels import sphere_pack as sp
from repro_torch.kernels.dft_matmul import (dft_matmul, dft_matmul_plain,
                                            dft_matmul_twiddle,
                                            dft_matmul_twiddle_plain,
                                            embed_operand, tf32_split)
from repro_torch.kernels.ref import (complex_matmul_ref, dft_apply_ref,
                                     four_step_ref, twiddle_matrix)

RTOL = 2e-6          # relative to the largest output magnitude


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


def _plus_zero(a) -> bool:
    a = np.asarray(a)
    parts = (a.real, a.imag) if np.iscomplexobj(a) else (a,)
    return all(bool(np.all((p == 0) & ~np.signbit(p))) for p in parts)


# ------------------------------------------------------------ dft_matmul
DFT_APPLY_CASES = [(1, 8, 8, False), (33, 16, 16, True), (256, 8, 32, True),
                   (16, 32, 8, False), (40, 24, 48, True),
                   (16, 128, 64, False)]


@pytest.mark.parametrize("B,n_in,n_out,inverse", DFT_APPLY_CASES)
def test_dft_apply_matches_reference_pallas(B, n_in, n_out, inverse):
    rng = np.random.default_rng(B * 1000 + n_in * 10 + n_out)
    x = _cx(rng, (B, n_in))
    y = ops.dft_apply(torch.as_tensor(x), n_out, inverse=inverse)
    r = ref_ops.dft_apply(jnp.asarray(x), n_out, inverse=inverse,
                          interpret=True)
    assert y.dtype == torch.complex64
    _close(y.numpy(), r)


@pytest.mark.parametrize("B,n_in,n_out,inverse", DFT_APPLY_CASES)
def test_dft_apply_matches_fft_oracle(B, n_in, n_out, inverse):
    """``dft_apply`` against ``dft_apply_ref`` (torch.fft of the padded or
    truncated line, no DFT matrix), and that oracle against the
    reference's ``dft_apply_ref`` (jnp.fft)."""
    rng = np.random.default_rng(B * 1000 + n_in * 10 + n_out)
    x = _cx(rng, (B, n_in))
    want = dft_apply_ref(torch.as_tensor(x), n_out, inverse=inverse)
    assert want.shape == (B, n_out) and want.dtype == torch.complex64
    _close(ops.dft_apply(torch.as_tensor(x), n_out, inverse=inverse).numpy(),
           want.numpy())
    _close(want.numpy(), ref_dft_apply_ref(jnp.asarray(x), n_out,
                                           inverse=inverse))


def test_dft_matmul_plain_matches_raw_reference_kernel():
    rng = np.random.default_rng(7)
    B, K, N = 64, 32, 48
    x = _cx(rng, (B, K))
    w = _cx(rng, (N, K))
    yr, yi = ref_dft_matmul(jnp.asarray(x.real), jnp.asarray(x.imag),
                            jnp.asarray(w.real), jnp.asarray(w.imag),
                            bm=32, bn=16, interpret=True)
    y = dft_matmul(torch.as_tensor(x), torch.as_tensor(w))
    _close(y.numpy(), np.asarray(yr) + 1j * np.asarray(yi))
    # the wrapper on a CPU tensor is exactly its plain version
    assert torch.equal(y, dft_matmul_plain(torch.as_tensor(x),
                                           torch.as_tensor(w)))


@pytest.mark.parametrize("B,K,N", [(16, 8, 8), (40, 24, 48)])
def test_complex_matmul_ref_matches_reference_and_plain_gemm(B, K, N):
    """The split re/im GEMM oracle against the reference's, and the
    complex plain version of ``dft_matmul`` against the oracle."""
    rng = np.random.default_rng(B + K + N)
    x = _cx(rng, (B, K))
    w = _cx(rng, (N, K))
    parts = [x.real, x.imag, w.real, w.imag]
    yr, yi = complex_matmul_ref(*(torch.as_tensor(p) for p in parts))
    rr, ri = ref_complex_matmul_ref(*(jnp.asarray(p) for p in parts))
    y = (yr + 1j * yi).numpy()
    _close(y, np.asarray(rr) + 1j * np.asarray(ri))
    _close(dft_matmul_plain(torch.as_tensor(x), torch.as_tensor(w)).numpy(),
           y)


def test_dft_matrix_bit_identical_to_reference():
    for n_out, n_in, inv in [(16, 8, True), (8, 16, False), (32, 32, True)]:
        wr, wi, w = dft_matrix_device(n_out, n_in, inv, "cpu")
        rr, ri, _ = ref_dft_matrix_device(n_out, n_in, inv)
        assert np.array_equal(wr.numpy(), np.asarray(rr))
        assert np.array_equal(wi.numpy(), np.asarray(ri))
        assert np.array_equal(w.numpy().real, np.asarray(rr))


# ------------------------------------- split-TF32 design of the kernel
def _rna_reference(a: np.ndarray) -> np.ndarray:
    """fp32 → TF32 round to nearest, ties away from zero, computed in
    float64 from the value (not the bits): the rule of
    ``cvt.rna.tf32.f32``, which keeps 10 of fp32's 23 mantissa bits."""
    a64 = a.astype(np.float64)
    out = a64.copy()
    fin = np.isfinite(a64) & (a64 != 0)
    _, ex = np.frexp(np.abs(a64[fin]))          # |a| = m·2^ex, m in [½, 1)
    ulp = np.ldexp(1.0, np.maximum(ex - 1, -126) - 10)
    q = np.floor(np.abs(a64[fin]) / ulp + 0.5)   # ties away from zero
    out[fin] = np.sign(a64[fin]) * q * ulp
    with np.errstate(over="ignore"):
        return out.astype(np.float32)


def _bits(v) -> np.ndarray:
    return np.asarray(v, dtype=np.float32).view(np.uint32)


TF32_EDGES = np.array([
    0x3F801000, 0xBF801000,           # ties: 1 + 2^-11 → 1 + 2^-10, ±
    0x3F800FFF, 0x3F801001,           # just below / above a tie
    0x3F803000, 0xC0A01000,           # ties with an odd kept bit, ±
    0x00000000, 0x80000000,           # ±0
    0x00000001, 0x80000FFF,           # subnormals that round to ±0
    0x00001000, 0x00003000,           # subnormal ties
    0x007FFFFF, 0x807FF000,           # round up into the least normal
    0x7F7FEFFF, 0x7F000FFF, 0xFF7FE000,  # large exponents
    0x7F7FF000,                       # the largest tie: rounds to inf
], dtype=np.uint32).view(np.float32)


def test_tf32_split_rounds_as_cvt_rna():
    """(a) ``big`` has its low 13 mantissa bits zero and equals the rna
    rule bit for bit on edge values and random ones; ``small`` is the
    same rule applied to ``a − big``."""
    rng = np.random.default_rng(31)
    rand = (rng.standard_normal(4096)
            * np.exp2(rng.integers(-100, 100, 4096))).astype(np.float32)
    a = np.concatenate([TF32_EDGES, rand])
    big, small = tf32_split(torch.as_tensor(a))
    big, small = big.numpy(), small.numpy()
    assert np.all(_bits(big) & 0x1FFF == 0)
    assert np.all(_bits(small) & 0x1FFF == 0)
    assert np.array_equal(_bits(big), _bits(_rna_reference(a)))
    fin = np.isfinite(big)
    rest = (a[fin].astype(np.float64) - big[fin]).astype(np.float32)
    assert np.array_equal(_bits(small[fin]), _bits(_rna_reference(rest)))
    # inf and NaN pass unchanged
    special = torch.tensor([float("inf"), -float("inf"), float("nan")])
    b, _ = tf32_split(special)
    assert torch.equal(b[:2], special[:2]) and bool(torch.isnan(b[2]))


def test_tf32_split_keeps_fp32_accuracy():
    """(a) |a − big − small| <= 2^-22 |a| for normal values."""
    rng = np.random.default_rng(32)
    a = (rng.standard_normal(1 << 14)
         * np.exp2(rng.integers(-100, 100, 1 << 14))).astype(np.float32)
    big, small = (p.numpy().astype(np.float64)
                  for p in tf32_split(torch.as_tensor(a)))
    a64 = a.astype(np.float64)
    assert np.all(np.abs(a64 - big - small) <= 2.0 ** -22 * np.abs(a64))
    assert np.abs(a64 - big).max() > 0      # the split does keep bits


def _ref_kernel(x, w, t=None):
    """The reference Pallas kernel (``_kernel``, or ``_kernel_twiddle``
    with the table tiled to (M, N) as its wrapper passes it), in
    interpret mode, over one whole-array block."""
    M, N = x.shape[0], w.shape[0]
    args = [jnp.asarray(p) for p in (x.real, x.imag, w.real, w.imag)]
    if t is not None:
        tf = np.tile(t, (M // t.shape[0], 1))
        args += [jnp.asarray(tf.real), jnp.asarray(tf.imag)]
    yr, yi = ref_dft_matmul(*args, bm=M, bn=N, interpret=True)
    return np.asarray(yr) + 1j * np.asarray(yi)


@pytest.mark.parametrize("M,K,N", [(64, 24, 40), (16, 5, 5),
                                   (32, 128, 64)])
def test_embedding_is_the_complex_product(M, K, N):
    """(b) complex64 x read as fp32 (M, 2K) times the real embedding of W,
    summed over both TF32 planes, is the complex product."""
    rng = np.random.default_rng(M + K + N)
    x = torch.as_tensor(_cx(rng, (M, K)))
    w = torch.as_tensor(_cx(rng, (N, K)))
    wsplit = embed_operand(w)
    assert tuple(wsplit.shape) == (2, 2 * N, 2 * K)
    xh = torch.view_as_real(x).reshape(M, 2 * K)
    yh = xh @ wsplit[0].T + xh @ wsplit[1].T
    y = torch.view_as_complex(yh.reshape(M, N, 2)).numpy()
    _close(y, dft_matmul_plain(x, w).numpy(), rtol=1e-6)
    _close(y, _ref_kernel(x.numpy(), w.numpy()), rtol=1e-6)


def _three_tf32(x, w, t=None):
    """The kernel's arithmetic emulated on the CPU: x̂ split by
    ``tf32_split``, the three fp32 GEMMs ``small·big + big·small +
    big·big`` against ``embed_operand(w)``, then the twiddle product in
    the kernel's order."""
    M, K = x.shape
    N = w.shape[0]
    xb, xs = tf32_split(torch.view_as_real(x).reshape(M, 2 * K))
    wb, ws = embed_operand(w)
    yh = xs @ wb.T + xb @ ws.T + xb @ wb.T
    y = torch.view_as_complex(yh.reshape(M, N, 2).contiguous())
    if t is None:
        return y
    T = t.shape[0]
    yr, yi = y.real.reshape(M // T, T, N), y.imag.reshape(M // T, T, N)
    return torch.complex(yr * t.real - yi * t.imag,
                         yr * t.imag + yi * t.real).reshape(M, N)


@pytest.mark.parametrize("case,M,K,N,table", [
    ("ragged", 100, 24, 40, None),
    ("ragged_general_twiddle", 100, 24, 40, "general"),
    ("stage_8_to_16", 48, 8, 16, None),
    ("stage_16_to_8", 48, 16, 8, None),
    ("four_step_64", 128, 64, 64, "four_step"),
    ("odd_k_5", 30, 5, 5, None),
    ("odd_k_9_to_18", 36, 9, 18, "general"),
])
def test_three_tf32_product_matches_reference_kernel(case, M, K, N, table):
    """(c) split-TF32 products on DFT matrices against the reference's
    ``_kernel`` / ``_kernel_twiddle`` at 1e-5 of the largest output."""
    rng = np.random.default_rng(sum(map(ord, case)))
    x = _cx(rng, (M, K))
    _, _, w = dft_matrix_device(N, K, M % 2 == 0, "cpu")
    if table == "four_step":
        n1 = 64
        t = np.ascontiguousarray(twiddle_matrix(n1, N, False).T)
    elif table == "general":
        t = _cx(rng, (M, N))
    else:
        t = None
    got = _three_tf32(torch.as_tensor(x), w,
                      None if t is None else torch.as_tensor(t))
    _close(got.numpy(), _ref_kernel(x, w.numpy(), t), rtol=1e-5)


# -------------------------------------------------- twiddle + four-step
@pytest.mark.parametrize("n1,n2,inverse", [(4, 8, False), (8, 8, True),
                                           (15, 24, True), (32, 32, False)])
def test_twiddle_matrix_bit_identical_to_reference(n1, n2, inverse):
    a = twiddle_matrix(n1, n2, inverse)
    b = ref_twiddle_matrix(n1, n2, inverse)
    assert a.dtype == b.dtype == np.complex64
    assert np.array_equal(a, b)


@pytest.mark.parametrize("case", ["general", "four_step"])
def test_dft_matmul_twiddle_plain_matches_reference_kernel(case):
    """The twiddle entry against the reference's ``_kernel_twiddle`` (run
    through ``dft_matmul(..., tr, ti, interpret=True)``): a general (M, N)
    twiddle, and the four-step (n1, n2) table whose rows repeat over the
    batch — which the reference receives tiled to (M, N)."""
    rng = np.random.default_rng(21)
    if case == "general":
        M, K, N = 64, 24, 32
        t = _cx(rng, (M, N))
        t_full = t
    else:
        n1, n2, B = 8, 16, 4
        M, K, N = B * n1, n2, n2
        t = np.ascontiguousarray(twiddle_matrix(n1, n2, False).T)
        t_full = np.tile(t, (B, 1))
    x = _cx(rng, (M, K))
    w = _cx(rng, (N, K))
    yr, yi = ref_dft_matmul(jnp.asarray(x.real), jnp.asarray(x.imag),
                            jnp.asarray(w.real), jnp.asarray(w.imag),
                            jnp.asarray(t_full.real),
                            jnp.asarray(t_full.imag), bm=16, bn=16,
                            interpret=True)
    y = dft_matmul_twiddle(torch.as_tensor(x), torch.as_tensor(w),
                           torch.as_tensor(t))
    _close(y.numpy(), np.asarray(yr) + 1j * np.asarray(yi))
    assert torch.equal(y, dft_matmul_twiddle_plain(
        torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(t)))


def test_dft_matmul_twiddle_rejects_a_table_that_does_not_tile():
    x = torch.zeros((10, 4), dtype=torch.complex64)
    w = torch.zeros((4, 4), dtype=torch.complex64)
    with pytest.raises(ValueError, match="must divide"):
        dft_matmul_twiddle(x, w, torch.zeros((3, 4), dtype=torch.complex64))
    with pytest.raises(ValueError, match="shape"):
        dft_matmul_twiddle(x, w, torch.zeros((5, 3), dtype=torch.complex64))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [64, 360, 1024])
def test_four_step_dft_matches_reference(n, inverse):
    """Port vs the reference's Pallas four-step (interpret mode) at 1e-5
    of max|y|; the reference itself sits at ~1e-7 of max against a
    float64 FFT.  Also held against ``torch.fft`` (``four_step_ref``)."""
    rng = np.random.default_rng(n + int(inverse))
    x = _cx(rng, (3, n))
    y = ops.four_step_dft(torch.as_tensor(x), inverse=inverse)
    r = ref_ops.four_step_dft(jnp.asarray(x), inverse=inverse,
                              interpret=True)
    assert y.dtype == torch.complex64 and tuple(y.shape) == (3, n)
    _close(y.numpy(), r, rtol=1e-5)
    _close(y.numpy(), four_step_ref(torch.as_tensor(x), inverse=inverse),
           rtol=1e-5)


@pytest.mark.parametrize("n", [97, 127])
def test_four_step_dft_rejects_prime_n(n):
    x = torch.zeros((2, n), dtype=torch.complex64)
    with pytest.raises(ValueError, match="prime"):
        ops.four_step_dft(x)
    with pytest.raises(ValueError, match="prime"):
        ref_ops.four_step_dft(jnp.zeros((2, n), jnp.complex64),
                              interpret=True)


# ---------------------------------------------------------------- tables
BATCHES = [
    (8, 3, ((0, 0, 0), (0.5, 0.5, 0.5))),
    (6, 2, ((0, 0, 0),)),
    (4, 1, ((0.25, 0, 0.5), (0, 0, 0), (0.5, 0.5, 0))),
]


@pytest.mark.parametrize("d,nbands,kpts", BATCHES)
def test_table_builders_equal_reference(d, nbands, kpts):
    spheres = [kpoint_sphere(d, k) for k in kpts]
    ref = [ref_kpoint_sphere(d, k) for k in kpts]
    for a, b in zip(sp.line_tables(spheres, nbands),
                    ref_sp.line_tables(ref, nbands)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    npm = max(s.npacked for s in spheres) + 3
    for a, b in zip(sp.pack_gather_tables(spheres, nbands, npm),
                    ref_sp.pack_gather_tables(ref, nbands, npm)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _tables(spheres, nbands):
    return tuple(torch.as_tensor(t) for t in sp.line_tables(spheres,
                                                            nbands))


# ------------------------------------------------------------ unpack_dft
@pytest.mark.parametrize("d,n,nbands,kpts", [
    (8, 16, 3, ((0, 0, 0), (0.5, 0.5, 0.5))),
    (6, 12, 2, ((0, 0, 0),)),
    (4, 8, 1, ((0.25, 0, 0.5), (0, 0, 0), (0.5, 0.5, 0))),
])
def test_unpack_dft_matches_reference_pallas(d, n, nbands, kpts):
    spheres = [kpoint_sphere(d, k) for k in kpts]
    B = len(spheres) * nbands
    npm = max(s.npacked for s in spheres)
    rng = np.random.default_rng(d * 100 + n)
    # garbage beyond each row's npacked lanes: never read by either side
    packed = _cx(rng, (B, npm))
    start, zlo, cnt, flag = sp.line_tables(spheres, nbands)
    wr, wi, _ = ref_dft_matrix_device(n, d, True)
    rr, ri = ref_sp.unpack_dft(
        jnp.asarray(packed.real), jnp.asarray(packed.imag),
        jnp.asarray(start), jnp.asarray(zlo), jnp.asarray(cnt),
        jnp.asarray(flag), wr, wi, interpret=True)
    _, _, w = dft_matrix_device(n, d, True, "cpu")
    y = sp.unpack_dft(torch.as_tensor(packed), *_tables(spheres, nbands),
                      w)
    assert tuple(y.shape) == (B, d, d, n)
    _close(y.numpy(), np.asarray(rr) + 1j * np.asarray(ri))
    # lines with no lanes are exact +0.0
    empty = (cnt == 0).reshape(B, d, d)
    assert _plus_zero(y.numpy()[empty])


def test_unpack_dft_zero_skip_planes_are_plus_zero():
    spheres = [kpoint_sphere(6, (0, 0, 0))]
    start, zlo, cnt, flag = _tables(spheres, 2)
    rng = np.random.default_rng(3)
    packed = torch.as_tensor(_cx(rng, (2, spheres[0].npacked)))
    _, _, w = dft_matrix_device(12, 6, True, "cpu")
    flag0 = flag.clone()
    flag0[2] = 0                      # force the skip path on plane x=2
    y = sp.unpack_dft(packed, start, zlo, cnt, flag0, w).numpy()
    assert _plus_zero(y[:, 2])
    assert np.any(y[:, 1] != 0.0)


def test_unpack_dft_never_reads_padded_lanes():
    spheres = [kpoint_sphere(8, k) for k in ((0, 0, 0), (0.5, 0.5, 0.5))]
    nb = 2
    npm = max(s.npacked for s in spheres)
    rng = np.random.default_rng(4)
    packed = _cx(rng, (len(spheres) * nb, npm))
    poisoned = packed.copy()
    for k, s in enumerate(spheres):
        poisoned[k * nb:(k + 1) * nb, s.npacked:] = np.nan
    _, _, w = dft_matrix_device(16, 8, True, "cpu")
    tabs = _tables(spheres, nb)
    a = sp.unpack_dft(torch.as_tensor(packed), *tabs, w)
    b = sp.unpack_dft(torch.as_tensor(poisoned), *tabs, w)
    assert torch.equal(a, b)


# ---------------------------------------------- unpack_dft's chunk table
# d = 40: 2d = 80 columns, three K chunks of 16 complex (the last partial),
# 128-line tiles straddling the 40-line planes; edge tiles need fewer
CHUNK_SETS = [((0, 0, 0),), ((0, 0, 0), (0.5, 0.5, 0.5)),
              ((0.25, 0, 0.5), (0, 0, 0), (0.5, 0.5, 0))]


def _unpack_over_chunks(packed, start, zlo, cnt, flag, w, ranges):
    """unpack_dft_plain with each 128-line tile's GEMM restricted to the
    K chunks of ``ranges``."""
    B, npk = packed.shape
    n, d = w.shape
    nl = start.shape[1]
    lane, inside = sp._line_masks(start, zlo, cnt, d)
    lines = torch.where(inside, torch.gather(
        packed, 1, lane.clamp(0, npk - 1).reshape(B, nl * d)).reshape(
            B, nl, d), torch.zeros((), dtype=torch.complex64))
    lines = lines.reshape(B * nl, d)
    y = torch.zeros((B * nl, n), dtype=torch.complex64)
    for t, (first, last) in enumerate(ranges.tolist()):
        rows = slice(t * sp.TILE_ROWS, (t + 1) * sp.TILE_ROWS)
        cols = slice(first * sp.CHUNK, last * sp.CHUNK)
        if first < last:
            y[rows] = dft_matmul_plain(lines[rows, cols], w[:, cols])
    plane = torch.arange(nl) // (nl // flag.numel())
    active = ((flag.reshape(-1)[plane] != 0)[None, :] & (cnt > 0))
    y = torch.where(active.reshape(-1, 1), y, torch.zeros(
        (), dtype=torch.complex64))
    return y.reshape(B, flag.numel(), nl // flag.numel(), n)


@pytest.mark.parametrize("kpts", CHUNK_SETS, ids=["1k", "2k", "3k"])
def test_chunk_ranges_cover_active_lines_and_keep_the_result(kpts):
    d, n, nb = 40, 80, 2
    spheres = [kpoint_sphere(d, k) for k in kpts]
    start, zlo, cnt, flag = _tables(spheres, nb)
    flag0 = flag.clone()
    flag0[d // 2] = 0                        # a plane with support, off
    rng = np.random.default_rng(len(kpts))
    packed = torch.as_tensor(_cx(rng, (len(spheres) * nb, max(
        s.npacked for s in spheres))))
    _, _, w = dft_matrix_device(n, d, True, "cpu")
    nk = -(-2 * d // 32)
    skipped = 0
    for fl in (flag, flag0):
        ranges = sp.chunk_ranges(zlo, cnt, fl)
        rows = zlo.numel()
        assert ranges.dtype == torch.int32
        assert tuple(ranges.shape) == (-(-rows // sp.TILE_ROWS), 2)
        first, last = ranges[:, 0].long(), ranges[:, 1].long()
        assert bool(((0 <= first) & (first <= last) & (last <= nk)).all())
        # every active line's [zlo, zlo + cnt) lies inside its tile's range
        plane = torch.arange(zlo.shape[1]) // d
        active = ((fl.reshape(-1)[plane] != 0)[None, :]
                  & (cnt > 0)).reshape(-1)
        tile = torch.arange(rows) // sp.TILE_ROWS
        lo, hi = zlo.reshape(-1).long(), (zlo + cnt).reshape(-1).long()
        assert bool((first[tile] * sp.CHUNK <= lo)[active].all())
        assert bool((hi <= last[tile] * sp.CHUNK)[active].all())
        # a tile with no active line reads nothing
        any_on = torch.zeros(len(ranges), dtype=torch.bool).index_put_(
            (tile[active],), torch.tensor(True))
        assert bool((last[~any_on] == first[~any_on]).all())
        skipped += int((nk - (last - first)).sum())
        # the GEMM over only those chunks gives the full result
        want = sp.unpack_dft_plain(packed, start, zlo, cnt, fl, w)
        got = _unpack_over_chunks(packed, start, zlo, cnt, fl, w, ranges)
        _close(got.numpy(), want.numpy(), rtol=1e-6)
        assert _plus_zero(got.numpy()[want.numpy() == 0])
    assert skipped > 0                         # the case skips something


def test_slab_layout_names_what_the_kernel_reads_in_place():
    B, n = 2, 12
    for d, fits in ((8, True), (64, True), (128, True), (6, False),
                    (40, False)):
        t = torch.zeros((B, d, n, d), dtype=torch.complex64)
        assert sp.slab_layout(torch.zeros((B, d, d, n),
                                          dtype=torch.complex64)) == 0
        assert sp.slab_layout(t.transpose(2, 3)) is None
        assert sp.slab_layout(t.permute(0, 3, 1, 2)) == (1 if fits else None)
        assert sp.slab_layout(t.permute(0, 3, 1, 2)[:, :, ::2]) is None


@pytest.mark.parametrize("d,fits", [(8, True), (64, True), (128, True),
                                    (6, False), (40, True), (10, False)])
def test_slab_layout_reads_a_z_major_slab_as_layout_2(d, fits):
    """(B, n, ey, ex) in memory, what the forward's x stage leaves: layout
    2 when a row's ex·ey lines fit the strided tile; layouts 0 and 1 are
    still named as before, 1 before 2 where both could read it."""
    B, n = 2, 12
    t = torch.zeros((B, n, d, d), dtype=torch.complex64)
    z_major = t.permute(0, 3, 2, 1)
    assert tuple(z_major.shape) == (B, d, d, n)
    assert sp.slab_layout(z_major) == (2 if fits else None)
    assert sp.slab_layout(z_major.contiguous()) == 0
    assert sp.slab_layout(z_major[:, :, ::2]) is None
    # one line a plane: z-major and y-planes are the same bytes
    one = torch.zeros((B, n, 1, d), dtype=torch.complex64).permute(0, 3, 2, 1)
    planes = d % 2 == 0 and (d % 64 == 0 or 64 % d == 0)
    assert sp.slab_layout(one) == (1 if planes else None)


@pytest.mark.parametrize("P,K,L,N", [(3, 8, 16, 12), (2, 5, 64, 9),
                                     (1, 16, 128, 8)])
def test_dft_matmul_cols_plain_is_the_rows_product(P, K, L, N):
    """The strided entry's plain version: the lines of a (P, K, L) block
    strided in K, row p·L + l being line (p, l), against the plain rows
    product bit for bit; ``ops.dft_apply`` takes the same block."""
    from repro_torch.kernels.dft_matmul import (dft_matmul_cols,
                                                dft_matmul_cols_plain)
    rng = np.random.default_rng(P + K + L)
    x = torch.as_tensor(_cx(rng, (P, K, L)))
    w = torch.as_tensor(_cx(rng, (N, K)))
    rows = x.transpose(1, 2).reshape(P * L, K)
    want = dft_matmul_plain(rows.contiguous(), w)
    got = dft_matmul_cols(x, w)
    assert got.shape == (P * L, N)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(dft_matmul_cols_plain(x, w).numpy(),
                                  want.numpy())
    ap = ops.dft_apply(x, N, inverse=True)
    _close(ap.numpy(), dft_apply_ref(rows, N, inverse=True).numpy())


# -------------------------------------------------------------- dft_pack
@pytest.mark.parametrize("d,n,nbands,kpts", [
    (8, 16, 3, ((0, 0, 0), (0.5, 0.5, 0.5))),
    (6, 12, 2, ((0, 0, 0),)),
    (4, 8, 2, ((0.25, 0, 0.5), (0, 0, 0), (0.5, 0.5, 0))),
])
def test_dft_pack_matches_reference_pallas(d, n, nbands, kpts):
    spheres = [kpoint_sphere(d, k) for k in kpts]
    B = len(spheres) * nbands
    npm = max(s.npacked for s in spheres)
    rng = np.random.default_rng(d * 7 + n)
    slab = _cx(rng, (B, d, d, n))
    line, zz, valid = sp.pack_gather_tables(spheres, nbands, npm)
    wr, wi, _ = ref_dft_matrix_device(d, n, False)
    pr, pi = ref_sp.dft_pack(
        jnp.asarray(slab.real), jnp.asarray(slab.imag),
        jnp.asarray(line * d + zz), jnp.asarray(valid), wr, wi,
        interpret=True)
    start, zlo, cnt, _ = _tables(spheres, nbands)
    nvalid = torch.as_tensor(valid.sum(1).astype(np.int32))
    _, _, w = dft_matrix_device(d, n, False, "cpu")
    out = sp.dft_pack(torch.as_tensor(slab), start, zlo, cnt, nvalid, w,
                      npm).numpy()
    _close(out, np.asarray(pr) + 1j * np.asarray(pi))
    pad = valid == 0
    assert pad.any() == (len(spheres) > 1)
    assert _plus_zero(out[pad])


# ------------------------------------------------------- wrapper checks
def test_wrappers_validate_inputs_and_build_nothing_on_cpu():
    spheres = [kpoint_sphere(4, (0, 0, 0))]
    start, zlo, cnt, flag = _tables(spheres, 1)
    _, _, w = dft_matrix_device(8, 4, True, "cpu")
    packed = torch.zeros((1, spheres[0].npacked), dtype=torch.complex64)
    with pytest.raises(TypeError, match="dtype"):
        sp.unpack_dft(packed.real.contiguous(), start, zlo, cnt, flag, w)
    with pytest.raises(ValueError, match="shape"):
        sp.unpack_dft(packed, start, zlo[:, :-1], cnt, flag, w)
    with pytest.raises(ValueError, match="contiguous"):
        dft_matmul(torch.zeros((4, 4), dtype=torch.complex64),
                   torch.zeros((4, 8), dtype=torch.complex64).T)
    ops.four_step_dft(torch.zeros((2, 64), dtype=torch.complex64))
    # CPU tensors take the plain versions: no library is built or loaded
    assert build.build_logs() == {} and build._LIBS == {}


# ------------------------------------------------------ the factored mode
# a ragged stacked batch of two spheres (two npacked), one band each: the
# cells' z-lines, 128 <-> 256 and 256 -> 64, by the factored mode's plain
# version against the dense one and against the reference's kernels
FACTORED_KPTS = ((0, 0, 0), (0.5, 0.5, 0.5))


def _factored_batch(d, nbands=1):
    spheres = [kpoint_sphere(d, k) for k in FACTORED_KPTS]
    ref = [ref_kpoint_sphere(d, k) for k in FACTORED_KPTS]
    npm = max(s.npacked for s in spheres)
    assert len({s.npacked for s in spheres}) == 2
    return spheres, ref, npm, sp.line_tables(spheres, nbands)


@pytest.mark.parametrize("d,n", [(128, 256), (64, 256)])
def test_unpack_dft_factored_matches_dense_and_reference(d, n):
    spheres, ref, npm, (start, zlo, cnt, flag) = _factored_batch(d)
    B = len(spheres)
    rng = np.random.default_rng(d + n)
    packed = _cx(rng, (B, npm))
    for k, s in enumerate(spheres):          # padded lanes: never used
        packed[k, s.npacked:] = np.nan
    flag[d // 2] = 0                         # a plane with support, off
    assert int(cnt[:, d // 2 * d:(d // 2 + 1) * d].sum()) > 0
    fo = sp.factored_for(d, n, True, start.shape[1], "cpu")
    assert fo is not None
    _, _, w = dft_matrix_device(n, d, True, "cpu")
    tabs = [torch.as_tensor(t) for t in (start, zlo, cnt, flag)]
    got = sp.unpack_dft(torch.as_tensor(packed), *tabs, w, factored=fo)
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    dense = sp.unpack_dft(torch.as_tensor(packed), *tabs, w)
    _close(got.numpy(), dense.numpy())
    wr, wi, _ = ref_dft_matrix_device(n, d, True)
    rr, ri = ref_sp.unpack_dft(
        jnp.asarray(packed.real), jnp.asarray(packed.imag),
        jnp.asarray(start), jnp.asarray(zlo), jnp.asarray(cnt),
        jnp.asarray(flag), wr, wi, interpret=True)
    _close(got.numpy(), np.asarray(rr) + 1j * np.asarray(ri))
    # lines with no lanes and the plane switched off: exact +0.0
    y = got.numpy()
    assert _plus_zero(y[(cnt == 0).reshape(B, d, d)])
    assert _plus_zero(y[:, d // 2])


@pytest.mark.parametrize("d,n", [(128, 256), (64, 256)])
def test_dft_pack_factored_matches_dense_and_reference(d, n):
    spheres, ref, npm, (start, zlo, cnt, _) = _factored_batch(d)
    B = len(spheres)
    rng = np.random.default_rng(d * 3 + n)
    slab = _cx(rng, (B, d, d, n))
    line, zz, valid = sp.pack_gather_tables(spheres, 1, npm)
    nvalid = torch.as_tensor(valid.sum(1).astype(np.int32))
    fo = sp.factored_for(n, d, False, start.shape[1], "cpu")
    assert fo is not None
    _, _, w = dft_matrix_device(d, n, False, "cpu")
    tabs = [torch.as_tensor(t) for t in (start, zlo, cnt)]
    got = sp.dft_pack(torch.as_tensor(slab), *tabs, nvalid, w, npm,
                      factored=fo)
    dense = sp.dft_pack(torch.as_tensor(slab), *tabs, nvalid, w, npm)
    _close(got.numpy(), dense.numpy())
    wr, wi, _ = ref_dft_matrix_device(d, n, False)
    pr, pi = ref_sp.dft_pack(
        jnp.asarray(slab.real), jnp.asarray(slab.imag),
        jnp.asarray(line * d + zz), jnp.asarray(valid), wr, wi,
        interpret=True)
    _close(got.numpy(), np.asarray(pr) + 1j * np.asarray(pi))
    # the padding of the ragged batch: exact +0.0
    assert (valid == 0).any() and _plus_zero(got.numpy()[valid == 0])


@pytest.mark.parametrize("n_in,n_out,lines,factored", [
    (128, 256, 16384, True), (256, 128, 16384, True),
    (256, 64, 4096, True), (64, 256, 4096, True),
    (256, 128, 8192, True), (128, 256, 48, False), (6, 12, 36, False),
    (40, 80, 1600, False), (256, 9, 16384, False), (128, 128, 16384, False)])
def test_factored_for_chooses_by_shape(n_in, n_out, lines, factored):
    """The sphere kernels take the factored mode where kernel #1 does
    (``factored_split``) and a row's lines fill whole 32-line tiles."""
    fo = sp.factored_for(n_in, n_out, n_out < n_in, lines, "cpu")
    assert (fo is not None) == factored
    if factored:
        assert fo.t.shape == (16, 16)
        assert (fo.f1.shape[1] * 16, fo.f2.shape[0] * 16) == (n_in, n_out)


@pytest.mark.parametrize("n,d,mode", [(256, 64, "factored"),
                                      (12, 6, "dense")])
def test_sphere_probe_counts_calls_by_mode(n, d, mode):
    """One call pair on the "cuda" backend (the plain versions on the
    CPU) counts one unpack and one pack in ``mode`` on the
    ``sphere_pack`` probe, the plans choosing the mode by shape, and gives
    back its coefficients."""
    from repro_torch.core import ProcGrid, make_planewave_pair
    from repro_torch.obs.metrics import global_metrics
    inv, fwd = make_planewave_pair(ProcGrid.create([1], device="cpu"), n,
                                   kpoint_sphere(d), 1, backend="cuda")
    assert (inv._fused_in_parts()["factored"] is not None) == (
        mode == "factored")
    assert (fwd._fused_out_parts()["factored"] is not None) == (
        mode == "factored")
    c = torch.as_tensor(_cx(np.random.default_rng(n + d),
                            (1, inv.sphere.npacked)))
    before = dict(global_metrics().snapshot()["sphere_pack"])
    out = fwd.transform_pack(inv.unpack_transform(c))
    after = global_metrics().snapshot()["sphere_pack"]
    delta = {k: after[k] - before[k] for k in after}
    other = "dense" if mode == "factored" else "factored"
    assert delta == {"unpack_dft": 1, "dft_pack": 1, f"unpack_{mode}": 1,
                     f"pack_{mode}": 1, f"unpack_{other}": 0,
                     f"pack_{other}": 0}
    _close(out.numpy(), c.numpy(), rtol=1e-5)


def test_factored_wrappers_refuse_operands_of_another_shape():
    spheres = [kpoint_sphere(8, (0, 0, 0))]
    start, zlo, cnt, flag = _tables(spheres, 1)
    _, _, w = dft_matrix_device(16, 8, True, "cpu")
    packed = torch.zeros((1, spheres[0].npacked), dtype=torch.complex64)
    fo = ops.factored_operands_device(256, 128, True, torch.device("cpu"))
    with pytest.raises(ValueError, match="factored operands"):
        sp.unpack_dft(packed, start, zlo, cnt, flag, w, factored=fo)
