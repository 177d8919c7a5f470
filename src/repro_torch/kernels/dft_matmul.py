"""Batched rectangular complex line DFT as one hand-written CUDA GEMM on
Hopper's tensor cores.

    y = x · Wᵀ              x (M, K), W (N, K), y (M, N), complex64
    y = (x · Wᵀ) ⊙ t        the twiddle entry: row r times row r mod T
                            of a (T, N) complex64 table

The kernels (``csrc/dft_matmul.cu`` on ``csrc/cgemm_tc.cuh``) replace the
TPU kernels ``_kernel`` and ``_kernel_twiddle`` of the reference's
``kernels/dft_matmul.py``, which run four real products
``yr = xr·Wrᵀ − xi·Wiᵀ``, ``yi = xr·Wiᵀ + xi·Wrᵀ`` with fp32 accumulation.
Here interleaved complex64 x is read as a real fp32 (M, 2K) matrix and
multiplied by the real (2N, 2K) embedding of W (:func:`embed_operand`):
the fp32 (M, 2N) product is the interleaved complex64 y.  The products
run on the tensor cores in split TF32 (:func:`tf32_split`): each operand
is a TF32 ``big`` plus a TF32 ``small``, and
``small·big + big·small + big·big`` keeps about fp32's accuracy; the
tensor core sums one K chunk of 32 columns at a time, and the chunks are
added with round-to-nearest fp32 adds (the tensor core's own adds
truncate, a bias that grows with K).  The twiddle entry multiplies each
result by ``tr + i·ti`` in the epilogue.

What bounds them on an H100 at fp32 accuracy: the inverse x stage of the
stacked H apply (2,097,152 lines, 128 → 256) by operations, 3.33 ms for
three TF32 passes at 495 TFLOP/s (its 6.4 GB take 1.92 ms); the four-step
stage 1 of the twiddle entry (262,144 lines, 64 → 64) by bytes, 0.080 ms.
The design: TMA loads into a ring of shared-memory stages behind one
producer warp, ``wgmma`` from two consumer warpgroups, a persistent grid.

``dft_matmul`` / ``dft_matmul_twiddle`` launch their kernel for CUDA
tensors and run the plain PyTorch version (:func:`dft_matmul_plain`,
:func:`dft_matmul_twiddle_plain`) for CPU tensors.  ``dft_matmul_cols``
is kernel #1's strided entry: the same product over lines strided in K
(planes of lines stored K-major, as a line stage over another axis leaves
them), read where they lie and transposed in shared memory.  There is no fallback:
a CUDA tensor either launches the kernel or raises.

``dft_factored`` / ``dft_factored_cols`` are kernel #1's factored mode
(``csrc/cgemm_tc_factored.cuh``): the same rectangular operator for lines
whose longer length n is 256 (:func:`factored_split`), as two 16-point
tensor-core stages with a twiddle between them in one launch,
``y[k2 + n2·k1] = Σ_j1 F_n1[k1, j1]·t[j1, k2]·Σ_j2 F_n2[k2, j2]·x[j1 +
n1·j2]``: 6,144 complex products a 128→256 line instead of 32,768, so
the line is bound by its bytes.  Their plain version,
:func:`dft_factored_plain`, runs the same two stages and twiddle.  The
sphere kernels #3 and #4 (``sphere_pack.py``) run the same body and
operands behind their CSR gather and before their scattering store.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import build


def tf32_split(a):
    """Split fp32 ``a`` into TF32 planes ``(big, small)``, a ≈ big + small.

    ``big`` rounds ``a`` to TF32 by the rule of ``cvt.rna.tf32.f32``
    (round to nearest, ties away from zero): on the int32 view,
    ``(bits + 0x1000) & ~0x1FFF`` for finite values; inf and NaN pass
    unchanged.  ``small`` is the same rounding of ``a − big``.
    """
    def rna(v):
        r = ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
        return torch.where(torch.isfinite(v), r, v)

    big = rna(a)
    return big, rna(a - big)


def embed_operand(w):
    """The kernel's B operand: the real (2N, 2K) embedding of the complex
    (N, K) matrix W, split into TF32 planes.

    Row 2n holds ``(Wr[n, k], −Wi[n, k])`` at columns ``(2k, 2k+1)``, row
    2n+1 holds ``(Wi[n, k], Wr[n, k])``, so ``x.view(float32) @ Ŵᵀ`` is
    ``(x @ Wᵀ).view(float32)``.  Returns a float32 tensor of shape
    ``(2, 2N, 2K)``: ``[0]`` is Ŵ_big and ``[1]`` Ŵ_small, each a view with
    its rows padded to a multiple of 4 floats (16 bytes, as TMA needs).
    """
    N, K = w.shape
    wr, wi = w.real, w.imag
    e = torch.stack((torch.stack((wr, -wi), -1),
                     torch.stack((wi, wr), -1)), 1).reshape(2 * N, 2 * K)
    buf = torch.zeros((2, 2 * N, _pitch(K)), dtype=torch.float32,
                      device=w.device)
    buf[0, :, :2 * K], buf[1, :, :2 * K] = tf32_split(e)
    return buf[:, :, :2 * K]


def _pitch(K: int) -> int:
    """Row pitch of Ŵ's planes in floats (``tc::w_pitch`` in the CUDA)."""
    return (2 * K + 3) // 4 * 4


def dft_matmul_plain(x, w):
    """The product in plain PyTorch: four real fp32 GEMMs."""
    xr, xi = x.real, x.imag
    wr, wi = w.real, w.imag
    yr = xr @ wr.T - xi @ wi.T
    yi = xr @ wi.T + xi @ wr.T
    return torch.complex(yr, yi)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _operand(w, wsplit, N, K, device):
    """The split embedding of w for the kernel: ``wsplit`` if given (as
    :func:`embed_operand` lays it out), else built now."""
    if wsplit is None:
        return embed_operand(w)
    if (wsplit.dtype != torch.float32 or wsplit.device != device
            or tuple(wsplit.shape) != (2, 2 * N, 2 * K)
            or wsplit.stride() != (2 * N * _pitch(K), _pitch(K), 1)):
        raise ValueError("wsplit must be embed_operand(w) for the (N, K) = "
                         f"({N}, {K}) matrix on {device}")
    return wsplit


def _tma_rows(x) -> int:
    """1 if TMA can address the rows of x (16-byte pitch and base): the
    kernel's TMA path for its A operand; 0 takes the gather path."""
    return int(x.shape[1] % 2 == 0 and x.data_ptr() % 16 == 0)


def dft_matmul(x, w, *, wsplit=None):
    """y = x · Wᵀ for x (B, K) and W (N, K), complex64 → (B, N) complex64.

    CUDA tensors launch the hand-written kernel (counted in
    ``dft_matmul.launches``) with ``wsplit = embed_operand(w)``, built per
    call unless the caller passes a cached one; CPU tensors run
    :func:`dft_matmul_plain`.
    """
    B, K = x.shape
    N = w.shape[0]
    if x.device.type != "cuda":
        _check("w", w, torch.complex64, (N, K), x.device)
        return dft_matmul_plain(x.to(torch.complex64), w)
    _check("x", x, torch.complex64, (B, K), x.device)
    _check("w", w, torch.complex64, (N, K), x.device)
    y = torch.empty((B, N), dtype=torch.complex64, device=x.device)
    if B == 0 or N == 0:
        return y
    ws = _operand(w, wsplit, N, K, x.device)
    lib = build.library("dft_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        status = lib.dft_matmul_launch(x.data_ptr(), ws.data_ptr(),
                                       y.data_ptr(), B, N, K, _tma_rows(x),
                                       stream)
    build.check(status, "dft_matmul")
    dft_matmul.launches += 1
    return y


dft_matmul.launches = 0


def cols_fit(lines: int) -> bool:
    """A plane of ``lines`` lines fits the strided read's tile
    (``tc::cols_fit``): even, and a divisor or a multiple of 64."""
    return lines >= 2 and lines % 2 == 0 and (lines % 64 == 0
                                              or 64 % lines == 0)


def dft_matmul_cols_plain(x, w):
    """:func:`dft_matmul_cols` in plain PyTorch: the lines copied into rows,
    then :func:`dft_matmul_plain`."""
    P, K, L = x.shape
    return dft_matmul_plain(x.transpose(1, 2).reshape(P * L, K), w)


def dft_matmul_cols(x, w, *, wsplit=None):
    """y = x · Wᵀ over lines strided in K: x (P, K, L), line l of plane p
    running over ``x[p, :, l]``, and W (N, K); complex64 → (P·L, N)
    complex64, row p·L + l being that line's transform.

    CUDA tensors launch the kernel's strided entry, which reads the lines
    where they lie (counted in ``dft_matmul.launches``, with ``wsplit`` as
    in :func:`dft_matmul`); x must be contiguous and 16-byte aligned and L
    must fit the tile (:func:`cols_fit`), else the launch fails and this
    raises.  CPU tensors run :func:`dft_matmul_cols_plain`.
    """
    P, K, L = x.shape
    N = w.shape[0]
    if x.device.type != "cuda":
        _check("w", w, torch.complex64, (N, K), x.device)
        return dft_matmul_cols_plain(x.to(torch.complex64), w)
    _check("x", x, torch.complex64, (P, K, L), x.device)
    _check("w", w, torch.complex64, (N, K), x.device)
    y = torch.empty((P * L, N), dtype=torch.complex64, device=x.device)
    if P * L == 0 or N == 0:
        return y
    ws = _operand(w, wsplit, N, K, x.device)
    lib = build.library("dft_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        status = lib.dft_matmul_cols_launch(x.data_ptr(), ws.data_ptr(),
                                            y.data_ptr(), P * L, N, K, L,
                                            stream)
    build.check(status, "dft_matmul")
    dft_matmul.launches += 1
    return y


def dft_matmul_twiddle_plain(x, w, t):
    """The twiddle entry's arithmetic in plain PyTorch: the four real
    GEMMs, then ``yr·tr − yi·ti``, ``yr·ti + yi·tr`` with row r of y
    taking row ``r mod T`` of the ``(T, N)`` table."""
    y = dft_matmul_plain(x, w)
    M, N = y.shape
    T = t.shape[0]
    yr = y.real.reshape(M // T, T, N)
    yi = y.imag.reshape(M // T, T, N)
    tr, ti = t.real, t.imag
    return torch.complex(yr * tr - yi * ti,
                         yr * ti + yi * tr).reshape(M, N)


def dft_matmul_twiddle(x, w, t, *, wsplit=None):
    """y = (x · Wᵀ) ⊙ t for x (M, K), W (N, K) and a (T, N) twiddle table
    whose row ``r mod T`` multiplies row r of y (T must divide M);
    complex64 → (M, N) complex64.

    ``T = M`` is a general per-row twiddle; the four-step DFT passes its
    ``(n1, n2)`` table, whose rows repeat over the batch.  CUDA tensors
    launch the hand-written kernel (counted in
    ``dft_matmul_twiddle.launches``), with ``wsplit`` as in
    :func:`dft_matmul`; CPU tensors run :func:`dft_matmul_twiddle_plain`.
    """
    M, K = x.shape
    N = w.shape[0]
    T = t.shape[0]
    if T < 1 or M % T:
        raise ValueError(f"twiddle table rows {T} must divide the {M} "
                         "rows of x")
    if x.device.type != "cuda":
        _check("w", w, torch.complex64, (N, K), x.device)
        _check("t", t, torch.complex64, (T, N), x.device)
        return dft_matmul_twiddle_plain(x.to(torch.complex64), w, t)
    _check("x", x, torch.complex64, (M, K), x.device)
    _check("w", w, torch.complex64, (N, K), x.device)
    _check("t", t, torch.complex64, (T, N), x.device)
    y = torch.empty((M, N), dtype=torch.complex64, device=x.device)
    if M == 0 or N == 0:
        return y
    ws = _operand(w, wsplit, N, K, x.device)
    lib = build.library("dft_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        status = lib.dft_matmul_twiddle_launch(
            x.data_ptr(), ws.data_ptr(), t.data_ptr(), y.data_ptr(), M, N, K,
            T, _tma_rows(x), stream)
    build.check(status, "dft_matmul_twiddle")
    dft_matmul_twiddle.launches += 1
    return y


dft_matmul_twiddle.launches = 0


#: the factored mode's lines: the longer length n = n1·n2 (input
#: j = j1 + n1·j2, output k = k2 + n2·k1), and the lengths it takes on
#: either side (the kernel's stages take n_in / n1 and n_out / n2 in whole
#: k8 steps of four complex columns, at most 16 each)
FACTORED_N, FACTORED_SPLIT = 256, (16, 16)
FACTORED_LENGTHS = (64, 128, 256)


def factored_split(n_in: int, n_out: int) -> tuple[int, int] | None:
    """``(n1, n2)`` when kernel #1 takes lines of ``n_in → n_out`` in its
    factored mode, else None (the dense product)."""
    if (max(n_in, n_out) != FACTORED_N or n_in not in FACTORED_LENGTHS
            or n_out not in FACTORED_LENGTHS):
        return None
    return FACTORED_SPLIT


class Factored(NamedTuple):
    """The factored mode's operators for one ``(n_out, n_in, inverse)``:
    ``f1`` (n2, n_in / n1) the stage-1 DFT over j2, ``f2`` (n_out / n2,
    n1) the stage-2 DFT's kept rows k1, ``t`` (n1, n2) the twiddles
    w_n^(j1·k2), times 1/n for the inverse (all complex64, computed in
    float64 and rounded once), and ``ops`` the kernel's (4, 32, 32) fp32
    split embeddings of f1 and f2 (None on the CPU)."""
    f1: torch.Tensor
    f2: torch.Tensor
    t: torch.Tensor
    ops: torch.Tensor | None


def _dft(m: int, rows: int, cols: int, sign: int) -> np.ndarray:
    return np.exp(sign * 2j * np.pi * np.outer(np.arange(rows),
                                               np.arange(cols)) / m)


def _embed_k8(w):
    """The real (2N, 2K) embedding of complex (N, K) w (as
    :func:`embed_operand`) with the factored kernel's column order:
    complex column k, part e at ``8·(k // 4) + k % 4 + 4·e``."""
    N, K = w.shape
    k = torch.arange(K, device=w.device)
    pos = 8 * (k // 4) + k % 4
    e = torch.zeros((2 * N, 2 * K), dtype=torch.float32, device=w.device)
    e[0::2, pos], e[0::2, pos + 4] = w.real, -w.imag
    e[1::2, pos], e[1::2, pos + 4] = w.imag, w.real
    return e


def factored_operands(n_out: int, n_in: int, inverse: bool,
                      device) -> Factored:
    """:class:`Factored` for lines of ``n_in → n_out`` (a shape
    :func:`factored_split` takes) on ``device``."""
    n1, n2 = factored_split(n_in, n_out)
    n = n1 * n2
    sign = 1 if inverse else -1
    t = _dft(n, n1, n2, sign) / (n if inverse else 1)
    f1, f2, t = (torch.as_tensor(a.astype(np.complex64), device=device)
                 for a in (_dft(n2, n2, n_in // n1, sign),
                           _dft(n1, n_out // n2, n1, sign), t))
    ops = None
    if torch.device(device).type == "cuda":
        ops = torch.zeros((4, 32, 32), dtype=torch.float32, device=device)
        for i, w in enumerate((f1, f2)):
            e = _embed_k8(w)
            ops[2 * i, :e.shape[0], :e.shape[1]], \
                ops[2 * i + 1, :e.shape[0], :e.shape[1]] = tf32_split(e)
    return Factored(f1, f2, t, ops)


def dft_factored_plain(x, fo: Factored):
    """The factored mode in plain PyTorch: x (B, n_in) → (B, n_out), the
    kernel's two stages and twiddle as complex64 products."""
    B, n_in = x.shape
    n1, n2 = fo.t.shape
    z = x.reshape(B, n_in // n1, n1).transpose(1, 2) @ fo.f1.T   # (j1, k2)
    y = (z * fo.t).transpose(1, 2) @ fo.f2.T                     # (k2, k1)
    return y.transpose(1, 2).reshape(B, -1)


def dft_factored_cols_plain(x, fo: Factored):
    """:func:`dft_factored_cols` in plain PyTorch: the lines copied into
    rows, then :func:`dft_factored_plain`."""
    P, K, L = x.shape
    return dft_factored_plain(x.transpose(1, 2).reshape(P * L, K), fo)


def _factored_launch(x, fo: Factored, M: int, n_in: int, L: int):
    n_out = fo.f2.shape[0] * fo.t.shape[1]
    y = torch.empty((M, n_out), dtype=torch.complex64, device=x.device)
    if M == 0:
        return y
    lib = build.library("dft_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if L:
            status = lib.dft_factored_cols_launch(
                x.data_ptr(), fo.ops.data_ptr(), fo.t.data_ptr(),
                y.data_ptr(), M, n_in, n_out, L, stream)
        else:
            status = lib.dft_factored_launch(
                x.data_ptr(), fo.ops.data_ptr(), fo.t.data_ptr(),
                y.data_ptr(), M, n_in, n_out, stream)
    build.check(status, "dft_matmul (factored)")
    dft_matmul.launches += 1
    return y


def _check_factored(fo: Factored, n_in: int, device) -> None:
    n1 = fo.t.shape[0]
    if (fo.ops is None or fo.ops.device != device
            or fo.f1.shape[1] * n1 != n_in):
        raise ValueError(f"operands for {fo.f1.shape[1] * n1}-long lines "
                         f"on {fo.t.device}, not {n_in} on {device}")


def dft_factored(x, fo: Factored):
    """The factored line DFT on rows: x (B, n_in) → (B, n_out) complex64,
    with the operands of :func:`factored_operands` for the shape.

    CUDA tensors launch the factored kernel (counted in
    ``dft_matmul.launches``; x must be contiguous, and rows that do not
    start on 16 bytes are copied first, as TMA reads them); CPU tensors
    run :func:`dft_factored_plain`.
    """
    B, n_in = x.shape
    if x.device.type != "cuda":
        return dft_factored_plain(x.to(torch.complex64), fo)
    _check("x", x, torch.complex64, (B, n_in), x.device)
    _check_factored(fo, n_in, x.device)
    if x.data_ptr() % 16:
        x = x.clone()                 # TMA needs a 16-byte aligned base
    return _factored_launch(x, fo, B, n_in, 0)


def dft_factored_cols(x, fo: Factored):
    """The factored line DFT over lines strided in K: x (P, n_in, L) →
    (P·L, n_out) complex64, row p·L + l the transform of ``x[p, :, l]``.

    CUDA tensors launch the factored kernel's strided entry (counted in
    ``dft_matmul.launches``): x must be contiguous and 16-byte aligned and
    L even and a multiple or a divisor of 16 (every L that :func:`cols_fit`
    takes), else the launch fails and this raises.  CPU tensors run
    :func:`dft_factored_cols_plain`.
    """
    P, n_in, L = x.shape
    if x.device.type != "cuda":
        return dft_factored_cols_plain(x.to(torch.complex64), fo)
    _check("x", x, torch.complex64, (P, n_in, L), x.device)
    _check_factored(fo, n_in, x.device)
    return _factored_launch(x, fo, P * L, n_in, L)
