"""Local 1D DFT backends — the red "local computation" block of the paper.

Line DFTs are dense matmuls with *rectangular* DFT matrices that fuse the
plane-wave zero-pad / truncation directly into the GEMM shape:

    ifft_n(pad_{m→n}(x))   ==  iDFT_n[:, :m] @ x
    fft_n(x)[:k]           ==  DFT_n[:k, :]  @ x

Backends:
  "fft"     torch.fft with an explicit pad and slice (the oracle route)
  "matmul"  split re/im real ``torch.matmul`` GEMMs
  "cuda"    the hand-written complex-GEMM kernel in repro_torch.kernels
            (its plain PyTorch version for a tensor on the CPU)

Normalization follows numpy.fft: forward unnormalized, inverse scaled by
1/n.  For rectangular inverse transforms the scale is 1/n_out (the padded
length), identical to ``ifft(pad(x, n))``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading

import numpy as np
import torch

from ..obs.trace import relayout
from .grid import resolve_device

_BACKENDS = ("fft", "matmul", "cuda")
# crossover above which a single dense-DFT matmul stops being the right tool
# (lines longer than this realize as "fft")
MATMUL_MAX_N = 2048


@functools.lru_cache(maxsize=128)
def _dft_matrix_np(n: int, inverse: bool) -> np.ndarray:
    k = np.arange(n)
    sign = 2j if inverse else -2j
    w = np.exp(sign * np.pi * np.outer(k, k) / n)
    if inverse:
        w = w / n
    return w.astype(np.complex64)


def dft_matrix(n_out: int, n_in: int, inverse: bool) -> np.ndarray:
    """Rectangular DFT operator (n_out × n_in) fusing pad or truncation.

    n_in <  n_out : inverse/forward of zero-padded input (cols sliced)
    n_in >  n_out : spectrum truncation (rows sliced of the n_in transform)
    """
    if n_in <= n_out:
        return _dft_matrix_np(n_out, inverse)[:, :n_in]
    return _dft_matrix_np(n_in, inverse)[:n_out, :]


@functools.lru_cache(maxsize=128)
def _dft_matrix_device(n_out: int, n_in: int, inverse: bool,
                       device: torch.device):
    w = dft_matrix(n_out, n_in, inverse)
    return (torch.as_tensor(np.ascontiguousarray(w.real), device=device),
            torch.as_tensor(np.ascontiguousarray(w.imag), device=device),
            torch.as_tensor(np.ascontiguousarray(w), device=device),
            torch.as_tensor(np.ascontiguousarray(w.real + w.imag),
                            device=device))


def dft_matrix_device(n_out: int, n_in: int, inverse: bool, device=None):
    """Device-resident ``(real f32, imag f32, complex64)`` forms of
    ``dft_matrix``, cached per ``(n_out, n_in, inverse, device)``.

    Uploading W per stage execution would re-send the matrix host→device
    on every line-DFT stage of the SCF loop; the cache makes repeated
    stage execution transfer-free.  The real planes feed the "matmul"
    backend, the interleaved complex matrix the kernels.  ``device=None``
    means CUDA and raises without it (:func:`~.grid.resolve_device`).
    """
    return _dft_matrix_device(int(n_out), int(n_in), bool(inverse),
                              resolve_device(device))[:3]


def dft_matrix_planes(n_out: int, n_in: int, inverse: bool, device=None):
    """The ``(real, imag, real + imag)`` f32 planes of ``dft_matrix`` from
    the same device cache as :func:`dft_matrix_device`; the sum plane
    feeds the lazy executor's Gauss three-product complex GEMM."""
    wr, wi, _, ws = _dft_matrix_device(int(n_out), int(n_in), bool(inverse),
                                       resolve_device(device))
    return wr, wi, ws


_FP32_LOCK = threading.Lock()
_FP32_USERS = 0
_FP32_SAVED = False


@contextlib.contextmanager
def full_fp32_matmul(device):
    """Run the enclosed fp32 CUDA GEMMs in full fp32, not TF32.

    cuBLAS reads the process-wide ``torch.backends.cuda.matmul.allow_tf32``
    at each call; TF32 products would lose the ~1e-6 agreement of the fp32
    GEMM routes (the "matmul" backend, the lazy executor, the jitted
    mixer's Gram).  The first of any nested or concurrent users clears
    the flag and the last puts back what it found, so the caller's setting
    survives.  A no-op off CUDA.
    """
    global _FP32_USERS, _FP32_SAVED
    if torch.device(device).type != "cuda":
        yield
        return
    with _FP32_LOCK:
        if _FP32_USERS == 0:
            _FP32_SAVED = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
        _FP32_USERS += 1
    try:
        yield
    finally:
        with _FP32_LOCK:
            _FP32_USERS -= 1
            if _FP32_USERS == 0:
                torch.backends.cuda.matmul.allow_tf32 = _FP32_SAVED


def _fft_backend(x, axis, n_in, n_out, inverse):
    fn = torch.fft.ifft if inverse else torch.fft.fft
    if n_in <= n_out:
        pad = [0, 0] * x.ndim               # last dim first, as F.pad wants
        pad[2 * (x.ndim - 1 - axis) + 1] = n_out - n_in
        xp = torch.nn.functional.pad(x, pad)
        # torch.fft.ifft normalizes by the padded length — matches matmul
        return fn(xp, dim=axis)
    y = fn(x, dim=axis)
    return y.narrow(axis, 0, n_out)


def _matmul_backend(x, axis, n_in, n_out, inverse):
    wr, wi, _ = dft_matrix_device(n_out, n_in, inverse, x.device)
    xm = torch.movedim(x, axis, -1)
    xr, xi = xm.real, xm.imag
    # y = x @ W^T with complex split into real GEMMs
    with full_fp32_matmul(x.device):
        yr = xr @ wr.T - xi @ wi.T
        yi = xr @ wi.T + xi @ wr.T
    return torch.movedim(torch.complex(yr, yi), -1, axis)


#: line stages of the "cuda" backend by how they read their lines (the
#: ``line_reads_*`` counters of the ``fftb`` probe): "rows" contiguous
#: lines, "strided" planes of lines strided in the axis, read where they
#: lie by the kernel's strided entry, "copied" lines laid out in rows
#: first by ``obs.trace.relayout``
LINE_READS = {"rows": 0, "strided": 0, "copied": 0}
#: line stages of the "cuda" backend by kernel #1's mode (the
#: ``line_dfts_*`` counters of the ``fftb`` probe): "factored" two
#: 16-point stages in one launch, "dense" one product with the DFT matrix
#: (``kernels.dft_matmul.factored_split`` decides by shape)
LINE_DFTS = {"factored": 0, "dense": 0}


@dataclasses.dataclass(frozen=True)
class LineRead:
    """How the "cuda" backend reads the lines of a tensor along an axis.

    ``order`` holds the other dims as they lie in memory, outermost first;
    the first ``outer`` of them lie outside the axis, the rest inside it.
    Read as ``(planes, K, L)``: ``planes`` the product of the outer dims,
    ``K`` the axis' length, ``L`` the product of the inner dims.  The
    stage's output rows run over ``order`` in that order, whatever the
    route: ``"rows"`` (L = 1, the lines contiguous), ``"strided"`` (the
    kernel reads the planes where they lie) or ``"copied"``.
    """
    route: str
    order: tuple[int, ...]
    outer: int
    planes: int
    K: int
    L: int


def line_read(x, axis: int, *, strided: bool | None = None) -> LineRead:
    """The route by which the "cuda" backend reads ``x``'s lines along
    ``axis`` (``strided``: whether the strided entry may be used; by
    default whether ``x`` is a CUDA tensor).

    The other dims are ordered by stride (dims of size 1 first, and an
    axis of length 1 counts as innermost).  When ``x`` is dense in that
    order, its lines form a ``(planes, K, L)`` view: rows if L = 1, else
    the strided entry if it may be used, L fits its tile
    (:func:`~repro_torch.kernels.dft_matmul.cols_fit`) and the base is
    16-byte aligned.  Anything else is copied into rows.
    """
    from ..kernels.dft_matmul import cols_fit
    strided = x.is_cuda if strided is None else strided
    others = [d for d in range(x.ndim) if d != axis]
    ones = [d for d in others if x.shape[d] == 1]
    big = sorted((d for d in others if x.shape[d] > 1),
                 key=lambda d: -x.stride(d))
    if x.shape[axis] > 1:
        s = x.stride(axis)
        outer = ones + [d for d in big if x.stride(d) > s]
        inner = [d for d in big if x.stride(d) <= s]
    else:
        outer, inner = ones + big, []
    L = math.prod(x.shape[d] for d in inner)
    dense = x.permute(*outer, axis, *inner).is_contiguous()
    if dense and not inner:
        route = "rows"
    elif (dense and strided and cols_fit(L)
          and x.data_ptr() % 16 == 0):
        route = "strided"
    else:
        route = "copied"
    return LineRead(route, tuple(outer + inner), len(outer),
                    math.prod(x.shape[d] for d in outer), x.shape[axis], L)


def _cuda_backend(x, axis, n_in, n_out, inverse):
    from ..kernels import ops as kops
    from ..kernels.dft_matmul import factored_split
    rd = line_read(x, axis)
    LINE_READS[rd.route] += 1
    LINE_DFTS["dense" if factored_split(n_in, n_out) is None
              else "factored"] += 1
    if rd.route == "strided":
        outer, inner = rd.order[:rd.outer], rd.order[rd.outer:]
        xf = x.permute(*outer, axis, *inner).view(rd.planes, n_in, rd.L)
    else:
        xf = relayout(x.permute(*rd.order, axis), n_in)
    yf = kops.dft_apply(xf, n_out=n_out, inverse=inverse)
    # rows over the other dims in memory order, the new axis last; the
    # result is that block seen in the logical order
    perm = rd.order + (axis,)
    y = yf.view(*(x.shape[d] for d in rd.order), n_out)
    return y.permute(*(perm.index(d) for d in range(x.ndim)))


def realized_backend(n_in: int, n_out: int, backend: str) -> str:
    """The backend ``local_dft`` will actually run for this line shape.

    A dense-matrix backend ("matmul", and "cuda", whose kernel is the same
    single GEMM) requested above the ``MATMUL_MAX_N`` crossover *realizes*
    as "fft".  Everything that accounts or reports per-stage work —
    ``dft_flops``, ``describe()`` — goes through this so the books match
    what executed rather than what was requested.
    """
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend in ("matmul", "cuda") and max(n_in, n_out) > MATMUL_MAX_N:
        return "fft"
    return backend


def local_dft(x, axis: int, n_out: int | None = None, *,
              inverse: bool = False, backend: str = "matmul"):
    """Apply a (possibly rectangular) DFT along ``axis`` of complex ``x``
    (a negative ``axis`` counts from the end)."""
    axis = axis % x.ndim
    n_in = x.shape[axis]
    n_out = n_in if n_out is None else n_out
    backend = realized_backend(n_in, n_out, backend)
    x = x.to(torch.complex64)
    if backend == "fft":
        return _fft_backend(x, axis, n_in, n_out, inverse)
    if backend == "matmul":
        return _matmul_backend(x, axis, n_in, n_out, inverse)
    return _cuda_backend(x, axis, n_in, n_out, inverse)


def dft_flops(n_out: int, n_in: int, batch: int, backend: str) -> int:
    """FLOP estimate for one batched line-DFT stage.

    Priced at the *realized* backend: a dense stage above the
    ``MATMUL_MAX_N`` crossover runs "fft", and reporting dense GEMM FLOPs
    for it would overstate the stage ~n/log n-fold.
    """
    backend = realized_backend(n_in, n_out, backend)
    if backend in ("matmul", "cuda"):
        # 8 real flops per complex MAC: y(n_out) = W(n_out×n_in) x
        return 8 * n_out * n_in * batch
    # split-radix style estimate
    n = max(n_out, n_in)
    return int(5 * n * np.log2(max(n, 2))) * batch
