"""Peaks and the work a transform needs: the yardstick of every roofline.

Work is counted from the problem, never from the algorithm that computes
it, so a later kernel that computes the same lines another way is measured
against the same work:

* bytes: each input read once and each output written once, complex64
  (8 bytes an element); where a line holds no lane of the sphere, no byte
  of it needs reading;
* operations: the standard FFT count, ``5 N log2 N`` real operations for a
  complex transform of length N (benchFFT's convention), for each line the
  problem needs transformed;
* bound: ``max(bytes / HBM, operations / float32 peak)``.

The peaks are the NVIDIA H100 SXM data sheet's: 3.35 TB/s of HBM3 and
67 TFLOP/s of float32 outside the tensor cores.  They assume the card's
full 700 W; a run reports the card's power limit beside every share.
"""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
COMPLEX64 = 8


def fft_flops(length: int) -> float:
    """Real operations of one complex FFT of ``length`` (5 N log2 N)."""
    return 5.0 * length * math.log2(length) if length > 1 else 0.0


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take for this work."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def pair_work(n: int, npacked: int, bands: int) -> tuple[float, float]:
    """(bytes, operations) of one sphere -> cube -> sphere pair of
    ``bands`` bands: per direction the packed sphere and the cube, once
    each, and one 3D FFT of n^3 per band."""
    per_dir = bands * (npacked + n ** 3) * COMPLEX64
    return 2.0 * per_dir, 2.0 * bands * fft_flops(n ** 3)


# ---------------------------------------------- per kernel call, by shape
def line_call(lines: int, n_in: int, n_out: int) -> tuple[float, float]:
    """One call of the line-DFT kernel (#1) on ``lines`` lines of length
    ``n_in`` -> ``n_out`` (zero-pad or truncation fused): the lines in
    and out, and one FFT of the longer length per line."""
    nbytes = lines * (n_in + n_out) * COMPLEX64
    return float(nbytes), lines * fft_flops(max(n_in, n_out))


def unpack_call(rows: int, npacked: int, ncols: int, d: int,
                n: int) -> tuple[float, float]:
    """One call of ``unpack_dft`` (#3): ``rows`` packed rows in, the
    ``(rows, d, d, n)`` first-stage slab out (every element written, the
    lines without lanes as zeros), one length-n FFT per column of lanes."""
    nbytes = rows * (npacked + d * d * n) * COMPLEX64
    return float(nbytes), rows * ncols * fft_flops(n)


def pack_call(rows: int, npacked: int, ncols: int,
              n: int) -> tuple[float, float]:
    """One call of ``dft_pack`` (#4): the slab's lines that hold lanes
    in (``ncols`` lines of length n a row), the packed rows out, one
    length-n FFT per such line."""
    nbytes = rows * (ncols * n + npacked) * COMPLEX64
    return float(nbytes), rows * ncols * fft_flops(n)


def pair_calls(n: int, d: int, npacked: int, ncols: int,
               rows: int) -> dict[str, list[tuple[float, float]]]:
    """The kernel calls of one inverse and one forward of ``rows`` bands
    on the staged schedule of the paper (inverse: z by ``unpack_dft``,
    then y and x by the line kernel; forward: the mirror, z by
    ``dft_pack``), by kernel: ``{"dft_matmul": [...], "sphere_pack":
    [...]}`` of (bytes, operations)."""
    y_inv = line_call(rows * d * n, d, n)       # (r, d, d, n) -> (r, d, n, n)
    x_inv = line_call(rows * n * n, d, n)       # -> (r, n, n, n)
    x_fwd = line_call(rows * n * n, n, d)       # (r, n, n, n) -> (r, d, n, n)
    y_fwd = line_call(rows * d * n, n, d)       # -> (r, d, d, n)
    return {"dft_matmul": [y_inv, x_inv, x_fwd, y_fwd],
            "sphere_pack": [unpack_call(rows, npacked, ncols, d, n),
                            pack_call(rows, npacked, ncols, n)]}


def kernel_of(name: str) -> str | None:
    """Which kernel of the port a device operation's name is, if any:
    ``"dft_matmul"`` (#1, the line DFT), ``"dft_matmul_twiddle"`` (#2),
    ``"sphere_pack"`` (#3 ``unpack_dft`` and #4 ``dft_pack``),
    ``"sphere_pack_tail"`` (#4's zeroing of padded lanes), else None.  The
    first three are instances of one tensor-core GEMM template, told apart
    by their policy."""
    if "zero_tail" in name:
        return "sphere_pack_tail"
    if "cgemm_tc" not in name:
        return None
    if "Unpack" in name or "Pack" in name:
        return "sphere_pack"
    if "Twiddle" in name:
        return "dft_matmul_twiddle"
    return "dft_matmul"


def kernel_roofline_pct(facts: dict, kernel: str,
                        also: tuple[str, ...] = ()) -> float | None:
    """``kernel``'s share of its roofline over a traced window: the least
    time of the calls the window made (``facts["kernel_calls"]``: a
    pair's calls of each kernel as (bytes, operations), times the pairs)
    over the device time of those launches and of ``also``'s.  None when
    the trace holds another number of launches than those calls: its
    time would then not be theirs."""
    tr, calls = facts.get("trace"), facts.get("kernel_calls")
    pairs = facts.get("pairs")
    if tr is None or not calls or kernel not in calls or not pairs:
        return None
    if tr.calls.get(kernel, 0) != len(calls[kernel]) * pairs:
        return None
    spent = tr.by_kernel[kernel] + sum(tr.by_kernel.get(k, 0.0)
                                       for k in also)
    least = pairs * sum(bound_s(b, f) for b, f in calls[kernel])
    return 100.0 * least / spent
