// dft_matmul — batched rectangular complex line DFT, y = x · Wᵀ, and its
// twiddle variant y = (x · Wᵀ) ⊙ t.
//
// `dft_matmul_launch` replaces the TPU kernel `_kernel` of
// src/repro/kernels/dft_matmul.py (reached through
// kernels/ops.py::dft_apply), which runs the four real MXU GEMMs
// yr = xr·Wrᵀ − xi·Wiᵀ, yi = xr·Wiᵀ + xi·Wrᵀ on split re/im planes with
// the whole K kept in VMEM.
//
// `dft_matmul_twiddle_launch` replaces `_kernel_twiddle` of the same file
// (reached through kernels/ops.py::four_step_dft): the same product, then
// y ← y ⊙ (tr + i·ti) in the epilogue.  The TPU kernel reads a (B, N)
// twiddle block per output tile, pre-broadcast over rows; here row r reads
// t[(r mod T)·N + c] from a (T, N) table, so the four-step DFT, whose
// twiddle depends only on the row's j1 = r mod n1, passes its (n1, n2)
// table and never materializes the B-fold tiled copy (T = M gives the TPU
// kernel's general per-row twiddle).
//
// What bounds it on an H100: operations.  At the stacked SCF's line
// shapes (K, N in {128, 256}) one complex MAC per 16 bytes moved gives
// 8·K·N / (8·(K + N)) ≈ 85 FLOP per byte, well above the ~20 FLOP/byte
// at which fp32 FMA (67 TFLOP/s, no tensor cores) overtakes HBM.  The
// twiddle variant at the four-step shape (K = N = 64, a 32 KB table that
// stays in L1/L2) does 8·64·64 FLOP per 16·64 bytes of line in and out:
// 32 FLOP per byte, still bound by operations.
//
// What the design does about it: the shared tiled SIMT GEMM (cgemm.cuh)
// with 4x4 register micro-tiles — 64 FMAs per 8 shared-memory loads —
// reads interleaved complex64 directly, so no stage splits its data into
// re/im planes, and masks the ragged M and N edges itself, so nothing is
// padded to whole tiles (the TPU wrapper's pad-to-tile copies would move
// multi-GB slabs at the SCF's sizes).
#include "cgemm.cuh"

namespace dftk {

struct DenseRows {
  int K, N;
  __device__ cgemm::Row row(int64_t r, int64_t M) const {
    cgemm::Row out;
    const bool ok = r < M;
    out.in = r * K;
    out.out = r * N;
    out.in_lo = 0;
    out.in_hi = K;
    out.out_lo = 0;
    out.out_hi = ok ? N : 0;
    out.active = ok ? 1 : 0;
    return out;
  }
  __device__ float2 epilogue(int64_t, int, float2 v) const { return v; }
};

// Dense rows with the twiddle product in the epilogue.  The product is
// yr·tr − yi·ti, yr·ti + yi·tr in the TPU kernel's order, rounded after
// every operation (no FMA contraction), so it adds no rounding
// difference of its own against the plain version.
struct TwiddleRows {
  DenseRows dense;
  const float2* t;   // (T, N) complex64
  int T;
  __device__ cgemm::Row row(int64_t r, int64_t M) const {
    return dense.row(r, M);
  }
  __device__ float2 epilogue(int64_t r, int c, float2 v) const {
    const float2 w = t[(r % T) * dense.N + c];
    return make_float2(__fsub_rn(__fmul_rn(v.x, w.x), __fmul_rn(v.y, w.y)),
                       __fadd_rn(__fmul_rn(v.x, w.y), __fmul_rn(v.y, w.x)));
  }
};

}  // namespace dftk

// x: (M, K) complex64, w: (N, K) complex64, y: (M, N) complex64, all
// contiguous on the current device.  Returns cudaGetLastError().
extern "C" int dft_matmul_launch(const void* x, const void* w, void* y,
                                 long long M, int N, int K, void* stream) {
  dftk::DenseRows op{K, N};
  return cgemm::launch(op, static_cast<const float2*>(x),
                       static_cast<const float2*>(w),
                       static_cast<float2*>(y), static_cast<int64_t>(M), N,
                       K, static_cast<cudaStream_t>(stream));
}

// x: (M, K), w: (N, K), t: (T, N), y: (M, N), all complex64 and contiguous
// on the current device; row r of y is multiplied by row (r mod T) of t.
// Returns cudaGetLastError().
extern "C" int dft_matmul_twiddle_launch(const void* x, const void* w,
                                         const void* t, void* y,
                                         long long M, int N, int K, int T,
                                         void* stream) {
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dftk::TwiddleRows op{dftk::DenseRows{K, N},
                       static_cast<const float2*>(t), T};
  return cgemm::launch(op, static_cast<const float2*>(x),
                       static_cast<const float2*>(w),
                       static_cast<float2*>(y), static_cast<int64_t>(M), N,
                       K, static_cast<cudaStream_t>(stream));
}
