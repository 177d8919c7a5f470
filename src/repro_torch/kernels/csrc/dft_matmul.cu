// dft_matmul — batched rectangular complex line DFT, y = x · Wᵀ.
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/dft_matmul.py
// (reached through kernels/ops.py::dft_apply), which runs the four real
// MXU GEMMs yr = xr·Wrᵀ − xi·Wiᵀ, yi = xr·Wiᵀ + xi·Wrᵀ on split re/im
// planes with the whole K kept in VMEM.
//
// What bounds it on an H100: operations.  At the stacked SCF's line
// shapes (K, N in {128, 256}) one complex MAC per 16 bytes moved gives
// 8·K·N / (8·(K + N)) ≈ 85 FLOP per byte, well above the ~20 FLOP/byte
// at which fp32 FMA (67 TFLOP/s, no tensor cores) overtakes HBM.
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
