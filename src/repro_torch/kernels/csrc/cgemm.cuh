// Tiled SIMT complex GEMM over line DFTs, shared by the line-DFT kernels.
//
//   y[row, c] = sum_k A[row, k] * W[c, k]          (complex64, fp32 FMA)
//
// W is the (N, K) rectangular DFT matrix, interleaved complex64.  The A
// operand and the place each output lands are described per row by a
// `Row` record that an Op policy builds once per block:
//
//   * A[row, k] = a[row.in + k] for row.in_lo <= k < row.in_hi, else 0
//     (dense rows for the plain line DFT, a CSR gather of packed sphere
//     lanes for the fused unpack);
//   * y[row, c] is stored to out[row.out + c] for row.out_lo <= c <
//     row.out_hi (dense rows, or a CSR scatter into packed lanes for the
//     fused pack);
//   * a row with active == 0 is never computed: its stored values are a
//     literal +0.0f.  A block whose rows are all inactive skips the
//     K loop entirely (the zero-skip of the sphere kernels);
//   * every computed value passes through the policy's epilogue,
//     op.epilogue(row, c, y), just before its store: the identity for the
//     plain line DFT and the sphere kernels, a complex twiddle product
//     for the four-step DFT's first stage.
//
// Design: a 64x64 output tile per 256-thread block, K staged through
// shared memory in chunks of 16, a 4x4 register micro-tile of complex
// accumulators per thread (rows ty + 16 i, columns tx + 16 j, so the W
// reads of a warp are 16 consecutive float2 and the A reads broadcast).
// One FMA per real product, no tensor cores: TF32 would lose the ~1e-6
// relative agreement with the fp32 reference.  All offsets are 64-bit:
// a (64, 256, 256, 256) complex slab has more than 2^31 elements.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cgemm {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

struct Row {
  int64_t in;     // offset of A[row, 0] in the A operand
  int64_t out;    // offset of y[row, 0] in the output
  int in_lo, in_hi;
  int out_lo, out_hi;
  int active;
};

template <class Op>
__global__ void __launch_bounds__(THREADS)
cgemm_kernel(Op op, const float2* __restrict__ a,
             const float2* __restrict__ w, float2* __restrict__ y,
             int64_t M, int N, int K, int tiles_n) {
  __shared__ float2 As[BK][BM + 1];
  __shared__ float2 Ws[BK][BN + 1];
  __shared__ Row rows[BM];
  __shared__ int any_active;

  const int tid = threadIdx.x;
  const int64_t tile = blockIdx.x;
  // column tiles vary fastest, so the blocks that share an A tile run
  // together and find it in L2
  const int64_t m0 = (tile / tiles_n) * BM;
  const int n0 = static_cast<int>(tile % tiles_n) * BN;

  if (tid == 0) any_active = 0;
  __syncthreads();
  if (tid < BM) {
    const Row r = op.row(m0 + tid, M);
    rows[tid] = r;
    if (r.active) any_active = 1;
  }
  __syncthreads();

  const int tx = tid % 16;
  const int ty = tid / 16;
  float cr[4][4], ci[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) cr[i][j] = ci[i][j] = 0.0f;

  if (any_active) {
    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
      for (int i = 0; i < (BM * BK) / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int mm = e / BK;
        const int kk = e % BK;
        const int k = k0 + kk;
        const Row& r = rows[mm];
        float2 v = make_float2(0.0f, 0.0f);
        if (r.active && k >= r.in_lo && k < r.in_hi) v = a[r.in + k];
        As[kk][mm] = v;
      }
#pragma unroll
      for (int i = 0; i < (BN * BK) / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int nn = e / BK;
        const int kk = e % BK;
        const int n = n0 + nn;
        const int k = k0 + kk;
        float2 v = make_float2(0.0f, 0.0f);
        if (n < N && k < K) v = w[static_cast<int64_t>(n) * K + k];
        Ws[kk][nn] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float2 av[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = Ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            cr[i][j] = fmaf(av[i].x, wv[j].x, cr[i][j]);
            cr[i][j] = fmaf(-av[i].y, wv[j].y, cr[i][j]);
            ci[i][j] = fmaf(av[i].x, wv[j].y, ci[i][j]);
            ci[i][j] = fmaf(av[i].y, wv[j].x, ci[i][j]);
          }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Row& r = rows[ty + 16 * i];
    const int64_t row = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < r.out_lo || c >= r.out_hi) continue;
      y[r.out + c] = r.active
          ? op.epilogue(row, c, make_float2(cr[i][j], ci[i][j]))
          : make_float2(0.0f, 0.0f);
    }
  }
}

// Launch the tiled kernel over an M x N output on `stream`; returns the
// launch status (cudaGetLastError) as an int.
template <class Op>
int launch(const Op& op, const float2* a, const float2* w, float2* y,
           int64_t M, int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const int tiles_n = (N + BN - 1) / BN;
  const int64_t tiles_m = (M + BM - 1) / BM;
  const int64_t blocks = tiles_m * tiles_n;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cgemm_kernel<Op><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      op, a, w, y, M, N, K, tiles_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cgemm
