// dft_matmul — batched rectangular complex line DFT, y = x · Wᵀ, and its
// twiddle variant y = (x · Wᵀ) ⊙ t, on Hopper's tensor cores.
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
// What bounds them on an H100, for fp32-accurate products: the inverse x
// stage of the stacked H apply (2,097,152 lines, 128 → 256) does 550 GFLOP
// and moves 6.4 GB; as three TF32 passes at 495 TFLOP/s that is 3.33 ms,
// against 1.92 ms for its bytes at 3.35 TB/s, so operations.  The twiddle
// entry at the four-step's stage-1 shape (262,144 lines, 64 → 64, a 32 KB
// table) moves 268 MB: 0.080 ms by bytes, against 0.053 ms of 3xTF32
// operations, so bytes.
//
// What the design does about it (csrc/cgemm_tc.cuh): complex64 is read
// and written in place as one real GEMM against the (2N, 2K) real
// embedding of W; the products run on the tensor cores through wgmma in
// split TF32 (three passes, fp32 accuracy), fed by TMA through a ring of
// shared-memory stages that one producer warp keeps full while two
// consumer warpgroups compute; a persistent grid lets the loads of the
// next tile overlap the stores of the last.
//
// `dft_factored_launch` and `dft_factored_cols_launch` are kernel #1's
// factored mode for lines whose longer length is 256 (n_in, n_out in
// {64, 128, 256}): the same operator as the dense product, computed as
// two 16-point tensor-core stages with a twiddle between them
// (csrc/cgemm_tc_factored.cuh).  A 128→256 line takes 6,144 complex
// products instead of 32,768, so the pair's stages are bound by their
// bytes (idft[x] 128->256 on 4,194,304 lines: 12.9 GB, 3.84 ms at
// 3.35 TB/s, against 1.25 ms of 3xTF32 operations).  kernels/ops.py::
// dft_apply chooses it by shape.  It replaces no TPU kernel of its own:
// the reference's `_kernel` computes the same operator as one product.
#include "cgemm_tc.cuh"
#include "cgemm_tc_factored.cuh"

namespace dftk {

using Identity = tc::Dense;

// The twiddle product yr·tr − yi·ti, yr·ti + yi·tr in the TPU kernel's
// order, rounded after every operation (no FMA contraction), so it adds no
// rounding difference of its own against the plain version.
struct Twiddle : tc::Dense {
  const float2* t;   // (T, N) complex64
  int T, N;
  __device__ const float2* row(int64_t r) const { return t + (r % T) * N; }
  __device__ float2 apply(const float2* tr, int c, float2 v) const {
    const float2 w = tr[c];
    return make_float2(__fsub_rn(__fmul_rn(v.x, w.x), __fmul_rn(v.y, w.y)),
                       __fadd_rn(__fmul_rn(v.x, w.y), __fmul_rn(v.y, w.x)));
  }
};

template <class Epi>
int launch(const Epi& epi, const void* x, const void* wsplit, void* y,
           long long M, int N, int K, int tma_a, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(wsplit);
  float2* yf = static_cast<float2*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tma_a)
    return tc::launch<tc::A_ROWS>(epi, xf, wf, yf, M, N, K, 0, s);
  return tc::launch<tc::A_GATHER>(epi, xf, wf, yf, M, N, K, 0, s);
}

}  // namespace dftk

// x: (M, K) complex64, wsplit: the split embedding of the (N, K) DFT
// matrix (two TF32 planes of (2N, 2K), row pitch tc::w_pitch(K)), y:
// (M, N) complex64, all on the current device.  tma_a != 0: K is even
// and x is 16-byte aligned.  Returns cudaGetLastError().
extern "C" int dft_matmul_launch(const void* x, const void* wsplit, void* y,
                                 long long M, int N, int K, int tma_a,
                                 void* stream) {
  return dftk::launch(dftk::Identity{}, x, wsplit, y, M, N, K, tma_a,
                      stream);
}

// As dft_matmul_launch, for lines strided in K: x is (M / L, K, L)
// complex64 in memory, planes of L lines stored K-major, line l of plane p
// being row p·L + l of y (the layout a line-DFT stage over another axis
// leaves).  The x^ tile comes by TMA and is transposed in shared memory
// during the TF32 split (tc::A_COLS), so x is read where it lies, without
// a copy into rows first.  Needs tc::cols_fit(L), L | M and x 16-byte
// aligned.  Returns cudaGetLastError().
extern "C" int dft_matmul_cols_launch(const void* x, const void* wsplit,
                                      void* y, long long M, int N, int K,
                                      int L, void* stream) {
  return tc::launch<tc::A_COLS>(
      dftk::Identity{}, static_cast<const float*>(x),
      static_cast<const float*>(wsplit), static_cast<float2*>(y), M, N, K, L,
      static_cast<cudaStream_t>(stream));
}

// As dft_matmul_launch, with t: (T, N) complex64; row r of y is multiplied
// by row (r mod T) of t.  Returns cudaGetLastError().
extern "C" int dft_matmul_twiddle_launch(const void* x, const void* wsplit,
                                         const void* t, void* y,
                                         long long M, int N, int K, int T,
                                         int tma_a, void* stream) {
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dftk::Twiddle tw;
  tw.t = static_cast<const float2*>(t);
  tw.T = T;
  tw.N = N;
  return dftk::launch(tw, x, wsplit, y, M, N, K, tma_a, stream);
}

// The factored line DFT on rows: x (M, n_in) complex64, 16-byte aligned;
// ops: (4, 32, 32) fp32, the two stages' split embeddings; tw: (16, 16)
// complex64 twiddles; y (M, n_out) complex64.  (n_in, n_out): 256 and one
// of 64, 128, 256.  Returns cudaGetLastError().
extern "C" int dft_factored_launch(const void* x, const void* ops,
                                   const void* tw, void* y, long long M,
                                   int n_in, int n_out, void* stream) {
  return tc::launch_factored_shape<tc::A_ROWS>(
      static_cast<const float*>(x), static_cast<const float*>(ops),
      static_cast<const float2*>(tw), static_cast<float2*>(y), M, n_in,
      n_out, 0, static_cast<cudaStream_t>(stream));
}

// As dft_factored_launch, for lines strided in K: x (M / L, n_in, L)
// complex64, line l of plane p being row p·L + l of y.  Needs L even, a
// multiple of 16 or a divisor of 16, and L | M.  Returns cudaGetLastError().
extern "C" int dft_factored_cols_launch(const void* x, const void* ops,
                                        const void* tw, void* y,
                                        long long M, int n_in, int n_out,
                                        int L, void* stream) {
  return tc::launch_factored_shape<tc::A_COLS>(
      static_cast<const float*>(x), static_cast<const float*>(ops),
      static_cast<const float2*>(tw), static_cast<float2*>(y), M, n_in,
      n_out, L, static_cast<cudaStream_t>(stream));
}
