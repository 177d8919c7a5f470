// Tensor-core complex GEMM over line DFTs for sm_90a (Hopper), fp32
// accurate through split-TF32 products.
//
//   y[r, c] = sum_k x[r, k] * W[c, k]        x (M, K), W (N, K), complex64
//
// Complex as one real GEMM.  Interleaved complex64 x of shape (M, K) is,
// bit for bit, a row-major fp32 (M, 2K) matrix x^.  With the real (2N, 2K)
// embedding W^ of W (row 2n holds (Wr, -Wi) at columns (2k, 2k+1), row
// 2n+1 holds (Wi, Wr)), the fp32 (M, 2N) product x^ . W^T *is* the
// interleaved complex64 y: 8·M·K·N real FLOP, every operand read and
// written in place, no re/im planes.
//
// 3xTF32.  A TF32 product keeps 10 mantissa bits.  Each fp32 operand a is
// split into a_big = rna(a) and a_small = rna(a - a_big), both TF32
// (round to nearest, ties away: cvt.rna.tf32.f32), and
//     a·b ~= a_small·b_big + a_big·b_small + a_big·b_big
// keeps about fp32's accuracy (the dropped a_small·b_small and the
// rounding of a_small are ~2^-22 relative).  The rounding is explicit:
// the tensor core truncates the low 13 bits of an unrounded fp32
// operand, which loses the split's accuracy.  W^ arrives split (two TF32
// planes, built once per DFT matrix by the host); the kernel splits its
// x^ tile in shared memory, in place (big) and into a second buffer
// (small).  The split is elementwise, so it is blind to the swizzle.
//
// Accumulation.  The tensor core adds each k8 step into its fp32
// accumulator with truncation, not round to nearest.  Chained over the
// whole K (up to 3·64 steps at 2K = 512) that bias grew to ~4e-6 of the
// output and to 4e-4 in an SCF energy (H100, chip_smoke.py).  So the
// wgmmas of one K chunk start from zero in a chunk accumulator, the
// chunk's 8 small-product steps come before its 4 big·big steps (they
// truncate while the sum is still ~2^-11 of its final size), and the
// chunks are added into the tile's accumulator with round-to-nearest
// fp32 adds.
//
// Data path.  A persistent grid (one block per SM) walks the output tiles
// of BM = 128 rows by BN = 128 real columns (64 complex outputs).  One
// producer warp keeps a ring of STAGES shared-memory stages full: each
// stage is one K chunk of 32 fp32 (one 128-byte swizzle row) of the x^
// tile and of both W^ planes, loaded by TMA (cp.async.bulk.tensor,
// 128-byte swizzle, zero fill out of bounds) and signalled by an
// mbarrier.  Two consumer warpgroups, 64 rows each, split their rows of
// the chunk and issue three wgmma.m64n128k8.f32.tf32.tf32 per 8 columns
// of K; while one warpgroup waits for its chunk and adds it up, the
// other's wgmmas run, and the loads of the next chunks (and of the next
// tile) overlap both.
//
// Operands whose rows TMA cannot address (odd K: a row pitch of 8·K
// bytes that is not a multiple of 16, or a base that is not 16-byte
// aligned) take the masked A path (template TMA_A = false): the producer
// warp loads the x^ tile with plain loads, zeros out of bounds, and
// stores it in the same swizzled layout.  W^'s planes always take TMA:
// their rows are padded to a multiple of 4 floats.
//
// Epilogue.  In wgmma's accumulator fragment each thread holds column
// pairs (2c, 2c+1): one complex output (yr, yi).  The policy's apply()
// maps it (identity, or the twiddle product) and it is stored as one
// float2.  Rows past M and columns past N are never stored; rows past M
// are never read (TMA zero-fills them, the masked path skips them).
// Output offsets are 64-bit: M reaches 2^21 rows of 2^8 complex.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int BM = 128;                   // rows per tile
constexpr int BK = 32;                    // fp32 columns per K chunk
constexpr int CONSUMERS = 2;              // warpgroups of 64 rows
constexpr int CONSUMER_WARPS = 4 * CONSUMERS;
constexpr int THREADS = 32 * (CONSUMER_WARPS + 1);   // + the producer

constexpr int BN = 128;                   // real columns per tile
constexpr int STAGES = 3;
constexpr int A_BYTES = BM * BK * 4;      // one x^ plane of a stage
constexpr int B_BYTES = BN * BK * 4;      // one W^ plane of a stage
// a stage: [x^ big | x^ small | W^ big | W^ small]
constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the phase of `bar` with this parity to complete.  A wait that
// outlasts WAIT_LIMIT_NS is a pipeline fault: it traps (the launch fails
// with an error) instead of hanging the card.
constexpr uint64_t WAIT_LIMIT_NS = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if ((n & 1023) == 0) {
      const uint64_t now = globaltimer_ns();
      if (n == 0) t0 = now;
      else if (now - t0 > WAIT_LIMIT_NS) __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* m,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(m)), "r"(c0),
         "r"(c1), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* m,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(m)), "r"(c0),
         "r"(c1), "r"(c2), "r"(smem_u32(bar)) : "memory");
}

// fp32 -> TF32, round to nearest with ties away from zero
__device__ __forceinline__ float tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return __uint_as_float(r);
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (SBO); the leading offset is unused for this layout
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void keep(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= a·b over one k8 step; scale_d = 0 ignores d's old value
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <bool TMA_A, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
cgemm_tc_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_b,
                const float* __restrict__ a, float2* __restrict__ y, Epi epi,
                int64_t M, int N, int K, int tiles_n, int64_t tiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int K2 = 2 * K;
  const int nk = (K2 + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // ---------------------------------------------------------- producer
    int64_t it = 0;
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = static_cast<int>((tile / tiles_n) * BM);
      const int n0 = static_cast<int>(tile % tiles_n) * BN;
      for (int kc = 0; kc < nk; ++kc, ++it) {
        const int s = static_cast<int>(it % STAGES);
        const uint32_t ph = static_cast<uint32_t>(it / STAGES) & 1u;
        mbar_wait(&empty[s], ph ^ 1u);
        unsigned char* st = smem + s * STAGE_BYTES;
        const int k0 = kc * BK;
        if constexpr (!TMA_A) {
          // masked x^ tile: lane = column, stored in TMA's 128-byte swizzle
          const int k = k0 + lane;
#pragma unroll 8
          for (int r = 0; r < BM; ++r) {
            const int64_t m = static_cast<int64_t>(m0) + r;
            const float v = (m < M && k < K2) ? a[m * K2 + k] : 0.0f;
            *reinterpret_cast<float*>(
                st + r * 128 + (((lane >> 2) ^ (r & 7)) << 4) +
                (lane & 3) * 4) = v;
          }
          __syncwarp();
        }
        if (lane == 0) {
          mbar_arrive_tx(&full[s], (TMA_A ? A_BYTES : 0) + 2 * B_BYTES);
          if constexpr (TMA_A) tma_load_2d(st, &tm_a, k0, m0, &full[s]);
          unsigned char* b = st + 2 * A_BYTES;
          tma_load_3d(b, &tm_b, k0, n0, 0, &full[s]);
          tma_load_3d(b + B_BYTES, &tm_b, k0, n0, 1, &full[s]);
        }
        __syncwarp();
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warp / 4;                     // this warpgroup's 64 rows
  const int t = threadIdx.x % 128;
  float acc[BN / 2];                           // the tile, round to nearest
  float part[BN / 2];                          // one K chunk, tensor core
  int64_t it = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t m0 = (tile / tiles_n) * BM;
    const int n0 = static_cast<int>(tile % tiles_n) * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = static_cast<int>(it % STAGES);
      const uint32_t ph = static_cast<uint32_t>(it / STAGES) & 1u;
      mbar_wait(&full[s], ph);
      unsigned char* st = smem + s * STAGE_BYTES;
      unsigned char* xa = st + wg * (A_BYTES / CONSUMERS);
      unsigned char* xs = xa + A_BYTES;
      unsigned char* wb = st + 2 * A_BYTES;
      unsigned char* ws = wb + B_BYTES;
      // split this warpgroup's rows: big in place, small beside it
#pragma unroll
      for (int j = 0; j < A_BYTES / CONSUMERS / 16 / 128; ++j) {
        float4* pb = reinterpret_cast<float4*>(xa) + t + 128 * j;
        float4* ps = reinterpret_cast<float4*>(xs) + t + 128 * j;
        const float4 v = *pb;
        float4 b, l;
        b.x = tf32_rna(v.x); l.x = tf32_rna(__fsub_rn(v.x, b.x));
        b.y = tf32_rna(v.y); l.y = tf32_rna(__fsub_rn(v.y, b.y));
        b.z = tf32_rna(v.z); l.z = tf32_rna(__fsub_rn(v.z, b.z));
        b.w = tf32_rna(v.w); l.w = tf32_rna(__fsub_rn(v.w, b.w));
        *pb = b;
        *ps = l;
      }
      // the generic-proxy writes must be visible to wgmma (async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
      keep(part);
      wgmma_fence();
      // k8 step j reads 32 bytes into each 128-byte swizzled row.  The
      // small products go first, while the chunk's sum is still small, so
      // only the four big·big steps truncate at the chunk's magnitude
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        wgmma_m64n128k8(part, sw128_desc(xs + 32 * j),
                        sw128_desc(wb + 32 * j), j > 0);
        wgmma_m64n128k8(part, sw128_desc(xa + 32 * j),
                        sw128_desc(ws + 32 * j), 1);
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        wgmma_m64n128k8(part, sw128_desc(xa + 32 * j),
                        sw128_desc(wb + 32 * j), 1);
      wgmma_commit();
      wgmma_wait<0>();
      keep(part);
      // the chunk's wgmmas are done: release its stage, add it up
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }

    // epilogue: acc[4j..4j+3] hold rows (g, g+8), complex column 4j + q;
    // each row's outputs are mapped first, then stored, so the policy's
    // loads are not held behind the stores
    const int w4 = warp % 4;
    const int64_t r0 = m0 + wg * 64 + w4 * 16 + lane / 4;
    const int c0 = n0 / 2 + (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = r0 + 8 * h;
      if (r >= M) continue;
      const auto row = epi.row(r);
      float2 out[BN / 8];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = c0 + 4 * j;
        out[j] = c < N ? epi.apply(row, c, make_float2(acc[4 * j + 2 * h],
                                                       acc[4 * j + 2 * h + 1]))
                       : make_float2(0.0f, 0.0f);
      }
      float2* yr = y + r * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        if (c0 + 4 * j < N) yr[c0 + 4 * j] = out[j];
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, fetched once through the runtime
// (no link against libcuda)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

inline bool encode(CUtensorMap* m, int rank, const void* base,
                   const cuuint64_t* dims, const cuuint64_t* strides,
                   const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Row pitch, in floats, of each W^ plane: 2K rounded up to 16 bytes.
inline int w_pitch(int K) { return (2 * K + 3) / 4 * 4; }

template <bool TMA_A, class Epi>
int launch_tiles(const Epi& epi, const float* x, const float* wsplit,
                 float2* y, int64_t M, int N, int K, cudaStream_t stream) {
  const int K2 = 2 * K;
  CUtensorMap tm_a{}, tm_b{};
  if constexpr (TMA_A) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K2),
                                static_cast<cuuint64_t>(M)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K2) * 4};
    const cuuint32_t box[2] = {BK, BM};
    if (!encode(&tm_a, 2, x, dims, strides, box))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int P = w_pitch(K);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K2),
                              static_cast<cuuint64_t>(2 * N), 2};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(P) * 4,
                                 static_cast<cuuint64_t>(2 * N) * P * 4};
  const cuuint32_t box[3] = {BK, BN, 1};
  if (!encode(&tm_b, 3, wsplit, dims, strides, box))
    return static_cast<int>(cudaErrorInvalidValue);

  const int tiles_n = (2 * N + BN - 1) / BN;
  const int64_t tiles = (M + BM - 1) / BM * tiles_n;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  auto kernel = cgemm_tc_kernel<TMA_A, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, SMEM, stream>>>(tm_a, tm_b, x, y, epi, M, N, K,
                                          tiles_n, tiles);
  return static_cast<int>(cudaGetLastError());
}

// y (M, N) = x (M, K) . W^T [then the epilogue], complex64 as fp32 views.
// wsplit: the two TF32 planes of W^, each (2N, 2K) with row pitch
// w_pitch(K), the small plane right after the big one.  tma_a: the x
// rows are TMA-addressable (K even, x 16-byte aligned); else the masked
// A path.  Returns the launch status (cudaGetLastError) as an int.
template <class Epi>
int launch(const Epi& epi, const float* x, const float* wsplit, float2* y,
           int64_t M, int N, int K, bool tma_a, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0 || M > 0x7fffffffLL - BM || N > (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  return tma_a ? launch_tiles<true>(epi, x, wsplit, y, M, N, K, stream)
               : launch_tiles<false>(epi, x, wsplit, y, M, N, K, stream);
}

}  // namespace tc
