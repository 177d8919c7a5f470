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
// tile and of both W^ planes, signalled by an mbarrier.  W^'s planes
// always come by TMA (cp.async.bulk.tensor, 128-byte swizzle; their rows
// are padded to a multiple of 4 floats).  Two consumer warpgroups, 64
// rows each, split their rows of the chunk and issue three
// wgmma.m64n128k8.f32.tf32.tf32 per 8 columns of K; while one warpgroup
// waits for its chunk and adds it up, the other's wgmmas run, and the
// loads of the next chunks (and of the next tile) overlap both.
//
// The x^ tile comes one of three ways (template A):
//   A_ROWS    TMA of K-major rows (x contiguous, K even, 16-byte base),
//             128-byte swizzle, zero fill out of bounds.
//   A_GATHER  loads by the consumers themselves, one complex per thread
//             and row, 16 threads a row: each warpgroup loads its 64 rows
//             of the next chunk into registers while the wgmmas of this
//             one run, then splits them straight into big and small in
//             the same swizzled layout.  Each row's source is the
//             policy's src() line; its columns outside [lo, hi) are zeros
//             whose addresses are never formed.  Odd K, a misaligned x,
//             and the CSR gather of packed sphere lanes take it.
//   A_COLS    TMA of lines that are strided in K: planes of L lines
//             stored z-major, element (plane·L + l, k) at
//             plane·(K·L) + k·L + l (the layout a line-DFT stage over
//             another axis leaves).  Each warpgroup's 64 rows arrive as
//             one box of [64/E planes][16 k][E lines] (E = min(L, 64)),
//             unswizzled,
//             in the small buffer; the split reads them across and writes
//             big and small K-major, so no copy of x is made first.
//             wgmma takes 32-bit operands K-major only, hence the
//             transpose in shared memory.
//
// Policies.  The kernel asks its policy (template Epi) per tile and row:
//   chunks(tm, nk)  the K chunks [x, y) that row tile tm can have
//                   nonzero; the others are skipped by the producer and
//                   the consumers alike, and an empty range issues no load
//                   and no wgmma (its rows store zeros);
//   src(r, K)       (A_GATHER) row r's complex column k is
//                   x[off + k − lo] for lo <= k < hi and 0 elsewhere;
//   dst(r, N)       row r's complex columns lo <= c < hi are stored at
//                   y[off + c − lo]; a row that is not active stores +0.0f
//                   there (asked only when dense_store is false);
//   row(r), apply(row, c, v)  map each computed output (identity, or the
//                   twiddle product) just before it is stored.
// `Dense` answers for the plain GEMM: all of K, all of N at y + r·N.
//
// Epilogue.  In wgmma's accumulator fragment each thread holds column
// pairs (2c, 2c+1): one complex output (yr, yi), stored as one float2.
// Rows past M are never stored and never read (TMA zero-fills them, the
// gather skips them).  Offsets are 64-bit: M reaches 2^21 rows of 2^8
// complex.
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
// the stages, then the barriers, then the gathered rows' sources
constexpr int SRC_OFFSET = STAGES * STAGE_BYTES + 2 * STAGES * 8;
constexpr int SMEM = SRC_OFFSET + BM * 16 + 1024;

// where the x^ tile comes from (see the header)
enum { A_ROWS = 0, A_GATHER = 1, A_COLS = 2 };

// A line of a policy: the columns [lo, hi) it covers, column c at offset
// off + c − lo (complex elements), and whether it is active (dst only:
// inactive lines store +0.0f)
struct Line {
  int64_t off;
  int lo, hi;
  int active;
};

// The plain GEMM's policy: every K chunk, row r's x at x + r·K, its
// outputs at y + r·N, stored as computed.  dense_store: the epilogue
// stores every row whole at y + r·N without asking dst() (a policy with
// its own dst() sets it false).
struct Dense {
  static constexpr bool dense_store = true;
  struct Row {};
  __device__ int2 chunks(int64_t, int nk) const { return make_int2(0, nk); }
  __device__ Line src(int64_t r, int K) const { return {r * K, 0, K, 1}; }
  __device__ Line dst(int64_t r, int N) const { return {r * N, 0, N, 1}; }
  __device__ Row row(int64_t) const { return {}; }
  __device__ float2 apply(Row, int, float2 v) const { return v; }
};

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

// a gathered row's source (a Line without the flag), in shared memory
struct Src {
  int64_t off;
  int lo, hi;
};

__device__ __forceinline__ float4 tf32_big(float4 v) {
  return make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z),
                     tf32_rna(v.w));
}

__device__ __forceinline__ float4 tf32_small(float4 v, float4 b) {
  return make_float4(tf32_rna(__fsub_rn(v.x, b.x)),
                     tf32_rna(__fsub_rn(v.y, b.y)),
                     tf32_rna(__fsub_rn(v.z, b.z)),
                     tf32_rna(__fsub_rn(v.w, b.w)));
}

template <int A, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
cgemm_tc_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_b,
                const float* __restrict__ a, float2* __restrict__ y, Epi epi,
                int64_t M, int N, int K, int L, int tiles_n,
                int64_t tiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  Src* srcs = reinterpret_cast<Src*>(smem + SRC_OFFSET);
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
      const int64_t tm = tile / tiles_n;
      const int64_t m0 = tm * BM;
      const int n0 = static_cast<int>(tile % tiles_n) * BN;
      const int2 kr = epi.chunks(tm, nk);
      for (int kc = kr.x; kc < kr.y; ++kc, ++it) {
        const int s = static_cast<int>(it % STAGES);
        const uint32_t ph = static_cast<uint32_t>(it / STAGES) & 1u;
        mbar_wait(&empty[s], ph ^ 1u);
        unsigned char* st = smem + s * STAGE_BYTES;
        const int k0 = kc * BK;
        if (lane == 0) {
          mbar_arrive_tx(&full[s],
                         (A == A_GATHER ? 0 : A_BYTES) + 2 * B_BYTES);
          if constexpr (A == A_ROWS)
            tma_load_2d(st, &tm_a, k0, static_cast<int>(m0), &full[s]);
          if constexpr (A == A_COLS) {
            // each warpgroup's 64 rows, one box into its half of the
            // small buffer
            for (int g = 0; g < CONSUMERS; ++g) {
              const int64_t r = m0 + g * (BM / CONSUMERS);
              tma_load_3d(st + A_BYTES + g * (A_BYTES / CONSUMERS), &tm_a,
                          2 * static_cast<int>(r % L), kc * (BK / 2),
                          static_cast<int>(r / L), &full[s]);
            }
          }
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
  // A_GATHER: this thread's complex column gc of each chunk, in rows
  // grow + 2q (q < 8) of the warpgroup's 64, whose sources are in wsrcs;
  // v holds the next chunk's values, loaded while this one computes.
  // (Loading two chunks ahead spilled and ran slower on the H100.)
  const float2* a2 = reinterpret_cast<const float2*>(a);
  const int gc = lane & 15;
  const int grow = (warp % 4) * 16 + (lane >> 4);
  Src* wsrcs = srcs + wg * (BM / CONSUMERS);
  constexpr int GQ = BM / CONSUMERS / 8;
  float2 v[GQ];
  auto gather = [&](int kc) {
    const int z = kc * (BK / 2) + gc;
#pragma unroll
    for (int q = 0; q < GQ; ++q) {
      const Src src = wsrcs[grow + 2 * q];
      v[q] = (z >= src.lo && z < src.hi)
                 ? __ldg(a2 + (src.off + (z - src.lo)))
                 : make_float2(0.0f, 0.0f);
    }
  };
  // split v into this warpgroup's big rows (xa) and small rows, in TMA's
  // 128-byte swizzle
  auto put = [&](unsigned char* xa) {
#pragma unroll
    for (int q = 0; q < GQ; ++q) {
      const int i = grow + 2 * q;
      const int off = i * 128 + (((gc >> 1) ^ (i & 7)) << 4) + (gc & 1) * 8;
      const float bx = tf32_rna(v[q].x);
      const float by = tf32_rna(v[q].y);
      *reinterpret_cast<float2*>(xa + off) = make_float2(bx, by);
      *reinterpret_cast<float2*>(xa + A_BYTES + off) =
          make_float2(tf32_rna(__fsub_rn(v[q].x, bx)),
                      tf32_rna(__fsub_rn(v[q].y, by)));
    }
  };
  // A_COLS: this thread's row of the box and its column pairs t/64 + 2q
  const int lg = 31 - __clz(L < 64 ? (L > 0 ? L : 1) : 64);
  const int ci = t & 63;
  const int col0 = ((ci >> lg) << (lg + 5)) + 2 * (ci & ((1 << lg) - 1));
  float acc[BN / 2];                           // the tile, round to nearest
  float part[BN / 2];                          // one K chunk, tensor core
  int64_t it = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t tm = tile / tiles_n;
    const int64_t m0 = tm * BM;
    const int n0 = static_cast<int>(tile % tiles_n) * BN;
    const int2 kr = epi.chunks(tm, nk);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    if constexpr (A == A_GATHER) {
      if (kr.x < kr.y) {
        // this tile's row sources (every read of the last tile's came
        // before its last chunk's barrier), then its first chunk
        if (t < BM / CONSUMERS) {
          Src src{0, 0, 0};
          const int64_t m = m0 + wg * (BM / CONSUMERS) + t;
          if (m < M) {
            const Line l = epi.src(m, K);
            src = {l.off, l.lo, l.hi};
          }
          wsrcs[t] = src;
        }
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
        gather(kr.x);
      }
    }
    for (int kc = kr.x; kc < kr.y; ++kc, ++it) {
      const int s = static_cast<int>(it % STAGES);
      const uint32_t ph = static_cast<uint32_t>(it / STAGES) & 1u;
      mbar_wait(&full[s], ph);
      unsigned char* st = smem + s * STAGE_BYTES;
      unsigned char* xa = st + wg * (A_BYTES / CONSUMERS);
      unsigned char* xs = xa + A_BYTES;
      unsigned char* wb = st + 2 * A_BYTES;
      unsigned char* ws = wb + B_BYTES;
      if constexpr (A == A_GATHER) {
        put(xa);
        if (kc + 1 < kr.y) gather(kc + 1);
      } else if constexpr (A == A_COLS) {
        // the box in xs: row i = pl·E + y, complex column z at float
        // pl·32E + z·2E + 2y.  Read it all, then write big and small
        // K-major in the swizzle (over the box: hence the barrier)
        const float* raw = reinterpret_cast<const float*>(xs) + col0;
        const int zs = 4 << lg;                // two columns of z
        float4 v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int zp = (t >> 6) + 2 * q;
          const float2 lo = *reinterpret_cast<const float2*>(raw + zp * zs);
          const float2 hi =
              *reinterpret_cast<const float2*>(raw + zp * zs + zs / 2);
          v[q] = make_float4(lo.x, lo.y, hi.x, hi.y);
        }
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int zp = (t >> 6) + 2 * q;
          const int off = ci * 128 + ((zp ^ (ci & 7)) << 4);
          const float4 b = tf32_big(v[q]);
          *reinterpret_cast<float4*>(xa + off) = b;
          *reinterpret_cast<float4*>(xs + off) = tf32_small(v[q], b);
        }
      } else {
        // split this warpgroup's rows: big in place, small beside it
#pragma unroll
        for (int j = 0; j < A_BYTES / CONSUMERS / 16 / 128; ++j) {
          float4* pb = reinterpret_cast<float4*>(xa) + t + 128 * j;
          float4* ps = reinterpret_cast<float4*>(xs) + t + 128 * j;
          const float4 v = *pb;
          const float4 b = tf32_big(v);
          *pb = b;
          *ps = tf32_small(v, b);
        }
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
      if constexpr (Epi::dense_store) {
        const auto row = epi.row(r);
        float2 out[BN / 8];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = c0 + 4 * j;
          out[j] = c < N ? epi.apply(row, c,
                                     make_float2(acc[4 * j + 2 * h],
                                                 acc[4 * j + 2 * h + 1]))
                         : make_float2(0.0f, 0.0f);
        }
        float2* yr = y + r * N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          if (c0 + 4 * j < N) yr[c0 + 4 * j] = out[j];
      } else {
        const Line d = epi.dst(r, N);
        float2* yr = y + d.off;                // column c at yr[c - lo]
        const unsigned span = static_cast<unsigned>(d.hi - d.lo);
        const int c1 = c0 - d.lo;
        if (!d.active) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            if (static_cast<unsigned>(c1 + 4 * j) < span)
              yr[c1 + 4 * j] = make_float2(0.0f, 0.0f);
          continue;
        }
        const auto row = epi.row(r);
        float2 out[BN / 8];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          out[j] = static_cast<unsigned>(c1 + 4 * j) < span
                       ? epi.apply(row, c0 + 4 * j,
                                   make_float2(acc[4 * j + 2 * h],
                                               acc[4 * j + 2 * h + 1]))
                       : make_float2(0.0f, 0.0f);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          if (static_cast<unsigned>(c1 + 4 * j) < span)
            yr[c1 + 4 * j] = out[j];
      }
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
                   const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Row pitch, in floats, of each W^ plane: 2K rounded up to 16 bytes.
inline int w_pitch(int K) { return (2 * K + 3) / 4 * 4; }

// L lines a plane fit A_COLS's box: even, a divisor or a multiple of 64
inline bool cols_fit(int L) {
  return L >= 2 && L % 2 == 0 && (L % 64 == 0 || 64 % L == 0);
}

// y = x (M, K) . W^T through the policy epi, complex64 as fp32 views, the
// x^ tile taken the way A says (see the header).  wsplit: the two TF32
// planes of W^, each (2N, 2K) with row pitch w_pitch(K), the small plane
// right after the big one.  A_ROWS needs K even and x 16-byte aligned;
// A_COLS needs cols_fit(L), L | M and x 16-byte aligned (L is unused
// otherwise).  Returns the launch status (cudaGetLastError) as an int.
template <int A, class Epi>
int launch(const Epi& epi, const float* x, const float* wsplit, float2* y,
           int64_t M, int N, int K, int L, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0 || M > 0x7fffffffLL - BM || N > (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int K2 = 2 * K;
  CUtensorMap tm_a{}, tm_b{};
  if constexpr (A == A_ROWS) {
    if (K % 2 || !aligned) return static_cast<int>(cudaErrorInvalidValue);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K2),
                                static_cast<cuuint64_t>(M)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K2) * 4};
    const cuuint32_t box[2] = {BK, BM};
    if (!encode(&tm_a, 2, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (A == A_COLS) {
    if (!cols_fit(L) || M % L || !aligned)
      return static_cast<int>(cudaErrorInvalidValue);
    // (line pairs of floats, z, plane); a box is [64/E][16][2E floats]
    const cuuint32_t E = L < 64 ? L : 64;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(2 * L),
                                static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(M / L)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(2 * L) * 4,
                                   static_cast<cuuint64_t>(2 * L) * K * 4};
    const cuuint32_t box[3] = {2 * E, BK / 2, 64 / E};
    if (!encode(&tm_a, 3, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int P = w_pitch(K);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K2),
                              static_cast<cuuint64_t>(2 * N), 2};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(P) * 4,
                                 static_cast<cuuint64_t>(2 * N) * P * 4};
  const cuuint32_t box[3] = {BK, BN, 1};
  if (!encode(&tm_b, 3, wsplit, dims, strides, box,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);

  const int tiles_n = (2 * N + BN - 1) / BN;
  const int64_t tiles = (M + BM - 1) / BM * tiles_n;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  auto kernel = cgemm_tc_kernel<A, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, SMEM, stream>>>(tm_a, tm_b, x, y, epi, M, N, K,
                                          L, tiles_n, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
