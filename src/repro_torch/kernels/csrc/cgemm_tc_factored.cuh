// The factored mode of the tensor-core line DFT: a line of n = 256 =
// 16·16 as two 16-point DFT stages with a twiddle between them, both
// stages on the tensor cores in split TF32, in one launch.
//
// With j = j1 + 16·j2 (input) and k = k2 + 16·k1 (output), s the sign of
// the transform and w_m = exp(s·2πi/m):
//
//   y[k] = sum_j1 w_16^(j1·k1) · w_256^(j1·k2) · sum_j2 w_16^(j2·k2) ·
//          x[j1 + 16·j2]
//
// Zero padding (n_in = 16·KC < 256) reads only j2 < KC; truncation
// (n_out = 16·NC < 256) computes only k1 < NC; the inverse's 1/256 is
// folded into the twiddle table (a power of two: exact).  So a 128→256 or
// 256→128 line costs 6,144 complex products, not the dense 32,768, and
// #1 is bound by its bytes, not by the tensor cores.
//
// One warp owns one line from load to store, so nothing between the two
// stages leaves the SM, and nothing but the warp's own shared memory is
// touched between them:
//   1. Load.  One producer warp brings a tile of TL = 32 whole lines by
//      TMA into a ring of shared-memory stages: rows (A_ROWS) as a box of
//      [32 lines][n_in], or lines strided in K (A_COLS, planes of L lines
//      stored K-major) as two boxes of 16 lines, each [n_in][16 lines] in
//      the 128-byte swizzle (for L >= 16; L in {2, 4, 8}: [16/L planes]
//      [n_in][L], unswizzled).
//   2. Stage 1.  Each of four consumer warpgroups takes 8 lines of the
//      tile, 4 at a time: warp w's 16 rows of the m64 tile are its line's
//      j1, K = j2.  (With two warpgroups every shape took the same time a
//      line whatever its bytes, 55–78% of the byte bound on the H100: the
//      chain load → wgmma → twiddle → transpose → wgmma → store is latency
//      that more warpgroups hide; with four, 73–89%.)  Each
//      thread reads its A fragment straight out of the raw tile (the
//      layout is in the address, so rows and strided lines give the same
//      registers), splits it into TF32 big and small in registers, and
//      three register-A wgmma.m64n32k8 per k8 step run it against the
//      split real embedding of DFT_16 (built once by the host, kept in
//      shared memory for the block's life).
//   3. Twiddle.  Each thread's accumulator holds the same (j1, k2) cells
//      for every line, so its 8 twiddles stay in registers: rounded fp32
//      products, no FMA contraction.
//   4. Transpose.  The warp writes its line's 16×16 block to its own
//      shared-memory rows (pitch 20 complex: conflict-free both ways),
//      reads it back as rows k2, K = j1, and splits it again.
//   5. Stage 2.  Three register-A wgmma.m64n(2·NC)k8 per k8 step against
//      DFT_16's kept rows k1 < NC.
//   6. Store.  Each thread writes its outputs (k2, k1) at k2 + 16·k1 of
//      the line: 64 contiguous bytes per 8 lanes.
//
// Precision: both stages keep the dense kernel's 3xTF32 products and
// order (the small products of all k8 steps first, from zero, then the
// big ones); each stage's K is at most 32 fp32, one chunk.  The outputs
// add +0.0f last, as the dense kernel's chunk sum does, so a zero is +0.0.
//
// The K order inside a k8 step is free as long as A and B agree: position
// q + 4e of step kk is complex index 4·kk + q, part e (re, im), so one
// float2 load fills a thread's two registers of a row.  The host builds
// the embeddings in that order (kernels/dft_matmul.py::factored_operands).
//
// Sphere lines.  The same body serves the sphere kernels #3 and #4
// (csrc/sphere_pack.cu) through a policy (template Sph; fct::Rows is
// #1's, rows in and rows out).  Either way the producer warp reads the
// tile's 32 lines of the line tables, one a lane, before it waits for the
// stage, and writes each line's run to a per-stage table in shared memory
// that the consumers read with the stage (off the chain of loads that
// feeds the tensor cores: #4 read its tables in the consumer warps first,
// 2.73 ms a 128-band call on the H100, against 2.30 ms so):
//   gather   the lines come from packed CSR lanes (A_GATHER; src(r):
//            element j at x[off + j − lo] for lo <= j < hi, hi = lo for a
//            line that loads nothing).  One bulk copy (cp.async.bulk)
//            brings the span from the tile's first active lane to its
//            last, its ends rounded to 16 bytes (the array is 16-byte
//            aligned and holds whole 16 bytes, so they stay inside it).
//            The lanes of a row's consecutive lines are consecutive (CSR
//            order), so a tile of one row spans at most 32 · n_in lanes; a
//            wider span is a fault and traps.  Each thread takes element j
//            of its line from the span, or +0.0 outside the line's run, so
//            no lane outside it is used.  Lines that load nothing store
//            +0.0.
//   scatter  the lines come by TMA as for #1; each line's outputs
//            lo <= k < hi go to y[off + k − lo] (dst(r)), the others are
//            not stored.
#pragma once

#include <type_traits>

#include "cgemm_tc.cuh"

namespace tc {
namespace fct {

constexpr int N1 = 16;                   // j1, k1: rows of a line, stage-2 K
constexpr int N2 = 16;                   // j2, k2
constexpr int TL = 32;                   // lines a tile
constexpr int CONS = 4;                  // consumer warpgroups
constexpr int CWARPS = 4 * CONS;
constexpr int THREADS = 32 * (CWARPS + 1);
constexpr int ZP = 20;                   // complex pitch of a warp's rows
constexpr int Z_BYTES = N1 * ZP * 8;
constexpr int OP_BYTES = 32 * 128;       // one operand plane: 32 rows, 128 B
constexpr int OPS = 4;                   // B1 big, B1 small, B2 big, B2 small
constexpr int SMEM_MAX = 232448;

// The shared memory of a block: [operands | stages | Z rows | line tables
// | barriers]; a stage holds TL lines of n_in (+ PAD bytes), a line table
// META bytes a stage
template <int KC, int PAD = 0, int META = 0>
struct Tile {
  static constexpr int STAGE = TL * N2 * KC * 8 + PAD;
  static constexpr int FIXED =
      OPS * OP_BYTES + CWARPS * Z_BYTES + 4 * (2 * 8 + META) + 1024;
  static constexpr int FIT = (SMEM_MAX - FIXED) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int Z_OFFSET = OPS * OP_BYTES + STAGES * STAGE;
  static constexpr int META_OFFSET = Z_OFFSET + CWARPS * Z_BYTES;
  static constexpr int BAR_OFFSET = META_OFFSET + STAGES * META;
  static constexpr int SMEM = BAR_OFFSET + 2 * STAGES * 8 + 1024;
  static_assert(STAGES >= 2, "a tile of lines must fit twice");
  static_assert(STAGE % 16 == 0 && META % 16 == 0, "");
};

// #1's policy: lines by TMA, outputs in rows at y + line·n_out
struct Rows {
  static constexpr bool gather = false;
  static constexpr bool scatter = false;
  static constexpr int PAD = 0, META = 0;
};

// a gathered tile's span, rounded to 16 bytes, may be one pair wider
constexpr int GATHER_PAD = 16;
// a stage's table of line runs (gather, scatter): an int4 a line
constexpr int RUNS_META = TL * 16;

__device__ __forceinline__ int64_t warp_min(int64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u < v ? u : v;
  }
  return v;
}

__device__ __forceinline__ int64_t warp_max(int64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// d (+)= a·b over one k8 step, a from registers (TF32 bits), b by
// descriptor; scale_d = 0 ignores d's old value
__device__ __forceinline__ void wgmma_ra(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ra(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ra(float (&d)[4], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int R>
__device__ __forceinline__ void keep_u(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e]) :: "memory");
}

// one row pair's values (rows g and g+8 of the fragment) as the k8 step's
// A registers {re g, re g+8, im g, im g+8}, split into TF32 big and small
__device__ __forceinline__ void split_pair(float2 v0, float2 v1,
                                           uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
  const float v[4] = {v0.x, v1.x, v0.y, v1.y};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float b = tf32_rna(v[e]);
    big[e] = __float_as_uint(b);
    small[e] = __float_as_uint(tf32_rna(__fsub_rn(v[e], b)));
  }
}

// three-pass split-TF32 product of one stage: small products of every k8
// step first (the first from zero), then the big ones
template <int KS, int R>
__device__ __forceinline__ void stage_mma(float (&d)[R],
                                          uint32_t (&big)[KS][4],
                                          uint32_t (&small)[KS][4],
                                          const unsigned char* wb,
                                          const unsigned char* ws) {
  keep(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    wgmma_ra(d, small[kk], sw128_desc(wb + 32 * kk), kk > 0);
    wgmma_ra(d, big[kk], sw128_desc(ws + 32 * kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_ra(d, big[kk], sw128_desc(wb + 32 * kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  keep(d);
  // the registers stay the wgmmas' until they are done
  keep_u(big);
  keep_u(small);
}

}  // namespace fct

namespace fct {

// The kernel's body for x's lines as the policy says (see the header): TMA
// of rows (A_ROWS, (M, n_in)) or of planes strided in K (A_COLS, (M / L,
// n_in, L)), or the CSR gather (A_GATHER, Sph::gather).  ops: (4, 32, 32)
// fp32, the split embeddings of stage 1 and stage 2 in the k8 order above
// (rows past 2·16 or 2·NC and columns past 2·KC or 32 zero); tw: (16, 16)
// complex64, row j1 column k2 (times 1/256 for the inverse); y: (M, 16·NC)
// complex64, or the scattered lanes (Sph::scatter).
template <int A, int KC, int NC, class Sph>
__device__ __forceinline__ void body(unsigned char* smem_raw,
                                     const CUtensorMap* tm_x,
                                     const float4* __restrict__ ops,
                                     const float2* __restrict__ tw,
                                     float2* __restrict__ y, const Sph sph,
                                     int64_t M, int L, int64_t tiles) {
  using T = Tile<KC, Sph::PAD, Sph::META>;
  constexpr int NIN = N2 * KC;
  constexpr int NOUT = N2 * NC;
  constexpr int K1 = KC / 4;                   // stage-1 k8 steps
  constexpr int K2 = N1 / 4;                   // stage-2 k8 steps
  static_assert(KC % 4 == 0 && KC <= 16 && NC % 4 == 0 && NC <= 16, "");
  static_assert(Sph::gather == (A == A_GATHER), "");
  static_assert(Sph::META == (Sph::gather || Sph::scatter ? RUNS_META : 0),
                "a policy with line runs keeps a table of them a stage");
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* opsm = smem;
  unsigned char* stages = smem + OPS * OP_BYTES;
  int4* runs = reinterpret_cast<int4*>(smem + T::META_OFFSET);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFFSET);
  uint64_t* empty = full + T::STAGES;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // the operands, once, into the 128-byte swizzle wgmma reads
  for (int i = threadIdx.x; i < OPS * 32 * 8; i += blockDim.x) {
    const int n = (i / 8) % 32, c = i % 8;
    *reinterpret_cast<float4*>(opsm + (i / 256) * OP_BYTES + n * 128 +
                               ((c ^ (n & 7)) << 4)) = ops[i];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      // with line runs every producer lane arrives after writing its own
      mbar_init(&full[s], Sph::gather || Sph::scatter ? 32 : 1);
      mbar_init(&empty[s], CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (warp == CWARPS) {
    // ---------------------------------------------------------- producer
    // a tile of rows or strided lines by TMA: one box of 32 rows, or two
    // boxes of 16 lines
    auto load_tile = [&](unsigned char* st, uint64_t* bar, int64_t m0) {
      if constexpr (A == A_ROWS) {
        tma_load_3d(st, tm_x, 0, 0, static_cast<int>(m0), bar);
      } else if constexpr (A == A_COLS) {
        for (int b = 0; b < 2; ++b) {
          const int64_t l0 = m0 + 16 * b;
          tma_load_3d(st + b * (T::STAGE / 2), tm_x,
                      L >= 16 ? 2 * static_cast<int>(l0 % L) : 0, 0,
                      static_cast<int>(l0 / L), bar);
        }
      }
    };
    int64_t it = 0;
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
      const int s = static_cast<int>(it % T::STAGES);
      const uint32_t ph = static_cast<uint32_t>(it / T::STAGES) & 1u;
      unsigned char* st = stages + s * T::STAGE;
      const int64_t m0 = tile * TL;
      if constexpr (Sph::gather || Sph::scatter) {
        // this lane's line, read before the wait it overlaps
        const int64_t r = m0 + lane;
        Line ln{0, 0, 0, 0};
        if constexpr (Sph::gather) ln = sph.src(r, 0);
        else if (r < M) ln = sph.dst(r, 0);
        mbar_wait(&empty[s], ph ^ 1u);
        uint32_t bytes = T::STAGE;
        int64_t lo = 0, n = 0;
        if constexpr (Sph::gather) {
          // the span [lo, lo + n) of the tile's lanes, in whole 16 bytes
          const bool on = ln.hi > ln.lo;
          const int64_t first = warp_min(on ? ln.off : INT64_MAX);
          const int64_t end = warp_max(on ? ln.off + (ln.hi - ln.lo) : 0);
          if (end > 0) {
            lo = first & ~int64_t(1);
            n = ((end + 1) & ~int64_t(1)) - lo;
            if (n > TL * NIN + 2) __trap();      // lanes not in CSR order
          }
          // element j of this line at span index off + j
          ln.off = on ? ln.off - ln.lo - lo : 0;
          bytes = static_cast<uint32_t>(8 * n);
        }
        // each lane's run, then its arrival (which releases the run)
        runs[s * TL + lane] = make_int4(
            static_cast<int>(ln.off & 0xffffffff),
            static_cast<int>(ln.off >> 32), ln.lo, ln.hi);
        if (lane == 0 && bytes) {
          mbar_arrive_tx(&full[s], bytes);
          if constexpr (Sph::gather)
            bulk_load(st, sph.x + lo, bytes, &full[s]);
          else
            load_tile(st, &full[s], m0);
        } else {
          mbar_arrive(&full[s]);
        }
      } else {
        mbar_wait(&empty[s], ph ^ 1u);
        if (lane == 0) {
          mbar_arrive_tx(&full[s], T::STAGE);
          load_tile(st, &full[s], m0);
        }
      }
      __syncwarp();
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warp / 4;
  const int w = warp % 4;
  const int g = lane / 4;
  const int q = lane % 4;
  const unsigned char* b1 = opsm;
  const unsigned char* b2 = opsm + 2 * OP_BYTES;
  float2* zw = reinterpret_cast<float2*>(smem + T::Z_OFFSET +
                                         warp * Z_BYTES);
  // this thread's twiddles: rows j1 = g + 8h, columns k2 = 4j + q
  float2 twr[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      twr[h][j] = tw[(g + 8 * h) * N2 + 4 * j + q];
  // complex element j of the tile's line t, in the stage's layout
  const bool small_l = A == A_COLS && L < 16;
  auto at = [&](int t, int j) -> int {
    if constexpr (A == A_ROWS) return t * NIN + j;
    const int b = t >> 4, u = t & 15;
    if (small_l)
      return b * 16 * NIN + ((u / L) * NIN + j) * L + u % L;
    return b * 16 * NIN + j * 16 + ((((u >> 1) ^ (j & 7))) << 1) + (u & 1);
  };

  int64_t it = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const int s = static_cast<int>(it % T::STAGES);
    const uint32_t ph = static_cast<uint32_t>(it / T::STAGES) & 1u;
    mbar_wait(&full[s], ph);
    const float2* xs = reinterpret_cast<const float2*>(stages + s * T::STAGE);
    const int64_t m0 = tile * TL;
#pragma unroll 1
    for (int blk = 0; blk < TL / (4 * CONS); ++blk) {
      const int t = wg * (TL / CONS) + 4 * blk + w;
      const int64_t line = m0 + t;
      // the line's run: a gathered line's elements lo <= j < hi at span
      // index off + j, a scattered line's outputs lo <= k < hi at y[off +
      // k − lo]
      Line run{0, 0, 0, 0};
      if constexpr (Sph::gather || Sph::scatter) {
        const int4 r4 = runs[s * TL + t];
        run = {static_cast<int64_t>(
                   (static_cast<uint64_t>(static_cast<uint32_t>(r4.y)) << 32) |
                   static_cast<uint32_t>(r4.x)),
               r4.z, r4.w, 1};
      }
      const int off = static_cast<int>(run.off);   // a gathered span index
      auto elem = [&](int j) -> float2 {
        if constexpr (Sph::gather) {
          float2 v = make_float2(0.0f, 0.0f);
          if (j >= run.lo && j < run.hi) v = xs[off + j];
          return v;
        } else {
          return xs[at(t, j)];
        }
      };
      // stage 1: rows j1 = g + 8h, K = j2
      uint32_t a1b[K1][4], a1s[K1][4];
#pragma unroll
      for (int kk = 0; kk < K1; ++kk) {
        const int j2 = 4 * kk + q;
        split_pair(elem(g + N1 * j2), elem(g + 8 + N1 * j2), a1b[kk],
                   a1s[kk]);
      }
      if (blk == TL / (4 * CONS) - 1) {
        // the tile's last reads are in registers: release its stage
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      float d1[16];
      stage_mma<K1>(d1, a1b, a1s, b1, b1 + OP_BYTES);
      // twiddle, then this warp's rows j1, columns k2
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float zr = d1[4 * j + 2 * h], zi = d1[4 * j + 2 * h + 1];
          const float2 wv = twr[h][j];
          zw[(g + 8 * h) * ZP + 4 * j + q] = make_float2(
              __fsub_rn(__fmul_rn(zr, wv.x), __fmul_rn(zi, wv.y)),
              __fadd_rn(__fmul_rn(zr, wv.y), __fmul_rn(zi, wv.x)));
        }
      __syncwarp();
      // stage 2: rows k2 = g + 8h, K = j1
      uint32_t a2b[K2][4], a2s[K2][4];
#pragma unroll
      for (int kk = 0; kk < K2; ++kk) {
        const int j1 = 4 * kk + q;
        split_pair(zw[j1 * ZP + g], zw[j1 * ZP + g + 8], a2b[kk], a2s[kk]);
      }
      __syncwarp();
      float d2[NC];
      stage_mma<K2>(d2, a2b, a2s, b2, b2 + OP_BYTES);
      // store: output k2 + 16·k1, k1 = 4j + q
      if (line < M) {
        if constexpr (Sph::scatter) {
          const unsigned span = static_cast<unsigned>(run.hi - run.lo);
          float2* yl = y + run.off;            // output k at yl[k - lo]
#pragma unroll
          for (int j = 0; j < NC / 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int k = g + 8 * h + N2 * (4 * j + q) - run.lo;
              if (static_cast<unsigned>(k) < span)
                yl[k] = make_float2(__fadd_rn(d2[4 * j + 2 * h], 0.0f),
                                    __fadd_rn(d2[4 * j + 2 * h + 1], 0.0f));
            }
        } else {
          // a gathered line that loaded nothing stores +0.0
          const bool on = !Sph::gather || run.hi > run.lo;
          float2* yl = y + line * NOUT;
#pragma unroll
          for (int j = 0; j < NC / 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              yl[g + 8 * h + N2 * (4 * j + q)] =
                  on ? make_float2(__fadd_rn(d2[4 * j + 2 * h], 0.0f),
                                   __fadd_rn(d2[4 * j + 2 * h + 1], 0.0f))
                     : make_float2(0.0f, 0.0f);
        }
      }
    }
  }
}

}  // namespace fct

// #1's factored line DFT (see fct::body): x's lines in rows or planes, y
// (M, 16·NC) rows
template <int A, int KC, int NC>
__global__ void __launch_bounds__(fct::THREADS, 1)
cgemm_tc_factored_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const float4* __restrict__ ops,
                         const float2* __restrict__ tw,
                         float2* __restrict__ y, int64_t M, int L,
                         int64_t tiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  fct::body<A, KC, NC>(smem_raw, &tm_x, ops, tw, y, fct::Rows{}, M, L,
                       tiles);
}

// The same for the sphere kernels, the policy's name in the kernel's
// (csrc/sphere_pack.cu: dftk::FactoredUnpack, dftk::FactoredPack)
template <int A, int KC, int NC, class Sph>
__global__ void __launch_bounds__(fct::THREADS, 1)
cgemm_tc_factored_sphere_kernel(const __grid_constant__ CUtensorMap tm_x,
                                const float4* __restrict__ ops,
                                const float2* __restrict__ tw,
                                float2* __restrict__ y, const Sph sph,
                                int64_t M, int L, int64_t tiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  fct::body<A, KC, NC>(smem_raw, &tm_x, ops, tw, y, sph, M, L, tiles);
}

// Launch the factored line DFT: x (see fct::body) 16-byte aligned; for
// A_COLS, L even with L % 16 == 0 or L < 16 dividing 16, and L | M; for
// A_GATHER (x the packed lanes), TL | M and every tile's lines in one
// row.  Returns the launch status (cudaGetLastError) as an int.
template <int A, int KC, int NC, class Sph = fct::Rows>
int launch_factored(const float* x, const float* ops, const float2* tw,
                    float2* y, int64_t M, int L, cudaStream_t stream,
                    const Sph& sph = Sph{}) {
  using T = fct::Tile<KC, Sph::PAD, Sph::META>;
  constexpr int NIN = fct::N2 * KC;
  if (M <= 0) return static_cast<int>(cudaSuccess);
  if (M > 0x7fffffffLL - fct::TL ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm{};
  if constexpr (A == A_ROWS) {
    // (complex chunks of CW, chunks, rows): whole rows, box inner <= 256
    constexpr int CW = NIN < 128 ? NIN : 128;
    const cuuint64_t dims[3] = {2 * CW, NIN / CW,
                                static_cast<cuuint64_t>(M)};
    const cuuint64_t strides[2] = {2 * CW * 4, NIN * 8};
    const cuuint32_t box[3] = {2 * CW, NIN / CW, fct::TL};
    if (!encode(&tm, 3, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE))
      return static_cast<int>(cudaErrorInvalidValue);
  } else if constexpr (A == A_COLS) {
    const bool wide = L >= 16 && L % 16 == 0;
    if (L < 2 || M % L || !(wide || 16 % L == 0))
      return static_cast<int>(cudaErrorInvalidValue);
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(2 * L), NIN,
                                static_cast<cuuint64_t>(M / L)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(2 * L) * 4,
                                   static_cast<cuuint64_t>(2 * L) * NIN * 4};
    // 16 lines a box: 128 bytes a row of z, swizzled; or 16/L planes
    const cuuint32_t box[3] = {wide ? 32u : static_cast<cuuint32_t>(2 * L),
                               NIN, wide ? 1u : static_cast<cuuint32_t>(16 / L)};
    if (!encode(&tm, 3, x, dims, strides, box,
                wide ? CU_TENSOR_MAP_SWIZZLE_128B
                     : CU_TENSOR_MAP_SWIZZLE_NONE))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (M % fct::TL) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = (M + fct::TL - 1) / fct::TL;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  if constexpr (std::is_same<Sph, fct::Rows>::value) {
    auto kernel = cgemm_tc_factored_kernel<A, KC, NC>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, fct::THREADS, T::SMEM, stream>>>(
        tm, reinterpret_cast<const float4*>(ops), tw, y, M, L, tiles);
  } else {
    auto kernel = cgemm_tc_factored_sphere_kernel<A, KC, NC, Sph>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, fct::THREADS, T::SMEM, stream>>>(
        tm, reinterpret_cast<const float4*>(ops), tw, y, sph, M, L, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// The factored kernel for lines of (n_in, n_out) = (16·KC, 16·NC): 256 and
// one of 64, 128, 256 (kernels/dft_matmul.py::factored_split); any other
// shape is refused.  Returns the launch status as an int.
template <int A, class Sph = fct::Rows>
int launch_factored_shape(const float* x, const float* ops,
                          const float2* tw, float2* y, int64_t M, int n_in,
                          int n_out, int L, cudaStream_t stream,
                          const Sph& sph = Sph{}) {
#define TC_FACTORED(KC, NC)                                                \
  if (n_in == 16 * KC && n_out == 16 * NC)                                 \
    return launch_factored<A, KC, NC, Sph>(x, ops, tw, y, M, L, stream, sph);
  TC_FACTORED(16, 16)
  TC_FACTORED(8, 16)
  TC_FACTORED(4, 16)
  TC_FACTORED(16, 8)
  TC_FACTORED(16, 4)
#undef TC_FACTORED
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc
