// Fused sphere-pack kernels of the plane-wave hot path, on Hopper's tensor
// cores (csrc/cgemm_tc.cuh: split-TF32 wgmma, fp32 accurate).
//
// unpack_dft replaces the TPU kernel `_unpack_dft_kernel` of
// src/repro/kernels/sphere_pack.py: CSR gather of each bounding-box
// z-line (lane start + (z − zlo) for zlo <= z < zlo + cnt) plus the d→n
// inverse line DFT, writing the (B, ex, ey, n) first-stage slab without
// materializing the zero-padded d³ cube.  Planes with flag[x] = 0, and
// lines with cnt = 0, store a literal +0.0f.
//
// dft_pack replaces `_dft_pack_kernel` of the same file: the truncating
// n→d line DFT of the last stage plus the CSR gather back to the
// (B, npacked) packed lanes; lanes past a row's valid count are +0.0f.
//
// What bounds them on an H100: operations, barely.  A line's useful work
// is 8·n·cnt FLOP against 8·(cnt + n) bytes; at the stacked SCF's n = 256,
// d = 128 (67 lanes a line on average) that is ~53 FLOP per byte, just
// above the 49 at which three TF32 products (fp32 accuracy) at 495
// TFLOP/s take as long as the bytes at 3.35 TB/s (0.436 against ~0.41 ms
// for unpack_dft).  As a GEMM over the whole bounding box a line costs
// 8·n·d, twice that: the operations bound it clearly.
//
// What the design does about it.  Both are the tensor-core GEMM of
// cgemm_tc.cuh over the (b, x, y) lines, with the sphere in the policy:
//   * unpack_dft: the x^ tile is gathered (A_GATHER): the consumer
//     warpgroups load each line's packed lanes, one complex a thread, a
//     chunk ahead, and zero the columns outside [zlo, zlo + cnt) without
//     forming their addresses, so lanes past a row's sphere are never
//     read.  A plane's z support spans only its cross-section (π/4 of d
//     on average), so each 128-line tile reads only the K chunks that the
//     union of its active lines covers (a (tiles, 2) table built with the
//     line tables); a tile with no active line issues no load and no
//     wgmma.  Inactive lines store +0.0f.  The gather is what bounds this
//     design: a first version with the copies in the one producer warp
//     (cp.async) took 4.8 ms at the SCF's shapes on an H100, and the
//     consumers' gather still costs ~1.5x the TMA path on dense rows.
//   * dft_pack: the slab's lines come by TMA, either as contiguous rows
//     (A_ROWS; odd n takes A_GATHER) or where the plan's x stage left
//     them, each y plane or each row's whole slab z-major (A_COLS,
//     transposed in shared memory, so the 1 GB slab is not copied first;
//     the rows then run in the slab's memory order and the policy maps
//     each to its table line).
//     The epilogue stores each line's d outputs straight to its packed
//     lanes b·npk + start − zlo + c for zlo <= c < zlo + cnt, so the
//     truncated (B, ex, ey, d) slab is never written; a small second
//     kernel stores +0.0f to the lanes past each row's valid count.
#include "cgemm_tc.cuh"

namespace dftk {

struct Unpack : tc::Dense {
  static constexpr bool dense_store = false;
  const int* start;
  const int* zlo;
  const int* cnt;
  const int* flag;
  const int2* chunk_range;   // (tiles, 2): the K chunks each tile reads
  int64_t npk;
  int nlines, ey;
  __device__ bool on(int64_t r) const {
    return flag[static_cast<int>(r % nlines) / ey] != 0 && cnt[r] > 0;
  }
  __device__ int2 chunks(int64_t tm, int nk) const {
    const int2 c = chunk_range[tm];
    return make_int2(c.x > 0 ? c.x : 0, c.y < nk ? c.y : nk);
  }
  // table row r is line r: the tables are (B, nlines) row-major
  __device__ tc::Line src(int64_t r, int) const {
    const int lo = zlo[r];
    const int hi = on(r) ? lo + cnt[r] : lo;
    return {(r / nlines) * npk + start[r], lo, hi, 1};
  }
  __device__ tc::Line dst(int64_t r, int N) const {
    return {r * N, 0, N, on(r) ? 1 : 0};
  }
};

// Rows run over the lines in the slab's memory order: row r is
// (b, p, l), l < L fastest, and its table line is p·sp + l·sl
// (contiguous lines: p = x, l = y; y planes or a z-major slab: p = y,
// l = x)
struct Pack : tc::Dense {
  static constexpr bool dense_store = false;
  const int* start;
  const int* zlo;
  const int* cnt;
  int64_t npk;
  int nlines, L, sp, sl;
  __device__ tc::Line dst(int64_t r, int) const {
    const int64_t b = r / nlines;
    const int q = static_cast<int>(r - b * nlines);
    const int64_t t = b * nlines + (q / L) * sp + (q % L) * sl;
    const int lo = zlo[t];
    return {b * npk + start[t], lo, lo + cnt[t], 1};
  }
};

// +0.0f to lanes [nvalid[b], npk) of each row b (blockIdx.y)
__global__ void zero_tail_kernel(float2* __restrict__ out,
                                 const int* __restrict__ nvalid,
                                 int64_t npk) {
  const int64_t b = blockIdx.y;
  const int64_t v = nvalid[b];
  for (int64_t i = (v > 0 ? v : 0) + blockIdx.x * blockDim.x + threadIdx.x;
       i < npk; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    out[b * npk + i] = make_float2(0.0f, 0.0f);
}

}  // namespace dftk

// packed: (B, npk) complex64; start/zlo/cnt: (B, ex·ey) int32; flag: (ex,)
// int32; chunk_range: (ceil(B·ex·ey / 128), 2) int32, the K chunks of 16
// complex columns [first, last) each 128-line tile reads; wsplit: the
// split embedding of the (n, d) DFT matrix w (tc::launch); y: (B, ex, ey,
// n) complex64.  Returns cudaGetLastError().
extern "C" int unpack_dft_launch(const void* packed, const int* start,
                                 const int* zlo, const int* cnt,
                                 const int* flag, const int* chunk_range,
                                 const void* wsplit, void* y, int B,
                                 long long npk, int ex, int ey, int n, int d,
                                 void* stream) {
  dftk::Unpack op;
  op.start = start;
  op.zlo = zlo;
  op.cnt = cnt;
  op.flag = flag;
  op.chunk_range = reinterpret_cast<const int2*>(chunk_range);
  op.npk = static_cast<int64_t>(npk);
  op.nlines = ex * ey;
  op.ey = ey;
  const int64_t M = static_cast<int64_t>(B) * ex * ey;
  return tc::launch<tc::A_GATHER>(
      op, static_cast<const float*>(packed),
      static_cast<const float*>(wsplit), static_cast<float2*>(y), M, n, d, 0,
      static_cast<cudaStream_t>(stream));
}

// out: (B, npk) complex64; nvalid: (B,) int32.  Stores +0.0f to each row's
// lanes past nvalid.  Returns cudaGetLastError().
extern "C" int pack_zero_tail_launch(void* out, const int* nvalid, int B,
                                     long long npk, void* stream) {
  if (B <= 0 || npk <= 0) return static_cast<int>(cudaSuccess);
  dftk::zero_tail_kernel<<<dim3(8, B), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(out), nvalid, static_cast<int64_t>(npk));
  return static_cast<int>(cudaGetLastError());
}

// slab: (B, ex, ey, n) complex64, its lines contiguous (layout 0), each
// y plane stored z-major, (B, ey, n, ex) in memory (layout 1, which needs
// tc::cols_fit(ex)), or each row's whole slab z-major, (B, n, ey, ex) in
// memory (layout 2, which needs tc::cols_fit(ex·ey)); start/zlo/cnt: (B, ex·ey) int32; nvalid: (B,) int32
// valid lanes per row; wsplit: the split embedding of the (d, n) DFT
// matrix; out: (B, npk) complex64.  Returns cudaGetLastError().
extern "C" int dft_pack_launch(const void* slab, const int* start,
                               const int* zlo, const int* cnt,
                               const int* nvalid, const void* wsplit,
                               void* out, int B, long long npk, int ex,
                               int ey, int n, int d, int layout,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dftk::Pack op;
  op.start = start;
  op.zlo = zlo;
  op.cnt = cnt;
  op.npk = static_cast<int64_t>(npk);
  op.nlines = ex * ey;
  // layouts 1 and 2 give the rows in the same (b, y, x) order; only the
  // lines of a TMA plane differ (ex, or a row's ex·ey)
  const bool planes = layout == 1 || layout == 2;
  op.L = planes ? ex : ey;
  op.sp = planes ? 1 : ey;
  op.sl = planes ? ey : 1;
  const int64_t M = static_cast<int64_t>(B) * ex * ey;
  const float* x = static_cast<const float*>(slab);
  const float* w = static_cast<const float*>(wsplit);
  float2* y = static_cast<float2*>(out);
  int err;
  if (planes)
    err = tc::launch<tc::A_COLS>(op, x, w, y, M, d, n,
                                 layout == 1 ? ex : ex * ey, s);
  else if (n % 2 == 0 && reinterpret_cast<uintptr_t>(slab) % 16 == 0)
    err = tc::launch<tc::A_ROWS>(op, x, w, y, M, d, n, 0, s);
  else
    err = tc::launch<tc::A_GATHER>(op, x, w, y, M, d, n, 0, s);
  if (err != 0) return err;
  return pack_zero_tail_launch(out, nvalid, B, npk, stream);
}
