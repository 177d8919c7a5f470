// Fused sphere-pack kernels of the plane-wave hot path, on Hopper's tensor
// cores in split TF32 (fp32 accurate).
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
// What bounds them on an H100: bytes.  At the cells' shapes (n = 256, d =
// 128 or 64, the longer length 256) each runs the factored line DFT of
// csrc/cgemm_tc_factored.cuh, 6,144 complex products a 128↔256 line
// against the dense 32,768: a 128-band unpack_dft of the 128-sphere reads
// 1.13 GB of lanes and writes the 4.29 GB slab, 1.62 ms at 3.35 TB/s,
// against 0.62 ms of 3xTF32 products at 495 TFLOP/s (the dense method's
// 3.3 ms bound it by operations); dft_pack is the mirror (the slab's
// 4.29 GB in, of which the lines with lanes are 3.38 GB, the lanes out).
//
// What the design does about it: one launch a call, each line loaded once
// and stored once, with the sphere in the policy of the factored kernel
// (fct::body), which keeps both 16-point stages and the twiddle on the SM:
//   * unpack_dft (FactoredUnpack): the producer warp reads a 32-line
//     tile's line tables and brings the tile's lanes, one contiguous span
//     in CSR order, by one bulk copy; each line's elements outside
//     [zlo, zlo + cnt) are zeros, so lanes past a row's sphere are never
//     used.  The slab's rows are stored as the line kernel stores them.
//   * dft_pack (FactoredPack): the slab's lines come by TMA where the
//     plan's x stage left them, as rows (A_ROWS) or as planes stored
//     z-major (A_COLS: each y plane, or each row's whole slab), so the slab
//     is not copied first; each warp stores its line's d outputs straight
//     to the line's packed lanes b·npk + start − zlo + k for zlo <= k <
//     zlo + cnt, so the truncated (B, ex, ey, d) slab is never written; a
//     small second kernel stores +0.0f to the lanes past each row's valid
//     count.
//
// Every other shape (the longer length not 256, or either length outside
// {64, 128, 256}; odd n) runs the dense tensor-core GEMM of cgemm_tc.cuh
// with the same sphere logic (Unpack, Pack): unpack_dft gathers its lines
// in the consumer warpgroups (A_GATHER) and reads only the K chunks its
// 128-line tile's active lines cover; dft_pack reads the slab by TMA
// (A_ROWS, A_COLS; odd n A_GATHER) and scatters in its epilogue.
#include "cgemm_tc.cuh"
#include "cgemm_tc_factored.cuh"

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

// The factored kernel's policies (tc::fct::body): #3 gathers its lines'
// lanes (src), #4 scatters its lines' outputs (dst)
struct FactoredUnpack : Unpack {
  static constexpr bool gather = true;
  static constexpr bool scatter = false;
  static constexpr int PAD = tc::fct::GATHER_PAD;
  static constexpr int META = tc::fct::RUNS_META;
  const float2* x;    // the packed lanes
};

struct FactoredPack : Pack {
  static constexpr bool gather = false;
  static constexpr bool scatter = true;
  static constexpr int PAD = 0;
  static constexpr int META = tc::fct::RUNS_META;
};

// Pack's row order for a slab layout (see dft_pack_launch): layouts 1 and
// 2 give the rows in the same (b, y, x) order; only the lines of a TMA
// plane differ (ex, or a row's ex·ey)
template <class P>
P pack_policy(const int* start, const int* zlo, const int* cnt,
              long long npk, int ex, int ey, int layout) {
  P op;
  op.start = start;
  op.zlo = zlo;
  op.cnt = cnt;
  op.npk = static_cast<int64_t>(npk);
  op.nlines = ex * ey;
  const bool planes = layout == 1 || layout == 2;
  op.L = planes ? ex : ey;
  op.sp = planes ? 1 : ey;
  op.sl = planes ? ey : 1;
  return op;
}

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
  const dftk::Pack op = dftk::pack_policy<dftk::Pack>(start, zlo, cnt, npk,
                                                      ex, ey, layout);
  const int64_t M = static_cast<int64_t>(B) * ex * ey;
  const float* x = static_cast<const float*>(slab);
  const float* w = static_cast<const float*>(wsplit);
  float2* y = static_cast<float2*>(out);
  int err;
  if (layout == 1 || layout == 2)
    err = tc::launch<tc::A_COLS>(op, x, w, y, M, d, n,
                                 layout == 1 ? ex : ex * ey, s);
  else if (n % 2 == 0 && reinterpret_cast<uintptr_t>(slab) % 16 == 0)
    err = tc::launch<tc::A_ROWS>(op, x, w, y, M, d, n, 0, s);
  else
    err = tc::launch<tc::A_GATHER>(op, x, w, y, M, d, n, 0, s);
  if (err != 0) return err;
  return pack_zero_tail_launch(out, nvalid, B, npk, stream);
}

// unpack_dft in the factored mode, for lines of d -> n whose longer length
// is 256 and both in {64, 128, 256}: packed, the tables and y as for
// unpack_dft_launch (packed 16-byte aligned and whole 16 bytes long, a
// row's ex·ey lines a multiple of 32; the tables in CSR order, as
// line_tables builds them); ops, tw: the factored operands of the (n, d)
// operator
// (kernels/dft_matmul.py::factored_operands).  Returns cudaGetLastError().
extern "C" int unpack_factored_launch(const void* packed, const int* start,
                                      const int* zlo, const int* cnt,
                                      const int* flag, const void* ops,
                                      const void* tw, void* y, int B,
                                      long long npk, int ex, int ey, int n,
                                      int d, void* stream) {
  if ((ex * ey) % tc::fct::TL) return static_cast<int>(cudaErrorInvalidValue);
  dftk::FactoredUnpack op;
  op.start = start;
  op.zlo = zlo;
  op.cnt = cnt;
  op.flag = flag;
  op.chunk_range = nullptr;
  op.npk = static_cast<int64_t>(npk);
  op.nlines = ex * ey;
  op.ey = ey;
  op.x = static_cast<const float2*>(packed);
  return tc::launch_factored_shape<tc::A_GATHER>(
      static_cast<const float*>(packed), static_cast<const float*>(ops),
      static_cast<const float2*>(tw), static_cast<float2*>(y),
      static_cast<int64_t>(B) * ex * ey, d, n, 0,
      static_cast<cudaStream_t>(stream), op);
}

// dft_pack in the factored mode, for lines of n -> d as above: slab,
// tables, nvalid, out and layout as for dft_pack_launch (the slab 16-byte
// aligned; n = 256 is even); ops, tw: the factored operands of the (d, n)
// operator.  Returns cudaGetLastError().
extern "C" int pack_factored_launch(const void* slab, const int* start,
                                    const int* zlo, const int* cnt,
                                    const int* nvalid, const void* ops,
                                    const void* tw, void* out, int B,
                                    long long npk, int ex, int ey, int n,
                                    int d, int layout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dftk::FactoredPack op = dftk::pack_policy<dftk::FactoredPack>(
      start, zlo, cnt, npk, ex, ey, layout);
  const int64_t M = static_cast<int64_t>(B) * ex * ey;
  const float* x = static_cast<const float*>(slab);
  const float* o = static_cast<const float*>(ops);
  const float2* t = static_cast<const float2*>(tw);
  float2* y = static_cast<float2*>(out);
  const int err =
      layout == 1 || layout == 2
          ? tc::launch_factored_shape<tc::A_COLS>(
                x, o, t, y, M, n, d, layout == 1 ? ex : ex * ey, s, op)
          : tc::launch_factored_shape<tc::A_ROWS>(x, o, t, y, M, n, d, 0, s,
                                                  op);
  if (err != 0) return err;
  return pack_zero_tail_launch(out, nvalid, B, npk, stream);
}
