// Fused sphere-pack kernels of the plane-wave hot path.
//
// unpack_dft replaces the TPU kernel `_unpack_dft_kernel` of
// src/repro/kernels/sphere_pack.py: CSR gather of each bounding-box
// z-line (lane start + (z − zlo) for zlo <= z < zlo + cnt) plus the d→n
// inverse line DFT, writing the (B, ex, ey, n) first-stage slab without
// materializing the zero-padded d³ cube.  Planes with flag[x] = 0, and
// lines with cnt = 0, store a literal +0.0f and are not computed.
//
// dft_pack replaces `_dft_pack_kernel` of the same file: the truncating
// n→d line DFT of the last stage plus the CSR gather back to the
// (B, npacked) packed lanes; lanes past a row's valid count are +0.0f.
//
// What bounds them on an H100: operations.  Each line costs 8·n·d FLOP
// against 8·(cnt + n) bytes — ~50 FLOP per byte at n = 256, d = 128,
// above fp32 FMA's ~20 FLOP/byte balance point.
//
// What the design does about it.  The TPU kernels hold whole operands in
// VMEM: unpack_dft loads all of pr/pi (B, npacked) into every program —
// 281 MB per block at the stacked SCF's size — and dft_pack is one
// program over the whole slab (grid=(1,)).  Neither fits 227 KB of
// shared memory.  Here both are the tiled complex GEMM of cgemm.cuh over
// a real grid of (64-line tile) x (64-column tile) blocks, rows being the
// (b, x, y) bounding-box lines:
//   * unpack_dft: a block reads its 64 lines' table entries and gathers
//     only those lines' packed lanes, chunk by chunk, into shared memory;
//     lanes past a row's npacked are never addressed.  A block whose
//     lines are all empty (flag 0 or cnt 0) skips the GEMM and stores
//     zeros.
//   * dft_pack: a block computes its lines' d outputs and scatters them
//     straight to their packed lanes (start + z − zlo), so the (B, ex, ey,
//     d) truncated slab is never written; empty lines are skipped, and a
//     second, elementwise kernel stores +0.0f to the padded tail lanes.
#include "cgemm.cuh"

namespace dftk {

struct UnpackRows {
  const int* start;
  const int* zlo;
  const int* cnt;
  const int* flag;
  int64_t npk;
  int nlines, ey, n;
  __device__ cgemm::Row row(int64_t r, int64_t M) const {
    cgemm::Row out;
    out.in = 0;
    out.in_lo = out.in_hi = 0;
    out.out = r * n;
    out.out_lo = 0;
    out.out_hi = 0;
    out.active = 0;
    if (r >= M) return out;
    const int64_t b = r / nlines;
    const int l = static_cast<int>(r % nlines);
    const int64_t t = b * nlines + l;
    const int c = cnt[t];
    const int lo = zlo[t];
    out.out_hi = n;
    out.active = (flag[l / ey] != 0 && c > 0) ? 1 : 0;
    out.in = b * npk + start[t] - lo;
    out.in_lo = lo;
    out.in_hi = lo + c;
    return out;
  }
  __device__ float2 epilogue(int64_t, int, float2 v) const { return v; }
};

struct PackRows {
  const int* start;
  const int* zlo;
  const int* cnt;
  int64_t npk;
  int nlines, n;
  __device__ cgemm::Row row(int64_t r, int64_t M) const {
    cgemm::Row out;
    out.in = r * n;
    out.in_lo = 0;
    out.in_hi = n;
    out.out = 0;
    out.out_lo = out.out_hi = 0;
    out.active = 0;
    if (r >= M) return out;
    const int64_t b = r / nlines;
    const int64_t t = r;  // row index == table index (b·nlines + line)
    const int c = cnt[t];
    const int lo = zlo[t];
    out.out = b * npk + start[t] - lo;
    out.out_lo = lo;
    out.out_hi = lo + c;
    out.active = c > 0 ? 1 : 0;
    return out;
  }
  __device__ float2 epilogue(int64_t, int, float2 v) const { return v; }
};

__global__ void zero_tail_kernel(float2* __restrict__ out,
                                 const int* __restrict__ nvalid, int B,
                                 int64_t npk) {
  const int64_t total = static_cast<int64_t>(B) * npk;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t b = i / npk;
    if (i - b * npk >= nvalid[b]) out[i] = make_float2(0.0f, 0.0f);
  }
}

}  // namespace dftk

// packed: (B, npk) complex64; start/zlo/cnt: (B, ex·ey) int32; flag: (ex,)
// int32; w: (n, d) complex64; y: (B, ex, ey, n) complex64.
extern "C" int unpack_dft_launch(const void* packed, const int* start,
                                 const int* zlo, const int* cnt,
                                 const int* flag, const void* w, void* y,
                                 int B, long long npk, int ex, int ey, int n,
                                 int d, void* stream) {
  dftk::UnpackRows op{start, zlo, cnt, flag, static_cast<int64_t>(npk),
                      ex * ey, ey, n};
  const int64_t M = static_cast<int64_t>(B) * ex * ey;
  return cgemm::launch(op, static_cast<const float2*>(packed),
                       static_cast<const float2*>(w),
                       static_cast<float2*>(y), M, n, d,
                       static_cast<cudaStream_t>(stream));
}

// slab: (B, ex, ey, n) complex64; start/zlo/cnt: (B, ex·ey) int32;
// nvalid: (B,) int32 valid lanes per row; w: (d, n) complex64;
// out: (B, npk) complex64.
extern "C" int dft_pack_launch(const void* slab, const int* start,
                               const int* zlo, const int* cnt,
                               const int* nvalid, const void* w, void* out,
                               int B, long long npk, int ex, int ey, int n,
                               int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dftk::PackRows op{start, zlo, cnt, static_cast<int64_t>(npk), ex * ey, n};
  const int64_t M = static_cast<int64_t>(B) * ex * ey;
  int err = cgemm::launch(op, static_cast<const float2*>(slab),
                          static_cast<const float2*>(w),
                          static_cast<float2*>(out), M, d, n, s);
  if (err != 0) return err;
  const int64_t total = static_cast<int64_t>(B) * npk;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  dftk::zero_tail_kernel<<<blocks, threads, 0, s>>>(
      static_cast<float2*>(out), nvalid, B, static_cast<int64_t>(npk));
  return static_cast<int>(cudaGetLastError());
}
