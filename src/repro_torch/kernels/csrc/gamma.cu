// Γ-point fold and unfold: two real bands through one complex plane-wave
// transform, on half the G-sphere.
//
// At k = 0 a band is real in r-space, so c(−G) = conj c(G) and only the
// half sphere (lexicographic G >= 0) is stored.  Two real bands a, b go
// through one complex transform as ψ_a + iψ_b, whose spectrum on the full
// sphere is F(G) = c_a(G) + i c_b(G), F(−G) = conj c_a(G) + i conj c_b(G).
//
// gamma_fold (the inverse's side): real-band half-sphere rows (nb, nhalf)
// to complex full-sphere rows (rows, npk), rows = ceil(nb / 2), band 2k
// and 2k + 1 into row k (an odd last band paired with a zero band).
//
// gamma_unfold (the forward's side): complex full-sphere rows back to the
// real bands, c_a(G) = (F(G) + conj F(−G)) / 2 and
// c_b(G) = (F(G) − conj F(−G)) / (2i).
//
// Both run over the half's lanes with two tables of npk-lane indices,
// lane[h] (the full-sphere lane of G) and mirror[h] (that of −G; equal to
// lane[h] at G = 0), so every half-sphere element is read or written once
// and every full-sphere element written or read once: bound by bytes.  In
// CSR order the half is one run of lanes and its mirror the same run
// reversed, so a warp's loads and stores are contiguous (the mirror's
// descending).  A thread keeps its lane's two indices in registers for
// ROWS rows.
#include <cstdint>

#include <cuda_runtime.h>

namespace gmk {

constexpr int THREADS = 256;
constexpr int ROWS = 4;

__global__ void __launch_bounds__(THREADS)
gamma_fold_kernel(const float2* __restrict__ half,
                  const int* __restrict__ lane, const int* __restrict__ mirror,
                  float2* __restrict__ full, int rows, int nb, int64_t nhalf,
                  int64_t npk) {
  const int64_t h = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (h >= nhalf) return;
  const int p = lane[h];
  const int q = mirror[h];
  const int k0 = blockIdx.y * ROWS;
  const int k1 = k0 + ROWS < rows ? k0 + ROWS : rows;
#pragma unroll
  for (int k = k0; k < k1; ++k) {
    const float2 a = half[(2 * static_cast<int64_t>(k)) * nhalf + h];
    const float2 b = 2 * k + 1 < nb
                         ? half[(2 * static_cast<int64_t>(k) + 1) * nhalf + h]
                         : make_float2(0.f, 0.f);
    float2* row = full + static_cast<int64_t>(k) * npk;
    // a + i·b at G, conj(a) + i·conj(b) at −G
    row[p] = make_float2(a.x - b.y, a.y + b.x);
    if (q != p) row[q] = make_float2(a.x + b.y, b.x - a.y);
  }
}

__global__ void __launch_bounds__(THREADS)
gamma_unfold_kernel(const float2* __restrict__ full,
                    const int* __restrict__ lane,
                    const int* __restrict__ mirror, float2* __restrict__ half,
                    int rows, int nb, int64_t nhalf, int64_t npk) {
  const int64_t h = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (h >= nhalf) return;
  const int p = lane[h];
  const int q = mirror[h];
  const int k0 = blockIdx.y * ROWS;
  const int k1 = k0 + ROWS < rows ? k0 + ROWS : rows;
#pragma unroll
  for (int k = k0; k < k1; ++k) {
    const float2* row = full + static_cast<int64_t>(k) * npk;
    const float2 f = row[p];  // F(G)
    const float2 g = row[q];  // F(−G)
    // (f + conj g) / 2 and (f − conj g) / (2i)
    half[(2 * static_cast<int64_t>(k)) * nhalf + h] =
        make_float2((f.x + g.x) * 0.5f, (f.y - g.y) * 0.5f);
    if (2 * k + 1 < nb)
      half[(2 * static_cast<int64_t>(k) + 1) * nhalf + h] =
          make_float2((f.y + g.y) * 0.5f, (g.x - f.x) * 0.5f);
  }
}

inline dim3 grid_of(int rows, int64_t nhalf) {
  return dim3(static_cast<unsigned>((nhalf + THREADS - 1) / THREADS),
              static_cast<unsigned>((rows + ROWS - 1) / ROWS));
}

}  // namespace gmk

// half: (nb, nhalf) complex64 rows; lane, mirror: (nhalf,) int32 lanes of
// G and −G in [0, npk); full: (rows, npk) complex64, rows = ceil(nb / 2),
// every lane written.  Returns cudaGetLastError().
extern "C" int gamma_fold_launch(const void* half, const int* lane,
                                 const int* mirror, void* full, int rows,
                                 int nb, long long nhalf, long long npk,
                                 void* stream) {
  if (rows <= 0 || nhalf <= 0) return 0;
  gmk::gamma_fold_kernel<<<gmk::grid_of(rows, nhalf), gmk::THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(half), lane, mirror,
      static_cast<float2*>(full), rows, nb, nhalf, npk);
  return static_cast<int>(cudaGetLastError());
}

// full: (rows, npk) complex64 rows; lane, mirror as for gamma_fold_launch;
// half: (nb, nhalf) complex64, nb <= 2·rows, every element written.
// Returns cudaGetLastError().
extern "C" int gamma_unfold_launch(const void* full, const int* lane,
                                   const int* mirror, void* half, int rows,
                                   int nb, long long nhalf, long long npk,
                                   void* stream) {
  if (rows <= 0 || nhalf <= 0) return 0;
  gmk::gamma_unfold_kernel<<<gmk::grid_of(rows, nhalf), gmk::THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(full), lane, mirror,
      static_cast<float2*>(half), rows, nb, nhalf, npk);
  return static_cast<int>(cudaGetLastError());
}
