// K5/K6: binned-P(k) reductions with a floating squared-space digitize.
//
// Replaces fastbox_tpu/ops/pallas/binned_pk.py::binned_pk_half_dual_pallas
// (_half_dual_kernel, K5) and ::binned_pk_pallas (_kernel, K6).  K5 is the
// pipeline's P(k) reduction on boxes that are not cubes (and wherever
// pallas_pk='on'): for every mode (i, j, l) of an (Nx, Ny, H) half spectrum
// it forms k2 = kx2[i] + (ky2[j] + kz2[l]) in the input dtype, in the
// Pallas body's association order, classifies it as bin b = #{edges2 <= k2}
// (an upper-bound binary search on the ascending edges gives the same
// count), and accumulates, for b < nbins, sum w p1, sum w p1^2, sum w p2
// and sum w with w = wz[l].  K6 is the same body for one field on the full
// cube with unit weights: sum p, sum p^2 and the count.
//
// Bound on the card: memory (8 bytes read per f32 mode, 68 MB at 256^3),
// as long as the binning does not serialise.  Design, as K4's
// (binned_pk_v2.cu): every thread owns a private float64 slot per (bin,
// statistic) in shared memory, padded rows so threads hit distinct banks;
// products are formed in float64 with explicit rounding, each block walks a
// fixed contiguous slice of the modes, the block sums its threads' slots in
// a fixed order, and sum_partials_kernel sums the blocks in a fixed tree.
// The result is bitwise the same on every run.  With 4 statistics the slots
// take 4 * nbins * (threads + 1) doubles: 82 KB for the pipeline's 20 bins
// at 128 threads, and the wrapper shrinks the block (down to one warp,
// 127 KB) for up to 120 bins, so the per-thread design fits at every bin
// count the Pallas kernel takes and no shared histogram is needed.
#include "common.cuh"

namespace {

template <typename T, bool kDual>
__global__ void binned_pk_partial_kernel(const T* __restrict__ p1, const T* __restrict__ p2,
                                         const T* __restrict__ kx2, const T* __restrict__ ky2,
                                         const T* __restrict__ kz2, const T* __restrict__ wz,
                                         const T* __restrict__ edges2, double* __restrict__ partial,
                                         uint32_t Ny, uint32_t H, uint32_t n, int nbins) {
  constexpr int kStats = kDual ? 4 : 3;  // (s1, q1, s2, count) or (s, q, count)
  extern __shared__ double acc[];        // [kStats * nbins][blockDim.x + 1]
  const int stride = blockDim.x + 1;
  T* edges_sh = reinterpret_cast<T*>(acc + kStats * nbins * stride);
  for (int k = threadIdx.x; k < kStats * nbins * stride; k += blockDim.x) acc[k] = 0.0;
  for (int k = threadIdx.x; k < nbins; k += blockDim.x) edges_sh[k] = edges2[k];
  __syncthreads();

  const uint32_t chunk = (n + gridDim.x - 1) / gridDim.x;
  const uint32_t begin = blockIdx.x * chunk;
  const uint32_t end = begin + chunk < n ? begin + chunk : n;
  for (uint32_t e = begin + threadIdx.x; e < end; e += blockDim.x) {
    const uint32_t l = e % H;
    const uint32_t r = e / H;
    const T k2 = fbx::add_rn(kx2[r / Ny], fbx::add_rn(ky2[r % Ny], kz2[l]));
    int lo = 0, hi = nbins;  // bin = number of edges <= k2
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (edges_sh[mid] <= k2) lo = mid + 1; else hi = mid;
    }
    if (lo < nbins) {
      const double w = kDual ? static_cast<double>(wz[l]) : 1.0;
      const double a = static_cast<double>(p1[e]);
      double* slot = acc + (kStats * lo) * stride + threadIdx.x;
      const double wa = fbx::mul_rn(w, a);
      slot[0] += wa;
      slot[stride] += fbx::mul_rn(wa, a);
      if (kDual) slot[2 * stride] += fbx::mul_rn(w, static_cast<double>(p2[e]));
      slot[(kStats - 1) * stride] += w;
    }
  }
  __syncthreads();

  // partial[block][stat][bin], each the in-order sum of the block's threads
  for (int k = threadIdx.x; k < kStats * nbins; k += blockDim.x) {
    const int stat = k / nbins, bin = k % nbins;
    const double* row = acc + (kStats * bin + stat) * stride;
    double s = 0.0;
    for (int t = 0; t < static_cast<int>(blockDim.x); ++t) s += row[t];
    partial[(static_cast<int64_t>(blockIdx.x) * kStats + stat) * nbins + bin] = s;
  }
}

template <typename T, bool kDual>
cudaError_t launch(const T* p1, const T* p2, const T* kx2, const T* ky2, const T* kz2, const T* wz,
                   const T* edges2, double* partial, double* out, int64_t Nx, int64_t Ny,
                   int64_t H, int nbins, int nblocks, int threads, cudaStream_t stream) {
  constexpr int kStats = kDual ? 4 : 3;
  const size_t smem = kStats * static_cast<size_t>(nbins) * (threads + 1) * sizeof(double) +
                      static_cast<size_t>(nbins) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(binned_pk_partial_kernel<T, kDual>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  binned_pk_partial_kernel<T, kDual><<<nblocks, threads, smem, stream>>>(
      p1, p2, kx2, ky2, kz2, wz, edges2, partial, static_cast<uint32_t>(Ny),
      static_cast<uint32_t>(H), static_cast<uint32_t>(Nx * Ny * H), nbins);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fbx::sum_partials_kernel<256><<<kStats * nbins, 256, 0, stream>>>(partial, out, nblocks,
                                                                  kStats * nbins);
  return cudaGetLastError();
}

}  // namespace

// K5.  p1, p2: (Nx, Ny, H) contiguous; kx2 (Nx,), ky2 (Ny,), kz2h (H,):
// squared wavenumbers, physical or integer-valued, in the fields' dtype;
// wz: (H,) kz multiplicities; edges2: (nbins,) ascending squared edges;
// partial: (nblocks, 4, nbins) float64 scratch; out: (4, nbins) float64 =
// (sum w p1, sum w p1^2, sum w p2, sum w).  Requires Nx*Ny*H < 2^32 and a
// blockDim `threads` that is a multiple of 32.
extern "C" int fbx_binned_pk_half_dual_f32(const float* p1, const float* p2, const float* kx2,
                                           const float* ky2, const float* kz2h, const float* wz,
                                           const float* edges2, double* partial, double* out,
                                           int64_t Nx, int64_t Ny, int64_t H, int nbins,
                                           int nblocks, int threads, void* stream) {
  return launch<float, true>(p1, p2, kx2, ky2, kz2h, wz, edges2, partial, out, Nx, Ny, H, nbins,
                             nblocks, threads, static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_binned_pk_half_dual_f64(const double* p1, const double* p2, const double* kx2,
                                           const double* ky2, const double* kz2h, const double* wz,
                                           const double* edges2, double* partial, double* out,
                                           int64_t Nx, int64_t Ny, int64_t H, int nbins,
                                           int nblocks, int threads, void* stream) {
  return launch<double, true>(p1, p2, kx2, ky2, kz2h, wz, edges2, partial, out, Nx, Ny, H, nbins,
                              nblocks, threads, static_cast<cudaStream_t>(stream));
}

// K6.  pk: (Nx, Ny, Nz) contiguous; kx2 (Nx,), ky2 (Ny,), kz2 (Nz,);
// edges2 as above; partial: (nblocks, 3, nbins); out: (3, nbins) float64 =
// (sum p, sum p^2, count).
extern "C" int fbx_binned_pk_full_f32(const float* pk, const float* kx2, const float* ky2,
                                      const float* kz2, const float* edges2, double* partial,
                                      double* out, int64_t Nx, int64_t Ny, int64_t Nz, int nbins,
                                      int nblocks, int threads, void* stream) {
  return launch<float, false>(pk, nullptr, kx2, ky2, kz2, nullptr, edges2, partial, out, Nx, Ny,
                              Nz, nbins, nblocks, threads, static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_binned_pk_full_f64(const double* pk, const double* kx2, const double* ky2,
                                      const double* kz2, const double* edges2, double* partial,
                                      double* out, int64_t Nx, int64_t Ny, int64_t Nz, int nbins,
                                      int nblocks, int threads, void* stream) {
  return launch<double, false>(pk, nullptr, kx2, ky2, kz2, nullptr, edges2, partial, out, Nx, Ny,
                               Nz, nbins, nblocks, threads, static_cast<cudaStream_t>(stream));
}
