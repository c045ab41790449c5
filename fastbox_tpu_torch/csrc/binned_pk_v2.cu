// K4: dual binned-P(k) reduction over two half-spectrum power cubes with
// hoisted counts.
//
// Replaces fastbox_tpu/ops/pallas/binned_pk_v2.py::binned_pk_half_dual_pallas_v2
// (_kernel_v2, non-telescoped).  For every mode (i, j, l) of the (Nx, Ny, H)
// half spectrum it classifies the exact integer m = kx2[i] + ky2[j] +
// kz2h[l] into bin b = #{thr <= m} (squared-space digitize with the
// integer thresholds of ops/spectra.kbin_thresholds) and accumulates, for
// b < nbins, sum w p1, sum w p1^2 and sum w p2 with the kz multiplicity
// weight w = wz[l].  The weighted counts are geometry and stay on the host.
//
// Bound on the card: memory (8 bytes read per f32 mode, 68 MB at 256^3),
// as long as the binning does not serialise.  Float atomics into ~20 bins
// would serialise and, in f32, miss the accuracy bar the TPU kernel set
// (3.9e-7 max relative error at 256^3, binned_pk.py:203-205); they would also
// change the result from run to run.  Design: every thread owns a private
// float64 accumulator per (bin, statistic) in shared memory (padded rows,
// so threads hit distinct banks), products are formed in float64 (exact
// for f32 inputs), and each block walks a fixed contiguous slice of the
// modes.  The block then sums its threads' slots in a fixed order into a
// per-block partial, and a second kernel sums the partials in a fixed
// tree.  The result is bitwise the same on every run.
#include "common.cuh"

namespace {

template <typename T>
__global__ void binned_pk_v2_partial_kernel(const T* __restrict__ p1, const T* __restrict__ p2,
                                            const int32_t* __restrict__ kx2,
                                            const int32_t* __restrict__ ky2,
                                            const int32_t* __restrict__ kz2h,
                                            const T* __restrict__ wz,
                                            const int32_t* __restrict__ thr,
                                            double* __restrict__ partial, uint32_t Ny, uint32_t H,
                                            uint32_t n, int nbins) {
  extern __shared__ double acc[];  // [3 * nbins][blockDim.x + 1]
  const int stride = blockDim.x + 1;
  int32_t* thr_sh = reinterpret_cast<int32_t*>(acc + 3 * nbins * stride);
  for (int k = threadIdx.x; k < 3 * nbins * stride; k += blockDim.x) acc[k] = 0.0;
  for (int k = threadIdx.x; k < nbins; k += blockDim.x) thr_sh[k] = thr[k];
  __syncthreads();

  const uint32_t chunk = (n + gridDim.x - 1) / gridDim.x;
  const uint32_t begin = blockIdx.x * chunk;
  const uint32_t end = begin + chunk < n ? begin + chunk : n;
  for (uint32_t e = begin + threadIdx.x; e < end; e += blockDim.x) {
    const uint32_t l = e % H;
    const uint32_t r = e / H;
    const int32_t m = kx2[r / Ny] + ky2[r % Ny] + kz2h[l];
    int lo = 0, hi = nbins;  // bin = number of thresholds <= m
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (thr_sh[mid] <= m) lo = mid + 1; else hi = mid;
    }
    if (lo < nbins) {
      const double w = static_cast<double>(wz[l]);
      const double a = static_cast<double>(p1[e]);
      const double b = static_cast<double>(p2[e]);
      double* slot = acc + (3 * lo) * stride + threadIdx.x;
      const double wa = w * a;
      slot[0] += wa;
      slot[stride] += wa * a;
      slot[2 * stride] += w * b;
    }
  }
  __syncthreads();

  // partial[block][stat][bin], each the in-order sum of the block's threads
  for (int k = threadIdx.x; k < 3 * nbins; k += blockDim.x) {
    const int stat = k / nbins, bin = k % nbins;
    const double* row = acc + (3 * bin + stat) * stride;
    double s = 0.0;
    for (int t = 0; t < static_cast<int>(blockDim.x); ++t) s += row[t];
    partial[(static_cast<int64_t>(blockIdx.x) * 3 + stat) * nbins + bin] = s;
  }
}

// out[k] = sum over blocks of partial[block][k], k = stat * nbins + bin; one
// block of 256 threads per k: strided sums, then a fixed shared-memory tree.
__global__ void binned_pk_v2_final_kernel(const double* __restrict__ partial,
                                          double* __restrict__ out, int nblocks, int nk) {
  __shared__ double sh[256];
  const int k = blockIdx.x;
  double s = 0.0;
  for (int g = threadIdx.x; g < nblocks; g += blockDim.x) s += partial[static_cast<int64_t>(g) * nk + k];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) sh[threadIdx.x] += sh[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[k] = sh[0];
}

template <typename T>
cudaError_t launch(const T* p1, const T* p2, const int32_t* kx2, const int32_t* ky2,
                   const int32_t* kz2h, const T* wz, const int32_t* thr, double* partial,
                   double* out, int64_t Nx, int64_t Ny, int64_t H, int nbins, int nblocks,
                   int threads, cudaStream_t stream) {
  const size_t smem = 3 * static_cast<size_t>(nbins) * (threads + 1) * sizeof(double) +
                      static_cast<size_t>(nbins) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(binned_pk_v2_partial_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  binned_pk_v2_partial_kernel<T><<<nblocks, threads, smem, stream>>>(
      p1, p2, kx2, ky2, kz2h, wz, thr, partial, static_cast<uint32_t>(Ny),
      static_cast<uint32_t>(H), static_cast<uint32_t>(Nx * Ny * H), nbins);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  binned_pk_v2_final_kernel<<<3 * nbins, 256, 0, stream>>>(partial, out, nblocks, 3 * nbins);
  return cudaGetLastError();
}

}  // namespace

// p1, p2: (Nx, Ny, H) contiguous; kx2 (Nx,), ky2 (Ny,), kz2h (H,): int32
// squared integer FFT indices; wz: (H,) kz weights; thr: (nbins,) int32
// ascending thresholds; partial: (nblocks, 3, nbins) float64 scratch;
// out: (3, nbins) float64 = (sum w p1, sum w p1^2, sum w p2).  Requires
// Nx*Ny*H < 2^32 and blockDim `threads` a multiple of 32.
extern "C" int fbx_binned_pk_v2_f32(const float* p1, const float* p2, const int32_t* kx2,
                                    const int32_t* ky2, const int32_t* kz2h, const float* wz,
                                    const int32_t* thr, double* partial, double* out, int64_t Nx,
                                    int64_t Ny, int64_t H, int nbins, int nblocks, int threads,
                                    void* stream) {
  return launch(p1, p2, kx2, ky2, kz2h, wz, thr, partial, out, Nx, Ny, H, nbins, nblocks, threads,
                static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_binned_pk_v2_f64(const double* p1, const double* p2, const int32_t* kx2,
                                    const int32_t* ky2, const int32_t* kz2h, const double* wz,
                                    const int32_t* thr, double* partial, double* out, int64_t Nx,
                                    int64_t Ny, int64_t H, int nbins, int nblocks, int threads,
                                    void* stream) {
  return launch(p1, p2, kx2, ky2, kz2h, wz, thr, partial, out, Nx, Ny, H, nbins, nblocks, threads,
                static_cast<cudaStream_t>(stream));
}
