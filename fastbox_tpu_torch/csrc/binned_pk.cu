// K5/K6: binned-P(k) reductions with a floating squared-space digitize.
//
// Replaces fastbox_tpu/ops/pallas/binned_pk.py::binned_pk_half_dual_pallas
// (_half_dual_kernel, K5) and ::binned_pk_pallas (_kernel, K6).  K5 is the
// pipeline's P(k) reduction on boxes that are not cubes (and wherever
// pallas_pk='on'): for every mode (i, j, l) of an (Nx, Ny, H) half spectrum
// it forms k2 = kx2[i] + (ky2[j] + kz2[l]) in the input dtype, in the
// Pallas body's association order, classifies it as bin b = #{edges2 <= k2},
// and accumulates, for b < nbins, sum w p1, sum w p1^2, sum w p2 and sum w
// with w = wz[l].  K6 is the same body for one field on the full cube with
// unit weights: sum p, sum p^2 and the count.
//
// Bound on the card: memory (8 bytes read per f32 mode for K5, 4 for K6;
// 68 MB at 256^3).  Float atomics into ~20 bins would serialise and change
// the result from run to run, so the sums are float64 in an order fixed by
// the shape alone, and the result is bitwise the same on every run.
//
// The walk is K4's (binned_pk_v2.cu) with the digitize in floating point.
// Each warp walks a fixed contiguous range of rows (i, j); kx2[i] and ky2[j]
// are registers, and (i, j) advance by increments, so the walk has no
// integer division.  Round-to-nearest is monotone, so k2(l) = fl(kx2 +
// fl(ky2 + kz2[l])) is non-decreasing wherever kz2 is, and along such a
// segment each bin is one run of consecutive l.  K5's segment is [0, H):
// kz2h ascends at every call site.  K6's full-cube kz2 is in FFT order: it
// ascends on [0, S) and descends on [S, Nz), S = Nz / 2 + 1 (odd Nz too,
// where kz2[S - 1] = kz2[S]); the second segment is walked from its end,
// where k2 ascends, with loads still coalesced.  Every block checks its
// kernel's rule on kz2, and that kz2 is finite, on the device while it
// starts; a row whose kx2 or ky2 is not finite, and every row of a call
// whose kz2 breaks the rule, takes the general path below.
//
// Per segment the warp finds the first mode's bin b0 by ballots over the
// edges, and lane k the end of bin b0 + k, the first position whose k2 is
// >= edges2[b0 + k], by bisection; each probe forms k2 with the same two
// rounded adds in the dtype as the twin (ops/cuda/binned_pk.py::
// bin_index_sq), so every mode lands in the twin's bin.  A run's lanes sum
// along l with coalesced loads and no test per mode, the products in
// float64 rounded as the twin's (w p, then (w p) p).  The lanes' sums stay
// in registers, and a fixed shuffle butterfly (common.cuh) adds them into
// the warp's own row of bins in shared memory, kStats x nbins doubles (at
// most 30 KB a block at 120 bins and 8 warps, under the 48 KB default).
// K6's count of a run is end - start, exact.  The block adds its warps'
// rows in warp order into a per-block partial, and sum_partials_kernel adds
// the blocks in a fixed tree and writes the input dtype.
//
// The general path bins each mode by bisection over the edges and adds a
// chunk of 32 modes bin by bin, in order of each bin's lowest lane, by the
// same butterfly.  It is right on any input.
#include "common.cuh"

namespace {

constexpr unsigned kAll = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T k2_at(T kx, T ky, T kz) {
  return fbx::add_rn(kx, fbx::add_rn(ky, kz));
}

// Adds one bin's lane sums to the warp's row of bins [kStats][nbins] at
// bin b.  K5: (w p1, w p1^2, w p2, w); K6: (p, p^2) and the count `n`.
template <bool kDual>
__device__ __forceinline__ void deposit(double* wacc, double x, double y, double z, double w,
                                        double n, int b, int nbins, int lane) {
  if (kDual) {
    const double v = fbx::warp_sum4(x, y, z, w, lane);
    if ((lane & 7) == 0) wacc[(lane >> 3) * nbins + b] += v;
  } else {
    const double v = fbx::warp_sum2(x, y, lane);
    if ((lane & 15) == 0) wacc[(lane >> 4) * nbins + b] += v;
    if (lane == 0) wacc[2 * nbins + b] += n;
  }
}

// The fast path on one segment of a row: `len` positions t, mode t at
// a[dir * t], c[dir * t], kz[dir * t], wz[dir * t], with k2 non-decreasing
// in t.
template <typename T, bool kDual>
__device__ __forceinline__ void walk_segment(const T* __restrict__ a, const T* __restrict__ c,
                                             const T* __restrict__ kz, const T* __restrict__ wz,
                                             int dir, int len, T kx, T ky, const T* edges_sh,
                                             double* wacc, int nbins, int lane) {
  // the bin of the segment's first mode: the edges <= its k2, by ballots
  const T first = k2_at(kx, ky, kz[0]);
  int b0 = 0;
  for (int e0 = 0; e0 < nbins; e0 += 32)
    b0 += __popc(__ballot_sync(kAll, e0 + lane < nbins && !(first < edges_sh[e0 + lane])));
  // runs of 32 bins at a time: lane k finds where bin b0 + k ends, the
  // first t with k2 >= edges2[b0 + k] (len if none)
  int start = 0;
  for (; b0 < nbins && start < len; b0 += 32) {
    int lo = start, hi = len;
    if (b0 + lane < nbins) {
      const T edge = edges_sh[b0 + lane];
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (k2_at(kx, ky, kz[dir * mid]) < edge) lo = mid + 1;
        else hi = mid;
      }
    }
    const int bins = min(32, nbins - b0);
    for (int k = 0; k < bins && start < len; ++k) {
      const int end = __shfl_sync(kAll, lo, k);
      if (end == start) continue;  // an empty bin
      double x = 0.0, y = 0.0, z = 0.0, w = 0.0;
#pragma unroll 4
      for (int t = start + lane; t < end; t += 32) {
        const int l = dir * t;
        const double p = static_cast<double>(a[l]);
        if (kDual) {
          const double wl = static_cast<double>(wz[l]);
          const double wp = fbx::mul_rn(wl, p);
          x += wp;
          y += fbx::mul_rn(wp, p);
          z += fbx::mul_rn(wl, static_cast<double>(c[l]));
          w += wl;
        } else {
          x += p;
          y += fbx::mul_rn(p, p);
        }
      }
      deposit<kDual>(wacc, x, y, z, w, static_cast<double>(end - start), b0 + k, nbins, lane);
      start = end;
    }
  }
}

// The general path on a row of `len` modes: each mode's bin by bisection
// over the edges; per chunk of 32 modes the warp adds its lanes bin by bin,
// in order of each bin's lowest lane.
template <typename T, bool kDual>
__device__ void walk_modes(const T* __restrict__ a, const T* __restrict__ c,
                           const T* __restrict__ kz, const T* __restrict__ wz, int len, T kx, T ky,
                           const T* edges_sh, double* wacc, int nbins, int lane) {
  for (int l0 = 0; l0 < len; l0 += 32) {
    const int l = l0 + lane;
    int bin = nbins;
    double x = 0.0, y = 0.0, z = 0.0, w = 0.0;
    if (l < len) {
      const T k2 = k2_at(kx, ky, kz[l]);
      int lo = 0, hi = nbins;  // bin = number of edges <= k2 (a NaN: nbins)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (k2 < edges_sh[mid]) hi = mid;
        else lo = mid + 1;
      }
      bin = lo;
      if (bin < nbins) {
        const double p = static_cast<double>(a[l]);
        if (kDual) {
          w = static_cast<double>(wz[l]);
          x = fbx::mul_rn(w, p);
          y = fbx::mul_rn(x, p);
          z = fbx::mul_rn(w, static_cast<double>(c[l]));
        } else {
          x = p;
          y = fbx::mul_rn(p, p);
        }
      }
    }
    unsigned pending = __ballot_sync(kAll, bin < nbins);
    while (pending) {
      const int bl = __shfl_sync(kAll, bin, __ffs(pending) - 1);
      const bool mine = bin == bl;
      const unsigned who = __ballot_sync(kAll, mine);
      deposit<kDual>(wacc, mine ? x : 0.0, mine ? y : 0.0, mine ? z : 0.0, mine ? w : 0.0,
                     static_cast<double>(__popc(who)), bl, nbins, lane);
      pending &= ~who;
    }
  }
}

template <typename T, bool kDual>
__global__ void __launch_bounds__(256)
    binned_pk_partial_kernel(const T* __restrict__ p1, const T* __restrict__ p2,
                             const T* __restrict__ kx2, const T* __restrict__ ky2,
                             const T* __restrict__ kz2, const T* __restrict__ wz,
                             const T* __restrict__ edges2, double* __restrict__ partial,
                             uint32_t Ny, int L, int64_t rows, int nbins) {
  constexpr int kStats = kDual ? 4 : 3;  // (s1, q1, s2, sum w) or (s, q, count)
  // [warp][kStats][nbins] sums, then the edges
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int nk = kStats * nbins;
  double* acc = reinterpret_cast<double*>(smem_raw);
  T* edges_sh = reinterpret_cast<T*>(acc + nwarps * nk);
  for (int k = threadIdx.x; k < nwarps * nk; k += blockDim.x) acc[k] = 0.0;
  for (int k = threadIdx.x; k < nbins; k += blockDim.x) edges_sh[k] = edges2[k];
  // the segment rule, checked on the device by every block: kz2 is finite,
  // ascends on [0, S) and (K6) descends on [S, L)
  const int S = kDual ? L : L / 2 + 1;
  int monotone = 1;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const T v = kz2[l];
    monotone &= isfinite(v);
    if (l + 1 < S) monotone &= v <= kz2[l + 1];
    else if (l >= S && l + 1 < L) monotone &= v >= kz2[l + 1];
  }
  monotone = __syncthreads_and(monotone);

  // the warp's rows: a contiguous range fixed by the shape
  const int64_t nw = static_cast<int64_t>(gridDim.x) * nwarps;
  const int64_t per = (rows + nw - 1) / nw;
  const int64_t r0 = (static_cast<int64_t>(blockIdx.x) * nwarps + warp) * per;
  if (r0 < rows) {
    const int64_t r1 = r0 + per < rows ? r0 + per : rows;
    uint32_t i = static_cast<uint32_t>(r0 / Ny);  // once per warp
    uint32_t j = static_cast<uint32_t>(r0 - static_cast<int64_t>(i) * Ny);
    double* wacc = acc + warp * nk;
    for (int64_t r = r0; r < r1; ++r) {
      const T kx = kx2[i], ky = ky2[j];
      const T* a = p1 + r * L;
      const T* c = kDual ? p2 + r * L : nullptr;
      if (monotone && isfinite(kx) && isfinite(ky)) {
        walk_segment<T, kDual>(a, c, kz2, wz, 1, S, kx, ky, edges_sh, wacc, nbins, lane);
        if (S < L)  // K6: [S, L) from its end
          walk_segment<T, kDual>(a + (L - 1), c, kz2 + (L - 1), wz, -1, L - S, kx, ky, edges_sh,
                                 wacc, nbins, lane);
      } else {
        walk_modes<T, kDual>(a, c, kz2, wz, L, kx, ky, edges_sh, wacc, nbins, lane);
      }
      if (++j == Ny) {
        j = 0;
        ++i;
      }
    }
  }
  __syncthreads();

  // partial[block][stat][bin]: the block's warps in order
  for (int k = threadIdx.x; k < nk; k += blockDim.x) {
    double s = 0.0;
    for (int v = 0; v < nwarps; ++v) s += acc[v * nk + k];
    partial[static_cast<int64_t>(blockIdx.x) * nk + k] = s;
  }
}

template <typename T, bool kDual>
cudaError_t launch(const T* p1, const T* p2, const T* kx2, const T* ky2, const T* kz2, const T* wz,
                   const T* edges2, double* partial, T* out, int64_t Nx, int64_t Ny, int64_t L,
                   int nbins, int nblocks, int threads, cudaStream_t stream) {
  constexpr int kStats = kDual ? 4 : 3;
  // at most 8 * 4 * 120 doubles and 120 edges: under the 48 KB default
  const size_t smem = (threads / 32) * kStats * static_cast<size_t>(nbins) * sizeof(double) +
                      static_cast<size_t>(nbins) * sizeof(T);
  binned_pk_partial_kernel<T, kDual><<<nblocks, threads, smem, stream>>>(
      p1, p2, kx2, ky2, kz2, wz, edges2, partial, static_cast<uint32_t>(Ny), static_cast<int>(L),
      Nx * Ny, nbins);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fbx::sum_partials_kernel<256, T><<<kStats * nbins, 256, 0, stream>>>(partial, out, nblocks,
                                                                     kStats * nbins);
  return cudaGetLastError();
}

}  // namespace

// K5.  p1, p2: (Nx, Ny, H) contiguous; kx2 (Nx,), ky2 (Ny,), kz2h (H,):
// squared wavenumbers, physical or integer-valued, in the fields' dtype;
// wz: (H,) kz multiplicities; edges2: (nbins,) ascending squared edges,
// nbins <= 120; partial: (nblocks, 4, nbins) float64 scratch; out: (4,
// nbins) = (sum w p1, sum w p1^2, sum w p2, sum w) in the fields' dtype.
// Requires Nx*Ny*H < 2^31 and a blockDim `threads` that is a multiple of
// 32, at most 256.
extern "C" int fbx_binned_pk_half_dual_f32(const float* p1, const float* p2, const float* kx2,
                                           const float* ky2, const float* kz2h, const float* wz,
                                           const float* edges2, double* partial, float* out,
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
// edges2 as above; partial: (nblocks, 3, nbins); out: (3, nbins) = (sum p,
// sum p^2, count) in pk's dtype.
extern "C" int fbx_binned_pk_full_f32(const float* pk, const float* kx2, const float* ky2,
                                      const float* kz2, const float* edges2, double* partial,
                                      float* out, int64_t Nx, int64_t Ny, int64_t Nz, int nbins,
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
