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
// Bound on the card: memory (8 bytes read per f32 mode, 68 MB at 256^3).
// Float atomics into ~20 bins would serialise and, in f32, miss the
// accuracy bar the TPU kernel set (3.9e-7 max relative error at 256^3,
// binned_pk.py:203-205); they would also change the result from run to run.
// Design: products in float64 (exact for f32 inputs), sums in float64 in an
// order fixed by the shape alone, so the result is bitwise the same on every
// run.
//
// Each warp walks a fixed contiguous range of rows (i, j); base = kx2[i] +
// ky2[j] once per row, and (i, j) advance by increments, so the walk has no
// integer division.  On the fast path kz2h ascends (fi2[:H] does at every
// call site; each block checks it on the device while it starts, with no
// read on the host), so m ascends along a row and each bin is one run of
// consecutive l.  Per row the warp finds the first mode's bin b0 by one
// ballot over the thresholds, and lane k the end of bin b0 + k by one
// bisection over kz2h; then it takes the runs in order, lanes along l with
// coalesced loads and no test per mode.  A lane sums its modes of a run in
// registers; the warp adds the three sums of its 32 lanes by a fixed
// butterfly of 12 shuffles (fbx::warp_sum4 with w = 0) and adds them to its
// own row of bins in shared memory.  The block adds its warps' rows in warp order into a per-block
// partial, and a second kernel sums the partials in a fixed tree
// (common.cuh), writing the input dtype.  A call whose kz2h does not ascend
// takes the general path: each mode's bin by bisection over the thresholds,
// and the warp's lanes summed bin by bin, in order of the lowest lane, by
// the same butterfly.
//
// K4t, the telescoped mode (kTelescoped; _kernel_v2's telescoped=True body,
// binned_pk_v2.py:63-71 and :162-173): bin b = S_b - S_{b-1}, with S_c the
// less-than prefix over the modes with m < thr[c], c < nbins (S_{-1} = 0;
// the overflow bin m >= thr[nbins-1] is not represented).  A mode still
// adds to its own bin's sum only, so the walk is K4's; the block's epilogue
// turns its bin sums into prefixes by a running sum over the bins, the
// cross-block tree sums those, and takes each difference S_b - S_{b-1} in
// f64 before the one rounding to the input dtype.  The TPU accumulates its
// prefixes in f32, whose cancellation at the top of a prefix costs up to
// ~2e-5 relative (tests/test_binned_pk_v2.py:46); here every prefix is an
// f64 sum, so K4t equals K4 to within the rounding of the final cast.
#include "common.cuh"

namespace {

constexpr unsigned kAll = 0xffffffffu;

// Adds the butterfly's three sums to the warp's row of bins [3][nbins] at
// bin b.
__device__ __forceinline__ void deposit(double* wacc, double v, int b, int nbins, int lane) {
  if ((lane & 7) == 0 && lane < 24) wacc[(lane >> 3) * nbins + b] += v;
}

// The walk over the warp's rows [r, r1), row r at (i, j): state and steps.
struct Rows {
  const int32_t* kx2;
  const int32_t* ky2;
  int64_t r, r1;
  uint32_t i, j, Ny;
  int32_t base;
  __device__ void next() {
    ++r;
    if (++j == Ny) {
      j = 0;
      ++i;
    }
  }
  __device__ void load_base() { base = kx2[i] + ky2[j]; }
};

// The fast path: kz2h ascends, so every bin is a run of consecutive l.
template <typename T>
__device__ __forceinline__ void walk_runs(Rows& w, const T* __restrict__ p1,
                                          const T* __restrict__ p2,
                                          const int32_t* __restrict__ kz2h,
                                          const T* __restrict__ wz, const int32_t* thr_sh,
                                          double* wacc, int H, int nbins, int lane) {
  for (; w.r < w.r1; w.next()) {
    w.load_base();
    const T* a = p1 + w.r * H;
    const T* c = p2 + w.r * H;
    // the bin of the row's first mode: the thresholds <= its m, by ballots
    const int32_t m0 = w.base + kz2h[0];
    int b0 = 0;
    for (int k0 = 0; k0 < nbins; k0 += 32)
      b0 += __popc(__ballot_sync(kAll, k0 + lane < nbins && thr_sh[k0 + lane] <= m0));
    // runs of 32 bins at a time: lane k finds where bin b0 + k ends, the
    // first l with m >= thr[b0 + k] (H if none), by bisection over kz2h
    int start = 0;
    for (; b0 < nbins && start < H; b0 += 32) {
      int lo = start, hi = H;
      if (b0 + lane < nbins) {
        const int32_t edge = thr_sh[b0 + lane] - w.base;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (kz2h[mid] < edge) lo = mid + 1;
          else hi = mid;
        }
      }
      const int bins = min(32, nbins - b0);
      for (int k = 0; k < bins && start < H; ++k) {
        const int end = __shfl_sync(kAll, lo, k);
        if (end == start) continue;  // an empty bin
        double s1 = 0.0, q1 = 0.0, s2 = 0.0;
#pragma unroll 4
        for (int l = start + lane; l < end; l += 32) {
          const double wl = static_cast<double>(wz[l]);
          const double x = static_cast<double>(a[l]);
          const double wx = wl * x;
          s1 += wx;
          q1 += wx * x;
          s2 += wl * static_cast<double>(c[l]);
        }
        deposit(wacc, fbx::warp_sum4(s1, q1, s2, 0.0, lane), b0 + k, nbins, lane);
        start = end;
      }
    }
  }
}

// The general path: each mode's bin by bisection over the thresholds; per
// chunk of 32 modes the warp sums its lanes bin by bin, in order of each
// bin's lowest lane.
template <typename T>
__device__ void walk_modes(Rows& w, const T* __restrict__ p1, const T* __restrict__ p2,
                           const int32_t* __restrict__ kz2h, const T* __restrict__ wz,
                           const int32_t* thr_sh, double* wacc, int H, int nbins, int lane) {
  for (; w.r < w.r1; w.next()) {
    w.load_base();
    const int64_t row0 = w.r * H;
    for (int l0 = 0; l0 < H; l0 += 32) {
      const int l = l0 + lane;
      int bin = nbins;
      double x = 0.0, y = 0.0, z = 0.0;
      if (l < H) {
        const int32_t m = w.base + kz2h[l];
        int lo = 0, hi = nbins;  // bin = number of thresholds <= m
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (thr_sh[mid] <= m) lo = mid + 1;
          else hi = mid;
        }
        bin = lo;
        if (bin < nbins) {
          const double wl = static_cast<double>(wz[l]);
          const double a = static_cast<double>(p1[row0 + l]);
          x = wl * a;
          y = x * a;
          z = wl * static_cast<double>(p2[row0 + l]);
        }
      }
      unsigned pending = __ballot_sync(kAll, bin < nbins);
      while (pending) {
        const int bl = __shfl_sync(kAll, bin, __ffs(pending) - 1);
        const bool mine = bin == bl;
        deposit(wacc, fbx::warp_sum4(mine ? x : 0.0, mine ? y : 0.0, mine ? z : 0.0, 0.0, lane), bl,
                nbins, lane);
        pending &= ~__ballot_sync(kAll, mine);
      }
    }
  }
}

template <typename T, bool kTelescoped>
__global__ void __launch_bounds__(256)
    binned_pk_v2_partial_kernel(const T* __restrict__ p1, const T* __restrict__ p2,
                                const int32_t* __restrict__ kx2, const int32_t* __restrict__ ky2,
                                const int32_t* __restrict__ kz2h, const T* __restrict__ wz,
                                const int32_t* __restrict__ thr, double* __restrict__ partial,
                                uint32_t Ny, int H, int64_t rows, int nbins) {
  // [warp][3][nbins] sums; K4t: the block's [3][nbins]; the thresholds
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int nk = 3 * nbins;
  double* acc = reinterpret_cast<double*>(smem_raw);
  double* blk = acc + nwarps * nk;
  int32_t* thr_sh = reinterpret_cast<int32_t*>(blk + (kTelescoped ? nk : 0));
  for (int k = threadIdx.x; k < nwarps * nk; k += blockDim.x) acc[k] = 0.0;
  for (int k = threadIdx.x; k < nbins; k += blockDim.x) thr_sh[k] = thr[k];
  // the fast path's precondition, checked on the device by every block
  int ascending = 1;
  for (int l = threadIdx.x; l + 1 < H; l += blockDim.x) ascending &= kz2h[l] <= kz2h[l + 1];
  ascending = __syncthreads_and(ascending);

  // the warp's rows: a contiguous range fixed by the shape
  const int64_t nw = static_cast<int64_t>(gridDim.x) * nwarps;
  const int64_t per = (rows + nw - 1) / nw;
  const int64_t r0 = (static_cast<int64_t>(blockIdx.x) * nwarps + warp) * per;
  if (r0 < rows) {
    const uint32_t i = static_cast<uint32_t>(r0 / Ny);  // once per warp
    Rows w{kx2, ky2, r0, r0 + per < rows ? r0 + per : rows,
           i, static_cast<uint32_t>(r0 - static_cast<int64_t>(i) * Ny), Ny, 0};
    double* wacc = acc + warp * nk;
    if (ascending) walk_runs(w, p1, p2, kz2h, wz, thr_sh, wacc, H, nbins, lane);
    else walk_modes(w, p1, p2, kz2h, wz, thr_sh, wacc, H, nbins, lane);
  }
  __syncthreads();

  // partial[block][stat][bin]: the block's warps in order (K4t: kept in
  // blk, then summed over bins 0..bin)
  for (int k = threadIdx.x; k < nk; k += blockDim.x) {
    double s = 0.0;
    for (int v = 0; v < nwarps; ++v) s += acc[v * nk + k];
    if (kTelescoped) blk[k] = s;
    else partial[static_cast<int64_t>(blockIdx.x) * nk + k] = s;
  }
  if (kTelescoped) {
    __syncthreads();
    for (int k = threadIdx.x; k < nk; k += blockDim.x) {
      const int stat = k / nbins, edge = k - stat * nbins;
      double s = 0.0;
      for (int bin = 0; bin <= edge; ++bin) s += blk[stat * nbins + bin];
      partial[static_cast<int64_t>(blockIdx.x) * nk + k] = s;
    }
  }
}

template <typename T, bool kTelescoped>
cudaError_t launch(const T* p1, const T* p2, const int32_t* kx2, const int32_t* ky2,
                   const int32_t* kz2h, const T* wz, const int32_t* thr, double* partial,
                   T* out, int64_t Nx, int64_t Ny, int64_t H, int nbins, int nblocks,
                   int threads, cudaStream_t stream) {
  // at most (8 + 1) * 3 * 120 doubles and 120 thresholds: under the 48 KB default
  const size_t smem = (threads / 32 + (kTelescoped ? 1 : 0)) * 3 * static_cast<size_t>(nbins) *
                          sizeof(double) +
                      static_cast<size_t>(nbins) * sizeof(int32_t);
  binned_pk_v2_partial_kernel<T, kTelescoped><<<nblocks, threads, smem, stream>>>(
      p1, p2, kx2, ky2, kz2h, wz, thr, partial, static_cast<uint32_t>(Ny),
      static_cast<int>(H), Nx * Ny, nbins);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fbx::sum_partials_kernel<256, T><<<3 * nbins, 256, 0, stream>>>(partial, out, nblocks,
                                                                   3 * nbins,
                                                                   kTelescoped ? nbins : 0);
  return cudaGetLastError();
}

}  // namespace

// p1, p2: (Nx, Ny, H) contiguous; kx2 (Nx,), ky2 (Ny,), kz2h (H,): int32
// squared integer FFT indices; wz: (H,) kz weights; thr: (nbins,) int32
// ascending thresholds, nbins <= 120; partial: (nblocks, 3, nbins) float64
// scratch; out: (3, nbins) = (sum w p1, sum w p1^2, sum w p2) per bin in the
// input dtype (fbx_binned_pk_v2t: the same, as differences of the float64
// prefixes).  `threads` is a multiple of 32, at most 256.
extern "C" int fbx_binned_pk_v2_f32(const float* p1, const float* p2, const int32_t* kx2,
                                    const int32_t* ky2, const int32_t* kz2h, const float* wz,
                                    const int32_t* thr, double* partial, float* out, int64_t Nx,
                                    int64_t Ny, int64_t H, int nbins, int nblocks, int threads,
                                    void* stream) {
  return launch<float, false>(p1, p2, kx2, ky2, kz2h, wz, thr, partial, out, Nx, Ny, H, nbins,
                              nblocks, threads, static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_binned_pk_v2_f64(const double* p1, const double* p2, const int32_t* kx2,
                                    const int32_t* ky2, const int32_t* kz2h, const double* wz,
                                    const int32_t* thr, double* partial, double* out, int64_t Nx,
                                    int64_t Ny, int64_t H, int nbins, int nblocks, int threads,
                                    void* stream) {
  return launch<double, false>(p1, p2, kx2, ky2, kz2h, wz, thr, partial, out, Nx, Ny, H, nbins,
                               nblocks, threads, static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_binned_pk_v2t_f32(const float* p1, const float* p2, const int32_t* kx2,
                                     const int32_t* ky2, const int32_t* kz2h, const float* wz,
                                     const int32_t* thr, double* partial, float* out, int64_t Nx,
                                     int64_t Ny, int64_t H, int nbins, int nblocks, int threads,
                                     void* stream) {
  return launch<float, true>(p1, p2, kx2, ky2, kz2h, wz, thr, partial, out, Nx, Ny, H, nbins,
                             nblocks, threads, static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_binned_pk_v2t_f64(const double* p1, const double* p2, const int32_t* kx2,
                                     const int32_t* ky2, const int32_t* kz2h, const double* wz,
                                     const int32_t* thr, double* partial, double* out, int64_t Nx,
                                     int64_t Ny, int64_t H, int nbins, int nblocks, int threads,
                                     void* stream) {
  return launch<double, true>(p1, p2, kx2, ky2, kz2h, wz, thr, partial, out, Nx, Ny, H, nbins,
                              nblocks, threads, static_cast<cudaStream_t>(stream));
}
