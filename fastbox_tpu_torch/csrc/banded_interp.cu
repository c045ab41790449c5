// K8: banded telescoping interpolation on per-row sorted nodes.
//
// Replaces fastbox_tpu/ops/pallas/banded_interp.py::banded_interp_pallas
// (_kernel), the banded tier of the sort branch of
// ops/rsd.py::remap_los_batched (the RSD remap of the sharded ensemble
// step).  Every sorted node lies within `band` cells of its rank, so
// interpolation onto the rank grid needs only the 2*band segments around
// each target:
//   out(t) = v[max(t-band, 0)]
//            + sum_{o=-band}^{band-1} dv[t+o] * clamp((z_t - s[t+o]) / ds, 0, 1)
// over segments c = t+o with 0 <= c <= C-2; a segment with ds <= 0 (duplicate
// nodes) steps by dv where z_t >= s[c].  Targets outside [s[0], s[C-1]] get
// the row's fill (the griddata hull).
//
// The terms without a division.  With a = z_t - s[c] and ds+ = max(ds, 0),
// both rounded as the plain PyTorch twin rounds ds and a, the twin's term is
//   dv[c]               where a >= ds+ (a correctly rounded a / ds of a >= ds
//                       > 0 is >= 1, and for ds <= 0 the step rule z_t >= s[c]
//                       is a >= 0: a difference of finite floats is 0 only
//                       between equal ones);
//   dv[c] * (a / ds)    where 0 < a < ds+ (the segment that straddles z_t);
//   +-0                 otherwise (a quotient <= 0 clamps to 0).
// The +-0 terms are skipped: adding one changes at most the sign of a zero
// sum, and torch.equal holds +0 and -0 equal.  The rest are added in the
// twin's order (offsets ascending) with explicit rounding, so the result
// equals the twin's on finite inputs.  On a row whose nodes ascend (every
// ds >= 0) the whole terms of a target are its first segments and only the
// next one can straddle z_t (a whole segment c has z_t >= s[c], so every
// earlier one is whole; a later one has z_t < s[c], so a < 0): the target
// adds dv while a >= ds+, then divides once.  A row that does not ascend
// takes the per-term loop (sum_terms), one division per straddling segment.
//
// Bound on the card: memory.  Each row reads s and v once and writes out
// once (12 bytes per f32 cell).  Each segment's ds+ and dv are formed once
// per row.  Two paths, chosen by the wrapper's rule (ops/cuda/
// banded_interp.py staged_path, the rule of K2/K7):
//
// The staged path (C a multiple of 4, band 2 or 4, rows of at most 4096
// cells, 16-byte aligned arrays) gives each row to one warp, several warps
// to a block and row after row to each warp, with z staged once per block
// and no block barrier after it.  A warp copies its next row's s and v into
// a second buffer with 16-byte cp.async while it works on the current one;
// it writes the row's ds+ and dv into its own shared arrays, then each lane
// takes one 16-byte vector of targets (4 in f32, 2 in f64): it loads the
// window of s, ds+ and dv those targets share into registers as 16-byte
// vectors at compile-time indices, adds the whole terms in order, and takes
// the straddling segment's from shared memory with one division.  Halos
// (ds+ = dv = 0; s = -inf before the row, whole terms of 0 as the twin adds
// there, and +inf after it, no terms) keep the segment test free of index
// checks.  The row's ascent is one warp vote.  The direct path (any other row) gives
// each row to a block of threads and bounds the segments by index.
#include "common.cuh"

namespace {

// The twin's clamped term of a segment, from a = z_t - s[c] and its ds+:
// the whole dv, or the straddling fraction of it (else nothing).
template <typename T>
__device__ __forceinline__ bool whole_term(T a, T dsp) { return a >= dsp; }
template <typename T>
__device__ __forceinline__ bool straddles(T a, T dsp) { return a > T(0) && a < dsp; }

// ds+ = max(ds, 0) of a segment's ds = s[c+1] - s[c]
template <typename T>
__device__ __forceinline__ T ds_plus(T ds) { return ds > T(0) ? ds : T(0); }

// acc plus the terms of segments c0 .. c0+n-1 in order, one division per
// straddling segment: the direct path's sum, and the staged path's for a
// target with more than one straddling segment.
template <typename T>
__device__ T sum_terms(T acc, T zt, const T* s, const T* dsp, const T* dv, int c0, int n) {
  for (int c = c0; c < c0 + n; ++c) {
    const T a = fbx::sub_rn(zt, s[c]);
    if (whole_term(a, dsp[c])) {
      acc = fbx::add_rn(acc, dv[c]);
    } else if (straddles(a, dsp[c])) {
      acc = fbx::add_rn(acc, fbx::mul_rn(dv[c], fbx::div_rn(a, dsp[c])));
    }
  }
  return acc;
}

// ---------------------------------------------------------------- direct
// One block per row (grid-stride over rows), any C and band: s, v, ds+ and
// dv of the row in shared memory.
template <typename T>
__global__ void banded_interp_rows(const T* __restrict__ ss, const T* __restrict__ vv,
                                   const T* __restrict__ z, const T* __restrict__ fill,
                                   T* __restrict__ out, int64_t M, int C, int band) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_sh = reinterpret_cast<T*>(smem_raw);
  T* v_sh = s_sh + C;
  T* dsp_sh = v_sh + C;
  T* dv_sh = dsp_sh + C;

  for (int64_t row = blockIdx.x; row < M; row += gridDim.x) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      s_sh[c] = ss[row * C + c];
      v_sh[c] = vv[row * C + c];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C - 1; c += blockDim.x) {
      dsp_sh[c] = ds_plus(fbx::sub_rn(s_sh[c + 1], s_sh[c]));
      dv_sh[c] = fbx::sub_rn(v_sh[c + 1], v_sh[c]);
    }
    __syncthreads();
    const T s_first = s_sh[0], s_last = s_sh[C - 1], fr = fill[row];
    for (int t = threadIdx.x; t < C; t += blockDim.x) {
      const T zt = z[t];
      const int lo = t >= band ? t - band : 0;               // first segment, and v's index
      const int hi = t + band - 1 < C - 2 ? t + band - 1 : C - 2;
      const T acc = sum_terms(v_sh[lo], zt, s_sh, dsp_sh, dv_sh, lo, hi - lo + 1);
      out[row * C + t] = (zt >= s_first && zt <= s_last) ? acc : fr;
    }
    __syncthreads();  // the next row overwrites the arrays
  }
}

template <typename T>
cudaError_t launch_rows(const T* ss, const T* vv, const T* z, const T* fill, T* out, int64_t M,
                        int C, int band, cudaStream_t stream) {
  const int threads = C >= 256 ? 256 : (C + 31) / 32 * 32;
  const int64_t blocks = M < (1 << 20) ? M : (1 << 20);
  const size_t smem = 4 * static_cast<size_t>(C) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(banded_interp_rows<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  banded_interp_rows<T><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      ss, vv, z, fill, out, M, C, band);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- staged
// The staged row's geometry at band kBand: node c of the row sits at
// position kLead + c of each per-warp array; K targets per lane (one
// 16-byte vector); a lane's window of kWin vectors starts kLead nodes before
// its first target (on a 16-byte boundary) and reaches its last target's
// last segment, t + kBand - 1; the halos, kLead before the row and kTail
// after it, are whole vectors.
template <typename T, int kBand>
struct Banded {
  static constexpr int K = 16 / static_cast<int>(sizeof(T));
  static constexpr int kLead = (kBand + K - 1) / K * K;
  static constexpr int kWin = (kLead + K + kBand - 1 + K - 1) / K;
  static constexpr int kTail = kWin * K - kLead - K;
  // v[max(t - kBand, 0)] of the lane's targets: vectors kV0 .. kV0 + kNV - 1
  static constexpr int kV0 = (kLead - kBand) / K;
  static constexpr int kNV = (kLead - kBand + K - 1) / K - kV0 + 1;
  static_assert(kTail >= 1, "the segment pass reads one node past the row");
  static __host__ __device__ int row_len(int C) { return kLead + C + kTail; }
};

template <typename T, int kBand>
__global__ void __launch_bounds__(256)
    banded_interp_staged(const T* __restrict__ ss, const T* __restrict__ vv,
                         const T* __restrict__ z, const T* __restrict__ fill, T* __restrict__ out,
                         int64_t M, int C) {
  using G = Banded<T, kBand>;
  using VT = fbx::Vec16<T>;
  using V = typename VT::type;
  constexpr int K = G::K;
  constexpr int kSeg = 2 * kBand;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = G::row_len(C);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  T* z_sh = reinterpret_cast<T*>(smem_raw);
  T* bufs = z_sh + C + static_cast<size_t>(warp) * 6 * L;  // [2 buffers][s, v][L]
  T* dsp_sh = bufs + 4 * L;
  T* dv_sh = dsp_sh + L;
  for (int c = threadIdx.x; c < C; c += blockDim.x) z_sh[c] = z[c];
  // halos: ds+ = dv = 0, and s = -inf before the row (a = +inf: a whole term
  // of 0, as the twin adds for c < 0) and +inf after it (a = -inf: no term);
  // v's lead is rewritten per row
  for (int i = lane; i < G::kLead + G::kTail; i += 32) {
    const int pos = i < G::kLead ? i : C + i;
    const T inf = fbx::Limits<T>::inf();
    bufs[pos] = bufs[2 * L + pos] = i < G::kLead ? -inf : inf;
    bufs[L + pos] = bufs[3 * L + pos] = T(0);
    dsp_sh[pos] = dv_sh[pos] = T(0);
  }
  __syncthreads();  // the block's only barrier
  const int nvec = C / K;

  auto fetch = [&](int64_t row, T* b) {
    const T* gs = ss + row * C;
    const T* gv = vv + row * C;
    for (int i = lane; i < nvec; i += 32) {
      fbx::cp_async16(b + G::kLead + K * i, gs + K * i);
      fbx::cp_async16(b + L + G::kLead + K * i, gv + K * i);
    }
    fbx::cp_async_commit();
  };

  const int64_t stride = static_cast<int64_t>(gridDim.x) * nwarps;
  int64_t row = static_cast<int64_t>(blockIdx.x) * nwarps + warp;
  if (row < M) fetch(row, bufs);
  for (int it = 0; row < M; ++it, row += stride) {
    T* s_sh = bufs + (it & 1) * 2 * L;
    T* v_sh = s_sh + L;
    if (row + stride < M) {
      fetch(row + stride, bufs + ((it + 1) & 1) * 2 * L);
      fbx::cp_async_wait<1>();  // this row's group has landed
    } else {
      fbx::cp_async_wait<0>();
    }
    __syncwarp();

    // the row's segments, once: ds+ and dv of c = 0 .. C-2; none from C-1 on
    bool ascending = true;
    for (int i = lane; i < nvec; i += 32) {
      const int p = G::kLead + K * i;
      T s[K + 1], v[K + 1], d[K], e[K];
      VT::unpack(*reinterpret_cast<const V*>(s_sh + p), s);
      VT::unpack(*reinterpret_cast<const V*>(v_sh + p), v);
      s[K] = s_sh[p + K];
      v[K] = v_sh[p + K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T ds = fbx::sub_rn(s[k + 1], s[k]);
        ascending &= ds >= T(0);  // false for NaN
        d[k] = ds_plus(ds);
        e[k] = fbx::sub_rn(v[k + 1], v[k]);
      }
      if (i == nvec - 1) d[K - 1] = e[K - 1] = T(0);
      *reinterpret_cast<V*>(dsp_sh + p) = VT::pack(d);
      *reinterpret_cast<V*>(dv_sh + p) = VT::pack(e);
    }
    if (lane < G::kLead) v_sh[lane] = v_sh[G::kLead];  // v[max(t - band, 0)] of t < band
    ascending = __all_sync(0xffffffffu, ascending);  // (the halo after the row is +inf)
    __syncwarp();

    const T s_first = s_sh[G::kLead], s_last = s_sh[G::kLead + C - 1];
    const T fr = fill[row];
    T* orow = out + row * C;
    for (int t0 = K * lane; t0 < C; t0 += 32 * K) {
      T ws[G::kWin * K], wd[G::kWin * K], wdv[G::kWin * K], wv[G::kNV * K], zt[K], res[K];
#pragma unroll
      for (int i = 0; i < G::kWin; ++i) {
        VT::unpack(*reinterpret_cast<const V*>(s_sh + t0 + K * i), ws + K * i);
        VT::unpack(*reinterpret_cast<const V*>(dsp_sh + t0 + K * i), wd + K * i);
        VT::unpack(*reinterpret_cast<const V*>(dv_sh + t0 + K * i), wdv + K * i);
      }
#pragma unroll
      for (int i = 0; i < G::kNV; ++i)
        VT::unpack(*reinterpret_cast<const V*>(v_sh + t0 + K * (G::kV0 + i)), wv + K * i);
      VT::unpack(*reinterpret_cast<const V*>(z_sh + t0), zt);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        // window index of segment t + o is w0 + j + k, o = k - kBand
        constexpr int w0 = G::kLead - kBand;
        T acc = wv[w0 + j - K * G::kV0];
        if (ascending) {
          // the whole terms are the first `whole` segments; only the next one
          // can straddle z_t
          int whole = 0;
#pragma unroll
          for (int k = 0; k < kSeg; ++k) {
            if (whole_term(fbx::sub_rn(zt[j], ws[w0 + j + k]), wd[w0 + j + k])) {
              acc = fbx::add_rn(acc, wdv[w0 + j + k]);
              ++whole;
            }
          }
          if (whole < kSeg) {
            const int p = G::kLead + t0 + j - kBand + whole;
            const T a = fbx::sub_rn(zt[j], s_sh[p]);
            if (straddles(a, dsp_sh[p]))
              acc = fbx::add_rn(acc, fbx::mul_rn(dv_sh[p], fbx::div_rn(a, dsp_sh[p])));
          }
        } else {
          acc = sum_terms(acc, zt[j], s_sh + G::kLead, dsp_sh + G::kLead, dv_sh + G::kLead,
                          t0 + j - kBand, kSeg);
        }
        res[j] = (zt[j] >= s_first && zt[j] <= s_last) ? acc : fr;
      }
      *reinterpret_cast<V*>(orow + t0) = VT::pack(res);
    }
    __syncwarp();  // every lane is done with this row before its buffers are refilled
  }
}

template <typename T, int kBand>
cudaError_t launch_staged(const T* ss, const T* vv, const T* z, const T* fill, T* out, int64_t M,
                          int C, cudaStream_t stream) {
  const size_t per_warp = 6 * static_cast<size_t>(Banded<T, kBand>::row_len(C)) * sizeof(T);
  auto kern = banded_interp_staged<T, kBand>;
  int warps = 0;
  unsigned blocks = 0;
  size_t smem = 0;
  cudaError_t e = fbx::warp_rows_shape(kern, static_cast<size_t>(C) * sizeof(T), per_warp, M,
                                       &warps, &blocks, &smem);
  if (e != cudaSuccess) return e;
  kern<<<blocks, 32 * warps, smem, stream>>>(ss, vv, z, fill, out, M, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* ss, const T* vv, const T* z, const T* fill, T* out, int64_t M,
                   int64_t C, int band, int staged, cudaStream_t stream) {
  const int c = static_cast<int>(C);
  if (M == 0) return cudaSuccess;
  if (!staged) return launch_rows(ss, vv, z, fill, out, M, c, band, stream);
  if (C % 4 != 0) return cudaErrorInvalidValue;
  if (band == 2) return launch_staged<T, 2>(ss, vv, z, fill, out, M, c, stream);
  if (band == 4) return launch_staged<T, 4>(ss, vv, z, fill, out, M, c, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// ss, vv, out: (M, C) contiguous, each row of ss ascending with vv sorted
// alongside; z: (C,); fill: (M,); staged: 1 for the staged path (see above).
extern "C" int fbx_banded_interp_f32(const float* ss, const float* vv, const float* z,
                                     const float* fill, float* out, int64_t M, int64_t C,
                                     int band, int staged, void* stream) {
  return launch(ss, vv, z, fill, out, M, C, band, staged, static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_banded_interp_f64(const double* ss, const double* vv, const double* z,
                                     const double* fill, double* out, int64_t M, int64_t C,
                                     int band, int staged, void* stream) {
  return launch(ss, vv, z, fill, out, M, C, band, staged, static_cast<cudaStream_t>(stream));
}
