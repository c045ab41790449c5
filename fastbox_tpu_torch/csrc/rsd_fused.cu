// K2: wrap-fused periodic bracket interpolation for the RSD remap, and K7,
// the same scan on coordinates the caller already wrapped.
//
// K2 replaces fastbox_tpu/ops/pallas/rsd_fused.py::rsd_remap_wrap_pallas
// (_kernel_wrap -> _bracket_interp), the band-2 and band-4 tiers of
// ops/rsd.py::_remap_wrap_tiered.  K7 replaces rsd_bracket_interp_pallas
// (_kernel -> _bracket_interp), the fused branch of
// ops/rsd.py::remap_los_batched; it reads s instead of computing it from
// the velocity (the template flag kWrap).  Per line of sight (row) of C
// cells:
//   s = (z - v/H - z0) mod L + z0          (floor mod, torch.remainder)
//   out(t) = linear interp between the bracket nodes of z_t, found by a
//            circular scan over lane offsets o = -3B-1 .. 3B+2,
//   out(t) = fill outside [min s, max s]   (the griddata hull).
// The scan never sorts; it is exact whenever every node moved at most B
// cells (the caller checks max|v|/H <= B dz).  The window is two lanes wider
// than the unwrapped bound because the wrap period (C-1) dz differs from the
// roll period C (rsd_fused.py:28-35).  Tie rules follow rsd_fused.py:96-115:
// offsets ascend, the lower bracket updates for o <= B with >=, the upper
// for o >= -B with strict <.
//
// Bound on the card: instructions, not bytes.  Each row reads vel and vals
// once and writes out once (12 bytes per f32 cell), but every cell takes
// 6B+4 compare-selects on two nodes.  Both paths stage a row in shared
// memory with periodic halos (the lanes wrapped from the other end of the
// row, placed by a table the block builds once), so the scan reads node
// t + o at a fixed offset and does no modulo.
//
// The staged path (C a multiple of 4, B = 2 or 4, rows of at most 4096
// cells, 16-byte aligned arrays: the wrapper's rule, ops/cuda/rsd_fused.py
// staged_path) gives each row to one warp, several warps to a block and a
// row after row to each warp.  z is staged once per block.  A warp copies
// its next row into a second buffer with 16-byte cp.async while it works on
// the current one; it wraps the coordinates in place, takes the hull's min
// and max by shuffles (no block barrier), fills the halos, then each lane
// takes one 16-byte vector of targets (4 in f32, 2 in f64): it loads the
// node window those targets share into registers as 16-byte vectors, scans
// it once per target, and stores the results as one vector.  The direct
// path (any other row) gives each row to a block of threads.
// Arithmetic is explicitly rounded in both, so the result equals the plain
// PyTorch scan bit for bit.
#include "common.cuh"

namespace {

template <typename T>
struct Min {
  __device__ T operator()(T a, T b) const { return b < a ? b : a; }
};
template <typename T>
struct Max {
  __device__ T operator()(T a, T b) const { return b > a ? b : a; }
};

// The bracket pair of one target; node() takes the node at the next offset.
template <typename T>
struct Bracket {
  T s_lo, v_lo, s_hi, v_hi;
  __device__ __forceinline__ explicit Bracket(T big)
      : s_lo(-big), v_lo(T(0)), s_hi(big), v_hi(T(0)) {}
  __device__ __forceinline__ void node(T sc, T vc, T zt, bool lower, bool upper) {
    const bool below = sc <= zt;
    if (lower && below && sc >= s_lo) {
      s_lo = sc;
      v_lo = vc;
    }
    if (upper && !below && sc < s_hi) {
      s_hi = sc;
      v_hi = vc;
    }
  }
  __device__ __forceinline__ T value(T zt) const {
    const T frac = fbx::div_rn(fbx::sub_rn(zt, s_lo), fbx::sub_rn(s_hi, s_lo));
    return fbx::add_rn(v_lo, fbx::mul_rn(fbx::sub_rn(v_hi, v_lo), frac));
  }
};

template <typename T>
__device__ __forceinline__ T wrap_coord(T zc, T vel, T z0, T length, T inv_hz) {
  const T u = fbx::sub_rn(zc, fbx::mul_rn(vel, inv_hz));
  return fbx::add_rn(fbx::floor_mod(fbx::sub_rn(u, z0), length), z0);
}

// A staged row holds lane l at position lead + l, with `lead` periodic
// images before it and `tail` after.  Halo entry i sits at position i
// (i < lead) or C + i and holds lane (i - lead) mod C; the block computes
// the table once, so no row pays a modulo.
__device__ __forceinline__ void halo_table(int* src, int lead, int tail, int C) {
  for (int i = threadIdx.x; i < lead + tail; i += blockDim.x) {
    int l = (i - lead) % C;
    src[i] = l < 0 ? l + C : l;
  }
}

template <typename T>
__device__ __forceinline__ void fill_halo(T* s_sh, T* v_sh, const int* src, int lead, int tail,
                                          int C, int first, int step) {
  for (int i = first; i < lead + tail; i += step) {
    const int pos = i < lead ? i : C + i;
    s_sh[pos] = s_sh[lead + src[i]];
    v_sh[pos] = v_sh[lead + src[i]];
  }
}

// ---------------------------------------------------------------- direct
// One block per row (grid-stride over rows), any C and band.
template <typename T, bool kWrap>
__global__ void bracket_interp_rows(const T* __restrict__ vals, const T* __restrict__ coord,
                                    const T* __restrict__ z, const T* __restrict__ fill,
                                    const T* __restrict__ wrap, T* __restrict__ out, int64_t M,
                                    int C, int band) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lead = 3 * band + 1, tail = 3 * band + 2, L = lead + C + tail;
  T* s_sh = reinterpret_cast<T*>(smem_raw);
  T* v_sh = s_sh + L;
  int* src = reinterpret_cast<int*>(v_sh + L);
  __shared__ T scratch[32];
  halo_table(src, lead, tail, C);  // complete after block_reduce's barriers
  T z0 = T(0), length = T(0), inv_hz = T(0);
  if (kWrap) {
    z0 = wrap[0];
    length = wrap[1];
    inv_hz = wrap[2];
  }
  const T big = fbx::Limits<T>::max() / T(4);

  for (int64_t row = blockIdx.x; row < M; row += gridDim.x) {
    const T* vr = vals + row * C;
    const T* wr = coord + row * C;
    T lmin = fbx::Limits<T>::inf(), lmax = -fbx::Limits<T>::inf();
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const T s = kWrap ? wrap_coord(z[c], wr[c], z0, length, inv_hz) : wr[c];
      s_sh[lead + c] = s;
      v_sh[lead + c] = vr[c];
      lmin = s < lmin ? s : lmin;
      lmax = s > lmax ? s : lmax;
    }
    const T smin = fbx::block_reduce(lmin, scratch, Min<T>());
    const T smax = fbx::block_reduce(lmax, scratch, Max<T>());  // syncs: the row is staged
    fill_halo(s_sh, v_sh, src, lead, tail, C, threadIdx.x, blockDim.x);
    __syncthreads();

    for (int t = threadIdx.x; t < C; t += blockDim.x) {
      const T zt = z[t];
      Bracket<T> br(big);
      for (int o = -3 * band - 1; o <= 3 * band + 2; ++o)
        br.node(s_sh[lead + t + o], v_sh[lead + t + o], zt, o <= band, o >= -band);
      out[row * C + t] = (zt >= smin && zt <= smax) ? br.value(zt) : fill[row];
    }
    __syncthreads();  // the next row overwrites s_sh / v_sh
  }
}

template <typename T, bool kWrap>
cudaError_t launch_rows(const T* vals, const T* coord, const T* z, const T* fill, const T* wrap,
                        T* out, int64_t M, int C, int band, cudaStream_t stream) {
  const int threads = C >= 256 ? 256 : (C + 31) / 32 * 32;
  const int64_t blocks = M < (1 << 20) ? M : (1 << 20);
  const int L = 3 * band + 1 + C + 3 * band + 2;
  const size_t smem = 2 * static_cast<size_t>(L) * sizeof(T) + (6 * band + 3) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(bracket_interp_rows<T, kWrap>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  bracket_interp_rows<T, kWrap><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      vals, coord, z, fill, wrap, out, M, C, band);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- staged
// The staged row's geometry at band kBand: K targets per lane (one 16-byte
// vector); the scan reaches kLo lanes below a target and kHi above; the
// halos, kLead before the row and kTail after, are whole vectors, so a
// lane's window of kWin vectors (from kLead before its first target to kHi
// past its last) starts on a 16-byte boundary.
template <typename T, int kBand>
struct Staged {
  static constexpr int K = 16 / static_cast<int>(sizeof(T));
  static constexpr int kLo = 3 * kBand + 1, kHi = 3 * kBand + 2;
  static constexpr int kLead = (kLo + K - 1) / K * K;
  static constexpr int kWin = (kLead + K + kHi + K - 1) / K;
  static constexpr int kTail = kWin * K - kLead - K;
  static __host__ __device__ int row_len(int C) { return kLead + C + kTail; }
};

template <typename T, bool kWrap, int kBand>
__global__ void __launch_bounds__(256)
    bracket_interp_staged(const T* __restrict__ vals, const T* __restrict__ coord,
                          const T* __restrict__ z, const T* __restrict__ fill,
                          const T* __restrict__ wrap, T* __restrict__ out, int64_t M, int C) {
  using G = Staged<T, kBand>;
  using VT = fbx::Vec16<T>;
  using V = typename VT::type;
  constexpr int K = G::K;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = G::row_len(C);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  T* z_sh = reinterpret_cast<T*>(smem_raw);
  T* bufs = z_sh + C + static_cast<size_t>(warp) * 4 * L;  // [2 buffers][s, v][L]
  int* src = reinterpret_cast<int*>(z_sh + C + static_cast<size_t>(nwarps) * 4 * L);
  for (int c = threadIdx.x; c < C; c += blockDim.x) z_sh[c] = z[c];
  halo_table(src, G::kLead, G::kTail, C);
  __syncthreads();  // the block's only barrier
  T z0 = T(0), length = T(0), inv_hz = T(0);
  if (kWrap) {
    z0 = wrap[0];
    length = wrap[1];
    inv_hz = wrap[2];
  }
  const T big = fbx::Limits<T>::max() / T(4);
  const int nvec = C / K;

  // the row's coordinates (or velocities) and values into buffer b
  auto fetch = [&](int64_t row, T* b) {
    const T* gs = coord + row * C;
    const T* gv = vals + row * C;
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

    // wrap in place (K2), and the hull
    T lmin = fbx::Limits<T>::inf(), lmax = -fbx::Limits<T>::inf();
    for (int i = lane; i < nvec; i += 32) {
      V* p = reinterpret_cast<V*>(s_sh + G::kLead + K * i);
      T s[K];
      VT::unpack(*p, s);
      if (kWrap) {
        T zc[K];
        VT::unpack(*reinterpret_cast<const V*>(z_sh + K * i), zc);
#pragma unroll
        for (int j = 0; j < K; ++j) s[j] = wrap_coord(zc[j], s[j], z0, length, inv_hz);
        *p = VT::pack(s);
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        lmin = s[j] < lmin ? s[j] : lmin;
        lmax = s[j] > lmax ? s[j] : lmax;
      }
    }
    const T smin = fbx::warp_reduce(lmin, Min<T>());
    const T smax = fbx::warp_reduce(lmax, Max<T>());
    __syncwarp();
    fill_halo(s_sh, v_sh, src, G::kLead, G::kTail, C, lane, 32);
    __syncwarp();

    const T fr = fill[row];
    T* orow = out + row * C;
    for (int t0 = K * lane; t0 < C; t0 += 32 * K) {
      T ws[G::kWin * K], wv[G::kWin * K], zt[K], res[K];
#pragma unroll
      for (int i = 0; i < G::kWin; ++i) {
        VT::unpack(*reinterpret_cast<const V*>(s_sh + t0 + K * i), ws + K * i);
        VT::unpack(*reinterpret_cast<const V*>(v_sh + t0 + K * i), wv + K * i);
      }
      VT::unpack(*reinterpret_cast<const V*>(z_sh + t0), zt);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        Bracket<T> br(big);
#pragma unroll
        for (int o = -G::kLo; o <= G::kHi; ++o)
          br.node(ws[G::kLead + j + o], wv[G::kLead + j + o], zt[j], o <= kBand, o >= -kBand);
        res[j] = (zt[j] >= smin && zt[j] <= smax) ? br.value(zt[j]) : fr;
      }
      *reinterpret_cast<V*>(orow + t0) = VT::pack(res);
    }
    __syncwarp();  // every lane is done with this buffer before it is refilled
  }
}

template <typename T, bool kWrap, int kBand>
cudaError_t launch_staged(const T* vals, const T* coord, const T* z, const T* fill, const T* wrap,
                          T* out, int64_t M, int C, cudaStream_t stream) {
  using G = Staged<T, kBand>;
  const size_t per_warp = 4 * static_cast<size_t>(G::row_len(C)) * sizeof(T);
  const size_t fixed = static_cast<size_t>(C) * sizeof(T) + (G::kLead + G::kTail) * sizeof(int);
  auto kern = bracket_interp_staged<T, kWrap, kBand>;
  int warps = 0;
  unsigned blocks = 0;
  size_t smem = 0;
  cudaError_t e = fbx::warp_rows_shape(kern, fixed, per_warp, M, &warps, &blocks, &smem);
  if (e != cudaSuccess) return e;
  kern<<<blocks, 32 * warps, smem, stream>>>(vals, coord, z, fill, wrap, out, M, C);
  return cudaGetLastError();
}

template <typename T, bool kWrap>
cudaError_t launch(const T* vals, const T* coord, const T* z, const T* fill, const T* wrap, T* out,
                   int64_t M, int64_t C, int band, int staged, cudaStream_t stream) {
  const int c = static_cast<int>(C);
  if (M == 0) return cudaSuccess;
  if (!staged) return launch_rows<T, kWrap>(vals, coord, z, fill, wrap, out, M, c, band, stream);
  if (C % 4 != 0) return cudaErrorInvalidValue;
  if (band == 2) return launch_staged<T, kWrap, 2>(vals, coord, z, fill, wrap, out, M, c, stream);
  if (band == 4) return launch_staged<T, kWrap, 4>(vals, coord, z, fill, wrap, out, M, c, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// vals, vel, out: (M, C) contiguous; z: (C,); fill: (M,); wrap: device
// (z0, length_z, 1/H) triple; staged: 1 for the staged path (see above).
extern "C" int fbx_rsd_remap_wrap_f32(const float* vals, const float* vel, const float* z,
                                      const float* fill, const float* wrap, float* out, int64_t M,
                                      int64_t C, int band, int staged, void* stream) {
  return launch<float, true>(vals, vel, z, fill, wrap, out, M, C, band, staged,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_rsd_remap_wrap_f64(const double* vals, const double* vel, const double* z,
                                      const double* fill, const double* wrap, double* out,
                                      int64_t M, int64_t C, int band, int staged, void* stream) {
  return launch<double, true>(vals, vel, z, fill, wrap, out, M, C, band, staged,
                              static_cast<cudaStream_t>(stream));
}

// K7.  s, v, out: (M, C) contiguous, s already wrapped; z: (C,); fill: (M,).
extern "C" int fbx_rsd_bracket_interp_f32(const float* s, const float* v, const float* z,
                                          const float* fill, float* out, int64_t M, int64_t C,
                                          int band, int staged, void* stream) {
  return launch<float, false>(v, s, z, fill, nullptr, out, M, C, band, staged,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_rsd_bracket_interp_f64(const double* s, const double* v, const double* z,
                                          const double* fill, double* out, int64_t M, int64_t C,
                                          int band, int staged, void* stream) {
  return launch<double, false>(v, s, z, fill, nullptr, out, M, C, band, staged,
                               static_cast<cudaStream_t>(stream));
}
