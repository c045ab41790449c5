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
// Bound on the card: memory and latency of one row at a time.  Each row
// reads vel and vals once (8 bytes per f32 cell) and writes out once; the
// 6B+4 scan steps read shared memory only (~200 flops per cell at B=4).
// Design: one block per row (grid-stride over rows); the block computes the
// wrapped coordinates straight into shared memory, reduces min/max for the
// hull, then each thread scans for its targets.  Neighbouring threads read
// neighbouring shared words at every offset, so the scan is free of bank
// conflicts.  Arithmetic is explicitly rounded so that the result equals
// the plain PyTorch scan bit for bit.
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

// coord: the velocity (kWrap, K2) or the wrapped coordinate (K7); wrap is
// read only with kWrap.
template <typename T, bool kWrap>
__global__ void bracket_interp_kernel(const T* __restrict__ vals, const T* __restrict__ coord,
                                      const T* __restrict__ z, const T* __restrict__ fill,
                                      const T* __restrict__ wrap, T* __restrict__ out,
                                      int64_t M, int C, int band) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_sh = reinterpret_cast<T*>(smem_raw);
  T* v_sh = s_sh + C;
  __shared__ T scratch[32];
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
      T s;
      if (kWrap) {
        const T u = fbx::sub_rn(z[c], fbx::mul_rn(wr[c], inv_hz));
        s = fbx::add_rn(fbx::floor_mod(fbx::sub_rn(u, z0), length), z0);
      } else {
        s = wr[c];
      }
      s_sh[c] = s;
      v_sh[c] = vr[c];
      lmin = s < lmin ? s : lmin;
      lmax = s > lmax ? s : lmax;
    }
    const T smin = fbx::block_reduce(lmin, scratch, Min<T>());
    const T smax = fbx::block_reduce(lmax, scratch, Max<T>());  // syncs: s_sh is complete

    for (int t = threadIdx.x; t < C; t += blockDim.x) {
      const T zt = z[t];
      T s_lo = -big, v_lo = T(0), s_hi = big, v_hi = T(0);
      for (int o = -3 * band - 1; o <= 3 * band + 2; ++o) {
        int lane = (t + o) % C;
        if (lane < 0) lane += C;
        const T sc = s_sh[lane];
        const T vc = v_sh[lane];
        const bool below = sc <= zt;
        if (o <= band && below && sc >= s_lo) {
          s_lo = sc;
          v_lo = vc;
        }
        if (o >= -band && !below && sc < s_hi) {
          s_hi = sc;
          v_hi = vc;
        }
      }
      const T frac = fbx::div_rn(fbx::sub_rn(zt, s_lo), fbx::sub_rn(s_hi, s_lo));
      const T val = fbx::add_rn(v_lo, fbx::mul_rn(fbx::sub_rn(v_hi, v_lo), frac));
      out[row * C + t] = (zt >= smin && zt <= smax) ? val : fill[row];
    }
    __syncthreads();  // the next row overwrites s_sh / v_sh
  }
}

template <typename T, bool kWrap>
cudaError_t launch(const T* vals, const T* coord, const T* z, const T* fill, const T* wrap, T* out,
                   int64_t M, int64_t C, int band, cudaStream_t stream) {
  const int threads = C >= 256 ? 256 : static_cast<int>((C + 31) / 32 * 32);
  const int64_t blocks = M < (1 << 20) ? M : (1 << 20);
  const size_t smem = 2 * static_cast<size_t>(C) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(bracket_interp_kernel<T, kWrap>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  bracket_interp_kernel<T, kWrap><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      vals, coord, z, fill, wrap, out, M, static_cast<int>(C), band);
  return cudaGetLastError();
}

}  // namespace

// vals, vel, out: (M, C) contiguous; z: (C,); fill: (M,); wrap: device
// (z0, length_z, 1/H) triple.
extern "C" int fbx_rsd_remap_wrap_f32(const float* vals, const float* vel, const float* z,
                                      const float* fill, const float* wrap, float* out, int64_t M,
                                      int64_t C, int band, void* stream) {
  return launch<float, true>(vals, vel, z, fill, wrap, out, M, C, band,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_rsd_remap_wrap_f64(const double* vals, const double* vel, const double* z,
                                      const double* fill, const double* wrap, double* out,
                                      int64_t M, int64_t C, int band, void* stream) {
  return launch<double, true>(vals, vel, z, fill, wrap, out, M, C, band,
                              static_cast<cudaStream_t>(stream));
}

// K7.  s, v, out: (M, C) contiguous, s already wrapped; z: (C,); fill: (M,).
extern "C" int fbx_rsd_bracket_interp_f32(const float* s, const float* v, const float* z,
                                          const float* fill, float* out, int64_t M, int64_t C,
                                          int band, void* stream) {
  return launch<float, false>(v, s, z, fill, nullptr, out, M, C, band,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_rsd_bracket_interp_f64(const double* s, const double* v, const double* z,
                                          const double* fill, double* out, int64_t M, int64_t C,
                                          int band, void* stream) {
  return launch<double, false>(v, s, z, fill, nullptr, out, M, C, band,
                               static_cast<cudaStream_t>(stream));
}
