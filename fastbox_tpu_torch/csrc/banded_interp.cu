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
// Bound on the card: memory.  Each row reads s and v once and writes out
// once (12 bytes per f32 cell); the 2*band segment terms read shared memory
// only (~10 flops and one division each).  Design: one block per row
// (grid-stride over rows); the block stages s and v in shared memory, then
// each thread sums the segments of its targets in the twin's order, offsets
// ascending, with explicit rounding, so the result equals the plain PyTorch
// version bit for bit.  Neighbouring threads read neighbouring shared words
// at every offset: no bank conflicts.
#include "common.cuh"

namespace {

template <typename T>
__global__ void banded_interp_kernel(const T* __restrict__ ss, const T* __restrict__ vv,
                                     const T* __restrict__ z, const T* __restrict__ fill,
                                     T* __restrict__ out, int64_t M, int C, int band) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_sh = reinterpret_cast<T*>(smem_raw);
  T* v_sh = s_sh + C;

  for (int64_t row = blockIdx.x; row < M; row += gridDim.x) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      s_sh[c] = ss[row * C + c];
      v_sh[c] = vv[row * C + c];
    }
    __syncthreads();
    const T s_first = s_sh[0], s_last = s_sh[C - 1];

    for (int t = threadIdx.x; t < C; t += blockDim.x) {
      const T zt = z[t];
      T acc = v_sh[t >= band ? t - band : 0];
      for (int o = -band; o < band; ++o) {
        const int c = t + o;
        T term = T(0);
        if (c >= 0 && c <= C - 2) {
          const T sc = s_sh[c];
          const T ds = fbx::sub_rn(s_sh[c + 1], sc);
          const T dv = fbx::sub_rn(v_sh[c + 1], v_sh[c]);
          T frac;
          if (ds > T(0)) {
            frac = fbx::div_rn(fbx::sub_rn(zt, sc), ds);
          } else {
            frac = zt >= sc ? T(1) : T(0);
          }
          const T w = frac < T(0) ? T(0) : (frac > T(1) ? T(1) : frac);
          term = fbx::mul_rn(dv, w);
        }
        acc = fbx::add_rn(acc, term);
      }
      out[row * C + t] = (zt >= s_first && zt <= s_last) ? acc : fill[row];
    }
    __syncthreads();  // the next row overwrites s_sh / v_sh
  }
}

template <typename T>
cudaError_t launch(const T* ss, const T* vv, const T* z, const T* fill, T* out, int64_t M,
                   int64_t C, int band, cudaStream_t stream) {
  const int threads = C >= 256 ? 256 : static_cast<int>((C + 31) / 32 * 32);
  const int64_t blocks = M < (1 << 20) ? M : (1 << 20);
  const size_t smem = 2 * static_cast<size_t>(C) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(banded_interp_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  banded_interp_kernel<T><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      ss, vv, z, fill, out, M, static_cast<int>(C), band);
  return cudaGetLastError();
}

}  // namespace

// ss, vv, out: (M, C) contiguous, each row of ss ascending with vv sorted
// alongside; z: (C,); fill: (M,).
extern "C" int fbx_banded_interp_f32(const float* ss, const float* vv, const float* z,
                                     const float* fill, float* out, int64_t M, int64_t C,
                                     int band, void* stream) {
  return launch(ss, vv, z, fill, out, M, C, band, static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_banded_interp_f64(const double* ss, const double* vv, const double* z,
                                     const double* fill, double* out, int64_t M, int64_t C,
                                     int band, void* stream) {
  return launch(ss, vv, z, fill, out, M, C, band, static_cast<cudaStream_t>(stream));
}
