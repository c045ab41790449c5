// K3: piecewise-linear interpolation of per-row sorted nodes at shared
// targets, with the griddata hull fill.
//
// Replaces fastbox_tpu/ops/pallas/rsd_interp.py::interp_sorted_pallas
// (_kernel), the exact tier of ops/rsd.py::_remap_wrap_tiered (after a
// per-row stable sort, which stays outside the kernel as in JAX).
//
// The TPU kernel evaluates the telescoping sum
//   out(t) = v_0 + sum_c (v_{c+1} - v_c) clamp((z_t - s_c)/(s_{c+1} - s_c), 0, 1)
// over all C-1 segments: O(C) work per target, which suits a vector unit
// with no gathers.  Here each target binary-searches its bracket segment in
// shared memory instead: j = the last node with s_j <= z_t, and
//   out(t) = v_j + (v_{j+1} - v_j) (z_t - s_j)/(s_{j+1} - s_j),
// the same function (O(log C) work).  Taking the LAST node <= z_t matches the
// telescoping form's duplicate rule: on equal coordinates the value switches
// at the last duplicate.  Targets outside [s_0, s_{C-1}] get the row's fill
// (rsd_interp.py:48-49).
//
// Bound on the card: memory.  One read of the sorted row pair and one
// write per target; the search is ~log2(C) shared-memory reads.  Design:
// one block per row (grid-stride over rows), the row staged in shared memory.
#include "common.cuh"

namespace {

template <typename T>
__global__ void interp_sorted_kernel(const T* __restrict__ ss, const T* __restrict__ vv,
                                     const T* __restrict__ z, const T* __restrict__ fill,
                                     T* __restrict__ out, int64_t M, int C, int Tn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_sh = reinterpret_cast<T*>(smem_raw);
  T* v_sh = s_sh + C;
  for (int64_t row = blockIdx.x; row < M; row += gridDim.x) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      s_sh[c] = ss[row * C + c];
      v_sh[c] = vv[row * C + c];
    }
    __syncthreads();
    const T s_first = s_sh[0], s_last = s_sh[C - 1], f = fill[row];
    for (int t = threadIdx.x; t < Tn; t += blockDim.x) {
      const T zt = z[t];
      T res = f;
      if (zt >= s_first && zt <= s_last) {
        int lo = 0, hi = C;  // first index with s > zt
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_sh[mid] <= zt) lo = mid + 1; else hi = mid;
        }
        const int j = lo - 1;  // >= 0 because s_first <= zt
        if (j >= C - 1) {
          res = v_sh[C - 1];
        } else {
          const T frac = fbx::div_rn(fbx::sub_rn(zt, s_sh[j]), fbx::sub_rn(s_sh[j + 1], s_sh[j]));
          res = fbx::add_rn(v_sh[j], fbx::mul_rn(fbx::sub_rn(v_sh[j + 1], v_sh[j]), frac));
        }
      }
      out[row * Tn + t] = res;
    }
    __syncthreads();  // the next row overwrites the shared row
  }
}

template <typename T>
cudaError_t launch(const T* ss, const T* vv, const T* z, const T* fill, T* out, int64_t M,
                   int64_t C, int64_t Tn, cudaStream_t stream) {
  const int64_t width = C > Tn ? C : Tn;
  const int threads = width >= 256 ? 256 : static_cast<int>((width + 31) / 32 * 32);
  const int64_t blocks = M < (1 << 20) ? M : (1 << 20);
  const size_t smem = 2 * static_cast<size_t>(C) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(interp_sorted_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  interp_sorted_kernel<T><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      ss, vv, z, fill, out, M, static_cast<int>(C), static_cast<int>(Tn));
  return cudaGetLastError();
}

}  // namespace

// ss, vv: (M, C) contiguous, rows sorted ascending by ss; z: (Tn,);
// fill: (M,); out: (M, Tn).
extern "C" int fbx_interp_sorted_f32(const float* ss, const float* vv, const float* z,
                                     const float* fill, float* out, int64_t M, int64_t C,
                                     int64_t Tn, void* stream) {
  return launch(ss, vv, z, fill, out, M, C, Tn, static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_interp_sorted_f64(const double* ss, const double* vv, const double* z,
                                     const double* fill, double* out, int64_t M, int64_t C,
                                     int64_t Tn, void* stream) {
  return launch(ss, vv, z, fill, out, M, C, Tn, static_cast<cudaStream_t>(stream));
}
