// K1: fused add-scaled-Gaussian-noise, out = x + scale[c] * N(0,1).
//
// Replaces fastbox_tpu/ops/pallas/noise.py::add_scaled_normal_pallas
// (_kernel, _kernel_max).  Two pipeline stages use it: the sigma_NL
// velocity dispersion, whose max|out| is the RSD displacement bound, and
// the radiometer noise.
//
// Bound on the card: memory.  One read of x and one write of out (8 bytes
// per f32 element; 134 MB at 256^3); Philox and Box-Muller cost ~40
// instructions per element, far below the H100's compute rate at that
// traffic.  Design: the normals never touch device memory.  A counter-based
// Philox4x32-10 (common.cuh, shared with K9) keyed by (seed, group) yields
// four 32-bit words per group of four elements; Box-Muller turns each pair
// of words into two normals, both used.  Group g covers elements g, g+G, g+2G, g+3G (G = ceil(n/4)), so for
// each of the four a warp touches 32 consecutive elements.  The seed is read
// from device memory, so drawing it from a torch.Generator needs no host
// sync.  The max is a block reduction plus one atomicMax on the float bits,
// which orders like the values because |y| >= 0: the result is exact and
// independent of block order.  In supplied-normals mode the kernel reads n
// instead of generating it and rounds exactly like x + scale * n in PyTorch.
#include "common.cuh"

namespace {

__device__ __forceinline__ void atomic_max_nonneg(float* addr, float v) {
  atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}
__device__ __forceinline__ void atomic_max_nonneg(double* addr, double v) {
  atomicMax(reinterpret_cast<unsigned long long*>(addr),
            static_cast<unsigned long long>(__double_as_longlong(v)));
}

// max that propagates NaN, like torch.max
template <typename T>
struct NanMax {
  __device__ T operator()(T a, T b) const { return (b > a || b != b) ? b : a; }
};

template <typename T>
__global__ void add_scaled_normal_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                                         const T* __restrict__ normals,
                                         const int64_t* __restrict__ seed, T* __restrict__ out,
                                         T* __restrict__ maxabs, int64_t n, int64_t C) {
  __shared__ T scratch[32];
  uint32_t k0 = 0, k1 = 0;
  if (normals == nullptr) fbx::seed_key(seed, k0, k1);
  const int64_t G = (n + 3) / 4;
  const NanMax<T> nanmax;
  T m = T(0);
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; g < G;
       g += (int64_t)gridDim.x * blockDim.x) {
    T nv[4];
    if (normals == nullptr) {
      const fbx::U4 r = fbx::philox4x32_10(
          fbx::U4{static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32), 0u, 0u}, k0, k1);
      fbx::box_muller(r.x, r.y, nv[0], nv[1]);
      fbx::box_muller(r.z, r.w, nv[2], nv[3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t e = g + j * G;
      if (e < n) {
        const T nj = normals != nullptr ? normals[e] : nv[j];
        const T y = fbx::add_rn(x[e], fbx::mul_rn(scale[e % C], nj));
        out[e] = y;
        m = nanmax(m, fbx::abs_t(y));
      }
    }
  }
  if (maxabs != nullptr) {
    m = fbx::block_reduce(m, scratch, nanmax);
    if (threadIdx.x == 0) atomic_max_nonneg(maxabs, m);
  }
}

template <typename T>
cudaError_t launch(const T* x, const T* scale, const T* normals, const int64_t* seed, T* out,
                   T* maxabs, int64_t R, int64_t C, cudaStream_t stream) {
  const int64_t n = R * C;
  const int threads = 256;
  add_scaled_normal_kernel<T><<<fbx::grid_blocks((n + 3) / 4, threads), threads, 0, stream>>>(
      x, scale, normals, seed, out, maxabs, n, C);
  return cudaGetLastError();
}

}  // namespace

// x, out: (R, C) contiguous; scale: (C,); normals: (R, C) or NULL to draw
// them from `seed` (device int64, read only when normals is NULL); maxabs:
// one element initialised to 0, or NULL.
extern "C" int fbx_add_scaled_normal_f32(const float* x, const float* scale, const float* normals,
                                         const int64_t* seed, float* out, float* maxabs, int64_t R,
                                         int64_t C, void* stream) {
  return launch(x, scale, normals, seed, out, maxabs, R, C, static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_add_scaled_normal_f64(const double* x, const double* scale,
                                         const double* normals, const int64_t* seed, double* out,
                                         double* maxabs, int64_t R, int64_t C, void* stream) {
  return launch(x, scale, normals, seed, out, maxabs, R, C, static_cast<cudaStream_t>(stream));
}

extern "C" const char* fbx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
