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
// Philox4x32-10 keyed by (seed, group) yields four 32-bit words per group of
// four elements; Box-Muller turns each pair of words into two normals, both
// used.  Group g covers elements g, g+G, g+2G, g+3G (G = ceil(n/4)), so for
// each of the four a warp touches 32 consecutive elements.  The seed is read
// from device memory, so drawing it from a torch.Generator needs no host
// sync.  The max is a block reduction plus one atomicMax on the float bits,
// which orders like the values because |y| >= 0: the result is exact and
// independent of block order.  In supplied-normals mode the kernel reads n
// instead of generating it and rounds exactly like x + scale * n in PyTorch.
#include "common.cuh"

namespace {

struct U4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ U4 philox4x32_10(U4 c, uint32_t k0, uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = U4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
    k0 += W0;
    k1 += W1;
  }
  return c;
}

__device__ __forceinline__ void sincospi_t(float x, float* s, float* c) { sincospif(x, s, c); }
__device__ __forceinline__ void sincospi_t(double x, double* s, double* c) { sincospi(x, s, c); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

// Two independent N(0,1) values from two 32-bit words: 24-bit uniforms,
// u1 in (0, 1) (never 0, so the log is finite) and u2 in [0, 1).
template <typename T>
__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, T& n1, T& n2) {
  const T u1 = T(a >> 8) * T(5.9604644775390625e-08) + T(2.98023223876953125e-08);
  const T u2 = T(b >> 8) * T(5.9604644775390625e-08);
  const T r = sqrt_t(T(-2) * log_t(u1));
  T s, c;
  sincospi_t(T(2) * u2, &s, &c);
  n1 = r * c;
  n2 = r * s;
}

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
  if (normals == nullptr) {
    const uint64_t s = static_cast<uint64_t>(seed[0]);
    k0 = static_cast<uint32_t>(s);
    k1 = static_cast<uint32_t>(s >> 32);
  }
  const int64_t G = (n + 3) / 4;
  const NanMax<T> nanmax;
  T m = T(0);
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; g < G;
       g += (int64_t)gridDim.x * blockDim.x) {
    T nv[4];
    if (normals == nullptr) {
      const U4 r = philox4x32_10(
          U4{static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32), 0u, 0u}, k0, k1);
      box_muller(r.x, r.y, nv[0], nv[1]);
      box_muller(r.z, r.w, nv[2], nv[3]);
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
  const int64_t G = (n + 3) / 4;
  const int threads = 256;
  int64_t blocks = (G + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond ~32 blocks per SM
  if (blocks < 1) blocks = 1;
  add_scaled_normal_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
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
