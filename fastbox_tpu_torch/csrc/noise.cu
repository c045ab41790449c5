// K1: fused add-scaled-Gaussian-noise, out = x + scale[c] * N(0,1).
//
// Replaces fastbox_tpu/ops/pallas/noise.py::add_scaled_normal_pallas
// (_kernel, _kernel_max).  Two pipeline stages use it: the sigma_NL
// velocity dispersion, whose max|out| is the RSD displacement bound, and
// the radiometer noise.
//
// Bound on the card: memory.  One read of x and one write of out (8 bytes
// per f32 element; 134 MB at 256^3), plus one read of the normals when they
// are supplied; Philox and Box-Muller cost ~40 instructions per element,
// below the H100's compute rate at that traffic.  Design: the work goes in
// units of four consecutive elements of a row.  A block covers whole rows,
// `lanes` threads to a row, so a thread finds its column once, keeps its
// unit's four scales in registers, and indexes each element as row * C + c
// with no division in the loop.  Where C is a multiple of 4 and every
// array starts on a 16-byte boundary (the wrapper's rule, ops/cuda/noise.py
// vector_path), a unit is one 16-byte access per array (float4, or two
// double2); else the direct path reads and writes it element by element.
// The normals never touch device memory: one counter-based Philox4x32-10
// call (common.cuh, shared with K9) per unit, counter (unit, row), key the
// seed, gives four words, and Box-Muller turns each pair into two normals,
// both used.  The counter of an element depends only on its row and column,
// so both paths draw the same bits.  The seed is read from device memory,
// so drawing it from a torch.Generator needs no host sync.  The max is a
// block reduction (warp shuffles, then one pass over the warps) and one
// atomicMax on the float bits, which orders like the values because
// |y| >= 0: the result is exact and independent of block order.  In
// supplied-normals mode the kernel reads n instead of generating it and
// rounds exactly like x + scale * n in PyTorch (no FMA).
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

// Four consecutive elements as 16-byte accesses (p 16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double v[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// Four normals for columns 4u .. 4u+3 of a row.
template <typename T>
__device__ __forceinline__ void normal4(int64_t row, int u, uint32_t k0, uint32_t k1, T nv[4]) {
  const fbx::U4 r = fbx::philox4x32_10(
      fbx::U4{static_cast<uint32_t>(u), static_cast<uint32_t>(row),
              static_cast<uint32_t>(row >> 32), 0u},
      k0, k1);
  fbx::box_muller(r.x, r.y, nv[0], nv[1]);
  fbx::box_muller(r.z, r.w, nv[2], nv[3]);
}

// (R, C) as units of four columns, U = ceil(C / 4) per row; `lanes` threads
// share a row (every unit when U <= blockDim, else a stride of them) and a
// block takes blockDim / lanes rows per pass.
template <typename T, bool kVec>
__global__ void add_scaled_normal_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                                         const T* __restrict__ normals,
                                         const int64_t* __restrict__ seed, T* __restrict__ out,
                                         T* __restrict__ maxabs, int64_t R, int C, int lanes) {
  __shared__ T scratch[32];
  uint32_t k0 = 0, k1 = 0;
  if (normals == nullptr) fbx::seed_key(seed, k0, k1);
  const int U = (C + 3) / 4;
  const int rows_per_pass = blockDim.x / lanes;
  const int tr = threadIdx.x / lanes;   // once per thread, not per element
  const int tu = threadIdx.x - tr * lanes;
  const bool one_unit = lanes == U;     // the thread's unit is the same in every row
  const NanMax<T> nanmax;
  T m = T(0);
  T sv[4] = {T(0), T(0), T(0), T(0)};
  if (one_unit && kVec) load4(scale + 4 * tu, sv);
  if (tr < rows_per_pass) {
    for (int64_t row = blockIdx.x * static_cast<int64_t>(rows_per_pass) + tr; row < R;
         row += static_cast<int64_t>(gridDim.x) * rows_per_pass) {
      for (int u = tu; u < U; u += lanes) {
        const int c = 4 * u;
        const int64_t base = row * C + c;
        T nv[4];
        if (normals == nullptr) normal4(row, u, k0, k1, nv);
        if (kVec) {
          if (!one_unit) load4(scale + c, sv);
          T xv[4], y[4];
          load4(x + base, xv);
          if (normals != nullptr) load4(normals + base, nv);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            y[j] = fbx::add_rn(xv[j], fbx::mul_rn(sv[j], nv[j]));
            m = nanmax(m, fbx::abs_t(y[j]));
          }
          store4(out + base, y);
        } else {
          const int n = C - c < 4 ? C - c : 4;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < n) {
              const T nj = normals != nullptr ? normals[base + j] : nv[j];
              const T y = fbx::add_rn(x[base + j], fbx::mul_rn(scale[c + j], nj));
              out[base + j] = y;
              m = nanmax(m, fbx::abs_t(y));
            }
          }
        }
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
                   T* maxabs, int64_t R, int64_t C, int vec, cudaStream_t stream) {
  const int threads = 256;
  const int U = static_cast<int>((C + 3) / 4);
  const int lanes = U < threads ? U : threads;
  const int rows_per_pass = threads / lanes;
  int64_t blocks = (R + rows_per_pass - 1) / rows_per_pass;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  if (vec)
    add_scaled_normal_kernel<T, true><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        x, scale, normals, seed, out, maxabs, R, static_cast<int>(C), lanes);
  else
    add_scaled_normal_kernel<T, false><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        x, scale, normals, seed, out, maxabs, R, static_cast<int>(C), lanes);
  return cudaGetLastError();
}

}  // namespace

// x, out: (R, C) contiguous; scale: (C,); normals: (R, C) or NULL to draw
// them from `seed` (device int64, read only when normals is NULL); maxabs:
// one element initialised to 0, or NULL; vec: 1 for 16-byte accesses (C a
// multiple of 4, every array 16-byte aligned), 0 for the direct path.
extern "C" int fbx_add_scaled_normal_f32(const float* x, const float* scale, const float* normals,
                                         const int64_t* seed, float* out, float* maxabs, int64_t R,
                                         int64_t C, int vec, void* stream) {
  return launch(x, scale, normals, seed, out, maxabs, R, C, vec, static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_add_scaled_normal_f64(const double* x, const double* scale,
                                         const double* normals, const int64_t* seed, double* out,
                                         double* maxabs, int64_t R, int64_t C, int vec,
                                         void* stream) {
  return launch(x, scale, normals, seed, out, maxabs, R, C, vec, static_cast<cudaStream_t>(stream));
}

extern "C" const char* fbx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
