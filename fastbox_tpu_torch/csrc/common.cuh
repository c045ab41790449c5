// Shared helpers for the fastbox_tpu_torch Hopper kernels.
//
// Every kernel is exposed through a plain C function that launches on the
// caller's stream and returns cudaGetLastError(); the Python wrappers load
// the shared library with ctypes and raise on a non-zero code.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fbx {

// Explicitly rounded arithmetic.  nvcc contracts a*b+c into one FMA by
// default; the plain PyTorch twins round the product and the sum
// separately, so the kernels spell each rounding out to agree with them
// bit for bit.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }
__device__ __forceinline__ float fmod_t(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double fmod_t(double a, double b) { return fmod(a, b); }

// torch.remainder / jnp.mod for floats: fmod (exact), then shifted into
// the sign of the divisor.
template <typename T>
__device__ __forceinline__ T floor_mod(T a, T b) {
  T r = fmod_t(a, b);
  if (r != T(0) && ((r < T(0)) != (b < T(0)))) r = add_rn(r, b);
  return r;
}

template <typename T> struct Limits;
template <> struct Limits<float> {
  __device__ static float max() { return 3.402823466e+38f; }
  __device__ static float inf() { return __int_as_float(0x7f800000); }
};
template <> struct Limits<double> {
  __device__ static double max() { return 1.7976931348623157e+308; }
  __device__ static double inf() { return __longlong_as_double(0x7ff0000000000000LL); }
};

// Block-wide reduction over blockDim.x threads (a multiple of 32, at most
// 1024) for an idempotent op (min, max): lanes past the last warp repeat
// scratch[0].  `scratch` holds 32 values; every thread gets the result.
template <typename T, typename Op>
__device__ T block_reduce(T v, T* scratch, Op op) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, off));
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? scratch[lane] : scratch[0];
    for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  return scratch[0];
}

}  // namespace fbx

extern "C" const char* fbx_error_string(int err);
