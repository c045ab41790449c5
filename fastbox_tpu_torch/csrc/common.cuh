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

// The counter-based random stream of K1 and K9: Philox4x32-10 turns a
// 128-bit counter and a 64-bit key into four 32-bit words.
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

// The Philox key: the two halves of a seed drawn on the device (no host sync).
__device__ __forceinline__ void seed_key(const int64_t* seed, uint32_t& k0, uint32_t& k1) {
  const uint64_t s = static_cast<uint64_t>(seed[0]);
  k0 = static_cast<uint32_t>(s);
  k1 = static_cast<uint32_t>(s >> 32);
}

__device__ __forceinline__ void sincospi_t(float x, float* s, float* c) { sincospif(x, s, c); }
__device__ __forceinline__ void sincospi_t(double x, double* s, double* c) { sincospi(x, s, c); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

// Two independent N(0,1) values from two 32-bit words: 24-bit uniforms,
// u1 in (0, 1) (never 0, so the log is finite) and u2 in [0, 1); n1 is the
// cos branch, n2 the sin branch.
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

// Grid-stride launch size for one thread per item: at most ~32 blocks per
// SM of the H100's 132, at least one.
__host__ inline unsigned grid_blocks(int64_t items, int threads) {
  int64_t blocks = (items + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

// out[k] = sum over blocks of partial[block][k] for k < nk; one block of
// 256 threads per k: strided sums, then a fixed shared-memory tree, so the
// result is the same on every run.
template <int kThreads = 256>
__global__ void sum_partials_kernel(const double* __restrict__ partial, double* __restrict__ out,
                                    int nblocks, int nk) {
  __shared__ double sh[kThreads];
  const int k = blockIdx.x;
  double s = 0.0;
  for (int g = threadIdx.x; g < nblocks; g += kThreads) s += partial[static_cast<int64_t>(g) * nk + k];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) sh[threadIdx.x] += sh[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[k] = sh[0];
}

// Warp-wide reduction for an idempotent op (min, max) by butterfly
// shuffles: every lane of the (full) warp gets the result.
template <typename T, typename Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Block-wide reduction over blockDim.x threads (a multiple of 32, at most
// 1024) for an idempotent op (min, max): lanes past the last warp repeat
// scratch[0].  `scratch` holds 32 values; every thread gets the result.
template <typename T, typename Op>
__device__ T block_reduce(T v, T* scratch, Op op) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_reduce(v, op);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_reduce(lane < nwarps ? scratch[lane] : scratch[0], op);
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  return scratch[0];
}

// cp.async of 16 bytes into shared memory (sm_80+), both addresses 16-byte
// aligned, cached in L2 only; a thread's copies are grouped by commit and
// waited for by group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kPending of this thread's copy groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

}  // namespace fbx

extern "C" const char* fbx_error_string(int err);
