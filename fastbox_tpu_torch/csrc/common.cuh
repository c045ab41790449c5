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

// jax.random's threefry2x32 (jax/_src/prng.py, _threefry2x32_lowering):
// 20 rounds of add, rotate and xor on a pair of 32-bit words, the key
// injected every four rounds with the round count.  R1/R2 (row_draw.cu)
// reproduce jax's row streams with it.
struct U2 {
  uint32_t x, y;
};

template <int kR>
__device__ __forceinline__ void threefry_round(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, kR) ^ x0;
}

template <int kA, int kB, int kC, int kD>
__device__ __forceinline__ void threefry_rounds4(uint32_t& x0, uint32_t& x1) {
  threefry_round<kA>(x0, x1);
  threefry_round<kB>(x0, x1);
  threefry_round<kC>(x0, x1);
  threefry_round<kD>(x0, x1);
}

__device__ __forceinline__ U2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  threefry_rounds4<13, 15, 26, 6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  threefry_rounds4<17, 29, 16, 24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  threefry_rounds4<13, 15, 26, 6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  threefry_rounds4<17, 29, 16, 24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  threefry_rounds4<13, 15, 26, 6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
  return U2{x0, x1};
}

// jax.random.fold_in(key, d), and the d-th key of the partitionable
// jax.random.split(key, n): both hash the counter (0, d).
__device__ __forceinline__ U2 threefry_fold(U2 k, uint32_t d) { return threefry2x32(k.x, k.y, 0u, d); }

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

// out[k] = S_k, the sum over blocks of partial[block][k] for k < nk, rounded
// once to TOut; one block of 256 threads per k: strided sums, then a fixed
// shared-memory tree, so the result is the same on every run.  With
// diff_run > 0, k runs of diff_run prefixes: out[k] = S_k - S_{k-1} in
// float64 but at the start of a run, S_{k-1} summed by the same tree (the
// same bits as S_{k-1} itself).
template <int kThreads = 256, typename TOut = double>
__global__ void sum_partials_kernel(const double* __restrict__ partial, TOut* __restrict__ out,
                                    int nblocks, int nk, int diff_run = 0) {
  __shared__ double sh[2][kThreads];
  const int k = blockIdx.x;
  const bool diff = diff_run > 0 && k % diff_run != 0;
  double s = 0.0, p = 0.0;
  for (int g = threadIdx.x; g < nblocks; g += kThreads) {
    s += partial[static_cast<int64_t>(g) * nk + k];
    if (diff) p += partial[static_cast<int64_t>(g) * nk + k - 1];
  }
  sh[0][threadIdx.x] = s;
  sh[1][threadIdx.x] = p;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      sh[0][threadIdx.x] += sh[0][threadIdx.x + half];
      sh[1][threadIdx.x] += sh[1][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[k] = static_cast<TOut>(sh[0][0] - sh[1][0]);
}

// Float64 sums over a warp's 32 lanes by fixed butterflies, so that a sum
// is the same on every run.  warp_sum4 halves four values at the first two
// steps (12 shuffles of 32 bits): lanes 0-7 end with the sum of x, 8-15
// y's, 16-23 z's, 24-31 w's.  warp_sum2 halves two at the first step (10):
// lanes 0-15 end with x's, 16-31 with y's.
__device__ __forceinline__ double warp_sum4(double x, double y, double z, double w, int lane) {
  const bool hi16 = lane & 16, hi8 = lane & 8;
  double k0 = hi16 ? z : x, k1 = hi16 ? w : y;
  k0 += __shfl_xor_sync(0xffffffffu, hi16 ? x : z, 16);
  k1 += __shfl_xor_sync(0xffffffffu, hi16 ? y : w, 16);
  double v = hi8 ? k1 : k0;
  v += __shfl_xor_sync(0xffffffffu, hi8 ? k0 : k1, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

__device__ __forceinline__ double warp_sum2(double x, double y, int lane) {
  const bool hi16 = lane & 16;
  double v = hi16 ? y : x;
  v += __shfl_xor_sync(0xffffffffu, hi16 ? x : y, 16);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
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

// One 16-byte vector of T (4 floats or 2 doubles), unpacked to and packed
// from an array.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  __device__ static void unpack(const float4& q, float* v) { v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w; }
  __device__ static float4 pack(const float* v) { return make_float4(v[0], v[1], v[2], v[3]); }
};
template <> struct Vec16<double> {
  using type = double2;
  __device__ static void unpack(const double2& q, double* v) { v[0] = q.x, v[1] = q.y; }
  __device__ static double2 pack(const double* v) { return make_double2(v[0], v[1]); }
};

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

// Launch shape of a kernel that gives each row to a warp (grid-stride over
// rows): as many warps, at most 8, as fit kRowBlockBytes (two blocks to an
// SM) with `fixed` shared bytes per block and `per_warp` per warp, at least
// one; no more blocks than the card holds at once.  Raises the kernel's
// dynamic shared-memory limit to what it takes.
constexpr size_t kRowBlockBytes = 113 * 1024;

template <typename Kernel>
__host__ cudaError_t warp_rows_shape(Kernel kern, size_t fixed, size_t per_warp, int64_t rows,
                                     int* warps, unsigned* blocks, size_t* smem) {
  int w = fixed + per_warp < kRowBlockBytes ? static_cast<int>((kRowBlockBytes - fixed) / per_warp)
                                            : 1;
  if (w > 8) w = 8;
  *warps = w;
  *smem = fixed + w * per_warp;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(*smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 32 * w, *smem);
  if (e != cudaSuccess) return e;
  int64_t b = (rows + w - 1) / w;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  *blocks = static_cast<unsigned>(b < resident ? b : resident);
  return cudaSuccess;
}

}  // namespace fbx

extern "C" const char* fbx_error_string(int err);
