// K9: fused colored complex-normal draw on the rfft half spectrum,
// delta = (n1 + i n2) * sqrt(1/2) * amp, optionally with the LOS velocity
// spectrum vz = delta * i * kznum / (kx2 + kyz2).
//
// Replaces fastbox_tpu/ops/pallas/half_draw.py::colored_complex_normal_pallas
// (_kernel, K9a) and ::colored_complex_normal_vz_pallas (_kernel_vz, K9b).
// The pipeline's density draw takes it for pallas_draw 'auto'/'on' and, with
// the velocity weighting, for 'vz'.
//
// Bound on the card: memory.  One read of amp and one complex write of
// delta (12 bytes per f32 mode, 101 MB at 256^3), plus one complex write of
// vz in vz mode (kx2, kyz2 and kznum are vectors, read from L2); two Philox
// calls and four Box-Mullers per four modes cost ~110 instructions a mode,
// about as long as the bytes take, so both have to overlap.  Design: the
// normals never touch device memory, and no mode pays an integer division.
// The (R, C) array goes in units of four consecutive columns of one row: a
// block takes blockDim units of a row (blockIdx.x strides the units,
// blockIdx.y the rows), so a thread finds its row and column from the grid
// alone, holds kx2[row] in a register, and indexes each mode as row * C +
// col with 64-bit offsets formed once per unit.  Each unit takes two
// counter-based Philox4x32-10 calls (common.cuh, K1's generator), counter
// (unit, row, word) with words 2 and 3 (K1 uses 0), key the seed: eight
// words, four Box-Muller pairs, one pair per mode (the cos branch the real
// part, the sin branch the imaginary part).  A mode's normals depend only on
// its row and column.  Where C is a multiple of 4 and every array starts on
// a 16-byte boundary (the wrapper's rule, ops/cuda/half_draw.py
// vector_path) a unit reads amp, kyz2 and kznum and writes delta and vz as
// 16-byte vectors (two complex f32 per float4, one complex f64 per
// double2); else the element path reads and writes mode by mode, with the
// same units and counters, so both paths draw the same bits.  K9a and K9b
// are one body (kVz), so they draw the same delta for one seed.  The seed is
// read from device memory (drawn from a torch.Generator on the card, no
// host sync).  In supplied mode the kernel reads the complex half-noise
// `white` (already x sqrt(1/2)) and rounds exactly like the plain twin
// (ops/cuda/half_draw.py): every product and the quotient are spelled out
// with mul_rn/div_rn/add_rn, so nvcc contracts nothing into an FMA.  The
// kz = 0 and Nyquist planes are drawn like the rest; the caller overwrites
// them with Hermitian planes, as the twin does.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // units a block takes from one row

template <typename T> struct Complex;
template <> struct Complex<float> { using type = float2; };
template <> struct Complex<double> { using type = double2; };
__device__ __forceinline__ float2 make_c2(float re, float im) { return make_float2(re, im); }
__device__ __forceinline__ double2 make_c2(double re, double im) { return make_double2(re, im); }

// Four consecutive values as 16-byte accesses (p 16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  fbx::Vec16<float>::unpack(*reinterpret_cast<const float4*>(p), v);
}
__device__ __forceinline__ void load4(const double* p, double v[4]) {
  fbx::Vec16<double>::unpack(reinterpret_cast<const double2*>(p)[0], v);
  fbx::Vec16<double>::unpack(reinterpret_cast<const double2*>(p)[1], v + 2);
}
// Four consecutive complex values (re[j], im[j]), interleaved.
__device__ __forceinline__ void load4c(const float2* p, float re[4], float im[4]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  re[0] = a.x, im[0] = a.y, re[1] = a.z, im[1] = a.w;
  re[2] = b.x, im[2] = b.y, re[3] = b.z, im[3] = b.w;
}
__device__ __forceinline__ void load4c(const double2* p, double re[4], double im[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const double2 q = p[j];
    re[j] = q.x, im[j] = q.y;
  }
}
__device__ __forceinline__ void store4c(float2* p, const float re[4], const float im[4]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(re[0], im[0], re[1], im[1]);
  reinterpret_cast<float4*>(p)[1] = make_float4(re[2], im[2], re[3], im[3]);
}
__device__ __forceinline__ void store4c(double2* p, const double re[4], const double im[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) p[j] = make_double2(re[j], im[j]);
}

// The normals of columns 4u .. 4u+3 of a row: (nre[j], nim[j]) for column
// 4u + j, from counters (u, row, 2) and (u, row, 3).
template <typename T>
__device__ __forceinline__ void normal4c(uint32_t row, uint32_t u, uint32_t k0, uint32_t k1,
                                         T nre[4], T nim[4]) {
  const fbx::U4 a = fbx::philox4x32_10(fbx::U4{u, row, 2u, 0u}, k0, k1);
  const fbx::U4 b = fbx::philox4x32_10(fbx::U4{u, row, 3u, 0u}, k0, k1);
  fbx::box_muller(a.x, a.y, nre[0], nim[0]);
  fbx::box_muller(a.z, a.w, nre[1], nim[1]);
  fbx::box_muller(b.x, b.y, nre[2], nim[2]);
  fbx::box_muller(b.z, b.w, nre[3], nim[3]);
}

// delta = white * amp and, with kVz, vz = delta * i * w for one mode.
template <typename T, bool kVz>
__device__ __forceinline__ void colour(T wr, T wi, T a, T kx2r, T kyz2c, T kznumc, T& dre,
                                       T& dim, T& vre, T& vim) {
  dre = fbx::mul_rn(wr, a);
  dim = fbx::mul_rn(wi, a);
  if (kVz) {
    const T k2 = fbx::add_rn(kx2r, kyz2c);
    const T w = k2 > T(0) ? fbx::div_rn(kznumc, k2) : T(0);
    vre = fbx::mul_rn(-dim, w);  // (re + i im) * (i w)
    vim = fbx::mul_rn(dre, w);
  }
}

template <typename T, bool kVz, bool kVec>
__global__ void __launch_bounds__(kThreads)
    half_draw_kernel(const T* __restrict__ amp, const typename Complex<T>::type* __restrict__ white,
                     const int64_t* __restrict__ seed, const T* __restrict__ kx2,
                     const T* __restrict__ kyz2, const T* __restrict__ kznum,
                     typename Complex<T>::type* __restrict__ delta,
                     typename Complex<T>::type* __restrict__ vz, int R, int C) {
  const T sqrt_half = T(0.7071067811865476);
  uint32_t k0 = 0, k1 = 0;
  if (white == nullptr) fbx::seed_key(seed, k0, k1);
  const int U = (C + 3) / 4;
  for (int row = blockIdx.y; row < R; row += gridDim.y) {
    const T kx2r = kVz ? kx2[row] : T(0);
    const int64_t base = static_cast<int64_t>(row) * C;
    for (int u = blockIdx.x * kThreads + threadIdx.x; u < U; u += gridDim.x * kThreads) {
      const int c = 4 * u;
      const int64_t e = base + c;
      T wr[4], wi[4];
      if (white == nullptr) {
        T nre[4], nim[4];
        normal4c(static_cast<uint32_t>(row), static_cast<uint32_t>(u), k0, k1, nre, nim);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wr[j] = fbx::mul_rn(nre[j], sqrt_half);
          wi[j] = fbx::mul_rn(nim[j], sqrt_half);
        }
      }
      T dre[4], dim[4], vre[4], vim[4];
      if (kVec) {
        T a[4], ky[4] = {T(0), T(0), T(0), T(0)}, kz[4] = {T(0), T(0), T(0), T(0)};
        if (white != nullptr) load4c(white + e, wr, wi);
        load4(amp + e, a);
        if (kVz) {
          load4(kyz2 + c, ky);
          load4(kznum + c, kz);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          colour<T, kVz>(wr[j], wi[j], a[j], kx2r, ky[j], kz[j], dre[j], dim[j], vre[j], vim[j]);
        store4c(delta + e, dre, dim);
        if (kVz) store4c(vz + e, vre, vim);
      } else {
        const int n = C - c < 4 ? C - c : 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < n) {
            if (white != nullptr) {
              const typename Complex<T>::type w = white[e + j];
              wr[j] = w.x;
              wi[j] = w.y;
            }
            colour<T, kVz>(wr[j], wi[j], amp[e + j], kx2r, kVz ? kyz2[c + j] : T(0),
                           kVz ? kznum[c + j] : T(0), dre[j], dim[j], vre[j], vim[j]);
            delta[e + j] = make_c2(dre[j], dim[j]);
            if (kVz) vz[e + j] = make_c2(vre[j], vim[j]);
          }
        }
      }
    }
  }
}

template <typename T, bool kVz>
cudaError_t launch_mode(const T* amp, const T* white, const int64_t* seed, const T* kx2,
                        const T* kyz2, const T* kznum, T* delta, T* vz, int64_t R, int64_t C,
                        int vec, cudaStream_t stream) {
  using C2 = typename Complex<T>::type;
  const int64_t U = (C + 3) / 4;
  const int64_t gx = (U + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(gx < 1024 ? gx : 1024),
                  static_cast<unsigned>(R < 65535 ? R : 65535));
  const C2* w = reinterpret_cast<const C2*>(white);
  C2* d = reinterpret_cast<C2*>(delta);
  C2* v = reinterpret_cast<C2*>(vz);
  if (vec)
    half_draw_kernel<T, kVz, true><<<grid, kThreads, 0, stream>>>(
        amp, w, seed, kx2, kyz2, kznum, d, v, static_cast<int>(R), static_cast<int>(C));
  else
    half_draw_kernel<T, kVz, false><<<grid, kThreads, 0, stream>>>(
        amp, w, seed, kx2, kyz2, kznum, d, v, static_cast<int>(R), static_cast<int>(C));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* amp, const T* white, const int64_t* seed, const T* kx2, const T* kyz2,
                   const T* kznum, T* delta, T* vz, int64_t R, int64_t C, int vec,
                   cudaStream_t stream) {
  if (R == 0 || C == 0) return cudaSuccess;
  // rows, columns and units are 32-bit indices; offsets are 64-bit
  if (R > INT32_MAX || C > INT32_MAX - 3) return cudaErrorInvalidValue;
  if (vec && C % 4 != 0) return cudaErrorInvalidValue;
  if (vz == nullptr)
    return launch_mode<T, false>(amp, white, seed, kx2, kyz2, kznum, delta, vz, R, C, vec, stream);
  return launch_mode<T, true>(amp, white, seed, kx2, kyz2, kznum, delta, vz, R, C, vec, stream);
}

}  // namespace

// amp: (R, C) contiguous; white: (R, C) interleaved complex, or NULL to draw
// from `seed` (device int64, read only when white is NULL); delta: (R, C)
// interleaved complex output.  vz: (R, C) interleaved complex output, or
// NULL for the draw alone; with vz, kx2 (R,), kyz2 (C,) and kznum (C,).
// vec: 1 for 16-byte accesses (C a multiple of 4, every array 16-byte
// aligned), 0 for the element path; both draw the same bits.
extern "C" int fbx_half_draw_f32(const float* amp, const float* white, const int64_t* seed,
                                 const float* kx2, const float* kyz2, const float* kznum,
                                 float* delta, float* vz, int64_t R, int64_t C, int vec,
                                 void* stream) {
  return launch(amp, white, seed, kx2, kyz2, kznum, delta, vz, R, C, vec,
                static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_half_draw_f64(const double* amp, const double* white, const int64_t* seed,
                                 const double* kx2, const double* kyz2, const double* kznum,
                                 double* delta, double* vz, int64_t R, int64_t C, int vec,
                                 void* stream) {
  return launch(amp, white, seed, kx2, kyz2, kznum, delta, vz, R, C, vec,
                static_cast<cudaStream_t>(stream));
}
