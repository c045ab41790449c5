// K9: fused colored complex-normal draw on the rfft half spectrum,
// delta = (n1 + i n2) * sqrt(1/2) * amp, optionally with the LOS velocity
// spectrum vz = delta * i * kznum / (kx2 + kyz2).
//
// Replaces fastbox_tpu/ops/pallas/half_draw.py::colored_complex_normal_pallas
// (_kernel) and ::colored_complex_normal_vz_pallas (_kernel_vz).  The
// pipeline's density draw takes it for pallas_draw 'auto'/'on' and, with the
// velocity weighting, for 'vz'.
//
// Bound on the card: memory.  One read of amp and one complex write of
// delta (12 bytes per f32 mode, 101 MB at 256^3), plus one complex write of
// vz in vz mode; two Philox calls and four Box-Mullers per group of four
// modes are far below the compute rate at that traffic.  Design: the
// normals never touch device memory.  One thread per group of four complex
// modes, Philox4x32-10 (common.cuh, K1's stream definition) keyed by (seed,
// group) with counter words (g, 0) and (g, 1); each Box-Muller pair colours
// one mode, the cos branch the real part, the sin branch the imaginary part.
// Group g covers modes g, g+G, g+2G, g+3G (G = ceil(n/4)), so each store of
// a warp is 32 consecutive complex values.  The kernel writes the
// interleaved complex tensor directly.  Both modes draw the same normals for
// the same seed.  The seed is read from device memory (drawn from a
// torch.Generator on the card, no host sync).  In supplied mode the kernel
// reads the complex half-noise `white` (already x sqrt(1/2)) instead and
// rounds exactly like the plain twin (ops/cuda/half_draw.py): every product
// and the quotient are spelled out with mul_rn/div_rn, so nvcc contracts
// nothing into an FMA.  The kz = 0 and Nyquist planes are drawn like the
// rest; the caller overwrites them with Hermitian planes, as the twin does.
#include "common.cuh"

namespace {

template <typename T> struct Complex;
template <> struct Complex<float> { using type = float2; };
template <> struct Complex<double> { using type = double2; };

template <typename T, bool kVz>
__global__ void half_draw_kernel(const T* __restrict__ amp,
                                 const typename Complex<T>::type* __restrict__ white,
                                 const int64_t* __restrict__ seed, const T* __restrict__ kx2,
                                 const T* __restrict__ kyz2, const T* __restrict__ kznum,
                                 typename Complex<T>::type* __restrict__ delta,
                                 typename Complex<T>::type* __restrict__ vz, int64_t n, int64_t C) {
  using C2 = typename Complex<T>::type;
  const T sqrt_half = T(0.7071067811865476);
  uint32_t k0 = 0, k1 = 0;
  if (white == nullptr) fbx::seed_key(seed, k0, k1);
  const int64_t G = (n + 3) / 4;
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; g < G;
       g += (int64_t)gridDim.x * blockDim.x) {
    T nre[4], nim[4];
    if (white == nullptr) {
      const uint32_t lo = static_cast<uint32_t>(g), hi = static_cast<uint32_t>(g >> 32);
      const fbx::U4 a = fbx::philox4x32_10(fbx::U4{lo, hi, 0u, 0u}, k0, k1);
      const fbx::U4 b = fbx::philox4x32_10(fbx::U4{lo, hi, 1u, 0u}, k0, k1);
      fbx::box_muller(a.x, a.y, nre[0], nim[0]);
      fbx::box_muller(a.z, a.w, nre[1], nim[1]);
      fbx::box_muller(b.x, b.y, nre[2], nim[2]);
      fbx::box_muller(b.z, b.w, nre[3], nim[3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t e = g + j * G;
      if (e < n) {
        T wr, wi;
        if (white == nullptr) {
          wr = fbx::mul_rn(nre[j], sqrt_half);
          wi = fbx::mul_rn(nim[j], sqrt_half);
        } else {
          const C2 w = white[e];
          wr = w.x;
          wi = w.y;
        }
        const T a = amp[e];
        const T re = fbx::mul_rn(wr, a), im = fbx::mul_rn(wi, a);
        C2 d;
        d.x = re;
        d.y = im;
        delta[e] = d;
        if (kVz) {
          const int64_t col = e % C;
          const T k2 = fbx::add_rn(kx2[e / C], kyz2[col]);
          const T w = k2 > T(0) ? fbx::div_rn(kznum[col], k2) : T(0);
          C2 v;
          v.x = fbx::mul_rn(-im, w);  // (re + i im) * (i w)
          v.y = fbx::mul_rn(re, w);
          vz[e] = v;
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const T* amp, const T* white, const int64_t* seed, const T* kx2, const T* kyz2,
                   const T* kznum, T* delta, T* vz, int64_t R, int64_t C, cudaStream_t stream) {
  using C2 = typename Complex<T>::type;
  const int64_t n = R * C;
  const int threads = 256;
  const unsigned blocks = fbx::grid_blocks((n + 3) / 4, threads);
  const C2* w = reinterpret_cast<const C2*>(white);
  if (vz == nullptr) {
    half_draw_kernel<T, false><<<blocks, threads, 0, stream>>>(
        amp, w, seed, nullptr, nullptr, nullptr, reinterpret_cast<C2*>(delta), nullptr, n, C);
  } else {
    half_draw_kernel<T, true><<<blocks, threads, 0, stream>>>(
        amp, w, seed, kx2, kyz2, kznum, reinterpret_cast<C2*>(delta), reinterpret_cast<C2*>(vz),
        n, C);
  }
  return cudaGetLastError();
}

}  // namespace

// amp: (R, C) contiguous; white: (R, C) interleaved complex, or NULL to draw
// from `seed` (device int64, read only when white is NULL); delta: (R, C)
// interleaved complex output.  vz: (R, C) interleaved complex output, or
// NULL for the draw alone; with vz, kx2 (R,), kyz2 (C,) and kznum (C,).
extern "C" int fbx_half_draw_f32(const float* amp, const float* white, const int64_t* seed,
                                 const float* kx2, const float* kyz2, const float* kznum,
                                 float* delta, float* vz, int64_t R, int64_t C, void* stream) {
  return launch(amp, white, seed, kx2, kyz2, kznum, delta, vz, R, C,
                static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_half_draw_f64(const double* amp, const double* white, const int64_t* seed,
                                 const double* kx2, const double* kyz2, const double* kznum,
                                 double* delta, double* vz, int64_t R, int64_t C, void* stream) {
  return launch(amp, white, seed, kx2, kyz2, kznum, delta, vz, R, C,
                static_cast<cudaStream_t>(stream));
}
