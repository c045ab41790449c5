// K10: factored (Cooley-Tukey) C2C DFT along one axis of a planar pair.
//
// Replaces fastbox_tpu/ops/pallas/mmdft.py::dft_c2c_axis_pallas
// (_kernel_ax0, _kernel_ax1), the leading-axis transforms of the cube
// R2C/C2R route (ops/mmfft.py, FASTBOX_PALLAS_DFT).  With C = n1 * n2
// (n1 in {2, 4}), j = j1*n2 + j2 and k = k1 + n1*k2:
//   A[k1, j2]     = sum_j1 x[j1*n2 + j2] W_n1^(s j1 k1)   (butterflies)
//   B[k1, j2]     = A[k1, j2] * T[k1*n2 + j2]             (twiddle)
//   X[k1 + n1 k2] = sum_j2 B[k1, j2] W2[k2, j2]           (stage-2 product)
// W2 and T come from the wrapper (host f64, rounded to the data type; the
// 1/C of an inverse folded into W2).  W2[k2, j2] = W_n2^(s j2 k2) is
// symmetric, so the kernel reads it by rows of j2.
//
// Layout: the (A, B, M) planes are viewed as (O, C, I) with the transform
// on the middle axis (axis 0: O = 1, I = B*M; axis 1: O = A, I = M).  A
// "column" q in [0, O*I) is one length-C line, element c at
// (q / I) * C * I + c * I + q % I.
//
// Bound on the card: memory for the function itself (16 bytes per complex
// f32 element moved, ~5 log2(C) flops per element for an FFT), but this
// factored algorithm does 8*n2 flops per element in its stage-2 product
// (n2 = 128 at C = 256 and 512), which puts this kernel at the f32 FMA
// rate: ~0.13 ms of FMAs against 0.04 ms of bytes at (256, 256, 129).
// Design: one block of 256 threads per tile of LB consecutive columns.
//   1. The block loads the C x LB re/im tile into dynamic shared memory
//      (neighbouring threads read neighbouring columns: coalesced rows).
//   2. Butterflies and twiddle in place in shared memory, one thread per
//      (j2, column).
//   3. Each thread owns one column and, in turn, chunks of K2T = 8 values
//      of k2 for all n1 values of k1: an n1 x 8 register tile of complex
//      sums over j2, fed per j2 by n1 shared-memory reads (conflict-free:
//      the lanes read consecutive words) and two 8-wide vector reads of W2
//      that every lane of a group shares (L1-resident).  The sums are f32
//      (f64 for double data), written straight to out[k1 + n1*k2].
// LB is the largest power of two <= 32 that keeps the tile within 64 KB,
// so three blocks fit an SM by shared memory.  The ragged last tile is
// masked; offsets are 64-bit.  No tensor cores, no library product: a
// later pass can move stage 2 onto wgmma.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kK2T = 8;
constexpr size_t kTileBudget = 64 * 1024;

template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ p, T* out) {
#pragma unroll
  for (int t = 0; t < kK2T; ++t) out[t] = __ldg(p + t);
}

template <>
__device__ __forceinline__ void load8<float>(const float* __restrict__ p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

template <>
__device__ __forceinline__ void load8<double>(const double* __restrict__ p, double* out) {
#pragma unroll
  for (int t = 0; t < kK2T / 2; ++t) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p) + t);
    out[2 * t] = v.x;
    out[2 * t + 1] = v.y;
  }
}

// Radix-n1 DFT of a[0..n1) (re, im) in place; the signs of
// fastbox_tpu/ops/pallas/mmdft.py:97-114.
template <typename T, int N1>
__device__ __forceinline__ void butterfly(T* ar, T* ai, int sign) {
  if (N1 == 2) {
    const T r0 = ar[0], i0 = ai[0];
    ar[0] = r0 + ar[1]; ai[0] = i0 + ai[1];
    ar[1] = r0 - ar[1]; ai[1] = i0 - ai[1];
    return;
  }
  const T t0r = ar[0] + ar[2], t0i = ai[0] + ai[2];
  const T t1r = ar[0] - ar[2], t1i = ai[0] - ai[2];
  const T u0r = ar[1] + ar[3], u0i = ai[1] + ai[3];
  const T u1r = ar[1] - ar[3], u1i = ai[1] - ai[3];
  ar[0] = t0r + u0r; ai[0] = t0i + u0i;
  ar[2] = t0r - u0r; ai[2] = t0i - u0i;
  if (sign < 0) {  // forward: A1 = t1 - i u1, A3 = t1 + i u1
    ar[1] = t1r + u1i; ai[1] = t1i - u1r;
    ar[3] = t1r - u1i; ai[3] = t1i + u1r;
  } else {         // inverse: conjugated mixing
    ar[1] = t1r - u1i; ai[1] = t1i + u1r;
    ar[3] = t1r + u1i; ai[3] = t1i - u1r;
  }
}

template <typename T, int N1>
__global__ void __launch_bounds__(kThreads)
dft_axis_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                const T* __restrict__ w2r, const T* __restrict__ w2i,
                const T* __restrict__ tr, const T* __restrict__ ti,
                T* __restrict__ yr, T* __restrict__ yi,
                int64_t I, int64_t ncols, int n2, int LB, int sign) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = N1 * n2;
  T* sr = reinterpret_cast<T*>(smem_raw);  // [C][LB]
  T* si = sr + static_cast<size_t>(C) * LB;

  // This thread's column: constant over the strided loops below, since LB
  // divides kThreads.
  const int lane = threadIdx.x % LB;
  const int group = threadIdx.x / LB;
  const int groups = kThreads / LB;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * LB + lane;
  const bool valid = q < ncols;
  const int64_t base = valid ? (q / I) * static_cast<int64_t>(C) * I + q % I : 0;

  // 1. the tile, zeros past the last column
  for (int c = group; c < C; c += groups) {
    sr[c * LB + lane] = valid ? xr[base + c * I] : T(0);
    si[c * LB + lane] = valid ? xi[base + c * I] : T(0);
  }
  __syncthreads();

  // 2. butterflies over j1 and the twiddle, in place
  for (int j2 = group; j2 < n2; j2 += groups) {
    T ar[N1], ai[N1];
#pragma unroll
    for (int j1 = 0; j1 < N1; ++j1) {
      ar[j1] = sr[(j1 * n2 + j2) * LB + lane];
      ai[j1] = si[(j1 * n2 + j2) * LB + lane];
    }
    butterfly<T, N1>(ar, ai, sign);
#pragma unroll
    for (int k1 = 0; k1 < N1; ++k1) {
      const int r = k1 * n2 + j2;
      const T cr = __ldg(tr + r), ci = __ldg(ti + r);
      sr[r * LB + lane] = ar[k1] * cr - ai[k1] * ci;
      si[r * LB + lane] = ar[k1] * ci + ai[k1] * cr;
    }
  }
  __syncthreads();

  // 3. stage-2 product: chunks of kK2T values of k2 per thread, all k1
  const int nchunks = n2 / kK2T;
  for (int chunk = group; chunk < nchunks; chunk += groups) {
    const int k20 = chunk * kK2T;
    T acc_r[N1][kK2T], acc_i[N1][kK2T];
#pragma unroll
    for (int k1 = 0; k1 < N1; ++k1) {
#pragma unroll
      for (int t = 0; t < kK2T; ++t) acc_r[k1][t] = acc_i[k1][t] = T(0);
    }
    for (int j2 = 0; j2 < n2; ++j2) {
      T wr[kK2T], wi[kK2T];
      load8(w2r + static_cast<size_t>(j2) * n2 + k20, wr);
      load8(w2i + static_cast<size_t>(j2) * n2 + k20, wi);
#pragma unroll
      for (int k1 = 0; k1 < N1; ++k1) {
        const T br = sr[(k1 * n2 + j2) * LB + lane];
        const T bi = si[(k1 * n2 + j2) * LB + lane];
#pragma unroll
        for (int t = 0; t < kK2T; ++t) {
          acc_r[k1][t] += wr[t] * br - wi[t] * bi;
          acc_i[k1][t] += wr[t] * bi + wi[t] * br;
        }
      }
    }
    if (valid) {
#pragma unroll
      for (int k1 = 0; k1 < N1; ++k1) {
#pragma unroll
        for (int t = 0; t < kK2T; ++t) {
          const int64_t off = base + static_cast<int64_t>(k1 + N1 * (k20 + t)) * I;
          yr[off] = acc_r[k1][t];
          yi[off] = acc_i[k1][t];
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const T* xr, const T* xi, const T* w2r, const T* w2i, const T* tr,
                   const T* ti, T* yr, T* yi, int64_t O, int64_t C, int64_t I, int n1,
                   int sign, cudaStream_t stream) {
  if ((n1 != 2 && n1 != 4) || C % n1 != 0 || (C / n1) % kK2T != 0 || I < 1 || O < 1)
    return cudaErrorInvalidValue;
  const int n2 = static_cast<int>(C / n1);
  int LB = 32;
  while (LB > 1 && 2 * static_cast<size_t>(C) * LB * sizeof(T) > kTileBudget) LB /= 2;
  const size_t smem = 2 * static_cast<size_t>(C) * LB * sizeof(T);
  const int64_t ncols = O * I;
  const int64_t blocks = (ncols + LB - 1) / LB;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = n1 == 4 ? &dft_axis_kernel<T, 4> : &dft_axis_kernel<T, 2>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      xr, xi, w2r, w2i, tr, ti, yr, yi, I, ncols, n2, LB, sign);
  return cudaGetLastError();
}

}  // namespace

// xr, xi, yr, yi: (O, C, I) contiguous planes, transform along C; w2r, w2i:
// (n2, n2) with n2 = C / n1; tr, ti: (C,) twiddles; sign -1 or +1.
extern "C" int fbx_dft_c2c_axis_f32(const float* xr, const float* xi, const float* w2r,
                                    const float* w2i, const float* tr, const float* ti,
                                    float* yr, float* yi, int64_t O, int64_t C, int64_t I,
                                    int n1, int sign, void* stream) {
  return launch(xr, xi, w2r, w2i, tr, ti, yr, yi, O, C, I, n1, sign,
                static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_dft_c2c_axis_f64(const double* xr, const double* xi, const double* w2r,
                                    const double* w2i, const double* tr, const double* ti,
                                    double* yr, double* yi, int64_t O, int64_t C, int64_t I,
                                    int n1, int sign, void* stream) {
  return launch(xr, xi, w2r, w2i, tr, ti, yr, yi, O, C, I, n1, sign,
                static_cast<cudaStream_t>(stream));
}
