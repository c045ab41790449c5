// K10: C2C DFT along one axis of a planar pair, as a shared-memory FFT.
//
// Replaces fastbox_tpu/ops/pallas/mmdft.py::dft_c2c_axis_pallas
// (_kernel_ax0, _kernel_ax1), the leading-axis transforms of the cube
// R2C/C2R route (ops/mmfft.py, FASTBOX_PALLAS_DFT).  The TPU kernel factors
// C = n1 * n2 and does stage 2 as a dense n2 x n2 product, because its
// matrix unit makes dense products cheap; on the card that product costs
// 8*n2 flops per element (1,024 at C = 256) against ~5 log2(C) for an FFT,
// and alone took longer than cuFFT along the same axis.
//
// Layout: the (A, B, M) planes are viewed as (O, C, I) with the transform
// on the middle axis (axis 0: O = 1, I = B*M; axis 1: O = A, I = M).  A
// "column" q in [0, O*I) is one length-C line, element c at
// (q / I) * C * I + c * I + q % I.
//
// Algorithm: a mixed-radix Stockham FFT (decimation in time, natural order
// in and out).  With radices R_0, R_1, ... (product C) and Ns the product
// of the radices before pass p, pass p computes for every j in [0, C/R):
//   v[r] = x[j + r*C/R] * W_{Ns*R}^(s*r*(j % Ns))      r in [0, R)
//   v    = DFT_R(v) with sign s
//   y[(j / Ns)*Ns*R + j % Ns + r*Ns] = v[r]
// The twiddle W_{Ns*R}^(s*m) is entry m*C/(Ns*R) of one table of
// exp(s 2 pi i m / C), m in [0, C), built by the wrapper in f64 and
// rounded to the data type.  An inverse multiplies the last pass's outputs
// by 1/C.  The plan (ops/cuda/mmdft.py::_fft_plan, and plan_* below) gives
// the radices and E, the number of elements each thread holds: radices 16,
// 16 and then 2, 4 or 8 for C = 2^k, 8, 8, 4 or 8 and 3 for 768 and 1536;
// E = 16, except 32 at 512 and 24 at 768 and 1536.
//
// Bound on the card: memory, 16 bytes per complex f32 element moved (one
// read, one write); the FFT's ~5 log2(C) flops per element are a few
// percent of the f32 rate.  Design, for that bound:
//   - one block of block_threads(C) threads per tile of LB = threads / T_c
//     consecutive columns, T_c = C / E threads per column; thread (t, lane)
//     with lane fastest, so a warp's device-memory accesses are runs of LB
//     contiguous columns (coalesced, as the TPU kernel's (8, 128) tiles are);
//   - the first pass reads its butterflies' inputs straight from device
//     memory into registers and the last pass writes its outputs straight
//     back in natural order (rows j + r*C/R in, rows j + r*Ns out: both
//     coalesced across lanes); the passes between exchange through a C x LB
//     tile in shared memory (padded one word in 32 against bank conflicts),
//     except that where E is the product of the last two radices (512: 16 x
//     2, 1536: 8 x 3) a thread's outputs of the second-to-last pass are
//     exactly the inputs of its last-pass butterflies, which then stay in
//     registers.  So at 256 and 512, the route's lengths, the tile is
//     written and read once;
//   - each thread holds E complex values in registers for E / R radix-R
//     butterflies; the plan is a compile-time constant of each length (one
//     kernel per length and type), so every index, stride and loop unrolls;
//   - f32 blocks get 4 E registers a thread, so two blocks share an SM (2 x
//     64 KB of tile) and one block's loads overlap the other's butterflies.
// Measured (H100 80GB HBM3, 700 W; PERF.md): at (256, 256, 129) and (512,
// 512, 257) as fast as torch.fft.fft along axis 0 and faster along axis 1,
// at 71-74% of the byte bound on axis 0.  Streaming cache hints on the
// loads and stores, and blocks of 256 or 1024 threads at 256, were slower.
// The wrapper's plan (radices, E) is checked against the kernel's.  The
// ragged last tile is masked; offsets are 64-bit.
#include "common.cuh"

namespace {

// The in-register butterflies' constants: cos and sin of 2 pi k / 16
// (radix 2, 4, 8 and 16 use every 8th, 4th, 2nd and 1st k) and sqrt(3)/2.
constexpr double kSqrt3Half = 0.86602540378443865;

__host__ __device__ constexpr double cos16(int k) {
  return k == 0 ? 1.0 : k == 1 ? 0.92387953251128674 : k == 2 ? 0.70710678118654757
       : k == 3 ? 0.38268343236508978 : k == 4 ? 0.0 : k == 5 ? -0.38268343236508978
       : k == 6 ? -0.70710678118654757 : k == 7 ? -0.92387953251128674 : k == 8 ? -1.0
       : k == 9 ? -0.92387953251128674 : k == 10 ? -0.70710678118654757
       : k == 11 ? -0.38268343236508978 : k == 12 ? 0.0 : k == 13 ? 0.38268343236508978
       : k == 14 ? 0.70710678118654757 : 0.92387953251128674;
}
__host__ __device__ constexpr double sin16(int k) { return cos16((k + 12) & 15); }

__host__ __device__ constexpr int bitrev(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

// The radix-2 stages of length LEN, 2 * LEN, ..., R of an in-register DFT
// (decimation in time on bit-reversed input); a template recursion, so that
// every index is a compile-time constant and the values stay in registers.
template <typename T, int R, int LEN>
__device__ __forceinline__ void radix2_stages(T* re, T* im, int sign) {
  if constexpr (LEN <= R) {
#pragma unroll
    for (int i = 0; i < R; i += LEN) {
#pragma unroll
      for (int k = 0; k < LEN / 2; ++k) {
        const int a = i + k, b = i + k + LEN / 2;
        const int m = k * (16 / LEN);  // W_LEN^k = W_16^m
        T tr, ti;
        if (m == 0) {
          tr = re[b]; ti = im[b];
        } else if (m == 4) {  // W = s i
          tr = sign < 0 ? im[b] : -im[b];
          ti = sign < 0 ? -re[b] : re[b];
        } else {
          const T c = T(cos16(m)), sn = sign < 0 ? T(-sin16(m)) : T(sin16(m));
          tr = re[b] * c - im[b] * sn;
          ti = re[b] * sn + im[b] * c;
        }
        re[b] = re[a] - tr; im[b] = im[a] - ti;
        re[a] = re[a] + tr; im[a] = im[a] + ti;
      }
    }
    radix2_stages<T, R, 2 * LEN>(re, im, sign);
  }
}

// In-register radix-R DFT of (re[0..R), im[0..R)) with sign s, R a power of
// two up to 16.
template <typename T, int R>
__device__ __forceinline__ void dft_pow2(T* re, T* im, int sign) {
  constexpr int bits = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int j = bitrev(i, bits);
    if (i < j) {
      const T tr = re[i], ti = im[i];
      re[i] = re[j]; im[i] = im[j];
      re[j] = tr; im[j] = ti;
    }
  }
  radix2_stages<T, R, 2>(re, im, sign);
}

template <typename T, int R>
__device__ __forceinline__ void dft_small(T* re, T* im, int sign) {
  if constexpr (R == 3) {
    const T t1r = re[1] + re[2], t1i = im[1] + im[2];
    const T t2r = re[1] - re[2], t2i = im[1] - im[2];
    const T mr = re[0] - T(0.5) * t1r, mi = im[0] - T(0.5) * t1i;
    // s i (sqrt3/2) t2
    const T h = sign < 0 ? T(-kSqrt3Half) : T(kSqrt3Half);
    const T qr = -h * t2i, qi = h * t2r;
    re[0] = re[0] + t1r; im[0] = im[0] + t1i;
    re[1] = mr + qr; im[1] = mi + qi;
    re[2] = mr - qr; im[2] = mi - qi;
  } else {
    dft_pow2<T, R>(re, im, sign);
  }
}

// The compile-time plan of a supported length C (ops/cuda/mmdft.py::
// _fft_plan): E values per thread, the passes' radices, and Ns, the product
// of the radices before pass p.
__host__ __device__ constexpr int plan_e(int C) {
  return C % 3 == 0 ? 24 : C == 512 ? 32 : 16;
}
__host__ __device__ constexpr int plan_passes(int C) {
  return C % 3 == 0 ? 4 : C == 256 ? 2 : 3;
}
__host__ __device__ constexpr int plan_radix(int C, int p) {
  return C % 3 == 0 ? (p < 2 ? 8 : p == 2 ? C / 192 : 3) : (p < 2 ? 16 : C / 256);
}
__host__ __device__ constexpr int plan_ns(int C, int p) {
  int ns = 1;
  for (int i = 0; i < p; ++i) ns *= plan_radix(C, i);
  return ns;
}

// Threads of a block: 256 at 512 (E = 32: 16 threads a column, 16 columns
// a block; faster there than 512 threads), else 512.
__host__ __device__ constexpr int block_threads(int C) { return C == 512 ? 256 : 512; }

// The tile [C][LB] in shared memory, one pad word after every 32.
template <int LB>
__device__ __forceinline__ int sidx(int c, int lane) {
  return c * LB + lane + ((c * LB) >> 5);
}

// Where a pass finds its inputs and leaves its outputs.
enum Where { kGlobal, kShared, kRegs };

// One Stockham pass (radix R, Ns) of this thread's E values.  The first
// pass reads its inputs from device memory (gx, rows strided by I), the
// last writes its outputs there (gy, times scale); the others go through
// the shared tile, except that when E is the product of the last two
// radices the thread already holds the last pass's inputs (kRegs).
template <typename T, int C, int R, int Ns, Where kIn, Where kOut>
__device__ __forceinline__ void pass(T (&vr)[plan_e(C)], T (&vi)[plan_e(C)], T* sr, T* si,
                                     int t, int lane, int sign, const T* __restrict__ twr,
                                     const T* __restrict__ twi, const T* gxr, const T* gxi,
                                     T* gyr, T* gyi, int64_t I, bool valid, T scale) {
  constexpr int E = plan_e(C), Tc = C / E, LB = block_threads(C) / Tc;
  if constexpr (kIn == kRegs) {
    // The previous pass left row t + Tc*m in v[m]; butterfly b's r-th
    // input, row j + r*C/R = t + Tc*(b + r*E/R), is v[b + r*E/R].
    static_assert(Ns == Tc * (E / R), "the last two passes fuse only when E = R' * R");
    T tr[E], ti[E];
#pragma unroll
    for (int m = 0; m < E; ++m) {
      tr[m] = vr[m];
      ti[m] = vi[m];
    }
#pragma unroll
    for (int b = 0; b < E / R; ++b) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        vr[b * R + r] = tr[b + r * (E / R)];
        vi[b * R + r] = ti[b + r * (E / R)];
      }
    }
  } else {
    if constexpr (kIn == kShared) __syncthreads();  // the previous pass's writes
#pragma unroll
    for (int b = 0; b < E / R; ++b) {
      const int j = t + b * Tc;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = j + r * (C / R);
        if constexpr (kIn == kGlobal) {
          vr[b * R + r] = valid ? gxr[row * I] : T(0);
          vi[b * R + r] = valid ? gxi[row * I] : T(0);
        } else {
          vr[b * R + r] = sr[sidx<LB>(row, lane)];
          vi[b * R + r] = si[sidx<LB>(row, lane)];
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < E / R; ++b) {
    const int j = t + b * Tc;
    T* re = vr + b * R;
    T* im = vi + b * R;
    if constexpr (Ns > 1) {
      const int k = j % Ns;
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const int m = r * k * (C / (Ns * R));
        const T cr = __ldg(twr + m), ci = __ldg(twi + m);
        const T xr = re[r], xi = im[r];
        re[r] = xr * cr - xi * ci;
        im[r] = xr * ci + xi * cr;
      }
    }
    dft_small<T, R>(re, im, sign);
  }
  // kRegs: butterfly b's r-th output stays in v[b*R + r]
  if constexpr (kOut == kRegs) return;
  if constexpr (kOut == kGlobal) {
    if (!valid) return;
  } else if constexpr (kIn == kShared) {
    __syncthreads();  // every read of this pass is done
  }
#pragma unroll
  for (int b = 0; b < E / R; ++b) {
    const int j = t + b * Tc;
    const int base = (j / Ns) * Ns * R + j % Ns;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = base + r * Ns;
      if constexpr (kOut == kGlobal) {
        gyr[row * I] = vr[b * R + r] * scale;
        gyi[row * I] = vi[b * R + r] * scale;
      } else {
        sr[sidx<LB>(row, lane)] = vr[b * R + r];
        si[sidx<LB>(row, lane)] = vi[b * R + r];
      }
    }
  }
}

template <typename T, int C, int P = 0>
__device__ __forceinline__ void run_passes(T (&vr)[plan_e(C)], T (&vi)[plan_e(C)], T* sr, T* si,
                                           int t, int lane, int sign, const T* __restrict__ twr,
                                           const T* __restrict__ twi, const T* gxr, const T* gxi,
                                           T* gyr, T* gyi, int64_t I, bool valid, T scale) {
  constexpr int kPasses = plan_passes(C);
  if constexpr (P < kPasses) {
    constexpr bool kFuse = kPasses >= 3 && plan_e(C) == plan_radix(C, kPasses - 2) *
                                                            plan_radix(C, kPasses - 1);
    constexpr Where kIn = P == 0 ? kGlobal : kFuse && P == kPasses - 1 ? kRegs : kShared;
    constexpr Where kOut = P == kPasses - 1 ? kGlobal : kFuse && P == kPasses - 2 ? kRegs : kShared;
    pass<T, C, plan_radix(C, P), plan_ns(C, P), kIn, kOut>(vr, vi, sr, si, t, lane, sign, twr,
                                                             twi, gxr, gxi, gyr, gyi, I, valid,
                                                             scale);
    run_passes<T, C, P + 1>(vr, vi, sr, si, t, lane, sign, twr, twi, gxr, gxi, gyr, gyi, I, valid,
                            scale);
  }
}

template <typename T, int C>
__host__ __device__ constexpr size_t tile_bytes() {
  constexpr int LB = block_threads(C) / (C / plan_e(C));
  return 2 * static_cast<size_t>(C * LB + ((C * LB) >> 5) + 1) * sizeof(T);
}

// Blocks an SM should hold: in f32, as many as leave each thread 4 E
// registers (two blocks of 512 threads at E = 16); in f64 one (its tile
// allows no more).
template <typename T, int C>
__host__ __device__ constexpr int min_blocks() {
  constexpr int n = 16384 / (block_threads(C) * plan_e(C));
  return sizeof(T) == 4 && n > 1 ? n : 1;
}

template <typename T, int C>
__global__ void __launch_bounds__(block_threads(C), (min_blocks<T, C>()))
fft_axis_kernel(const T* __restrict__ xr, const T* __restrict__ xi, const T* __restrict__ twr,
                const T* __restrict__ twi, T* __restrict__ yr, T* __restrict__ yi, int64_t I,
                int64_t ncols, int sign, int inverse_scale) {
  constexpr int E = plan_e(C), Tc = C / E, LB = block_threads(C) / Tc;
  constexpr int kTile = C * LB + ((C * LB) >> 5) + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sr = reinterpret_cast<T*>(smem_raw);
  T* si = sr + kTile;

  const int lane = threadIdx.x % LB;
  const int t = threadIdx.x / LB;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * LB + lane;
  const bool valid = q < ncols;
  const int64_t base = valid ? (q / I) * static_cast<int64_t>(C) * I + q % I : 0;
  const T scale = inverse_scale ? T(1) / T(C) : T(1);
  T vr[E], vi[E];
  run_passes<T, C>(vr, vi, sr, si, t, lane, sign, twr, twi, xr + base, xi + base, yr + base,
                   yi + base, I, valid, scale);
}

template <typename T, int C>
cudaError_t launch_length(const T* xr, const T* xi, const T* twr, const T* twi, T* yr, T* yi,
                          int64_t O, int64_t I, int64_t radices, int E, int sign,
                          int inverse_scale, cudaStream_t stream) {
  // the wrapper's plan must be the kernel's
  if (E != plan_e(C)) return cudaErrorInvalidValue;
  for (int p = 0; p < 8; ++p) {
    const int want = p < plan_passes(C) ? plan_radix(C, p) : 0;
    if (((radices >> (8 * p)) & 0xff) != want) return cudaErrorInvalidValue;
  }
  constexpr int LB = block_threads(C) / (C / plan_e(C));
  constexpr size_t smem = tile_bytes<T, C>();
  const int64_t ncols = O * I;
  const int64_t blocks = (ncols + LB - 1) / LB;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = &fft_axis_kernel<T, C>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), block_threads(C), smem, stream>>>(xr, xi, twr, twi, yr, yi, I,
                                                                   ncols, sign, inverse_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* xr, const T* xi, const T* twr, const T* twi, T* yr, T* yi,
                   int64_t O, int64_t C, int64_t I, int64_t radices, int E, int sign,
                   int inverse_scale, cudaStream_t stream) {
  if (I < 1 || O < 1 || (sign != 1 && sign != -1)) return cudaErrorInvalidValue;
#define FBX_LENGTH(L)                                                                        \
  case L:                                                                                    \
    return launch_length<T, L>(xr, xi, twr, twi, yr, yi, O, I, radices, E, sign, inverse_scale, \
                               stream)
  switch (C) {
    FBX_LENGTH(256);
    FBX_LENGTH(512);
    FBX_LENGTH(768);
    FBX_LENGTH(1024);
    FBX_LENGTH(1536);
    FBX_LENGTH(2048);
    default:
      return cudaErrorInvalidValue;
  }
#undef FBX_LENGTH
}

}  // namespace

// xr, xi, yr, yi: (O, C, I) contiguous planes, transform along C; twr, twi:
// (C,) exp(sign 2 pi i m / C); radices: the passes' radices, 8 bits each,
// first pass lowest, 0-terminated; E: values per thread; sign -1 or +1;
// inverse_scale != 0 multiplies by 1/C.
extern "C" int fbx_dft_c2c_axis_f32(const float* xr, const float* xi, const float* twr,
                                    const float* twi, float* yr, float* yi, int64_t O, int64_t C,
                                    int64_t I, int64_t radices, int E, int sign,
                                    int inverse_scale, void* stream) {
  return launch(xr, xi, twr, twi, yr, yi, O, C, I, radices, E, sign, inverse_scale,
                static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_dft_c2c_axis_f64(const double* xr, const double* xi, const double* twr,
                                    const double* twi, double* yr, double* yi, int64_t O,
                                    int64_t C, int64_t I, int64_t radices, int E, int sign,
                                    int inverse_scale, void* stream) {
  return launch(xr, xi, twr, twi, yr, yi, O, C, I, radices, E, sign, inverse_scale,
                static_cast<cudaStream_t>(stream));
}
