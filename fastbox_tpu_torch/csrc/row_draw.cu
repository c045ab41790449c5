// R1/R2: jax.random's row-keyed draws, one launch per field for a batch of keys.
//
// Counterparts of fastbox_tpu/parallel/rng.py::row_normal (R1) and
// fastbox_tpu/parallel/halos.py::row_poisson (R2).  They replace no Pallas
// kernel: on the TPU each field is one XLA program (jax.random under
// jax.vmap over rows and keys).  Row r of key b draws with
// fold_in(fold_in(key_b, tag), row0 + r), and element j of a row hashes
// the counter (0, j) with threefry2x32 (common.cuh), as jax 0.9's
// partitionable random_bits does, so the card draws jax's own bits for
// jax.random.PRNGKey(seed).
//
// R1 (row_normal): f32 takes the XOR of the two output words, f64 the
// 64-bit word hi << 32 | lo; the mantissa trick gives f in [0, 1), then
// u = max(lo, fma(f, hi - lo, lo)) as jax.random.uniform computes it on
// the CPU (XLA fuses the product and the sum).  'erfinv':
// sqrt(2) erfinv(u) with u on [nextafter(-1, 0), 1) (jax.random.normal);
// 'box_muller': split(key) gives (k1, k2), u1 on [tiny, 1), u2 on [0, 1)
// over the half row, the cos values then the sin values of each leading
// index (an odd last axis: the cos values of the whole row); 'uniform'
// writes the erfinv path's u (for checks).
//
// Bound on the card at 256^3, f32: one threefry2x32 per element (20
// rounds of add, funnel-shift, xor plus 5 key injections, ~77 32-bit
// operations) and ~30 for the uniform and erfinv, against 4 bytes written:
// ~110 operations per element over 67e12/s is 0.027 ms a field, above the
// 0.020 ms of its 67 MB over 3.35 TB/s, so the integer work bounds it
// (and the H100 issues 32-bit integer operations at half its f32 rate).
// Design: each block takes a row at a time (blockIdx.y, grid-stride); its
// first thread derives the row's key (two threefry calls, four with
// Box-Muller's split) into shared memory, so the fold_ins cost once per
// row and not once per element; threads then work in units of 16 bytes
// (four f32 or two f64 consecutive counters) and write each unit as one
// vector where vector_path holds (ops/cuda/row_draw.py), else element by
// element with the same values.
//
// R2 (row_poisson): jax.random.poisson on the rate rounded to f32.  Below
// 10 (or NaN) Knuth: each step splits the chain key, draws an f32 uniform
// of the element's counter and adds its log, counting while the sum stays
// above -lambda.  Every element of a row walks the same chain of subkeys:
// two warps stage its first 32 steps (Knuth's and the rejection's) in
// shared memory, and a thread walks on from there for its own element
// (three threefry calls a Knuth step become one).  From 10 Hörmann's transformed
// rejection, split(key, 3) per step.  jax runs that loop over a whole row
// until each element has been accepted once (the rate of a Knuth element
// replaced by 1e5) and keeps, per element, the k of its LAST accepted
// step, so a row's elements are coupled through its step count.  A block
// owns a row: it writes the Knuth counts, reduces the row's step count
// (the latest first acceptance, a block max) and walks the rejection
// elements that many steps.  Lambda 0 gives 0.  Counts are written in the
// rate's dtype.  Bound: the data-dependent number of threefry calls and
// transcendentals per element (counted by chip_smoke.py from the run).
//
// R1w/R2w: the whole-array draws of fastbox_tpu's single-device paths,
// jax.random.normal / uniform / poisson(key, shape) with each key taken as
// given (no fold_in): element i of a field hashes the counter (0, i) of its
// flat index, so R1w is R1 on one row the size of the field, its blocks
// spread over the counters (blockIdx.x) and the batch of keys (blockIdx.y).
// Its 'pair' layout writes (re, im) interleaved, a complex tensor's memory:
// re from k1 and im from k2 of split(key) (two jax.random.normal or
// uniform draws), or Box-Muller's (r cos th, r sin th) on (k1, k2)
// (fastbox_tpu.parallel.rng.bm_pair over the whole shape, the layout of
// fields.gaussian._complex_normal).  'uniform' takes jax.random.uniform's
// minval/maxval (the fused multiply-add above).  R2w is jax.random.poisson over a
// whole field: the rejection loop runs until every element of the field
// has been accepted once, so its step count is a maximum over the grid.
// A first launch writes the Knuth counts and each element's first
// acceptance, reduced per block and atomicMax'ed into the key's count; a
// second launch walks the rejection elements that many steps.  Both take
// a grid of a few blocks per SM (grid-stride), so that each block stages
// its chains once.
#include "common.cuh"

namespace {

constexpr int kErfinv = 0, kBoxMuller = 1, kUniform = 2;
constexpr int kThreads = 256;        // R1
constexpr int kUnitsPerThread = 4;   // R1: units a thread takes in a row
constexpr int kPoissonThreads = 512;
// jax's Poisson loops stop at the integer dtype's max; Knuth below rate 10
// and the rejection (acceptance >= ~0.8 a step) end long before this cap.
constexpr int kMaxIters = 1 << 16;

__device__ __forceinline__ float erfinv_t(float x) { return erfinvf(x); }
__device__ __forceinline__ double erfinv_t(double x) { return erfinv(x); }
__device__ __forceinline__ float cos_t(float x) { return cosf(x); }
__device__ __forceinline__ double cos_t(double x) { return cos(x); }
__device__ __forceinline__ float sin_t(float x) { return sinf(x); }
__device__ __forceinline__ double sin_t(double x) { return sin(x); }
__device__ __forceinline__ float max_t(float a, float b) { return a > b ? a : b; }
__device__ __forceinline__ double max_t(double a, double b) { return a > b ? a : b; }

// jax's float in [0, 1) for counter j under key k: the top mantissa bits of
// a value in [1, 2), minus 1 (exact).
__device__ __forceinline__ float unit_float(fbx::U2 k, uint32_t j, float) {
  const fbx::U2 b = fbx::threefry2x32(k.x, k.y, 0u, j);
  return __uint_as_float(((b.x ^ b.y) >> 9) | 0x3F800000u) - 1.0f;
}
__device__ __forceinline__ double unit_float(fbx::U2 k, uint32_t j, double) {
  const fbx::U2 b = fbx::threefry2x32(k.x, k.y, 0u, j);
  const uint64_t w = (static_cast<uint64_t>(b.x) << 32) | b.y;
  return __longlong_as_double(static_cast<long long>((w >> 12) | 0x3FF0000000000000ull)) - 1.0;
}

template <typename T> struct Consts;
template <> struct Consts<float> {
  __device__ static float lo() { return -0x1.fffffep-1f; }   // nextafter(-1, 0)
  __device__ static float tiny() { return 0x1p-126f; }
};
template <> struct Consts<double> {
  __device__ static double lo() { return -0x1.fffffffffffffp-1; }
  __device__ static double tiny() { return 0x1p-1022; }
};

__device__ __forceinline__ float fma_t(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return __fma_rn(a, b, c); }

// jax.random.uniform(k, ..., lo, hi) at counter j: max(lo, f (hi - lo) + lo)
// with the product and the sum in one fused multiply-add, as XLA's CPU
// backend contracts them (on R1's spans, 2 and 1, the product is exact
// and the fused and the separate forms agree).
template <typename T>
__device__ __forceinline__ T uniform(fbx::U2 k, uint32_t j, T lo, T hi) {
  const T f = unit_float(k, j, T(0));
  return max_t(lo, fma_t(f, fbx::sub_rn(hi, lo), lo));
}

template <typename T, int kMethod>
__device__ __forceinline__ T normal_at(fbx::U2 k, uint32_t j) {
  const T u = uniform(k, j, Consts<T>::lo(), T(1));
  if (kMethod == kUniform) return u;
  return fbx::mul_rn(T(1.4142135623730951), erfinv_t(u));
}

// bm_pair at counter q: (r cos th, r sin th)
template <typename T>
__device__ __forceinline__ void box_muller_at(fbx::U2 k1, fbx::U2 k2, uint32_t q, T& c, T& s) {
  const T u1 = uniform(k1, q, Consts<T>::tiny(), T(1));
  const T u2 = unit_float(k2, q, T(0));   // uniform on [0, 1): f * 1 + 0 = f
  const T r = fbx::sqrt_t(fbx::mul_rn(T(-2), fbx::log_t(u1)));
  const T th = fbx::mul_rn(T(6.283185307179586), u2);
  c = fbx::mul_rn(r, cos_t(th));
  s = fbx::mul_rn(r, sin_t(th));
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const T* v) {
  if constexpr (V == 1) {
    p[0] = v[0];
  } else {
    *reinterpret_cast<typename fbx::Vec16<T>::type*>(p) = fbx::Vec16<T>::pack(v);
  }
}

// fold_in(fold_in(key_b, tag), row0 + r) of flat row `row` = b * nrows + r
__device__ __forceinline__ fbx::U2 row_key(const int64_t* keys, uint32_t tag, int64_t row0,
                                           int64_t nrows, int64_t row) {
  const int64_t b = row / nrows;
  fbx::U2 k{static_cast<uint32_t>(keys[2 * b]), static_cast<uint32_t>(keys[2 * b + 1])};
  k = fbx::threefry_fold(k, tag);
  return fbx::threefry_fold(k, static_cast<uint32_t>(row0 + (row - b * nrows)));
}

// (total_rows, L) rows; V consecutive counters a unit (V divides the items
// of a row: L, or L / 2 for Box-Muller's halves, where W / 2 % V == 0).
template <typename T, int kMethod, int V>
__global__ void __launch_bounds__(kThreads)
    row_normal_kernel(const int64_t* __restrict__ keys, uint32_t tag, int64_t row0, int64_t nrows,
                      uint32_t L, uint32_t W, int64_t total_rows, T* __restrict__ out) {
  __shared__ fbx::U2 rk[2];
  const bool halves = kMethod == kBoxMuller && W % 2 == 0;
  const uint32_t hw = W / 2;
  const uint32_t units = (halves ? L / 2 : L) / V;
  for (int64_t row = blockIdx.y; row < total_rows; row += gridDim.y) {
    __syncthreads();   // the previous row's keys are read
    if (threadIdx.x == 0) {
      const fbx::U2 k = row_key(keys, tag, row0, nrows, row);
      rk[0] = kMethod == kBoxMuller ? fbx::threefry_fold(k, 0u) : k;
      rk[1] = kMethod == kBoxMuller ? fbx::threefry_fold(k, 1u) : k;
    }
    __syncthreads();
    const fbx::U2 k1 = rk[0], k2 = rk[1];
    T* o = out + row * static_cast<int64_t>(L);
    for (uint32_t u = blockIdx.x * blockDim.x + threadIdx.x; u < units;
         u += gridDim.x * blockDim.x) {
      const uint32_t q = u * V;
      T a[V], c[V];
      if constexpr (kMethod != kBoxMuller) {
#pragma unroll
        for (int i = 0; i < V; ++i) a[i] = normal_at<T, kMethod>(k1, q + i);
        store<T, V>(o + q, a);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) box_muller_at(k1, k2, q + i, a[i], c[i]);
        if (halves) {
          const uint32_t p = q / hw, w = q - p * hw;
          store<T, V>(o + p * W + w, a);
          store<T, V>(o + p * W + hw + w, c);
        } else {
          store<T, V>(o + q, a);
        }
      }
    }
  }
}

template <typename T, int kMethod>
cudaError_t launch_normal(const int64_t* keys, int64_t B, int64_t tag, int64_t row0, int64_t nrows,
                          int64_t L, int64_t W, int vec, T* out, cudaStream_t stream) {
  const int64_t total = B * nrows;
  const bool halves = kMethod == kBoxMuller && W % 2 == 0;
  const int V = vec ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int64_t units = (halves ? L / 2 : L) / V;
  const int64_t per_block = static_cast<int64_t>(kThreads) * kUnitsPerThread;
  int64_t bx = (units + per_block - 1) / per_block;
  if (bx > 65535) bx = 65535;
  const dim3 grid(static_cast<unsigned>(bx < 1 ? 1 : bx),
                  static_cast<unsigned>(total < 65535 ? total : 65535));
  const uint32_t t = static_cast<uint32_t>(tag);
  if (vec)
    row_normal_kernel<T, kMethod, 16 / sizeof(T)><<<grid, kThreads, 0, stream>>>(
        keys, t, row0, nrows, static_cast<uint32_t>(L), static_cast<uint32_t>(W), total, out);
  else
    row_normal_kernel<T, kMethod, 1><<<grid, kThreads, 0, stream>>>(
        keys, t, row0, nrows, static_cast<uint32_t>(L), static_cast<uint32_t>(W), total, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_normal_method(const int64_t* keys, int64_t B, int64_t tag, int64_t row0,
                                 int64_t nrows, int64_t L, int64_t W, int method, int vec, T* out,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * nrows == 0 || L == 0) return cudaSuccess;
  switch (method) {
    case kErfinv: return launch_normal<T, kErfinv>(keys, B, tag, row0, nrows, L, W, vec, out, s);
    case kBoxMuller:
      return launch_normal<T, kBoxMuller>(keys, B, tag, row0, nrows, L, W, vec, out, s);
    case kUniform: return launch_normal<T, kUniform>(keys, B, tag, row0, nrows, L, W, vec, out, s);
    default: return cudaErrorInvalidValue;
  }
}

// The first kChain steps of a row's two chains of subkeys, which every
// element of the row walks: Knuth's split(r) and the rejection's
// split(r, 3); a longer walk goes on from the chain key after them.
constexpr int kChain = 32;
struct Chains {
  fbx::U2 knuth[kChain];    // the uniform's key of Knuth step t + 1
  fbx::U2 rej[kChain][2];   // the two uniforms' keys of rejection step t + 1
  fbx::U2 knuth_next, rej_next;
};

__device__ void fill_chain(Chains& c, fbx::U2 r, bool rejection) {
  for (int t = 0; t < kChain; ++t) {
    if (rejection) {
      c.rej[t][0] = fbx::threefry_fold(r, 1u);
      c.rej[t][1] = fbx::threefry_fold(r, 2u);
    } else {
      c.knuth[t] = fbx::threefry_fold(r, 1u);
    }
    r = fbx::threefry_fold(r, 0u);
  }
  (rejection ? c.rej_next : c.knuth_next) = r;
}

// jax's Knuth loop for one element: uniforms drawn while the log sum stays
// above -lam, less one.
__device__ int64_t knuth(const Chains& c, uint32_t j, float lam) {
  const float neg = -lam;
  float lp = 0.0f;
  int64_t k = 0;
  fbx::U2 r = c.knuth_next;
  while (lp > neg && k < kMaxIters) {
    ++k;
    fbx::U2 sub;
    if (k <= kChain) {
      sub = c.knuth[k - 1];
    } else {
      sub = fbx::threefry_fold(r, 1u);
      r = fbx::threefry_fold(r, 0u);
    }
    lp = fbx::add_rn(lp, logf(unit_float(sub, j, 0.0f)));
  }
  return k - 1;
}

// jax's transformed rejection for one element at rate lam (f32, every
// operation rounded as jax writes it).  steps < 0: returns the step of the
// first acceptance.  Else walks `steps` steps and returns the k of the
// last acceptance (-1 if none).
__device__ float rejection(const Chains& c, uint32_t j, float lam, int steps) {
  using fbx::add_rn;
  using fbx::div_rn;
  using fbx::mul_rn;
  using fbx::sub_rn;
  const float log_lam = logf(lam);
  const float b = add_rn(0.931f, mul_rn(2.53f, sqrtf(lam)));
  const float a = add_rn(-0.059f, mul_rn(0.02483f, b));
  const float inv_alpha = add_rn(1.1239f, div_rn(1.1328f, sub_rn(b, 3.4f)));
  const float v_r = sub_rn(0.9277f, div_rn(3.6224f, sub_rn(b, 2.0f)));
  const int n = steps < 0 ? kMaxIters : steps;
  float last = -1.0f;
  fbx::U2 r = c.rej_next;
  for (int it = 1; it <= n; ++it) {
    fbx::U2 s0, s1;
    if (it <= kChain) {
      s0 = c.rej[it - 1][0];
      s1 = c.rej[it - 1][1];
    } else {
      s0 = fbx::threefry_fold(r, 1u);
      s1 = fbx::threefry_fold(r, 2u);
      r = fbx::threefry_fold(r, 0u);
    }
    const float u = unit_float(s0, j, 0.0f) - 0.5f;   // exact
    const float v = unit_float(s1, j, 0.0f);
    const float us = sub_rn(0.5f, fabsf(u));
    const float k =
        floorf(add_rn(add_rn(mul_rn(add_rn(div_rn(mul_rn(2.0f, a), us), b), u), lam), 0.43f));
    const float s = logf(div_rn(mul_rn(v, inv_alpha), add_rn(div_rn(a, mul_rn(us, us)), b)));
    const float t = sub_rn(add_rn(-lam, mul_rn(k, log_lam)), lgammaf(add_rn(k, 1.0f)));
    const bool accept1 = us >= 0.07f && v <= v_r;
    const bool reject = k < 0.0f || (us < 0.013f && v > us);
    if (accept1 || (!reject && s <= t)) {
      if (steps < 0) return static_cast<float>(it);
      last = k;
    }
  }
  return steps < 0 ? static_cast<float>(n) : last;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(double x) { return __double2float_rn(x); }
__device__ __forceinline__ bool knuth_rate(float x) { return x != x || x < 10.0f; }

struct IntMax {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// A block per row (grid-stride): the Knuth counts, then, where the row has
// rejection rates, its step count and the rejection counts.
template <typename T>
__global__ void __launch_bounds__(kPoissonThreads)
    row_poisson_kernel(const int64_t* __restrict__ keys, uint32_t tag, int64_t row0, int64_t nrows,
                       uint32_t L, int64_t total_rows, const T* __restrict__ lam,
                       T* __restrict__ out) {
  __shared__ Chains chains;
  __shared__ int scratch[32];
  const IntMax imax;
  for (int64_t row = blockIdx.x; row < total_rows; row += gridDim.x) {
    __syncthreads();   // the previous row's chains are read
    if (threadIdx.x == 0 || threadIdx.x == 32)   // two warps, side by side
      fill_chain(chains, row_key(keys, tag, row0, nrows, row), threadIdx.x == 32);
    __syncthreads();
    const T* lr = lam + row * static_cast<int64_t>(L);
    T* o = out + row * static_cast<int64_t>(L);
    int rej = 0;
    for (uint32_t j = threadIdx.x; j < L; j += blockDim.x) {
      const float x = to_f32(lr[j]);
      if (knuth_rate(x))
        o[j] = x == 0.0f ? T(0) : static_cast<T>(knuth(chains, j, x));
      else
        rej = 1;
    }
    if (!fbx::block_reduce(rej, scratch, imax)) continue;
    int steps = 0;
    for (uint32_t j = threadIdx.x; j < L; j += blockDim.x) {
      const float x = to_f32(lr[j]);
      const int first = static_cast<int>(rejection(chains, j, knuth_rate(x) ? 1e5f : x, -1));
      steps = first > steps ? first : steps;
    }
    steps = fbx::block_reduce(steps, scratch, imax);
    for (uint32_t j = threadIdx.x; j < L; j += blockDim.x) {
      const float x = to_f32(lr[j]);
      if (!knuth_rate(x)) o[j] = static_cast<T>(rejection(chains, j, x, steps));
    }
  }
}

template <typename T>
cudaError_t launch_poisson(const int64_t* keys, int64_t B, int64_t tag, int64_t row0, int64_t nrows,
                           int64_t L, const T* lam, T* out, void* stream) {
  const int64_t total = B * nrows;
  if (total == 0 || L == 0) return cudaSuccess;
  row_poisson_kernel<T><<<static_cast<unsigned>(total < 65535 ? total : 65535), kPoissonThreads,
                          0, static_cast<cudaStream_t>(stream)>>>(
      keys, static_cast<uint32_t>(tag), row0, nrows, static_cast<uint32_t>(L), total, lam, out);
  return cudaGetLastError();
}

// R1w: a block per 4 * kThreads units of one key's field (blockIdx.y the
// key); kPair: (re, im) pairs from split(key); kVec: E elements a unit
// written as one 16-byte vector, else one element a unit.
template <typename T, int kMethod, bool kPair, bool kVec>
__global__ void __launch_bounds__(kThreads)
    key_draw_kernel(const int64_t* __restrict__ keys, int64_t n, T lo, T hi,
                    T* __restrict__ out) {
  __shared__ fbx::U2 kk[2];
  const int64_t b = blockIdx.y;
  if (threadIdx.x == 0) {
    const fbx::U2 k{static_cast<uint32_t>(keys[2 * b]), static_cast<uint32_t>(keys[2 * b + 1])};
    kk[0] = kPair ? fbx::threefry_fold(k, 0u) : k;
    kk[1] = kPair ? fbx::threefry_fold(k, 1u) : k;
  }
  __syncthreads();
  const fbx::U2 k1 = kk[0], k2 = kk[1];
  constexpr int S = kPair ? 2 : 1;   // values an element
  constexpr int E = kVec ? 16 / static_cast<int>(sizeof(T)) / S : 1;   // elements a unit
  constexpr int V = E * S;           // values a unit
  T* o = out + b * n * S;
  const int64_t units = n / E;
  for (int64_t u = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; u < units;
       u += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const uint32_t q = static_cast<uint32_t>(u * E);
    T v[V];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if constexpr (kMethod == kBoxMuller) {
        box_muller_at(k1, k2, q + i, v[2 * i], v[2 * i + 1]);
      } else if constexpr (kMethod == kErfinv) {
        v[S * i] = normal_at<T, kErfinv>(k1, q + i);
        if constexpr (kPair) v[2 * i + 1] = normal_at<T, kErfinv>(k2, q + i);
      } else {
        v[S * i] = uniform(k1, q + i, lo, hi);
        if constexpr (kPair) v[2 * i + 1] = uniform(k2, q + i, lo, hi);
      }
    }
    T* p = o + static_cast<int64_t>(q) * S;
    if constexpr (kVec) {
      store<T, V>(p, v);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) p[i] = v[i];
    }
  }
}

template <typename T, int kMethod, bool kPair>
cudaError_t launch_key_draw(const int64_t* keys, int64_t B, int64_t n, T lo, T hi, int vec, T* out,
                            cudaStream_t stream) {
  constexpr int S = kPair ? 2 : 1;
  constexpr int EV = 16 / static_cast<int>(sizeof(T)) / S;   // elements a 16-byte unit
  const int E = vec ? EV : 1;
  const int64_t units = n / E;
  const int64_t per_block = static_cast<int64_t>(kThreads) * kUnitsPerThread;
  int64_t bx = (units + per_block - 1) / per_block;
  if (bx > 65535) bx = 65535;
  const dim3 grid(static_cast<unsigned>(bx < 1 ? 1 : bx), static_cast<unsigned>(B));
  if (vec)
    key_draw_kernel<T, kMethod, kPair, true><<<grid, kThreads, 0, stream>>>(keys, n, lo, hi, out);
  else
    key_draw_kernel<T, kMethod, kPair, false><<<grid, kThreads, 0, stream>>>(keys, n, lo, hi, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_key_draw_method(const int64_t* keys, int64_t B, int64_t n, int method, int pair,
                                   double lo, double hi, int vec, T* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || n == 0) return cudaSuccess;
  if (B > 65535) return cudaErrorInvalidValue;
  const T l = static_cast<T>(lo), h = static_cast<T>(hi);
  if (pair) {
    switch (method) {
      case kErfinv: return launch_key_draw<T, kErfinv, true>(keys, B, n, l, h, vec, out, s);
      case kBoxMuller: return launch_key_draw<T, kBoxMuller, true>(keys, B, n, l, h, vec, out, s);
      case kUniform: return launch_key_draw<T, kUniform, true>(keys, B, n, l, h, vec, out, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (method) {
    case kErfinv: return launch_key_draw<T, kErfinv, false>(keys, B, n, l, h, vec, out, s);
    case kUniform: return launch_key_draw<T, kUniform, false>(keys, B, n, l, h, vec, out, s);
    default: return cudaErrorInvalidValue;   // Box-Muller draws pairs
  }
}

// R2w, first launch: the Knuth counts of the key's field (blockIdx.y), and
// the latest first acceptance of the rejection loop over the field (every
// element at its rate, a Knuth element's at 1e5, as jax runs it), a block
// max atomicMax'ed into steps[b].
template <typename T>
__global__ void __launch_bounds__(kPoissonThreads)
    key_poisson_first_kernel(const int64_t* __restrict__ keys, int64_t n,
                             const T* __restrict__ lam, T* __restrict__ out, int* steps) {
  __shared__ Chains chains;
  __shared__ int scratch[32];
  const int64_t b = blockIdx.y;
  if (threadIdx.x == 0 || threadIdx.x == 32)
    fill_chain(chains, fbx::U2{static_cast<uint32_t>(keys[2 * b]),
                               static_cast<uint32_t>(keys[2 * b + 1])},
               threadIdx.x == 32);
  __syncthreads();
  const T* lr = lam + b * n;
  T* o = out + b * n;
  int first = 0;
  for (int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; j < n;
       j += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float x = to_f32(lr[j]);
    const uint32_t c = static_cast<uint32_t>(j);
    if (knuth_rate(x)) o[j] = x == 0.0f ? T(0) : static_cast<T>(knuth(chains, c, x));
    const int f = static_cast<int>(rejection(chains, c, knuth_rate(x) ? 1e5f : x, -1));
    first = f > first ? f : first;
  }
  first = fbx::block_reduce(first, scratch, IntMax());
  if (threadIdx.x == 0) atomicMax(steps + b, first);
}

// R2w, second launch: the rejection elements walk steps[b] steps and keep
// the k of their last acceptance.
template <typename T>
__global__ void __launch_bounds__(kPoissonThreads)
    key_poisson_walk_kernel(const int64_t* __restrict__ keys, int64_t n,
                            const T* __restrict__ lam, T* __restrict__ out,
                            const int* __restrict__ steps) {
  __shared__ Chains chains;
  const int64_t b = blockIdx.y;
  if (threadIdx.x == 0)
    fill_chain(chains, fbx::U2{static_cast<uint32_t>(keys[2 * b]),
                               static_cast<uint32_t>(keys[2 * b + 1])}, true);
  __syncthreads();
  const int walk = steps[b];
  const T* lr = lam + b * n;
  T* o = out + b * n;
  for (int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; j < n;
       j += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float x = to_f32(lr[j]);
    if (!knuth_rate(x)) o[j] = static_cast<T>(rejection(chains, static_cast<uint32_t>(j), x, walk));
  }
}

template <typename T>
cudaError_t launch_key_poisson(const int64_t* keys, int64_t B, int64_t n, const T* lam, T* out,
                               int* steps, void* stream) {
  if (B == 0 || n == 0) return cudaSuccess;
  if (B > 65535) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // a few blocks a multiprocessor in all, each staging its chains once
  int64_t bx = (n + kPoissonThreads - 1) / kPoissonThreads;
  const int64_t cap = (4 * static_cast<int64_t>(sms) + B - 1) / B;
  if (bx > cap) bx = cap;
  const dim3 grid(static_cast<unsigned>(bx < 1 ? 1 : bx), static_cast<unsigned>(B));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  key_poisson_first_kernel<T><<<grid, kPoissonThreads, 0, s>>>(keys, n, lam, out, steps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  key_poisson_walk_kernel<T><<<grid, kPoissonThreads, 0, s>>>(keys, n, lam, out, steps);
  return cudaGetLastError();
}

}  // namespace

// R1w.  keys: (B, 2) int64 words (device), taken as given; out: (B, n)
// contiguous, or (B, n, 2) with pair = 1 ((re, im) from split(key));
// method 0 erfinv, 1 box_muller (pair only), 2 uniform on [lo, hi); vec: 1
// for 16-byte stores (ops/cuda/row_draw.py key_vector_path), 0 element by
// element.
extern "C" int fbx_key_normal_f32(const int64_t* keys, int64_t B, int64_t n, int method, int pair,
                                  double lo, double hi, int vec, float* out, void* stream) {
  return launch_key_draw_method(keys, B, n, method, pair, lo, hi, vec, out, stream);
}

extern "C" int fbx_key_normal_f64(const int64_t* keys, int64_t B, int64_t n, int method, int pair,
                                  double lo, double hi, int vec, double* out, void* stream) {
  return launch_key_draw_method(keys, B, n, method, pair, lo, hi, vec, out, stream);
}

// R2w.  keys as above; lam, out: (B, n) contiguous, counts in lam's dtype;
// steps: (B,) int32, zero (the step counts of the rejection loops).
extern "C" int fbx_key_poisson_f32(const int64_t* keys, int64_t B, int64_t n, const float* lam,
                                   float* out, int* steps, void* stream) {
  return launch_key_poisson(keys, B, n, lam, out, steps, stream);
}

extern "C" int fbx_key_poisson_f64(const int64_t* keys, int64_t B, int64_t n, const double* lam,
                                   double* out, int* steps, void* stream) {
  return launch_key_poisson(keys, B, n, lam, out, steps, stream);
}

// keys: (B, 2) int64 words (device); out: (B * nrows, L) contiguous, L the
// product of the row shape and W its last axis (1 for a scalar row);
// method 0 erfinv, 1 box_muller, 2 uniform; vec: 1 for 16-byte stores
// (ops/cuda/row_draw.py vector_path), 0 element by element.
extern "C" int fbx_row_normal_f32(const int64_t* keys, int64_t B, int64_t tag, int64_t row0,
                                  int64_t nrows, int64_t L, int64_t W, int method, int vec,
                                  float* out, void* stream) {
  return launch_normal_method(keys, B, tag, row0, nrows, L, W, method, vec, out, stream);
}

extern "C" int fbx_row_normal_f64(const int64_t* keys, int64_t B, int64_t tag, int64_t row0,
                                  int64_t nrows, int64_t L, int64_t W, int method, int vec,
                                  double* out, void* stream) {
  return launch_normal_method(keys, B, tag, row0, nrows, L, W, method, vec, out, stream);
}

// keys as above; lam, out: (B * nrows, L) contiguous, counts in lam's dtype.
extern "C" int fbx_row_poisson_f32(const int64_t* keys, int64_t B, int64_t tag, int64_t row0,
                                   int64_t nrows, int64_t L, const float* lam, float* out,
                                   void* stream) {
  return launch_poisson(keys, B, tag, row0, nrows, L, lam, out, stream);
}

extern "C" int fbx_row_poisson_f64(const int64_t* keys, int64_t B, int64_t tag, int64_t row0,
                                   int64_t nrows, int64_t L, const double* lam, double* out,
                                   void* stream) {
  return launch_poisson(keys, B, tag, row0, nrows, L, lam, out, stream);
}
