// R1/R2: jax.random's row-keyed draws for a batch of keys, one launch a field (R2: four).
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
// above -lambda.  From 10 Hörmann's transformed rejection, split(key, 3)
// per step.  Both loops split the same chain r_{t+1} = fold(r_t, 0) from
// the row key, and every element of a row walks it.  jax runs the
// rejection loop over a whole row until each element has been accepted
// once (the rate of a Knuth element replaced by 1e5) and keeps, per
// element, the k of its LAST accepted step, so a row's elements are coupled
// through its step count S, the latest first acceptance.  Lambda 0 gives
// 0.  Counts are written in the rate's dtype.
//
// R2 and R2w are one design over R rows of L elements (R2w: a field per
// key, one row), in four launches:
//  0. chains: a block per row derives its chain and the subkeys of the
//     first kChain steps into device scratch (the chain on one thread, the
//     subkeys in parallel), once per row;
//  1. Knuth, over (row, tile) tiles sized so that the grid fills the card
//     whatever R is: a block copies its row's chains to shared memory, each
//     warp stages its segment's rates, queues the Knuth-loop elements and
//     walks them a lane each, a finished lane taking the queue's next
//     element; the counts leave in one coalesced pass.  The segment's
//     rejection elements go to a compact list (one atomicAdd a block) and
//     flag their row;
//  2. first acceptances over the flagged rows' tiles, the lanes refilled
//     as in pass 1: each element's first acceptance, the tile's latest
//     atomicMax'ed into its row's S.  A row without a rejection rate does
//     none of this rejection work;
//  3. the walk: a thread per listed element, S[row] steps in full warps.
//     No count depends on the list's order.  Where the list outgrew its
//     room (nearly every element a rejection element), the walk visits
//     every element instead, its warps as full.
// Bound: the threefry calls that the data need (Knuth's count + 1 a
// Knuth element, a first acceptance of two a step for every element of a
// row that holds a rejection rate, S steps of two a rejection element)
// and the transcendentals beside them, issued as 32-bit integer work
// (counted by chip_smoke.py from the run); the lane refill keeps a warp's
// steps near its elements' mean, where a lane per element ran its
// warp's largest count (times: PERF.md, section 6).
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
// has been accepted once, so its S is a maximum over the field: R2's
// launches with a row per key, the key as given.
#include "common.cuh"

namespace {

constexpr int kErfinv = 0, kBoxMuller = 1, kUniform = 2;
constexpr int kThreads = 256;        // R1
constexpr int kUnitsPerThread = 4;   // R1: units a thread takes in a row
constexpr int kPoissonThreads = 256;   // R2/R2w: 8 warps
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

// ---------------------------------------------------------------------------
// R2/R2w: one Poisson design for R rows of L elements, each row under its
// own key (R2: the B * nrows folded row keys; R2w: the B keys as given).
// ---------------------------------------------------------------------------

// A row's chain of subkeys, which every element of the row walks: step
// t + 1 of Knuth's loop (split(r_t)) draws under sub[0][t], step t + 1 of
// the rejection (split(r_t, 3)) under sub[0][t] and sub[1][t], with r_0
// the row key and r_{t+1} = fold(r_t, 0); `next` is r_kChain, from which a
// longer walk derives its keys.  Derived once per row (poisson_chain_kernel)
// into device scratch; a block copies its row's to shared memory.
constexpr int kChain = 32;
struct Chains {
  fbx::U2 sub[2][kChain];
  fbx::U2 next;
};
constexpr int kChainWords = static_cast<int>(sizeof(Chains) / 4);
constexpr int kWarps = kPoissonThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Tiles of a row: kMaxTile elements, halved (to kMinTile) until the grid
// holds kTilesPerSm tiles a multiprocessor.
constexpr int64_t kMaxTile = 4096, kMinTile = 256, kTilesPerSm = 8;

// The scratch (int32 words), in order: the chains (R * kChainWords), the
// list's length (two words), each row's step count and flag (R each), then
// the list of the rejection elements' flat indices, as long as the rest.
// The rest is sized to the rate field (the scratch is at most its size, or
// the fixed part where that is larger); where more rejection elements are
// listed than it holds, the walk visits every element instead.
int64_t poisson_fixed_words(int64_t R) { return R * (kChainWords + 2) + 2; }

int64_t poisson_scratch_words(int64_t R, int64_t L, int elem_bytes) {
  const int64_t fixed = poisson_fixed_words(R), n = R * L;
  if (n > static_cast<int64_t>(UINT32_MAX)) return fixed;   // 32-bit list entries
  const int64_t total = n * elem_bytes / 4;
  return fixed > total ? fixed : (total < n + fixed ? total : n + fixed);
}

struct PoissonArgs {
  int64_t R, L, tile, tiles_per_row;
  Chains* chains;
  unsigned long long* listed;   // elements appended to the list
  int* steps;                   // a row's step count S (0: no rejection rate)
  int* flags;                   // a row holds a rejection rate
  uint32_t* list;
  unsigned long long capacity;
};

// fold_in(fold_in(key_b, tag), row0 + r) for R2 (fold), key_b for R2w
struct RowKeys {
  const int64_t* keys;
  uint32_t tag;
  int64_t row0, nrows;
  bool fold;
  __device__ fbx::U2 operator()(int64_t row) const {
    if (fold) return row_key(keys, tag, row0, nrows, row);
    return fbx::U2{static_cast<uint32_t>(keys[2 * row]), static_cast<uint32_t>(keys[2 * row + 1])};
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(double x) { return __double2float_rn(x); }
__device__ __forceinline__ bool knuth_rate(float x) { return x != x || x < 10.0f; }

struct IntMax {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// Hörmann's per-rate constants, rounded as jax writes them.
struct Rejection {
  float lam, log_lam, b, a, inv_alpha, v_r;
  __device__ explicit Rejection(float x) : lam(x) {
    using fbx::add_rn;
    using fbx::div_rn;
    using fbx::mul_rn;
    using fbx::sub_rn;
    log_lam = logf(x);
    b = add_rn(0.931f, mul_rn(2.53f, sqrtf(x)));
    a = add_rn(-0.059f, mul_rn(0.02483f, b));
    inv_alpha = add_rn(1.1239f, div_rn(1.1328f, sub_rn(b, 3.4f)));
    v_r = sub_rn(0.9277f, div_rn(3.6224f, sub_rn(b, 2.0f)));
  }
  // One step under the keys (s0, s1) at counter j: whether it accepts; k
  // its candidate.
  __device__ bool step(fbx::U2 s0, fbx::U2 s1, uint32_t j, float& k) const {
    using fbx::add_rn;
    using fbx::div_rn;
    using fbx::mul_rn;
    using fbx::sub_rn;
    const float u = unit_float(s0, j, 0.0f) - 0.5f;   // exact
    const float v = unit_float(s1, j, 0.0f);
    const float us = sub_rn(0.5f, fabsf(u));
    k = floorf(add_rn(add_rn(mul_rn(add_rn(div_rn(mul_rn(2.0f, a), us), b), u), lam), 0.43f));
    const float s = logf(div_rn(mul_rn(v, inv_alpha), add_rn(div_rn(a, mul_rn(us, us)), b)));
    const float t = sub_rn(add_rn(-lam, mul_rn(k, log_lam)), lgammaf(add_rn(k, 1.0f)));
    const bool accept1 = us >= 0.07f && v <= v_r;
    const bool reject = k < 0.0f || (us < 0.013f && v > us);
    return accept1 || (!reject && s <= t);
  }
};

// The keys of rejection step `it` (from 1); r carries the chain beyond
// kChain (start it at c.next).
__device__ __forceinline__ void rejection_keys(const Chains& c, int it, fbx::U2& r, fbx::U2& s0,
                                               fbx::U2& s1) {
  if (it <= kChain) {
    s0 = c.sub[0][it - 1];
    s1 = c.sub[1][it - 1];
  } else {
    s0 = fbx::threefry_fold(r, 1u);
    s1 = fbx::threefry_fold(r, 2u);
    r = fbx::threefry_fold(r, 0u);
  }
}

// Pass 0, a block of 2 * kChain threads per row: the row key and its
// chain r_0..r_kChain on one thread, the 2 * kChain subkeys one a thread;
// the row's step count, flag and (row 0) the list's length zeroed.
__global__ void __launch_bounds__(2 * kChain)
    poisson_chain_kernel(RowKeys keys, PoissonArgs p) {
  __shared__ fbx::U2 r[kChain + 1];
  const int64_t row = blockIdx.x;
  if (threadIdx.x == 0) {
    fbx::U2 k = keys(row);
    r[0] = k;
    for (int t = 1; t <= kChain; ++t) r[t] = k = fbx::threefry_fold(k, 0u);
    p.chains[row].next = k;
    p.steps[row] = 0;
    p.flags[row] = 0;
    if (row == 0) *p.listed = 0;
  }
  __syncthreads();
  const int d = threadIdx.x / kChain, t = threadIdx.x % kChain;
  p.chains[row].sub[d][t] = fbx::threefry_fold(r[t], d + 1u);
}

// A block's tile: its row, the tile's first element in the row, and warp
// w's segment [a, b) of tile offsets (empty past the row's end).
struct Segment {
  int64_t row;
  uint32_t first, a, b;
  __device__ explicit Segment(const PoissonArgs& p) {
    row = blockIdx.x / p.tiles_per_row;
    const int64_t t0 = (blockIdx.x - row * p.tiles_per_row) * p.tile;
    const int64_t len = p.L - t0 < p.tile ? p.L - t0 : p.tile;
    const int64_t seg = p.tile / kWarps, a0 = (threadIdx.x >> 5) * seg;
    first = static_cast<uint32_t>(t0);
    a = static_cast<uint32_t>(a0 < len ? a0 : len);
    b = static_cast<uint32_t>(a0 + seg < len ? a0 + seg : len);
  }
};

// The block's chains from device scratch into shared memory.
__device__ void stage_chains(Chains& c, const Chains* g) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(g);
  uint32_t* dst = reinterpret_cast<uint32_t*>(&c);
  for (int i = threadIdx.x; i < kChainWords; i += blockDim.x) dst[i] = src[i];
}

// Pass 1 over (row, tile) tiles: the Knuth counts, the rejection elements
// appended to the list (one atomicAdd a block) and their rows flagged.
// Each warp stages its segment's rates (rounded to f32) in shared memory
// and queues its Knuth-loop elements (rates in (0, 10)) at the segment's
// front and its rejection elements at its back; 0 and NaN are answered at
// once.  A lane per queued element walks Knuth's loop, and a lane whose
// element is done takes the queue's next one, so that a warp runs about
// its queue's mean Knuth count and not its lanes' largest.  The counts
// collect in shared memory and leave in one coalesced pass.
template <typename T>
__global__ void __launch_bounds__(kPoissonThreads)
    poisson_knuth_kernel(PoissonArgs p, const T* __restrict__ lam, T* __restrict__ out) {
  __shared__ Chains c;
  __shared__ float xs[kMaxTile];       // rates, then counts (NaN: a rejection element)
  __shared__ uint16_t q[kMaxTile];     // the queues, tile offsets
  __shared__ unsigned long long base[kWarps];
  const Segment sg(p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  stage_chains(c, p.chains + sg.row);
  const T* lr = lam + sg.row * p.L + sg.first;
  uint32_t nk = 0, nr = 0;   // warp-uniform: queued Knuth and rejection elements
  for (uint32_t i0 = sg.a; i0 < sg.b; i0 += 32) {
    const uint32_t i = i0 + lane;
    const bool in = i < sg.b;
    const float x = in ? to_f32(lr[i]) : 0.0f;
    const bool loop = in && x > 0.0f && x < 10.0f;
    const bool rej = in && !knuth_rate(x);
    // 0 (or -0) gives 0; NaN and negative rates never enter the loop
    if (in) xs[i] = loop ? x : rej ? __int_as_float(0x7fffffff) : x == 0.0f ? 0.0f : -1.0f;
    const unsigned ml = __ballot_sync(kFull, loop), mr = __ballot_sync(kFull, rej);
    if (loop) q[sg.a + nk + __popc(ml & lt)] = static_cast<uint16_t>(i);
    if (rej) q[sg.b - 1 - nr - __popc(mr & lt)] = static_cast<uint16_t>(i);
    nk += __popc(ml);
    nr += __popc(mr);
  }
  if (lane == 0) base[warp] = nr;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += base[w];
    unsigned long long at = total ? atomicAdd(p.listed, total) : 0;
    if (total) p.flags[sg.row] = 1;
    for (int w = 0; w < kWarps; ++w) {
      const unsigned long long m = base[w];
      base[w] = at;
      at += m;
    }
  }
  __syncthreads();
  const int64_t flat = sg.row * p.L + sg.first;   // the tile's first flat index
  for (uint32_t n = lane; n < nr; n += 32) {
    const unsigned long long at = base[warp] + n;
    if (at < p.capacity) p.list[at] = static_cast<uint32_t>(flat + q[sg.b - 1 - n]);
  }
  uint32_t next = 0, i = 0;   // next: warp-uniform
  bool live = false;
  float neg = 0.0f, lp = 0.0f;
  int k = 0;
  const fbx::U2 r0 = c.next;
  fbx::U2 r = r0;
  for (;;) {
    const unsigned need = __ballot_sync(kFull, !live);
    if (need && next < nk) {
      const uint32_t mine = next + __popc(need & lt);
      next += __popc(need);
      if (!live && mine < nk) {
        i = q[sg.a + mine];
        live = true;
        neg = -xs[i];
        lp = 0.0f;
        k = 0;
        r = r0;
      }
    }
    if (!__any_sync(kFull, live)) break;
    if (live) {   // one step of jax's Knuth loop
      ++k;
      fbx::U2 sub;
      if (k <= kChain) {
        sub = c.sub[0][k - 1];
      } else {
        sub = fbx::threefry_fold(r, 1u);
        r = fbx::threefry_fold(r, 0u);
      }
      lp = fbx::add_rn(lp, logf(unit_float(sub, sg.first + i, 0.0f)));
      if (!(lp > neg && k < kMaxIters)) {
        xs[i] = static_cast<float>(k - 1);   // exact
        live = false;
      }
    }
  }
  __syncwarp();
  T* o = out + flat;
  for (uint32_t j = sg.a + lane; j < sg.b; j += 32) {
    const float v = xs[j];
    if (v == v) o[j] = static_cast<T>(v);   // the walk writes the rejection elements
  }
}

// Pass 2 over the flagged rows' tiles: each element's first acceptance
// of the rejection loop (at its rate, a Knuth element's at 1e5, as jax
// runs it), the rates staged and the lanes refilled as in pass 1; the
// tile's latest atomicMax'ed into its row's step count.
template <typename T>
__global__ void __launch_bounds__(kPoissonThreads)
    poisson_first_kernel(PoissonArgs p, const T* __restrict__ lam) {
  __shared__ Chains c;
  __shared__ float xs[kMaxTile];
  __shared__ int scratch[32];
  const Segment sg(p);
  if (!p.flags[sg.row]) return;   // the whole block
  stage_chains(c, p.chains + sg.row);
  const unsigned lt = (1u << (threadIdx.x & 31)) - 1u;
  const T* lr = lam + sg.row * p.L + sg.first;
  for (uint32_t j = sg.a + (threadIdx.x & 31); j < sg.b; j += 32) xs[j] = to_f32(lr[j]);
  __syncthreads();
  const Rejection high(1e5f);   // every Knuth element's
  Rejection q = high;
  uint32_t next = sg.a, i = 0;
  bool live = false;
  int it = 0, first = 0;
  const fbx::U2 r0 = c.next;
  fbx::U2 r = r0;
  for (;;) {
    const unsigned need = __ballot_sync(kFull, !live);
    if (need && next < sg.b) {
      const uint32_t mine = next + __popc(need & lt);
      next += __popc(need);
      if (!live && mine < sg.b) {
        const float x = xs[mine];
        if (knuth_rate(x))
          q = high;
        else
          q = Rejection(x);
        live = true;
        i = mine;
        it = 0;
        r = r0;
      }
    }
    if (!__any_sync(kFull, live)) break;
    if (live) {
      ++it;
      fbx::U2 s0, s1;
      rejection_keys(c, it, r, s0, s1);
      float k;
      if (q.step(s0, s1, sg.first + i, k) || it >= kMaxIters) {
        first = it > first ? it : first;
        live = false;
      }
    }
  }
  first = fbx::block_reduce(first, scratch, IntMax());
  if (threadIdx.x == 0) atomicMax(p.steps + sg.row, first);
}

// Pass 3, the walk: a thread per listed element (every element where the
// list overflowed), S[row] steps, the k of the last acceptance (-1 if
// none).  The list's order is the atomics', and no count depends on it.
template <typename T>
__global__ void __launch_bounds__(kPoissonThreads)
    poisson_walk_kernel(PoissonArgs p, const T* __restrict__ lam, T* __restrict__ out) {
  using u64 = unsigned long long;
  const u64 listed = *p.listed;
  const bool all = listed > p.capacity;
  const u64 n = all ? static_cast<u64>(p.R * p.L) : listed;
  for (u64 g = blockIdx.x * static_cast<u64>(blockDim.x) + threadIdx.x; g < n;
       g += static_cast<u64>(gridDim.x) * blockDim.x) {
    const int64_t e = all ? static_cast<int64_t>(g) : static_cast<int64_t>(p.list[g]);
    const float x = to_f32(lam[e]);
    if (all && knuth_rate(x)) continue;
    const int64_t row = e / p.L;
    const uint32_t j = static_cast<uint32_t>(e - row * p.L);
    const Chains& c = p.chains[row];
    const Rejection q(x);
    const int steps = p.steps[row];
    float last = -1.0f;
    fbx::U2 r = c.next;
    for (int it = 1; it <= steps; ++it) {
      fbx::U2 s0, s1;
      rejection_keys(c, it, r, s0, s1);
      float k;
      if (q.step(s0, s1, j, k)) last = k;
    }
    out[e] = static_cast<T>(last);
  }
}

template <typename T>
cudaError_t launch_poisson(const RowKeys& keys, int64_t R, int64_t L, const T* lam, T* out,
                           int32_t* scratch, int64_t words, void* stream) {
  if (R == 0 || L == 0) return cudaSuccess;
  const int64_t fixed = poisson_fixed_words(R);
  if (words < fixed) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  PoissonArgs p;
  p.R = R;
  p.L = L;
  p.tile = kMaxTile;
  while (p.tile > kMinTile && R * ((L + p.tile - 1) / p.tile) < kTilesPerSm * sms) p.tile /= 2;
  p.tiles_per_row = (L + p.tile - 1) / p.tile;
  p.chains = reinterpret_cast<Chains*>(scratch);
  p.listed = reinterpret_cast<unsigned long long*>(scratch + R * kChainWords);
  p.steps = scratch + R * kChainWords + 2;
  p.flags = p.steps + R;
  p.list = reinterpret_cast<uint32_t*>(p.flags + R);
  p.capacity = static_cast<unsigned long long>(words - fixed);
  const int64_t tiles = R * p.tiles_per_row;
  if (R > INT32_MAX || tiles > INT32_MAX) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  poisson_chain_kernel<<<static_cast<unsigned>(R), 2 * kChain, 0, s>>>(keys, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  poisson_knuth_kernel<T><<<static_cast<unsigned>(tiles), kPoissonThreads, 0, s>>>(p, lam, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  poisson_first_kernel<T><<<static_cast<unsigned>(tiles), kPoissonThreads, 0, s>>>(p, lam);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t want = (R * L + kPoissonThreads - 1) / kPoissonThreads;   // walk: 4 a SM
  const int64_t walkers = want < 4 * static_cast<int64_t>(sms) ? want : 4 * sms;
  poisson_walk_kernel<T><<<static_cast<unsigned>(walkers), kPoissonThreads, 0, s>>>(p, lam, out);
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
// scratch: fbx_poisson_scratch(B, n, dtype size) int32 words.
extern "C" int fbx_key_poisson_f32(const int64_t* keys, int64_t B, int64_t n, const float* lam,
                                   float* out, int32_t* scratch, int64_t words, void* stream) {
  return launch_poisson(RowKeys{keys, 0u, 0, 1, false}, B, n, lam, out, scratch, words, stream);
}

extern "C" int fbx_key_poisson_f64(const int64_t* keys, int64_t B, int64_t n, const double* lam,
                                   double* out, int32_t* scratch, int64_t words, void* stream) {
  return launch_poisson(RowKeys{keys, 0u, 0, 1, false}, B, n, lam, out, scratch, words, stream);
}

// The int32 words of R2/R2w's scratch for R rows of L rates of elem_bytes
// each (R2: R = B * nrows; R2w: R = B, L = n).
extern "C" int64_t fbx_poisson_scratch(int64_t R, int64_t L, int elem_bytes) {
  return poisson_scratch_words(R, L, elem_bytes);
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

// keys as above; lam, out: (B * nrows, L) contiguous, counts in lam's dtype;
// scratch: fbx_poisson_scratch(B * nrows, L, dtype size) int32 words.
extern "C" int fbx_row_poisson_f32(const int64_t* keys, int64_t B, int64_t tag, int64_t row0,
                                   int64_t nrows, int64_t L, const float* lam, float* out,
                                   int32_t* scratch, int64_t words, void* stream) {
  return launch_poisson(RowKeys{keys, static_cast<uint32_t>(tag), row0, nrows, true}, B * nrows, L,
                        lam, out, scratch, words, stream);
}

extern "C" int fbx_row_poisson_f64(const int64_t* keys, int64_t B, int64_t tag, int64_t row0,
                                   int64_t nrows, int64_t L, const double* lam, double* out,
                                   int32_t* scratch, int64_t words, void* stream) {
  return launch_poisson(RowKeys{keys, static_cast<uint32_t>(tag), row0, nrows, true}, B * nrows, L,
                        lam, out, scratch, words, stream);
}
