// K12: the COLA kick-drift, one pass over the particle state.
//
// Replaces no Pallas kernel: fastbox_tpu's step (fastbox_tpu/fields/cola.py)
// is jnp arithmetic that XLA fuses on the TPU.  The port ran the same step
// as 14 PyTorch launches (7 multiplies by a scalar, 6 in-place adds or
// subtracts, one remainder) that read 20 and wrote 14 arrays of the state's
// size (6.84 GB a step at 256^3 in f32).
//
// For each element of the flat (3, N, N, N) state, in the plain passes'
// order (ops/cuda/cola_kick.py kick_drift_plain), each operation rounded on
// its own (no FMA contraction):
//   comp = ((p1 * c1) + (p2 * c2)) * cf
//   v    = v + (F - comp) * K
//   x    = remainder(((x + v * Dr) + p1 * dD1) + p2 * dD2, L)
// so x and v come out bitwise equal to the passes'.  The scalars are the
// host's values in the state's dtype, passed as doubles (exact).
//
// Bound on the card: memory.  Five arrays read once (x, v, p1, p2, F) and
// two written (x, v): 28 bytes an f32 element, 1.41 GB at 256^3, 0.421 ms
// at 3.35 TB/s; ~15 floating-point operations an element are far below the
// compute rate at that traffic.  Design: where every array starts on a
// 16-byte boundary (the wrapper's rule, vector_path), a thread reads and
// writes 16-byte vectors (float4, double2), five independent loads in
// flight for each vector it updates; p1, p2 and F, which nothing reads
// again this step, load with the evict-first hint (ld.global.cs); the grid
// is as many 256-thread blocks as the SMs hold at once, striding over the
// vectors, so every SM streams until the end; the elements past the last
// whole vector (3 N^3 not a multiple of it) make a scalar tail.  Otherwise
// the direct path goes element by element, with the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
struct KickScalars {
  T c1, c2, cf, K, Dr, dD1, dD2, L;
};

template <typename T>
__device__ __forceinline__ void kick_drift_one(T& x, T& v, T p1, T p2, T F,
                                               const KickScalars<T>& s) {
  T comp = fbx::mul_rn(p1, s.c1);
  comp = fbx::add_rn(comp, fbx::mul_rn(p2, s.c2));
  comp = fbx::mul_rn(comp, s.cf);
  v = fbx::add_rn(v, fbx::mul_rn(fbx::sub_rn(F, comp), s.K));
  T y = fbx::add_rn(x, fbx::mul_rn(v, s.Dr));
  y = fbx::add_rn(y, fbx::mul_rn(p1, s.dD1));
  y = fbx::add_rn(y, fbx::mul_rn(p2, s.dD2));
  x = fbx::floor_mod(y, s.L);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    kick_drift_kernel(T* __restrict__ x, T* __restrict__ v, const T* __restrict__ p1,
                      const T* __restrict__ p2, const T* __restrict__ F, int64_t n,
                      KickScalars<T> s) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t tail = 0;
  if constexpr (kVec) {
    using V = typename fbx::Vec16<T>::type;
    constexpr int W = 16 / sizeof(T);
    const int64_t nv = n / W;
    V* xv = reinterpret_cast<V*>(x);
    V* vv = reinterpret_cast<V*>(v);
    const V* p1v = reinterpret_cast<const V*>(p1);
    const V* p2v = reinterpret_cast<const V*>(p2);
    const V* Fv = reinterpret_cast<const V*>(F);
    for (int64_t i = tid; i < nv; i += stride) {
      const V qp1 = __ldcs(p1v + i), qp2 = __ldcs(p2v + i), qF = __ldcs(Fv + i);
      const V qx = xv[i], qv = vv[i];
      T ax[W], av[W], a1[W], a2[W], aF[W];
      fbx::Vec16<T>::unpack(qx, ax);
      fbx::Vec16<T>::unpack(qv, av);
      fbx::Vec16<T>::unpack(qp1, a1);
      fbx::Vec16<T>::unpack(qp2, a2);
      fbx::Vec16<T>::unpack(qF, aF);
#pragma unroll
      for (int j = 0; j < W; ++j) kick_drift_one(ax[j], av[j], a1[j], a2[j], aF[j], s);
      xv[i] = fbx::Vec16<T>::pack(ax);
      vv[i] = fbx::Vec16<T>::pack(av);
    }
    tail = nv * W;
  }
  for (int64_t i = tail + tid; i < n; i += stride) {
    T xi = x[i], vi = v[i];
    kick_drift_one(xi, vi, __ldcs(p1 + i), __ldcs(p2 + i), __ldcs(F + i), s);
    x[i] = xi;
    v[i] = vi;
  }
}

template <typename T, bool kVec>
cudaError_t launch_as(T* x, T* v, const T* p1, const T* p2, const T* F, int64_t n,
                      const KickScalars<T>& s, cudaStream_t stream) {
  auto kern = kick_drift_kernel<T, kVec>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);
  if (e != cudaSuccess) return e;
  const int64_t items = kVec ? n / (16 / static_cast<int64_t>(sizeof(T))) : n;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  kern<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(x, v, p1, p2, F, n, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(T* x, T* v, const T* p1, const T* p2, const T* F, int64_t n, double c1,
                   double c2, double cf, double K, double Dr, double dD1, double dD2, double L,
                   int vec, cudaStream_t stream) {
  const KickScalars<T> s{static_cast<T>(c1), static_cast<T>(c2),  static_cast<T>(cf),
                         static_cast<T>(K),  static_cast<T>(Dr),  static_cast<T>(dD1),
                         static_cast<T>(dD2), static_cast<T>(L)};
  if (n <= 0) return cudaSuccess;
  return vec ? launch_as<T, true>(x, v, p1, p2, F, n, s, stream)
             : launch_as<T, false>(x, v, p1, p2, F, n, s, stream);
}

}  // namespace

// x, v (updated in place), p1, p2, F: n contiguous elements each (the flat
// (3, N, N, N) state), no two sharing memory; c1 = D1, c2 = D2 - D1^2,
// cf = fac_pm / a, K = K1 + K2, Dr, dD1, dD2: the step's scalars and L the
// box length, each a value of the state's dtype; vec: 1 for 16-byte
// accesses (every array 16-byte aligned), 0 for the direct path.
extern "C" int fbx_cola_kick_drift_f32(float* x, float* v, const float* p1, const float* p2,
                                       const float* F, int64_t n, double c1, double c2, double cf,
                                       double K, double Dr, double dD1, double dD2, double L,
                                       int vec, void* stream) {
  return launch(x, v, p1, p2, F, n, c1, c2, cf, K, Dr, dD1, dD2, L, vec,
                static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_cola_kick_drift_f64(double* x, double* v, const double* p1, const double* p2,
                                       const double* F, int64_t n, double c1, double c2, double cf,
                                       double K, double Dr, double dD1, double dD2, double L,
                                       int vec, void* stream) {
  return launch(x, v, p1, p2, F, n, c1, c2, cf, K, Dr, dD1, dD2, L, vec,
                static_cast<cudaStream_t>(stream));
}
