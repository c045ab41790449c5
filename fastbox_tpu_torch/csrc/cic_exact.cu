// K13: COLA's exact CIC tier, one pass each: the paint K13a and the gather
// of C = 1 or 3 meshes K13b.
//
// Replaces no Pallas kernel: fastbox_tpu's exact tier
// (fastbox_tpu/fields/cola.py:63-147) is XLA's .at[].add scatter and a
// gathered sum.  The port ran it as plain PyTorch (ops/cuda/cic_exact.py,
// cic_paint_exact_plain, cic_gather_exact_plain): per axis two int64 index
// and two weight tensors, then eight int64 flat indices and eight products,
// one index_add_ or one gathered term each, rebuilt for every force
// component; about 40 passes over the particles a force evaluation.
//
// Both kernels work out each particle's corners once, in registers, with
// the plain path's arithmetic: per axis fl = floor(a), fr = a - fl,
// i0 = (int64) fl, the cells floor_mod(i0, Nm) and floor_mod(i0 + 1, Nm)
// with the weights 1 - fr and fr.  Every cell index lies in [0, Nm), so
// neither kernel reads or writes outside the mesh, whatever the (finite)
// position; flat offsets are 32-bit where Nm^3 < 2^31, else 64-bit.
//
// K13a, the paint of M particles (optionally weighted) onto a zeroed
// (Nm, Nm, Nm) periodic mesh: each contribution is ((w wx) wy) wz, rounded
// as the plain path rounds it (fbx::mul_rn, no FMA contraction), so the
// kernel adds the same numbers as index_add_; only the order of the sums
// differs: eight atomic adds (red.global.add) a particle, in no fixed
// order, so f32 sums do not repeat bit for bit (nor do index_add_'s on the
// card).  Bound: bytes, 12 M of positions read (16 M weighted) and the
// 4 Nm^3-byte mesh written: 16 N^3 at Nm = N, 0.64 ms at 512^3 in f32.
// Design: one thread a particle on a resident grid that strides over the
// particles in their Lagrangian order, so a warp's 32 particles are
// neighbours along z and the grid's front sweeps the mesh plane by plane:
// the atomics of the resident threads fall on a few planes that stay in
// L2, and the mesh goes to memory about once.  The number of atomics does
// not set its time either: one atomic for the z-corner that two
// neighbouring lanes share, by a shuffle, gained 8% (PERF.md) and was left
// out.
//
// K13b, the gather of C = 1 or 3 meshes at M positions: the corners once
// for all meshes, each output summed in the plain path's order (from 0, the
// terms ((m wx) wy) wz over (x0,y0,z0), (x0,y0,z1), ..., (x1,y1,z1)), each
// operation rounded on its own, so the outputs are bitwise equal to the
// plain gather in f32 and f64.  Bound: bytes, 12 M of positions read,
// 4 C Nm^3 of meshes read and 4 C M written: 36 N^3 at C = 3 and Nm = N,
// 1.44 ms at 512^3 in f32.  Design: as K13a, a thread a particle on a
// resident grid in Lagrangian order, the 8 C corner loads of a particle
// independent and in flight together through the read-only path, the
// outputs written once, evict-first.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float floor_t(float a) { return floorf(a); }
__device__ __forceinline__ double floor_t(double a) { return floor(a); }

// One axis of a particle's cloud: its two cells and their weights.
template <typename T, typename I>
struct Axis {
  I c[2];
  T w[2];
};

template <typename T, typename I>
__device__ __forceinline__ Axis<T, I> axis_corners(T a, int64_t Nm) {
  const T fl = floor_t(a);
  const T fr = fbx::sub_rn(a, fl);
  int64_t i0;
  if (fl >= T(0) && fl < static_cast<T>(Nm)) {
    i0 = static_cast<int64_t>(fl);  // inside the mesh: the remainder is i0
  } else {
    i0 = static_cast<int64_t>(fl) % Nm;  // torch.remainder of the int64 floor
    if (i0 < 0) i0 += Nm;
  }
  Axis<T, I> r;
  r.c[0] = static_cast<I>(i0);
  r.c[1] = static_cast<I>(i0 + 1 == Nm ? 0 : i0 + 1);
  r.w[0] = fbx::sub_rn(T(1), fr);
  r.w[1] = fr;
  return r;
}

template <typename T, typename I, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
    paint_kernel(const T* __restrict__ ux, const T* __restrict__ uy, const T* __restrict__ uz,
                 const T* __restrict__ w, T* __restrict__ mesh, int64_t M, int64_t Nm) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const I n = static_cast<I>(Nm);
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; p < M;
       p += stride) {
    const Axis<T, I> ax = axis_corners<T, I>(__ldcs(ux + p), Nm);
    const Axis<T, I> ay = axis_corners<T, I>(__ldcs(uy + p), Nm);
    const Axis<T, I> az = axis_corners<T, I>(__ldcs(uz + p), Nm);
    const T wp = kWeighted ? __ldcs(w + p) : T(1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const T px = kWeighted ? fbx::mul_rn(wp, ax.w[i]) : ax.w[i];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const T pxy = fbx::mul_rn(px, ay.w[j]);
        T* row = mesh + (ax.c[i] * n + ay.c[j]) * n;
#pragma unroll
        for (int k = 0; k < 2; ++k) atomicAdd(row + az.c[k], fbx::mul_rn(pxy, az.w[k]));
      }
    }
  }
}

template <typename T, typename I, int C>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const T* __restrict__ m0, const T* __restrict__ m1, const T* __restrict__ m2,
                  const T* __restrict__ ux, const T* __restrict__ uy, const T* __restrict__ uz,
                  T* __restrict__ o0, T* __restrict__ o1, T* __restrict__ o2, int64_t M,
                  int64_t Nm) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const I n = static_cast<I>(Nm);
  const T* meshes[3] = {m0, m1, m2};
  T* outs[3] = {o0, o1, o2};
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; p < M;
       p += stride) {
    const Axis<T, I> ax = axis_corners<T, I>(__ldcs(ux + p), Nm);
    const Axis<T, I> ay = axis_corners<T, I>(__ldcs(uy + p), Nm);
    const Axis<T, I> az = axis_corners<T, I>(__ldcs(uz + p), Nm);
    T v[C][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const I row = (ax.c[i] * n + ay.c[j]) * n;
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int c = 0; c < C; ++c) v[c][4 * i + 2 * j + k] = __ldg(meshes[c] + row + az.c[k]);
      }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      T acc = T(0);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const T t = fbx::mul_rn(fbx::mul_rn(fbx::mul_rn(v[c][e], ax.w[e >> 2]), ay.w[(e >> 1) & 1]),
                                az.w[e & 1]);
        acc = fbx::add_rn(acc, t);
      }
      __stcs(outs[c] + p, acc);
    }
  }
}

// As many blocks as the SMs hold at once, at most one a 256 particles.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kern, int64_t M, unsigned* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);
  if (e != cudaSuccess) return e;
  int64_t b = (M + kThreads - 1) / kThreads;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (b > resident) b = resident;
  *blocks = static_cast<unsigned>(b < 1 ? 1 : b);
  return cudaSuccess;
}

// 32-bit flat offsets where every offset fits
inline bool small_mesh(int64_t Nm) { return Nm * Nm * Nm < (int64_t(1) << 31); }

template <typename T, typename I>
cudaError_t paint_as(const T* ux, const T* uy, const T* uz, const T* w, T* mesh, int64_t M,
                     int64_t Nm, cudaStream_t stream) {
  auto kern = w ? paint_kernel<T, I, true> : paint_kernel<T, I, false>;
  unsigned blocks = 0;
  cudaError_t e = resident_blocks(kern, M, &blocks);
  if (e != cudaSuccess) return e;
  kern<<<blocks, kThreads, 0, stream>>>(ux, uy, uz, w, mesh, M, Nm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t paint(const T* ux, const T* uy, const T* uz, const T* w, T* mesh, int64_t M,
                  int64_t Nm, cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  if (Nm < 1) return cudaErrorInvalidValue;
  return small_mesh(Nm) ? paint_as<T, int32_t>(ux, uy, uz, w, mesh, M, Nm, stream)
                        : paint_as<T, int64_t>(ux, uy, uz, w, mesh, M, Nm, stream);
}

template <typename T, typename I, int C>
cudaError_t gather_as(const T* const* m, const T* ux, const T* uy, const T* uz, T* const* o,
                      int64_t M, int64_t Nm, cudaStream_t stream) {
  auto kern = gather_kernel<T, I, C>;
  unsigned blocks = 0;
  cudaError_t e = resident_blocks(kern, M, &blocks);
  if (e != cudaSuccess) return e;
  kern<<<blocks, kThreads, 0, stream>>>(m[0], m[1], m[2], ux, uy, uz, o[0], o[1], o[2], M, Nm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t gather(const T* m0, const T* m1, const T* m2, const T* ux, const T* uy, const T* uz,
                   T* o0, T* o1, T* o2, int64_t M, int64_t Nm, int C, cudaStream_t stream) {
  if (C != 1 && C != 3) return cudaErrorInvalidValue;
  if (M <= 0) return cudaSuccess;
  if (Nm < 1) return cudaErrorInvalidValue;
  const T* m[3] = {m0, m1, m2};
  T* o[3] = {o0, o1, o2};
  if (small_mesh(Nm))
    return C == 1 ? gather_as<T, int32_t, 1>(m, ux, uy, uz, o, M, Nm, stream)
                  : gather_as<T, int32_t, 3>(m, ux, uy, uz, o, M, Nm, stream);
  return C == 1 ? gather_as<T, int64_t, 1>(m, ux, uy, uz, o, M, Nm, stream)
                : gather_as<T, int64_t, 3>(m, ux, uy, uz, o, M, Nm, stream);
}

}  // namespace

// K13a: ux, uy, uz: M positions in cell units; w: M weights or null; mesh:
// the (Nm, Nm, Nm) periodic mesh, zeroed by the caller, added into.
extern "C" int fbx_cic_paint_exact_f32(const float* ux, const float* uy, const float* uz,
                                       const float* w, float* mesh, int64_t M, int64_t Nm,
                                       void* stream) {
  return paint(ux, uy, uz, w, mesh, M, Nm, static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_cic_paint_exact_f64(const double* ux, const double* uy, const double* uz,
                                       const double* w, double* mesh, int64_t M, int64_t Nm,
                                       void* stream) {
  return paint(ux, uy, uz, w, mesh, M, Nm, static_cast<cudaStream_t>(stream));
}

// K13b: m0..m2: C (Nm, Nm, Nm) meshes (C = 1: m0 alone, the rest unused);
// ux, uy, uz: M positions in cell units; o0..o2: C outputs of M values, none
// overlapping an input.
extern "C" int fbx_cic_gather_exact_f32(const float* m0, const float* m1, const float* m2,
                                        const float* ux, const float* uy, const float* uz,
                                        float* o0, float* o1, float* o2, int64_t M, int64_t Nm,
                                        int C, void* stream) {
  return gather(m0, m1, m2, ux, uy, uz, o0, o1, o2, M, Nm, C, static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_cic_gather_exact_f64(const double* m0, const double* m1, const double* m2,
                                        const double* ux, const double* uy, const double* uz,
                                        double* o0, double* o1, double* o2, int64_t M,
                                        int64_t Nm, int C, void* stream) {
  return gather(m0, m1, m2, ux, uy, uz, o0, o1, o2, M, Nm, C, static_cast<cudaStream_t>(stream));
}
