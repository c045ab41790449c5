// K11: CIC paint, gather and three-mesh gather of lattice-ordered particles.
//
// Replaces fastbox_tpu/ops/pallas/lattice_cic.py: cic_paint_lattice_pallas
// (_paint_kernel), cic_gather_lattice_pallas and cic_gather3_lattice_pallas
// (_gather_kernel, nmesh 1 and 3), the COLA engine's CIC paint and PM force
// gather (fastbox_tpu/fields/cola.py:429-455, :612-644, :662-705).
//
// The particles never reorder, so particle l = (i, j, k) sits at lattice
// site l plus a wrapped displacement d (cell units, |d| <= B, or |d| < B
// strictly in the open band).  Its CIC cloud covers cells l + o with
// per-axis offsets o in [lo, hi] = [-B, B+1] (closed) or [-B, B] (open), and
// the per-axis weight on offset o is (1 - fr)[fl == o] + fr[fl == o - 1] with
// fl = floor(d), fr = d - fl.  The TPU kernels sum all (hi-lo+1)^3 offsets
// as rolled products because a TPU cannot gather or scatter on
// data-dependent indices; here the same operator is computed under the
// band directly, in the summation order of the roll-form twin
// (fastbox_tpu_torch/fields/lattice_cic.py), with every product and sum
// rounded explicitly, so kernel and twin agree bit for bit.  Offsets outside
// [lo, hi] contribute nothing, as in the twin, even when the bound fails.
//
// Paint is output-centric, as on the TPU, and needs no atomics: one thread
// per mesh cell c sums the contributions of the source particles c - o over
// the band, nested ox { oy { oz } } as the twin nests its rolls.  A block
// owns a tx x 8 x 32 tile of cells and stages its source tile (the tile plus
// the band's halo) in shared memory as per-axis fractions, the optional
// weight and one packed word of the three floors, so the (hi-lo+1)^3
// candidate tests per cell cost one shared load each.  At B=3 (open band,
// weighted, f32) the 10 x 14 x 38 source tile takes 106 KB of dynamic shared
// memory; the launcher shrinks tx where a tile would not fit.  Bound on the
// card: the candidate scan, ~(2B+1)^3 shared loads and integer tests per cell.
//
// Gather is particle-centric: under the bound the banded sum has exactly
// eight non-zero weights, so one thread per particle reads the eight cells
// (l + floor(d) + {0,1}) mod N directly (oz outer, oy inner, as the twin).
// The three-mesh gather computes the indices and weights once for the three
// PM force components.  Bound on the card: memory, one read of d and of the
// meshes' neighbourhoods, one write per particle and mesh.
#include "common.cuh"

namespace {

constexpr int kTileY = 8;
constexpr int kTileZ = 32;
constexpr int kThreads = kTileY * kTileZ;
constexpr int kBias = 64;  // a packed floor byte is fl + kBias; 0 never matches
constexpr int kMaxB = 16;

__device__ __forceinline__ float floor_t(float a) { return floorf(a); }
__device__ __forceinline__ double floor_t(double a) { return floor(a); }

__device__ __forceinline__ int wrap(int a, int n) {
  a %= n;
  return a < 0 ? a + n : a;
}

template <typename T>
__host__ __device__ constexpr size_t paint_bytes_per_particle(bool weighted) {
  return (weighted ? 4 : 3) * sizeof(T) + sizeof(int);
}

template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
paint_kernel(const T* __restrict__ dx, const T* __restrict__ dy, const T* __restrict__ dz,
             const T* __restrict__ w, T* __restrict__ out, int N, int lo, int hi, int tx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int span = hi - lo;
  const int SY = kTileY + span, SZ = kTileZ + span;
  const int S = (tx + span) * SY * SZ;
  T* fr = reinterpret_cast<T*>(smem_raw);  // [3][S]
  T* wsh = fr + 3 * S;                     // [S] when weighted
  int* code = reinterpret_cast<int*>(wsh + (kWeighted ? S : 0));
  const int cx0 = blockIdx.x * tx, cy0 = blockIdx.y * kTileY, cz0 = blockIdx.z * kTileZ;

  // Source particle l = c - o with o in [lo, hi]: the tile starts at c0 - hi.
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int a = s / (SY * SZ);
    const int r = s - a * SY * SZ;
    const int b = r / SZ;
    const int c = r - b * SZ;
    const int64_t g = (static_cast<int64_t>(wrap(cx0 - hi + a, N)) * N +
                       wrap(cy0 - hi + b, N)) * N + wrap(cz0 - hi + c, N);
    const T v[3] = {dx[g], dy[g], dz[g]};
    int packed = 0;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const T f = floor_t(v[ax]);
      fr[ax * S + s] = v[ax] - f;  // exact
      // a weight can be non-zero on some o in [lo, hi] only if fl in [lo-1, hi]
      const int byte = (f >= T(lo - 1) && f <= T(hi)) ? static_cast<int>(f) + kBias : 0;
      packed |= byte << (8 * ax);
    }
    code[s] = packed;
    if (kWeighted) wsh[s] = w[g];
  }
  __syncthreads();

  const int ty = threadIdx.x / kTileZ, tz = threadIdx.x % kTileZ;
  const int cy = cy0 + ty, cz = cz0 + tz;
  if (cy >= N || cz >= N) return;
  for (int ix = 0; ix < tx && cx0 + ix < N; ++ix) {
    T acc = T(0);
    for (int ox = lo; ox <= hi; ++ox) {
      const int ax = ix - ox + hi;
      T sx = T(0);
      for (int oy = lo; oy <= hi; ++oy) {
        const int base = (ax * SY + ty - oy + hi) * SZ + tz + hi;
        T sy = T(0);
        for (int oz = lo; oz <= hi; ++oz) {
          const int s = base - oz;
          const int cd = code[s];
          // 0: fl == o (weight 1 - fr), 1: fl == o - 1 (weight fr)
          const unsigned ex = static_cast<unsigned>(ox + kBias - (cd & 0xff));
          const unsigned ey = static_cast<unsigned>(oy + kBias - ((cd >> 8) & 0xff));
          const unsigned ez = static_cast<unsigned>(oz + kBias - ((cd >> 16) & 0xff));
          if ((ex | ey | ez) <= 1u) {
            const T frx = fr[s], fry = fr[S + s], frz = fr[2 * S + s];
            const T wx = ex ? frx : fbx::sub_rn(T(1), frx);
            const T wy = ey ? fry : fbx::sub_rn(T(1), fry);
            const T wz = ez ? frz : fbx::sub_rn(T(1), frz);
            const T px = kWeighted ? fbx::mul_rn(wx, wsh[s]) : wx;
            sy = fbx::add_rn(sy, fbx::mul_rn(fbx::mul_rn(px, wy), wz));
          }
        }
        sx = fbx::add_rn(sx, sy);
      }
      acc = fbx::add_rn(acc, sx);
    }
    out[(static_cast<int64_t>(cx0 + ix) * N + cy) * N + cz] = acc;
  }
}

template <typename T, int kMeshes>
__global__ void __launch_bounds__(256)
gather_kernel(const T* __restrict__ m0, const T* __restrict__ m1, const T* __restrict__ m2,
              const T* __restrict__ dx, const T* __restrict__ dy, const T* __restrict__ dz,
              T* __restrict__ o0, T* __restrict__ o1, T* __restrict__ o2, int N, int lo, int hi) {
  const int64_t NN = static_cast<int64_t>(N) * N;
  const int64_t n3 = NN * N;
  const T* mesh[3] = {m0, m1, m2};
  T* outp[3] = {o0, o1, o2};
  for (int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; g < n3;
       g += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int site[3] = {static_cast<int>(g / NN), static_cast<int>((g / N) % N),
                         static_cast<int>(g % N)};
    const T v[3] = {dx[g], dy[g], dz[g]};
    int idx[3][2];
    T wt[3][2];
    bool ok[3][2];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const T f = floor_t(v[ax]);
      const T frac = v[ax] - f;
      wt[ax][0] = fbx::sub_rn(T(1), frac);
      wt[ax][1] = frac;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const T o = f + T(e);  // exact: |f| <= N
        ok[ax][e] = o >= T(lo) && o <= T(hi);
        idx[ax][e] = ok[ax][e] ? wrap(site[ax] + static_cast<int>(o), N) : 0;
      }
    }
    T acc[kMeshes];
#pragma unroll
    for (int m = 0; m < kMeshes; ++m) acc[m] = T(0);
#pragma unroll
    for (int ez = 0; ez < 2; ++ez) {
      if (!ok[2][ez]) continue;
#pragma unroll
      for (int ey = 0; ey < 2; ++ey) {
        if (!ok[1][ey]) continue;
        const T wyz = fbx::mul_rn(wt[1][ey], wt[2][ez]);
        const int64_t row = static_cast<int64_t>(idx[1][ey]) * N + idx[2][ez];
#pragma unroll
        for (int m = 0; m < kMeshes; ++m) {
          T sx = T(0);
#pragma unroll
          for (int ex = 0; ex < 2; ++ex) {
            if (ok[0][ex]) {
              sx = fbx::add_rn(sx, fbx::mul_rn(wt[0][ex], mesh[m][idx[0][ex] * NN + row]));
            }
          }
          acc[m] = fbx::add_rn(acc[m], fbx::mul_rn(wyz, sx));
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMeshes; ++m) outp[m][g] = acc[m];
  }
}

cudaError_t band(int64_t N, int B, int openband, int* lo, int* hi) {
  if (N < 1 || N > (1 << 20) || B < 1 || B > kMaxB) return cudaErrorInvalidValue;
  *lo = -B;
  *hi = openband ? B : B + 1;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_paint(const T* dx, const T* dy, const T* dz, const T* w, T* out, int64_t N,
                         int B, int openband, cudaStream_t stream) {
  int lo, hi;
  cudaError_t e = band(N, B, openband, &lo, &hi);
  if (e != cudaSuccess) return e;
  int dev, max_smem;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return e;
  const bool weighted = w != nullptr;
  const int span = hi - lo;
  // widest x extent of the cell tile whose source tile fits in shared memory
  int tx = 4;
  size_t smem = 0;
  for (; tx >= 1; tx /= 2) {
    smem = static_cast<size_t>(tx + span) * (kTileY + span) * (kTileZ + span) *
           paint_bytes_per_particle<T>(weighted);
    if (smem <= static_cast<size_t>(max_smem)) break;
  }
  if (tx < 1) return cudaErrorInvalidValue;
  auto kernel = weighted ? &paint_kernel<T, true> : &paint_kernel<T, false>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int n = static_cast<int>(N);
  const dim3 grid((n + tx - 1) / tx, (n + kTileY - 1) / kTileY, (n + kTileZ - 1) / kTileZ);
  kernel<<<grid, kThreads, smem, stream>>>(dx, dy, dz, w, out, n, lo, hi, tx);
  return cudaGetLastError();
}

template <typename T, int kMeshes>
cudaError_t launch_gather(const T* m0, const T* m1, const T* m2, const T* dx, const T* dy,
                          const T* dz, T* o0, T* o1, T* o2, int64_t N, int B, int openband,
                          cudaStream_t stream) {
  int lo, hi;
  cudaError_t e = band(N, B, openband, &lo, &hi);
  if (e != cudaSuccess) return e;
  const int64_t n3 = N * N * N;
  const int threads = 256;
  int64_t blocks = (n3 + threads - 1) / threads;
  if (blocks > (1 << 22)) blocks = 1 << 22;
  gather_kernel<T, kMeshes><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      m0, m1, m2, dx, dy, dz, o0, o1, o2, static_cast<int>(N), lo, hi);
  return cudaGetLastError();
}

}  // namespace

// dx, dy, dz: (N, N, N) wrapped displacements in cell units; w: (N, N, N)
// weights or null; out: (N, N, N).  openband != 0: offsets [-B, B].
extern "C" int fbx_cic_paint_lattice_f32(const float* dx, const float* dy, const float* dz,
                                         const float* w, float* out, int64_t N, int B,
                                         int openband, void* stream) {
  return launch_paint(dx, dy, dz, w, out, N, B, openband, static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_cic_paint_lattice_f64(const double* dx, const double* dy, const double* dz,
                                         const double* w, double* out, int64_t N, int B,
                                         int openband, void* stream) {
  return launch_paint(dx, dy, dz, w, out, N, B, openband, static_cast<cudaStream_t>(stream));
}

// mesh, dx, dy, dz, out: (N, N, N).
extern "C" int fbx_cic_gather_lattice_f32(const float* mesh, const float* dx, const float* dy,
                                          const float* dz, float* out, int64_t N, int B,
                                          int openband, void* stream) {
  return launch_gather<float, 1>(mesh, nullptr, nullptr, dx, dy, dz, out, nullptr, nullptr, N,
                                 B, openband, static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_cic_gather_lattice_f64(const double* mesh, const double* dx, const double* dy,
                                          const double* dz, double* out, int64_t N, int B,
                                          int openband, void* stream) {
  return launch_gather<double, 1>(mesh, nullptr, nullptr, dx, dy, dz, out, nullptr, nullptr, N,
                                  B, openband, static_cast<cudaStream_t>(stream));
}

// m0, m1, m2: the three (N, N, N) meshes; o0, o1, o2: their gathers.
extern "C" int fbx_cic_gather3_lattice_f32(const float* m0, const float* m1, const float* m2,
                                           const float* dx, const float* dy, const float* dz,
                                           float* o0, float* o1, float* o2, int64_t N, int B,
                                           int openband, void* stream) {
  return launch_gather<float, 3>(m0, m1, m2, dx, dy, dz, o0, o1, o2, N, B, openband,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_cic_gather3_lattice_f64(const double* m0, const double* m1, const double* m2,
                                           const double* dx, const double* dy, const double* dz,
                                           double* o0, double* o1, double* o2, int64_t N, int B,
                                           int openband, void* stream) {
  return launch_gather<double, 3>(m0, m1, m2, dx, dy, dz, o0, o1, o2, N, B, openband,
                                  static_cast<cudaStream_t>(stream));
}
