// K3: piecewise-linear interpolation of per-row sorted nodes at shared
// targets, with the griddata hull fill.
//
// Replaces fastbox_tpu/ops/pallas/rsd_interp.py::interp_sorted_pallas
// (_kernel), the exact tier of ops/rsd.py::_remap_wrap_tiered (after a
// per-row stable sort, which stays outside the kernel as in JAX).
//
// The TPU kernel evaluates the telescoping sum
//   out(t) = v_0 + sum_c (v_{c+1} - v_c) clamp((z_t - s_c)/(s_{c+1} - s_c), 0, 1)
// over all C-1 segments: O(C) work per target, which suits a vector unit
// with no gathers.  Here each target finds its bracket segment instead:
// j = the last node with s_j <= z_t, and
//   out(t) = v_j + (v_{j+1} - v_j) (z_t - s_j)/(s_{j+1} - s_j),
// the same function, rounded in that order (sub, sub, div; sub, mul, add),
// so one j gives one result bit for bit on every path.  Taking the LAST
// node <= z_t matches the telescoping form's duplicate rule: on equal
// coordinates the value switches at the last duplicate; j = C-1 gives
// v_{C-1}.  Targets outside [s_0, s_{C-1}] get the row's fill
// (rsd_interp.py:48-49).
//
// Bound on the card: memory.  One read of the sorted row pair and one
// write per target (201 MB at 256^3, 0.060 ms at 3.35 TB/s).  Two paths,
// chosen by the wrapper's rule (ops/cuda/rsd_interp.py staged_path):
//
// The staged path (C a multiple of 4, C and T at most 4096, 16-byte
// aligned rows) gives each row to one warp, several warps to a block and
// row after row to each warp, with the targets staged once per block and
// no block barrier after that.  A warp copies its next row's s and v into
// a second buffer with 16-byte cp.async while it interpolates the current
// one, so one row's loads overlap another row's search.  The warp takes
// the targets in batches of 32, lane l target t0 + l, and stores each
// batch as 32 consecutive values.  Where the targets ascend (non-decreasing,
// checked once per block while they are staged), the bracket index is
// non-decreasing in t, and the warp finds a batch's brackets by a merge
// walk: from w, the count of nodes <= the previous batch's last target, a
// window of 64 nodes (a pair a lane, one 8- or 16-byte load, no bank
// conflict) is searched by a bisection over the lanes (seven shuffles) and
// moved on by 64 while some lane's target lies past it, so a row costs
// O(C + T) steps, not T log2 C dependent loads.  After kWindowHops moves
// (clustered nodes) the lanes still open bisect over the rest of the row.
// The staged row is followed by kPad nodes of +inf, so a window needs no
// index checks.  Targets that do not ascend take a bisection each, in the
// same layout (neighbouring lanes then walk nearby paths).  A run of
// consecutive targets per lane, merged by each lane alone, measured slower
// on the card: a warp waits for its slowest lane's merge.
//
// The direct path (any other row) gives each row to a block of threads and
// bisects per target.
#include "common.cuh"

namespace {

// Window moves a batch of targets may take before the lanes still open
// bisect instead (ops/cuda/rsd_interp.py reads it from here as WINDOW_HOPS
// for the CPU tests' emulation of the walk).
constexpr int kWindowHops = 2;
// +inf nodes after a staged row: a 64-node window from any node of the row
// stays inside the buffer.
constexpr int kPad = 64;

// The last index j in [lo - 1, hi) with s[j] <= zt, given s[lo - 1] <= zt
// (or lo == 0) and s sorted: a bisection for the first node > zt.
template <typename T>
__device__ __forceinline__ int last_le(const T* s, int lo, int hi, T zt) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] <= zt) lo = mid + 1; else hi = mid;
  }
  return lo - 1;
}

// The interpolated value on segment j (0 <= j < C-1), the twin's rounding.
template <typename T>
__device__ __forceinline__ T segment_value(T zt, T s_j, T s_j1, T v_j, T v_j1) {
  const T frac = fbx::div_rn(fbx::sub_rn(zt, s_j), fbx::sub_rn(s_j1, s_j));
  return fbx::add_rn(v_j, fbx::mul_rn(fbx::sub_rn(v_j1, v_j), frac));
}

// ---------------------------------------------------------------- direct
// One block per row (grid-stride over rows), any C and T.
template <typename T>
__global__ void interp_sorted_rows(const T* __restrict__ ss, const T* __restrict__ vv,
                                   const T* __restrict__ z, const T* __restrict__ fill,
                                   T* __restrict__ out, int64_t M, int C, int Tn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_sh = reinterpret_cast<T*>(smem_raw);
  T* v_sh = s_sh + C;
  for (int64_t row = blockIdx.x; row < M; row += gridDim.x) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      s_sh[c] = ss[row * C + c];
      v_sh[c] = vv[row * C + c];
    }
    __syncthreads();
    const T s_first = s_sh[0], s_last = s_sh[C - 1], f = fill[row];
    for (int t = threadIdx.x; t < Tn; t += blockDim.x) {
      const T zt = z[t];
      T res = f;
      if (zt >= s_first && zt <= s_last) {
        const int j = last_le(s_sh, 0, C, zt);  // >= 0 because s_first <= zt
        res = j >= C - 1 ? v_sh[C - 1]
                         : segment_value(zt, s_sh[j], s_sh[j + 1], v_sh[j], v_sh[j + 1]);
      }
      out[row * Tn + t] = res;
    }
    __syncthreads();  // the next row overwrites the shared row
  }
}

template <typename T>
cudaError_t launch_rows(const T* ss, const T* vv, const T* z, const T* fill, T* out, int64_t M,
                        int C, int Tn, cudaStream_t stream) {
  const int width = C > Tn ? C : Tn;
  const int threads = width >= 256 ? 256 : (width + 31) / 32 * 32;
  const int64_t blocks = M < (1 << 20) ? M : (1 << 20);
  const size_t smem = 2 * static_cast<size_t>(C) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(interp_sorted_rows<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  interp_sorted_rows<T><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      ss, vv, z, fill, out, M, C, Tn);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- staged
// Two consecutive nodes of a row, loaded together (8 or 16 bytes).
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// The count of a 64-node window's nodes <= zt.  Lane i holds nodes ww + 2i
// (a) and ww + 2i + 1 (b), sorted (the staged row is followed by +inf, so
// a window that runs past the row stays sorted).  P, the pairs whose first
// node is <= zt, comes from a bisection over the lanes: five shuffles find
// it among pairs 0..30, a sixth tests pair 31.  Every pair before pair
// P - 1 counts twice, and pair P - 1 once or twice (a seventh shuffle).
template <typename T>
__device__ __forceinline__ int window_count(T a, T b, T zt) {
  int P = 0;
#pragma unroll
  for (int step = 16; step >= 1; step >>= 1) {
    const T sv = __shfl_sync(0xffffffffu, a, P + step - 1);
    if (sv <= zt) P += step;
  }
  const T last = __shfl_sync(0xffffffffu, a, 31);
  if (P == 31 && last <= zt) P = 32;
  const T sb = __shfl_sync(0xffffffffu, b, (P + 31) & 31);
  return P == 0 ? 0 : 2 * P - 1 + (sb <= zt ? 1 : 0);
}

template <typename T>
__global__ void __launch_bounds__(256)
    interp_sorted_staged(const T* __restrict__ ss, const T* __restrict__ vv,
                         const T* __restrict__ z, const T* __restrict__ fill, T* __restrict__ out,
                         int64_t M, int C, int Tn) {
  using P2 = typename Pair<T>::type;
  constexpr int K = 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  // per warp two buffers, each s (C nodes and kPad of +inf) then v (C)
  const int buf = 2 * C + kPad;
  T* bufs = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * 2 * buf;
  T* z_sh = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(nwarps) * 2 * buf;
  for (int i = lane; i < kPad; i += 32)
    bufs[C + i] = bufs[buf + C + i] = fbx::Limits<T>::inf();

  // the targets, and whether they ascend (a NaN fails every comparison)
  bool ascending = true;
  for (int t = threadIdx.x; t < Tn; t += blockDim.x) {
    const T zt = z[t];
    z_sh[t] = zt;
    if (t > 0) ascending &= z[t - 1] <= zt;
    else ascending &= zt == zt;
  }
  ascending = __syncthreads_and(ascending);  // the block's only barrier
  const int nvec = C / K;

  auto fetch = [&](int64_t row, T* b) {
    const T* gs = ss + row * C;
    const T* gv = vv + row * C;
    for (int i = lane; i < nvec; i += 32) {
      fbx::cp_async16(b + K * i, gs + K * i);
      fbx::cp_async16(b + C + kPad + K * i, gv + K * i);
    }
    fbx::cp_async_commit();
  };

  const int64_t stride = static_cast<int64_t>(gridDim.x) * nwarps;
  int64_t row = static_cast<int64_t>(blockIdx.x) * nwarps + warp;
  if (row < M) fetch(row, bufs);
  for (int it = 0; row < M; ++it, row += stride) {
    const T* s_sh = bufs + (it & 1) * buf;
    const T* v_sh = s_sh + C + kPad;
    if (row + stride < M) {
      fetch(row + stride, bufs + ((it + 1) & 1) * buf);
      fbx::cp_async_wait<1>();  // this row's group has landed
    } else {
      fbx::cp_async_wait<0>();
    }
    __syncwarp();

    const T s_first = s_sh[0], s_last = s_sh[C - 1], fr = fill[row];
    T* op = out + row * Tn + lane;
    int w = 0;  // ascending: the nodes <= the previous batch's last target
    for (int t0 = 0; t0 < Tn; t0 += 32, op += 32) {
      const int t = t0 + lane;
      const T zt = z_sh[t < Tn ? t : Tn - 1];  // idle lanes repeat the last target
      int j;
      if (ascending) {
        // merge: a window of 64 nodes from w (rounded down to a pair),
        // moved on by 64 while some lane's target lies past it; after
        // kWindowHops moves (clustered nodes) the lanes still open bisect
        // over the rest of the row
        int ww = w & ~1, hops = 0;
        bool open = true;
        j = -1;
        while (true) {
          const P2 ab = *reinterpret_cast<const P2*>(s_sh + ww + 2 * lane);
          const int p = window_count(ab.x, ab.y, zt);
          if (open) {
            j = min(ww + p - 1, C - 1);  // the padding counts only for zt = +inf
            open = p == 64 && ww + 64 < C;
          }
          if (!__any_sync(0xffffffffu, open)) break;
          ww += 64;
          if (++hops == kWindowHops) {
            if (open) j = last_le(s_sh, ww, C, zt);
            break;
          }
        }
        w = __shfl_sync(0xffffffffu, j, 31) + 1;
      } else {
        j = last_le(s_sh, 0, C, zt);
      }
      if (t < Tn) {
        T res = fr;
        if (zt >= s_first && zt <= s_last)
          res = j >= C - 1 ? v_sh[C - 1]
                           : segment_value(zt, s_sh[j], s_sh[j + 1], v_sh[j], v_sh[j + 1]);
        *op = res;
      }
    }
    __syncwarp();  // every lane is done with this row before its buffer is refilled
  }
}

template <typename T>
cudaError_t launch_staged(const T* ss, const T* vv, const T* z, const T* fill, T* out, int64_t M,
                          int C, int Tn, cudaStream_t stream) {
  const size_t per_warp = 2 * (2 * static_cast<size_t>(C) + kPad) * sizeof(T);
  auto kern = interp_sorted_staged<T>;
  int warps = 0;
  unsigned blocks = 0;
  size_t smem = 0;
  cudaError_t e = fbx::warp_rows_shape(kern, static_cast<size_t>(Tn) * sizeof(T), per_warp, M,
                                       &warps, &blocks, &smem);
  if (e != cudaSuccess) return e;
  kern<<<blocks, 32 * warps, smem, stream>>>(ss, vv, z, fill, out, M, C, Tn);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* ss, const T* vv, const T* z, const T* fill, T* out, int64_t M,
                   int64_t C, int64_t Tn, int staged, cudaStream_t stream) {
  if (M == 0 || Tn == 0) return cudaSuccess;
  if (C < 1 || C > INT32_MAX || Tn > INT32_MAX) return cudaErrorInvalidValue;
  const int c = static_cast<int>(C), tn = static_cast<int>(Tn);
  if (!staged) return launch_rows(ss, vv, z, fill, out, M, c, tn, stream);
  if (C % 4 != 0) return cudaErrorInvalidValue;
  return launch_staged(ss, vv, z, fill, out, M, c, tn, stream);
}

}  // namespace

// ss, vv: (M, C) contiguous, rows sorted ascending by ss; z: (Tn,);
// fill: (M,); out: (M, Tn); staged: 1 for the staged path (see above).
extern "C" int fbx_interp_sorted_f32(const float* ss, const float* vv, const float* z,
                                     const float* fill, float* out, int64_t M, int64_t C,
                                     int64_t Tn, int staged, void* stream) {
  return launch(ss, vv, z, fill, out, M, C, Tn, staged, static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_interp_sorted_f64(const double* ss, const double* vv, const double* z,
                                     const double* fill, double* out, int64_t M, int64_t C,
                                     int64_t Tn, int staged, void* stream) {
  return launch(ss, vv, z, fill, out, M, C, Tn, staged, static_cast<cudaStream_t>(stream));
}
