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
// Paint: each cell sums its own terms in one thread, in the twin's order;
// no float is added into the mesh by an atomic.  A particle at site l with
// floors fl reaches only cells L + e, L = l + fl, e in {0,1}^3, at offset o
// = fl + e, and paints at all only where every floor lies in [lo - 1, hi].
// For a fixed cell c the twin adds the terms of the sources c - o in
// ascending (ox, oy, oz), nested as its rolls: sy over oz, sx over oy, acc
// over ox.  A block owns a face of fy x 32 cells (warp = y, lane = z; fy =
// 16 where two blocks fit an SM's shared memory, narrower for wide bands),
// one thread a cell column, and marches DOWN x over the source planes s
// that reach its run of 32 cell planes.  Plane s feeds the D = hi - lo + 1
// cell planes X = s + ox, and marching down hands each cell its ox in
// ascending order, one source plane, one sx, at a time.  A step:
//   1. stage and push: each source of plane s, the face grown by the band
//      (periodic, the d of the plane loaded while the block summed the
//      plane before), stages in shared memory its eight corner terms ((wx
//      w) wy) wz, every product rounded, and one word from its floors, and
//      sets, for each corner cell inside the face and the run, the bit of
//      its (oy, oz) in that cell's D^2-bit mask for target ox, and the bit
//      ox in the cell's word of live targets: integer atomicOr's in shared
//      memory, whose result does not depend on their order;
//   2. sum: each cell walks its live targets' masks, bits in ascending
//      (oy, oz) two at a time (their loads in flight together), reads each
//      term by its source c - o and the source's word, nests sy and sx,
//      adds sx to the target plane's sum (a ring of D sums a cell) and
//      writes the plane X = s + hi, which is then complete.
// Measured first (the tile kernel this replaces, 2.05 ms at B = 2 on a
// 256^3 COLA run's own displacements): its sort-and-merge per cell took
// 1.47 ms of that, its staging and counting 0.35 ms, its scan, fill and
// bucket sorts 0.18 ms; slab mode's five passes spent 1.10 of their 1.83
// ms in the per-cell 8-way merge.  Here no cell merges buckets: the mask's
// bit order is the twin's order.  The bound by bytes is one read of d (and
// w) and one write of the mesh, 16 N^3 bytes (0.080 ms at 256^3); the
// kernel is instruction-bound at ~10x that: each source is staged (1 +
// span/fy)(1 + span/32)(1 + span/32) times, pushes up to 16 shared
// atomics, and a cell's walk diverges across its warp by the spread of its
// terms' count.  On a 256^3 COLA run's paints it takes 0.83, 0.85 and 0.99
// ms at B = 1, 2, 3 (2.5x the tile kernel; H100 80GB HBM3, 700 W;
// PERF.md), and uses no device memory beyond its output.  It keeps 64
// registers a thread, with no spills.  A cell clears its masks and live
// word as it walks them; a barrier separates the first clear from the
// first pushes, the pushes from the sums, and the sums from the next
// pushes.  The launcher narrows the face where shared memory would not
// hold it and refuses D > 32 (B = 16; the wrapper refuses it first).
//
// Gather: under the bound a particle's banded sum has at most eight
// non-zero weights, on the corners (l + floor(d) + {0,1}) mod N, summed oz
// outer, oy, then ox, as the twin nests its rolls; the three-mesh gather
// (the PM force components) computes the floors and weights once.  The
// bound on the card is bytes: one read of d and of each mesh, one write
// per particle and mesh.  Read straight from global memory, the corners of
// a warp's 32 particles fall in ~32 sectors per load wherever the
// displacements are uncorrelated, so sector traffic from L2, not bytes,
// bounds such a kernel.  Instead a block owns a face of sites, face_y x 32
// (warp = y, lane = z; no division by N), and marches along x over 32
// planes.  The mesh planes its corners can reach, the face grown by the
// band, stream through a ring of span + 1 + ahead planes per mesh in
// shared memory: cp.async copies of 16-byte chunks, coalesced along z and
// wrapped periodically, issued ahead of the plane being summed, while the
// next plane's d is loaded.  Each mesh plane is read from L2 ~(1 +
// span/face_y)(1 + span/32)^2 times, and the sums read shared memory.  The
// copies and the sums' shared-memory loads share the SM's load/store
// pipe: timed apart, each added about as much time as the d-in, out-out
// traffic alone, and copying 16 bytes at a time instead of 4 cut K11c by
// 15%.  Where the
// rings do not fit a block's shared memory (open band: f32 K11b beyond
// B = 8 and K11c beyond B = 5, f64 beyond 5 and 3), or N is not a multiple
// of a 16-byte chunk, one thread per particle reads its corners from
// global memory.  Only where a corner is loaded from differs: the
// arithmetic and its order, and the band tests, are the twin's, so kernel
// and twin agree bit for bit (H100 80GB HBM3, 700 W; PERF.md).
//
// Slab mode: the slab-sharded COLA engine's halo paint and force gather
// (fastbox_tpu/parallel/lattice.py:48-132, :135-166, whose roll sums reach
// K11a and K11c's arithmetic).  The particles are a slab of S rows, (S, N,
// N), and the band is closed.  The paint writes an (S + 2H, N, N) buffer,
// H = B + 1, particle row s landing on buffer row H + s + o: x does not
// wrap, y and z do.  The gather (kSlab) reads a halo-extended (S + 2H, N,
// N) mesh at row H + s + o with K11c's body.  The paint is a global
// counting sort by lower-corner cell in five passes over the slab, each a
// kernel: count (an atomic on the bucket of each particle), scan (reduce,
// then scan, over blocks), fill (an atomic claims the particle a place in
// its bucket for a record of its key and fractions), sort (each bucket by
// key) and sum (a thread per cell merges its 8 buckets in the twin's
// order, for every weight channel of a call on one sort).  Each pass
// streams the slab once; the sum, which visits each record from 8 cells
// through a chain of scattered loads where buckets hold several records,
// takes most of the time (times: PERF.md, section 6).  The sums and their order are the periodic mode's, in the
// slab twin's order (fastbox_tpu_torch/fields/lattice_cic.py), so the slab
// paint agrees with its twin bit for bit.
#include "common.cuh"

namespace {

constexpr int kMaxB = 16;
// A paint or staged gather block owns a face of kFaceZ cells or sites along
// z (a warp's lanes) and marches along x over a run of kRun planes.
constexpr int kFaceZ = 32, kRun = 32;
// A slab record's key: fl + kFlBias in 6 bits per axis (|fl| <= kMaxB + 1
// < kFlBias).
constexpr int kFlBias = 32;

__device__ __forceinline__ float floor_t(float a) { return floorf(a); }
__device__ __forceinline__ double floor_t(double a) { return floor(a); }

__device__ __forceinline__ int wrap(int a, int n) {
  a %= n;
  return a < 0 ? a + n : a;
}

// wrap() without the division where a is within one period of [0, n)
__device__ __forceinline__ int wrap_near(int a, int n) {
  if (a < 0) a += n;
  else if (a >= n) a -= n;
  return (a < 0 || a >= n) ? wrap(a, n) : a;
}

// start[0..n] = exclusive prefix sums of cnt[0..n); cnt[i] becomes start[i]
// (the fill's cursor).  Every thread of the block calls it.
__device__ void block_exclusive_scan(int* cnt, int* start, int n, int* scratch) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int i0 = threadIdx.x * per, i1 = min(i0 + per, n);
  int local = 0;
  for (int i = i0; i < i1; ++i) local += cnt[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  int v = local;
  for (int off = 1; off < 32; off *= 2) {
    const int u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? scratch[lane] : 0;
    for (int off = 1; off < 32; off *= 2) {
      const int u = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += u;
    }
    scratch[lane] = w;
  }
  __syncthreads();
  int offset = (warp > 0 ? scratch[warp - 1] : 0) + v - local;
  for (int i = i0; i < i1; ++i) {
    const int c = cnt[i];
    start[i] = offset;
    cnt[i] = offset;
    offset += c;
  }
  if (threadIdx.x == blockDim.x - 1) start[n] = offset;
}

// A paint block: a face of fy x kFaceZ cells (warp = y, lane = z), one
// thread a cell column, marching down x over kRun cell planes.  Shared
// memory: one staged source plane (the face grown by the band: each
// source's eight corner terms and its corner base), the cells' sums of the
// D = span + 1 planes in flight, and each cell's mask of the (oy, oz)
// offsets that reach it from the staged plane, D^2 bits (oy - lo) D + oz -
// lo for each of the D planes, with a word of the planes whose masks are
// not empty.
constexpr int kPaintAhead = 2;  // staged sources a thread loads a plane ahead
constexpr int kWalk = 2;        // mask bits a cell reads at once
__host__ __device__ inline int paint_mask_words(int D) { return (D * D + 31) / 32; }

template <typename T>
__host__ __device__ size_t paint_smem(int fy, int span) {
  const int D = span + 1, threads = fy * kFaceZ;
  const size_t staged = static_cast<size_t>(fy + span) * (kFaceZ + span);
  return staged * (8 * sizeof(T) + sizeof(int)) +
         static_cast<size_t>(threads) * (D * (sizeof(T) + paint_mask_words(D) * 4) + 4);
}

// A paint block's shape and shared memory (see paint_kernel).
template <typename T>
struct PaintBlock {
  T* term;           // [8][PYZ]: each staged source's corner terms
  int* corner;       // [PYZ]: each staged source's corner base
  unsigned* mask;    // [D][nw][threads]: each cell's offset masks
  unsigned* live;    // [threads]: each cell's targets with a mask bit
  int lo, hi, D, nw, PYZ, threads, fy, X0, R;
};

// This thread's staged sources p = t + j threads (j < kPaintAhead) of plane
// s: rows pr, lanes pq of the staged plane (source y0 - hi + r, z0 - hi +
// q, periodic).
template <typename T, bool kWeighted>
__device__ __forceinline__ void paint_load(const T* __restrict__ dx, const T* __restrict__ dy,
                                           const T* __restrict__ dz, const T* __restrict__ w,
                                           int N, int s, int ry0, int qz0, int t, int threads,
                                           int PYZ, const int (&pr)[kPaintAhead],
                                           const int (&pq)[kPaintAhead],
                                           T (&v)[kPaintAhead][3], T (&wv)[kPaintAhead]) {
  const int64_t gx = static_cast<int64_t>(wrap_near(s, N)) * N;
#pragma unroll
  for (int j = 0; j < kPaintAhead; ++j) {
    if (t + j * threads < PYZ) {
      const int64_t g = (gx + wrap_near(ry0 + pr[j], N)) * N + wrap_near(qz0 + pq[j], N);
      v[j][0] = dx[g];
      v[j][1] = dy[g];
      v[j][2] = dz[g];
      if (kWeighted) wv[j] = w[g];
    }
  }
}

// Stage source p of plane s, at (r, q), with displacement (a0, a1, a2) and
// weight wa, and push it.  A painting source (every floor in [lo - 1, hi],
// else no weight in the band is non-zero) stages its eight corner terms
// ((wx w) wy) wz, e = (ex, ey, ez) at 4 ex + 2 ey + ez, and its corner
// base 7 - 4 fx - 2 fy - fz (f = fl - lo + 1), so that a cell at offset o
// from it finds its term at 4 kx + 2 oyi + ozi + base (kx, oyi, ozi = o -
// lo).  Then it sets, in the mask of each corner cell L + e inside the face
// and the run, the bit of the offset (oy, oz) = fl + e for the target kx =
// fl_x + e_x - lo, and the cell's live bits of its targets.  The masks are
// integers, so the order of the atomicOr's does not matter.
template <typename T, bool kWeighted>
__device__ __forceinline__ void paint_stage(const PaintBlock<T>& b, int s, int p, int r, int q,
                                            T a0, T a1, T a2, T wa) {
  const T a[3] = {a0, a1, a2};
  int fl[3];
  T fr[3];
  bool ok = true;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const T f = floor_t(a[ax]);
    fr[ax] = a[ax] - f;  // exact
    ok = ok && f >= T(b.lo - 1) && f <= T(b.hi);
    fl[ax] = ok ? static_cast<int>(f) : 0;
  }
  if (!ok) return;
  const int lo = b.lo, hi = b.hi;
  b.corner[p] = 7 - 4 * (fl[0] - lo + 1) - 2 * (fl[1] - lo + 1) - (fl[2] - lo + 1);
  T px[2], wy[2], wz[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const T wx = e ? fr[0] : fbx::sub_rn(T(1), fr[0]);
    px[e] = kWeighted ? fbx::mul_rn(wx, wa) : wx;
    wy[e] = e ? fr[1] : fbx::sub_rn(T(1), fr[1]);
    wz[e] = e ? fr[2] : fbx::sub_rn(T(1), fr[2]);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    b.term[e * b.PYZ + p] = fbx::mul_rn(fbx::mul_rn(px[e >> 2], wy[(e >> 1) & 1]), wz[e & 1]);
  // target planes (x), rows (y) and lanes (z) of the corners e = 0, 1
  bool in_x[2], in_y[2], in_z[2];
  int kx[2], cy[2], cz[2], by[2], bz[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int ox = fl[0] + e, oy = fl[1] + e, oz = fl[2] + e;
    kx[e] = ox - lo;
    cy[e] = r - hi + oy;
    cz[e] = q - hi + oz;
    in_x[e] = ox >= lo && ox <= hi && s + ox >= b.X0 && s + ox < b.X0 + b.R;
    in_y[e] = oy >= lo && oy <= hi && cy[e] >= 0 && cy[e] < b.fy;
    in_z[e] = oz >= lo && oz <= hi && cz[e] >= 0 && cz[e] < kFaceZ;
    by[e] = (oy - lo) * b.D;
    bz[e] = oz - lo;
  }
  const unsigned targets = (in_x[0] ? 1u << kx[0] : 0u) | (in_x[1] ? 1u << kx[1] : 0u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int ey = e >> 1, ez = e & 1;
    if (targets == 0u || !in_y[ey] || !in_z[ez]) continue;
    const int bit = by[ey] + bz[ez];
    const int c = cy[ey] * kFaceZ + cz[ez];
#pragma unroll
    for (int ex = 0; ex < 2; ++ex)
      if (in_x[ex])
        atomicOr(&b.mask[(kx[ex] * b.nw + (bit >> 5)) * b.threads + c], 1u << (bit & 31));
    atomicOr(&b.live[c], targets);
  }
}

template <typename T, bool kWeighted>
__global__ void __launch_bounds__(16 * kFaceZ, 2)
paint_kernel(const T* __restrict__ dx, const T* __restrict__ dy, const T* __restrict__ dz,
             const T* __restrict__ w, T* __restrict__ out, int N, int lo, int hi,
             unsigned magic_d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int threads = blockDim.x, fy = threads / kFaceZ;
  const int span = hi - lo, D = span + 1, nw = paint_mask_words(D);
  const int PZ = kFaceZ + span, PYZ = (fy + span) * PZ;
  T* term = reinterpret_cast<T*>(smem_raw);                    // [8][PYZ]
  T* acc = term + 8 * PYZ;                                     // [D][threads]
  int* corner = reinterpret_cast<int*>(acc + D * threads);     // [PYZ]
  unsigned* mask = reinterpret_cast<unsigned*>(corner + PYZ);  // [D][nw][threads]
  unsigned* live = mask + D * nw * threads;                    // [threads]
  const int t = threadIdx.x, ty = t / kFaceZ, tz = t % kFaceZ;
  // z faces fastest in launch order, so blocks that share halo rows along
  // the contiguous axis run together and find them in L2
  const int z0 = blockIdx.x * kFaceZ, y0 = blockIdx.y * fy, X0 = blockIdx.z * kRun;
  const int R = min(kRun, N - X0);
  const int64_t NN = static_cast<int64_t>(N) * N;
  for (int i = 0; i < D * nw; ++i) mask[i * threads + t] = 0u;
  live[t] = 0u;
  for (int k = 0; k < D; ++k) acc[k * threads + t] = T(0);
  // every cell's masks clear before any source pushes into them
  __syncthreads();

  // This thread stages sources p = t + j threads of each plane; the first
  // kPaintAhead are loaded while the block sums the plane before.
  int pr[kPaintAhead], pq[kPaintAhead];
  T v[kPaintAhead][3], wv[kPaintAhead];
#pragma unroll
  for (int j = 0; j < kPaintAhead; ++j) {
    pr[j] = (t + j * threads) / PZ;
    pq[j] = (t + j * threads) % PZ;
    wv[j] = T(0);
  }
  const PaintBlock<T> pb{term, corner, mask, live, lo, hi, D, nw, PYZ, threads, fy, X0, R};

  // Source plane s feeds cell planes X = s + o_x, o_x in [lo, hi]: target k
  // = o_x - lo.  Marching down in s gives each cell its o_x ascending, the
  // twin's outer order.  Cell plane X takes ring slot (X - X0) mod D of acc;
  // base is the slot of X = s + lo.
  const int s_first = X0 + R - 1 - lo, s_last = X0 - hi;
  const int cell = (ty + span) * PZ + tz + span;  // the source at o = lo
  int base = (R - 1) % D;
  paint_load<T, kWeighted>(dx, dy, dz, w, N, s_first, y0 - hi, z0 - hi, t, threads, PYZ, pr, pq,
                           v, wv);
  for (int s = s_first; s >= s_last; --s) {
    // 1. stage and push
#pragma unroll
    for (int j = 0; j < kPaintAhead; ++j)
      if (t + j * threads < PYZ)
        paint_stage<T, kWeighted>(pb, s, t + j * threads, pr[j], pq[j], v[j][0], v[j][1], v[j][2],
                                  wv[j]);
    for (int p = t + kPaintAhead * threads; p < PYZ; p += threads) {  // wide bands only
      const int r = p / PZ, q = p % PZ;
      const int64_t g = (static_cast<int64_t>(wrap_near(s, N)) * N + wrap_near(y0 - hi + r, N)) * N +
                        wrap_near(z0 - hi + q, N);
      paint_stage<T, kWeighted>(pb, s, p, r, q, dx[g], dy[g], dz[g], kWeighted ? w[g] : T(0));
    }
    __syncthreads();
    if (s > s_last)  // in flight while the block sums
      paint_load<T, kWeighted>(dx, dy, dz, w, N, s - 1, y0 - hi, z0 - hi, t, threads, PYZ, pr, pq,
                               v, wv);

    // 2. Each cell sums what the staged plane gives each target plane whose
    // mask is not empty: the mask's bits in ascending (oy, oz), the staged
    // terms nested as the twin nests its rolls (sy over oz, sx over oy,
    // every sum rounded explicitly), sx added to the plane's sum.
    for (unsigned u = live[t]; u != 0u; u &= u - 1) {
      const int k = __ffs(u) - 1;
      T sx = T(0), sy = T(0);
      int cur_oy = -1;
      for (int wd = 0; wd < nw; ++wd) {
        unsigned* mw = &mask[(k * nw + wd) * threads + t];
        unsigned m = *mw;
        if (m == 0u) continue;
        *mw = 0u;
        // kWalk bits at a time, their loads in flight together
        do {
          int oyi[kWalk], ozi[kWalk];
          bool use[kWalk];
          T tm[kWalk];
          int bit = 0;
#pragma unroll
          for (int i = 0; i < kWalk; ++i) {
            use[i] = m != 0u;
            if (use[i]) {
              bit = wd * 32 + __ffs(m) - 1;
              m &= m - 1;
            }
            oyi[i] = __umulhi(static_cast<unsigned>(bit), magic_d);  // bit / D
            ozi[i] = bit - oyi[i] * D;
            const int p = cell - oyi[i] * PZ - ozi[i];  // the source c - o
            tm[i] = term[(4 * k + 2 * oyi[i] + ozi[i] + corner[p]) * PYZ + p];
          }
#pragma unroll
          for (int i = 0; i < kWalk; ++i) {
            if (!use[i]) break;
            if (oyi[i] != cur_oy) {
              sx = fbx::add_rn(sx, sy);
              sy = T(0);
              cur_oy = oyi[i];
            }
            sy = fbx::add_rn(sy, tm[i]);
          }
        } while (m != 0u);
      }
      T* a = &acc[(base + k < D ? base + k : base + k - D) * threads + t];
      *a = fbx::add_rn(*a, fbx::add_rn(sx, sy));
    }
    live[t] = 0u;
    // The plane X = s + hi is complete: written, its slot cleared for X =
    // s - 1 + lo.
    const int X = s + hi;
    if (X >= X0 && X < X0 + R) {
      T* a = &acc[(base == 0 ? D - 1 : base - 1) * threads + t];
      const int y = y0 + ty, z = z0 + tz;
      if (y < N && z < N) out[X * NN + static_cast<int64_t>(y) * N + z] = *a;
      *a = T(0);
    }
    base = base == 0 ? D - 1 : base - 1;
    __syncthreads();
  }
}

// cp.async of one element into shared memory (sm_80+): no register staging,
// many copies in flight per thread
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
               "n"(sizeof(T)));
}

// cp.async of 16 bytes, both addresses 16-byte aligned; cached in L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kPending of this thread's copy groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The staged gather's block: a face_y x kFaceZ face of sites (warp = y,
// lane = z; rows sites per thread along y) that marches along x over kRun
// planes, with ahead mesh planes staged ahead of the plane it sums.

// K11b takes two sites per thread; K11c's three rings leave room for two
// blocks of one site per thread, staged two planes ahead.
template <int kMeshes>
struct GatherShape {
  static constexpr int warps = 16;                    // per block
  static constexpr int rows = kMeshes == 1 ? 2 : 1;   // sites per thread along y
  static constexpr int ahead = kMeshes == 1 ? 4 : 2;  // mesh planes staged ahead
  static constexpr int face_y = warps * rows, threads = warps * 32;
};

// one site's floors, fractions and band tests; bit 2 ax + e of the mask:
// corner offset floor + e lies in [lo, hi]
template <typename T>
__device__ __forceinline__ unsigned corners(const T v[3], int lo, int hi, T fr[3], int fl[3]) {
  unsigned ok = 0;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const T f = floor_t(v[ax]);
    fr[ax] = v[ax] - f;  // exact
    fl[ax] = 0;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const T o = f + T(e);  // exact: |f| <= N
      if (o >= T(lo) && o <= T(hi)) {
        ok |= 1u << (2 * ax + e);
        fl[ax] = static_cast<int>(o) - e;
      }
    }
  }
  return ok;
}

// The banded sum of one site in the twin's order, oz outer, oy, then ox,
// over its in-band corners; at(cx, cy, cz) loads corner floor + (cx, cy, cz).
template <typename T, typename At>
__device__ __forceinline__ T corner_sum(unsigned ok, const T fr[3], At&& at) {
  T acc = T(0);
#pragma unroll
  for (int cz = 0; cz < 2; ++cz) {
    if (!((ok >> (4 + cz)) & 1u)) continue;
    const T wz = cz ? fr[2] : fbx::sub_rn(T(1), fr[2]);
#pragma unroll
    for (int cy = 0; cy < 2; ++cy) {
      if (!((ok >> (2 + cy)) & 1u)) continue;
      const T wyz = fbx::mul_rn(cy ? fr[1] : fbx::sub_rn(T(1), fr[1]), wz);
      T sx = T(0);
#pragma unroll
      for (int cx = 0; cx < 2; ++cx) {
        if ((ok >> cx) & 1u) {
          const T wx = cx ? fr[0] : fbx::sub_rn(T(1), fr[0]);
          sx = fbx::add_rn(sx, fbx::mul_rn(wx, at(cx, cy, cz)));
        }
      }
      acc = fbx::add_rn(acc, fbx::mul_rn(wyz, sx));
    }
  }
  return acc;
}

// A staged row of a mesh plane starts at the 16-byte boundary at or below
// z0 + lo (every z0 is a multiple of 32): shift elements before the
// face's band, row pitch pitch elements, in whole 16-byte chunks.
template <typename T>
__host__ __device__ void gather_row(int lo, int hi, int* shift, int* pitch) {
  constexpr int kVec = 16 / sizeof(T);
  *shift = ((lo % kVec) + kVec) % kVec;
  *pitch = (*shift + kFaceZ + hi - lo + kVec - 1) / kVec * kVec;
}

// Shared memory of a staged gather block: kMeshes rings of span + 1 +
// ahead mesh planes, each (face_y + span) rows of pitch elements.
template <typename T, int kMeshes>
size_t gather_smem(int lo, int hi) {
  using S = GatherShape<kMeshes>;
  int shift, pitch;
  gather_row<T>(lo, hi, &shift, &pitch);
  const int span = hi - lo;
  return static_cast<size_t>(kMeshes) * (span + 1 + S::ahead) * (S::face_y + span) * pitch *
         sizeof(T);
}

// kSlab: rows particle rows reading mesh rows H + s + o; otherwise rows ==
// N, H == 0 and x wraps
template <typename T, int kMeshes, bool kSlab>
__global__ void __launch_bounds__(GatherShape<kMeshes>::threads)
gather_kernel(const T* __restrict__ m0, const T* __restrict__ m1, const T* __restrict__ m2,
              const T* __restrict__ dx, const T* __restrict__ dy, const T* __restrict__ dz,
              T* __restrict__ o0, T* __restrict__ o1, T* __restrict__ o2, int N, int rows, int H,
              int lo, int hi) {
  using S = GatherShape<kMeshes>;
  constexpr int kWarps = S::warps, kRows = S::rows, kAhead = S::ahead;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kVec = 16 / sizeof(T);
  const int span = hi - lo;
  int shift, PZ;
  gather_row<T>(lo, hi, &shift, &PZ);
  const int PY = S::face_y + span, plane = PY * PZ, nchunk = PZ / kVec;
  const int R = span + 1 + kAhead;            // ring depth, planes
  T* ring = reinterpret_cast<T*>(smem_raw);  // [kMeshes][R][PY][PZ]
  const T* mesh[3] = {m0, m1, m2};
  T* outp[3] = {o0, o1, o2};
  const int lane = threadIdx.x & 31, wy = threadIdx.x >> 5;
  // z faces fastest in launch order, so blocks whose planes share rows
  // along the contiguous axis run together and find them in L2
  const int z0 = blockIdx.x * kFaceZ, y0 = blockIdx.y * S::face_y, xs = blockIdx.z * kRun;
  const int nrun = min(kRun, rows - xs);
  const int sz = z0 + lane;

  // Mesh plane q (global x = xs + lo + q, q < nrun + span; mesh row H + xs
  // + lo + q in slab mode) of every mesh into ring slot q mod R as one
  // cp.async group of 16-byte chunks, coalesced along z and wrapped
  // periodically (N is a multiple of kVec, so no chunk crosses the
  // periodic edge); an empty group past the end keeps the count.
  const int za = z0 + lo - shift;
  auto stage = [&](int q) {
    if (q < nrun + span) {
      const int64_t gx =
          static_cast<int64_t>(kSlab ? H + xs + lo + q : wrap_near(xs + lo + q, N)) * N;
      T* slot = ring + static_cast<size_t>(q % R) * plane;
      for (int p = threadIdx.x; p < PY * nchunk; p += S::threads) {
        const int r = p / nchunk, c = p - r * nchunk;
        const int64_t g = (gx + wrap_near(y0 + lo + r, N)) * N + wrap_near(za + c * kVec, N);
#pragma unroll
        for (int m = 0; m < kMeshes; ++m)
          cp_async16(slot + static_cast<size_t>(m) * R * plane + r * PZ + c * kVec, mesh[m] + g);
      }
    }
    cp_async_commit();
  };
  // this thread's sites (xs + j, y0 + wy + kWarps t, sz), t < kRows
  auto live = [&](int t) { return y0 + wy + kWarps * t < N && sz < N; };
  auto site = [&](int j, int t) {
    return (static_cast<int64_t>(xs + j) * N + y0 + wy + kWarps * t) * N + sz;
  };
  auto load_d = [&](int j, T v[kRows][3]) {
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      if (live(t) && j < nrun) {
        const int64_t g = site(j, t);
        v[t][0] = dx[g];
        v[t][1] = dy[g];
        v[t][2] = dz[g];
      }
    }
  };

  // plane q is group q: the first span + kAhead, then one per step
  for (int q = 0; q < span + kAhead; ++q) stage(q);
  T v[kRows][3] = {};
  load_d(0, v);
  for (int j = 0, jr = 0; j < nrun; ++j, jr = jr + 1 == R ? 0 : jr + 1) {
    T vn[kRows][3] = {};
    load_d(j + 1, vn);            // the next step's d, in flight meanwhile
    cp_async_wait<kAhead - 1>();  // planes up to j + span have landed
    __syncthreads();
    // every thread has summed plane j - 1: its slot takes plane j + span +
    // kAhead
    stage(j + span + kAhead);
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      if (!live(t)) continue;
      T fr[3];
      int fl[3];
      const unsigned ok = corners(v[t], lo, hi, fr, fl);
      // where in band, corner plane j + fl + cx - lo lies in [j, j + span]
      int s0 = jr + fl[0] - lo;
      s0 = s0 < 0 ? s0 + R : (s0 >= R ? s0 - R : s0);
      const int s1 = s0 + 1 == R ? 0 : s0 + 1;
      const int row = (wy + kWarps * t + fl[1] - lo) * PZ + lane + fl[2] - lo + shift;
      const int64_t g = site(j, t);
#pragma unroll
      for (int m = 0; m < kMeshes; ++m) {
        const T* r0 = ring + static_cast<size_t>(m * R + s0) * plane + row;
        const T* r1 = ring + static_cast<size_t>(m * R + s1) * plane + row;
        outp[m][g] = corner_sum(ok, fr, [&](int cx, int cy, int cz) {
          return (cx ? r1 : r0)[cy * PZ + cz];
        });
      }
    }
#pragma unroll
    for (int t = 0; t < kRows; ++t)
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) v[t][ax] = vn[t][ax];
  }
}

// The gather where the staged rings do not fit (wide bands): one thread per
// particle reads its corners from global memory.
template <typename T, int kMeshes, bool kSlab>
__global__ void __launch_bounds__(256)
gather_direct_kernel(const T* __restrict__ m0, const T* __restrict__ m1,
                     const T* __restrict__ m2, const T* __restrict__ dx,
                     const T* __restrict__ dy, const T* __restrict__ dz, T* __restrict__ o0,
                     T* __restrict__ o1, T* __restrict__ o2, int N, int rows, int H, int lo,
                     int hi) {
  const int64_t NN = static_cast<int64_t>(N) * N;
  const int64_t n3 = NN * rows;
  const T* mesh[3] = {m0, m1, m2};
  T* outp[3] = {o0, o1, o2};
  for (int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; g < n3;
       g += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int site[3] = {static_cast<int>(g / NN), static_cast<int>((g / N) % N),
                         static_cast<int>(g % N)};
    const T v[3] = {dx[g], dy[g], dz[g]};
    T fr[3];
    int fl[3];
    const unsigned ok = corners(v, lo, hi, fr, fl);
#pragma unroll
    for (int m = 0; m < kMeshes; ++m) {
      const T* src = mesh[m];
      outp[m][g] = corner_sum(ok, fr, [&](int cx, int cy, int cz) {
        const int64_t x = kSlab ? H + site[0] + fl[0] + cx : wrap(site[0] + fl[0] + cx, N);
        return src[x * NN + wrap(site[1] + fl[1] + cy, N) * N + wrap(site[2] + fl[2] + cz, N)];
      });
    }
  }
}

cudaError_t band(int64_t N, int B, int openband, int* lo, int* hi) {
  if (N < 1 || N > (1 << 20) || B < 1 || B > kMaxB) return cudaErrorInvalidValue;
  *lo = -B;
  *hi = openband ? B : B + 1;
  return cudaSuccess;
}

// The particle rows and halo of a call: a periodic cube (nslab < 0: rows =
// N, H = 0) or an nslab-row slab (H = B + 1, closed band).
cudaError_t slab_rows(int64_t N, int64_t nslab, int B, int* rows, int* H) {
  if (nslab < 0) {
    *rows = static_cast<int>(N);
    *H = 0;
    return cudaSuccess;
  }
  if (nslab < 1 || nslab > (1 << 20)) return cudaErrorInvalidValue;
  *rows = static_cast<int>(nslab);
  *H = B + 1;
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
  if (span + 1 > 32) return cudaErrorInvalidValue;  // a word of live planes
  // the widest face, 16 rows down to one, of which two blocks fit an SM's
  // shared memory, else of which one fits
  int fy = 0;
  size_t smem = 0;
  for (int pass = 0; pass < 2 && fy == 0; ++pass) {
    for (int f = 16; f >= 1; f /= 2) {
      smem = paint_smem<T>(f, span);
      if (smem * (pass == 0 ? 2 : 1) <= static_cast<size_t>(max_smem)) {
        fy = f;
        break;
      }
    }
  }
  if (fy == 0) return cudaErrorInvalidValue;
  auto kernel = weighted ? &paint_kernel<T, true> : &paint_kernel<T, false>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int n = static_cast<int>(N);
  const dim3 grid((n + kFaceZ - 1) / kFaceZ, (n + fy - 1) / fy, (n + kRun - 1) / kRun);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  const unsigned magic_d = 0xffffffffu / (span + 1) + 1;  // ceil(2^32 / D)
  kernel<<<grid, fy * kFaceZ, smem, stream>>>(dx, dy, dz, w, out, n, lo, hi, magic_d);
  return cudaGetLastError();
}

// nslab < 0: periodic (N, N, N) meshes and sites; nslab = S >= 1: (S, N, N)
// sites reading (S + 2H, N, N) halo-extended meshes
template <typename T, int kMeshes, bool kSlab>
cudaError_t launch_gather(const T* m0, const T* m1, const T* m2, const T* dx, const T* dy,
                          const T* dz, T* o0, T* o1, T* o2, int64_t N, int64_t nslab, int B,
                          int openband, cudaStream_t stream) {
  int lo, hi, rows, H;
  cudaError_t e = band(N, B, openband, &lo, &hi);
  if (e != cudaSuccess) return e;
  if ((e = slab_rows(N, nslab, B, &rows, &H)) != cudaSuccess) return e;
  int dev, max_smem;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return e;
  const int n = static_cast<int>(N);
  using S = GatherShape<kMeshes>;
  const size_t smem = gather_smem<T, kMeshes>(lo, hi);
  if (smem <= static_cast<size_t>(max_smem) && N % (16 / sizeof(T)) == 0) {
    auto kernel = &gather_kernel<T, kMeshes, kSlab>;
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    const dim3 grid((n + kFaceZ - 1) / kFaceZ, (n + S::face_y - 1) / S::face_y,
                    (rows + kRun - 1) / kRun);
    if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
    kernel<<<grid, S::threads, smem, stream>>>(m0, m1, m2, dx, dy, dz, o0, o1, o2, n, rows, H,
                                                lo, hi);
    return cudaGetLastError();
  }
  const int64_t n3 = static_cast<int64_t>(rows) * N * N;
  const int threads = 256;
  int64_t blocks = (n3 + threads - 1) / threads;
  if (blocks > (1 << 22)) blocks = 1 << 22;
  gather_direct_kernel<T, kMeshes, kSlab><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      m0, m1, m2, dx, dy, dz, o0, o1, o2, n, rows, H, lo, hi);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Slab paint (K11a's slab mode): a global counting sort by lower-corner cell.
// Five passes over the whole slab, each a kernel of its own on the caller's
// stream, on scratch from the caller (slab_scratch_words int32 words).

constexpr int kRowThreads = 256;   // count and fill: a row of z per block
constexpr int kSortThreads = 256;  // one bucket per thread
constexpr int kSumThreads = 256;   // cells of a row per block
constexpr int kScanThreads = 1024;
constexpr int kScanTile = 4 * kScanThreads;  // counts per scan block, 4 a thread
constexpr int kNoKey = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// A slab source's record: its sort key and per-axis fractions d - floor(d).
template <typename T>
struct __align__(16) SlabRecord {
  int key;
  T fr[3];
};

// The key: floors fl + kFlBias in 6 bits per axis, x highest, so integer
// order is (fl_x, fl_y, fl_z) order, and key + corner_key(e) (offset o = fl
// + e; no carry, fl + kFlBias + 1 < 64) is (o_x, o_y, o_z) order, the twin's.
__device__ __forceinline__ int slab_key(int fx, int fy, int fz) {
  return ((fx + kFlBias) << 12) | ((fy + kFlBias) << 6) | (fz + kFlBias);
}
__device__ __forceinline__ int key_axis(int key, int ax) {
  return ((key >> (12 - 6 * ax)) & 63) - kFlBias;
}
__device__ __forceinline__ int corner_key(int e) {
  return ((e >> 2) << 12) | (((e >> 1) & 1) << 6) | (e & 1);
}

// Within a bucket the floors lie in [lo - 1, hi]^3, W = hi - lo + 2 a side:
// a key's dense index there and back, both in key order.
__device__ __forceinline__ int key_dense(int key, int lo, int W) {
  return ((key_axis(key, 0) - lo + 1) * W + key_axis(key, 1) - lo + 1) * W + key_axis(key, 2) -
         lo + 1;
}
__device__ __forceinline__ int dense_key(int d, int lo, int W) {
  return slab_key(d / (W * W) + lo - 1, (d / W) % W + lo - 1, d % W + lo - 1);
}

// Particle (s, y, z) at g: whether it paints at all (every floor in [lo -
// 1, hi], else no weight is non-zero on [lo, hi]), and then its key, its
// fractions and its lower-corner cell L = (H + s + fl_x, y + fl_y, z + fl_z)
// of the (S + 2H, N, N) buffer, y and z wrapped.
template <typename T>
__device__ __forceinline__ bool slab_source(const T* __restrict__ dx, const T* __restrict__ dy,
                                            const T* __restrict__ dz, int64_t g, int s, int y,
                                            int z, int N, int H, int lo, int hi,
                                            SlabRecord<T>* rec, int64_t* L) {
  const T v[3] = {dx[g], dy[g], dz[g]};
  int fl[3];
  bool ok = true;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const T f = floor_t(v[ax]);
    rec->fr[ax] = v[ax] - f;  // exact
    ok = ok && f >= T(lo - 1) && f <= T(hi);
    fl[ax] = ok ? static_cast<int>(f) : 0;
  }
  rec->key = slab_key(fl[0], fl[1], fl[2]);
  *L = (static_cast<int64_t>(H + s + fl[0]) * N + wrap_near(y + fl[1], N)) * N +
       wrap_near(z + fl[2], N);
  return ok;
}

// 1. Count, a thread per particle (blockIdx.x = s N + y): bucket L's count
// goes to A[L + 1] (A[0] stays 0).
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
slab_count_kernel(const T* __restrict__ dx, const T* __restrict__ dy, const T* __restrict__ dz,
                  int* __restrict__ A, int N, int H, int lo, int hi) {
  const int z = blockIdx.y * blockDim.x + threadIdx.x;
  if (z >= N) return;
  const int s = blockIdx.x / N, y = blockIdx.x - s * N;
  SlabRecord<T> rec;
  int64_t L;
  if (slab_source(dx, dy, dz, static_cast<int64_t>(blockIdx.x) * N + z, s, y, z, N, H, lo, hi,
                  &rec, &L))
    atomicAdd(&A[L + 1], 1);
}

// 2. Scan A in place, exclusive, reduce then scan: each tile's sum, the
// tiles' exclusive scan (one block), each tile's own from its start.  A
// holds whole tiles (zeros past the last bucket); A[L + 1] becomes bucket
// L's start.
__global__ void __launch_bounds__(kScanThreads)
scan_reduce_kernel(const int* __restrict__ A, int* __restrict__ tile_sum) {
  __shared__ int warp_sum[32];
  const int4 q = reinterpret_cast<const int4*>(A)[static_cast<int64_t>(blockIdx.x) * kScanThreads +
                                                  threadIdx.x];
  int v = q.x + q.y + q.z + q.w;
  for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(kFull, v, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = warp_sum[threadIdx.x];
    for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(kFull, v, off);
    if (threadIdx.x == 0) tile_sum[blockIdx.x] = v;
  }
}

__global__ void __launch_bounds__(kScanThreads)
scan_tiles_kernel(int* tile_sum, int ntile) {
  __shared__ int scratch[32];
  block_exclusive_scan(tile_sum, tile_sum, ntile, scratch);
}

__global__ void __launch_bounds__(kScanThreads)
scan_down_kernel(int* __restrict__ A, const int* __restrict__ tile_start) {
  __shared__ int sums[kScanThreads + 1];
  __shared__ int scratch[32];
  int4* a = reinterpret_cast<int4*>(A) + static_cast<int64_t>(blockIdx.x) * kScanThreads +
            threadIdx.x;
  const int4 q = *a;
  sums[threadIdx.x] = q.x + q.y + q.z + q.w;
  __syncthreads();
  block_exclusive_scan(sums, sums, kScanThreads, scratch);
  __syncthreads();
  const int base = tile_start[blockIdx.x] + sums[threadIdx.x];
  *a = make_int4(base, base + q.x, base + q.x + q.y, base + q.x + q.y + q.z);
}

// 3. Fill: each painting particle claims the next place of its bucket
// (atomics, in arbitrary order) and writes its record there.  A[L + 1]
// ends at bucket L's end, so bucket L is [A[L], A[L + 1]) from here on.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
slab_fill_kernel(const T* __restrict__ dx, const T* __restrict__ dy, const T* __restrict__ dz,
                 int* __restrict__ A, SlabRecord<T>* __restrict__ records, int N, int H, int lo,
                 int hi) {
  const int z = blockIdx.y * blockDim.x + threadIdx.x;
  if (z >= N) return;
  const int s = blockIdx.x / N, y = blockIdx.x - s * N;
  SlabRecord<T> rec;
  int64_t L;
  if (slab_source(dx, dy, dz, static_cast<int64_t>(blockIdx.x) * N + z, s, y, z, N, H, lo, hi,
                  &rec, &L))
    records[atomicAdd(&A[L + 1], 1)] = rec;
}

// 4. Each bucket in ascending key, which removes the atomics' order: a key
// is unique within its bucket (source = L - fl).  A thread sorts a bucket
// of up to 32 records by insertion.  The whole warp takes each longer one
// (up to (2B + 3)^3 records, a collapsed halo) in turn: a bitmap of its
// keys' dense indices in shared memory (words 32-bit words a warp), read
// back in order, each record's fractions read again at its source.
template <typename T>
__device__ __forceinline__ void insertion_sort(SlabRecord<T>* r, int n) {
  for (int i = 1; i < n; ++i) {
    const SlabRecord<T> cur = r[i];
    int j = i - 1;
    while (j >= 0 && r[j].key > cur.key) {
      r[j + 1] = r[j];
      --j;
    }
    r[j + 1] = cur;
  }
}

template <typename T>
__global__ void __launch_bounds__(kSortThreads)
slab_sort_kernel(const T* __restrict__ dx, const T* __restrict__ dy, const T* __restrict__ dz,
                 const int* __restrict__ A, SlabRecord<T>* __restrict__ records, int64_t ncell,
                 int N, int H, int lo, int W, int words) {
  extern __shared__ unsigned bitmap[];
  unsigned* bits = bitmap + (threadIdx.x >> 5) * words;
  const int lane = threadIdx.x & 31;
  const int64_t L = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int b0 = L < ncell ? A[L] : 0;
  const int n = L < ncell ? A[L + 1] - b0 : 0;
  if (n >= 2 && n <= 32) insertion_sort(records + b0, n);
  for (unsigned todo = __ballot_sync(kFull, n > 32); todo; todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    SlabRecord<T>* r = records + __shfl_sync(kFull, b0, src);
    const int rn = __shfl_sync(kFull, n, src);
    const int64_t cell = L - lane + src;
    const int cx = static_cast<int>(cell / N / N), cy = static_cast<int>(cell / N % N),
              cz = static_cast<int>(cell % N);
    for (int i = lane; i < words; i += 32) bits[i] = 0u;
    __syncwarp();
    for (int i = lane; i < rn; i += 32) {
      const int d = key_dense(r[i].key, lo, W);
      atomicOr(&bits[d >> 5], 1u << (d & 31));
    }
    __syncwarp();
    int base = 0;
    for (int w0 = 0; w0 < words; w0 += 32) {
      unsigned m = w0 + lane < words ? bits[w0 + lane] : 0u;
      const int c = __popc(m);
      int incl = c;
      for (int off = 1; off < 32; off *= 2) {
        const int u = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += u;
      }
      for (int at = base + incl - c; m; m &= m - 1) {
        SlabRecord<T> rec;
        rec.key = dense_key((w0 + lane) * 32 + __ffs(m) - 1, lo, W);
        const int64_t g = (static_cast<int64_t>(cx - H - key_axis(rec.key, 0)) * N +
                           wrap_near(cy - key_axis(rec.key, 1), N)) * N +
                          wrap_near(cz - key_axis(rec.key, 2), N);
        const T v[3] = {dx[g], dy[g], dz[g]};
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) rec.fr[ax] = v[ax] - floor_t(v[ax]);
        r[at++] = rec;
      }
      base += __shfl_sync(kFull, incl, 31);
    }
    __syncwarp();
  }
}

// 5. Sum: a block per kSumThreads cells of a row (X, y) (blockIdx.x = X N +
// y, blockIdx.y the chunk of z).  A cell c = (X, y, z) takes the entries of
// its 8 buckets L = c - e in ascending (o << 3) | e, o = key + corner_key(e):
// (o_x, o_y, o_z) order, the twin's: a merge of the 8 buckets.  A cell's
// work is its number of entries, which
// clustering spreads widely, so the block first deals its cells to its
// threads by that number (classes of 4), so that a warp's cells take
// alike.  Each term with o in [lo, hi] is summed as the twin nests its
// rolls, ox { oy { oz } }: partial sums sy -> sx -> acc, every product and
// sum rounded explicitly; the terms the twin adds with weight zero add
// exactly nothing.  The kC weight channels' weights are read at the source
// c - o; the sums leave through shared memory, coalesced.
template <typename T, bool kWeighted, int kC>
__global__ void __launch_bounds__(kSumThreads)
slab_sum_kernel(const T* __restrict__ w, const int* __restrict__ A,
                const SlabRecord<T>* __restrict__ records, T* __restrict__ out, int N, int H,
                int lo, int hi, int64_t np, int64_t ncell) {
  constexpr int kClasses = 32;
  __shared__ int at_s[8][kSumThreads], end_s[8][kSumThreads];
  __shared__ int hist[kClasses + 1], deal[kSumThreads];
  __shared__ T sums[kC][kSumThreads];
  const int t = threadIdx.x;
  const int X = blockIdx.x / N, y = blockIdx.x - X * N;
  const int ym = y == 0 ? N - 1 : y - 1;
  const int z0 = blockIdx.y * kSumThreads;
  const int ncz = N - z0 < kSumThreads ? N - z0 : kSumThreads;  // this block's cells
  // the starts of bucket row q = 2 ex + ey, (X - ex, y - ey), or null
  // before the buffer's first row
  const int* row[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    row[q] = X - (q >> 1) < 0
                 ? nullptr
                 : A + (static_cast<int64_t>(X - (q >> 1)) * N + (q & 1 ? ym : y)) * N;
  // bucket e of cell z: A[L], A[L + 1]
  auto bucket = [&](int z, int e, int* b0, int* b1) {
    *b0 = *b1 = 0;
    if (row[e >> 1] != nullptr) {
      const int* r = row[e >> 1] + (e & 1 ? (z == 0 ? N - 1 : z - 1) : z);
      *b0 = r[0];
      *b1 = r[1];
    }
  };
  if (t <= kClasses) hist[t] = 0;
  __syncthreads();
  int cls = 0, rank = 0;
  if (t < ncz) {
    int n = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      int b0, b1;
      bucket(z0 + t, e, &b0, &b1);
      n += b1 - b0;
    }
    cls = n / 4 < kClasses - 1 ? n / 4 : kClasses - 1;
    rank = atomicAdd(&hist[cls + 1], 1);
  }
  __syncthreads();
  if (t < 32) {  // hist[c] becomes the first place of class c
    int v = hist[t + 1];
    for (int off = 1; off < 32; off *= 2) {
      const int u = __shfl_up_sync(kFull, v, off);
      if (t >= off) v += u;
    }
    hist[t + 1] = v;
  }
  __syncthreads();
  if (t < ncz) deal[hist[cls] + rank] = t;
  __syncthreads();
  if (t < ncz) {
    const int iz = deal[t], z = z0 + iz;
    // bucket e: records [at, end); head: (o << 3) | e of its first, or kNoKey
    int head[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      int b0, b1;
      bucket(z, e, &b0, &b1);
      at_s[e][t] = b0;
      end_s[e][t] = b1;
      head[e] = b0 < b1 ? ((records[b0].key + corner_key(e)) << 3) | e : kNoKey;
    }
    T acc[kC], sx[kC], sy[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[c] = sx[c] = sy[c] = T(0);
    int cur_ox = lo - 2, cur_oy = lo - 2;
    // the term of packed entry p = (o << 3) | e, record r
    auto add = [&](int p, const SlabRecord<T>& r) {
      const int e = p & 7;
      const int ox = key_axis(p >> 3, 0), oy = key_axis(p >> 3, 1), oz = key_axis(p >> 3, 2);
      if (ox < lo || ox > hi || oy < lo || oy > hi || oz < lo || oz > hi) return;
      // e = 0: weight 1 - fr, e = 1: weight fr
      const T wx = e >> 2 ? r.fr[0] : fbx::sub_rn(T(1), r.fr[0]);
      const T wy = (e >> 1) & 1 ? r.fr[1] : fbx::sub_rn(T(1), r.fr[1]);
      const T wz = e & 1 ? r.fr[2] : fbx::sub_rn(T(1), r.fr[2]);
      if (ox != cur_ox) {
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          sx[c] = fbx::add_rn(sx[c], sy[c]);
          acc[c] = fbx::add_rn(acc[c], sx[c]);
          sx[c] = sy[c] = T(0);
        }
        cur_ox = ox;
        cur_oy = oy;
      } else if (oy != cur_oy) {
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          sx[c] = fbx::add_rn(sx[c], sy[c]);
          sy[c] = T(0);
        }
        cur_oy = oy;
      }
      int64_t src = 0;
      if (kWeighted)
        src = (static_cast<int64_t>(X - H - ox) * N + wrap_near(y - oy, N)) * N +
              wrap_near(z - oz, N);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const T px = kWeighted ? fbx::mul_rn(wx, w[c * np + src]) : wx;
        sy[c] = fbx::add_rn(sy[c], fbx::mul_rn(fbx::mul_rn(px, wy), wz));
      }
    };
    while (true) {
      int p = head[0];
#pragma unroll
      for (int e = 1; e < 8; ++e) p = min(p, head[e]);
      if (p == kNoKey) break;
      const int e = p & 7, pos = at_s[e][t];
      const int next =
          pos + 1 < end_s[e][t] ? ((records[pos + 1].key + corner_key(e)) << 3) | e : kNoKey;
      at_s[e][t] = pos + 1;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (e == j) head[j] = next;
      add(p, records[pos]);
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      sx[c] = fbx::add_rn(sx[c], sy[c]);
      sums[c][iz] = fbx::add_rn(acc[c], sx[c]);
    }
  }
  __syncthreads();
  if (t < ncz) {
    const int64_t cell = static_cast<int64_t>(blockIdx.x) * N + z0 + t;
#pragma unroll
    for (int c = 0; c < kC; ++c) out[c * ncell + cell] = sums[c][t];
  }
}

// The buffer's buckets and the scan's tiles of a call: ncell = (S + 2H) N^2
// cells, ntile tiles of A's ncell + 1 counts; false where out of range
// (bucket starts are int32).
bool slab_layout(int64_t S, int64_t N, int B, int64_t* ncell, int64_t* ntile) {
  int lo, hi, rows, H;
  if (band(N, B, 0, &lo, &hi) != cudaSuccess || slab_rows(N, S, B, &rows, &H) != cudaSuccess)
    return false;
  *ncell = (S + 2 * H) * N * N;
  *ntile = (*ncell + kScanTile) / kScanTile;
  return *ntile * kScanTile < (int64_t{1} << 31);
}

// The int32 words of a slab paint's scratch: the records (one a particle,
// elem_bytes the dtype's size), A (whole scan tiles) and the tile sums; -1
// where the call is out of range.
int64_t slab_scratch_words(int64_t S, int64_t N, int B, int elem_bytes) {
  int64_t ncell, ntile;
  if (!slab_layout(S, N, B, &ncell, &ntile) || (elem_bytes != 4 && elem_bytes != 8)) return -1;
  const int64_t rec = elem_bytes == 4 ? sizeof(SlabRecord<float>) : sizeof(SlabRecord<double>);
  return S * N * N * rec / 4 + ntile * kScanTile + ntile + 1;
}

// dx, dy, dz: (S, N, N); w: C (S, N, N) channels, or null (C = 1,
// unweighted); out: C (S + 2H, N, N) buffers.  The sum runs in groups of up
// to three channels, on one sort.
template <typename T>
cudaError_t launch_paint_slab(const T* dx, const T* dy, const T* dz, const T* w, int64_t C,
                              T* out, int64_t S, int64_t N, int B, int* scratch,
                              cudaStream_t stream) {
  int lo, hi, rows, H;
  int64_t ncell, ntile;
  cudaError_t e = band(N, B, 0, &lo, &hi);
  if (e != cudaSuccess) return e;
  if ((e = slab_rows(N, S, B, &rows, &H)) != cudaSuccess) return e;
  if (!slab_layout(S, N, B, &ncell, &ntile) || C < 1 || (w == nullptr && C != 1) ||
      scratch == nullptr)
    return cudaErrorInvalidValue;
  const int n = static_cast<int>(N);
  const int64_t np = S * N * N;
  SlabRecord<T>* records = reinterpret_cast<SlabRecord<T>*>(scratch);
  int* A = reinterpret_cast<int*>(records + np);
  int* tile_sum = A + ntile * kScanTile;
  const int threads = N < kRowThreads ? (n + 31) / 32 * 32 : kRowThreads;
  const unsigned zblocks = static_cast<unsigned>((N + threads - 1) / threads);
  const dim3 particles(static_cast<unsigned>(rows * n), zblocks);
  if ((e = cudaMemsetAsync(A, 0, ntile * kScanTile * sizeof(int), stream)) != cudaSuccess)
    return e;
  slab_count_kernel<T><<<particles, threads, 0, stream>>>(dx, dy, dz, A, n, H, lo, hi);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  scan_reduce_kernel<<<static_cast<unsigned>(ntile), kScanThreads, 0, stream>>>(A, tile_sum);
  scan_tiles_kernel<<<1, kScanThreads, 0, stream>>>(tile_sum, static_cast<int>(ntile));
  scan_down_kernel<<<static_cast<unsigned>(ntile), kScanThreads, 0, stream>>>(A, tile_sum);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  slab_fill_kernel<T><<<particles, threads, 0, stream>>>(dx, dy, dz, A, records, n, H, lo, hi);
  const int W = hi - lo + 2, words = (W * W * W + 31) / 32;
  slab_sort_kernel<T><<<static_cast<unsigned>((ncell + kSortThreads - 1) / kSortThreads),
                        kSortThreads, (kSortThreads / 32) * words * sizeof(unsigned), stream>>>(
      dx, dy, dz, A, records, ncell, n, H, lo, W, words);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 cells(static_cast<unsigned>((rows + 2 * H) * n), (n + kSumThreads - 1) / kSumThreads);
  for (int64_t c0 = 0; c0 < C; c0 += 3) {
    const int64_t kc = C - c0 < 3 ? C - c0 : 3;
    auto kernel = w == nullptr ? &slab_sum_kernel<T, false, 1>
                  : kc == 1    ? &slab_sum_kernel<T, true, 1>
                  : kc == 2    ? &slab_sum_kernel<T, true, 2>
                               : &slab_sum_kernel<T, true, 3>;
    kernel<<<cells, kSumThreads, 0, stream>>>(w == nullptr ? nullptr : w + c0 * np, A, records,
                                              out + c0 * ncell, n, H, lo, hi, np, ncell);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
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
  return launch_gather<float, 1, false>(mesh, nullptr, nullptr, dx, dy, dz, out, nullptr,
                                        nullptr, N, int64_t{-1}, B, openband,
                                        static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_cic_gather_lattice_f64(const double* mesh, const double* dx, const double* dy,
                                          const double* dz, double* out, int64_t N, int B,
                                          int openband, void* stream) {
  return launch_gather<double, 1, false>(mesh, nullptr, nullptr, dx, dy, dz, out, nullptr,
                                         nullptr, N, int64_t{-1}, B, openband,
                                         static_cast<cudaStream_t>(stream));
}

// m0, m1, m2: the three (N, N, N) meshes; o0, o1, o2: their gathers.
extern "C" int fbx_cic_gather3_lattice_f32(const float* m0, const float* m1, const float* m2,
                                           const float* dx, const float* dy, const float* dz,
                                           float* o0, float* o1, float* o2, int64_t N, int B,
                                           int openband, void* stream) {
  return launch_gather<float, 3, false>(m0, m1, m2, dx, dy, dz, o0, o1, o2, N, int64_t{-1}, B,
                                        openband, static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_cic_gather3_lattice_f64(const double* m0, const double* m1, const double* m2,
                                           const double* dx, const double* dy, const double* dz,
                                           double* o0, double* o1, double* o2, int64_t N, int B,
                                           int openband, void* stream) {
  return launch_gather<double, 3, false>(m0, m1, m2, dx, dy, dz, o0, o1, o2, N, int64_t{-1}, B,
                                         openband, static_cast<cudaStream_t>(stream));
}

// Slab mode, closed band [-B, B+1], H = B + 1.  dx, dy, dz: (S, N, N); w:
// a (C, S, N, N) weight stack, or null with C = 1; out: (C, S + 2H, N, N);
// scratch: fbx_cic_paint_lattice_slab_scratch(S, N, B, dtype size) int32
// words on the device.
extern "C" int64_t fbx_cic_paint_lattice_slab_scratch(int64_t S, int64_t N, int B,
                                                       int elem_bytes) {
  return slab_scratch_words(S, N, B, elem_bytes);
}

extern "C" int fbx_cic_paint_lattice_slab_f32(const float* dx, const float* dy, const float* dz,
                                              const float* w, int64_t C, float* out, int64_t S,
                                              int64_t N, int B, void* scratch, void* stream) {
  return launch_paint_slab(dx, dy, dz, w, C, out, S, N, B, static_cast<int*>(scratch),
                           static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_cic_paint_lattice_slab_f64(const double* dx, const double* dy,
                                              const double* dz, const double* w, int64_t C,
                                              double* out, int64_t S, int64_t N, int B,
                                              void* scratch, void* stream) {
  return launch_paint_slab(dx, dy, dz, w, C, out, S, N, B, static_cast<int*>(scratch),
                           static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_cic_gather3_lattice_slab_f32(const float* m0, const float* m1,
                                                const float* m2, const float* dx,
                                                const float* dy, const float* dz, float* o0,
                                                float* o1, float* o2, int64_t S, int64_t N,
                                                int B, void* stream) {
  return launch_gather<float, 3, true>(m0, m1, m2, dx, dy, dz, o0, o1, o2, N, S, B, 0,
                                       static_cast<cudaStream_t>(stream));
}

extern "C" int fbx_cic_gather3_lattice_slab_f64(const double* m0, const double* m1,
                                                const double* m2, const double* dx,
                                                const double* dy, const double* dz, double* o0,
                                                double* o1, double* o2, int64_t S, int64_t N,
                                                int B, void* stream) {
  return launch_gather<double, 3, true>(m0, m1, m2, dx, dy, dz, o0, o1, o2, N, S, B, 0,
                                        static_cast<cudaStream_t>(stream));
}
