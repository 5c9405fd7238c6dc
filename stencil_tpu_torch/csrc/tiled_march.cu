// k temporally blocked sweeps of a linear stencil over a deep-halo 3D
// fp32 or bf16 grid, in one launch, marching d0 through one ring of planes
// per sweep. Hand-written for Hopper (sm_90a).
//
// Replaces stencil_tpu/ops/pallas_tiled.py:build_tiled_sweep (the Pallas
// TPU kernel, :704, pallas_call at :1821) in its homogeneous, source
// (has_source, :1326), two-level (two_level, body compute2 :1374-1431),
// Chebyshev (cheby_coeffs, :207, body compute_cheby :1433-1495) and dual
// (cheby_dual, :218, second output :1476-1483) modes, in fp32 and bf16,
// and in its coefficient mode (tap_mode='coeff', taps_coeff :1195-1229;
// fp32 only, as the TPU kernel, :451-455), each with its pins (:1270-1305;
// the Chebyshev modes keep every face pinned, as the TPU kernel's callers
// do) and, but the two-level mode (which the TPU kernel refuses them,
// :752-755), its tile subsets (:746-758). The window schedule of
// tiled_sweep.cu computes the same in every mode, bitwise, and stays the
// comparison. Wrapper, plan and plain PyTorch version:
// stencil_tpu_torch/ops/tiled_kernel.py, ops/tiled.py (schedule "march"),
// ops/sweep_kernel.py:sweep_reference.
//
// What it computes: exactly what tiled_sweep.cu computes in those modes
// (see its header), bitwise: `in` and `out` are padded (n0+2H, n1+2H,
// n2+2H) T arrays with H >= k*r; `out` receives k sweeps of the stencil
// applied to `in` on its interior points only, each update the taps in
// StencilSpec.weight_groups order (stencil_taps.cuh, -fmad=false) and, in
// the source mode, + the padded source at the point; in the two-level
// mode, - the level before the last at the point (below); in the Chebyshev
// modes, the recurrence (below). A point inside
// the grid gets the full update; a pinned ghost copies its constant; a live
// face (pins 0, d0 and d1 only) is updated like the interior; d2 is always
// pinned; the ghosts of `out` are never written.
//
// The two-level mode (the leapfrog of the wave equation): `in` is L_n and
// a second padded input `prev` is L_{n-1}; sweep t computes
// L_{n+t} = S(L_{n+t-1}) - L_{n+t-2}, the taps as above and then one
// subtraction (sub<T>), the window's order. Sweep k goes to `out` and sweep
// k-1 (at k = 1 the input L_n itself) to a second output `out2`, tile
// points only. The subtrahend of level 1 is `prev`, read once at the point
// through the read-only cache; that of level s >= 2 is level s-2's plane,
// at the point, in its ring; the store to `out2` is the centre tap that
// level k has just read from level k-1's ring.
//
// The Chebyshev modes (the multigrid fine level's smoothers): sweep t
// computes u_t = n_t*S(u_{t-1}) + c_t*u_{t-1} + pv_t*u_{t-2} + s_t*f with
// S the spec (nbsum3d, radius 1), each update formed as ((n*S + c*u) +
// s*f) + pv*prev in tiled_sweep.cu's order, each op rounded to T, and no
// prev term at t = 1; the coefficients come per level by value. u is the
// centre tap level t has read from level t-1's ring, f the padded raw
// source read at the point through the read-only cache (as the source
// mode reads it), and prev level t-2's plane at the point, in its ring as
// the two-level mode's subtrahend is (level 0, the input ring, serves
// level 2). The dual mode also stores level k-1's centre to `out2`, tile
// points only, as the two-level mode does: the fused smooth+residual,
// whose sweep k is the residual tuple. nbsum3d's one group of uniform
// weight is compiled in (apply_uniform), as the wave's groups are.
//
// The coefficient mode (radius 1): each update is
//   W3(p)u(p) + W1(p)u(p-e1) + W1(p+e1)u(p+e1) + W2(p)u(p-e2)
//   + W2(p+e2)u(p+e2) + W0(p)u(p-e0) + W0(p+e0)u(p+e0),
// summed left to right, of the four weight fields W (nb*harm of the lo
// face in d0, d1, d2, and the centre c0 + cs*sum of the six face means)
// that coeff_weights.cu forms once per run from the padded a(x): the hi
// face's weight at p is the lo face's at p+e_d (harm is bitwise
// symmetric), and a stored nb*harm times u is the product tiled_sweep.cu
// forms, so the two schedules agree bitwise. The weights come through the
// read-only cache at every level; only u lives in the rings.
//
// What bounds it on this card. By the roofline rule (each input read once,
// each output written once) k sweeps in one launch are bound by bytes, at
// 256^3 k=8 fp32 by ~0.044 ms (the coefficient mode, which also reads
// a(x) once, by ~0.068 ms). The window schedule (tiled_sweep.cu) loses
// to its instruction count instead: its 3D windows shrink by r per sweep in
// every dim, so an (8,16,16) tile at k=8 updates ~4.5 points per useful
// update, two fp32 windows of 24x32x32 leave one block of 512 threads per
// SM, and the load of a window does not overlap its sweeps. This kernel
// keeps the instruction and shared-memory traffic per useful update down:
//
//   - Blocks. Each block owns one (d1, d2) tile of t1 x t2 points and one
//     chunk of t0 planes of d0 (the plan's tiles; the last tile of a
//     ragged dim and the last chunk start early, clamped at n - t, as in
//     tiled_sweep.cu), and walks the padded planes of d0 from chunk start
//     - k*r to chunk end + k*r.
//   - Rings. Sweep level s (0 = the input, 1 .. k-1 the intermediate
//     sweeps) keeps a ring of S = 2r+2 planes in shared memory (2r+3 in
//     the two-level and Chebyshev modes, below), each as
//     wide as the level's region, (t1 + 2(k-s)r) x (t2 + 2(k-s)r). Level
//     s computes a plane of its region once the 2r+1 planes of level s-1
//     that it reads are complete; level k stores straight to `out`. The
//     regions shrink in d1 and d2 only: a chunk of t0 planes recomputes
//     2(k-s)r planes per level, not a shrinking window's overlap in all
//     three dims (32x32 tiles at k=8: ~1.5 points per useful update in d1
//     and d2, ~1.1 more from a 64-plane chunk).
//   - Order. Level s runs L_s = s(r+1) - 1 steps behind the input (the
//     input plane m arrives in step m-1), one plane more than its radius
//     needs, so a step reads only planes completed in earlier steps: one
//     __syncthreads per step for all levels together, each ring 2r+2
//     planes. (The other order, 2r+1 planes and one barrier per level, is
//     not built: it would cost k barriers per step.) Plane m of level s
//     lives in slot (m + L_{s+1}) mod S, so at step j every level reads
//     slots j-r .. j+r and writes slot j+r+1 (mod S): one table of slot
//     offsets per step serves every level. The slots of one index hold
//     every level's plane, one after the other.
//   - The subtrahend. Level s reads level s-2's plane m, which lives in
//     slot (m + L_{s-1}) mod S = j-r-1 at step j. With 2r+2 slots that is
//     j+r+1, the slot every level writes in the same step, with no
//     barrier between: a race. The two-level mode keeps 2r+3 slots
//     instead, so a step reads slots j-r .. j+r and j+r+2 and writes
//     j+r+1, and one table of slots still serves every level; any depth
//     above 2(r+1) would do, 2r+3 is the least. It costs (2r+3)/(2r+2)
//     of the rings' bytes, so the chooser (ops/tiled.py) takes narrower
//     tiles there: at 256^3 k=8 fp32 (32,32) no longer fits. The
//     Chebyshev modes read level s-2's plane the same way (their pv*prev
//     term) and keep the same 2r+3 slots.
//   - Loads. The input planes come in one plane ahead of their use: in
//     fp32 with cp.async (4-byte copies, any alignment), committed each
//     step and waited for just before the step's barrier, so the copy of
//     plane j+1 overlaps the compute of step j; cp.async copies no fewer
//     than 4 bytes, so in bf16 each thread loads its share of the plane
//     into registers at the step's start and stores it to shared memory
//     at its end. TMA may replace both later.
//   - Work. Every level's plane is flattened over the block's 512 threads
//     (carried row/column, no division per point), so narrow planes keep
//     every lane busy. Taps read shared memory at an offset that is the
//     step's slot delta plus d1 times the level's row width, formed once
//     per level and step. The homogeneous fp32 launch of jacobi7's taps at
//     k <= 8 runs a second kernel of this file instead,
//     tiled_march_kernel_tables (below): the same schedule with each
//     thread's points, addresses and interior bits formed once per launch.
//   - Coefficients. The window schedule's coefficient mode formed six face
//     means from a(x) at every update of every sweep (7 loads, 6 divides
//     and ~44 more operations) on top of its 3D windows' recomputation.
//     Here the weights are formed once per run (coeff_weights.cu), and an
//     update costs 7 weight loads from L2 or HBM and 13 operations: W is 16
//     bytes per padded point, and the k levels re-read a plane's weights
//     within k(r+1) steps of each other.
//
// Shared memory: S * sum_{s=0}^{k-1} (t1 + 2(k-s)r)(t2 + 2(k-s)r) * sizeof(T)
// with S = 2r+2 (2r+3 in the two-level and Chebyshev modes) <= 232,448
// bytes (the plan chooser, ops/tiled.py:march_smem_bytes, keeps within it;
// jacobi7 fp32 k=8 with 32x32 tiles: 217,856 bytes; the wave spec's
// two-level mode at k=8 with 32x24 tiles: 219,840 bytes; the dual mode at
// k=3 and k=5 with 32x32 fp32 tiles: 77,920 and 145,200 bytes).
//
// Tile subsets: as in tiled_sweep.cu, a launch may sweep only a list of
// (d0 chunk, d1 tile) columns, each with every d2 tile, id i0 * nt1 + i1,
// passed as a device int32 array `cols`; the points outside the list keep
// what `out` held.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "stencil_taps.cuh"

namespace {

using stencil::add;
using stencil::apply_fixed;
using stencil::apply_grouped;
using stencil::apply_uniform;
using stencil::close_group;
using stencil::mul;
using stencil::Num;
using stencil::sub;
using stencil::Taps;

constexpr int kThreads = 512;
constexpr int kGeomLen = 19;
constexpr int kMaxLevels = 16;  // sweeps per launch (Chebyshev tuples)
constexpr int kStage = 16;      // bf16: input plane <= kStage * kThreads
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB per block on sm_90
// the wave spec's groups (models/wave.py): the centre, then the six
// neighbours
constexpr uint32_t kWaveStarts = 0x3;
// how a fixed tap count's groups are evaluated: the table's group test per
// tap (apply_fixed), the wave's groups compiled in (apply_grouped), or one
// group with a uniform weight (apply_uniform: the Chebyshev modes' nbsum3d)
enum Groups { kTableGroups = 0, kWaveGroups = 1, kUniformGroups = 2 };
constexpr int kErrArgument = -1;
constexpr int kErrShared = -2;
constexpr int kErrPlane = -3;

struct Geometry {
  int n0, n1, n2;  // interior extents
  int p1, p2;      // padded extents of d1 and d2 (row strides)
  int halo;        // pad depth H
  int t0, t1, t2;  // d0 chunk, d1 and d2 tile
  int nt1, nt2;    // tiles along d1 and d2
  int k, r;        // sweeps per launch, stencil radius
  int slots;       // ring depth S: 2r+2; 2r+3 in the modes that read
                   // level s-2 (two-level, Chebyshev, dual)
  int planes;      // input planes a block walks, t0 + 2kr
  int q;           // elements of one slot index, every level's plane
  int pins[4];     // d0 lo, d0 hi, d1 lo, d1 hi: 1 pinned, 0 live
  // per level s = 0..k: the plane's rows (d1) and columns (d2), 1/columns
  // (fp32, for the thread's start), and the (rows, columns) step of
  // kThreads points in the flattened plane; for s < k, the ring's offset
  // in a slot
  int rows[kMaxLevels + 1], cols[kMaxLevels + 1];
  float inv_cols[kMaxLevels + 1];
  int srow[kMaxLevels + 1], scol[kMaxLevels + 1];
  int ring[kMaxLevels];
};

// The d0 and d2 offsets of each tap (the d1 offset rides in Taps::off).
struct TapPlanes {
  signed char d0[stencil::kMaxTaps], d2[stencil::kMaxTaps];
};

// The Chebyshev modes' (c, n, pv, s) per level, as the host rounded them
// to T (held in fp32); level s (1-based) uses entry s-1. Zero elsewhere.
struct Coeffs {
  float c[kMaxLevels], n[kMaxLevels], pv[kMaxLevels], s[kMaxLevels];
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(saddr),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Offset, in elements, from slot c to the slot of d0 offset d (mod S).
__device__ __forceinline__ int slot_delta(int c, int d, int S, int Q) {
  int x = c + d;
  x += x < 0 ? S : 0;
  x -= x >= S ? S : 0;
  return (x - c) * Q;
}

// Any tap count: apply_taps' order (stencil_taps.cuh), each offset formed
// from the tap's (d0, d1, d2) at the point.
template <typename T>
__device__ __forceinline__ float taps_any(const T* __restrict__ s, int p,
                                          const Taps& taps,
                                          const TapPlanes& tp, int c, int S,
                                          int Q, int wp) {
  float acc = 0.0f;
  int t = 0;
  for (int g = 0; g < taps.ngroups; ++g) {
    const int end = taps.group_end[g];
    float gacc = Num<T>::load(
        s[p + slot_delta(c, tp.d0[t], S, Q) + taps.off[t] * wp + tp.d2[t]]);
    for (++t; t < end; ++t)
      gacc = add<T>(gacc, Num<T>::load(s[p + slot_delta(c, tp.d0[t], S, Q) +
                                         taps.off[t] * wp + tp.d2[t]]));
    acc = close_group<T>(acc, gacc, g, taps);
  }
  return taps.uniform ? mul<T>(acc, taps.uniform_weight) : acc;
}

// The taps at point p of level s-1's ring `src`: NT > 0 with this level's
// and step's offsets `off`, the groups as GROUPS says; NT == 0 through the
// table.
template <int NT, int GROUPS, typename T>
__device__ __forceinline__ float tap_sum(const T* __restrict__ src, int p,
                                         const int (&off)[NT > 0 ? NT : 1],
                                         const Taps& taps,
                                         const TapPlanes& tp, int c, int S,
                                         int Q, int wp) {
  if constexpr (NT > 0 && GROUPS == kWaveGroups) {
    return apply_grouped<NT, kWaveStarts, T>(src, p, off, taps);
  } else if constexpr (NT > 0 && GROUPS == kUniformGroups) {
    return apply_uniform<NT, T>(src, p, off, taps);
  } else if constexpr (NT > 0) {
    return apply_fixed<NT, T>(src, p, off, taps);
  } else {
    return taps_any<T>(src, p, taps, tp, c, S, Q, wp);
  }
}

// The coefficient mode's update at point p of level s-1's centre plane `u`
// in the ring (row width wp; its d0 neighbours at offsets dm and dp), the
// weights read at padded index q of `w` (four fields of `field` points,
// d0 stride pstride, d1 stride p2): tiled_sweep.cu's order
// (coeff_update), each step rounded.
__device__ __forceinline__ float coeff_update(
    const float* __restrict__ u, int p, int wp, int dm, int dp,
    const float* __restrict__ w, int64_t q, int64_t field, int64_t pstride,
    int p2) {
  const float* const w1 = w + field;
  const float* const w2 = w1 + field;
  float acc = __fmul_rn(__ldg(w2 + field + q), u[p]);
  acc = __fadd_rn(acc, __fmul_rn(__ldg(w1 + q), u[p - wp]));
  acc = __fadd_rn(acc, __fmul_rn(__ldg(w1 + q + p2), u[p + wp]));
  acc = __fadd_rn(acc, __fmul_rn(__ldg(w2 + q), u[p - 1]));
  acc = __fadd_rn(acc, __fmul_rn(__ldg(w2 + q + 1), u[p + 1]));
  acc = __fadd_rn(acc, __fmul_rn(__ldg(w + q), u[p + dm]));
  return __fadd_rn(acc, __fmul_rn(__ldg(w + q + pstride), u[p + dp]));
}

// The Chebyshev modes' update from the taps `sum`, level s-1's centre `u`
// and f: tiled_sweep.cu's order, (n*S + c*u) + s*f, each op rounded to T
// (the caller adds pv*prev from level 2 on).
template <typename T>
__device__ __forceinline__ float cheby_update(float sum, float u, float f,
                                              float cn, float cc, float cs) {
  return add<T>(add<T>(mul<T>(cn, sum), mul<T>(cc, u)), mul<T>(cs, f));
}

// What a launch computes (see the header).
enum Mode {
  kPlain = 0, kSource = 1, kCoeff = 2, kTwoLevel = 3, kCheby = 4, kDual = 5
};

// NT > 0: a spec of exactly NT taps, offsets in registers; NT == 0: any
// spec (kCoeff: the taps unused). MODE: kPlain, kSource (add the padded
// source after the taps), kCoeff (`source` holds the weight fields W),
// kTwoLevel (`source` holds L_{n-1}; `out2` receives sweep k-1; its NT = 7
// instance is the wave spec, whose groups it compiles in), kCheby
// (`source` holds the raw f; the recurrence of `co`; its NT = 6 instance
// is nbsum3d, one group of uniform weight, compiled in) or kDual (kCheby,
// and `out2` receives sweep k-1). T: float or bf16 (kCoeff: float only).
template <int NT, int MODE, typename T>
__global__ void __launch_bounds__(kThreads, 1)
tiled_march_kernel(const T* __restrict__ in, T* __restrict__ out,
                   T* __restrict__ out2, const T* __restrict__ source,
                   const int32_t* __restrict__ cols,
                   const __grid_constant__ Geometry g,
                   const __grid_constant__ Taps taps,
                   const __grid_constant__ TapPlanes tp,
                   const __grid_constant__ Coeffs co) {
  using N = Num<T>;
  constexpr bool kCheb = MODE == kCheby || MODE == kDual;
  // the modes that read level s-2's plane (2r+3 slots)
  constexpr bool kOlder = MODE == kTwoLevel || kCheb;
  constexpr int kGroups = MODE == kTwoLevel && NT == 7 ? kWaveGroups
                          : kCheb && NT == 6           ? kUniformGroups
                                                       : kTableGroups;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* const ring = reinterpret_cast<T*>(smem_bytes);
  const int tid = threadIdx.x;

  // this block's column (i0, i1) and d2 tile, as tiled_sweep.cu
  const int i2 = blockIdx.x % g.nt2;
  int col = blockIdx.x / g.nt2;
  if (cols != nullptr) col = cols[col];
  const int i1 = col % g.nt1;
  const int i0 = col / g.nt1;
  const int kr = g.k * g.r;
  // padded origin of the input region: clamped start - k*r + H
  const int a0 = min(i0 * g.t0, g.n0 - g.t0) + g.halo - kr;
  const int o1 = min(i1 * g.t1, g.n1 - g.t1) + g.halo - kr;
  const int o2 = min(i2 * g.t2, g.n2 - g.t2) + g.halo - kr;
  const int64_t pstride = (int64_t)g.p1 * g.p2;
  // kCoeff: the points of one weight field, the padded grid
  const int64_t field = (int64_t)(g.n0 + 2 * g.halo) * pstride;
  const int S = g.slots, Q = g.q, r = g.r;

  // the input plane: this thread's first point (ly, lx) of the flattened
  // rows[0] x cols[0] region
  const int w0 = g.cols[0], a0n = g.rows[0] * w0;
  const int ly = tid / w0, lx = tid % w0;
  const T* const in0 = in + (int64_t)a0 * pstride + (int64_t)o1 * g.p2 + o2;
  T stage[sizeof(T) == 4 ? 1 : kStage];  // bf16: the next plane's share

  // fetch input plane m (into slot w): fp32 by cp.async, bf16 into stage
  auto fetch = [&](int m, int w) {
    const T* src = in0 + (int64_t)m * pstride;
    int y = ly, x = lx;
    if constexpr (sizeof(T) == 4) {
      T* dst = ring + w * Q;
      for (int i = tid; i < a0n; i += kThreads) {
        cp_async4(dst + i, src + y * g.p2 + x);
        x += g.scol[0];
        y += g.srow[0];
        if (x >= w0) { x -= w0; ++y; }
      }
      cp_async_commit();
    } else {
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        if (tid + u * kThreads < a0n) stage[u] = __ldg(src + y * g.p2 + x);
        x += g.scol[0];
        y += g.srow[0];
        if (x >= w0) { x -= w0; ++y; }
      }
    }
  };
  // bf16: store the fetched share into slot w
  auto place = [&](int w) {
    if constexpr (sizeof(T) != 4) {
      T* dst = ring + w * Q;
#pragma unroll
      for (int u = 0; u < kStage; ++u)
        if (tid + u * kThreads < a0n) dst[tid + u * kThreads] = stage[u];
    }
  };

  // the planes a sweep updates, padded: the grid's interior, widened to
  // the region's edge at a live face
  const int lo0 = g.pins[0] ? g.halo : INT_MIN;
  const int hi0 = g.pins[1] ? g.halo + g.n0 : INT_MAX;

  // prologue: input plane 0 into its slot, r (step -1 writes slot r)
  fetch(0, r);
  place(r);
  if constexpr (sizeof(T) == 4) cp_async_wait_all();
  __syncthreads();

  const int last = g.t0 + kr - 1 + g.k * (r + 1) - 1;  // level k's last step
  int c = 0;  // j mod S: the slot of each level's centre plane
  for (int j = 0; j <= last; ++j) {
    const int w = c + r + 1 >= S ? c + r + 1 - S : c + r + 1;
    if (j + 1 < g.planes) fetch(j + 1, w);
    // this step's slot offset of each tap, + its d2 offset
    int sdd[NT > 0 ? NT : 1];
    if constexpr (NT > 0) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
        sdd[t] = slot_delta(c, tp.d0[t], S, Q) + tp.d2[t];
    }
    // kCoeff: the slot offsets of the d0 neighbours (r = 1)
    const int dm = slot_delta(c, -1, S, Q), dp = slot_delta(c, 1, S, Q);
    // kTwoLevel, kCheby, kDual: the slot of level s-2's planes, j-r-1
    // (S = 2r+3)
    const int sb = slot_delta(c, -(r + 1), S, Q);
    for (int s = 1; s <= g.k; ++s) {
      const int m = j - (s * (r + 1) - 1);  // level s's plane this step
      if (m < s * r || m >= g.planes - s * r) continue;
      const int wp = g.cols[s - 1], ws = g.cols[s];
      const int n = g.rows[s] * ws;
      // level s-1's centre plane, shifted to level s's origin
      const T* const src = ring + c * Q + g.ring[s - 1] + r * wp + r;
      int off[NT > 0 ? NT : 1];
      if constexpr (NT > 0) {
#pragma unroll
        for (int t = 0; t < NT; ++t) off[t] = sdd[t] + taps.off[t] * wp;
      }
      // padded origin of level s's plane; the global index of its (y, x)
      const int p0 = a0 + m, r1 = o1 + s * r, r2 = o2 + s * r;
      const int64_t gbase = (int64_t)p0 * pstride + (int64_t)r1 * g.p2 + r2;
      // kOlder, s >= 2: level s-2's plane m, shifted to level s's origin
      // (row width wq); the two-level mode's level 1 reads `prev` at gbase
      // instead, the Chebyshev modes' level 1 has no such term
      const int wq = s >= 2 ? g.cols[s - 2] : 0;
      const T* const older =
          kOlder && s >= 2
              ? ring + c * Q + sb + g.ring[s - 2] + 2 * r * wq + 2 * r
              : nullptr;
      // the level before the last at (y, x): L_{t-2} of the leapfrog
      auto subtrahend = [&](int py, int px) {
        return s == 1 ? N::ldg(source + gbase + py * g.p2 + px)
                      : N::load(older[py * wq + px]);
      };
      // the Chebyshev modes: this level's coefficients, and its update at
      // (y, x) from the taps (u the centre tap, f the source at the point)
      float cc = 0.0f, cn = 0.0f, cpv = 0.0f, cs = 0.0f;
      if constexpr (kCheb) {
        cc = co.c[s - 1];
        cn = co.n[s - 1];
        cpv = co.pv[s - 1];
        cs = co.s[s - 1];
      }
      auto recur = [&](float sum, int py, int px) {
        float v = cheby_update<T>(sum, N::load(src[py * wp + px]),
                                  N::ldg(source + gbase + py * g.p2 + px),
                                  cn, cc, cs);
        if (s >= 2) v = add<T>(v, mul<T>(cpv, N::load(older[py * wq + px])));
        return v;
      };
      int y = __float2int_rz(__fmul_rn((float)tid + 0.5f, g.inv_cols[s]));
      int x = tid - y * ws;
      const int sy = g.srow[s], sx = g.scol[s];
      if (s < g.k) {
        const bool live0 = p0 >= lo0 && p0 < hi0;
        const int ylo = g.pins[2] ? g.halo - r1 : INT_MIN;
        const int yhi = g.pins[3] ? g.halo + g.n1 - r1 : INT_MAX;
        const int xlo = g.halo - r2, xhi = xlo + g.n2;
        T* const dst = ring + w * Q + g.ring[s];
        for (int i = tid; i < n; i += kThreads) {
          const int p = y * wp + x;
          float v;
          if (live0 && y >= ylo && y < yhi && x >= xlo && x < xhi) {
            if constexpr (MODE == kCoeff) {
              v = coeff_update(src, p, wp, dm, dp, source,
                               gbase + y * g.p2 + x, field, pstride, g.p2);
            } else {
              v = tap_sum<NT, kGroups, T>(src, p, off, taps, tp, c, S, Q,
                                          wp);
              if constexpr (MODE == kSource)
                v = add<T>(v, N::ldg(source + gbase + y * g.p2 + x));
              if constexpr (MODE == kTwoLevel)
                v = sub<T>(v, subtrahend(y, x));
              if constexpr (kCheb) v = recur(v, y, x);
            }
          } else {
            v = N::load(src[p]);
          }
          dst[i] = N::store(v);
          x += sx;
          y += sy;
          if (x >= ws) { x -= ws; ++y; }
        }
      } else {
        // level k: the tile, every point interior, straight to `out`
        for (int i = tid; i < n; i += kThreads) {
          const int64_t q = gbase + y * g.p2 + x;
          float v;
          if constexpr (MODE == kCoeff) {
            v = coeff_update(src, y * wp + x, wp, dm, dp, source, q, field,
                             pstride, g.p2);
          } else {
            v = tap_sum<NT, kGroups, T>(src, y * wp + x, off, taps, tp, c,
                                        S, Q, wp);
          }
          if constexpr (MODE == kSource) v = add<T>(v, N::ldg(source + q));
          if constexpr (MODE == kTwoLevel) v = sub<T>(v, subtrahend(y, x));
          if constexpr (kCheb) v = recur(v, y, x);
          if constexpr (MODE == kTwoLevel || MODE == kDual)
            out2[q] = src[y * wp + x];  // level k-1, the centre tap
          out[q] = N::store(v);
          x += sx;
          y += sy;
          if (x >= ws) { x -= ws; ++y; }
        }
      }
    }
    if (j + 1 < g.planes) {
      place(w);
      if constexpr (sizeof(T) == 4) cp_async_wait_all();
    }
    __syncthreads();
    c = c + 1 == S ? 0 : c + 1;
  }
}

// ---- The point-table march: the homogeneous fp32 mode of jacobi7 --------
//
// tiled_march_kernel's schedule, rings, slots, loads and barrier, in its
// homogeneous fp32 mode, for jacobi7's tap table (kTableTap: six radius-1
// taps in one group of uniform weight), k = 1 .. kTableMaxLevels, with
// the same shared memory. What a thread does with a level's plane never
// changes from step to step, so this kernel forms it once per launch, in
// registers (the level and pass loops unrolled over the instance's bound
// of passes per level, table_row):
//
//   - Points. Level s walks its plane in the row width of the plane it
//     reads, level s-1's (cols[s-1] = cols[s] + 2): point i = tid +
//     kThreads*u of pass u is (y, x) = (i / cols[s-1], i % cols[s-1]), and
//     the two columns x >= cols[s] are computed and dropped. So a warp's
//     32 lanes read 32 consecutive words of level s-1's plane at every
//     tap, one shared-memory wavefront each (tiled_march_kernel walks the
//     plane in its own width, and the two-word jump where a warp crosses a
//     row costs a second wavefront in most warps), and a tap's address is
//     the thread's slot address plus the step's and level's offset plus
//     kThreads*4*u: no table and no arithmetic per point.
//   - Passes. Each instance holds, per level, the passes of the largest
//     plane the tile chooser gives at its k (table_row), and computes
//     every one of them in every step, with no branch: its passes' loads
//     then overlap one another, which measured faster on an H100 than
//     skipping a pass that holds no point. A thread past a plane's end
//     clamps its loads to the plane's last point and stores nothing.
//   - Tables. Per level s < k and pass u, the shared address the point is
//     stored at, (ring[s] + y*cols[s] + x) * 4 past the rings' start; per
//     pass of level k, its byte offset y*p2 + x in a padded plane of
//     `out`; per pass of the input plane, the byte offset its fetch reads;
//     one bit per pass of levels 1 .. k (table_bases) in `keep`: the point
//     lies in the plane (x < cols[s], i below the plane's end); in `inner`:
//     level s < k updates it in d1 and d2 (the interior, or beyond a live
//     d1 face). The d0 test (live0) stays one uniform test per level and
//     step.
//   - A step's pass: six shared loads in kTableTap's order, five adds and
//     one multiply (apply_uniform: tiled_march_kernel's rounding, bitwise),
//     the centre where the point is not updated, one store where it is
//     kept.

constexpr int kTableMaxLevels = 8;
constexpr int kTableTaps = 6;
constexpr int kTableMaxPasses = 10;

// Passes of kThreads points that the instance of k sweeps holds at level s
// = 0 (the input plane) .. k: at every level the most that a tile the
// chooser gives at k (ops/tiled.py:choose_march_tiles, 64^3 to 1024^3)
// needs, one hex digit per level, level 0 the lowest:
//   k=1 9 9; k=2 10 9 9; k=3 10 10 9 9; k=4 7 6 6 6 5; k=5 7 6 6 5 5 5;
//   k=6 6 6 5 5 4 4 4; k=7 5 5 4 4 4 3 3 3; k=8 5 5 4 4 4 3 3 3 3.
// (Shifts of one constant fold once the kernel's loops are unrolled.)
__host__ __device__ constexpr unsigned long long table_row(int k) {
  return k == 1   ? 0x99ull
         : k == 2 ? 0x99Aull
         : k == 3 ? 0x99AAull
         : k == 4 ? 0x56667ull
         : k == 5 ? 0x555667ull
         : k == 6 ? 0x4445566ull
         : k == 7 ? 0x33344455ull
                  : 0x333344455ull;
}

__host__ __device__ constexpr int table_passes(int k, int s) {
  return (int)((table_row(k) >> (4 * s)) & 15u);
}

// The bit of each level s = 1 .. k's pass 0 in the instance's masks, one
// byte per level (level 1 the lowest): levels 1 .. k one after the other;
// and the bits they take in all.
__host__ __device__ constexpr unsigned long long table_bases(int k) {
  unsigned long long out = 0;
  int b = 0;
  for (int s = 1; s <= k; ++s) {
    out |= (unsigned long long)b << (8 * (s - 1));
    b += table_passes(k, s);
  }
  return out;
}

__host__ __device__ constexpr int table_bits(int k) {
  int b = 0;
  for (int s = 1; s <= k; ++s) b += table_passes(k, s);
  return b;
}

constexpr int kErrTables = -4;
// The taps compiled in: the six face neighbours (d0, d1, d2) in
// StencilSpec.weight_groups order, jacobi7's and star3d_r1's table.
constexpr int kTableTap[kTableTaps][3] = {
    {-1, 0, 0}, {1, 0, 0}, {0, -1, 0}, {0, 1, 0}, {0, 0, -1}, {0, 0, 1}};

// What the host forms once per launch for the point-table kernel: per
// pass u of the input plane's fetch the bound n_0 - kThreads*u under which
// a thread's tid lies for the pass to hold a point; per level s = 1 .. k
// and tap t the byte offset, from a thread's address in slot 0, of the tap
// of its pass-0 point in level s-1's plane, (ring[s-1] + cols[s-1] + 1 +
// d1*cols[s-1] + d2) * 4, and of the centre; per level s = 1 .. k the
// byte offset from the rings' start of its last point's slot-0 address,
// to which a thread past the end clamps its own (its loads then stay in
// the rings); a slot's bytes.
struct TablePlan {
  int lim[kTableMaxPasses];
  int off[kTableMaxLevels + 1][kTableTaps];
  int ctr[kTableMaxLevels + 1];
  int end[kTableMaxLevels + 1];
  int q4;
};

// Shared and global accesses at 32-bit shared and 64-bit global byte
// addresses, so the step loop forms no generic addresses.
__device__ __forceinline__ float lds(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts(unsigned addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void stg(uint64_t addr, float v) {
  asm volatile("st.global.f32 [%0], %1;" ::"l"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void cp_async4_at(unsigned dst, uint64_t src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
tiled_march_kernel_tables(const float* __restrict__ in,
                          float* __restrict__ out,
                          const int32_t* __restrict__ cols,
                          const __grid_constant__ Geometry g,
                          const __grid_constant__ TablePlan tb,
                          float weight) {
  constexpr int P = kTableMaxPasses;  // an array bound
  constexpr unsigned long long kRow = table_row(K);
  constexpr unsigned long long kBases = table_bases(K);
  static_assert(K >= 1 && K <= kTableMaxLevels && table_bits(K) <= 64,
                "one bit per point of levels 1 .. K in two words");
  // level s's passes, the mask bit of its pass u, and a bit of a mask:
  // constants once the loops are unrolled
  auto passes = [](int s) { return (int)((kRow >> (4 * s)) & 15u); };
  auto bit = [](int s, int u) {
    return (int)((kBases >> (8 * (s - 1))) & 255u) + u;
  };
  auto has = [](const uint32_t (&mask)[2], int b) {
    return ((mask[b >> 5] >> (b & 31)) & 1u) != 0;
  };
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const unsigned ring = (unsigned)__cvta_generic_to_shared(smem_bytes);
  const int tid = threadIdx.x;
  constexpr int S = 4;  // 2r+2 slots, r = 1
  constexpr int kPassBytes = kThreads * 4;

  // this block's column (i0, i1) and d2 tile, as tiled_march_kernel
  const int i2 = blockIdx.x % g.nt2;
  int col = blockIdx.x / g.nt2;
  if (cols != nullptr) col = cols[col];
  const int i1 = col % g.nt1;
  const int i0 = col / g.nt1;
  const int a0 = min(i0 * g.t0, g.n0 - g.t0) + g.halo - K;
  const int o1 = min(i1 * g.t1, g.n1 - g.t1) + g.halo - K;
  const int o2 = min(i2 * g.t2, g.n2 - g.t2) + g.halo - K;
  const int64_t pstride = (int64_t)g.p1 * g.p2;

  // the tables (see above); an entry past its plane's end holds the
  // plane's last point, which a dropped store leaves alone
  int load[P], put[P];
  unsigned home[K > 1 ? K - 1 : 1][P];
  uint32_t keep[2] = {0u, 0u}, inner[2] = {0u, 0u};
#pragma unroll
  for (int u = 0; u < passes(0); ++u) {
    const int i = min(tid + u * kThreads, g.rows[0] * g.cols[0] - 1);
    const int y = i / g.cols[0], x = i - y * g.cols[0];
    load[u] = (y * g.p2 + x) * 4;
  }
#pragma unroll
  for (int s = 1; s <= K; ++s) {
    const int ws = g.cols[s], wp = g.cols[s - 1];
    const int n = g.rows[s] * wp - 2;
    const int r1 = o1 + s, r2 = o2 + s;
    const int ylo = g.pins[2] ? g.halo - r1 : INT_MIN;
    const int yhi = g.pins[3] ? g.halo + g.n1 - r1 : INT_MAX;
    const int xlo = g.halo - r2, xhi = xlo + g.n2;
#pragma unroll
    for (int u = 0; u < P; ++u) {
      if (u >= passes(s)) continue;
      const int i = min(tid + u * kThreads, n - 1);
      const int y = i / wp, x = i - y * wp;
      const int b = bit(s, u);
      if (tid + u * kThreads < n && x < ws) keep[b >> 5] |= 1u << (b & 31);
      if (s < K) {
        home[s - 1][u] = ring + (g.ring[s] + y * ws + x) * 4;
        if (y >= ylo && y < yhi && x >= xlo && x < xhi)
          inner[b >> 5] |= 1u << (b & 31);
      } else {
        put[u] = (y * g.p2 + x) * 4;
      }
    }
  }

  // byte addresses: the input region's origin, the tile's origin in
  // `out`, a padded plane's stride; this thread's element of slot 0
  const uint64_t gin = reinterpret_cast<uint64_t>(
      in + (int64_t)a0 * pstride + (int64_t)o1 * g.p2 + o2);
  const uint64_t gout = reinterpret_cast<uint64_t>(
      out + (int64_t)a0 * pstride + (int64_t)(o1 + K) * g.p2 + o2 + K);
  const uint64_t pbytes = (uint64_t)pstride * 4;
  const unsigned mine = ring + tid * 4;

  // fetch input plane m into slot w by cp.async
  auto fetch = [&](int m, int w) {
    const uint64_t src = gin + (uint64_t)m * pbytes;
    const unsigned dst = mine + w * tb.q4;
#pragma unroll
    for (int u = 0; u < passes(0); ++u)
      if (tid < tb.lim[u])
        cp_async4_at(dst + u * kPassBytes, src + (uint64_t)load[u]);
    cp_async_commit();
  };

  const int lo0 = g.pins[0] ? g.halo : INT_MIN;
  const int hi0 = g.pins[1] ? g.halo + g.n0 : INT_MAX;

  // prologue: input plane 0 into its slot, r = 1
  fetch(0, 1);
  cp_async_wait_all();
  __syncthreads();

  const int last = g.t0 + K - 1 + 2 * K - 1;  // level K's last step
  int c = 0;  // j mod S: the slot of each level's centre plane
  for (int j = 0; j <= last; ++j) {
    const int w = (c + 2) & (S - 1);
    if (j + 1 < g.planes) fetch(j + 1, w);
    // this step's slots of the planes d0 - 1, d0 and d0 + 1, in bytes
    const int below = ((c + S - 1) & (S - 1)) * tb.q4;
    const int centre = c * tb.q4;
    const int above = ((c + 1) & (S - 1)) * tb.q4;
#pragma unroll
    for (int s = 1; s <= K; ++s) {
      const int m = j - (2 * s - 1);  // level s's plane this step
      if (m < s || m >= g.planes - s) continue;
      // each tap's offset from this thread's slot-0 address (kTableTap)
      const int o[kTableTaps] = {
          below + tb.off[s][0], above + tb.off[s][1], centre + tb.off[s][2],
          centre + tb.off[s][3], centre + tb.off[s][4],
          centre + tb.off[s][5]};
      // the taps of every pass first (apply_uniform's order), then the
      // stores: a level's loads never read the slot this step writes
      const unsigned end = ring + tb.end[s];
      float v[P];
#pragma unroll
      for (int u = 0; u < P; ++u) {
        if (u >= passes(s)) continue;
        const unsigned p = min(mine + u * kPassBytes, end);
        float acc = lds(p + o[0]);
#pragma unroll
        for (int t = 1; t < kTableTaps; ++t)
          acc = __fadd_rn(acc, lds(p + o[t]));
        v[u] = __fmul_rn(acc, weight);
      }
      if (s < K) {
        // a plane outside a pinned d0 face copies every centre
        const int p0 = a0 + m;
        const bool live0 = p0 >= lo0 && p0 < hi0;
        const uint32_t due[2] = {live0 ? inner[0] : 0u,
                                 live0 ? inner[1] : 0u};
        const int put_slot = w * tb.q4;
        const int ctr = centre + tb.ctr[s];
#pragma unroll
        for (int u = 0; u < P; ++u) {
          if (u >= passes(s)) continue;
          const int b = bit(s, u);
          if (!has(due, b))
            v[u] = lds(min(mine + u * kPassBytes, end) + ctr);
          if (has(keep, b)) sts(home[s - 1][u] + put_slot, v[u]);
        }
      } else {
        // level K: the tile, every point interior, straight to `out`
        const uint64_t dst = gout + (uint64_t)m * pbytes;
#pragma unroll
        for (int u = 0; u < P; ++u) {
          if (u >= passes(K)) continue;
          const int b = bit(K, u);
          if (has(keep, b)) stg(dst + (uint64_t)put[u], v[u]);
        }
      }
    }
    if (j + 1 < g.planes) cp_async_wait_all();
    __syncthreads();
    c = (c + 1) & (S - 1);
  }
}

template <typename T>
struct Launch {
  const T* in;
  T* out;
  T* out2;  // kTwoLevel, kDual: sweep k-1; else null
  const T* source;
  const int32_t* cols;  // the subset's column ids (device), or null
  Geometry g;
  Coeffs co;  // kCheby, kDual
  unsigned nblocks;
  size_t shared;
  cudaStream_t stream;
};

template <int NT, int MODE, typename T>
cudaError_t launch(const Launch<T>& l, const Taps& taps,
                   const TapPlanes& tp) {
  cudaError_t err = cudaFuncSetAttribute(
      tiled_march_kernel<NT, MODE, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.shared);
  if (err != cudaSuccess) return err;
  tiled_march_kernel<NT, MODE, T><<<l.nblocks, kThreads, l.shared,
                                    l.stream>>>(l.in, l.out, l.out2,
                                                l.source, l.cols, l.g, taps,
                                                tp, l.co);
  return cudaGetLastError();
}

template <int MODE, typename T>
cudaError_t dispatch(int ntaps, const Launch<T>& l, const Taps& taps,
                     const TapPlanes& tp) {
  switch (ntaps) {
    case 6:   // jacobi7, star3d_r1 (Poisson)
      return launch<6, MODE>(l, taps, tp);
    case 7:   // the multigrid fine level's weighted-Jacobi smoother and
              // residual (wjacobi3d, neg_laplace3d: a centre and six)
      return launch<7, MODE>(l, taps, tp);
    case 12:  // star3d_r2, laplace3d_ho
      return launch<12, MODE>(l, taps, tp);
    case 26:  // jacobi27
      return launch<26, MODE>(l, taps, tp);
    default:
      return launch<0, MODE>(l, taps, tp);
  }
}

// The two-level mode: the wave spec (7 taps, the centre then the six
// neighbours, no uniform weight) unrolled with its groups compiled in, any
// other spec through the table.
template <typename T>
cudaError_t dispatch_two_level(int ntaps, const Launch<T>& l,
                               const Taps& taps, const TapPlanes& tp) {
  const bool wave =
      ntaps == 7 && !taps.uniform && taps.group_starts == kWaveStarts;
  return wave ? launch<7, kTwoLevel>(l, taps, tp)
              : launch<0, kTwoLevel>(l, taps, tp);
}

// The Chebyshev modes: nbsum3d (6 taps, one group of uniform weight)
// unrolled with its group compiled in, any other spec through the table.
template <int MODE, typename T>
cudaError_t dispatch_cheby(int ntaps, const Launch<T>& l, const Taps& taps,
                           const TapPlanes& tp) {
  const bool nbsum = ntaps == 6 && taps.uniform && taps.ngroups == 1;
  return nbsum ? launch<6, MODE>(l, taps, tp) : launch<0, MODE>(l, taps, tp);
}

// Checks the geometry, the subset's length and the tap table and fills `l`
// (but its tensor pointers, coefficients and stream), `taps` and `tp`, the
// rings 2r+2 planes deep, 2r+3 (`deep`) for the modes that read level s-2;
// 0 or a negative error code.
template <typename T>
int prepare(const int32_t* geom, int ngeom, const int32_t* cols, int ncols,
            const int32_t* tap_offsets, const int32_t* group_sizes,
            const float* group_weights, int ntaps, int ngroups, int uniform,
            float uniform_weight, Launch<T>& l, Taps& taps, TapPlanes& tp,
            bool deep = false) {
  if (ngeom != kGeomLen) return kErrArgument;
  const int n0 = geom[0], n1 = geom[1], n2 = geom[2];
  const int p0 = geom[3], p1 = geom[4], p2 = geom[5], halo = geom[6];
  const int t0 = geom[7], t1 = geom[8], t2 = geom[9];
  const int nt0 = geom[10], nt1 = geom[11], nt2 = geom[12];
  const int k = geom[13], r = geom[14];
  if (k < 1 || k > kMaxLevels || r < 1 || r > 32 ||
      (int64_t)k * r > halo)
    return kErrArgument;
  Geometry& g = l.g;
  for (int i = 0; i < 4; ++i) {
    if (geom[15 + i] != 0 && geom[15 + i] != 1) return kErrArgument;
    g.pins[i] = geom[15 + i];
  }
  if (p0 != n0 + 2 * halo || p1 != n1 + 2 * halo || p2 != n2 + 2 * halo)
    return kErrArgument;
  if (t0 < 1 || t0 > n0 || t1 < 1 || t1 > n1 || t2 < 1 || t2 > n2)
    return kErrArgument;
  if (nt0 != (n0 + t0 - 1) / t0 || nt1 != (n1 + t1 - 1) / t1 ||
      nt2 != (n2 + t2 - 1) / t2)
    return kErrArgument;
  if ((cols == nullptr) != (ncols == 0) || ncols < 0 ||
      (int64_t)ncols > (int64_t)nt0 * nt1)
    return kErrArgument;
  const int64_t nblocks = (int64_t)(cols ? ncols : nt0 * nt1) * nt2;
  if (nblocks > 0x7fffffff) return kErrArgument;
  l.cols = cols;

  g.n0 = n0; g.n1 = n1; g.n2 = n2;
  g.p1 = p1; g.p2 = p2; g.halo = halo;
  g.t0 = t0; g.t1 = t1; g.t2 = t2;
  g.nt1 = nt1; g.nt2 = nt2;
  g.k = k; g.r = r;
  g.slots = 2 * r + 2 + (deep ? 1 : 0);
  l.co = Coeffs{};
  g.planes = t0 + 2 * k * r;
  int64_t q = 0;
  for (int s = 0; s <= k; ++s) {
    const int rows = t1 + 2 * (k - s) * r, cols_s = t2 + 2 * (k - s) * r;
    g.rows[s] = rows;
    g.cols[s] = cols_s;
    g.inv_cols[s] = 1.0f / (float)cols_s;
    g.srow[s] = kThreads / cols_s;
    g.scol[s] = kThreads % cols_s;
    if (s < k) {
      g.ring[s] = (int)q;
      q += (int64_t)rows * cols_s;
    }
  }
  l.shared = (size_t)g.slots * q * sizeof(T);
  if (l.shared > kMaxSharedBytes) return kErrShared;
  g.q = (int)q;
  if (sizeof(T) != 4 && g.rows[0] * g.cols[0] > kStage * kThreads)
    return kErrPlane;
  l.nblocks = (unsigned)nblocks;

  if (!stencil::fill_groups(taps, group_sizes, group_weights, ntaps,
                            ngroups, uniform, uniform_weight))
    return kErrArgument;
  for (int i = 0; i < ntaps; ++i) {
    const int d0 = tap_offsets[3 * i], d1 = tap_offsets[3 * i + 1],
              d2 = tap_offsets[3 * i + 2];
    if (d0 < -r || d0 > r || d1 < -r || d1 > r || d2 < -r || d2 > r)
      return kErrArgument;
    tp.d0[i] = (signed char)d0;
    taps.off[i] = d1;
    tp.d2[i] = (signed char)d2;
  }
  return 0;
}

template <typename T>
int march_entry(const T* in, T* out, const T* source, const int32_t* geom,
                int ngeom, const int32_t* cols, int ncols,
                const int32_t* tap_offsets, const int32_t* group_sizes,
                const float* group_weights, int ntaps, int ngroups,
                int uniform, float uniform_weight, int device, void* stream) {
  Launch<T> l;
  Taps taps;
  TapPlanes tp;
  const int rc = prepare(geom, ngeom, cols, ncols, tap_offsets, group_sizes,
                         group_weights, ntaps, ngroups, uniform,
                         uniform_weight, l, taps, tp);
  if (rc != 0) return rc;
  l.in = in; l.out = out; l.out2 = nullptr; l.source = source;
  l.stream = (cudaStream_t)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return source ? (int)dispatch<kSource>(ntaps, l, taps, tp)
                : (int)dispatch<kPlain>(ntaps, l, taps, tp);
}

int coeff_entry(const float* in, const float* weights, float* out,
                const int32_t* geom, int ngeom, const int32_t* cols,
                int ncols, const int32_t* tap_offsets,
                const int32_t* group_sizes, const float* group_weights,
                int ntaps, int ngroups, int uniform, float uniform_weight,
                int device, void* stream) {
  Launch<float> l;
  Taps taps;
  TapPlanes tp;
  const int rc = prepare(geom, ngeom, cols, ncols, tap_offsets, group_sizes,
                         group_weights, ntaps, ngroups, uniform,
                         uniform_weight, l, taps, tp);
  if (rc != 0) return rc;
  if (weights == nullptr || l.g.r != 1) return kErrArgument;
  l.in = in; l.out = out; l.out2 = nullptr; l.source = weights;
  l.stream = (cudaStream_t)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<0, kCoeff>(l, taps, tp);
}

template <typename T>
int two_level_entry(const T* in, const T* prev, T* out, T* out2,
                    const int32_t* geom, int ngeom,
                    const int32_t* tap_offsets, const int32_t* group_sizes,
                    const float* group_weights, int ntaps, int ngroups,
                    int uniform, float uniform_weight, int device,
                    void* stream) {
  Launch<T> l;
  Taps taps;
  TapPlanes tp;
  // no subset: the TPU kernel refuses one in the two-level mode
  const int rc = prepare(geom, ngeom, nullptr, 0, tap_offsets, group_sizes,
                         group_weights, ntaps, ngroups, uniform,
                         uniform_weight, l, taps, tp, true);
  if (rc != 0) return rc;
  if (prev == nullptr || out2 == nullptr) return kErrArgument;
  l.in = in; l.out = out; l.out2 = out2; l.source = prev;
  l.stream = (cudaStream_t)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)dispatch_two_level(ntaps, l, taps, tp);
}

template <typename T>
int cheby_entry(const T* in, T* out, T* out2, const T* source,
                const int32_t* geom, int ngeom, const float* coeffs,
                int ncoeffs, const int32_t* cols, int ncols,
                const int32_t* tap_offsets, const int32_t* group_sizes,
                const float* group_weights, int ntaps, int ngroups,
                int uniform, float uniform_weight, int device, void* stream) {
  Launch<T> l;
  Taps taps;
  TapPlanes tp;
  const int rc = prepare(geom, ngeom, cols, ncols, tap_offsets, group_sizes,
                         group_weights, ntaps, ngroups, uniform,
                         uniform_weight, l, taps, tp, true);
  if (rc != 0) return rc;
  const int k = l.g.k;
  // tiled_sweep.cu's checks (cheby_entry): raw f, one tuple per sweep,
  // radius 1, the dual output from k = 2, every face pinned
  if (source == nullptr || coeffs == nullptr || l.g.r != 1 ||
      ncoeffs != 4 * k || (out2 != nullptr && k < 2))
    return kErrArgument;
  for (int i = 0; i < 4; ++i)
    if (!l.g.pins[i]) return kErrArgument;
  for (int t = 0; t < k; ++t) {
    l.co.c[t] = coeffs[4 * t];
    l.co.n[t] = coeffs[4 * t + 1];
    l.co.pv[t] = coeffs[4 * t + 2];
    l.co.s[t] = coeffs[4 * t + 3];
  }
  l.in = in; l.out = out; l.out2 = out2; l.source = source;
  l.stream = (cudaStream_t)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return out2 ? (int)dispatch_cheby<kDual>(ntaps, l, taps, tp)
              : (int)dispatch_cheby<kCheby>(ntaps, l, taps, tp);
}

template <int K>
cudaError_t launch_tables(const Launch<float>& l, const TablePlan& tb,
                          float weight) {
  cudaError_t err = cudaFuncSetAttribute(
      tiled_march_kernel_tables<K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.shared);
  if (err != cudaSuccess) return err;
  tiled_march_kernel_tables<K><<<l.nblocks, kThreads, l.shared,
                                 l.stream>>>(l.in, l.out, l.cols, l.g, tb,
                                             weight);
  return cudaGetLastError();
}

// Whether an instance of the point-table kernel runs a homogeneous launch
// of geometry `g` (prepare's) and this tap table: kTableTap's six taps in
// one group of uniform weight, k <= kTableMaxLevels, every level's points
// in the instance's passes, and every byte offset a table or a thread
// forms in an int. The one place that decides it: tables_entry refuses
// what it rejects, and stencil_tiled_march_tables_fit answers the wrapper.
bool tables_fit(const Geometry& g, const int32_t* tap_offsets, int ntaps,
                int ngroups, int uniform) {
  const int k = g.k;
  if (g.r != 1 || k > kTableMaxLevels || ntaps != kTableTaps ||
      ngroups != 1 || !uniform)
    return false;
  for (int t = 0; t < kTableTaps; ++t)
    for (int d = 0; d < 3; ++d)
      if (tap_offsets[3 * t + d] != kTableTap[t][d]) return false;
  if (g.rows[0] * g.cols[0] > table_passes(k, 0) * kThreads) return false;
  if (((int64_t)g.rows[0] * g.p2 + g.cols[0]) * 4 > INT_MAX) return false;
  for (int s = 1; s <= k; ++s) {
    if (g.rows[s] * g.cols[s - 1] - 2 > table_passes(k, s) * kThreads)
      return false;
    if (((int64_t)g.rows[s] * g.p2 + g.cols[s]) * 4 > INT_MAX) return false;
  }
  return true;
}

int tables_entry(const float* in, float* out, const float* source,
                 const int32_t* geom, int ngeom, const int32_t* cols,
                 int ncols, const int32_t* tap_offsets,
                 const int32_t* group_sizes, const float* group_weights,
                 int ntaps, int ngroups, int uniform, float uniform_weight,
                 int device, void* stream) {
  Launch<float> l;
  Taps taps;
  TapPlanes tp;
  const int rc = prepare(geom, ngeom, cols, ncols, tap_offsets, group_sizes,
                         group_weights, ntaps, ngroups, uniform,
                         uniform_weight, l, taps, tp);
  if (rc != 0) return rc;
  if (source != nullptr || !tables_fit(l.g, tap_offsets, ntaps, ngroups,
                                       uniform))
    return kErrTables;
  const Geometry& g = l.g;
  const int k = g.k;
  TablePlan tb{};
  for (int u = 0; u < kTableMaxPasses; ++u)
    tb.lim[u] = g.rows[0] * g.cols[0] - u * kThreads;
  for (int s = 1; s <= k; ++s) {
    const int wp = g.cols[s - 1];
    tb.ctr[s] = (g.ring[s - 1] + wp + 1) * 4;
    tb.end[s] = (g.rows[s] * wp - 3) * 4;
    for (int t = 0; t < kTableTaps; ++t)
      tb.off[s][t] = tb.ctr[s] + (kTableTap[t][1] * wp + kTableTap[t][2]) * 4;
  }
  tb.q4 = g.q * 4;
  l.in = in; l.out = out; l.out2 = nullptr; l.source = nullptr;
  l.stream = (cudaStream_t)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float wt = taps.uniform_weight;
  switch (k) {
    case 1: return (int)launch_tables<1>(l, tb, wt);
    case 2: return (int)launch_tables<2>(l, tb, wt);
    case 3: return (int)launch_tables<3>(l, tb, wt);
    case 4: return (int)launch_tables<4>(l, tb, wt);
    case 5: return (int)launch_tables<5>(l, tb, wt);
    case 6: return (int)launch_tables<6>(l, tb, wt);
    case 7: return (int)launch_tables<7>(l, tb, wt);
    default: return (int)launch_tables<8>(l, tb, wt);
  }
}

}  // namespace

extern "C" {

// Launch k sweeps on `stream` (a cudaStream_t, 0 = the legacy default
// stream) of device `device`, marching d0. The arguments are those of
// stencil_tiled_sweep (tiled_sweep.cu): `source` null or the padded
// pre-scaled source; `geom` int32[19] = n0 n1 n2 p0 p1 p2 halo t0 t1 t2 nt0
// nt1 nt2 k r and the pins of the d0 lo, d0 hi, d1 lo and d1 hi faces, t0
// being the d0 chunk; `cols` null or a device int32[ncols] of column ids;
// the tap table in group order (host). k <= 16. Returns 0, a CUDA error
// code (cudaGetLastError after the launch), or a negative code for a
// rejected argument (see stencil_tiled_march_error).
int stencil_tiled_march(const float* in, float* out, const float* source,
                        const int32_t* geom, int ngeom, const int32_t* cols,
                        int ncols, const int32_t* tap_offsets,
                        const int32_t* group_sizes,
                        const float* group_weights, int ntaps, int ngroups,
                        int uniform, float uniform_weight, int device,
                        void* stream) {
  return march_entry(in, out, source, geom, ngeom, cols, ncols, tap_offsets,
                     group_sizes, group_weights, ntaps, ngroups, uniform,
                     uniform_weight, device, stream);
}

// The same in bf16: `in`, `out` and `source` hold __nv_bfloat16; the
// weights stay fp32, each a bf16 value.
int stencil_tiled_march_bf16(const __nv_bfloat16* in, __nv_bfloat16* out,
                             const __nv_bfloat16* source,
                             const int32_t* geom, int ngeom,
                             const int32_t* cols, int ncols,
                             const int32_t* tap_offsets,
                             const int32_t* group_sizes,
                             const float* group_weights, int ntaps,
                             int ngroups, int uniform, float uniform_weight,
                             int device, void* stream) {
  return march_entry(in, out, source, geom, ngeom, cols, ncols, tap_offsets,
                     group_sizes, group_weights, ntaps, ngroups, uniform,
                     uniform_weight, device, stream);
}

// The coefficient mode: k sweeps of the radius-1 face-weight operator
// whose weights `weights` (float32[4 * p0 * p1 * p2], device, required)
// coeff_weights.cu formed from the padded a(x) (see the header). The tap
// table is that of the plan's radius-1 spec; it sets the radius and is
// otherwise unused. The other arguments and the return value are those of
// stencil_tiled_march.
int stencil_tiled_march_coeff(const float* in, const float* weights,
                              float* out, const int32_t* geom, int ngeom,
                              const int32_t* cols, int ncols,
                              const int32_t* tap_offsets,
                              const int32_t* group_sizes,
                              const float* group_weights, int ntaps,
                              int ngroups, int uniform, float uniform_weight,
                              int device, void* stream) {
  return coeff_entry(in, weights, out, geom, ngeom, cols, ncols,
                     tap_offsets, group_sizes, group_weights, ntaps, ngroups,
                     uniform, uniform_weight, device, stream);
}

// The two-level (leapfrog) mode: k steps of L_t = S(L_{t-1}) - L_{t-2}
// from `in` = L_n and `prev` = L_{n-1} (padded like `in`, required); sweep
// k goes to `out`, sweep k-1 (at k = 1 the input L_n) to `out2`
// (required), tile points only; no tile subset; the rings 2r+3 planes
// deep (see the header). The arguments and the return value are those of
// stencil_tiled_sweep_two_level (tiled_sweep.cu).
int stencil_tiled_march_two_level(const float* in, const float* prev,
                                  float* out, float* out2,
                                  const int32_t* geom, int ngeom,
                                  const int32_t* tap_offsets,
                                  const int32_t* group_sizes,
                                  const float* group_weights, int ntaps,
                                  int ngroups, int uniform,
                                  float uniform_weight, int device,
                                  void* stream) {
  return two_level_entry(in, prev, out, out2, geom, ngeom, tap_offsets,
                         group_sizes, group_weights, ntaps, ngroups, uniform,
                         uniform_weight, device, stream);
}

// The same in bf16.
int stencil_tiled_march_two_level_bf16(
    const __nv_bfloat16* in, const __nv_bfloat16* prev, __nv_bfloat16* out,
    __nv_bfloat16* out2, const int32_t* geom, int ngeom,
    const int32_t* tap_offsets, const int32_t* group_sizes,
    const float* group_weights, int ntaps, int ngroups, int uniform,
    float uniform_weight, int device, void* stream) {
  return two_level_entry(in, prev, out, out2, geom, ngeom, tap_offsets,
                         group_sizes, group_weights, ntaps, ngroups, uniform,
                         uniform_weight, device, stream);
}

// The Chebyshev modes: k sweeps of u_t = n_t*S(u_{t-1}) + c_t*u_{t-1} +
// pv_t*u_{t-2} + s_t*f, S the spec (radius 1), `source` the padded raw f
// (required), `coeffs` float[4*k] as (c, n, pv, s) per sweep (host), k <=
// 16; with `out2` (the dual mode, k >= 2) sweep k-1 also goes to `out2`,
// tile points only. Every face must be pinned. The rings 2r+3 planes deep
// (see the header). The arguments and the return value are those of
// stencil_tiled_sweep_cheby (tiled_sweep.cu).
int stencil_tiled_march_cheby(const float* in, float* out, float* out2,
                              const float* source, const int32_t* geom,
                              int ngeom, const float* coeffs, int ncoeffs,
                              const int32_t* cols, int ncols,
                              const int32_t* tap_offsets,
                              const int32_t* group_sizes,
                              const float* group_weights, int ntaps,
                              int ngroups, int uniform, float uniform_weight,
                              int device, void* stream) {
  return cheby_entry(in, out, out2, source, geom, ngeom, coeffs, ncoeffs,
                     cols, ncols, tap_offsets, group_sizes, group_weights,
                     ntaps, ngroups, uniform, uniform_weight, device, stream);
}

// The same in bf16 (the coefficients fp32, each a bf16 value).
int stencil_tiled_march_cheby_bf16(
    const __nv_bfloat16* in, __nv_bfloat16* out, __nv_bfloat16* out2,
    const __nv_bfloat16* source, const int32_t* geom, int ngeom,
    const float* coeffs, int ncoeffs, const int32_t* cols, int ncols,
    const int32_t* tap_offsets, const int32_t* group_sizes,
    const float* group_weights, int ntaps, int ngroups, int uniform,
    float uniform_weight, int device, void* stream) {
  return cheby_entry(in, out, out2, source, geom, ngeom, coeffs, ncoeffs,
                     cols, ncols, tap_offsets, group_sizes, group_weights,
                     ntaps, ngroups, uniform, uniform_weight, device, stream);
}

// The point-table kernel: the arguments and the return value of
// stencil_tiled_march, for a homogeneous launch (`source` null) that
// tables_fit admits; any other launch returns kErrTables.
int stencil_tiled_march_tables(const float* in, float* out,
                               const float* source, const int32_t* geom,
                               int ngeom, const int32_t* cols, int ncols,
                               const int32_t* tap_offsets,
                               const int32_t* group_sizes,
                               const float* group_weights, int ntaps,
                               int ngroups, int uniform, float uniform_weight,
                               int device, void* stream) {
  return tables_entry(in, out, source, geom, ngeom, cols, ncols, tap_offsets,
                      group_sizes, group_weights, ntaps, ngroups, uniform,
                      uniform_weight, device, stream);
}

// Whether stencil_tiled_march_tables runs a homogeneous launch of this
// geometry and tap table (the arguments of that entry): 1 if it does, 0 if
// it refuses it, or the code of a rejected geometry or tap table. Makes no
// CUDA call (ops/tiled_kernel.py:point_tables asks it once per plan).
int stencil_tiled_march_tables_fit(const int32_t* geom, int ngeom,
                                   const int32_t* tap_offsets,
                                   const int32_t* group_sizes,
                                   const float* group_weights, int ntaps,
                                   int ngroups, int uniform,
                                   float uniform_weight) {
  Launch<float> l;
  Taps taps;
  TapPlanes tp;
  const int rc = prepare(geom, ngeom, nullptr, 0, tap_offsets, group_sizes,
                         group_weights, ntaps, ngroups, uniform,
                         uniform_weight, l, taps, tp);
  if (rc != 0) return rc;
  return tables_fit(l.g, tap_offsets, ntaps, ngroups, uniform) ? 1 : 0;
}

const char* stencil_tiled_march_error(int code) {
  if (code == kErrArgument)
    return "rejected geometry, tap table or coefficients";
  if (code == kErrShared)
    return "rings exceed 232448 bytes of shared memory";
  if (code == kErrPlane)
    return "a bf16 input plane exceeds 8192 points";
  if (code == kErrTables)
    return "not a plan of the point-table kernel (homogeneous fp32, six "
           "radius-1 taps in one uniform group, k <= 8, each level's plane "
           "in its passes)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
