// k temporally blocked sweeps of a linear stencil over a deep-halo 3D
// fp32 or bf16 grid, in one launch. Hand-written for Hopper (sm_90a).
//
// Replaces stencil_tpu/ops/pallas_tiled.py:build_tiled_sweep (the Pallas
// TPU kernel, pallas_call at :1821) in six of its modes and its tile
// subsets (`subset`, B1f; every mode but the two-level one), with its `pins`
// (one per face of d0 and d1, :1270-1305) in the homogeneous, source,
// two-level and coefficient modes; the Chebyshev modes keep every face
// pinned:
//   - homogeneous: k sweeps of a StencilSpec;
//   - source (has_source): the affine sweep u' = S(u) + src behind Poisson
//     relaxation and the multigrid weighted-Jacobi smoother;
//   - Chebyshev (cheby_coeffs, TPU body compute_cheby at :1433-1495): k
//     sweeps of the per-sweep affine recurrence
//       u_t = n_t*S(u_{t-1}) + c_t*u_{t-1} + pv_t*u_{t-2} + s_t*f
//     with S the center-less radius-1 neighbour sum and no u_{t-2} term
//     at t = 1 (the multigrid Chebyshev smoother);
//   - dual (cheby_dual, :1476-1483): the Chebyshev recurrence whose sweep
//     k-1 also goes to a second output `out2`, while sweep k (the
//     residual tuple) goes to `out`: the multigrid fused smooth+residual.
//     The plan rule runs both Chebyshev modes on the d0 march
//     (tiled_march.cu, rings of 2r+3 planes) from k = 2 on; this window
//     mode is the march's comparison, bitwise equal on both outputs, and
//     the schedule of a launch of one sweep or that asks for the window;
//   - two-level (two_level, TPU body compute2 at :1374-1431): k leapfrog
//     steps L_t = S(L_{t-1}) - L_{t-2} of the wave equation from the two
//     levels `in` (L_n) and `prev` (L_{n-1}); sweep k goes to `out`, sweep
//     k-1 (at k = 1 the input L_n) to `out2`. The plan rule runs this
//     mode on the d0 march (tiled_march.cu, rings of 2r+3 planes) wherever
//     its rings fit; this window mode is the march's comparison, bitwise
//     equal on both outputs, and the schedule of a plan whose rings do not
//     fit or that asks for the window;
//   - coefficient (tap_mode='coeff', TPU weights prep_weights :871-912 and
//     taps taps_coeff :1195-1229): k sweeps of the radius-1 operator whose
//     per-point face weights are nb*harm(a(p), a(p+-e_d)) of a padded
//     coefficient field a(x) and whose center is c0 + cs*(sum of the six
//     face means): heterogeneous FTCS diffusion (nb = dt/h^2, c0 = 1,
//     cs = -dt/h^2) and, at k = 1, the steady operator's matvec (nb =
//     -1/h^2, c0 = 0, cs = 1/h^2). The plan rule (ops/tiled.py) runs
//     this mode on the d0 march (tiled_march.cu) wherever its rings fit,
//     from weights formed once per run (coeff_weights.cu); this window
//     mode is the march's comparison, bitwise equal, and the schedule of
//     a plan whose rings do not fit or that asks for the window.
// Every mode but the coefficient one runs in fp32 or bf16 (the TPU kernel
// at dtype=bfloat16; its coeff mode needs a 4-byte dtype, :451-455).
// Wrapper and plain PyTorch version: stencil_tpu_torch/ops/tiled_kernel.py.
//
// Element type. The kernel is templated on T, float or __nv_bfloat16: the
// shared-memory windows, the global loads and stores, the source and the
// prev/out2 operands are all T, so a bf16 window takes half the bytes and
// the plan chooser (ops/tiled.py) counts 2-byte points. Values are held in
// float registers; in bf16 every add and multiply (taps, source add,
// Chebyshev combination, leapfrog subtraction) is an fp32 _rn operation
// rounded to bf16 at once (stencil_taps.cuh), which is how torch computes
// each bf16 op of the plain version, so kernel and plain version agree
// bitwise in both types. The weights and Chebyshev coefficients come as
// fp32 holding values the host rounded to T. Each mode has one C entry per
// type: stencil_tiled_sweep, _cheby, _two_level (fp32) and the same names
// + _bf16; the coefficient mode only in fp32.
//
// What it computes. `in` and `out` are padded (n0+2H, n1+2H, n2+2H) T
// arrays whose H >= k*r ghost layers hold the Dirichlet face values. `out`
// receives k sweeps of the stencil applied to `in`, interior points only;
// ghost cells of `out` (and `out2`) are never written (the caller keeps
// them equal to those of `in`). Holding the ghosts constant between sweeps
// is what the TPU kernel's re-pinning of the ghost bands does. With a
// source, every interior update of every sweep adds the padded source at
// its point (one add after the taps, as the TPU kernel adds it at
// :1326-1335), read through the read-only cache; ghosts copy along
// without it. In the Chebyshev modes the source holds the raw f and each
// sweep scales it by its own s_t; the update is formed as
// ((n*S + c*u) + s*f) + pv*prev, each step a separate rounded multiply or
// add in the TPU kernel's order (:1465-1471).
//
// How. One block per 3D output tile of (t0, t1, t2) points. It loads the
// tile's window, the tile grown by k*r on every side, into shared memory,
// then runs the k sweeps there, a barrier between sweeps. Sweep t updates
// the window shrunk by t*r on every side, reading the region sweep t-1 left
// valid; two shared buffers alternate. A point of that region that lies in
// the grid's interior gets the stencil; a ghost point copies its constant
// along. The last sweep's region is the tile itself, all interior, and goes
// straight to global memory.
//
// The Chebyshev recurrence needs three windows (u_{t-1}, u_{t-2} and the
// destination) but keeps two: at sweep t the buffer being written still
// holds u_{t-2}, over a region that contains sweep t's, so each thread
// reads prev[p] and then writes u_t[p] at the same point, while every
// neighbour read goes to the other buffer. So a Chebyshev or dual launch
// uses exactly the shared memory of a source launch, and the plan chooser
// counts it the same (ops/tiled.py). The two-level mode is the same
// recurrence with pv = -1: its subtrahend at sweep 1 is `prev` at the
// point, read once through the read-only cache (it is never read at a
// neighbour, so it needs no window), and from sweep 2 the buffer being
// written. The coefficient mode reads a(p) and its six face neighbours
// through the read-only cache at every update and forms the face means
// there, harm(x, y) = (2x*y)/(x+y) in _rn steps: bitwise symmetric, so a
// hi face equals the neighbour's lo face as the TPU kernel assumes. It
// recomputes the weights at every sweep (7 loads, 6 divides per update)
// where the TPU kernel stores them in five weight windows once per tile;
// both modes thus keep the shared memory of a source launch. That
// recomputation, on top of the shrinking windows' overlap, is what binds
// this mode (on an H100, 10.66 ms a launch at 256^3 k=8, 157x its bound,
// PERF.md); the march
// forms the weights once per run instead and reads four fields of them.
//
// Pins: the geometry carries one flag per face of d0 and d1 (lo, hi). A
// pinned face (1) is a Dirichlet wall, as above. A live face (0) is a
// periodic or Neumann wall whose k*r ghost layers the caller filled with
// the wrapped or mirrored interior before the launch: a window point
// beyond it gets the mode's full update (taps, + src, - L_{t-2}, the
// weights of the refreshed a(x)) exactly as an interior point does, so
// the shrinking windows carry the wrap or mirror through the k sweeps as
// the TPU kernel does for a face whose ghosts hold live data. In the
// update test a live face moves the interior's bound to the window's
// edge; with every face pinned the bounds, and so the results, are those
// of a launch without pins. A live point at sweep t lies at padded index
// >= H - k*r + t*r >= t*r and reads at most r (taps) or 1 (a(x)) beyond,
// so every read stays inside the padded array. The d2 faces are always
// pinned: a periodic or Neumann d2 runs at k = 1, where sweep 1's region
// is the tile itself and the caller's refresh is the whole mechanism.
//
// Ragged grids: the last tile of a dim whose extent is not a multiple of
// the tile starts early, at n - t (clamped, as build_tiled_sweep does at
// :732-745). It overlaps its neighbour; both compute the overlap from the
// same input with the same arithmetic and write identical values.
//
// Tile subsets (build_tiled_sweep(subset=...) at :705, :746-758, the phase
// split of the overlapped sharded step, stencil_tpu/parallel/
// pallas_sharded.py:280-290, 447-456): a launch may sweep only a list of
// tile columns. A column is one (i0, i1) pair with every i2 of it, named
// by its id i0 * nt1 + i1 (ops/tiled.py:partition_tiles). The caller
// passes the ids as a device int32 array `cols` of ncols entries; the
// grid then has ncols * nt2 blocks, block b sweeping tile i2 = b % nt2 of
// column cols[b / nt2]. Nothing else changes: the tiles outside the list
// are not written, so `out` keeps what it held (the TPU kernel's output
// aliasing). Every mode but the two-level one takes a subset (the TPU
// kernel refuses it there, :752-755). A null `cols` is the full launch.
// The interior launch followed by the edge launch into one `out` writes
// every tile once with the values of the full launch, so the pair is
// bitwise the full launch whenever the interior tiles' windows read no
// cell the exchange between them writes (the sharded step's geometry).
//
// Taps: a table in StencilSpec.weight_groups order, passed by value and
// evaluated by stencil_taps.cuh, bitwise as the eager torch version
// (ops/eager.py) rounds. The tap counts of the named 3D specs (6, 12, 26)
// get an unrolled evaluator with the offsets in registers; any other count
// up to stencil::kMaxTaps reads the table in a loop. The Chebyshev
// coefficients are passed by value too, rounded to T on the host.
//
// Bound. Temporal blocking exists to cut HBM bytes: one launch reads the
// padded array once (plus the windows' overlap, mostly from L2) and writes
// it once for k sweeps; by the roofline rule (each input read once, each
// output written once) every mode is bound by bytes on the H100, at a
// small k (the multigrid smoothers run k = 1..5) by a wide margin. On the
// card that is not what binds this kernel: the shrinking windows recompute
// their overlap (at k=8 an (8,16,16) tile updates ~4.5 points per useful
// update), every update reads its taps from shared memory, and a block
// holding one or two windows leaves few warps to hide latency. So
// instruction throughput and latency bind it, and the loops are written
// to execute few instructions: no index division per point, loads
// unrolled so that several are in flight, the sweep's four Chebyshev
// coefficients read once per sweep. The Chebyshev modes add one source
// read (read-only cache) and, from t = 2, one shared read per update; the
// dual mode one global store per tile point; the two-level mode one
// source read at sweep 1 and one shared read from sweep 2; the
// coefficient mode 7 global loads, 6 divides and 44 more operations per
// update, which make it bound by operations even by the roofline rule.
// Loads are plain, not TMA or cp.async, and do not overlap compute within
// a block. Every mode runs instead on the d0 march of tiled_march.cu
// wherever its rings fit (ops/tiled.py, schedule "march"): the
// homogeneous and source modes (with pins, bf16 and tile subsets), the
// two-level mode (with pins and bf16), the Chebyshev and dual modes (bf16
// and subsets) and the coefficient mode (with pins and subsets); one ring
// of planes per sweep level, so d0 is not recomputed and the input loads
// overlap the sweeps. This window schedule stays their comparison, bitwise
// equal, and runs a two-level or Chebyshev launch of one sweep, where its
// one window was the faster on an H100.

#include <cuda_runtime.h>

#include <cstdint>

#include "stencil_taps.cuh"

namespace {

using stencil::add;
using stencil::Evaluator;
using stencil::mul;
using stencil::Num;
using stencil::sub;
using stencil::Taps;

constexpr int kBlockX = 32;   // threads along d2 (contiguous)
constexpr int kBlockY = 16;   // threads along the flattened (d0, d1) rows
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kGeomLen = 19;
constexpr int kMaxSweeps = 16;  // Chebyshev coefficient tuples per launch
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB per block on sm_90
constexpr int kErrArgument = -1;
constexpr int kErrShared = -2;

// What a launch computes (see the header).
enum Mode {
  kPlain = 0, kSource = 1, kCheby = 2, kDual = 3, kTwoLevel = 4, kCoeff = 5
};

struct Geometry {
  int n0, n1, n2;   // interior extents
  int p1, p2;       // padded extents of d1 and d2 (row strides)
  int halo;         // pad depth H: the interior starts at padded index H
  int t0, t1, t2;   // tile extents
  int nt1, nt2;     // tiles along d1 and d2
  int k, r;         // sweeps per launch, stencil radius
  int w0, w1, w2;   // window extents, t + 2*k*r
  int pins[4];      // d0 lo, d0 hi, d1 lo, d1 hi: 1 pinned, 0 live
};

// Per-sweep (c, n, pv, s) of the Chebyshev modes, as the host rounded them
// to the element type (held in fp32); sweep t (1-based) uses entry t-1.
// (nb, c0, cs): the coefficient mode's scales, fp32 as the host rounded
// them.
struct Coeffs {
  float c[kMaxSweeps], n[kMaxSweeps], pv[kMaxSweeps], s[kMaxSweeps];
  float nb, c0, cs;
};

// The face mean of two cell coefficients, in the TPU kernel's order.
__device__ __forceinline__ float harm(float x, float y) {
  return __fdiv_rn(__fmul_rn(__fmul_rn(2.0f, x), y), __fadd_rn(x, y));
}

// The coefficient mode's update at window point p of `u` (window strides
// sw0, sw1, 1), the coefficient read at padded index q of `a` (strides
// gs0, gs1, 1): weights and sums in the TPU kernel's order (:903-912,
// :1219-1227), each step rounded.
__device__ __forceinline__ float coeff_update(
    const float* __restrict__ u, int p, int sw0, int sw1,
    const float* __restrict__ a, int64_t q, int64_t gs0, int gs1,
    float nb, float c0, float cs) {
  const float ac = __ldg(a + q);
  const float h0l = harm(ac, __ldg(a + q - gs0));
  const float h0h = harm(ac, __ldg(a + q + gs0));
  const float h1l = harm(ac, __ldg(a + q - gs1));
  const float h1h = harm(ac, __ldg(a + q + gs1));
  const float h2l = harm(ac, __ldg(a + q - 1));
  const float h2h = harm(ac, __ldg(a + q + 1));
  const float sum6 = __fadd_rn(
      __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(h0l, h0h), h1l), h1h), h2l),
      h2h);
  const float ctr = __fadd_rn(c0, __fmul_rn(cs, sum6));
  float acc = __fmul_rn(ctr, u[p]);
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(nb, h1l), u[p - sw1]));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(nb, h1h), u[p + sw1]));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(nb, h2l), u[p - 1]));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(nb, h2h), u[p + 1]));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(nb, h0l), u[p - sw0]));
  return __fadd_rn(acc, __fmul_rn(__fmul_rn(nb, h0h), u[p + sw0]));
}

// NT > 0: a spec of exactly NT taps; NT == 0: any spec. MODE: see Mode;
// `cols`: a tile subset's column ids (i0 * nt1 + i1), or null for every
// tile (see the header);
// `source` is read in every mode but kPlain: the padded source, the raw f
// (kCheby, kDual), L_{n-1} (kTwoLevel) or the coefficient a(x) (kCoeff);
// `coeffs` in kCheby, kDual and kCoeff, `out2` in kDual and kTwoLevel.
// T: the element type (kCoeff: float only).
template <int NT, int MODE, typename T>
__global__ void __launch_bounds__(kThreads)
tiled_sweep_kernel(const T* __restrict__ in, T* __restrict__ out,
                   T* __restrict__ out2, const T* __restrict__ source,
                   const int32_t* __restrict__ cols, const Geometry g,
                   const __grid_constant__ Taps taps,
                   const __grid_constant__ Coeffs coeffs) {
  using N = Num<T>;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* const smem = reinterpret_cast<T*>(smem_bytes);
  const int wvol = g.w0 * g.w1 * g.w2;
  T* cur = smem;
  T* nxt = g.k > 1 ? smem + wvol : smem;  // a second window when k > 1
  const Evaluator<NT, T> stencil_at(taps);

  // this block's tile: i2 from the block index, its column (i0, i1) from
  // the block index or, in a subset launch, from the column list
  const int i2 = blockIdx.x % g.nt2;
  int col = blockIdx.x / g.nt2;
  if (cols != nullptr) col = cols[col];
  const int i1 = col % g.nt1;
  const int i0 = col / g.nt1;
  const int kr = g.k * g.r;
  // window origin in padded coordinates: clamped tile start - k*r + H
  const int o0 = min(i0 * g.t0, g.n0 - g.t0) + g.halo - kr;
  const int o1 = min(i1 * g.t1, g.n1 - g.t1) + g.halo - kr;
  const int o2 = min(i2 * g.t2, g.n2 - g.t2) + g.halo - kr;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;

  // The window load, flattened over its points so every lane works. Each
  // thread walks i = tid, tid + kThreads, ... carrying the (a, c1, c)
  // window coordinates of i instead of dividing for each point; unrolled
  // so that several global loads are in flight.
  {
    const int sc = kThreads % g.w2;
    const int srow = kThreads / g.w2;
    const int sc1 = srow % g.w1;
    const int sa = srow / g.w1;
    int c = tid % g.w2;
    int c1 = (tid / g.w2) % g.w1;
    int a = tid / (g.w2 * g.w1);
#pragma unroll 4
    for (int i = tid; i < wvol; i += kThreads) {
      cur[i] = in[((int64_t)(o0 + a) * g.p1 + (o1 + c1)) * g.p2 + o2 + c];
      c += sc;
      int carry = c >= g.w2;
      c -= carry ? g.w2 : 0;
      c1 += sc1 + carry;
      carry = c1 >= g.w1;
      c1 -= carry ? g.w1 : 0;
      a += sa + carry;
    }
  }
  __syncthreads();

  // the points a sweep updates, in window coordinates, [lo, hi) per dim:
  // the grid's interior, widened to the window's edge at a live face
  const int lo0 = g.pins[0] ? g.halo - o0 : 0;
  const int hi0 = g.pins[1] ? g.halo - o0 + g.n0 : g.w0;
  const int lo1 = g.pins[2] ? g.halo - o1 : 0;
  const int hi1 = g.pins[3] ? g.halo - o1 + g.n1 : g.w1;
  const int lo2 = g.halo - o2, hi2 = lo2 + g.n2;

  for (int t = 1; t <= g.k; ++t) {
    const int e = t * g.r;  // region of sweep t: [e, w - e) per dim
    const int rows1 = g.w1 - 2 * e;
    const int rows = (g.w0 - 2 * e) * rows1;
    const bool last = t == g.k;
    // dual and two-level modes: sweep k-1 also writes the tile, [kr, kr +
    // t) per dim
    constexpr bool kTwoOut = MODE == kDual || MODE == kTwoLevel;
    const bool dual_out = kTwoOut && t == g.k - 1;
    float cc = 0.0f, cn = 0.0f, cpv = 0.0f, cs = 0.0f;
    if constexpr (MODE == kCheby || MODE == kDual) {
      cc = coeffs.c[t - 1];
      cn = coeffs.n[t - 1];
      cpv = coeffs.pv[t - 1];
      cs = coeffs.s[t - 1];
    }
    // this thread's rows: threadIdx.y, + kBlockY, ... as (a, c1), carried
    const int sc1 = kBlockY % rows1;
    const int sa = kBlockY / rows1;
    int c1 = threadIdx.y % rows1;
    int a = threadIdx.y / rows1;
    for (int row = threadIdx.y; row < rows; row += kBlockY) {
      const int wa = a + e, wc1 = c1 + e;
      const bool inner = wa >= lo0 && wa < hi0 && wc1 >= lo1 && wc1 < hi1;
      const bool tile_row = dual_out && wa >= kr && wa < kr + g.t0 &&
                            wc1 >= kr && wc1 < kr + g.t1;
      const int base = (wa * g.w1 + wc1) * g.w2;
      const int64_t grow = ((int64_t)(o0 + wa) * g.p1 + (o1 + wc1)) * g.p2 + o2;
      for (int c = threadIdx.x + e; c < g.w2 - e; c += kBlockX) {
        const int p = base + c;
        float v;
        if (inner && c >= lo2 && c < hi2) {
          if constexpr (MODE == kCoeff) {
            v = coeff_update(cur, p, g.w1 * g.w2, g.w2, source, grow + c,
                             (int64_t)g.p1 * g.p2, g.p2, coeffs.nb,
                             coeffs.c0, coeffs.cs);
          } else {
            v = stencil_at(cur, p, taps);
          }
          if constexpr (MODE == kSource) {
            v = add<T>(v, N::ldg(source + grow + c));
          } else if constexpr (MODE == kCheby || MODE == kDual) {
            v = add<T>(add<T>(mul<T>(cn, v), mul<T>(cc, N::load(cur[p]))),
                       mul<T>(cs, N::ldg(source + grow + c)));
            // nxt still holds u_{t-2} here (see the header)
            if (t >= 2) v = add<T>(v, mul<T>(cpv, N::load(nxt[p])));
          } else if constexpr (MODE == kTwoLevel) {
            // L_{t-2}: prev at sweep 1, then nxt (see the header)
            v = sub<T>(v, t == 1 ? N::ldg(source + grow + c)
                                 : N::load(nxt[p]));
          }
        } else {
          v = N::load(cur[p]);
        }
        if (last) {
          out[grow + c] = N::store(v);
          // k = 1: L_{n+k-1} is the input itself (the region is the tile)
          if constexpr (MODE == kTwoLevel) {
            if (g.k == 1) out2[grow + c] = cur[p];
          }
        } else {
          nxt[p] = N::store(v);
          if constexpr (kTwoOut) {
            if (tile_row && c >= kr && c < kr + g.t2)
              out2[grow + c] = N::store(v);
          }
        }
      }
      c1 += sc1;
      const int carry = c1 >= rows1;
      c1 -= carry ? rows1 : 0;
      a += sa + carry;
    }
    if (!last) {
      __syncthreads();
      T* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
}

template <typename T>
struct Launch {
  const T* in;
  T* out;
  T* out2;
  const T* source;
  const int32_t* cols;  // the subset's column ids (device), or null
  Geometry g;
  unsigned nblocks;
  size_t shared;
  cudaStream_t stream;
};

template <int NT, int MODE, typename T>
cudaError_t launch(const Launch<T>& l, const Taps& taps, const Coeffs& co) {
  cudaError_t err = cudaFuncSetAttribute(
      tiled_sweep_kernel<NT, MODE, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.shared);
  if (err != cudaSuccess) return err;
  tiled_sweep_kernel<NT, MODE, T><<<l.nblocks, dim3(kBlockX, kBlockY),
                                    l.shared, l.stream>>>(
      l.in, l.out, l.out2, l.source, l.cols, l.g, taps, co);
  return cudaGetLastError();
}

template <int MODE, typename T>
cudaError_t dispatch(int ntaps, const Launch<T>& l, const Taps& taps,
                     const Coeffs& co) {
  switch (ntaps) {
    case 6:   // jacobi7, the multigrid neighbour sum
      return launch<6, MODE>(l, taps, co);
    case 12:  // star3d_r2, laplace3d_ho
      return launch<12, MODE>(l, taps, co);
    case 26:  // jacobi27
      return launch<26, MODE>(l, taps, co);
    default:
      return launch<0, MODE>(l, taps, co);
  }
}

// The two-level mode: the wave spec (7 taps) unrolled, any other through
// the table.
template <typename T>
cudaError_t dispatch_two_level(int ntaps, const Launch<T>& l,
                               const Taps& taps) {
  const Coeffs none{};
  return ntaps == 7 ? launch<7, kTwoLevel>(l, taps, none)
                    : launch<0, kTwoLevel>(l, taps, none);
}

// Checks the geometry, the subset's length and the tap table and fills `l`
// (but its tensor pointers and stream) and `taps`; 0 or a negative error
// code. `cols` (device) is not read here: the wrapper checks its ids.
template <typename T>
int prepare(const int32_t* geom, int ngeom, const int32_t* cols, int ncols,
            const int32_t* tap_offsets, const int32_t* group_sizes,
            const float* group_weights, int ntaps, int ngroups, int uniform,
            float uniform_weight, Launch<T>& l, Taps& taps) {
  if (ngeom != kGeomLen) return kErrArgument;
  const int n0 = geom[0], n1 = geom[1], n2 = geom[2];
  const int p0 = geom[3], p1 = geom[4], p2 = geom[5], halo = geom[6];
  const int t0 = geom[7], t1 = geom[8], t2 = geom[9];
  const int nt0 = geom[10], nt1 = geom[11], nt2 = geom[12];
  const int k = geom[13], r = geom[14];
  if (k < 1 || r < 1 || (int64_t)k * r > halo) return kErrArgument;
  for (int i = 0; i < 4; ++i) {
    if (geom[15 + i] != 0 && geom[15 + i] != 1) return kErrArgument;
    l.g.pins[i] = geom[15 + i];
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

  Geometry& g = l.g;
  g.n0 = n0; g.n1 = n1; g.n2 = n2;
  g.p1 = p1; g.p2 = p2; g.halo = halo;
  g.t0 = t0; g.t1 = t1; g.t2 = t2;
  g.nt1 = nt1; g.nt2 = nt2;
  g.k = k; g.r = r;
  g.w0 = t0 + 2 * k * r; g.w1 = t1 + 2 * k * r; g.w2 = t2 + 2 * k * r;
  const size_t window = (size_t)g.w0 * g.w1 * g.w2;
  l.shared = (k > 1 ? 2 : 1) * window * sizeof(T);
  if (l.shared > kMaxSharedBytes) return kErrShared;
  l.nblocks = (unsigned)nblocks;

  if (!stencil::fill_groups(taps, group_sizes, group_weights, ntaps,
                            ngroups, uniform, uniform_weight))
    return kErrArgument;
  for (int i = 0; i < ntaps; ++i) {
    const int d0 = tap_offsets[3 * i], d1 = tap_offsets[3 * i + 1],
              d2 = tap_offsets[3 * i + 2];
    if (d0 < -r || d0 > r || d1 < -r || d1 > r || d2 < -r || d2 > r)
      return kErrArgument;
    taps.off[i] = (d0 * g.w1 + d1) * g.w2 + d2;
  }
  return 0;
}

// The entries' bodies, one per mode, for either element type.
template <typename T>
int sweep_entry(const T* in, T* out, const T* source, const int32_t* geom,
                int ngeom, const int32_t* cols, int ncols,
                const int32_t* tap_offsets, const int32_t* group_sizes,
                const float* group_weights, int ntaps, int ngroups,
                int uniform, float uniform_weight, int device, void* stream) {
  Launch<T> l;
  Taps taps;
  const int rc = prepare(geom, ngeom, cols, ncols, tap_offsets, group_sizes,
                         group_weights, ntaps, ngroups, uniform,
                         uniform_weight, l, taps);
  if (rc != 0) return rc;
  l.in = in; l.out = out; l.out2 = nullptr; l.source = source;
  l.stream = (cudaStream_t)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Coeffs none{};
  return source ? (int)dispatch<kSource>(ntaps, l, taps, none)
                : (int)dispatch<kPlain>(ntaps, l, taps, none);
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
  const int rc = prepare(geom, ngeom, cols, ncols, tap_offsets, group_sizes,
                         group_weights, ntaps, ngroups, uniform,
                         uniform_weight, l, taps);
  if (rc != 0) return rc;
  const int k = l.g.k;
  if (source == nullptr || coeffs == nullptr || l.g.r != 1 ||
      k > kMaxSweeps || ncoeffs != 4 * k || (out2 != nullptr && k < 2))
    return kErrArgument;
  for (int i = 0; i < 4; ++i)
    if (!l.g.pins[i]) return kErrArgument;
  Coeffs co{};
  for (int t = 0; t < k; ++t) {
    co.c[t] = coeffs[4 * t];
    co.n[t] = coeffs[4 * t + 1];
    co.pv[t] = coeffs[4 * t + 2];
    co.s[t] = coeffs[4 * t + 3];
  }
  l.in = in; l.out = out; l.out2 = out2; l.source = source;
  l.stream = (cudaStream_t)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return out2 ? (int)dispatch<kDual>(ntaps, l, taps, co)
              : (int)dispatch<kCheby>(ntaps, l, taps, co);
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
  // no subset: the TPU kernel refuses one in the two-level mode
  const int rc = prepare(geom, ngeom, nullptr, 0, tap_offsets, group_sizes,
                         group_weights, ntaps, ngroups, uniform,
                         uniform_weight, l, taps);
  if (rc != 0) return rc;
  if (prev == nullptr || out2 == nullptr) return kErrArgument;
  l.in = in; l.out = out; l.out2 = out2; l.source = prev;
  l.stream = (cudaStream_t)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)dispatch_two_level(ntaps, l, taps);
}

}  // namespace

extern "C" {

// Launch k sweeps on `stream` (a cudaStream_t, 0 = the legacy default
// stream) of device `device`. `source` is null, or a padded array of the
// layout and type of `in` whose interior holds the pre-scaled source: each
// update is then S(u) + source (the affine sweep u' = S(u) + c*f; pinned
// ghosts get no source, live ones the source's image there). `geom` is
// int32[19]: n0 n1 n2 p0 p1 p2 halo t0 t1 t2 nt0 nt1 nt2 k r, then the
// pins of the d0 lo, d0 hi, d1 lo and d1 hi faces (1 pinned, 0 live; see
// the header). `cols` is null (every tile) or a device int32[ncols] of
// column ids, the tile subset to sweep (see the header); the caller
// checks each id lies in [0, nt0 * nt1). `tap_offsets` is int32[ntaps * 3]
// in group order,
// `group_sizes` int32[ngroups], `group_weights` float[ngroups].
// Host arrays are copied before the launch returns. Returns 0, a CUDA
// error code (cudaGetLastError after the launch), or a negative code for
// a rejected argument (see stencil_tiled_sweep_error).
int stencil_tiled_sweep(const float* in, float* out, const float* source,
                        const int32_t* geom, int ngeom, const int32_t* cols,
                        int ncols, const int32_t* tap_offsets,
                        const int32_t* group_sizes,
                        const float* group_weights, int ntaps, int ngroups,
                        int uniform, float uniform_weight, int device,
                        void* stream) {
  return sweep_entry(in, out, source, geom, ngeom, cols, ncols, tap_offsets,
                     group_sizes, group_weights, ntaps, ngroups, uniform,
                     uniform_weight, device, stream);
}

// The same in bf16: `in`, `out` and `source` hold __nv_bfloat16; the
// weights stay fp32, each a bf16 value.
int stencil_tiled_sweep_bf16(const __nv_bfloat16* in, __nv_bfloat16* out,
                             const __nv_bfloat16* source,
                             const int32_t* geom, int ngeom,
                             const int32_t* cols, int ncols,
                             const int32_t* tap_offsets,
                             const int32_t* group_sizes,
                             const float* group_weights, int ntaps,
                             int ngroups, int uniform, float uniform_weight,
                             int device, void* stream) {
  return sweep_entry(in, out, source, geom, ngeom, cols, ncols, tap_offsets,
                     group_sizes, group_weights, ntaps, ngroups, uniform,
                     uniform_weight, device, stream);
}

// The Chebyshev modes: k sweeps of u_t = n_t*S(u_{t-1}) + c_t*u_{t-1} +
// pv_t*u_{t-2} + s_t*f, S the spec (radius 1), `source` the padded raw f
// (required), `coeffs` float[4*k] as (c, n, pv, s) per sweep, k <= 16.
// With `out2` (dual mode, k >= 2) sweep k-1 is written to `out2` as well,
// and sweep k to `out`. Every face must be pinned (the multigrid levels
// have Dirichlet walls). The other arguments and the return value are
// those of stencil_tiled_sweep.
int stencil_tiled_sweep_cheby(const float* in, float* out, float* out2,
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
int stencil_tiled_sweep_cheby_bf16(
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

// The two-level (leapfrog) mode: k steps of L_t = S(L_{t-1}) - L_{t-2}
// from `in` = L_n and `prev` = L_{n-1} (padded like `in`, required); sweep
// k goes to `out`, sweep k-1 (at k = 1 the input L_n) to `out2`
// (required), tile points only; it takes no tile subset. The other
// arguments and the return value are those of stencil_tiled_sweep.
int stencil_tiled_sweep_two_level(const float* in, const float* prev,
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
int stencil_tiled_sweep_two_level_bf16(
    const __nv_bfloat16* in, const __nv_bfloat16* prev, __nv_bfloat16* out,
    __nv_bfloat16* out2, const int32_t* geom, int ngeom,
    const int32_t* tap_offsets, const int32_t* group_sizes,
    const float* group_weights, int ntaps, int ngroups, int uniform,
    float uniform_weight, int device, void* stream) {
  return two_level_entry(in, prev, out, out2, geom, ngeom, tap_offsets,
                         group_sizes, group_weights, ntaps, ngroups, uniform,
                         uniform_weight, device, stream);
}

// The coefficient mode: k sweeps of the radius-1 face-weight operator of
// the padded coefficient `coeff` (the layout of `in`, ghosts
// edge-replicated; required), `scales` float[3] = (nb, c0, cs) (host). The
// tap table is that of the plan's radius-1 spec; it sets the radius and is
// otherwise unused. The other arguments and the return value are those of
// stencil_tiled_sweep.
int stencil_tiled_sweep_coeff(const float* in, const float* coeff,
                              float* out, const int32_t* geom, int ngeom,
                              const float* scales, int nscales,
                              const int32_t* cols, int ncols,
                              const int32_t* tap_offsets,
                              const int32_t* group_sizes,
                              const float* group_weights, int ntaps,
                              int ngroups, int uniform, float uniform_weight,
                              int device, void* stream) {
  Launch<float> l;
  Taps taps;
  const int rc = prepare(geom, ngeom, cols, ncols, tap_offsets, group_sizes,
                         group_weights, ntaps, ngroups, uniform,
                         uniform_weight, l, taps);
  if (rc != 0) return rc;
  if (coeff == nullptr || scales == nullptr || nscales != 3 || l.g.r != 1)
    return kErrArgument;
  Coeffs co{};
  co.nb = scales[0];
  co.c0 = scales[1];
  co.cs = scales[2];
  l.in = in; l.out = out; l.out2 = nullptr; l.source = coeff;
  l.stream = (cudaStream_t)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<0, kCoeff>(l, taps, co);
}

const char* stencil_tiled_sweep_error(int code) {
  if (code == kErrArgument) return "rejected geometry, tap table or coefficients";
  if (code == kErrShared) return "window exceeds 232448 bytes of shared memory";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
