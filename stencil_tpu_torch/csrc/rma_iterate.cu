// n outer steps of a halo exchange and k sweeps, for every rank of a mesh
// whose ranks share one card, in one cooperative launch. Hand-written for
// Hopper (sm_90a), float32 or bfloat16.
//
// Replaces stencil_tpu/parallel/rma.py:build_rma_iterate (the Pallas TPU
// kernel, pallas_call at :746) on Dirichlet, periodic and Neumann walls.
// Wrapper, tables, schedule emulation and plain PyTorch version:
// stencil_tpu_torch/parallel/rma.py.
//
// What it computes. `bufs` holds R ranks' padded blocks, nbuf each
// (T[R][nbuf][P0][P1][P2]; a 2D grid comes with P0 = 1): buffers 0 and 1
// are the ping-pong slots. Step s reads slot (slot0 + s) % 2 and writes
// the other one, as the plain version (rma_iterate_reference) does it:
//   - the exchange into the input slot: the local refresh of an unsharded
//     dynamic dim, then one phase per sharded dim, each rank's edge strips
//     pushed into its neighbours' ghosts (rings of 1, 2 or more on a
//     periodic dim), a Neumann face's own mirror ghosts, corners riding
//     through the earlier phases (rma.py:phase_copies);
//   - k sweeps: sweep t writes the rank's update box of sweep t (the
//     interior grown by (k-t)*r on its live faces, rma.py:rma_tables) from
//     what sweep t-1 wrote; the last one the other slot's interior.
// The plain version keeps sweeps 1..k-1 in the compute buffers 2..nbuf-1;
// this kernel keeps them in shared memory and never touches those
// buffers. Both slots end cell for cell as the plain version leaves them.
//
// How. The exchange is a fixed map of ghost cells to the cells whose
// values they receive (rma.py:ghost_map: the phases run on the cells' own
// indices), so it needs no phases: each ghost cell is written by the tile
// that computes its source. Each rank's interior is cut into tiles
// (rma.py:rma_tiles, the tile chosen by rma.py:choose_rma_tile); each
// block of the cooperative launch (the grid the occupancy limit times the
// SM count, so every block is resident) owns the tiles blockIdx.x +
// i*gridDim.x for the whole launch and runs them in step order; the tile
// rule makes that one tile per block where it can (the first tile's place
// is worked out once per launch). Step s of a tile:
//   (a) wait until every tile of its dependency set has published epoch
//       >= s: one thread per dependency spins on ld.acquire.gpu of that
//       tile's flag, then __syncthreads();
//   (b) load its window (the tile grown by k*r) from the input slot into
//       two shared copies, on the L2-only path, a few loads in flight per
//       thread;
//   (c) run the k sweeps in shared memory, ping-ponging between the
//       copies: sweep t updates the tile grown by (k-t)*r cut to the
//       rank's box of sweep t; every other cell keeps the window's value
//       (outside the boxes that is a Dirichlet constant, the value the
//       plain version's compute buffers hold there);
//   (d) store level k (the tile itself) into the output slot as sweep k
//       computes it;
//   (e) but in the last step, write its ghost-map pairs into the output
//       slot: a source in its interior from shared memory, a source no
//       tile writes (a Dirichlet ghost a strip carries) from the output
//       slot, where it is a constant;
//   (f) __syncthreads(), then one thread publishes epoch s+1 with
//       st.release.gpu (cumulative: it orders the block's stores that the
//       barrier ordered before it).
// The dependency set of a tile is every tile whose writes (interior or
// pairs) meet its window, and every tile whose window meets its writes:
// the first are the reads of step s+1 of what step s wrote, the second the
// writes of step s+1 into the slot step s read. The set is symmetric, so a
// tile never runs more than one step ahead of a neighbour and one wait
// per step covers both. The launch opens with the exchange of its input
// slot (every pair, read from that slot) and one grid barrier, its only
// one; the last step writes no pairs, since the plain version exchanges at
// the start of a step and leaves the result slot's ghosts as they were.
// No block waits on one that waits on it in a cycle: every block runs all
// its tiles of step s before any of step s+1, so the block furthest behind
// can always go on.
//
// The read path. Every buffer is written inside this launch by other
// blocks, so no load may take the non-coherent path: no __restrict__ on
// the buffers and no __ldg (either lets nvcc emit ld.global.nc), and the
// L1, which is not coherent across SMs, is bypassed too. Every load of a
// buffer is __ldcg (cached in L2 only; a bf16 value is loaded as its 16
// bits). Stores are plain (the L1 writes through to L2).
//
// Element type. T is float or __nv_bfloat16 (entries rma_iterate_f32 and
// rma_iterate_bf16): copies move T values as they are; the taps widen
// each load to float and round every add and multiply to T at once
// (stencil_taps.cuh's Num<T>), as torch computes each op of the plain
// version in T. The windows in shared memory hold T.
//
// Taps: StencilSpec.weight_groups order, each group summed then multiplied
// once, with -fmad=false and the _rn operations, so the kernel is bitwise
// its plain version (eager.apply_spec). A uniform spec of 4, 6, 8, 12 or
// 26 taps (jacobi5, jacobi7, jacobi9, star3d_r2, jacobi27) has its sum
// compiled in (apply_uniform); any other spec reads the table.
//
// Bound. The function must move little: the grid read once and written
// once per launch; its operations, the stencil's per update, bound it.
// Each step reads every window from L2 (the tile grown by k*r) and
// recomputes the tile's rim at sweeps t < k; the rule that picks the tile
// weighs that against the tiles per SM. A step of a tile is a chain of
// phases (wait, load, k sweeps, pairs, publish) that no other work of its
// block overlaps; PERF.md has each phase's measured time.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "stencil_taps.cuh"

namespace cg = cooperative_groups;

namespace {

using stencil::Num;
using stencil::Taps;

constexpr int kThreads = 1024;
constexpr int kBatch = 4;  // window loads a thread keeps in flight
constexpr int kGeomLen = 33;  // rma.py:_geometry
constexpr int kSharedPerBlock = 232448;
constexpr int kErrArgument = -1;
constexpr int kErrCooperative = -2;

// With -DRMA_TRACE (parallel/rma_trace.py builds it so; never the
// launch's own build): thread 0 of each of the first kTraceBlocks blocks
// stamps the global timer (ns) at each phase of its first tile's first
// kTraceSteps steps: the start, the wait done, the window loaded, sweeps 1
// to 4 done, the pairs written, the epoch published.
constexpr int kTraceBlocks = 8, kTraceSteps = 64, kTracePhases = 9;
#ifdef RMA_TRACE
__device__ unsigned long long rma_trace[kTraceBlocks][kTraceSteps]
                                       [kTracePhases];
#define RMA_STAMP(ph)                                                     \
  do {                                                                    \
    if (threadIdx.x == 0 && blockIdx.x < kTraceBlocks &&                  \
        s < kTraceSteps && tile == (int)blockIdx.x) {                     \
      unsigned long long now;                                             \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));             \
      rma_trace[blockIdx.x][s][ph] = now;                                 \
    }                                                                     \
  } while (0)
#else
#define RMA_STAMP(ph) \
  do {                \
  } while (0)
#endif

struct Params {
  int k, steps, slot0, ntiles, npairs;
  int p1, p2;                  // padded extents of d1 and d2
  int64_t block, per_rank;     // P0*P1*P2, nbuf*block
  int t[3], nt[3], h[3], kr[3], n[3], r[3];
  int pitch1, pitch2, wvol;    // window pitches and volume
  int box_off, nbox;           // the boxes' byte offset in shared memory
  const int32_t* boxes;        // [R][k][6] start0..2, size0..2
  const int32_t* pair_ptr;     // [ntiles + 1]
  const int32_t* pairs;        // [npairs][3] dst, src, window index or -1
  const int32_t* dep_ptr;      // [ntiles + 1]
  const int32_t* deps;
};

// An L2-only load (see "The read path").
template <typename T>
__device__ __forceinline__ T ld(const T* p);
template <>
__device__ __forceinline__ float ld<float>(const float* p) {
  return __ldcg(p);
}
template <>
__device__ __forceinline__ __nv_bfloat16 ld<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// A uniform spec of NT taps (one group, one weight): the taps summed in
// order, then one multiply, each op rounded to T (apply_fixed's result
// without its per-tap test of the group table). The offsets are read from
// the launch's parameters at constant indices, so they take no registers,
// and the sum runs as the loads arrive.
template <int NT, typename T>
__device__ __forceinline__ float apply_uniform(const T* s, int p,
                                               const Taps& taps) {
  float acc = Num<T>::load(s[p + taps.off[0]]);
#pragma unroll
  for (int t = 1; t < NT; ++t)
    acc = stencil::add<T>(acc, Num<T>::load(s[p + taps.off[t]]));
  return stencil::mul<T>(acc, taps.uniform_weight);
}

// j / d for 0 <= j < 2^22 and d >= 1: a float estimate, then one
// correction (the estimate is off by at most one).
struct Div {
  int d;
  float inv;
  __device__ __forceinline__ explicit Div(int d_) : d(d_), inv(1.0f / d_) {}
  __device__ __forceinline__ int operator()(int j) const {
    int q = __float2int_rz(__int2float_rz(j) * inv);
    const int r = j - q * d;
    return q + (r >= d) - (r < 0);
  }
};

// The rows (d0, d1) of a box [lo, hi) dealt to the warps, each walked
// along d2 by the lanes: f(i0, i1, i2) for every cell, the row index
// stepped without a division.
template <typename F>
__device__ __forceinline__ void for_box(const int (&lo)[3], const int (&hi)[3],
                                        F f) {
  const int e0 = hi[0] - lo[0], e1 = hi[1] - lo[1], e2 = hi[2] - lo[2];
  if (e0 <= 0 || e1 <= 0 || e2 <= 0) return;
  const int lane = threadIdx.x & 31;
  int a = 0, b = threadIdx.x >> 5;
  while (b >= e1) b -= e1, ++a;
  while (a < e0) {
    const int i0 = lo[0] + a, i1 = lo[1] + b;
#pragma unroll 4
    for (int c = lane; c < e2; c += 32) f(i0, i1, lo[2] + c);
    b += kThreads / 32;
    while (b >= e1) b -= e1, ++a;
  }
}

// The window [lo, hi) from `src` (padded coordinates, row pitches p1 and
// p2) into both shared copies (pitches w1 and w2 from lo): its cells in
// row-major order dealt to the threads in turn, so every lane works
// however short the rows, kBatch of a thread's loads issued before their
// stores, so their L2 latencies overlap.
template <typename T>
__device__ __forceinline__ void load_window(const T* src, int p1, int p2,
                                            const int (&lo)[3],
                                            const int (&hi)[3], int w1,
                                            int w2, T* win0, T* win1) {
  const int e1 = hi[1] - lo[1], e2 = hi[2] - lo[2];
  const int n = (hi[0] - lo[0]) * e1 * e2;
  const Div by2(e2), by1(e1);
  const T* const first = src + ((int64_t)lo[0] * p1 + lo[1]) * p2 + lo[2];
  for (int j0 = threadIdx.x; j0 < n; j0 += kThreads * kBatch) {
    T v[kBatch];
    int at[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * kThreads;
      const int row = by2(j), a = by1(row);
      const int b = row - a * e1, c = j - row * e2;
      at[u] = -1;
      if (j < n) {
        v[u] = ld(first + (a * p1 + b) * p2 + c);
        at[u] = (a * w1 + b) * w2 + c;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (at[u] >= 0) {
        win0[at[u]] = v[u];
        win1[at[u]] = v[u];
      }
    }
  }
}

// A tile's place: its rank, its interior [lo, hi) in padded coordinates,
// its dependencies' and its pairs' ranges in the device table.
struct Tile {
  int rank, lo[3], hi[3], dep_first, dep_end, pair_first, pair_end;
};

__device__ __forceinline__ Tile tile_of(const Params& g, int tile) {
  Tile tl;
  int rest = tile;
  int j[3];
  j[2] = rest % g.nt[2];
  rest /= g.nt[2];
  j[1] = rest % g.nt[1];
  rest /= g.nt[1];
  j[0] = rest % g.nt[0];
  tl.rank = rest / g.nt[0];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    tl.lo[d] = g.h[d] + j[d] * g.t[d];
    tl.hi[d] = min(tl.lo[d] + g.t[d], g.h[d] + g.n[d]);
  }
  tl.dep_first = g.dep_ptr[tile];
  tl.dep_end = g.dep_ptr[tile + 1];
  tl.pair_first = g.pair_ptr[tile];
  tl.pair_end = g.pair_ptr[tile + 1];
  return tl;
}

template <int NT, typename T>
__global__ void __launch_bounds__(kThreads, 1)
rma_iterate_kernel(T* bufs, int* flags, const __grid_constant__ Params g,
                   const __grid_constant__ Taps taps) {
  extern __shared__ __align__(16) unsigned char shared[];
  T* const win0 = reinterpret_cast<T*>(shared);
  T* const win1 = win0 + g.wvol;
  int* const sbox = reinterpret_cast<int*>(shared + g.box_off);
  for (int i = threadIdx.x; i < g.nbox; i += kThreads) sbox[i] = g.boxes[i];
  // the opening exchange of the input slot, then the launch's one barrier
  {
    const int64_t in = (int64_t)g.slot0 * g.block;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < g.npairs;
         i += gridDim.x * kThreads) {
      const int32_t* q = g.pairs + 3 * (int64_t)i;
      bufs[in + q[0]] = ld(bufs + in + q[1]);
    }
  }
  cg::this_grid().sync();
  const T* const fin = (g.k & 1) ? win1 : win0;  // level k's copy
  // a block's first tile, its only one where the grid covers the tiles
  const Tile first = tile_of(g, blockIdx.x);
  for (int s = 0; s < g.steps; ++s) {
    const int64_t in = (int64_t)((g.slot0 + s) & 1) * g.block;
    const int64_t out = g.block - in;
    const bool last = s == g.steps - 1;
    for (int tile = blockIdx.x; tile < g.ntiles; tile += gridDim.x) {
      const Tile tl = tile == blockIdx.x ? first : tile_of(g, tile);
      RMA_STAMP(0);
      // (a) wait for the dependencies' step s-1
      for (int i = tl.dep_first + threadIdx.x; i < tl.dep_end;
           i += kThreads) {
        const int* f = flags + g.deps[i];
        while (ld_acquire(f) < s) __nanosleep(32);
      }
      __syncthreads();
      RMA_STAMP(1);
      int wlo[3], whi[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        wlo[d] = tl.lo[d] - g.kr[d];
        whi[d] = tl.hi[d] + g.kr[d];
      }
      T* const base = bufs + tl.rank * g.per_rank;
      auto widx = [&](int i0, int i1, int i2) {
        return ((i0 - wlo[0]) * g.pitch1 + (i1 - wlo[1])) * g.pitch2 + i2 -
               wlo[2];
      };
      // (b) the window, into both copies
      load_window(base + in, g.p1, g.p2, wlo, whi, g.pitch1, g.pitch2, win0,
                  win1);
      __syncthreads();
      RMA_STAMP(2);
      // (c) k sweeps in shared memory, level t in copy t % 2; (d) level k
      // (the tile itself: the last box is the interior) also stored into
      // the output slot
      for (int t = 1; t <= g.k; ++t) {
        const int* box = sbox + (tl.rank * g.k + t - 1) * 6;
        int rlo[3], rhi[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const int grow = (g.k - t) * g.r[d];
          rlo[d] = max(tl.lo[d] - grow, box[d]);
          rhi[d] = min(tl.hi[d] + grow, box[d] + box[3 + d]);
        }
        const T* const src = (t & 1) ? win0 : win1;
        T* const dst = (t & 1) ? win1 : win0;
        T* const to = t == g.k ? base + out : nullptr;
        for_box(rlo, rhi, [&](int i0, int i1, int i2) {
          const int p = widx(i0, i1, i2);
          float v;
          if constexpr (NT > 0)
            v = apply_uniform<NT, T>(src, p, taps);
          else
            v = stencil::apply_taps<T>(src, p, taps);
          const T o = Num<T>::store(v);
          dst[p] = o;
          if (to) to[(i0 * g.p1 + i1) * g.p2 + i2] = o;
        });
        __syncthreads();
        if (t <= 4) RMA_STAMP(2 + t);
      }
      // (e) the next step's exchange: this tile's ghost-map pairs
      if (!last) {
        for (int i = tl.pair_first + threadIdx.x; i < tl.pair_end;
             i += kThreads) {
          const int32_t* q = g.pairs + 3 * (int64_t)i;
          bufs[out + q[0]] = q[2] >= 0 ? fin[q[2]] : ld(bufs + out + q[1]);
        }
        __syncthreads();
      }
      RMA_STAMP(7);
      // (f) publish epoch s+1 once every store of the block is ordered
      if (threadIdx.x == 0) st_release(flags + tile, s + 1);
      RMA_STAMP(8);
    }
  }
}

template <int NT, typename T>
int launch_nt(T* bufs, int* flags, const Params& g, const Taps& taps,
              int shared, int device, cudaStream_t stream) {
  auto kernel = rma_iterate_kernel<NT, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return (int)err;
  int cooperative = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch,
                               device);
  if (err != cudaSuccess) return (int)err;
  if (!cooperative) return kErrCooperative;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, shared);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return kErrCooperative;
  const int grid = g.ntiles < per_sm * sms ? g.ntiles : per_sm * sms;
  Params gp = g;
  Taps tp = taps;
  void* args[] = {&bufs, &flags, &gp, &tp};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), args, shared, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(T* bufs, int* flags, const int32_t* table, const int32_t* geom,
           int ngeom, const int32_t* tap_offsets, const int32_t* group_sizes,
           const float* group_weights, int ntaps, int ngroups, int uniform,
           float uniform_weight, int device, void* stream) {
  if (ngeom != kGeomLen) return kErrArgument;
  Params g;
  const int ranks = geom[0], nbuf = geom[1];
  const int p0 = geom[2], p1 = geom[3], p2 = geom[4];
  g.k = geom[5];
  g.steps = geom[6];
  g.slot0 = geom[7];
  g.ntiles = geom[8];
  for (int d = 0; d < 3; ++d) {
    g.t[d] = geom[9 + d];
    g.nt[d] = geom[12 + d];
    g.h[d] = geom[15 + d];
    g.kr[d] = geom[18 + d];
    g.n[d] = geom[21 + d];
    g.r[d] = geom[24 + d];
  }
  g.npairs = geom[27];
  const int ndeps = geom[28];
  if (ranks < 1 || nbuf < 2 || g.k < 1 || g.steps < 1 || (g.slot0 & ~1) ||
      p0 < 1 || p1 < 1 || p2 < 1 || g.npairs < 0 || ndeps < 0)
    return kErrArgument;
  const int p[3] = {p0, p1, p2};
  int64_t tiles = ranks;
  for (int d = 0; d < 3; ++d) {
    if (g.t[d] < 1 || g.t[d] > g.n[d] || g.h[d] < g.kr[d] || g.kr[d] < 0 ||
        g.r[d] < 0 || (int64_t)g.k * g.r[d] > g.kr[d] ||
        p[d] != g.n[d] + 2 * g.h[d] ||
        g.nt[d] != (g.n[d] + g.t[d] - 1) / g.t[d])
      return kErrArgument;
    tiles *= g.nt[d];
  }
  if (tiles != g.ntiles) return kErrArgument;
  g.p1 = p1;
  g.p2 = p2;
  g.block = (int64_t)p0 * p1 * p2;
  g.per_rank = nbuf * g.block;
  if (ranks * g.per_rank >= ((int64_t)1 << 31)) return kErrArgument;
  const int pitch0 = g.t[0] + 2 * g.kr[0];
  g.pitch1 = g.t[1] + 2 * g.kr[1];
  g.pitch2 = g.t[2] + 2 * g.kr[2];
  const int64_t wvol = (int64_t)pitch0 * g.pitch1 * g.pitch2;
  g.box_off = (int)((2 * wvol * (int64_t)sizeof(T) + 15) / 16 * 16);
  g.nbox = ranks * g.k * 6;
  const int64_t shared = g.box_off + 4 * (int64_t)g.nbox;
  if (shared > kSharedPerBlock) return kErrArgument;
  g.wvol = (int)wvol;
  g.boxes = table;
  g.pair_ptr = table + geom[29];
  g.pairs = table + geom[30];
  g.dep_ptr = table + geom[31];
  g.deps = table + geom[32];

  Taps taps;
  if (!stencil::fill_groups(taps, group_sizes, group_weights, ntaps,
                            ngroups, uniform, uniform_weight))
    return kErrArgument;
  for (int i = 0; i < ntaps; ++i) {
    const int d0 = tap_offsets[3 * i], d1 = tap_offsets[3 * i + 1],
              d2 = tap_offsets[3 * i + 2];
    taps.off[i] = (d0 * g.pitch1 + d1) * g.pitch2 + d2;
  }

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  err = cudaMemsetAsync(flags, 0, sizeof(int) * (size_t)g.ntiles, st);
  if (err != cudaSuccess) return (int)err;
  const int sh = (int)shared;
  if (uniform && ngroups == 1) {
    switch (ntaps) {
      case 4:  // jacobi5
        return launch_nt<4>(bufs, flags, g, taps, sh, device, st);
      case 6:  // jacobi7
        return launch_nt<6>(bufs, flags, g, taps, sh, device, st);
      case 8:  // jacobi9
        return launch_nt<8>(bufs, flags, g, taps, sh, device, st);
      case 12:  // star3d_r2
        return launch_nt<12>(bufs, flags, g, taps, sh, device, st);
      case 26:  // jacobi27, box3d_r1
        return launch_nt<26>(bufs, flags, g, taps, sh, device, st);
      default:
        break;
    }
  }
  return launch_nt<0>(bufs, flags, g, taps, sh, device, st);
}

}  // namespace

extern "C" {

// Launch `steps` outer steps on `stream` (a cudaStream_t, 0 = the legacy
// default stream) of device `device`, as one cooperative launch. `bufs` is
// float32[R][nbuf][P0][P1][P2] on the device; `flags` int32[ntiles] on the
// device (zeroed here on the stream: the tiles' epochs); `table` (device,
// int32, rma.py:device_table) the update boxes [R][k][6], the pair and
// dependency lists of each tile. `geom` is int32[33] (host,
// rma.py:_geometry): R nbuf P0 P1 P2 k steps slot0 ntiles; per dim the
// tile, the tile grid, the layout's halo, k*r, the interior extent, the
// radius; the pair and dependency counts; the offsets in `table` of the
// pair pointers, the pairs, the dependency pointers, the dependencies.
// `tap_offsets` is int32[ntaps * 3] in group order, `group_sizes`
// int32[ngroups], `group_weights` float[ngroups]. Host arrays are copied
// before the launch returns. Returns 0, a CUDA error code, or a negative
// code (see rma_iterate_error).
int rma_iterate_f32(float* bufs, int32_t* flags, const int32_t* table,
                    const int32_t* geom, int ngeom,
                    const int32_t* tap_offsets, const int32_t* group_sizes,
                    const float* group_weights, int ntaps, int ngroups,
                    int uniform, float uniform_weight, int device,
                    void* stream) {
  return launch<float>(bufs, flags, table, geom, ngeom, tap_offsets,
                       group_sizes, group_weights, ntaps, ngroups, uniform,
                       uniform_weight, device, stream);
}

// The same in bf16: `bufs` holds __nv_bfloat16; the weights stay fp32,
// each a bf16 value.
int rma_iterate_bf16(__nv_bfloat16* bufs, int32_t* flags,
                     const int32_t* table, const int32_t* geom, int ngeom,
                     const int32_t* tap_offsets, const int32_t* group_sizes,
                     const float* group_weights, int ntaps, int ngroups,
                     int uniform, float uniform_weight, int device,
                     void* stream) {
  return launch<__nv_bfloat16>(bufs, flags, table, geom, ngeom, tap_offsets,
                               group_sizes, group_weights, ntaps, ngroups,
                               uniform, uniform_weight, device, stream);
}

#ifdef RMA_TRACE
// The stamps of the last launch into `out`
// (uint64[kTraceBlocks][kTraceSteps][kTracePhases]); 0 or a CUDA error.
int rma_iterate_trace(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, rma_trace, sizeof(rma_trace));
}
#endif

const char* rma_iterate_error(int code) {
  if (code == kErrArgument) return "rejected geometry or tap table";
  if (code == kErrCooperative)
    return "the device cannot run a cooperative launch of this kernel";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
