// n outer steps of a halo exchange and k sweeps, for every rank of a mesh
// whose ranks lie on one card or on several, one cooperative launch per
// card (or one over every virtual card of one device). Hand-written for
// Hopper (sm_90a), float32 or bfloat16.
//
// Replaces stencil_tpu/parallel/rma.py:build_rma_iterate (the Pallas TPU
// kernel, pallas_call at :746) on Dirichlet, periodic and Neumann walls,
// its remote copies chip to chip (make_async_remote_copy, :397-433) and
// its neighbour barrier (:365-383). Wrapper, tables, schedule emulation
// and plain PyTorch version: stencil_tpu_torch/parallel/rma.py.
//
// What it computes. Each card c holds its ranks' padded blocks, nbuf each
// (bufs[c] = T[R_c][nbuf][P0][P1][P2]; a 2D grid comes with P0 = 1):
// buffers 0 and 1 are the ping-pong slots. Step s reads slot
// (slot0 + s) % 2 and writes the other one, as the plain version
// (rma_iterate_reference) does it:
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
// (rma.py:rma_tiles, the tile chosen by rma.py:choose_rma_tile), numbered
// card by card; each block of a launch (the grid the occupancy limit
// times the SM count, so every block is resident) owns the tiles tile0 +
// blockIdx.x + i*gridDim.x of its launch's cards for the whole launch and
// runs them in step order; the tile rule makes that one tile per block
// where it can (the first tile's place is worked out once per launch).
// Step s of a tile:
//   (a) wait until every tile of its dependency set has published epoch
//       >= s: one thread per dependency spins on ld.acquire.sys of that
//       tile's flag in its own card's flag array, then __syncthreads();
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
//       slot, each through its destination card's pointer (a peer store
//       where that card is another device): a source in its interior from
//       shared memory, a source no tile writes (a Dirichlet ghost a strip
//       carries) from the output slot of its own card, where it is a
//       constant;
//   (f) __syncthreads(), then one thread publishes epoch s+1 into its own
//       card's flag array and into that of every other card with a tile
//       that depends on it (rma.py:RmaTiles.pub), so that every wait polls
//       local memory: with such cards, one fence.acq_rel.sys and then a
//       relaxed system-scope store into each array (a release pattern);
//       without, st.release.gpu (its waiters share its device).
// The dependency set of a tile is every tile whose writes (interior or
// pairs) meet its window, and every tile whose window meets its writes:
// the first are the reads of step s+1 of what step s wrote, the second the
// writes of step s+1 into the slot step s read. The set is symmetric, so a
// tile never runs more than one step ahead of a neighbour and one wait
// per step covers both, across cards too. A launch opens with the
// exchange of its input slot (every pair of its tiles, read from that
// slot), a system-scope fence, one grid barrier, its only one, and a
// barrier across cards in place of JAX's neighbour barrier: the block of
// each card's first tile marks its arrival in the flag array of every
// card it exchanges with (rma.py:RmaTiles.peers), then every block waits
// for its cards' peers to arrive. The last step writes no pairs, since
// the plain version exchanges at the start of a step and leaves the result
// slot's ghosts as they were. No block waits on one that waits on it in a
// cycle: every block runs all its tiles of step s before any of step s+1,
// so the tile furthest behind, on whichever card, can always go on, as
// long as every card's launch runs. A wait that outlasts kSpinBound clocks
// traps, so a protocol fault fails the launch instead of hanging it.
//
// One code path. Virtual cards (groups of one launch on one device) and
// real cards (one launch per device, peer access enabled by the wrapper
// through rma_enable_peer) run the same instructions: every edge between
// two cards synchronises at system scope, every edge within a card at gpu
// scope or wider, on either kind of card. A plan of one card has no edge
// between cards and runs the gpu-scope publish of before. Each card's
// flags are zeroed by the wrapper on its stream before every card's
// launch.
//
// The read path. Every buffer is written inside this launch by other
// blocks, so no load may take the non-coherent path: no __restrict__ on
// the buffers and no __ldg (either lets nvcc emit ld.global.nc), and the
// L1, which is not coherent across SMs, is bypassed too. Every load of a
// buffer is __ldcg (cached in L2 only; a bf16 value is loaded as its 16
// bits). Stores are plain (the L1 writes through to L2). A tile loads
// only from its own card.
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
constexpr int kMaxCards = 16;  // rma.py:MAX_CARDS
constexpr int kGeomLen = 38 + kMaxCards + 1;  // rma.py:_geometry
constexpr int kSharedPerBlock = 232448;
constexpr int kErrArgument = -1;
constexpr int kErrCooperative = -2;
constexpr int kErrNoPeer = -3;
// A wait past this many SM clocks (about 4.3 s at 1.98 GHz) traps.
constexpr long long kSpinBound = 1LL << 33;

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
        s < kTraceSteps && tile == g.tile0 + (int)blockIdx.x) {         \
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
  int k, steps, slot0;
  int tile0, ntiles;           // this launch's tiles [tile0, tile0 + ntiles)
  int rank_tiles;              // tiles per rank
  int card0, card_end;         // this launch's cards
  int arrive;                  // a flag array's arrival slots: [arrive + c]
  int rank_first[kMaxCards + 1];  // card c's ranks: places [rank_first[c],
                                  // rank_first[c + 1]) of the rank order
  int p1, p2;                  // padded extents of d1 and d2
  int64_t block, per_rank;     // P0*P1*P2, nbuf*block
  int t[3], nt[3], h[3], kr[3], n[3], r[3];
  int pitch1, pitch2, wvol;    // window pitches and volume
  int box_off, nbox, q0;       // the boxes' byte offset in shared memory,
                               // their count, the launch's first rank place
  void* bufs[kMaxCards];       // each card's buffers
  int* flags[kMaxCards];       // each card's flags: the epoch of every
                               // tile, then one arrival per card
  const int32_t* boxes;        // [R][k][6] start0..2, size0..2
  const int32_t* pair_ptr;     // [ntiles + 1]
  const int32_t* pairs;        // [npairs][4] dst card, dst offset, src
                               // offset (its tile's card), window index
                               // or -1
  const int32_t* dep_ptr;      // [ntiles + 1]
  const int32_t* deps;
  const int32_t* pub_ptr;      // [ntiles + 1]
  const int32_t* pub;          // the other cards a tile publishes to
  const int32_t* peer_ptr;     // [ncards + 1]
  const int32_t* peers;        // the other cards a card exchanges with
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

// The flags' accesses. Every wait acquires at system scope. A publish to
// waiters on another card (another device, or a virtual card standing for
// one) is a release pattern at system scope: one fence, then a relaxed
// store into each flag array, each strong, so each a release (one
// st.release.sys per array would fence once per array). A publish whose
// waiters all share the tile's card releases at gpu scope, which holds
// every thread of its device. The choice follows the tile's publish list,
// the same for virtual and real cards.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void fence_sys() {
  asm volatile("fence.acq_rel.sys;" ::: "memory");
}

__device__ __forceinline__ void st_relaxed_sys(int* p, int v) {
  asm volatile("st.relaxed.sys.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void st_release_gpu(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Spin until *p >= v; trap once the wait passes kSpinBound clocks.
__device__ __forceinline__ void wait_for(const int* p, int v) {
  if (ld_acquire(p) >= v) return;
  const long long start = clock64();
  while (ld_acquire(p) < v) {
    __nanosleep(32);
    if (clock64() - start > kSpinBound) __trap();
  }
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

// A tile's place: its rank's place q in the rank order, its card and the
// rank's index among the card's, its interior [lo, hi) in padded
// coordinates, its dependencies', pairs' and publish list's ranges in the
// device table.
struct Tile {
  int q, card, local, lo[3], hi[3], dep_first, dep_end, pair_first,
      pair_end, pub_first, pub_end;
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
  tl.q = rest / g.nt[0];
  tl.card = g.card0;
  while (tl.q >= g.rank_first[tl.card + 1]) ++tl.card;
  tl.local = tl.q - g.rank_first[tl.card];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    tl.lo[d] = g.h[d] + j[d] * g.t[d];
    tl.hi[d] = min(tl.lo[d] + g.t[d], g.h[d] + g.n[d]);
  }
  tl.dep_first = g.dep_ptr[tile];
  tl.dep_end = g.dep_ptr[tile + 1];
  tl.pair_first = g.pair_ptr[tile];
  tl.pair_end = g.pair_ptr[tile + 1];
  tl.pub_first = g.pub_ptr[tile];
  tl.pub_end = g.pub_ptr[tile + 1];
  return tl;
}

// The tile's ghost-map pairs into slot offset `at` of their destination
// cards, each source in shared memory (`fin`, level k's copy) or in the
// same slot of the tile's own card.
template <typename T>
__device__ __forceinline__ void write_pairs(const Params& g, const Tile& tl,
                                            int64_t at, const T* fin) {
  const T* const own = static_cast<const T*>(g.bufs[tl.card]) + at;
  for (int i = tl.pair_first + threadIdx.x; i < tl.pair_end; i += kThreads) {
    const int32_t* q = g.pairs + 4 * (int64_t)i;
    static_cast<T*>(g.bufs[q[0]])[at + q[1]] =
        fin != nullptr && q[3] >= 0 ? fin[q[3]] : ld(own + q[2]);
  }
}

template <int NT, typename T>
__global__ void __launch_bounds__(kThreads, 1)
rma_iterate_kernel(const __grid_constant__ Params g,
                   const __grid_constant__ Taps taps) {
  extern __shared__ __align__(16) unsigned char shared[];
  T* const win0 = reinterpret_cast<T*>(shared);
  T* const win1 = win0 + g.wvol;
  int* const sbox = reinterpret_cast<int*>(shared + g.box_off);
  const int32_t* const boxes = g.boxes + (int64_t)g.q0 * g.k * 6;
  for (int i = threadIdx.x; i < g.nbox; i += kThreads) sbox[i] = boxes[i];
  // the opening exchange of the input slot: each tile's pairs, read from
  // that slot of its own card
  for (int tile = g.tile0 + blockIdx.x; tile < g.tile0 + g.ntiles;
       tile += gridDim.x)
    write_pairs<T>(g, tile_of(g, tile), (int64_t)g.slot0 * g.block,
                   nullptr);
  __syncthreads();
  if (threadIdx.x == 0) fence_sys();
  // the launch's one grid barrier, then the barrier across cards: the
  // block of each card's first tile marks the card's arrival in the flag
  // array of every card it exchanges with, and every block waits until
  // all of its cards' peers have arrived in its cards' own arrays
  cg::this_grid().sync();
  if (threadIdx.x == 0) {
    fence_sys();
    for (int c = g.card0; c < g.card_end; ++c) {
      if ((g.rank_first[c] * g.rank_tiles - g.tile0) % (int)gridDim.x !=
          (int)blockIdx.x)
        continue;
      for (int i = g.peer_ptr[c]; i < g.peer_ptr[c + 1]; ++i)
        st_relaxed_sys(g.flags[g.peers[i]] + g.arrive + c, 1);
    }
    for (int c = g.card0; c < g.card_end; ++c)
      for (int i = g.peer_ptr[c]; i < g.peer_ptr[c + 1]; ++i)
        wait_for(g.flags[c] + g.arrive + g.peers[i], 1);
  }
  __syncthreads();
  const T* const fin = (g.k & 1) ? win1 : win0;  // level k's copy
  // a block's first tile, its only one where the grid covers the tiles
  const Tile first = tile_of(g, g.tile0 + blockIdx.x);
  for (int s = 0; s < g.steps; ++s) {
    const int64_t in = (int64_t)((g.slot0 + s) & 1) * g.block;
    const int64_t out = g.block - in;
    const bool last = s == g.steps - 1;
    for (int tile = g.tile0 + blockIdx.x; tile < g.tile0 + g.ntiles;
         tile += gridDim.x) {
      const Tile tl =
          tile == g.tile0 + (int)blockIdx.x ? first : tile_of(g, tile);
      int* const flags = g.flags[tl.card];
      RMA_STAMP(0);
      // (a) wait for the dependencies' step s-1, on this card's flags
      for (int i = tl.dep_first + threadIdx.x; i < tl.dep_end;
           i += kThreads)
        wait_for(flags + g.deps[i], s);
      __syncthreads();
      RMA_STAMP(1);
      int wlo[3], whi[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        wlo[d] = tl.lo[d] - g.kr[d];
        whi[d] = tl.hi[d] + g.kr[d];
      }
      T* const base = static_cast<T*>(g.bufs[tl.card]) + tl.local * g.per_rank;
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
        const int* box = sbox + ((tl.q - g.q0) * g.k + t - 1) * 6;
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
        write_pairs<T>(g, tl, out, fin);
        __syncthreads();
      }
      RMA_STAMP(7);
      // (f) publish epoch s+1 once every store of the block is ordered
      if (threadIdx.x == 0) {
        if (tl.pub_end > tl.pub_first) {
          fence_sys();
          st_relaxed_sys(flags + tile, s + 1);
          for (int i = tl.pub_first; i < tl.pub_end; ++i)
            st_relaxed_sys(g.flags[g.pub[i]] + tile, s + 1);
        } else {
          st_release_gpu(flags + tile, s + 1);
        }
      }
      RMA_STAMP(8);
    }
  }
}

template <int NT, typename T>
int launch_nt(const Params& g, const Taps& taps, int shared, int device,
              cudaStream_t stream) {
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
  void* args[] = {&gp, &tp};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), args, shared, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Restores the calling thread's current device on leaving a host entry.
struct DeviceGuard {
  int prev = -1;
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

template <typename T>
int launch(void* const* bufs, int* const* flags, const int32_t* table,
           const int32_t* geom, int ngeom, const int32_t* tap_offsets,
           const int32_t* group_sizes, const float* group_weights, int ntaps,
           int ngroups, int uniform, float uniform_weight, int card0,
           int card_end, int device, void* stream) {
  if (ngeom != kGeomLen) return kErrArgument;
  Params g;
  const int ranks = geom[0], nbuf = geom[1];
  const int p0 = geom[2], p1 = geom[3], p2 = geom[4];
  g.k = geom[5];
  g.steps = geom[6];
  g.slot0 = geom[7];
  const int ntiles = geom[8];
  for (int d = 0; d < 3; ++d) {
    g.t[d] = geom[9 + d];
    g.nt[d] = geom[12 + d];
    g.h[d] = geom[15 + d];
    g.kr[d] = geom[18 + d];
    g.n[d] = geom[21 + d];
    g.r[d] = geom[24 + d];
  }
  const int npairs = geom[27], ndeps = geom[28], ncards = geom[33];
  if (ranks < 1 || nbuf < 2 || g.k < 1 || g.steps < 1 || (g.slot0 & ~1) ||
      p0 < 1 || p1 < 1 || p2 < 1 || npairs < 0 || ndeps < 0 || ncards < 1 ||
      ncards > kMaxCards || card0 < 0 || card0 >= card_end ||
      card_end > ncards)
    return kErrArgument;
  const int p[3] = {p0, p1, p2};
  int64_t rank_tiles = 1;
  for (int d = 0; d < 3; ++d) {
    if (g.t[d] < 1 || g.t[d] > g.n[d] || g.h[d] < g.kr[d] || g.kr[d] < 0 ||
        g.r[d] < 0 || (int64_t)g.k * g.r[d] > g.kr[d] ||
        p[d] != g.n[d] + 2 * g.h[d] ||
        g.nt[d] != (g.n[d] + g.t[d] - 1) / g.t[d])
      return kErrArgument;
    rank_tiles *= g.nt[d];
  }
  if (rank_tiles * ranks != ntiles) return kErrArgument;
  g.p1 = p1;
  g.p2 = p2;
  g.block = (int64_t)p0 * p1 * p2;
  g.per_rank = nbuf * g.block;
  for (int c = 0; c <= kMaxCards; ++c) g.rank_first[c] = geom[38 + c];
  if (g.rank_first[0] != 0 || g.rank_first[ncards] != ranks)
    return kErrArgument;
  for (int c = 0; c < ncards; ++c) {
    const int held = g.rank_first[c + 1] - g.rank_first[c];
    if (held < 1 || held * g.per_rank >= ((int64_t)1 << 31) || !bufs[c] ||
        !flags[c])
      return kErrArgument;
    g.bufs[c] = bufs[c];
    g.flags[c] = flags[c];
  }
  for (int c = ncards; c < kMaxCards; ++c) {
    g.bufs[c] = nullptr;
    g.flags[c] = nullptr;
  }
  g.card0 = card0;
  g.card_end = card_end;
  g.rank_tiles = (int)rank_tiles;
  g.q0 = g.rank_first[card0];
  g.tile0 = g.q0 * g.rank_tiles;
  g.ntiles = (g.rank_first[card_end] - g.q0) * g.rank_tiles;
  g.arrive = ntiles;
  const int pitch0 = g.t[0] + 2 * g.kr[0];
  g.pitch1 = g.t[1] + 2 * g.kr[1];
  g.pitch2 = g.t[2] + 2 * g.kr[2];
  const int64_t wvol = (int64_t)pitch0 * g.pitch1 * g.pitch2;
  g.box_off = (int)((2 * wvol * (int64_t)sizeof(T) + 15) / 16 * 16);
  g.nbox = (g.rank_first[card_end] - g.q0) * g.k * 6;
  const int64_t shared = g.box_off + 4 * (int64_t)g.nbox;
  if (shared > kSharedPerBlock) return kErrArgument;
  g.wvol = (int)wvol;
  g.boxes = table;
  g.pair_ptr = table + geom[29];
  g.pairs = table + geom[30];
  g.dep_ptr = table + geom[31];
  g.deps = table + geom[32];
  g.pub_ptr = table + geom[34];
  g.pub = table + geom[35];
  g.peer_ptr = table + geom[36];
  g.peers = table + geom[37];

  Taps taps;
  if (!stencil::fill_groups(taps, group_sizes, group_weights, ntaps,
                            ngroups, uniform, uniform_weight))
    return kErrArgument;
  for (int i = 0; i < ntaps; ++i) {
    const int d0 = tap_offsets[3 * i], d1 = tap_offsets[3 * i + 1],
              d2 = tap_offsets[3 * i + 2];
    taps.off[i] = (d0 * g.pitch1 + d1) * g.pitch2 + d2;
  }

  DeviceGuard guard;
  cudaError_t err = cudaGetDevice(&guard.prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int sh = (int)shared;
  if (uniform && ngroups == 1) {
    switch (ntaps) {
      case 4:  // jacobi5
        return launch_nt<4, T>(g, taps, sh, device, st);
      case 6:  // jacobi7
        return launch_nt<6, T>(g, taps, sh, device, st);
      case 8:  // jacobi9
        return launch_nt<8, T>(g, taps, sh, device, st);
      case 12:  // star3d_r2
        return launch_nt<12, T>(g, taps, sh, device, st);
      case 26:  // jacobi27, box3d_r1
        return launch_nt<26, T>(g, taps, sh, device, st);
      default:
        break;
    }
  }
  return launch_nt<0, T>(g, taps, sh, device, st);
}

}  // namespace

extern "C" {

// Launch `steps` outer steps of the tiles of cards [card0, card_end) on
// `stream` (a cudaStream_t, 0 = the legacy default stream) of device
// `device`, as one cooperative launch. `bufs` and `flags` are host arrays
// of one device pointer per card (geom[33] cards): card c's buffers
// float32[R_c][nbuf][P0][P1][P2] and its flags int32[ntiles + ncards],
// zeroed by the caller before any card's launch (every tile's epoch, then
// one arrival per card); on real cards each on its own device, with peer
// access enabled between the cards that exchange (rma_enable_peer), and
// one launch per card, all issued before any is waited on. `table`
// (device, int32, rma.py:device_table) holds the update boxes [R][k][6],
// the pair, dependency and publish lists of each tile and the peers of
// each card. `geom` is int32[kGeomLen] (host, rma.py:_geometry): R nbuf P0
// P1 P2 k steps slot0 ntiles; per dim the tile, the tile grid, the
// layout's halo, k*r, the interior extent, the radius; the pair and
// dependency counts; the offsets in `table` of the pair pointers, the
// pairs, the dependency pointers, the dependencies; the card count; the
// offsets of the publish pointers, the publish lists, the peer pointers,
// the peers; each card's first rank place (kMaxCards + 1 values).
// `tap_offsets` is int32[ntaps * 3] in group order, `group_sizes`
// int32[ngroups], `group_weights` float[ngroups]. Host arrays are copied
// before the launch returns; the caller's current device is restored.
// Returns 0, a CUDA error code, or a negative code (see
// rma_iterate_error).
int rma_iterate_f32(void* const* bufs, int* const* flags,
                    const int32_t* table, const int32_t* geom, int ngeom,
                    const int32_t* tap_offsets, const int32_t* group_sizes,
                    const float* group_weights, int ntaps, int ngroups,
                    int uniform, float uniform_weight, int card0,
                    int card_end, int device, void* stream) {
  return launch<float>(bufs, flags, table, geom, ngeom, tap_offsets,
                       group_sizes, group_weights, ntaps, ngroups, uniform,
                       uniform_weight, card0, card_end, device, stream);
}

// The same in bf16: the buffers hold __nv_bfloat16; the weights stay fp32,
// each a bf16 value.
int rma_iterate_bf16(void* const* bufs, int* const* flags,
                     const int32_t* table, const int32_t* geom, int ngeom,
                     const int32_t* tap_offsets, const int32_t* group_sizes,
                     const float* group_weights, int ntaps, int ngroups,
                     int uniform, float uniform_weight, int card0,
                     int card_end, int device, void* stream) {
  return launch<__nv_bfloat16>(bufs, flags, table, geom, ngeom, tap_offsets,
                               group_sizes, group_weights, ntaps, ngroups,
                               uniform, uniform_weight, card0, card_end,
                               device, stream);
}

// Let `device` load from and store into the memory of `peer`: 0 (also
// where the access was already on), kErrNoPeer where
// cudaDeviceCanAccessPeer says no, or a CUDA error code. The caller's
// current device is restored.
int rma_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return kErrNoPeer;
  DeviceGuard guard;
  err = cudaGetDevice(&guard.prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // not sticky: clear it
    return 0;
  }
  return (int)err;
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
  if (code == kErrNoPeer) return "the device cannot access its peer's memory";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
