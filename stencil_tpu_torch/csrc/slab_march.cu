// k temporally blocked sweeps of a linear stencil over a deep-halo 2D
// fp32 or bf16 grid, in one launch, marching d0 through one ring of rows
// per sweep. Hand-written for Hopper (sm_90a).
//
// Replaces stencil_tpu/ops/pallas.py:build_sweep (the Pallas TPU slab
// kernel, :280, pallas_call at :675) on 2D grids, as slab_sweep.cu does:
// its homogeneous mode, its source mode (has_source, :586-591), its
// lead-dim pins (:564-575), in fp32 and bf16 (:292). slab_sweep.cu is the
// other schedule of the same kernel (the window); the plan (ops/slab.py,
// schedule "march" or "window") picks one. Wrapper and plain PyTorch
// version: stencil_tpu_torch/ops/slab_kernel.py,
// ops/sweep_kernel.py:sweep_reference.
//
// What it computes: exactly what slab_sweep.cu computes (see its header),
// bitwise: `in` and `out` are padded (n0+2H, n1+2H) T arrays with H >=
// k*r; `out` receives k sweeps of the stencil applied to `in` on its
// interior points only, each update the taps in StencilSpec.weight_groups
// order (stencil_taps.cuh, -fmad=false) and, in the source mode, + the
// padded source at the point. A point inside the grid gets the full
// update; a pinned ghost copies its constant; a row beyond a live d0 face
// (pins 0) is updated like the interior; d1 is always pinned (a periodic
// or Neumann d1 runs at k = 1); the ghosts of `out` are never written.
//
// What bounds it on this card. By the roofline rule (each input read
// once, each output written once) k sweeps in one launch are bound by
// bytes, at 512^2 k=16 by ~0.7 us and at 4096^2 k=4 by ~0.04 ms, far
// below what either schedule reaches: both are bound by issue and latency
// on shared memory. The window schedule loads its whole (t0+2kr) x
// (t1+2kr) window before its first sweep and runs k shrinking sweeps
// behind k barriers; its 2D windows recompute 1.1-1.9x. This kernel
// streams rows instead:
//
//   - Blocks. Each block owns one strip of t1 columns of d1 and one chunk
//     of t0 rows of d0 (the plan's tiles; the last strip and the last
//     chunk of a ragged dim start early, clamped at n - t, as in
//     slab_sweep.cu), and walks the padded rows of d0 from chunk start -
//     k*r to chunk end + k*r. Only d1 shrinks with the level: a chunk of
//     t0 rows recomputes 2(k-s)r rows per level s.
//   - Rings. Sweep level s (0 = the input, 1 .. k-1 the intermediate
//     sweeps) keeps a ring of S = 2r+1+kAhead rows in shared memory.
//     Level s computes a row once the 2r+1 rows of level s-1 that it reads
//     are complete; level k stores straight to `out`.
//   - Order. Level s runs L_s = s(r+1) - 1 steps behind the input (input
//     row m is complete in step m), so a step reads only rows completed in
//     earlier steps: one __syncthreads per step for all levels together.
//     Row m of level s lives in slot (m + L_{s+1}) mod S (tiled_march.cu's
//     rule), so at step j every level reads slots j-r .. j+r and writes
//     slot j+r+1: one table of tap offsets per step serves every level.
//     The slots of one index hold every level's row, one after the other.
//   - Threads. One thread per column of the input row (t1 + 2kr, in whole
//     warps): every level's row is held in the input row's columns, so a
//     thread computes the same column at every level, its taps at the same
//     offsets, its d1 test once for the launch. The edge columns a level
//     no longer needs compute garbage into their own slots, which no valid
//     point reads (64 elements before and after the rings take their
//     taps). A block of G groups of such threads, each group every G-th
//     level, shortens the chain of levels per thread where k is deep;
//     a thread computes kBatch of its levels at a time, their shared loads
//     issued before any store.
//   - Loads. Input row m is issued kAhead steps before its first use, with
//     cp.async 4-byte copies (a commit group per step, waited for down to
//     kAhead-1 pending groups before the step's barrier), so its latency
//     overlaps kAhead steps of compute; level 0's slots j+r+1 .. j+r+kAhead
//     hold the rows in flight, which is why the rings are 2r+1+kAhead deep
//     (2r+2 would take one step ahead). In bf16 a row's start may be 2-
//     byte aligned: the row is copied as aligned 4-byte words and stored
//     shifted by one element where needed. The shift is one per block: S
//     is even and a slot holds Q elements with Q = p1 (mod 2), so a row's
//     global parity and its slot's parity change together. A word past the
//     end of the array (the last row of an odd-sized array) is copied as
//     one 2-byte load. In the source mode source row m comes in the same
//     commit group, into slot m mod D of its own ring (shifted by its own
//     parity in bf16), and every level reads it there, not from global
//     memory k times.
//   - Taps. A spec of one weight group under a uniform weight sums its
//     taps in table order and multiplies once (bitwise apply_fixed,
//     without its run-time group tests). The common ones (jacobi5 and
//     star2d_r1, jacobi9, star2d_r2: Pattern<P>) have their offsets
//     compiled in, so the taps of one row share an address and take their
//     d1 as an immediate (jacobi9's launch at 4096^2 k=4 ~17% faster than
//     with the offsets in registers); other uniform specs take one add and
//     one shared load per tap; the rest stencil_taps.cuh.
//
// Shared memory: (S * Q + 128) * sizeof(T), Q = k * (cols + 4) [+1 in
// bf16 to give Q the parity of p1], cols = t1 + 2kr in whole warps; the
// source mode adds a ring of D = k(r+1) + kAhead source rows, each
// cols + 2 wide, which every level reads at its own row
// (ops/slab.py:slab_march_smem_bytes mirrors it).

#include <cuda_runtime.h>

#include <cstdint>

#include "stencil_taps.cuh"

namespace {

using stencil::add;
using stencil::apply_fixed;
using stencil::close_group;
using stencil::mul;
using stencil::Num;
using stencil::Taps;

constexpr int kMaxThreads = 1024;  // one thread per column of a block
// the levels a thread computes together, their loads before any store
constexpr int kBatch = 4;
// a block has G groups of one thread per column, each computing every
// G-th level: G the most that keep the block within 256 threads and give
// every group kBatch levels (at least 1)
constexpr int kGroupThreads = 256;
constexpr int kAhead = 3;  // input rows in flight (odd: S stays even)
constexpr int kGeomLen = 13;
constexpr int kMaxLevels = 32;  // sweeps per launch
constexpr int kFront = 64;      // elements before and after the rings,
constexpr int kSlack = 64;      // which the edge columns' taps read
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB per block on sm_90
constexpr int kErrArgument = -1;
constexpr int kErrShared = -2;

struct Geometry {
  int n0, n1;      // interior extents
  int p1;          // padded extent of d1 (the row stride)
  int halo;        // pad depth H
  int t0, t1;      // d0 chunk, d1 strip
  int nt1;         // strips along d1
  int k, r;        // sweeps per launch, stencil radius
  int slots;       // ring depth S = 2r+1+kAhead
  int planes;      // input rows a block walks, t0 + 2kr
  int q;           // elements of one slot index, every level's row
  int pitch;       // W: level s >= 1's row starts at s*W in a slot
  int cols;        // threads of a group, one per column: t1 + 2kr, whole
                   // warps
  int groups;      // G: groups of threads, each computing every G-th level
  int sdepth;      // D: source rows in flight or in use, k(r+1) + kAhead
  int spitch;      // a source row's slot: cols + 2 (even)
  int pin_lo, pin_hi;  // the d0 faces: 1 pinned, 0 live
  int64_t total;   // elements of the padded array
};

// The d0 offset of each tap (its d1 offset rides in Taps::off).
struct TapRows {
  signed char d0[stencil::kMaxTaps];
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(saddr),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One element of shared memory at byte address `a` (a shared-window
// address), as float.
template <typename T>
__device__ __forceinline__ float lds(uint32_t a) {
  if constexpr (sizeof(T) == 4) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
    return v;
  } else {
    unsigned short b;
    asm volatile("ld.shared.u16 %0, [%1];" : "=h"(b) : "r"(a));
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
}

// Offset, in elements, from slot c to the slot of d0 offset d (mod S).
__device__ __forceinline__ int slot_delta(int c, int d, int S, int Q) {
  int x = c + d;
  x += x < 0 ? S : 0;
  x -= x >= S ? S : 0;
  return (x - c) * Q;
}

// Any tap count: apply_taps' order (stencil_taps.cuh), each offset formed
// from the tap's (d0, d1) at the point.
template <typename T>
__device__ __forceinline__ float taps_any(const T* __restrict__ s, int p,
                                          const Taps& taps,
                                          const TapRows& tr, int c, int S,
                                          int Q) {
  float acc = 0.0f;
  int t = 0;
  for (int g = 0; g < taps.ngroups; ++g) {
    const int end = taps.group_end[g];
    float gacc = Num<T>::load(
        s[p + slot_delta(c, tr.d0[t], S, Q) + taps.off[t]]);
    for (++t; t < end; ++t)
      gacc = add<T>(gacc, Num<T>::load(
          s[p + slot_delta(c, tr.d0[t], S, Q) + taps.off[t]]));
    acc = close_group<T>(acc, gacc, g, taps);
  }
  return taps.uniform ? mul<T>(acc, taps.uniform_weight) : acc;
}

// One group of NT taps under one uniform weight (jacobi5, jacobi9,
// star2d_r1, star2d_r2): the taps summed in table order, then one
// multiply, which is what apply_fixed computes for such a table, without
// its run-time group tests. `a` is the point's shared byte address and
// `off` holds the taps' byte offsets from it, so each tap's address is one
// add.
template <int NT, typename T>
__device__ __forceinline__ float apply_uniform(uint32_t a,
                                               const int (&off)[NT],
                                               float weight) {
  float v[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) v[t] = lds<T>(a + off[t]);
  float acc = v[0];
#pragma unroll
  for (int t = 1; t < NT; ++t) acc = add<T>(acc, v[t]);
  return mul<T>(acc, weight);
}

// The tap offsets of the common specs, in table order (StencilSpec.
// weight_groups): P = 2 jacobi5 and star2d_r1, 3 jacobi9, 4 star2d_r2.
template <int P>
struct Pattern;
template <>
struct Pattern<2> {
  static constexpr int n = 4;
  __host__ __device__ static constexpr int d0(int t) {
    return t == 0 ? -1 : t == 1 ? 1 : 0;
  }
  __host__ __device__ static constexpr int d1(int t) {
    return t == 2 ? -1 : t == 3 ? 1 : 0;
  }
};
template <>
struct Pattern<3> {
  static constexpr int n = 8;
  __host__ __device__ static constexpr int d0(int t) {
    return t == 0 || t == 4 || t == 5 ? -1 : t == 2 || t == 3 ? 0 : 1;
  }
  __host__ __device__ static constexpr int d1(int t) {
    return t == 0 || t == 1 ? 0 : t == 2 || t == 4 || t == 6 ? -1 : 1;
  }
};
template <>
struct Pattern<4> {
  static constexpr int n = 8;
  __host__ __device__ static constexpr int d0(int t) {
    return t == 0 ? -1 : t == 1 ? -2 : t == 2 ? 1 : t == 3 ? 2 : 0;
  }
  __host__ __device__ static constexpr int d1(int t) {
    return t < 4 ? 0 : t == 4 ? -1 : t == 5 ? -2 : t == 6 ? 1 : 2;
  }
};

// A common spec's taps at point p, summed as apply_uniform sums them; `sd`
// holds this step's slot offsets of the rows d0 = -2 .. 2 away, so the
// taps of one row share an address and their d1 is an immediate.
template <int P, typename T>
__device__ __forceinline__ float apply_pattern(const T* __restrict__ p,
                                               const int (&sd)[5],
                                               float weight) {
  using Pt = Pattern<P>;
  float v[Pt::n];
#pragma unroll
  for (int t = 0; t < Pt::n; ++t)
    v[t] = Num<T>::load(p[sd[Pt::d0(t) + 2] + Pt::d1(t)]);
  float acc = v[0];
#pragma unroll
  for (int t = 1; t < Pt::n; ++t) acc = add<T>(acc, v[t]);
  return mul<T>(acc, weight);
}

// The taps at point p of level s-1's ring: NT > 0 with this step's
// offsets `off`, NT == 0 through the table.
template <int NT, typename T>
__device__ __forceinline__ float tap_sum(const T* __restrict__ src, int p,
                                         const int (&off)[NT > 0 ? NT : 1],
                                         const Taps& taps,
                                         const TapRows& tr, int c, int S,
                                         int Q) {
  if constexpr (NT > 0) {
    return apply_fixed<NT, T>(src, p, off, taps);
  } else {
    return taps_any<T>(src, p, taps, tr, c, S, Q);
  }
}

// NT > 0: a spec of exactly NT taps, offsets in registers; NT == 0: any
// spec. TAPS: 0 through the group table, 1 one group under a uniform
// weight (apply_uniform), P >= 2 a common spec's (apply_pattern). SRC:
// every update (live ghost rows included) adds the padded source at its
// point. T: float or bf16. One thread per column of the block's input
// row.
template <int NT, int TAPS, bool SRC, typename T>
__global__ void __launch_bounds__(kMaxThreads)
slab_march_kernel(const T* __restrict__ in, T* __restrict__ out,
                  const T* __restrict__ source,
                  const __grid_constant__ Geometry g,
                  const __grid_constant__ Taps taps,
                  const __grid_constant__ TapRows tr) {
  using N = Num<T>;
  constexpr bool kWords = sizeof(T) == 2;  // bf16: rows copied as words
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* const ring = reinterpret_cast<T*>(smem_bytes) + kFront;
  // this thread's column (level 0's coordinates) and its group of levels
  const int X = threadIdx.x % g.cols, grp = threadIdx.x / g.cols;
  const int nth = blockDim.x;

  const int i1 = blockIdx.x % g.nt1;
  const int i0 = blockIdx.x / g.nt1;
  const int k = g.k, r = g.r, S = g.slots, Q = g.q, W = g.pitch;
  const int kr = k * r;
  // padded origin of the input region: clamped start - k*r + H
  const int a0 = min(i0 * g.t0, g.n0 - g.t0) + g.halo - kr;
  const int o1 = min(i1 * g.t1, g.n1 - g.t1) + g.halo - kr;
  const int w0 = g.t1 + 2 * kr;
  // where element 0 of an input row sits in level 0's region of its slot:
  // bf16, 1 + the block's shift, so that aligned global words land on
  // aligned shared words (row m in slot (m + r) mod S, see the header)
  const int base0 = kWords
      ? 1 + (((a0 & g.p1) ^ o1 ^ (r & Q) ^ 1) & 1) : 0;

  // copy row m of the padded array `a` (w0 elements from column o1) to
  // shared memory, element 0 at `dst`; in bf16 `dst` has the parity of the
  // row's global start, so whole aligned words go across
  auto copy_row = [&](const T* __restrict__ a, int m, T* dst) {
    const int64_t e0 = (int64_t)(a0 + m) * g.p1 + o1;
    if constexpr (!kWords) {
      for (int x = threadIdx.x; x < w0; x += nth)
        cp_async4(dst + x, a + e0 + x);
    } else {
      const int odd = (int)(e0 & 1);
      const int64_t first = e0 - odd;  // the first word's element
      const int nwords = (w0 + odd + 1) >> 1;
      uint32_t* const sw = reinterpret_cast<uint32_t*>(dst - odd);
      const uint32_t* const gw = reinterpret_cast<const uint32_t*>(a + first);
      for (int i = threadIdx.x; i < nwords; i += nth) {
        if (first + 2 * i + 1 < g.total) {
          cp_async4(sw + i, gw + i);
        } else {  // the array's last element, alone in its word
          (dst - odd)[2 * i] = a[first + 2 * i];
        }
      }
    }
  };
  // bf16: the parity of row m's global start (a source row's shift)
  auto row_odd = [&](int m) -> int {
    return kWords ? (((a0 + m) & g.p1) ^ o1) & 1 : 0;
  };
  // the source mode: source row m in slot m mod D of its own ring, at
  // shift row_odd(m) from the slot's (even) start
  T* const sring = ring + g.slots * Q + kSlack;
  // issue input row m into its slot (and source row m into its own) as
  // one commit group per call
  auto fetch = [&](int m, int slot, int sslot) {
    if (m < g.planes) {
      copy_row(in, m, ring + slot * Q + base0);
      if constexpr (SRC)
        copy_row(source, m, sring + sslot * g.spitch + row_odd(m));
    }
    cp_async_commit();
  };

  // the rows a sweep updates, padded: the grid's interior, widened to the
  // region's edge at a live face; this thread's column is inside the grid
  // in d1 (d1 is always pinned) and, at level k, inside the tile
  const int lo0 = g.pin_lo ? g.halo : -0x40000000;
  const int hi0 = g.pin_hi ? g.halo + g.n0 : 0x40000000;
  const bool col_in = o1 + X >= g.halo && o1 + X < g.halo + g.n1;
  const bool col_tile = X >= kr && X < kr + g.t1;
  // this thread's column in a level's row, and in the padded array
  const T* __restrict__ const col = ring + X;
  const uint32_t col_s = (uint32_t)__cvta_generic_to_shared(col);
  const uint32_t scol_s = (uint32_t)__cvta_generic_to_shared(sring + X);
  const int64_t gcol = o1 + X;

  // prologue: input rows 0 .. kAhead-1 in flight, row 0 complete
#pragma unroll
  for (int m = 0; m < kAhead; ++m) fetch(m, (m + r) % S, m % g.sdepth);
  cp_async_wait<kAhead - 1>();
  __syncthreads();

  const int last = g.t0 + kr - 1 + k * (r + 1) - 1;  // level k's last step
  int c = 0;                       // j mod S: every level's centre slot
  int wf = (kAhead + r) % S;       // the slot of input row j + kAhead
  int sf = kAhead % g.sdepth;      // its source row's slot
  int jd = 0;                      // j mod D (the source ring)
  int s_hi = 0, next_hi = 2 * r;   // the highest active level, its step
  for (int j = 0; j <= last; ++j) {
    int w = c + r + 1;
    w -= w >= S ? S : 0;
    fetch(j + kAhead, wf, sf);
    // this step's offset of each tap from the centre row: slot delta + d1
    // (TAPS 1: in bytes); a common spec's, of each row d0 = -2 .. 2
    constexpr bool UNI = TAPS == 1;
    int off[NT > 0 ? NT : 1];
    int sd[5];
    if constexpr (TAPS >= 2) {
#pragma unroll
      for (int d = -2; d <= 2; ++d) sd[d + 2] = slot_delta(c, d, S, Q);
    } else if constexpr (NT > 0) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
        off[t] = (slot_delta(c, tr.d0[t], S, Q) + taps.off[t])
            * (UNI ? (int)sizeof(T) : 1);
    }
    // the active levels: row m_s = j - L_s in [s*r, planes - s*r)
    if (j == next_hi && s_hi < k) {
      ++s_hi;
      next_hi += 2 * r + 1;
    }
    const int s_lo = max(1, j + 2 - g.planes);

    // level s's value at this thread's column: the update where the point
    // is inside the grid or beyond a live face, else its centre
    auto point = [&](int s) -> float {
      const int at = c * Q + (s == 1 ? base0 : (s - 1) * W);
      const T* __restrict__ const src = col + at;
      const int p0 = a0 + j - s * (r + 1) + 1;
      float v;
      if constexpr (TAPS >= 2) {
        v = apply_pattern<TAPS, T>(src, sd, taps.uniform_weight);
      } else if constexpr (NT > 0 && UNI) {
        v = apply_uniform<NT, T>(col_s + (uint32_t)(at * (int)sizeof(T)),
                                 off, taps.uniform_weight);
      } else {
        v = tap_sum<NT, T>(src, 0, off, taps, tr, c, S, Q);
      }
      const bool upd = col_in && p0 >= lo0 && p0 < hi0;
      if constexpr (SRC) {
        // source row m_s = j - L_s, read from its ring at this column
        int ss = jd - s * (r + 1) + 1;
        ss += ss < 0 ? g.sdepth : 0;
        if (upd)
          v = add<T>(v, lds<T>(scol_s + (uint32_t)(
              (ss * g.spitch + row_odd(p0 - a0)) * (int)sizeof(T))));
      }
      return upd ? v : N::load(src[0]);
    };
    // level s's row in slot w, or at level k the tile in `out`
    auto put = [&](int s, float v) {
      if (s < k) {
        ring[w * Q + s * W + X] = N::store(v);
      } else if (col_tile) {
        out[(int64_t)(a0 + j - k * (r + 1) + 1) * g.p1 + gcol] =
            N::store(v);
      }
    };
    // this thread's levels: s = grp+1 (mod G), B at a time, their rows'
    // loads before any store
    constexpr int B = kBatch;
    const int G = g.groups;
    int s = s_lo + (grp - (s_lo - 1) % G + G) % G;
    for (; s + (B - 1) * G <= s_hi; s += B * G) {
      float v[B];
#pragma unroll
      for (int b = 0; b < B; ++b) v[b] = point(s + b * G);
#pragma unroll
      for (int b = 0; b < B; ++b) put(s + b * G, v[b]);
    }
    for (; s <= s_hi; s += G) put(s, point(s));
    cp_async_wait<kAhead - 1>();
    __syncthreads();
    c = c + 1 == S ? 0 : c + 1;
    wf = wf + 1 == S ? 0 : wf + 1;
    sf = sf + 1 == g.sdepth ? 0 : sf + 1;
    jd = jd + 1 == g.sdepth ? 0 : jd + 1;
  }
}

template <typename T>
struct Launch {
  const T* in;
  T* out;
  const T* source;
  Geometry g;
  unsigned nblocks;
  unsigned nthreads;
  size_t shared;
  cudaStream_t stream;
};

template <int NT, int TAPS, bool SRC, typename T>
cudaError_t launch(const Launch<T>& l, const Taps& taps, const TapRows& tr) {
  cudaError_t err = cudaFuncSetAttribute(
      slab_march_kernel<NT, TAPS, SRC, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.shared);
  if (err != cudaSuccess) return err;
  slab_march_kernel<NT, TAPS, SRC, T><<<l.nblocks, l.nthreads, l.shared,
                                        l.stream>>>(l.in, l.out, l.source,
                                                    l.g, taps, tr);
  return cudaGetLastError();
}

// Whether the tap table (offsets in group order) is Pattern<P>'s.
template <int P>
bool is_pattern(const int32_t* tap_offsets, int ntaps) {
  if (ntaps != Pattern<P>::n) return false;
  for (int t = 0; t < ntaps; ++t)
    if (tap_offsets[2 * t] != Pattern<P>::d0(t) ||
        tap_offsets[2 * t + 1] != Pattern<P>::d1(t))
      return false;
  return true;
}

template <bool SRC, typename T>
cudaError_t dispatch(int ntaps, const int32_t* tap_offsets,
                     const Launch<T>& l, const Taps& taps,
                     const TapRows& tr) {
  const bool uni = taps.uniform && taps.ngroups == 1;
  switch (ntaps) {
    case 4:  // jacobi5, star2d_r1 (Poisson)
      if (uni && is_pattern<2>(tap_offsets, ntaps))
        return launch<4, 2, SRC>(l, taps, tr);
      return uni ? launch<4, 1, SRC>(l, taps, tr)
                 : launch<4, 0, SRC>(l, taps, tr);
    case 8:  // jacobi9, star2d_r2 (uniform); laplace2d_ho
      if (uni && is_pattern<3>(tap_offsets, ntaps))
        return launch<8, 3, SRC>(l, taps, tr);
      if (uni && is_pattern<4>(tap_offsets, ntaps))
        return launch<8, 4, SRC>(l, taps, tr);
      return uni ? launch<8, 1, SRC>(l, taps, tr)
                 : launch<8, 0, SRC>(l, taps, tr);
    default:
      return launch<0, 0, SRC>(l, taps, tr);
  }
}

// The entry's body for either element type (see stencil_slab_march).
template <typename T>
int march_entry(const T* in, T* out, const T* source, const int32_t* geom,
                int ngeom, const int32_t* tap_offsets,
                const int32_t* group_sizes, const float* group_weights,
                int ntaps, int ngroups, int uniform, float uniform_weight,
                int device, void* stream) {
  if (ngeom != kGeomLen) return kErrArgument;
  const int n0 = geom[0], n1 = geom[1];
  const int p0 = geom[2], p1 = geom[3], halo = geom[4];
  const int t0 = geom[5], t1 = geom[6];
  const int nt0 = geom[7], nt1 = geom[8];
  const int k = geom[9], r = geom[10];
  const int pin_lo = geom[11], pin_hi = geom[12];
  if (k < 1 || k > kMaxLevels || r < 1 || r > 64 || (int64_t)k * r > halo)
    return kErrArgument;
  if ((pin_lo != 0 && pin_lo != 1) || (pin_hi != 0 && pin_hi != 1))
    return kErrArgument;
  if (p0 != n0 + 2 * halo || p1 != n1 + 2 * halo) return kErrArgument;
  if (t0 < 1 || t0 > n0 || t1 < 1 || t1 > n1) return kErrArgument;
  if (nt0 != (n0 + t0 - 1) / t0 || nt1 != (n1 + t1 - 1) / t1)
    return kErrArgument;
  const int64_t nblocks = (int64_t)nt0 * nt1;
  if (nblocks > 0x7fffffff) return kErrArgument;
  // bf16 rows are copied as 4-byte words from a 4-byte aligned array
  if (sizeof(T) == 2 && ((uintptr_t)in & 3) != 0) return kErrArgument;

  Launch<T> l;
  Geometry& g = l.g;
  g.n0 = n0; g.n1 = n1;
  g.p1 = p1; g.halo = halo;
  g.t0 = t0; g.t1 = t1;
  g.nt1 = nt1;
  g.k = k; g.r = r;
  g.slots = 2 * r + 1 + kAhead;
  g.planes = t0 + 2 * k * r;
  g.pin_lo = pin_lo; g.pin_hi = pin_hi;
  g.total = (int64_t)p0 * p1;
  const int64_t w0 = t1 + 2 * (int64_t)k * r;
  // one thread per column of the input row, rounded up to whole warps;
  // every level's row is W = threads + 4 wide in a slot (level 0's holds
  // the input row and, in bf16, its word copies' spill)
  if (w0 > kMaxThreads) return kErrArgument;
  g.cols = (int)((w0 + 31) / 32 * 32);
  g.groups = kGroupThreads / g.cols < k / kBatch ? kGroupThreads / g.cols
                                                 : k / kBatch;
  if (g.groups < 1) g.groups = 1;
  l.nthreads = (unsigned)(g.cols * g.groups);
  g.pitch = g.cols + 4;
  int64_t q = (int64_t)k * g.pitch;
  if (sizeof(T) == 2 && ((q ^ p1) & 1)) ++q;  // Q = p1 (mod 2)
  if (q > 0x7fffffff / g.slots) return kErrShared;
  g.q = (int)q;
  g.sdepth = k * (r + 1) + kAhead;
  g.spitch = g.cols + 2;
  l.shared = ((size_t)g.slots * q + kFront + kSlack
              + (source ? (size_t)g.sdepth * g.spitch : 0)) * sizeof(T);
  if (l.shared > kMaxSharedBytes) return kErrShared;
  l.nblocks = (unsigned)nblocks;

  Taps taps;
  TapRows tr;
  if (!stencil::fill_groups(taps, group_sizes, group_weights, ntaps,
                            ngroups, uniform, uniform_weight))
    return kErrArgument;
  for (int i = 0; i < ntaps; ++i) {
    const int d0 = tap_offsets[2 * i], d1 = tap_offsets[2 * i + 1];
    if (d0 < -r || d0 > r || d1 < -r || d1 > r) return kErrArgument;
    tr.d0[i] = (signed char)d0;
    taps.off[i] = d1;
  }

  l.in = in; l.out = out; l.source = source;
  l.stream = (cudaStream_t)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return source ? (int)dispatch<true>(ntaps, tap_offsets, l, taps, tr)
                : (int)dispatch<false>(ntaps, tap_offsets, l, taps, tr);
}

}  // namespace

extern "C" {

// Launch k sweeps on `stream` (a cudaStream_t, 0 = the legacy default
// stream) of device `device`, marching d0. The arguments are those of
// stencil_slab_sweep (slab_sweep.cu): `source` null or the padded
// pre-scaled source; `geom` int32[13] = n0 n1 p0 p1 halo t0 t1 nt0 nt1 k r
// and the pins of the d0 lo and hi faces, t0 being the d0 chunk; the tap
// table in group order (host). Returns 0, a CUDA error code
// (cudaGetLastError after the launch), or a negative code for a rejected
// argument (see stencil_slab_march_error).
int stencil_slab_march(const float* in, float* out, const float* source,
                       const int32_t* geom, int ngeom,
                       const int32_t* tap_offsets,
                       const int32_t* group_sizes,
                       const float* group_weights, int ntaps, int ngroups,
                       int uniform, float uniform_weight, int device,
                       void* stream) {
  return march_entry(in, out, source, geom, ngeom, tap_offsets, group_sizes,
                     group_weights, ntaps, ngroups, uniform, uniform_weight,
                     device, stream);
}

// The same in bf16: `in`, `out` and `source` hold __nv_bfloat16 (`in`
// 4-byte aligned); the weights stay fp32, each a bf16 value.
int stencil_slab_march_bf16(const __nv_bfloat16* in, __nv_bfloat16* out,
                            const __nv_bfloat16* source, const int32_t* geom,
                            int ngeom, const int32_t* tap_offsets,
                            const int32_t* group_sizes,
                            const float* group_weights, int ntaps,
                            int ngroups, int uniform, float uniform_weight,
                            int device, void* stream) {
  return march_entry(in, out, source, geom, ngeom, tap_offsets, group_sizes,
                     group_weights, ntaps, ngroups, uniform, uniform_weight,
                     device, stream);
}

const char* stencil_slab_march_error(int code) {
  if (code == kErrArgument) return "rejected geometry or tap table";
  if (code == kErrShared)
    return "rings exceed 232448 bytes of shared memory";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
