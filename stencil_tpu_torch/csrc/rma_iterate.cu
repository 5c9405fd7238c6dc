// n outer steps of a halo exchange and k sweeps, for every rank of a mesh
// whose ranks share one card, in one cooperative launch. Hand-written for
// Hopper (sm_90a), float32 or bfloat16.
//
// Replaces stencil_tpu/parallel/rma.py:build_rma_iterate (the Pallas TPU
// kernel, pallas_call at :746) on Dirichlet, periodic and Neumann walls.
// Wrapper, tables and plain PyTorch version: stencil_tpu_torch/parallel/
// rma.py.
//
// What it computes. `bufs` holds R ranks' padded blocks, nbuf each
// (T[R][nbuf][P0][P1][P2]; a 2D grid comes with P0 = 1): buffers 0 and 1
// are the ping-pong slots, 2.. the compute buffers. Step s reads slot
// (slot0 + s) % 2 and writes the other one:
//   - the local refresh, where a dynamic dim is unsharded (d1 of a 3D grid
//     on a 1D mesh): every rank's k*r-deep ghost rows of that dim wrapped
//     (periodic) or mirrored (Neumann: ghost layer j <- interior layer
//     j-1) from its own rows, over the interior of the sharded dim and
//     the launch's extent of the lane (rma.py:510-551);
//   - the exchange: for each sharded dim in order (one phase each), every
//     rank with a neighbour on a side (a ring wraps: on a ring of 2 both
//     sides are one rank, on a ring of 1 the rank itself) stores the strip
//     of its edge rows into that neighbour's opposite ghost band, in the
//     same slot; a rank on a Neumann face writes its own mirror ghosts
//     with the strip's footprint (rma.py:465-508); a rank on a Dirichlet
//     face keeps the ghosts it was given. A phase-d strip spans the full
//     launch extent of the earlier sharded and the unsharded dims and the
//     interior of the later sharded dims, so corners transit and no cell
//     is written twice (rma.py:385-433);
//   - k sweeps: sweep t writes the rank's update box of sweep t (the
//     interior grown by (k-t)*r on its live faces: a neighbour's, a
//     Neumann face, both faces of the refreshed dim; rma.py:286-332) from
//     the buffer sweep t-1 wrote: the step's input slot for t = 1, compute
//     buffer 2 + (t-1) % ncompute for t < k, the other slot for t = k
//     (rma.py:553-560). Cells outside the boxes are never written: the
//     Dirichlet ghosts hold their values in every buffer (the wrapper's
//     scatter puts the golden's corners there), which is what the TPU
//     kernel's re-pinning (rma.py:562-601) leaves there.
// The host tables (the strips' extent and starts, the refresh's box, per
// rank the neighbour codes and the boxes) come from rma.py:rma_tables and
// rma.py:_geometry; the plain version walks the copies they describe.
//
// How. The TPU kernel holds each chip's block in VMEM and paces remote
// DMAs with semaphores between chips. Here every phase is a grid-stride
// loop over (rank, cell) of a cooperative launch whose CTAs are all
// resident (the grid is the occupancy limit times the SM count), and a
// grid barrier (cooperative_groups' grid.sync()) ends every phase and
// every sweep, in place of the neighbour semaphores: nphase + k barriers
// per step, one more with a refresh (the phase-0 strips span the
// refreshed ghosts). A ring or a mirror adds no barrier: they are items of
// the dim's phase. The blocks stay in device memory for the whole launch;
// the plan keeps every rank's buffers within the L2 (50 MiB on an H100),
// so after the first sweep the steps run from L2.
//
// A mirror or a wrap is not a translation like a push: the row it reads
// depends on the depth j of the ghost row it writes (band_copy).
//
// The read path. Every buffer is written inside this launch by other CTAs,
// so no load may take the non-coherent path: no __restrict__ on the
// buffers and no __ldg (either lets nvcc emit ld.global.nc), and the L1,
// which is not coherent across SMs, is bypassed too. Every load of a
// buffer is __ldcg (cached in L2 only; a bf16 value is loaded as its 16
// bits); grid.sync() orders each phase's stores before the next phase's
// loads device-wide. Stores are plain (the L1 writes through to L2).
//
// Element type. T is float or __nv_bfloat16 (entries rma_iterate_f32 and
// rma_iterate_bf16): copies move T values as they are; the taps widen
// each load to float and round every add and multiply to T at once
// (stencil_taps.cuh's Num<T>), as torch computes each op of the plain
// version in T.
//
// Taps: the table of stencil_taps.cuh in StencilSpec.weight_groups order,
// each group summed then multiplied once, with -fmad=false and the _rn
// operations, so the kernel is bitwise its plain version (eager.apply_spec).
//
// Bound. The function must move little: the grid read once and written
// once per launch; its operations, the stencil's per update, bound it.
// This kernel is far from that: every update reads its taps from L2
// (no shared-memory reuse between neighbouring cells), spends integer
// divisions on its coordinates, and every step waits on its grid barriers
// (PERF.md has the measured cost of each). A faster design (per-sweep
// shared-memory tiles, neighbour flags in place of grid barriers) is later
// work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "stencil_taps.cuh"

namespace cg = cooperative_groups;

namespace {

using stencil::Num;
using stencil::Taps;

constexpr int kThreads = 256;
constexpr int kMaxPhases = 2;
// rma.py:_geometry: the header, the refresh, then per phase
constexpr int kHeader = 10;
constexpr int kRefresh = 8;
constexpr int kPhase = 17;
constexpr int kGeomLen = kHeader + kRefresh + kMaxPhases * kPhase;
constexpr int kDirichlet = -1;   // neighbour codes (rma.py:NBR_*)
constexpr int kMirror = -2;
constexpr int kNoRefresh = -1;   // refresh kinds (rma.py:REFRESH_*)
constexpr int kWrap = 0;
constexpr int kErrArgument = -1;
constexpr int kErrCooperative = -2;

struct Params {
  int ranks, nbuf, nphase, k, steps, slot0, ncompute;
  int64_t p1, p2, block;             // P1, P2, P0*P1*P2
  int size[kMaxPhases][3];           // a phase's strip extent
  int64_t src[kMaxPhases][2];        // flat start of the lo / hi push source
  int64_t dst[kMaxPhases][2];        // flat start of its destination
  int dim[kMaxPhases];               // the phase's dim (0..2)
  int n[kMaxPhases];                 // its interior extent
  int refresh;                       // kNoRefresh, kWrap or a mirror
  int rdim, rn, rsize[3];            // the refresh's dim, n, box extent
  int64_t rbase;                     // its box's start, first interior row
  const int32_t* nbr;                // [R][nphase][2] neighbour or code
  const int32_t* boxes;              // [R][k][6] start0..2, size0..2
  const int32_t* bound;              // [k][6] each sweep's bounding box
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

// stencil_taps.cuh's apply_taps, every load ld<T>.
template <typename T>
__device__ __forceinline__ float taps_at(const T* s, int64_t p,
                                         const Taps& taps) {
  float acc = 0.0f;
  int t = 0;
  for (int g = 0; g < taps.ngroups; ++g) {
    const int end = taps.group_end[g];
    float gacc = Num<T>::load(ld(s + p + taps.off[t++]));
#pragma unroll 4
    for (; t < end; ++t)
      gacc = stencil::add<T>(gacc, Num<T>::load(ld(s + p + taps.off[t])));
    acc = stencil::close_group<T>(acc, gacc, g, taps);
  }
  return taps.uniform ? stencil::mul<T>(acc, taps.uniform_weight) : acc;
}

// The cells of a wrap or a mirror: `a` is the flat offset of an item of a
// band whose dim-`stride` rows start at the first interior row, at depth
// j (0-based) into the band; n is the dim's interior extent. The lo side
// writes ghost row -1-j (the ghost layer j+1), the hi side ghost row n+j;
// a wrap reads the row n away (the far interior), a mirror the interior
// row j on the lo side and n-1-j on the hi side.
__device__ __forceinline__ void band_copy(int64_t a, int j, int64_t stride,
                                          int n, int side, bool wrap,
                                          int64_t& src, int64_t& dst) {
  const int64_t back = (int64_t)(2 * j + 1) * stride;
  const int64_t across = (int64_t)n * stride;
  if (side == 0) {
    dst = a - back;
    src = wrap ? dst + across : a;
  } else {
    dst = a + across;
    src = wrap ? a : dst - back;
  }
}

__device__ __forceinline__ int64_t stride_of(const Params& g, int dim) {
  return dim == 0 ? g.p1 * g.p2 : (dim == 1 ? g.p2 : 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rma_iterate_kernel(T* bufs, const __grid_constant__ Params g,
                   const __grid_constant__ Taps taps) {
  cg::grid_group grid = cg::this_grid();
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t per_rank = (int64_t)g.nbuf * g.block;
  for (int s = 0; s < g.steps; ++s) {
    const int in_slot = (g.slot0 + s) & 1;
    // the local refresh of the unsharded dynamic dim
    if (g.refresh != kNoRefresh) {
      const int s1 = g.rsize[1], s2 = g.rsize[2];
      const int64_t vol = (int64_t)g.rsize[0] * s1 * s2;
      const int64_t items = (int64_t)g.ranks * 2 * vol;
      const int64_t rstride = stride_of(g, g.rdim);
      for (int64_t i = first; i < items; i += stride) {
        const int64_t rank = i / (2 * vol);
        const int64_t rest = i - rank * 2 * vol;
        const int side = (int)(rest / vol);
        const int64_t c = rest - side * vol;
        const int64_t c2 = c % s2, c01 = c / s2;
        const int64_t i0 = c01 / s1, i1 = c01 % s1;
        const int j = (int)(g.rdim == 0 ? i0 : (g.rdim == 1 ? i1 : c2));
        const int64_t base = rank * per_rank + in_slot * g.block;
        int64_t src, dst;
        band_copy(base + g.rbase + (i0 * g.p1 + i1) * g.p2 + c2, j, rstride,
                  g.rn, side, g.refresh == kWrap, src, dst);
        bufs[dst] = ld(bufs + src);
      }
      grid.sync();
    }
    // the exchange, one phase per sharded dim
    for (int ph = 0; ph < g.nphase; ++ph) {
      const int s0 = g.size[ph][0], s1 = g.size[ph][1], s2 = g.size[ph][2];
      const int64_t vol = (int64_t)s0 * s1 * s2;
      const int64_t items = (int64_t)g.ranks * 2 * vol;
      const int64_t dstride = stride_of(g, g.dim[ph]);
      for (int64_t i = first; i < items; i += stride) {
        const int64_t rank = i / (2 * vol);
        const int64_t rest = i - rank * 2 * vol;
        const int side = (int)(rest / vol);
        const int64_t c = rest - side * vol;
        const int to = g.nbr[(rank * g.nphase + ph) * 2 + side];
        if (to == kDirichlet) continue;
        const int64_t c2 = c % s2, c01 = c / s2;
        const int64_t i0 = c01 / s1, i1 = c01 % s1;
        const int64_t off = (i0 * g.p1 + i1) * g.p2 + c2;
        const int64_t base = rank * per_rank + in_slot * g.block;
        if (to >= 0) {
          bufs[to * per_rank + in_slot * g.block + g.dst[ph][side] + off] =
              ld(bufs + base + g.src[ph][side] + off);
        } else if (to == kMirror) {  // my own ghosts on that side
          const int j =
              (int)(g.dim[ph] == 0 ? i0 : (g.dim[ph] == 1 ? i1 : c2));
          int64_t src, dst;
          band_copy(base + g.src[ph][0] + off, j, dstride, g.n[ph], side,
                    false, src, dst);
          bufs[dst] = ld(bufs + src);
        }
      }
      grid.sync();
    }
    // k sweeps over each rank's update boxes
    for (int t = 1; t <= g.k; ++t) {
      const int from = t == 1 ? in_slot : 2 + (t - 2) % g.ncompute;
      const int into = t == g.k ? 1 - in_slot : 2 + (t - 1) % g.ncompute;
      const int32_t* bb = g.bound + (t - 1) * 6;
      const int b0 = bb[0], b1 = bb[1], b2 = bb[2];
      const int n1 = bb[4], n2 = bb[5];
      const int64_t vol = (int64_t)bb[3] * n1 * n2;
      const int64_t items = (int64_t)g.ranks * vol;
      for (int64_t i = first; i < items; i += stride) {
        const int64_t rank = i / vol;
        const int64_t c = i - rank * vol;
        const int64_t c01 = c / n2;
        const int i0 = b0 + (int)(c01 / n1), i1 = b1 + (int)(c01 % n1);
        const int i2 = b2 + (int)(c - c01 * n2);
        const int32_t* box = g.boxes + (rank * g.k + (t - 1)) * 6;
        if (i0 < box[0] || i0 >= box[0] + box[3] || i1 < box[1] ||
            i1 >= box[1] + box[4] || i2 < box[2] || i2 >= box[2] + box[5])
          continue;
        const int64_t p = ((int64_t)i0 * g.p1 + i1) * g.p2 + i2;
        const T* src = bufs + rank * per_rank + from * g.block;
        bufs[rank * per_rank + into * g.block + p] =
            Num<T>::store(taps_at<T>(src, p, taps));
      }
      grid.sync();
    }
  }
}

template <typename T>
int launch(T* bufs, const int32_t* table, const int32_t* geom, int ngeom,
           const int32_t* tap_offsets, const int32_t* group_sizes,
           const float* group_weights, int ntaps, int ngroups, int uniform,
           float uniform_weight, int device, void* stream) {
  if (ngeom != kGeomLen) return kErrArgument;
  Params g;
  g.ranks = geom[0];
  g.nbuf = geom[1];
  const int p0 = geom[2], p1 = geom[3], p2 = geom[4];
  g.nphase = geom[5];
  g.k = geom[6];
  g.steps = geom[7];
  g.slot0 = geom[8];
  g.refresh = geom[9];
  g.ncompute = g.k == 1 ? 0 : (g.k == 2 ? 1 : 2);
  if (g.ranks < 1 || g.k < 1 || g.steps < 1 || p0 < 1 || p1 < 1 || p2 < 1)
    return kErrArgument;
  if (g.nphase < 1 || g.nphase > kMaxPhases || (g.slot0 & ~1) ||
      g.nbuf < 2 + g.ncompute || g.refresh < kNoRefresh || g.refresh > 1)
    return kErrArgument;
  g.p1 = p1;
  g.p2 = p2;
  g.block = (int64_t)p0 * p1 * p2;
  const int32_t* r = geom + kHeader;
  g.rdim = r[0];
  g.rn = r[1];
  for (int d = 0; d < 3; ++d) g.rsize[d] = r[2 + d];
  g.rbase = ((int64_t)r[5] * p1 + r[6]) * p2 + r[7];
  if (g.refresh != kNoRefresh &&
      (g.rdim < 0 || g.rdim > 2 || g.rn < 1 || g.rsize[0] < 1 ||
       g.rsize[1] < 1 || g.rsize[2] < 1))
    return kErrArgument;
  for (int ph = 0; ph < kMaxPhases; ++ph) {
    const int32_t* q = geom + kHeader + kRefresh + ph * kPhase;
    for (int d = 0; d < 3; ++d) g.size[ph][d] = q[d];
    g.dim[ph] = q[15];
    g.n[ph] = q[16];
    if (ph < g.nphase && (q[0] < 1 || q[1] < 1 || q[2] < 1 ||
                          g.dim[ph] < 0 || g.dim[ph] > 2 || g.n[ph] < 1))
      return kErrArgument;
    for (int side = 0; side < 2; ++side) {
      const int32_t* src = q + 3 + side * 6;
      const int32_t* dst = src + 3;
      g.src[ph][side] = ((int64_t)src[0] * p1 + src[1]) * p2 + src[2];
      g.dst[ph][side] = ((int64_t)dst[0] * p1 + dst[1]) * p2 + dst[2];
    }
  }
  g.nbr = table;
  g.boxes = table + g.ranks * g.nphase * 2;
  g.bound = g.boxes + g.ranks * g.k * 6;

  Taps taps;
  if (!stencil::fill_groups(taps, group_sizes, group_weights, ntaps,
                            ngroups, uniform, uniform_weight))
    return kErrArgument;
  for (int i = 0; i < ntaps; ++i) {
    const int d0 = tap_offsets[3 * i], d1 = tap_offsets[3 * i + 1],
              d2 = tap_offsets[3 * i + 2];
    taps.off[i] = (d0 * p1 + d1) * p2 + d2;
  }

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int cooperative = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch,
                               device);
  if (err != cudaSuccess) return (int)err;
  if (!cooperative) return kErrCooperative;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rma_iterate_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return kErrCooperative;
  void* args[] = {&bufs, &g, &taps};
  err = cudaLaunchCooperativeKernel((const void*)rma_iterate_kernel<T>,
                                    dim3(per_sm * sms), dim3(kThreads), args,
                                    0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch `steps` outer steps on `stream` (a cudaStream_t, 0 = the legacy
// default stream) of device `device`, as one cooperative launch. `bufs` is
// float32[R][nbuf][P0][P1][P2] on the device; `table` (device, int32) holds
// the neighbour codes [R][nphase][2] (a rank, -1 Dirichlet, -2 Neumann),
// the update boxes [R][k][6] and each sweep's bounding box over the ranks
// [k][6] (rma.py:device_table). `geom` is int32[52] (host): R nbuf P0 P1
// P2 nphase k steps slot0 and the refresh's kind (-1 none, 0 wrap, 1
// mirror); the refresh's dim, n, box extent [3] and box start [3] at the
// dim's first interior row; then per phase (two, zeros past nphase) the
// strip extent [3], the starts [3] of the lo push's source and
// destination and of the hi push's, the dim and its n (rma.py:_geometry).
// `tap_offsets` is int32[ntaps * 3] in group order, `group_sizes`
// int32[ngroups], `group_weights` float[ngroups]. Host arrays are copied
// before the launch returns. Returns 0, a CUDA error code, or a negative
// code (see rma_iterate_error).
int rma_iterate_f32(float* bufs, const int32_t* table, const int32_t* geom,
                    int ngeom, const int32_t* tap_offsets,
                    const int32_t* group_sizes, const float* group_weights,
                    int ntaps, int ngroups, int uniform,
                    float uniform_weight, int device, void* stream) {
  return launch<float>(bufs, table, geom, ngeom, tap_offsets, group_sizes,
                       group_weights, ntaps, ngroups, uniform,
                       uniform_weight, device, stream);
}

// The same in bf16: `bufs` holds __nv_bfloat16; the weights stay fp32,
// each a bf16 value.
int rma_iterate_bf16(__nv_bfloat16* bufs, const int32_t* table,
                     const int32_t* geom, int ngeom,
                     const int32_t* tap_offsets, const int32_t* group_sizes,
                     const float* group_weights, int ntaps, int ngroups,
                     int uniform, float uniform_weight, int device,
                     void* stream) {
  return launch<__nv_bfloat16>(bufs, table, geom, ngeom, tap_offsets,
                               group_sizes, group_weights, ntaps, ngroups,
                               uniform, uniform_weight, device, stream);
}

const char* rma_iterate_error(int code) {
  if (code == kErrArgument) return "rejected geometry or tap table";
  if (code == kErrCooperative)
    return "the device cannot run a cooperative launch of this kernel";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
