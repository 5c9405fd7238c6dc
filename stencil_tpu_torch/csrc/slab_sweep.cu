// k temporally blocked sweeps of a linear stencil over a deep-halo 2D
// fp32 or bf16 grid, in one launch. Hand-written for Hopper (sm_90a).
//
// Replaces stencil_tpu/ops/pallas.py:build_sweep (the Pallas TPU slab
// kernel, pallas_call at :675) on 2D grids, in its homogeneous mode and
// in its source mode (has_source, u' = S(u) + src, added at :586-591),
// with its lead-dim `pins` (:564-575), in fp32 and in bf16 (the TPU kernel
// at dtype=bfloat16). Wrapper and plain PyTorch version:
// stencil_tpu_torch/ops/slab_kernel.py.
//
// Element type: the kernel is templated on T, float or __nv_bfloat16, as
// tiled_sweep.cu is: windows, loads, stores and the source are T, values
// are held in float registers, and in bf16 every add and multiply is
// rounded to bf16 at once (stencil_taps.cuh), torch's rule for the plain
// version's bf16 ops. Entries: stencil_slab_sweep (fp32) and
// stencil_slab_sweep_bf16.
//
// What it computes. `in` and `out` are padded (n0+2H, n1+2H) T arrays
// whose H >= k*r ghost layers hold the Dirichlet face values. `out`
// receives k sweeps of the stencil applied to `in`, interior points only;
// its ghosts are never written (the caller keeps them equal to those of
// `in`), which is what the TPU kernel's re-pinning of the ghost rows and
// its one-time minor-ghost fill do. With a source (a padded array of the
// same layout holding the pre-scaled source), every interior update of
// every sweep adds it at its point, one fp32 add after the taps; ghosts
// copy along without it.
//
// How. The TPU kernel streams slabs of full minor width through VMEM. A
// full-width slab with a k*r temporal halo does not fit a block's 227 KB
// of shared memory at 4096 columns, so this kernel tiles both dims: one
// block per (t0, t1) output tile loads the tile's window, grown by k*r on
// every side, into shared memory and runs the k sweeps there, a barrier
// between sweeps, two buffers alternating when k > 1. Sweep t updates the
// window shrunk by t*r on every side; a point of that region inside the
// grid's interior gets the stencil, a ghost point copies its constant
// along. The last sweep's region is the tile, all interior, and goes
// straight to global memory. The last tile of a ragged dim starts at
// n - t (clamped); it overlaps its neighbour, and both write identical
// values.
//
// Pins: the geometry carries one flag per d0 face (lo, hi). A pinned face
// (1) is a Dirichlet wall, as above. A live face (0) is a periodic or
// Neumann wall whose k*r ghost rows the caller filled with the wrapped or
// mirrored interior before the launch: a window row beyond it gets the
// full update (taps, + src) as an interior row does, so the k sweeps carry
// the wrap or mirror along (the TPU kernel's pins off). With both faces
// pinned the update test, and so the result, is that of a launch without
// pins. A live row at sweep t lies at padded index >= t*r and reads at
// most r beyond it. The d1 faces are always pinned: a periodic or Neumann
// d1 runs at k = 1, where the caller's refresh is the whole mechanism.
//
// Taps: a table in StencilSpec.weight_groups order, evaluated by
// stencil_taps.cuh, bitwise as the eager torch version (ops/eager.py)
// rounds. 4 taps (jacobi5) and 8 taps (jacobi9, star2d_r2, laplace2d_ho)
// get the unrolled evaluator; other counts read the table in a loop.
//
// Bound. One launch reads the padded array once (the windows' overlap
// mostly from L2) and writes it once for k sweeps; at k >= 4 that puts the
// HBM bytes per sweep far below the card's bandwidth, and the windows'
// recompute (a t-wide tile with a k*r halo updates ~(t+k*r)^2/t^2 points
// per useful one) and the shared-memory tap loads bind it. The plan
// (ops/slab.py) trades that recompute against the number of blocks, which
// on small grids is what fills the card. Loads are plain (no TMA or
// cp.async) and do not overlap compute within a block. The second
// schedule, csrc/slab_march.cu, marches d0 through per-level rings of
// rows instead, its rows by cp.async one step ahead, recomputing in d0
// only the k*r rows at each end of a chunk; ops/slab.py:make_slab_plan
// picks between the two by a rule fitted on an H100.

#include <cuda_runtime.h>

#include <cstdint>

#include "stencil_taps.cuh"

namespace {

using stencil::add;
using stencil::Evaluator;
using stencil::Num;
using stencil::Taps;

constexpr int kBlockX = 32;   // threads along d1 (contiguous)
constexpr int kBlockY = 16;   // threads along d0 rows
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kGeomLen = 13;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB per block on sm_90
constexpr int kErrArgument = -1;
constexpr int kErrShared = -2;

struct Geometry {
  int n0, n1;   // interior extents
  int p1;       // padded extent of d1 (the row stride)
  int halo;     // pad depth H: the interior starts at padded index H
  int t0, t1;   // tile extents
  int nt1;      // tiles along d1
  int k, r;     // sweeps per launch, stencil radius
  int w0, w1;   // window extents, t + 2*k*r
  int pin_lo, pin_hi;  // the d0 faces: 1 pinned, 0 live
};

// NT > 0: a spec of exactly NT taps; NT == 0: any spec. SRC: every
// update (live ghost rows included) adds the padded source `source` at its
// point. T: the element type.
template <int NT, bool SRC, typename T>
__global__ void __launch_bounds__(kThreads)
slab_sweep_kernel(const T* __restrict__ in, T* __restrict__ out,
                  const T* __restrict__ source, const Geometry g,
                  const __grid_constant__ Taps taps) {
  using N = Num<T>;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* const smem = reinterpret_cast<T*>(smem_bytes);
  const int wvol = g.w0 * g.w1;
  T* cur = smem;
  T* nxt = smem + wvol;  // exists only when k > 1
  const Evaluator<NT, T> stencil_at(taps);

  const int i1 = blockIdx.x % g.nt1;
  const int i0 = blockIdx.x / g.nt1;
  const int kr = g.k * g.r;
  // window origin in padded coordinates: clamped tile start - k*r + H
  const int o0 = min(i0 * g.t0, g.n0 - g.t0) + g.halo - kr;
  const int o1 = min(i1 * g.t1, g.n1 - g.t1) + g.halo - kr;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;

  // The window load, flattened over its points so every lane works; each
  // thread carries the (a, c) window coordinates of its point instead of
  // dividing, unrolled so that several global loads are in flight.
  {
    const int sc = kThreads % g.w1;
    const int sa = kThreads / g.w1;
    int c = tid % g.w1;
    int a = tid / g.w1;
#pragma unroll 4
    for (int i = tid; i < wvol; i += kThreads) {
      cur[i] = in[(int64_t)(o0 + a) * g.p1 + o1 + c];
      c += sc;
      const int carry = c >= g.w1;
      c -= carry ? g.w1 : 0;
      a += sa + carry;
    }
  }
  __syncthreads();

  // the points a sweep updates, in window coordinates, [lo, hi) per dim:
  // the grid's interior, widened to the window's edge at a live d0 face
  const int lo0 = g.pin_lo ? g.halo - o0 : 0;
  const int hi0 = g.pin_hi ? g.halo - o0 + g.n0 : g.w0;
  const int lo1 = g.halo - o1, hi1 = lo1 + g.n1;

  for (int t = 1; t <= g.k; ++t) {
    const int e = t * g.r;  // region of sweep t: [e, w - e) per dim
    const bool last = t == g.k;
    for (int wa = threadIdx.y + e; wa < g.w0 - e; wa += kBlockY) {
      const bool inner = wa >= lo0 && wa < hi0;
      const int base = wa * g.w1;
      const int64_t grow = (int64_t)(o0 + wa) * g.p1 + o1;
      for (int c = threadIdx.x + e; c < g.w1 - e; c += kBlockX) {
        const int p = base + c;
        float v;
        if (inner && c >= lo1 && c < hi1) {
          v = stencil_at(cur, p, taps);
          if constexpr (SRC) v = add<T>(v, N::ldg(source + grow + c));
        } else {
          v = N::load(cur[p]);
        }
        if (last) {
          out[grow + c] = N::store(v);
        } else {
          nxt[p] = N::store(v);
        }
      }
    }
    if (!last) {
      __syncthreads();
      T* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
}

template <int NT, bool SRC, typename T>
cudaError_t launch(const T* in, T* out, const T* source, const Geometry& g,
                   const Taps& taps, unsigned nblocks, size_t shared,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      slab_sweep_kernel<NT, SRC, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return err;
  slab_sweep_kernel<NT, SRC, T><<<nblocks, dim3(kBlockX, kBlockY), shared,
                                  stream>>>(in, out, source, g, taps);
  return cudaGetLastError();
}

template <bool SRC, typename T>
cudaError_t dispatch(int ntaps, const T* in, T* out, const T* source,
                     const Geometry& g, const Taps& taps, unsigned nblocks,
                     size_t shared, cudaStream_t stream) {
  switch (ntaps) {
    case 4:  // jacobi5
      return launch<4, SRC>(in, out, source, g, taps, nblocks, shared,
                            stream);
    case 8:  // jacobi9, star2d_r2, laplace2d_ho
      return launch<8, SRC>(in, out, source, g, taps, nblocks, shared,
                            stream);
    default:
      return launch<0, SRC>(in, out, source, g, taps, nblocks, shared,
                            stream);
  }
}

// The entry's body for either element type (see stencil_slab_sweep).
template <typename T>
int sweep_entry(const T* in, T* out, const T* source, const int32_t* geom,
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
  if (k < 1 || r < 1 || (int64_t)k * r > halo) return kErrArgument;
  if ((pin_lo != 0 && pin_lo != 1) || (pin_hi != 0 && pin_hi != 1))
    return kErrArgument;
  if (p0 != n0 + 2 * halo || p1 != n1 + 2 * halo) return kErrArgument;
  if (t0 < 1 || t0 > n0 || t1 < 1 || t1 > n1) return kErrArgument;
  if (nt0 != (n0 + t0 - 1) / t0 || nt1 != (n1 + t1 - 1) / t1)
    return kErrArgument;
  const int64_t nblocks = (int64_t)nt0 * nt1;
  if (nblocks > 0x7fffffff) return kErrArgument;

  Geometry g;
  g.n0 = n0; g.n1 = n1;
  g.p1 = p1; g.halo = halo;
  g.t0 = t0; g.t1 = t1;
  g.nt1 = nt1;
  g.k = k; g.r = r;
  g.w0 = t0 + 2 * k * r; g.w1 = t1 + 2 * k * r;
  g.pin_lo = pin_lo; g.pin_hi = pin_hi;
  const size_t window = (size_t)g.w0 * g.w1;
  const size_t shared = (k > 1 ? 2 : 1) * window * sizeof(T);
  if (shared > kMaxSharedBytes) return kErrShared;

  Taps taps;
  if (!stencil::fill_groups(taps, group_sizes, group_weights, ntaps,
                            ngroups, uniform, uniform_weight))
    return kErrArgument;
  for (int i = 0; i < ntaps; ++i) {
    const int d0 = tap_offsets[2 * i], d1 = tap_offsets[2 * i + 1];
    if (d0 < -r || d0 > r || d1 < -r || d1 > r) return kErrArgument;
    taps.off[i] = d0 * g.w1 + d1;
  }

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned nb = (unsigned)nblocks;
  return source ? (int)dispatch<true>(ntaps, in, out, source, g, taps, nb,
                                      shared, s)
                : (int)dispatch<false>(ntaps, in, out, source, g, taps, nb,
                                       shared, s);
}

}  // namespace

extern "C" {

// Launch k sweeps on `stream` (a cudaStream_t, 0 = the legacy default stream)
// of device `device`. `source` is null, or a padded array of the layout and
// type of `in` whose interior holds the pre-scaled source. `geom` is
// int32[13]: n0 n1 p0 p1 halo t0 t1 nt0 nt1 k r, then the pins of the d0 lo
// and hi faces (1 pinned, 0 live; see the header). `tap_offsets` is
// int32[ntaps * 2] in group order, `group_sizes` int32[ngroups],
// `group_weights` float[ngroups]. Host arrays are copied before the launch
// returns. Returns 0, a CUDA error code (cudaGetLastError after the launch),
// or a negative code for a rejected argument (see stencil_slab_sweep_error).
int stencil_slab_sweep(const float* in, float* out, const float* source,
                       const int32_t* geom, int ngeom,
                       const int32_t* tap_offsets,
                       const int32_t* group_sizes,
                       const float* group_weights, int ntaps, int ngroups,
                       int uniform, float uniform_weight, int device,
                       void* stream) {
  return sweep_entry(in, out, source, geom, ngeom, tap_offsets, group_sizes,
                     group_weights, ntaps, ngroups, uniform, uniform_weight,
                     device, stream);
}

// The same in bf16: `in`, `out` and `source` hold __nv_bfloat16; the
// weights stay fp32, each a bf16 value.
int stencil_slab_sweep_bf16(const __nv_bfloat16* in, __nv_bfloat16* out,
                            const __nv_bfloat16* source, const int32_t* geom,
                            int ngeom, const int32_t* tap_offsets,
                            const int32_t* group_sizes,
                            const float* group_weights, int ntaps,
                            int ngroups, int uniform, float uniform_weight,
                            int device, void* stream) {
  return sweep_entry(in, out, source, geom, ngeom, tap_offsets, group_sizes,
                     group_weights, ntaps, ngroups, uniform, uniform_weight,
                     device, stream);
}

const char* stencil_slab_sweep_error(int code) {
  if (code == kErrArgument) return "rejected geometry or tap table";
  if (code == kErrShared) return "window exceeds 232448 bytes of shared memory";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
