// The tap evaluator shared by the hand-written sweep kernels
// (tiled_sweep.cu, 3D; slab_sweep.cu, 2D).
//
// Taps come as a table in StencilSpec.weight_groups order. Each group is
// summed first, then multiplied once by its weight; a uniform-weight spec
// multiplies once at the end. With -fmad=false and the explicit _rn
// intrinsics the rounding is step for step that of the eager torch version
// (ops/eager.py), so a kernel and its plain version agree bitwise. A
// caller that adds a source term adds it after this value, as the eager
// version does.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace stencil {

constexpr int kMaxTaps = 128;

struct Taps {
  int ngroups;
  int uniform;                    // 1: one weight, applied once at the end
  float uniform_weight;
  uint32_t group_starts;          // bit t: tap t opens a group (t < 32)
  int group_end[kMaxTaps];        // exclusive end of each group in off[]
  float group_weight[kMaxTaps];
  int off[kMaxTaps];              // tap offsets, flattened in the window
};

// Fills everything but `off` from the host tables; false on a bad table.
inline bool fill_groups(Taps& taps, const int32_t* group_sizes,
                        const float* group_weights, int ntaps, int ngroups,
                        int uniform, float uniform_weight) {
  if (ntaps < 1 || ntaps > kMaxTaps || ngroups < 1 || ngroups > ntaps)
    return false;
  taps.ngroups = ngroups;
  taps.uniform = uniform ? 1 : 0;
  taps.uniform_weight = uniform_weight;
  taps.group_starts = 0;
  int end = 0;
  for (int i = 0; i < ngroups; ++i) {
    if (group_sizes[i] < 1) return false;
    if (end < 32) taps.group_starts |= 1u << end;
    end += group_sizes[i];
    taps.group_end[i] = end;
    taps.group_weight[i] = group_weights[i];
  }
  return end == ntaps;
}

__device__ __forceinline__ float close_group(float acc, float gacc, int g,
                                             const Taps& taps) {
  const float term =
      taps.uniform ? gacc : __fmul_rn(gacc, taps.group_weight[g]);
  return g == 0 ? term : __fadd_rn(acc, term);
}

// Any tap count: the table is read in a loop.
__device__ __forceinline__ float apply_taps(const float* __restrict__ s,
                                            int p, const Taps& taps) {
  float acc = 0.0f;
  int t = 0;
  for (int g = 0; g < taps.ngroups; ++g) {
    const int end = taps.group_end[g];
    float gacc = s[p + taps.off[t++]];
#pragma unroll 4
    for (; t < end; ++t) gacc = __fadd_rn(gacc, s[p + taps.off[t]]);
    acc = close_group(acc, gacc, g, taps);
  }
  return taps.uniform ? __fmul_rn(acc, taps.uniform_weight) : acc;
}

// NT taps, offsets in registers: fully unrolled, so all NT shared loads
// can be in flight before the adds, which still run in tap order.
template <int NT>
__device__ __forceinline__ float apply_fixed(const float* __restrict__ s,
                                             int p, const int (&off)[NT],
                                             const Taps& taps) {
  float v[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) v[t] = s[p + off[t]];
  float acc = 0.0f;
  float gacc = v[0];
  int g = 0;
#pragma unroll
  for (int t = 1; t < NT; ++t) {
    if ((taps.group_starts >> t) & 1u) {
      acc = close_group(acc, gacc, g++, taps);
      gacc = v[t];
    } else {
      gacc = __fadd_rn(gacc, v[t]);
    }
  }
  acc = close_group(acc, gacc, g, taps);
  return taps.uniform ? __fmul_rn(acc, taps.uniform_weight) : acc;
}

// NT > 0: a spec of exactly NT taps, offsets copied into registers;
// NT == 0: any spec, through the table.
template <int NT>
struct Evaluator {
  int off[NT];
  __device__ __forceinline__ explicit Evaluator(const Taps& taps) {
#pragma unroll
    for (int t = 0; t < NT; ++t) off[t] = taps.off[t];
  }
  __device__ __forceinline__ float operator()(const float* __restrict__ s,
                                              int p,
                                              const Taps& taps) const {
    return apply_fixed<NT>(s, p, off, taps);
  }
};

template <>
struct Evaluator<0> {
  __device__ __forceinline__ explicit Evaluator(const Taps&) {}
  __device__ __forceinline__ float operator()(const float* __restrict__ s,
                                              int p,
                                              const Taps& taps) const {
    return apply_taps(s, p, taps);
  }
};

}  // namespace stencil
