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
//
// The element type T of the windows is float or __nv_bfloat16. Values
// live in float registers either way; in bfloat16 each add and multiply
// is an fp32 _rn operation whose result is rounded to bfloat16 at once
// (Num<T>::round), which is torch's rule for a bfloat16 op (compute in
// fp32, round the result) and so the plain version's. Accumulating in
// fp32 and rounding once would be another result. The weights come as
// fp32 values already rounded to T on the host, so every product is the
// one torch forms.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace stencil {

// Loads, stores and the rounding of one element type.
template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float ldg(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float store(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ float ldg(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// One rounded operation of type T on values held in float.
template <typename T>
__device__ __forceinline__ float add(float a, float b) {
  return Num<T>::round(__fadd_rn(a, b));
}
template <typename T>
__device__ __forceinline__ float sub(float a, float b) {
  return Num<T>::round(__fsub_rn(a, b));
}
template <typename T>
__device__ __forceinline__ float mul(float a, float b) {
  return Num<T>::round(__fmul_rn(a, b));
}

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

template <typename T>
__device__ __forceinline__ float close_group(float acc, float gacc, int g,
                                             const Taps& taps) {
  const float term =
      taps.uniform ? gacc : mul<T>(gacc, taps.group_weight[g]);
  return g == 0 ? term : add<T>(acc, term);
}

// Any tap count: the table is read in a loop.
template <typename T>
__device__ __forceinline__ float apply_taps(const T* __restrict__ s, int p,
                                            const Taps& taps) {
  float acc = 0.0f;
  int t = 0;
  for (int g = 0; g < taps.ngroups; ++g) {
    const int end = taps.group_end[g];
    float gacc = Num<T>::load(s[p + taps.off[t++]]);
#pragma unroll 4
    for (; t < end; ++t)
      gacc = add<T>(gacc, Num<T>::load(s[p + taps.off[t]]));
    acc = close_group<T>(acc, gacc, g, taps);
  }
  return taps.uniform ? mul<T>(acc, taps.uniform_weight) : acc;
}

// NT taps, offsets in registers: fully unrolled, so all NT shared loads
// can be in flight before the adds, which still run in tap order.
template <int NT, typename T>
__device__ __forceinline__ float apply_fixed(const T* __restrict__ s, int p,
                                             const int (&off)[NT],
                                             const Taps& taps) {
  float v[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) v[t] = Num<T>::load(s[p + off[t]]);
  float acc = 0.0f;
  float gacc = v[0];
  int g = 0;
#pragma unroll
  for (int t = 1; t < NT; ++t) {
    if ((taps.group_starts >> t) & 1u) {
      acc = close_group<T>(acc, gacc, g++, taps);
      gacc = v[t];
    } else {
      gacc = add<T>(gacc, v[t]);
    }
  }
  acc = close_group<T>(acc, gacc, g, taps);
  return taps.uniform ? mul<T>(acc, taps.uniform_weight) : acc;
}

// NT taps in groups that open at the set bits of STARTS (bit 0 set),
// known at compile time, and no uniform weight (taps.group_starts ==
// STARTS, taps.uniform == 0): apply_fixed's sums in its order, without its
// per-tap test of the group table, each group's weight read at a constant
// offset.
template <int NT, uint32_t STARTS, typename T>
__device__ __forceinline__ float apply_grouped(const T* __restrict__ s,
                                               int p, const int (&off)[NT],
                                               const Taps& taps) {
  static_assert(NT <= 32 && (STARTS & 1u), "groups open at tap 0");
  float v[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) v[t] = Num<T>::load(s[p + off[t]]);
  float acc = 0.0f;
  float gacc = v[0];
  int g = 0;
#pragma unroll
  for (int t = 1; t <= NT; ++t) {
    if (t == NT || ((STARTS >> t) & 1u)) {
      const float term = mul<T>(gacc, taps.group_weight[g]);
      acc = g == 0 ? term : add<T>(acc, term);
      ++g;
      if (t < NT) gacc = v[t];
    } else {
      gacc = add<T>(gacc, v[t]);
    }
  }
  return acc;
}

// NT taps in one group with a uniform weight (taps.ngroups == 1,
// taps.uniform == 1; the centre-less neighbour sum of the Chebyshev
// modes): apply_fixed's sum in its order, without its per-tap test of the
// group table, then the one multiply.
template <int NT, typename T>
__device__ __forceinline__ float apply_uniform(const T* __restrict__ s,
                                               int p, const int (&off)[NT],
                                               const Taps& taps) {
  float v[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) v[t] = Num<T>::load(s[p + off[t]]);
  float acc = v[0];
#pragma unroll
  for (int t = 1; t < NT; ++t) acc = add<T>(acc, v[t]);
  return mul<T>(acc, taps.uniform_weight);
}

// NT > 0: a spec of exactly NT taps, offsets copied into registers;
// NT == 0: any spec, through the table. T: the window's element type.
template <int NT, typename T>
struct Evaluator {
  int off[NT];
  __device__ __forceinline__ explicit Evaluator(const Taps& taps) {
#pragma unroll
    for (int t = 0; t < NT; ++t) off[t] = taps.off[t];
  }
  __device__ __forceinline__ float operator()(const T* __restrict__ s, int p,
                                              const Taps& taps) const {
    return apply_fixed<NT, T>(s, p, off, taps);
  }
};

template <typename T>
struct Evaluator<0, T> {
  __device__ __forceinline__ explicit Evaluator(const Taps&) {}
  __device__ __forceinline__ float operator()(const T* __restrict__ s, int p,
                                              const Taps& taps) const {
    return apply_taps<T>(s, p, taps);
  }
};

}  // namespace stencil
