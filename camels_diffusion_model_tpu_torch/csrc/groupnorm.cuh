// Pieces the GroupNorm kernels (K2) share: groupnorm.cu's single launches,
// groupnorm_narrow.cu's bf16 single launches where a group is not whole
// packs, and groupnorm_sharded.cu's statistics and apply launches, each
// source compiled by an nvcc of its own.  The activations of the JAX package
// (context_unet.py:54-61), Chan's merge of centred moments, and loads read
// once (no L1 line kept).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pack.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case 1: return fmaxf(y, 0.0f);
    case 2: return 0.5f * y * (1.0f + erff(y * 0.70710678118654752f));
    case 3: return y > 0.0f ? y : 0.2f * y;
    default: return y;
  }
}

// Centred moments: count, mean and the sum of squares about the mean.
struct Moments {
  float n, mean, m2;
};

// Chan's merge of a (first) and b, in that order (the weight b.n / n by
// the fast division: 2 ulps, far inside the statistics' fp32 rounding).
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.0f) return a;
  const float n = a.n + b.n, f = __fdividef(b.n, n), d = b.mean - a.mean;
  return {n, a.mean + d * f, a.m2 + b.m2 + d * d * a.n * f};
}

constexpr int MAX_SEG = 8;  // groups of one segment

// Four bf16 (8 bytes) as floats.
__device__ __forceinline__ Pack<4> load4(const bf16* p) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  return Pack<4>{{__uint_as_float(t.x << 16), __uint_as_float(t.x & 0xffff0000u),
                  __uint_as_float(t.y << 16), __uint_as_float(t.y & 0xffff0000u)}};
}

__device__ __forceinline__ uint4 load_stream(const bf16* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// A pack of V elements of T as loaded: 16 bytes, or one element.
template <typename T, int V>
struct Raw {
  uint4 bits;
};
template <typename T>
struct Raw<T, 1> {
  T bits;
};

// Read once: no L1 line kept for it.
template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* p) {
  Raw<T, V> r;
  if constexpr (V == 1) {
    r.bits = *p;
  } else {
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r.bits.x), "=r"(r.bits.y), "=r"(r.bits.z), "=r"(r.bits.w)
                 : "l"(p));
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ Pack<V> unpack(const Raw<T, V>& r) {
  return load<V>(reinterpret_cast<const T*>(&r.bits));
}

}  // namespace
