// Vectors of V elements (one 16-byte access, or one element: the scalar
// path) for the kernels that keep a thread on the same channels of NHWC
// rows, and the element types they take: float (V = 4) and bf16 (V = 8).
// Values travel as floats; a bf16 element is read exactly and written
// rounded to nearest even.

#pragma once

#include <cuda_bf16.h>

using bf16 = __nv_bfloat16;

// Elements per 16-byte access.
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// v rounded to T and read back: where the JAX package's bf16 program rounds
// (its ops' outputs are bf16).  The identity for float, so the float
// instances compute the expressions they did before they were templates.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int V>
struct Pack {
  float v[V];
};

// V floats: V / 4 float4 accesses, or one float.
template <int V>
__device__ __forceinline__ Pack<V> load(const float* p) {
  Pack<V> r;
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      float4 t = reinterpret_cast<const float4*>(p)[q];
      r.v[4 * q] = t.x; r.v[4 * q + 1] = t.y; r.v[4 * q + 2] = t.z; r.v[4 * q + 3] = t.w;
    }
  } else {
    static_assert(V == 1, "float vectors are 1 or a multiple of 4");
    r.v[0] = *p;
  }
  return r;
}

// V bf16: one 16-byte access of 8 (two to a 32-bit word, the first in the
// low half), or one.
template <int V>
__device__ __forceinline__ Pack<V> load(const bf16* p) {
  Pack<V> r;
  if constexpr (V == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r.v[2 * i] = __uint_as_float(w[i] << 16);
      r.v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    static_assert(V == 1, "bf16 vectors are 1 or 8");
    r.v[0] = __bfloat162float(*p);
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Pack<V>& r) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(r.v[4 * q], r.v[4 * q + 1], r.v[4 * q + 2], r.v[4 * q + 3]);
  } else {
    static_assert(V == 1, "float vectors are 1 or a multiple of 4");
    *p = r.v[0];
  }
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

template <int V>
__device__ __forceinline__ void store(bf16* p, const Pack<V>& r) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(r.v[0], r.v[1]), pack_bf16x2(r.v[2], r.v[3]),
                   pack_bf16x2(r.v[4], r.v[5]), pack_bf16x2(r.v[6], r.v[7]));
  } else {
    static_assert(V == 1, "bf16 vectors are 1 or 8");
    *p = __float2bfloat16_rn(r.v[0]);
  }
}
