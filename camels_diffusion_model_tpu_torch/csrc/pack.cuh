// Vectors of V floats (V = 4: one 16-byte access; V = 1: the scalar path)
// for the kernels that keep a thread on the same channels of NHWC rows.

#pragma once

template <int V>
struct Pack {
  float v[V];
};

template <int V>
__device__ __forceinline__ Pack<V> load(const float* p) {
  Pack<V> r;
  if constexpr (V == 4) {
    float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x; r.v[1] = t.y; r.v[2] = t.z; r.v[3] = t.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Pack<V>& r) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
    *p = r.v[0];
  }
}
