// The element of the resident QSPA kernels' stored state (K0 in
// qspa_resident.cu, K0-cl in qspa_cluster.cu and qspa_resident_cl.cu):
// float, or __nv_bfloat16 for mm_precision="bf16", where the prior, the
// posterior and the edge messages are stored rounded to nearest even from
// the f32 arithmetic, as the plain version rounds them
// (kernels/qspa_resident.py, ResidentQSPA._round). The arithmetic stays
// f32 in both.

#pragma once

#include <cuda_bf16.h>

namespace state {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float get(float x) { return x; }
__device__ __forceinline__ float get(bf16 x) { return __bfloat162float(x); }

template <class T>
__device__ __forceinline__ T put(float x);
template <>
__device__ __forceinline__ float put<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 put<bf16>(float x) { return __float2bfloat16_rn(x); }

// x as an element T holds it: x itself for float
template <class T>
__device__ __forceinline__ float rnd(float x) { return get(put<T>(x)); }

// two bf16 in a word, the lower address in the low half
__device__ __forceinline__ void unpack2(unsigned w, float& a, float& b) {
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned pack2(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

// V consecutive elements at p, aligned to their size, into floats: 16-byte
// accesses where V elements fill them, else one access of V elements
template <int V>
__device__ __forceinline__ void load(const float* p, float (&x)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int c = 0; c < V; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + c);
      x[c] = v.x; x[c + 1] = v.y; x[c + 2] = v.z; x[c + 3] = v.w;
    }
  } else {
    static_assert(V == 2, "2, or a multiple of 4, floats");
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  }
}

template <int V>
__device__ __forceinline__ void load(const bf16* p, float (&x)[V]) {
  if constexpr (V % 8 == 0) {
#pragma unroll
    for (int c = 0; c < V; c += 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + c);
      unpack2(v.x, x[c], x[c + 1]);
      unpack2(v.y, x[c + 2], x[c + 3]);
      unpack2(v.z, x[c + 4], x[c + 5]);
      unpack2(v.w, x[c + 6], x[c + 7]);
    }
  } else if constexpr (V == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    unpack2(v.x, x[0], x[1]);
    unpack2(v.y, x[2], x[3]);
  } else {
    static_assert(V == 2, "2, 4 or a multiple of 8 bf16");
    unpack2(*reinterpret_cast<const unsigned*>(p), x[0], x[1]);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&x)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int c = 0; c < V; c += 4)
      *reinterpret_cast<float4*>(p + c) = make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
  } else {
    static_assert(V == 2, "2, or a multiple of 4, floats");
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

template <int V>
__device__ __forceinline__ void store(bf16* p, const float (&x)[V]) {
  if constexpr (V % 8 == 0) {
#pragma unroll
    for (int c = 0; c < V; c += 8)
      *reinterpret_cast<uint4*>(p + c) =
          make_uint4(pack2(x[c], x[c + 1]), pack2(x[c + 2], x[c + 3]),
                     pack2(x[c + 4], x[c + 5]), pack2(x[c + 6], x[c + 7]));
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(x[0], x[1]), pack2(x[2], x[3]));
  } else {
    static_assert(V == 2, "2, 4 or a multiple of 8 bf16");
    *reinterpret_cast<unsigned*>(p) = pack2(x[0], x[1]);
  }
}

}  // namespace state
