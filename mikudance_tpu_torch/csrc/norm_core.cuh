// The norm core: helpers shared by GroupNorm K5 (group_norm.cu) and LayerNorm
// K6 (layer_norm.cu), hand-written for Hopper (sm_90a). Both are bound by
// memory, so both move x and y as 16-byte vectors (8 bf16 or 4 fp32
// values), take their moments in fp32 (K5 folds them on in double), and end
// in the same affine (+SiLU) epilogue before the one cast to x's type.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace md_norm {

typedef __nv_bfloat16 bf16;

template <typename T> struct Vec16;  // how many T a 16-byte vector holds
template <> struct Vec16<bf16> { static constexpr int N = 8; };
template <> struct Vec16<float> { static constexpr int N = 4; };

// One 16-byte vector as it is stored; a kernel keeps several in flight
// before it converts them.
__device__ __forceinline__ uint4 load_raw16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// A stored vector as floats: 8 bf16 or 4 fp32 values.
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x); v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z); v[3] = __uint_as_float(raw.w);
}

// One 16-byte vector of x's type, from global or shared memory, as floats.
template <typename T, int V>
__device__ __forceinline__ void load16(const T* p, float (&v)[V]) {
  static_assert(V == Vec16<T>::N, "a 16-byte vector of T");
  unpack(load_raw16(p), v);
}

__device__ __forceinline__ void store16(bf16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// V consecutive weight or bias values from element c (c a multiple of V, the
// tensor 16-byte aligned), stored as P (fp32 or bf16), as floats: one or two
// vector loads.
template <int V>
__device__ __forceinline__ void load_params(const float* p, int c, float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 raw = *reinterpret_cast<const float4*>(p + c + i);
    v[i] = raw.x; v[i + 1] = raw.y; v[i + 2] = raw.z; v[i + 3] = raw.w;
  }
}

template <int V>
__device__ __forceinline__ void load_params(const bf16* p, int c, float (&v)[V]) {
  static_assert(V == 4 || V == 8, "a parameter run is 4 or 8 values");
  if constexpr (V == 8) {
    unpack(load_raw16(p + c), v);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
}

// One weight or bias value, stored as fp32 or bf16.
__device__ __forceinline__ float param(const void* p, int i, int is_fp32) {
  return is_fp32 ? static_cast<const float*>(p)[i]
                 : __bfloat162float(static_cast<const bf16*>(p)[i]);
}

// Sum over the L lanes of an aligned lane group (L = 2, 4, ..., 32): every
// shuffle offset is under L, so a group never reads a neighbour's lanes.
// Every lane of the warp takes part.
template <typename S>
__device__ __forceinline__ S group_sum(S v, int L) {
  for (int off = L / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// y = x * a + b, then y * sigmoid(y) under SILU; fp32 throughout.
template <bool SILU>
__device__ __forceinline__ float affine(float x, float a, float b) {
  float t = fmaf(x, a, b);
  if (SILU) t = __fdividef(t, 1.f + __expf(-t));  // 0 where exp(-t) overflows: t * 0
  return t;
}

// 16 bytes global -> shared without passing through registers (L1 bypassed).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `pending` (0-3) of this thread's committed groups are
// still in flight.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

}  // namespace md_norm
