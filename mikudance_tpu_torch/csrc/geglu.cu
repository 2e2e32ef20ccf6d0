// GEGLU, hidden * gelu(gate) over the two halves of the last axis, hand-written
// for Hopper (sm_90a).
//
//   K15 md_geglu  replaces no TPU kernel. The JAX package writes the GEGLU as
//      hidden * nn.gelu(gate, approximate=False) (mikudance_tpu/models/layers.py
//      :413, :522) and XLA fuses that chain; eager PyTorch runs it as two passes
//      (gelu over the gate half, then the product), which this kernel fuses.
//      y is (rows, 2I), bf16 or fp32: hidden = y[:, :I], gate = y[:, I:];
//      out is (rows, I) in y's type.
//
// The arithmetic is ATen's, step for step, so that out equals the plain
// hidden * F.gelu(gate) bit for bit: the exact-erf GELU in fp32 as
// x * 0.5f * (1.0f + erff(x * kAlpha)), kAlpha = (float)M_SQRT1_2
// (ActivationGeluKernel.cu), rounded to y's type; then the product in fp32,
// rounded again. No tanh form, no lower precision.
//
// What bounds it on the card: memory. y is read once and out written once,
// 3 * rows * I * sizeof(T) bytes: 0.676 ms at level 0's 294912 rows x I = 1280
// in bf16 at 3.35 TB/s (the two ATen passes move 5 * rows * I * sizeof(T)).
// The design: out is taken as one flat run of 16-byte vectors (8 bf16 or 4
// fp32 values), one a thread, so neighbouring threads load and store
// neighbouring addresses; a thread loads its hidden vector and the gate
// vector I values to its right, then computes. The loads in flight while
// erff runs are those of the other warps: the kernel is built for a full SM
// (8 blocks of 256 threads, 32 registers), which moved more bytes a second
// on an H100 than 2, 4 or 8 vectors a thread at a half or a quarter of the
// warps. Every byte is touched once, so loads and stores carry the
// evict-first hint (ld.global.cs / st.global.cs). The vector's row is its
// index over the row's vector count, a 32-bit division: the wrapper keeps
// the vector count under 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;  // a full SM: 2048 threads

template <typename T> struct Vec16;  // how many T a 16-byte vector holds
template <> struct Vec16<bf16> { static constexpr int N = 8; };
template <> struct Vec16<float> { static constexpr int N = 4; };

// ATen's GeluType::None body for an fp32 opmath value.
__device__ __forceinline__ float gelu(float x) {
  constexpr float kAlpha = M_SQRT1_2;
  return x * 0.5f * (1.0f + erff(x * kAlpha));
}

// hidden * gelu(gate) for one vector of each, as stored.
__device__ __forceinline__ uint4 geglu16(const uint4& hidden, const uint4& gate, bf16) {
  uint4 out;
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&hidden);
  const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(&gate);
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(h[i]), b = __bfloat1622float2(g[i]);
    // the GELU as the bf16 tensor F.gelu returns, then the product's rounding
    const float2 act = __bfloat1622float2(__floats2bfloat162_rn(gelu(b.x), gelu(b.y)));
    o[i] = __floats2bfloat162_rn(a.x * act.x, a.y * act.y);
  }
  return out;
}

__device__ __forceinline__ uint4 geglu16(const uint4& hidden, const uint4& gate, float) {
  return make_uint4(__float_as_uint(__uint_as_float(hidden.x) * gelu(__uint_as_float(gate.x))),
                    __float_as_uint(__uint_as_float(hidden.y) * gelu(__uint_as_float(gate.y))),
                    __float_as_uint(__uint_as_float(hidden.z) * gelu(__uint_as_float(gate.z))),
                    __float_as_uint(__uint_as_float(hidden.w) * gelu(__uint_as_float(gate.w))));
}

// nvec: vectors of out (rows x row_vecs); row_vecs: vectors in a row of out
// (I / V); I: values in a half row.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
geglu_kernel(const T* __restrict__ y, T* __restrict__ out, unsigned nvec, unsigned row_vecs,
             int I) {
  constexpr int V = Vec16<T>::N;
  const unsigned v = blockIdx.x * (unsigned)kThreads + threadIdx.x;
  if (v >= nvec) return;
  const unsigned row = v / row_vecs, col = v - row * row_vecs;
  const T* src = y + (size_t)row * (2 * (size_t)I) + (size_t)col * V;
  const uint4 hidden = __ldcs(reinterpret_cast<const uint4*>(src));
  const uint4 gate = __ldcs(reinterpret_cast<const uint4*>(src + I));
  __stcs(reinterpret_cast<uint4*>(out) + v, geglu16(hidden, gate, T()));
}

template <typename T>
int launch(const void* y, void* out, long long nvec, int I, cudaStream_t stream) {
  constexpr int V = Vec16<T>::N;
  geglu_kernel<T><<<(unsigned)((nvec + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<T*>(out), (unsigned)nvec, (unsigned)(I / V), I);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y: (rows, 2I) contiguous, 16-byte aligned, bf16 (fp32 = 0) or fp32; out:
// (rows, I) contiguous, 16-byte aligned, y's type. The wrapper guarantees I a
// multiple of the 16-byte vector and rows * I / vector < 2^31.
int md_geglu(const void* y, void* out, long long rows, int I, int fp32, void* stream) {
  const int vec = fp32 ? 4 : 8;
  if (rows < 1 || I < vec || I % vec != 0 || rows * (I / vec) > (long long)INT_MAX)
    return cudaErrorInvalidValue;
  const long long nvec = rows * (I / vec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp32 ? launch<float>(y, out, nvec, I, s) : launch<bf16>(y, out, nvec, I, s);
}

}  // extern "C"
