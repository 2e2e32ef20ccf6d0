// Row LayerNorm over the last axis, hand-written for Hopper (sm_90a).
//
//   K6 md_layer_norm  replaces mikudance_tpu/kernels/layer_norm.py _ln_kernel
//      (:51). x is (rows, C), bf16 or fp32; per row the mean, then the centred
//      variance, in fp32 from the row held on chip; y = (x - mean) *
//      rsqrt(var + eps) * w + b, cast to x's type.
//
// What bounds it on the card: memory, one read and one write of x. The
// design: one warp per row, the whole row in registers, so x is read from
// device memory exactly once and both statistics passes run on registers
// (the TPU kernel holds a block of rows in VMEM for the same reason). The
// widths on the path are 320, 640, 1280 and 1024: 320 / 32 lanes = 10 values
// a lane, which 16-byte loads do not divide, so a lane loads pairs (4 bytes
// of bf16): lane l owns pairs l, l + 32, ... and a warp's load covers 128
// contiguous bytes. Sums cross the lanes by shuffles. Rows are independent,
// so blocks need no order and nothing is carried between them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPairsPerLane = 20;  // C <= 1280

__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// weight / bias pair at element 2 * p, stored as fp32 or bf16
__device__ __forceinline__ float2 param_pair(const void* w, int p, int is_fp32) {
  return is_fp32 ? static_cast<const float2*>(w)[p]
                 : __bfloat1622float2(static_cast<const __nv_bfloat162*>(w)[p]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// PAIRS = pairs a lane holds at most: ceil(C / 64) <= PAIRS.
template <typename T, int PAIRS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ln_kernel(const T* __restrict__ x, const void* __restrict__ w, const void* __restrict__ b,
          int w_fp32, T* __restrict__ y, long long rows, int C, float eps) {
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x % 32, pairs = C / 2;
  const T* xr = x + row * C;
  T* yr = y + row * C;

  float2 v[PAIRS];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < PAIRS; ++k) {
    const int p = k * 32 + lane;
    v[k] = p < pairs ? load_pair(xr + 2 * p) : make_float2(0.f, 0.f);
    sum += v[k].x + v[k].y;
  }
  const float mean = warp_sum(sum) / (float)C;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < PAIRS; ++k) {
    if (k * 32 + lane < pairs) {
      const float dx = v[k].x - mean, dy = v[k].y - mean;
      sq = fmaf(dx, dx, fmaf(dy, dy, sq));
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / (float)C + eps);
#pragma unroll
  for (int k = 0; k < PAIRS; ++k) {
    const int p = k * 32 + lane;
    if (p < pairs) {
      const float2 ww = param_pair(w, p, w_fp32), bb = param_pair(b, p, w_fp32);
      store_pair(yr + 2 * p, fmaf((v[k].x - mean) * inv, ww.x, bb.x),
                 fmaf((v[k].y - mean) * inv, ww.y, bb.y));
    }
  }
}

template <typename T>
int layer_norm(const T* x, const void* w, const void* b, int w_fp32, T* y, long long rows, int C,
               float eps, cudaStream_t stream) {
  const unsigned grid = (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int threads = kWarpsPerBlock * 32, per_lane = (C / 2 + 31) / 32;
  if (per_lane <= 5)
    ln_kernel<T, 5><<<grid, threads, 0, stream>>>(x, w, b, w_fp32, y, rows, C, eps);
  else if (per_lane <= 10)
    ln_kernel<T, 10><<<grid, threads, 0, stream>>>(x, w, b, w_fp32, y, rows, C, eps);
  else
    ln_kernel<T, kMaxPairsPerLane><<<grid, threads, 0, stream>>>(x, w, b, w_fp32, y, rows, C, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (rows, C) contiguous, bf16 (x_fp32 = 0) or fp32, aligned to a pair;
// w, b: (C,) fp32 (w_fp32 = 1) or bf16. The wrapper guarantees an even
// C <= 1280 and rows >= 1.
int md_layer_norm(const void* x, const void* w, const void* b, void* y, long long rows, int C,
                  float eps, int x_fp32, int w_fp32, void* stream) {
  if (C % 2 != 0 || C > 64 * kMaxPairsPerLane || rows < 1 ||
      (rows + kWarpsPerBlock - 1) / kWarpsPerBlock > 2147483647LL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_fp32)
    return layer_norm<float>(static_cast<const float*>(x), w, b, w_fp32, static_cast<float*>(y),
                             rows, C, eps, s);
  return layer_norm<bf16>(static_cast<const bf16*>(x), w, b, w_fp32, static_cast<bf16*>(y), rows,
                          C, eps, s);
}

}  // extern "C"
