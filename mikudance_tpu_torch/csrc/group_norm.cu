// GroupNorm(+SiLU) on channels-last feature maps, hand-written for Hopper
// (sm_90a).
//
//   K5 md_group_norm  replaces mikudance_tpu/kernels/group_norm.py
//      _stats_kernel (:51) + _apply_kernel (:61) and the glue between them.
//      x is (N, rows, C) with rows = H * W, bf16 or fp32; per image and group
//      the mean and the variance max(E[x^2] - mean^2, 0) are taken in fp32
//      over rows x (C / G) values; y = x * a + b with a = w * rsqrt(var + eps),
//      b = bias - mean * a, optionally y * sigmoid(y), all in fp32 before the
//      one cast to x's type.
//
// What bounds it on the card: memory. x is read twice and y written once
// against a handful of operations per element. The design follows from
// that and from the shapes it meets (N from 1 to 32, rows from 144 to 9.4
// million, C / G from 4 to 80, not always a power of two):
//
// 1. stats: the TPU kernel walks an image's rows in order on one core; here
//    every image's rows are split over many blocks (one block per image
//    would leave 131 SMs idle when N = 1). A thread owns one 16-byte column
//    vector (8 bf16 channels) and strides over its block's rows, so loads
//    coalesce along the channel run and sums stay per channel: vectors that
//    straddle two groups (C / G = 10, 30) need no special case. A thread
//    adds at most 256 values into each fp32 accumulator; the row lanes of a
//    block are folded through shared memory into one partial per (image,
//    split, channel). No atomics: two runs give the same bits.
// 2. finish: one block per (image, group) folds splits and the group's
//    channels in double precision (a group of the tallest map pools 37.7
//    million values), clamps the variance at 0 and writes a and b per
//    channel.
// 3. apply: one 16-byte vector per thread, y = x * a + b (+ SiLU), offsets
//    in 64 bits (the tallest map holds 2.4 GB).
//
// The wrapper (kernels/group_norm.py) picks the split and allocates the
// scratch: partial sums (N, splits, 2, C) then a, b as (N, 2, C), fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kFinishThreads = 256;
constexpr int kApplyThreads = 256;

template <typename T> struct Vec16;  // how many T a 16-byte vector holds
template <> struct Vec16<bf16> { static constexpr int N = 8; };
template <> struct Vec16<float> { static constexpr int N = 4; };

__device__ __forceinline__ void load16(const bf16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  v[0] = raw.x; v[1] = raw.y; v[2] = raw.z; v[3] = raw.w;
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

// weight / bias element i, stored as fp32 or bf16
__device__ __forceinline__ float param(const void* p, int i, int is_fp32) {
  return is_fp32 ? static_cast<const float*>(p)[i]
                 : __bfloat162float(static_cast<const bf16*>(p)[i]);
}

// Block = lanes x chunk_w threads: thread (lane, col) owns column vector
// chunk * chunk_w + col and the rows r0 + lane, r0 + lane + lanes, ... of
// split blockIdx.x. Grid (splits, chunks, N).
template <typename T>
__global__ void gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                                long long rows, int C, int chunk_w, int lanes,
                                int rows_per_block, int splits) {
  constexpr int V = Vec16<T>::N;
  extern __shared__ float sm[];  // [lanes][chunk_w][2 * V]
  const int split = blockIdx.x, chunk = blockIdx.y, n = blockIdx.z;
  const int col = threadIdx.x % chunk_w, lane = threadIdx.x / chunk_w;
  const int cv = chunk * chunk_w + col;
  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
  const long long r0 = (long long)split * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  if (cv * V < C) {
    const T* base = x + (long long)n * rows * C + (long long)cv * V;
#pragma unroll 4
    for (long long r = r0 + lane; r < r1; r += lanes) {
      float v[V];
      load16(base + r * C, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[i] += v[i];
        q[i] = fmaf(v[i], v[i], q[i]);
      }
    }
  }
  float* mine = sm + (size_t)threadIdx.x * 2 * V;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mine[i] = s[i];
    mine[V + i] = q[i];
  }
  __syncthreads();
  // fold the row lanes: output o = (col, k), k < V a sum, k >= V a sum of squares
  const int outs = chunk_w * 2 * V;
  for (int o = threadIdx.x; o < outs; o += blockDim.x) {
    float acc = 0.f;
    for (int l = 0; l < lanes; ++l) acc += sm[(size_t)l * outs + o];
    const int k = o % (2 * V);
    const int c = (chunk * chunk_w + o / (2 * V)) * V + k % V;
    if (c < C) partial[(((size_t)n * splits + split) * 2 + k / V) * C + c] = acc;
  }
}

__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double total = 0.0;
  for (int w = 0; w < kFinishThreads / 32; ++w) total += red[w];
  return total;
}

// Grid (G, N). Folds partial sums over splits and the group's channels, then
// writes a, b for the group's channels into ab (N, 2, C).
__global__ void __launch_bounds__(kFinishThreads)
gn_finish_kernel(const float* __restrict__ partial, const void* __restrict__ w,
                 const void* __restrict__ b, int w_fp32, float* __restrict__ ab, int C, int G,
                 int splits, double count, float eps) {
  __shared__ double red[kFinishThreads / 32];
  const int g = blockIdx.x, n = blockIdx.y, cpg = C / G;
  double s = 0.0, q = 0.0;
  const long long total = (long long)splits * cpg;
  for (long long i = threadIdx.x; i < total; i += kFinishThreads) {
    const long long sp = i / cpg;
    const int j = (int)(i % cpg);
    const size_t at = (((size_t)n * splits + sp) * 2) * C + g * cpg + j;
    s += (double)partial[at];
    q += (double)partial[at + C];
  }
  s = block_sum(s, red);
  q = block_sum(q, red);
  const double mu = s / count;
  const double var = fmax(q / count - mu * mu, 0.0);
  const float inv = (float)(1.0 / sqrt(var + (double)eps));
  for (int j = threadIdx.x; j < cpg; j += kFinishThreads) {
    const int c = g * cpg + j;
    const float a = inv * param(w, c, w_fp32);
    ab[(size_t)n * 2 * C + c] = a;
    ab[(size_t)n * 2 * C + C + c] = param(b, c, w_fp32) - (float)mu * a;
  }
}

// Grid (ceil(vecs_per_image / threads), N): one 16-byte vector per thread.
template <typename T, bool SILU>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ ab, T* __restrict__ y,
                long long vecs_per_image, int C) {
  constexpr int V = Vec16<T>::N;
  const long long i = (long long)blockIdx.x * kApplyThreads + threadIdx.x;
  if (i >= vecs_per_image) return;
  const int n = blockIdx.y;
  const int c0 = (int)(i % (C / V)) * V;
  const long long at = ((long long)n * vecs_per_image + i) * V;
  const float* a = ab + (size_t)n * 2 * C + c0;
  const float* b = a + C;
  float v[V];
  load16(x + at, v);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float t = fmaf(v[k], a[k], b[k]);
    if (SILU) t = t / (1.f + __expf(-t));
    v[k] = t;
  }
  store16(y + at, v);
}

template <typename T>
int group_norm(const T* x, const void* w, const void* b, T* y, float* scratch, int N,
               long long rows, int C, int G, float eps, int silu, int w_fp32, int rows_per_block,
               int splits, int chunk_w, int lanes, cudaStream_t stream) {
  constexpr int V = Vec16<T>::N;
  const int CV = C / V;
  const int chunks = (CV + chunk_w - 1) / chunk_w;
  float* partial = scratch;
  float* ab = scratch + (size_t)N * splits * 2 * C;

  const int threads = chunk_w * lanes;
  const size_t smem = sizeof(float) * (size_t)threads * 2 * V;
  gn_stats_kernel<T><<<dim3(splits, chunks, N), threads, smem, stream>>>(
      x, partial, rows, C, chunk_w, lanes, rows_per_block, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const double count = (double)rows * (double)(C / G);
  gn_finish_kernel<<<dim3(G, N), kFinishThreads, 0, stream>>>(partial, w, b, w_fp32, ab, C, G,
                                                              splits, count, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long vecs = rows * CV;
  const dim3 grid((unsigned)((vecs + kApplyThreads - 1) / kApplyThreads), N);
  if (silu)
    gn_apply_kernel<T, true><<<grid, kApplyThreads, 0, stream>>>(x, ab, y, vecs, C);
  else
    gn_apply_kernel<T, false><<<grid, kApplyThreads, 0, stream>>>(x, ab, y, vecs, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (N, rows, C) contiguous, bf16 (x_fp32 = 0) or fp32, 16-byte aligned;
// w, b: (C,) fp32 (w_fp32 = 1) or bf16; scratch: fp32, N * (splits + 1) * 2 * C
// values. The wrapper guarantees C % G == 0, C a multiple of the 16-byte
// vector, chunk_w * lanes <= 1024 threads and N <= 65535, and picks
// rows_per_block, splits = ceil(rows / rows_per_block), chunk_w and lanes.
int md_group_norm(const void* x, const void* w, const void* b, void* y, void* scratch, int N,
                  long long rows, int C, int G, float eps, int silu, int x_fp32, int w_fp32,
                  int rows_per_block, int splits, int chunk_w, int lanes, void* stream) {
  const int vec = x_fp32 ? 4 : 8;
  if (C % G != 0 || C % vec != 0 || chunk_w * lanes > 1024 || chunk_w < 1 || lanes < 1 ||
      N > 65535 || (long long)splits * rows_per_block < rows)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (x_fp32)
    return group_norm<float>(static_cast<const float*>(x), w, b, static_cast<float*>(y), sc, N,
                             rows, C, G, eps, silu, w_fp32, rows_per_block, splits, chunk_w,
                             lanes, s);
  return group_norm<bf16>(static_cast<const bf16*>(x), w, b, static_cast<bf16*>(y), sc, N, rows,
                          C, G, eps, silu, w_fp32, rows_per_block, splits, chunk_w, lanes, s);
}

}  // extern "C"
