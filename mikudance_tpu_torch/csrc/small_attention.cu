// Attention over many short, independent sequences, hand-written for Hopper
// (sm_90a).
//
//   K13 md_small_attention  replaces mikudance_tpu/kernels/temporal_attention.py
//       _temporal_kernel (:29, entry temporal_attention_fused). Input is
//       (N, T, C) bf16 with T <= 32 tokens a sequence and the heads packed in
//       C (8 heads of 40, 80 or 160); every sequence attends to itself only:
//       softmax(q k^T / sqrt(hd)) v per (sequence, head). The UNet mid-block's
//       spatial self-attention takes it when its map has at most 32 tokens
//       and the batch at least 64 frames.
//
// What bounds it on the card: memory, and at the model's sizes the launch
// itself. q, k, v are read once and o written once against 4 T C
// multiply-adds a token; T x T score matrices are too small for the tensor
// cores. The design: a block owns one sequence and a group of heads that
// spans about 320 channels, so every row it loads is one contiguous run of
// channels; q, k, v are staged as fp32 in shared memory, adjacent threads on
// adjacent channel pairs. Scores, the fp32 softmax and P V run from shared
// memory on the CUDA cores; the weights are rounded to bf16 before P V, as
// the TPU body casts them. The TPU kernel's block-diagonal mask exists only
// because a TPU tile packs several sequences; here a block never sees two.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTokens = 32;
constexpr int kGroupChannels = 320;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: q, k, v as [hg][T][hd + 1] fp32 (the +1 keeps the rows of
// neighbouring tokens in different banks), then P as [hg][T][T] fp32.
__host__ __device__ inline int row_stride(int hd) { return hd + 1; }

__global__ void __launch_bounds__(kThreads)
small_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, int T, int C, int hd,
                       int hg, float scale_log2) {
  extern __shared__ float sm[];
  const int ldr = row_stride(hd), half_gc = hg * hd / 2;
  const int c0 = blockIdx.y * hg * hd;                 // first channel of this head group
  const size_t seq0 = (size_t)blockIdx.x * T * C + c0;  // token 0 of this sequence
  const int tile = hg * T * ldr;
  float* qs = sm;
  float* ks = qs + tile;
  float* vs = ks + tile;
  float* ps = vs + tile;

  // Stage q, k, v: consecutive threads on consecutive channel pairs of one
  // token's run of hg * hd channels. A pair never straddles heads (hd even).
  for (int i = threadIdx.x; i < T * half_gc; i += kThreads) {
    const int cc = 2 * (i % half_gc), t = i / half_gc, h = cc / hd, c = cc % hd;
    const size_t g = seq0 + (size_t)t * C + cc;
    const float2 fq = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q + g));
    const float2 fk = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(k + g));
    const float2 fv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v + g));
    const int s = (h * T + t) * ldr + c;
    qs[s] = fq.x; qs[s + 1] = fq.y;
    ks[s] = fk.x; ks[s + 1] = fk.y;
    vs[s] = fv.x; vs[s + 1] = fv.y;
  }
  __syncthreads();

  // Scores in base 2: ps[h][t][u] = q[h][t] . k[h][u] * scale * log2(e)
  for (int i = threadIdx.x; i < hg * T * T; i += kThreads) {
    const int u = i % T, r = i / T, h = r / T;
    const float* qr = qs + r * ldr;
    const float* kr = ks + (h * T + u) * ldr;
    float acc = 0.f;
    for (int c = 0; c < hd; ++c) acc = fmaf(qr[c], kr[c], acc);
    ps[i] = acc * scale_log2;
  }
  __syncthreads();

  // Softmax over u, one thread per (h, t) row, fp32; the weights rounded to
  // bf16 as the P V product takes them
  for (int r = threadIdx.x; r < hg * T; r += kThreads) {
    float* row = ps + r * T;
    float mx = -INFINITY;
    for (int u = 0; u < T; ++u) mx = fmaxf(mx, row[u]);
    float sum = 0.f;
    for (int u = 0; u < T; ++u) {
      const float e = exp2f(row[u] - mx);
      row[u] = e;
      sum += e;
    }
    const float inv = 1.f / sum;
    for (int u = 0; u < T; ++u) row[u] = __bfloat162float(__float2bfloat16(row[u] * inv));
  }
  __syncthreads();

  // o[t][h][c] = sum_u P[h][t][u] v[h][u][c], written in the load's order
  for (int i = threadIdx.x; i < T * half_gc; i += kThreads) {
    const int cc = 2 * (i % half_gc), t = i / half_gc, h = cc / hd, c = cc % hd;
    const float* pr = ps + (h * T + t) * T;
    const float* vr = vs + h * T * ldr + c;
    float ax = 0.f, ay = 0.f;
    for (int u = 0; u < T; ++u) {
      const float w = pr[u];
      ax = fmaf(w, vr[u * ldr], ax);
      ay = fmaf(w, vr[u * ldr + 1], ay);
    }
    *reinterpret_cast<__nv_bfloat162*>(o + seq0 + (size_t)t * C + cc) =
        __floats2bfloat162_rn(ax, ay);
  }
}

}  // namespace

extern "C" {

// q, k, v, o: (sequences, tokens, channels) bf16, contiguous and 4-byte
// aligned; the wrapper guarantees channels % heads == 0, an even head width
// and tokens <= 32.
int md_small_attention(const void* q, const void* k, const void* v, void* o, int sequences,
                       int tokens, int channels, int heads, void* stream) {
  if (heads < 1 || channels % heads != 0) return cudaErrorInvalidValue;
  const int hd = channels / heads;
  if (tokens < 1 || tokens > kMaxTokens || hd % 2 != 0 || sequences < 1)
    return cudaErrorInvalidValue;
  // heads a block: the largest divisor of `heads` spanning <= ~320 channels
  int hg = 1;
  for (int g = 1; g <= heads; ++g)
    if (heads % g == 0 && g * hd <= kGroupChannels) hg = g;
  const size_t smem =
      sizeof(float) * ((size_t)3 * hg * tokens * row_stride(hd) + (size_t)hg * tokens * tokens);
  cudaError_t err = cudaFuncSetAttribute(small_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(sequences, heads / hg);
  small_attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), tokens, channels, hd, hg, kLog2e / sqrtf((float)hd));
  return cudaGetLastError();
}

}  // extern "C"
