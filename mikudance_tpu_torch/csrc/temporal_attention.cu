// Temporal (cross-frame) attention for the motion modules, hand-written for
// Hopper (sm_90a).
//
//   K3 md_temporal_attention  replaces mikudance_tpu/kernels/temporal_attention.py
//      _temporal_kernel_btpc (:120). Input is the motion module's native
//      (B, T, P, C) bf16 layout with the heads packed in C; for every
//      (batch, position, head) it computes softmax(q k^T / sqrt(hd)) v over
//      the T <= 32 frames, a T x T score matrix.
//
// What bounds it on the card: memory. Each of q, k, v is read once and o is
// written once (4 * B*T*P*C * 2 bytes), against only 4 * T * C multiply-adds
// per position and frame; the T x T matrices are far too small for tensor
// cores. The design: a block takes NP positions of one (batch, head) and
// stages their q, k, v into shared memory as fp32, adjacent threads on
// adjacent channel pairs so the loads coalesce along each position's
// channel run. Scores, the fp32 softmax and P V then run from shared memory
// on the CUDA cores. The TPU kernel's block-diagonal (T*pb)^2 mask trick is
// not carried over: each position's T x T matrix is computed directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFrames = 32;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: q, k, v as [np][T][hd + 1] fp32 (the +1 keeps rows of
// neighbouring frames in different banks), then P as [np][T][T] fp32.
__host__ __device__ inline int row_stride(int hd) { return hd + 1; }

__global__ void __launch_bounds__(kThreads)
temporal_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int T, int P, int C,
                int heads, int np, float scale_log2) {
  extern __shared__ float sm[];
  const int hd = C / heads, ldr = row_stride(hd), half_hd = hd / 2;
  const int p0 = blockIdx.x * np, h = blockIdx.y, b = blockIdx.z;
  const int tile = np * T * ldr;
  float* qs = sm;
  float* ks = qs + tile;
  float* vs = ks + tile;
  float* ps = vs + tile;

  // Stage q, k, v. Index order (t, p, channel pair): consecutive threads read
  // consecutive channel pairs of one position, then the next position.
  for (int i = threadIdx.x; i < T * np * half_hd; i += kThreads) {
    const int c = 2 * (i % half_hd), r = i / half_hd, p = r % np, t = r / np;
    float2 fq = make_float2(0.f, 0.f), fk = fq, fv = fq;
    if (p0 + p < P) {
      const size_t g = (((size_t)b * T + t) * P + p0 + p) * C + h * hd + c;
      fq = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q + g));
      fk = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(k + g));
      fv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v + g));
    }
    const int s = (p * T + t) * ldr + c;
    qs[s] = fq.x; qs[s + 1] = fq.y;
    ks[s] = fk.x; ks[s + 1] = fk.y;
    vs[s] = fv.x; vs[s + 1] = fv.y;
  }
  __syncthreads();

  // Scores in base 2: ps[p][t][u] = q[p][t] . k[p][u] * scale * log2(e)
  for (int i = threadIdx.x; i < np * T * T; i += kThreads) {
    const int u = i % T, r = i / T, p = r / T;
    const float* qr = qs + r * ldr;
    const float* kr = ks + (p * T + u) * ldr;
    float acc = 0.f;
    for (int c = 0; c < hd; ++c) acc = fmaf(qr[c], kr[c], acc);
    ps[i] = acc * scale_log2;
  }
  __syncthreads();

  // Softmax over u, one thread per (p, t) row, fp32
  for (int r = threadIdx.x; r < np * T; r += kThreads) {
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
    for (int u = 0; u < T; ++u) row[u] *= inv;
  }
  __syncthreads();

  // o[t][p][c] = sum_u P[p][t][u] v[p][u][c], written in the load's order
  for (int i = threadIdx.x; i < T * np * half_hd; i += kThreads) {
    const int c = 2 * (i % half_hd), r = i / half_hd, p = r % np, t = r / np;
    if (p0 + p >= P) continue;
    const float* pr = ps + (p * T + t) * T;
    const float* vr = vs + p * T * ldr + c;
    float ax = 0.f, ay = 0.f;
    for (int u = 0; u < T; ++u) {
      const float w = pr[u];
      ax = fmaf(w, vr[u * ldr], ax);
      ay = fmaf(w, vr[u * ldr + 1], ay);
    }
    const size_t g = (((size_t)b * T + t) * P + p0 + p) * C + h * hd + c;
    *reinterpret_cast<__nv_bfloat162*>(o + g) = __floats2bfloat162_rn(ax, ay);
  }
}

}  // namespace

extern "C" {

// q, k, v, o: (batch, frames, positions, channels) bf16, contiguous; the
// wrapper guarantees channels % heads == 0, an even head width and
// frames <= 32.
int md_temporal_attention(const void* q, const void* k, const void* v, void* o, int batch,
                          int frames, int positions, int channels, int heads, void* stream) {
  const int hd = channels / heads;
  if (frames > kMaxFrames || hd % 2 != 0 || channels % heads != 0) return cudaErrorInvalidValue;
  const int np = hd >= 320 ? 1 : 320 / hd;  // ~320 channels of q, k, v per block
  const size_t smem =
      sizeof(float) * ((size_t)3 * np * frames * row_stride(hd) + (size_t)np * frames * frames);
  cudaError_t err =
      cudaFuncSetAttribute(temporal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((positions + np - 1) / np, heads, batch);
  const float scale_log2 = kLog2e / sqrtf((float)hd);
  temporal_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), frames, positions, channels, heads, np, scale_log2);
  return cudaGetLastError();
}

}  // extern "C"
