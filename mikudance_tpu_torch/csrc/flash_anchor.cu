// Anchored packed-heads self-attention with the keys streamed, hand-written
// for Hopper (sm_90a).
//
//   K11 md_flash_anchor_stream    replaces mikudance_tpu/kernels/flash_attention.py
//       _flash_kernel_fullc_stream (:209), the branch of flash_attention_fullc
//       (:278) above its byte limit (the 9216-token level, 8 heads of 40).
//       K10, the branch under it, is flash_anchor_wg.cu.
//
// It computes, per head of (B, S, C) bf16 tensors with the heads packed in C:
//     q'  = q * (log2(e) / sqrt(hd))              fp32
//     off = sum_d q'_d q_d                        fp32, the row's self-score
//     s   = bf16(q') . k                          fp32 accumulation
//     p   = bf16(exp2(clip(s - off, -100, 100)))
//     o   = (sum_j p_j v_j) / (sum_j p_j)         both sums in fp32 over bf16 p
// This is not the exact softmax once the clamp bites; it is what the TPU
// kernel computes. There is no running maximum and so no rescale: the output
// accumulator stays in wmma fragments for the whole key loop and is divided
// once at the end. The denominator is a row sum of the rounded p in the same
// pass that writes p.
//
// What bounds it on the card: tensor-core work and the exponentials (S^2 hd
// multiply-adds against S hd bytes). A block of 8 warps owns 128 query rows of
// one (batch, head), 16 a warp; one tile update (tile_update) takes a tile of
// keys: S = Q K^T into fragments, through a per-warp fp32 scratch for the
// exponentials (two lanes a row), P back as bf16 fragments, O += P V. Key
// tiles are staged through shared memory with cp.async, two stages, a head of
// 40 padded to 48 columns there. Keys past S get p = 0 exactly, and query rows
// past S are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

using namespace nvcuda;
using namespace md_cp;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // query rows a block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClamp = 100.f;

// Shared-memory plan for a tile width D (48 or 80 columns) and a key tile of
// BK. Rows of Q, K and V carry 8 bf16 of padding, score rows 4 floats and P
// rows 8 bf16, so that the 16 rows of a fragment spread over the banks; every
// region size is a multiple of 128 bytes, which keeps wmma's 32-byte rule.
template <int D, int BK>
struct Plan {
  static constexpr int LD = D + 8, LDS = BK + 4, LDP = BK + 8;
  static constexpr int q = kBlockQ * LD * 2;         // scaled Q, bf16
  static constexpr int kv = BK * LD * 2;             // one K or one V tile, bf16
  static constexpr int s = kWarps * 16 * LDS * 4;    // scores, fp32, per warp
  static constexpr int p = kWarps * 16 * LDP * 2;    // p, bf16, per warp
  static_assert(D % 16 == 0 && BK % 16 == 0, "fragment multiples");
  static_assert(q % 128 == 0 && kv % 128 == 0 && s % (kWarps * 128) == 0 &&
                    p % (kWarps * 128) == 0, "regions stay 128-byte aligned");
};

// The block's Q tile: rows [q0, q0 + 128) of head columns [0, HD) at q_bh
// (row stride ld), scaled by scale_log2 and rounded to bf16, into q_s (row
// stride LD) at columns [woff, woff + HD); every other column of the D wide
// tile is zero. Returns the self-score anchor of this lane's row (row
// lane / 2 of the warp's 16), summed in fp32 over the unrounded q'.
template <int HD, int D>
__device__ __forceinline__ float prepare_q(bf16* q_s, const bf16* q_bh, int q0, int seq, int ld,
                                           int woff, float scale_log2) {
  constexpr int LD = D + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < kBlockQ * LD / 8; i += kThreads)
    reinterpret_cast<uint4*>(q_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int row = warp * 16 + lane / 2, half = lane % 2;
  float off = 0.f;
  if (q0 + row < seq) {
    const bf16* src = q_bh + static_cast<size_t>(q0 + row) * ld;
    bf16* dst = q_s + row * LD + woff;
    for (int c = half * 8; c < HD; c += 16) {
      __align__(16) bf16 in[8];
      __align__(16) bf16 out[8];
      *reinterpret_cast<uint4*>(in) = *reinterpret_cast<const uint4*>(src + c);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float raw = __bfloat162float(in[e]);
        const float scaled = raw * scale_log2;
        off += scaled * raw;
        out[e] = __float2bfloat16(scaled);
      }
      *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(out);
    }
  }
  off += __shfl_xor_sync(0xffffffffu, off, 1);
  __syncthreads();
  return off;
}

// One tile update of a warp's 16 query rows (q_w, row stride LDQ) against BK
// keys: kt / vt point at the tile's first key row (global or shared memory,
// row strides ldk / ldv), of which the first kv_valid are real. off is this
// lane's row anchor; l gathers this lane's share of the row sum of p.
template <int D, int BK>
__device__ __forceinline__ void tile_update(
    const bf16* q_w, const bf16* kt, int ldk, const bf16* vt, int ldv, float* s_w, bf16* p_w,
    float off, int kv_valid, wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&oacc)[D / 16],
    float& l) {
  constexpr int LDQ = D + 8, LDS = BK + 4, LDP = BK + 8;
  const int lane = threadIdx.x % 32;
  {  // S = Q K^T
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
    for (int d = 0; d < D; d += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa;
      wmma::load_matrix_sync(qa, q_w + d, LDQ);
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, kt + static_cast<size_t>(n) * 16 * ldk + d, ldk);
        wmma::mma_sync(acc[n], qa, kb, acc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < BK / 16; ++n)
      wmma::store_matrix_sync(s_w + n * 16, acc[n], LDS, wmma::mem_row_major);
  }
  __syncwarp();

  // p = bf16(exp2(clip(s - off))): two lanes a row, column pairs 2 * half,
  // 2 * half + 4, ...; the sum counts what P V will use, the rounded values
  const int row = lane / 2, half = lane % 2;
  const float* srow = s_w + row * LDS;
  bf16* prow = p_w + row * LDP;
  float sum = 0.f;
#pragma unroll 4
  for (int c = 2 * half; c < BK; c += 4) {
    const float2 s = *reinterpret_cast<const float2*>(srow + c);
    const float e0 = c < kv_valid ? exp2f(fminf(fmaxf(s.x - off, -kClamp), kClamp)) : 0.f;
    const float e1 = c + 1 < kv_valid ? exp2f(fminf(fmaxf(s.y - off, -kClamp), kClamp)) : 0.f;
    const __nv_bfloat162 p = __floats2bfloat162_rn(e0, e1);
    *reinterpret_cast<__nv_bfloat162*>(prow + c) = p;
    sum += __low2float(p) + __high2float(p);
  }
  l += sum;
  __syncwarp();

  // O += P V
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa[BK / 16];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) wmma::load_matrix_sync(pa[kk], p_w + kk * 16, LDP);
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
      wmma::load_matrix_sync(vb, vt + static_cast<size_t>(kk) * 16 * ldv + j * 16, ldv);
      wmma::mma_sync(oacc[j], pa[kk], vb, oacc[j]);
    }
  }
}

// O / l -> bf16 for this warp's rows: tile columns [c_lo, c_hi) go to o_w
// (this warp's first output row at the tile's column 0, row stride ld).
// Fragment by fragment through the warp's score scratch; two lanes a row,
// eight columns (one 16-byte store) each.
template <int D, int LDS>
__device__ __forceinline__ void write_out(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&oacc)[D / 16], float l, float* s_w,
    bf16* o_w, int ld, int rows_left, int c_lo, int c_hi) {
  const int lane = threadIdx.x % 32;
  const int row = lane / 2, c8 = (lane % 2) * 8;
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  const float inv = 1.f / l;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::store_matrix_sync(s_w, oacc[j], LDS, wmma::mem_row_major);
    __syncwarp();
    const int col = j * 16 + c8;
    if (row < rows_left && col >= c_lo && col + 8 <= c_hi) {
      const float* src = s_w + row * LDS + c8;
      __align__(16) __nv_bfloat162 out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[e] = __floats2bfloat162_rn(src[2 * e] * inv, src[2 * e + 1] * inv);
      *reinterpret_cast<uint4*>(o_w + static_cast<size_t>(row) * ld + col) =
          *reinterpret_cast<const uint4*>(out);
    }
    __syncwarp();
  }
}

// rows [row0, row0 + ROWS) x HD columns of a matrix with row stride ld ->
// shared memory with row stride LD, by cp.async; rows >= nrows are zero.
template <int ROWS, int HD, int LD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int row0, int nrows,
                                           int ld) {
  constexpr int kVec = HD / 8;
  for (int i = threadIdx.x; i < ROWS * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    const bool ok = row0 + r < nrows;
    cp_async16(dst + r * LD + c, ok ? src + static_cast<size_t>(row0 + r) * ld + c : src, ok);
  }
}

// K11. HD is the head width, D its tile width (40 -> 48, 80 -> 80).
template <int HD, int D, int BK>
__global__ void __launch_bounds__(kThreads, 2)
anchor_stream_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int seq, int heads, int ld,
                     float scale_log2) {
  using L = Plan<D, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  float* s_w = reinterpret_cast<float*>(smem + L::q) + warp * 16 * L::LDS;
  bf16* p_w = reinterpret_cast<bf16*>(smem + L::q + L::s) + warp * 16 * L::LDP;
  bf16* kv_s = reinterpret_cast<bf16*>(smem + L::q + L::s + L::p);  // [stage][K, V][BK][LD]
  constexpr int kTile = BK * L::LD;

  const int q0 = blockIdx.x * kBlockQ;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const size_t head = static_cast<size_t>(b) * seq * ld + h * HD;
  const bf16* k_bh = k + head;
  const bf16* v_bh = v + head;

  // the padding columns of the staged tiles are never written by the copies:
  // zero all four tiles once (K's padding meets Q's zeros in Q K^T, and
  // 0 x garbage could be NaN)
  for (int i = threadIdx.x; i < 4 * kTile / 8; i += kThreads)
    reinterpret_cast<uint4*>(kv_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  const float off = prepare_q<HD, D>(q_s, q + head, q0, seq, ld, 0, scale_log2);  // barriers

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(oacc[j], 0.f);
  float l = 0.f;
  const bf16* q_w = q_s + warp * 16 * L::LD;
  const int tiles = (seq + BK - 1) / BK;
  stage_rows<BK, HD, L::LD>(kv_s, k_bh, 0, seq, ld);
  stage_rows<BK, HD, L::LD>(kv_s + kTile, v_bh, 0, seq, ld);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    bf16* cur = kv_s + (t & 1) * 2 * kTile;
    if (t + 1 < tiles) {  // the other stage was released by the barrier ending tile t - 1
      bf16* nxt = kv_s + ((t + 1) & 1) * 2 * kTile;
      stage_rows<BK, HD, L::LD>(nxt, k_bh, (t + 1) * BK, seq, ld);
      stage_rows<BK, HD, L::LD>(nxt + kTile, v_bh, (t + 1) * BK, seq, ld);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile t has landed
    __syncthreads();
    tile_update<D, BK>(q_w, cur, L::LD, cur + kTile, L::LD, s_w, p_w, off,
                       min(BK, seq - t * BK), oacc, l);
    __syncthreads();
  }
  const int row0 = q0 + warp * 16;
  write_out<D, L::LDS>(oacc, l, s_w, o + head + static_cast<size_t>(row0) * ld, ld, seq - row0, 0,
                       HD);
}

template <typename Kernel>
cudaError_t launch(Kernel kern, int smem, const void* q, const void* k, const void* v, void* o,
                   int batch, int seq, int heads, int hd, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, batch * heads);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), seq, heads, heads * hd, kLog2e / sqrtf(static_cast<float>(hd)));
  return cudaGetLastError();
}

template <int D, int BK>
constexpr int stream_smem() {
  return Plan<D, BK>::q + Plan<D, BK>::s + Plan<D, BK>::p + 4 * Plan<D, BK>::kv;
}

}  // namespace

extern "C" {

// q, k, v, o: (batch, seq, heads * hd) bf16, contiguous, 16-byte aligned,
// hd 40 or 80, any head count.
int md_flash_anchor_stream(const void* q, const void* k, const void* v, void* o, int batch,
                           int seq, int heads, int hd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq < 1) return cudaErrorInvalidValue;
  if (hd == 40)
    return launch(anchor_stream_kernel<40, 48, 64>, stream_smem<48, 64>(), q, k, v, o, batch, seq,
                  heads, hd, s);
  if (hd == 80)
    return launch(anchor_stream_kernel<80, 80, 32>, stream_smem<80, 32>(), q, k, v, o, batch, seq,
                  heads, hd, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
