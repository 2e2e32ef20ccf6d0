// Transposed anchored packed-heads self-attention, hand-written for Hopper
// (sm_90a).
//
//   K12 md_flash_fullc_t  replaces mikudance_tpu/kernels/flash_attention.py
//       _flash_kernel_fullc_t (:357, entry flash_attention_fullc_t :436): the
//       branch of _flash taken with TRANSPOSED_FULLC on and NEUTRAL_FULLC off
//       once a batch element's K and V pass the resident limit (the
//       5184-token level of 576^2 training, the 9216-token level of 768^2).
//
// Per head of (B, S, C) bf16 tensors with the heads packed in C:
//     q'   = q * (log2(e) / sqrt(hd))                 fp32
//     off  = sum_d q'_d q_d                           fp32, the row's self-score
//     s^T  = [k, 1] . [bf16(q'), bf16(-off)]^T        fp32 accumulation
//     p^T  = bf16(exp2(clip(s^T, -100, 100)))
//     o^T  = [v, 1]^T . p^T                           fp32; its last row is sum_j p_j
//     o    = (o^T rows of v)^T / (o^T row of the ones)
// What sets it apart from K10 / K11 is what the TPU kernel folds into its
// products: the anchor is rounded to bf16 and rides the first product as one
// more column of Q against a column of ones in K, so the exponent's argument
// leaves the tensor cores ready for the clamp; and the denominator is the row
// of the second product that meets a column of ones in V. Both columns land in
// the padding that a head of 40 or 80 has anyway in a tile of 48 or 96.
//
// The layout work the TPU entry does in HBM before its kernel (swapaxes of q,
// the ones and zero lanes appended to K and V, V transposed) happens here while
// a tile is staged: the ones columns are written once into the shared-memory
// tiles, whose other columns cp.async refills; the tensors keep their (B, S, C)
// layout. Both products are computed transposed, as on the TPU: S^T = K Q^T
// puts P^T into shared memory as the (keys x queries) right operand that
// O^T = V^T P^T wants, and V is read in place as a column-major left operand.
//
// A block of 8 warps owns 128 query rows of one (batch, head), 16 a warp.
// Key tiles of BK rows are staged with cp.async in two stages. S need not be
// a multiple of anything: keys past S get p = 0 exactly, and query rows past
// S are not written. A head of 40 at an odd index is only 16-byte aligned,
// which is all a staged tile needs.

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
constexpr int kQW = 16;               // query columns of a warp's transposed tiles
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClamp = 100.f;

// Shared-memory plan for a tile width D (48 or 96 columns: the head, the
// ones / anchor column, zeros) and a key tile of BK rows. Rows of Q, K and V
// carry 8 bf16 of padding; a warp's S^T tile is BK x 16 floats with rows of
// 20, its P^T tile BK x 16 bf16 with rows of 24.
template <int D, int BK>
struct Plan {
  static constexpr int LD = D + 8, LDS = kQW + 4, LDP = kQW + 8;
  static constexpr int q = kBlockQ * LD * 2;
  static constexpr int kv = BK * LD * 2;
  static constexpr int s = kWarps * BK * LDS * 4;
  static constexpr int p = kWarps * BK * LDP * 2;
  static constexpr int total = q + s + p + 4 * kv;
  static_assert(D % 16 == 0 && BK % 32 == 0, "fragment multiples; a lane a key row");
  static_assert(q % 128 == 0 && kv % 128 == 0 && s % (kWarps * 128) == 0 &&
                    p % (kWarps * 128) == 0, "regions stay 128-byte aligned");
};

// The block's augmented Q tile: rows [q0, q0 + 128) of the head at q_bh (row
// stride ld), scaled and rounded to bf16 in columns [0, HD), bf16(-off) in
// column HD, zeros beyond; rows past seq are all zero.
template <int HD, int D>
__device__ __forceinline__ void prepare_q(bf16* q_s, const bf16* q_bh, int q0, int seq, int ld,
                                          float scale_log2) {
  constexpr int LD = D + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < kBlockQ * LD / 8; i += kThreads)
    reinterpret_cast<uint4*>(q_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int row = warp * 16 + lane / 2, half = lane % 2;
  float off = 0.f;
  const bool live = q0 + row < seq;
  if (live) {
    const bf16* src = q_bh + static_cast<size_t>(q0 + row) * ld;
    bf16* dst = q_s + row * LD;
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
  if (live && half == 0) q_s[row * LD + HD] = __float2bfloat16(-off);
  __syncthreads();
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

// One tile update of a warp's 16 queries (q_w: their augmented rows) against
// the BK staged keys kt / vt, of which the first kv_valid are real.
template <int D, int BK>
__device__ __forceinline__ void tile_update(
    const bf16* q_w, const bf16* kt, const bf16* vt, float* s_w, bf16* p_w, int kv_valid,
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&oacc)[D / 16]) {
  using L = Plan<D, BK>;
  const int lane = threadIdx.x % 32;
  {  // S^T = K_aug Q_aug^T: already s - off in the log2 domain
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
    for (int m = 0; m < BK / 16; ++m) wmma::fill_fragment(acc[m], 0.f);
#pragma unroll
    for (int d = 0; d < D; d += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> qb;
      wmma::load_matrix_sync(qb, q_w + d, L::LD);
#pragma unroll
      for (int m = 0; m < BK / 16; ++m) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ka;
        wmma::load_matrix_sync(ka, kt + m * 16 * L::LD + d, L::LD);
        wmma::mma_sync(acc[m], ka, qb, acc[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < BK / 16; ++m)
      wmma::store_matrix_sync(s_w + m * 16 * L::LDS, acc[m], L::LDS, wmma::mem_row_major);
  }
  __syncwarp();

  // p^T = bf16(exp2(clip(s^T))): a lane a key row, its 16 queries
#pragma unroll
  for (int r = lane; r < BK; r += 32) {
    const float* srow = s_w + r * L::LDS;
    __align__(16) __nv_bfloat162 out[kQW / 2];
    const bool real = r < kv_valid;
#pragma unroll
    for (int c = 0; c < kQW; c += 4) {
      const float4 s = *reinterpret_cast<const float4*>(srow + c);
      const float e0 = real ? exp2f(fminf(fmaxf(s.x, -kClamp), kClamp)) : 0.f;
      const float e1 = real ? exp2f(fminf(fmaxf(s.y, -kClamp), kClamp)) : 0.f;
      const float e2 = real ? exp2f(fminf(fmaxf(s.z, -kClamp), kClamp)) : 0.f;
      const float e3 = real ? exp2f(fminf(fmaxf(s.w, -kClamp), kClamp)) : 0.f;
      out[c / 2] = __floats2bfloat162_rn(e0, e1);
      out[c / 2 + 1] = __floats2bfloat162_rn(e2, e3);
    }
    uint4* prow = reinterpret_cast<uint4*>(p_w + r * L::LDP);
    prow[0] = reinterpret_cast<const uint4*>(out)[0];
    prow[1] = reinterpret_cast<const uint4*>(out)[1];
  }
  __syncwarp();

  // O^T += V_aug^T P^T: V read in place as the column-major left operand
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> pb[BK / 16];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wmma::load_matrix_sync(pb[kk], p_w + kk * 16 * L::LDP, L::LDP);
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> va;
      wmma::load_matrix_sync(va, vt + kk * 16 * L::LD + j * 16, L::LD);
      wmma::mma_sync(oacc[j], va, pb[kk], oacc[j]);
    }
  }
  __syncwarp();
}

// HD is the head width, D its tile width (40 -> 48, 80 -> 96).
template <int HD, int D, int BK>
__global__ void __launch_bounds__(kThreads, 2)
fullc_t_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int seq, int heads, int ld,
               float scale_log2) {
  using L = Plan<D, BK>;
  static_assert(HD < D && HD % 8 == 0, "the ones column lives in the tile's padding");
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  float* s_w = reinterpret_cast<float*>(smem + L::q) + warp * BK * L::LDS;
  bf16* p_w = reinterpret_cast<bf16*>(smem + L::q + L::s) + warp * BK * L::LDP;
  bf16* kv_s = reinterpret_cast<bf16*>(smem + L::q + L::s + L::p);  // [stage][K, V][BK][LD]
  constexpr int kTile = BK * L::LD;

  const int q0 = blockIdx.x * kBlockQ;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const size_t head = static_cast<size_t>(b) * seq * ld + h * HD;
  const bf16* k_bh = k + head;
  const bf16* v_bh = v + head;

  // the staged tiles' columns past the head are never touched by the copies:
  // ones in column HD of K (meets -off) and of V (sums p), zeros elsewhere
  const bf16 one = __float2bfloat16(1.f), zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < 4 * kTile; i += kThreads) kv_s[i] = (i % L::LD == HD) ? one : zero;
  prepare_q<HD, D>(q_s, q + head, q0, seq, ld, scale_log2);  // ends with a barrier

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(oacc[j], 0.f);
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
    tile_update<D, BK>(q_w, cur, cur + kTile, s_w, p_w, min(BK, seq - t * BK), oacc);
    __syncthreads();
  }

  // O^T fragments are (16 channels x 16 queries): stored column-major they
  // read as [query][channel]. The fragment that holds row HD comes first, for
  // the denominators; two lanes a query, eight channels (16 bytes) each.
  const int row = lane / 2, c8 = (lane % 2) * 8;
  const int rows_left = seq - (q0 + warp * 16);
  wmma::store_matrix_sync(s_w, oacc[HD / 16], L::LDS, wmma::mem_col_major);
  __syncwarp();
  const float inv = 1.f / s_w[row * L::LDS + HD % 16];
  __syncwarp();
  bf16* o_w = o + head + static_cast<size_t>(q0 + warp * 16) * ld;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::store_matrix_sync(s_w, oacc[j], L::LDS, wmma::mem_col_major);
    __syncwarp();
    const int col = j * 16 + c8;
    if (row < rows_left && col + 8 <= HD) {
      const float* src = s_w + row * L::LDS + c8;
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

}  // namespace

extern "C" {

// q, k, v, o: (batch, seq, heads * hd) bf16, contiguous, 16-byte aligned,
// hd 40 or 80; any seq >= 1.
int md_flash_fullc_t(const void* q, const void* k, const void* v, void* o, int batch, int seq,
                     int heads, int hd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq < 1) return cudaErrorInvalidValue;
  if (hd == 40)
    return launch(fullc_t_kernel<40, 48, 64>, Plan<48, 64>::total, q, k, v, o, batch, seq, heads,
                  hd, s);
  if (hd == 80)
    return launch(fullc_t_kernel<80, 96, 32>, Plan<96, 32>::total, q, k, v, o, batch, seq, heads,
                  hd, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
