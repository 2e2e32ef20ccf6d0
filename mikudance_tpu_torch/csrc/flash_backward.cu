// The backward of multi-head softmax attention, hand-written for Hopper
// (sm_90a): the gradients of q, k and v from q, k, v and the output's
// gradient g, with the exact softmax recomputed from q and k.
//
//   K16 md_flash_backward  replaces no TPU kernel: the JAX package's
//      backward of every ``_flash`` route is plain jnp math under its
//      custom_vjp (``_flash_bwd``, mikudance_tpu/kernels/flash_attention.py:823),
//      which XLA fuses; its plain PyTorch version is
//      ``kernels/_autograd.py::flash_backward_plain``, a chunked recompute that
//      writes an fp32 (B, heads, chunk, S_kv) score buffer per chunk of
//      queries. Heads of 40, 64 and 80 packed in C; any S_q and S_kv >= 1.
//
// What bounds it on the card: the products. At the 576^2 trainer's level 0,
// (20, 5184, 320) in 8 heads of 40, the least work is seven S x S_kv x hd
// products a head (a statistics pass's Q K^T and G V^T, then Q K^T, G V^T,
// P^T G, dS^T Q, dS K): 2.4 TFLOP, 2.4 ms at the bf16 tensor peak. This design
// runs nine (the rows kernel's second pass recomputes Q K^T and G V^T rather
// than add dQ through atomics) and 12.9 G exponentials; q, k, v, g and the
// three gradients are 0.2 GB. The plain version moves ~16 fp32 score buffers
// of 0.48 GB per chunk of 144 queries.
//
// Design: two kernels on mma.sync m16n8k16 (mma_sync.cuh), bf16 operands
// from shared memory by ldmatrix, fp32 sums in registers; no score, P or dS
// ever reaches device memory, and no atomics (the result does not depend on
// the schedule).
//
// 1. Rows (attn_bwd_rows_kernel): a block owns 16 query rows a warp of one
//    (batch, head), its Q and G rows as register fragments, and streams the
//    head's K and V in tiles of 64 keys through a two-stage cp.async ring.
//    Pass 1, the statistics: S = Q K^T and dP = G V^T, the online row maximum
//    m and sum l of exp(S scale) and a = sum_j exp(s_j - m) dp_j, all fp32
//    from the unrounded p; then lse = m + log2 l (base 2) and delta = a / l =
//    sum_j p_j dp_j, the plain version's (dp * p).sum(-1). Written to a
//    (B heads, S_q padded) scratch for the columns kernel. Pass 2 (where dq
//    is wanted) walks the keys again: p = 2^(s - lse), ds = p (dp - delta) in
//    fp32, rounded to bf16 as the A operand of dQ += dS K (the FA2 register
//    reuse); dQ scale leaves as bf16.
// 2. Columns (attn_bwd_cols_kernel, where dk or dv is wanted): a block owns
//    16 keys a warp, their K and V rows as register fragments, and streams
//    the head's Q, G, lse and delta in tiles of 64 queries. Per 16 queries:
//    S^T = K Q^T, dP^T = V G^T (keys as rows, so P^T and dS^T are already the
//    A operands), p = 2^(s - lse), P^T rounded to bf16 for dV += P^T G,
//    dS^T = p (dp - delta) rounded to bf16 for dK += dS^T Q. dK scale and dV
//    leave as bf16.
// The roundings are the plain version's: p to bf16 before P^T G, ds to bf16
// before dS K and dS^T Q, every product sum fp32. Keys past S_kv are zero rows
// with p = 0; queries past S_q are zero rows of Q and G, whose finite
// statistics give ds = 0 and a zero G row, so they add nothing.
// A head of 40 runs its Q K^T and G V^T over 48 columns, the pad zeroed once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "cp_async.cuh"
#include "mma_sync.cuh"

using namespace md_cp;
using namespace md_mma;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxGridY = 65535;  // (batch, head) pairs a launch

// Shared-memory plan for a head width HD. A block is 8 warps; the rows
// kernel's block owns 128 query rows, the columns kernel's 128 keys; each
// streams tiles of 64 of the other side through two stages. Rows carry 8 bf16
// of padding so that the 8 rows an ldmatrix reads fall on distinct banks.
template <int HD>
struct Plan {
  static constexpr int warps = 8;
  static constexpr int threads = 32 * warps;
  static constexpr int rows = 16 * warps;  // the block's own rows (queries or keys)
  static constexpr int tile = 64;          // streamed rows a stage
  static constexpr int KS = (HD + 15) / 16;
  static constexpr int D = 16 * KS;
  static constexpr int LD = D + 8;
  static constexpr int NT = HD / 8;  // n8 tiles of a head-wide output
  static constexpr int min_blocks = HD <= 40 ? 2 : 1;
  // rows kernel, bf16: Q and G (rows each), then per stage K and V (tile each)
  static constexpr int row_smem = (2 * rows + 2 * 2 * tile) * LD * 2;
  // columns kernel, bytes: K and V (rows each), then per stage Q and G (tile
  // each) and tile floats of lse and of delta
  static constexpr int col_stage = 2 * tile * LD * 2 + 2 * tile * 4;
  static constexpr int col_smem = 2 * rows * LD * 2 + 2 * col_stage;
  static_assert(HD % 8 == 0 && (LD * 2) % 16 == 0, "16-byte chunks and ldmatrix rows");
  static_assert(D - HD == 0 || D - HD == 8, "the pad is one 16-byte chunk");
  static_assert(rows % tile == 0, "the statistics' padding covers every query tile");
  static_assert(row_smem <= 232448 && col_smem <= 232448, "one block's shared memory");
};

// rows [row0, row0 + rows) of a head slice (HD channels at src, row stride
// ld) -> shared memory (row stride LD) by cp.async; rows >= nrows are zero.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int rows,
                                          int nrows, int ld) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += Plan<HD>::threads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = row0 + r < nrows;
    cp_async16(dst + r * Plan<HD>::LD + c, ok ? src + static_cast<size_t>(row0 + r) * ld + c : src,
               ok);
  }
}

// n floats (a multiple of 4, 16-byte aligned at both ends) by cp.async
template <int HD>
__device__ __forceinline__ void load_floats(float* dst, const float* src, int n) {
  for (int i = threadIdx.x * 4; i < n; i += Plan<HD>::threads * 4)
    cp_async16(reinterpret_cast<bf16*>(dst + i), reinterpret_cast<const bf16*>(src + i), true);
}

// columns [HD, D) of `rows` rows at dst (row stride LD) set to zero: they meet
// in the products over the head, and 0 x garbage could be NaN
template <int HD>
__device__ __forceinline__ void zero_pad(bf16* dst, int rows) {
  if constexpr (Plan<HD>::D > HD) {
    for (int r = threadIdx.x; r < rows; r += Plan<HD>::threads)
      *reinterpret_cast<uint4*>(dst + r * Plan<HD>::LD + HD) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// A warp's 16 rows of A (register fragments over the head) against 16 NJ
// rows of B at bt (shared memory, row stride LD): s = A B^T, 2 NJ n8 tiles.
template <int HD, int NJ>
__device__ __forceinline__ void product_nt(float (&s)[2 * NJ][4],
                                           const uint32_t (&a)[Plan<HD>::KS][4], const bf16* bt) {
  constexpr int KS = Plan<HD>::KS, LD = Plan<HD>::LD;
  const int lane = threadIdx.x % 32;
  const int b_row = (lane % 8) + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 8;
#pragma unroll
  for (int n = 0; n < 2 * NJ; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, smem_addr(bt + (j * 16 + b_row) * LD + kk * 16 + b_col));
      mma_bf16(s[2 * j], a[kk], b[0], b[1]);
      mma_bf16(s[2 * j + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc (16 x HD) += A B: A a packed 16 x 16 bf16 fragment, B 16 rows of the
// head at bt (shared memory, row stride LD), read transposed.
template <int HD>
__device__ __forceinline__ void product_nn(float (&acc)[Plan<HD>::NT][4], const uint32_t (&a)[4],
                                           const bf16* bt) {
  constexpr int LD = Plan<HD>::LD, NT = Plan<HD>::NT;
  const int lane = threadIdx.x % 32;
  const int b_row = (lane % 8) + ((lane / 8) % 2) * 8, b_col = (lane / 16) * 8;
#pragma unroll
  for (int n = 0; n + 1 < NT; n += 2) {
    uint32_t b[4];
    ldsm_x4_t(b, smem_addr(bt + b_row * LD + n * 8 + b_col));
    mma_bf16(acc[n], a, b[0], b[1]);
    mma_bf16(acc[n + 1], a, b[2], b[3]);
  }
  if constexpr (NT % 2) {
    uint32_t b0, b1;
    ldsm_x2_t(b0, b1, smem_addr(bt + b_row * LD + (NT - 1) * 8));
    mma_bf16(acc[NT - 1], a, b0, b1);
  }
}

// the four lanes of a quad hold one row's columns: their sum and maximum
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// A warp's 16 x HD fp32 accumulator (times `scale`) as bf16 rows of the
// output (rows row0.., those < nrows, at dst with row stride ld), through the
// warp's own 16 rows `stage` of shared memory (row stride LD).
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[Plan<HD>::NT][4], float scale,
                                           bf16* stage, bf16* dst, int row0, int nrows, int ld) {
  constexpr int LD = Plan<HD>::LD, NT = Plan<HD>::NT;
  const int lane = threadIdx.x % 32, g = lane / 4, c2 = (lane % 4) * 2;
  __syncwarp();  // every lane's reads of these rows are done
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(stage + g * LD + n * 8 + c2) =
        __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * LD + n * 8 + c2) =
        __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
  }
  __syncwarp();
  for (int i = lane; i < 16 * NT; i += 32) {
    const int r = i / NT, c = (i % NT) * 8;
    if (row0 + r < nrows)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row0 + r) * ld + c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
}

// The rows kernel: statistics (and lse, delta to `stats` where it is not
// null), then dQ where dq is not null. stats: lse at [bh][q_pad], delta at
// [B heads][q_pad] after it.
template <int HD>
__global__ void __launch_bounds__(Plan<HD>::threads, Plan<HD>::min_blocks)
attn_bwd_rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     bf16* __restrict__ dq, float* __restrict__ stats, int q_len, int kv_len,
                     int heads, int bh0, int q_pad, size_t delta_at, bool need_delta,
                     float scale_log2, float scale) {
  using L = Plan<HD>;
  constexpr int KS = L::KS, LD = L::LD, NT = L::NT, R = L::rows, T = L::tile;
  constexpr int NJ = 2;  // key slices of 16 a step: 32 keys
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* g_s = q_s + R * LD;
  bf16* kv_s = g_s + R * LD;  // stage i: K at kv_s + 2 i T LD, V T LD after it
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c2 = (lane % 4) * 2;

  const int ld = heads * HD;
  const int bh = bh0 + blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const bf16* q_bh = q + static_cast<size_t>(b) * q_len * ld + h * HD;
  const bf16* g_bh = g + static_cast<size_t>(b) * q_len * ld + h * HD;
  const bf16* k_bh = k + static_cast<size_t>(b) * kv_len * ld + h * HD;
  const bf16* v_bh = v + static_cast<size_t>(b) * kv_len * ld + h * HD;
  const int row0 = blockIdx.x * R;
  const int tiles = (kv_len + T - 1) / T;
  const int steps = dq != nullptr ? 2 * tiles : tiles;

  zero_pad<HD>(q_s, 2 * R + 4 * T);  // Q, G and both stages' K, V lie back to back
  load_rows<HD>(q_s, q_bh, row0, R, q_len, ld);
  load_rows<HD>(g_s, g_bh, row0, R, q_len, ld);
  load_rows<HD>(kv_s, k_bh, 0, T, kv_len, ld);
  load_rows<HD>(kv_s + T * LD, v_bh, 0, T, kv_len, ld);
  cp_async_commit();

  bf16* q_w = q_s + warp * 16 * LD;  // this warp's rows
  uint32_t qa[KS][4], ga[KS][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // this lane's rows g and g + 8: running maximum (base 2), its share of the
  // sum and of a; after pass 1 the rows' lse and delta
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, a0 = 0.f, a1 = 0.f;
  float lse0 = 0.f, lse1 = 0.f, del0 = 0.f, del1 = 0.f;

  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {  // the other stage was released by the barrier ending step s - 1
      const int tn = s + 1 < tiles ? s + 1 : s + 1 - tiles;
      bf16* kn = kv_s + ((s + 1) & 1) * 2 * T * LD;
      load_rows<HD>(kn, k_bh, tn * T, T, kv_len, ld);
      load_rows<HD>(kn + T * LD, v_bh, tn * T, T, kv_len, ld);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: step s's tile (and Q, G) landed
    __syncthreads();
    if (s == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int off = (lane % 16) * LD + kk * 16 + (lane / 16) * 8;
        ldsm_x4(qa[kk], smem_addr(q_w + off));
        ldsm_x4(ga[kk], smem_addr(g_s + warp * 16 * LD + off));
      }
    }
    const bool stats_pass = s < tiles;
    const int t = stats_pass ? s : s - tiles;
    const bf16* kt = kv_s + (s & 1) * 2 * T * LD;
    const bf16* vt = kt + T * LD;
    const int valid = min(T, kv_len - t * T);  // keys of the tile, >= 1

#pragma unroll
    for (int j0 = 0; j0 < T / 16; j0 += NJ) {
      if (j0 * 16 >= valid) break;
      float sc[2 * NJ][4], dp[2 * NJ][4];
      product_nt<HD, NJ>(sc, qa, kt + j0 * 16 * LD);
      if (need_delta) product_nt<HD, NJ>(dp, ga, vt + j0 * 16 * LD);
      // scale to base 2; keys past S_kv are -inf
#pragma unroll
      for (int n = 0; n < 2 * NJ; ++n) {
        const int key = j0 * 16 + n * 8 + c2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = key + e < valid;
          sc[n][e] = ok ? sc[n][e] * scale_log2 : -INFINITY;
          sc[n][2 + e] = ok ? sc[n][2 + e] * scale_log2 : -INFINITY;
        }
      }
      if (stats_pass) {
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int n = 0; n < 2 * NJ; ++n) {
          mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
          mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
        }
        // the first slice holds key 0, so the maxima are finite from then on
        // and the first correction ex2(-inf) is exactly 0
        const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
        const float corr0 = ex2(m0 - n0), corr1 = ex2(m1 - n1);
        m0 = n0;
        m1 = n1;
        l0 *= corr0;
        a0 *= corr0;
        l1 *= corr1;
        a1 *= corr1;
#pragma unroll
        for (int n = 0; n < 2 * NJ; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p0 = ex2(sc[n][e] - n0), p1 = ex2(sc[n][2 + e] - n1);
            l0 += p0;
            l1 += p1;
            if (need_delta) {
              a0 += p0 * dp[n][e];
              a1 += p1 * dp[n][2 + e];
            }
          }
        }
      } else {
        // ds = p (dp - delta) in fp32, rounded to bf16: the A operand of dS K
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t da[4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float* c = sc[2 * j + half];
            const float* d = dp[2 * j + half];
            da[2 * half] = pack_bf16(ex2(c[0] - lse0) * (d[0] - del0),
                                     ex2(c[1] - lse0) * (d[1] - del0));
            da[2 * half + 1] = pack_bf16(ex2(c[2] - lse1) * (d[2] - del1),
                                         ex2(c[3] - lse1) * (d[3] - del1));
          }
          product_nn<HD>(acc, da, kt + (j0 + j) * 16 * LD);
        }
      }
    }
    if (s == tiles - 1) {  // the statistics are whole
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      lse0 = m0 + log2f(l0);
      lse1 = m1 + log2f(l1);
      del0 = quad_sum(a0) / l0;
      del1 = quad_sum(a1) / l1;
      if (stats != nullptr && lane % 4 == 0) {
        const size_t r = static_cast<size_t>(bh) * q_pad + row0 + warp * 16 + lane / 4;
        stats[r] = lse0;
        stats[r + 8] = lse1;
        stats[delta_at + r] = del0;
        stats[delta_at + r + 8] = del1;
      }
    }
    __syncthreads();  // every warp is done with stage s & 1
  }
  cp_async_wait<0>();
  if (dq != nullptr)
    store_rows<HD>(acc, scale, q_w, dq + static_cast<size_t>(b) * q_len * ld + h * HD,
                   row0 + warp * 16, q_len, ld);
}

// The columns kernel: dK (where dk is not null) and dV (where dv is not null)
// of 128 keys a block, from the rows kernel's statistics.
template <int HD>
__global__ void __launch_bounds__(Plan<HD>::threads, Plan<HD>::min_blocks)
attn_bwd_cols_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     const float* __restrict__ stats, int q_len, int kv_len, int heads, int bh0,
                     int q_pad, size_t delta_at, float scale_log2, float scale) {
  using L = Plan<HD>;
  constexpr int KS = L::KS, LD = L::LD, NT = L::NT, R = L::rows, T = L::tile;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + R * LD;
  unsigned char* stage0 = smem + 2 * R * LD * 2;  // stage i at stage0 + i col_stage:
  // Q (T LD bf16), G (T LD bf16), lse (T floats), delta (T floats)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c2 = (lane % 4) * 2;
  const bool need_k = dk != nullptr, need_v = dv != nullptr;

  const int ld = heads * HD;
  const int bh = bh0 + blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const bf16* q_bh = q + static_cast<size_t>(b) * q_len * ld + h * HD;
  const bf16* g_bh = g + static_cast<size_t>(b) * q_len * ld + h * HD;
  const size_t kv_off = static_cast<size_t>(b) * kv_len * ld + h * HD;
  const float* lse_bh = stats + static_cast<size_t>(bh) * q_pad;
  const int key0 = blockIdx.x * R;
  const int tiles = (q_len + T - 1) / T;
  // this lane's keys g and g + 8 of the warp: past S_kv their p is 0
  const bool key_ok0 = key0 + warp * 16 + lane / 4 < kv_len;
  const bool key_ok1 = key0 + warp * 16 + lane / 4 + 8 < kv_len;

  auto stage = [&](int i) { return stage0 + i * L::col_stage; };
  auto load_stage = [&](int i, int t) {
    bf16* qt = reinterpret_cast<bf16*>(stage(i));
    float* lse_t = reinterpret_cast<float*>(stage(i) + 2 * T * LD * 2);
    load_rows<HD>(qt, q_bh, t * T, T, q_len, ld);
    load_rows<HD>(qt + T * LD, g_bh, t * T, T, q_len, ld);
    load_floats<HD>(lse_t, lse_bh + t * T, T);
    load_floats<HD>(lse_t + T, lse_bh + delta_at + t * T, T);
  };

  zero_pad<HD>(k_s, 2 * R);
  zero_pad<HD>(reinterpret_cast<bf16*>(stage(0)), 2 * T);
  zero_pad<HD>(reinterpret_cast<bf16*>(stage(1)), 2 * T);
  load_rows<HD>(k_s, k + kv_off, key0, R, kv_len, ld);
  load_rows<HD>(v_s, v + kv_off, key0, R, kv_len, ld);
  load_stage(0, 0);
  cp_async_commit();

  uint32_t ka[KS][4], va[KS][4];
  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) load_stage((t + 1) & 1, t + 1);  // released by the barrier ending t - 1
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int off = (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8;
        ldsm_x4(ka[kk], smem_addr(k_s + off));
        ldsm_x4(va[kk], smem_addr(v_s + off));
      }
    }
    const bf16* qt = reinterpret_cast<const bf16*>(stage(t & 1));
    const bf16* gt = qt + T * LD;
    const float* lse_t = reinterpret_cast<const float*>(stage(t & 1) + 2 * T * LD * 2);
    const float* del_t = lse_t + T;
#pragma unroll
    for (int j = 0; j < T / 16; ++j) {
      float sc[2][4], dp[2][4];
      product_nt<HD, 1>(sc, ka, qt + j * 16 * LD);
      if (need_k) product_nt<HD, 1>(dp, va, gt + j * 16 * LD);
      uint32_t pa[4], da[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = j * 16 + half * 8 + c2;  // this lane's two queries
        const float ls0 = lse_t[col], ls1 = lse_t[col + 1];
        const float* c = sc[half];
        // rows: keys g (c[0], c[1]) and g + 8 (c[2], c[3]); columns: queries
        const float p00 = key_ok0 ? ex2(c[0] * scale_log2 - ls0) : 0.f;
        const float p01 = key_ok0 ? ex2(c[1] * scale_log2 - ls1) : 0.f;
        const float p10 = key_ok1 ? ex2(c[2] * scale_log2 - ls0) : 0.f;
        const float p11 = key_ok1 ? ex2(c[3] * scale_log2 - ls1) : 0.f;
        pa[2 * half] = pack_bf16(p00, p01);
        pa[2 * half + 1] = pack_bf16(p10, p11);
        if (need_k) {
          const float dl0 = del_t[col], dl1 = del_t[col + 1];
          const float* d = dp[half];
          da[2 * half] = pack_bf16(p00 * (d[0] - dl0), p01 * (d[1] - dl1));
          da[2 * half + 1] = pack_bf16(p10 * (d[2] - dl0), p11 * (d[3] - dl1));
        }
      }
      if (need_v) product_nn<HD>(dv_acc, pa, gt + j * 16 * LD);
      if (need_k) product_nn<HD>(dk_acc, da, qt + j * 16 * LD);
    }
    __syncthreads();  // every warp is done with stage t & 1
  }
  cp_async_wait<0>();
  // out through the warp's own K and V rows (only this warp read them)
  const int r0 = key0 + warp * 16;
  if (need_k) store_rows<HD>(dk_acc, scale, k_s + warp * 16 * LD, dk + kv_off, r0, kv_len, ld);
  if (need_v) store_rows<HD>(dv_acc, 1.f, v_s + warp * 16 * LD, dv + kv_off, r0, kv_len, ld);
}

// Floats of the statistics scratch: lse and delta of every (batch, head,
// query row), the rows padded to the rows kernel's blocks.
template <int HD>
long long scratch_floats(int batch, int q_len, int heads) {
  const long long q_pad = (q_len + Plan<HD>::rows - 1) / Plan<HD>::rows * Plan<HD>::rows;
  return 2LL * batch * heads * q_pad;
}

template <int HD>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* g, bf16* dq,
                   bf16* dk, bf16* dv, float* stats, long long stats_floats, int batch,
                   int q_len, int kv_len, int heads, cudaStream_t stream) {
  using L = Plan<HD>;
  const int q_pad = (q_len + L::rows - 1) / L::rows * L::rows;
  const size_t delta_at = static_cast<size_t>(batch) * heads * q_pad;
  const bool need_kv = dk != nullptr || dv != nullptr;
  if (need_kv && (stats == nullptr || stats_floats < scratch_floats<HD>(batch, q_len, heads)))
    return cudaErrorInvalidValue;
  auto rows = attn_bwd_rows_kernel<HD>;
  auto cols = attn_bwd_cols_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize, L::row_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(cols, cudaFuncAttributeMaxDynamicSharedMemorySize, L::col_smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf(static_cast<float>(HD)), scale_log2 = kLog2e * scale;
  const int pairs = batch * heads;
  for (int bh0 = 0; bh0 < pairs; bh0 += kMaxGridY) {
    const int n = std::min(kMaxGridY, pairs - bh0);
    rows<<<dim3(q_pad / L::rows, n), L::threads, L::row_smem, stream>>>(
        q, k, v, g, dq, need_kv ? stats : nullptr, q_len, kv_len, heads, bh0, q_pad, delta_at,
        dq != nullptr || dk != nullptr, scale_log2, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (need_kv) {
      cols<<<dim3((kv_len + L::rows - 1) / L::rows, n), L::threads, L::col_smem, stream>>>(
          q, k, v, g, dk, dv, stats, q_len, kv_len, heads, bh0, q_pad, delta_at, scale_log2,
          scale);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// q and g (batch, q_len, heads * hd), k and v (batch, kv_len, heads * hd):
// bf16, contiguous, 16-byte aligned; hd 40, 64 or 80, q_len, kv_len >= 1.
// dq like q, dk and dv like k: each written where it is not null. stats:
// fp32 scratch of stats_floats floats, at least what md_flash_backward_scratch
// gives, needed where dk or dv is wanted.
int md_flash_backward(const void* q, const void* k, const void* v, const void* g, void* dq,
                      void* dk, void* dv, void* stats, long long stats_floats, int batch,
                      int q_len, int kv_len, int heads, int hd, void* stream) {
  if (batch < 1 || heads < 1 || q_len < 1 || kv_len < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  auto out = [](void* p) { return static_cast<bf16*>(p); };
  float* st = static_cast<float*>(stats);
  switch (hd) {
    case 40: return launch<40>(in(q), in(k), in(v), in(g), out(dq), out(dk), out(dv), st,
                               stats_floats, batch, q_len, kv_len, heads, s);
    case 64: return launch<64>(in(q), in(k), in(v), in(g), out(dq), out(dk), out(dv), st,
                               stats_floats, batch, q_len, kv_len, heads, s);
    case 80: return launch<80>(in(q), in(k), in(v), in(g), out(dq), out(dk), out(dv), st,
                               stats_floats, batch, q_len, kv_len, heads, s);
    default: return cudaErrorInvalidValue;
  }
}

// The floats of md_flash_backward's statistics scratch for these shapes, to *out.
int md_flash_backward_scratch(int batch, int q_len, int heads, int hd, long long* out) {
  *out = 0;
  if (batch < 1 || heads < 1 || q_len < 1) return cudaErrorInvalidValue;
  switch (hd) {
    case 40: *out = scratch_floats<40>(batch, q_len, heads); return cudaSuccess;
    case 64: *out = scratch_floats<64>(batch, q_len, heads); return cudaSuccess;
    case 80: *out = scratch_floats<80>(batch, q_len, heads); return cudaSuccess;
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
