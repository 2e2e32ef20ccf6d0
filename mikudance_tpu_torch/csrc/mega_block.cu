// The transformer-block mega-kernel probe, hand-written for Hopper (sm_90a).
//
//   K14 md_mega_block  replaces probes/_mega_block.py _mega_kernel (:100, entry
//       mega_block :150): the read-mode transformer-block interior in ONE
//       launch:
//         LN1 -> q, k + bank K, v + bank V -> self-attention -> out-proj + x
//         -> LN2 -> cross-q -> attention against the hoisted context K/V
//         (padded rows masked) -> out-proj + residual -> LN3 -> GEGLU (tanh
//         GELU) -> + residual.
//       Its arithmetic is the TPU kernel's: one-pass LN variance in fp32, the
//       residual stream in fp32 from the first out-proj on, k and v rounded to
//       bf16 after the bank add, q * scale rounded to bf16, a max-subtracted
//       softmax normalised in fp32 before the bf16 cast, the tanh GELU.
//
// The TPU kernel runs a (batch, query tile) grid and recomputes LN1 and the
// K/V projections in each of its 4 query tiles because 128 MB of VMEM cannot
// hold a whole row's activations. None of that carries over. Here one
// persistent kernel (a block an SM, launched cooperatively so that all are
// resident) walks the block's eleven phases for a chunk of batch elements at
// a time, with a grid-wide barrier between phases; every phase is a list of
// work items that the blocks take round robin. The intermediates (the normed
// rows, q, k, v, the attention output, the fp32 residual stream, the GEGLU
// activations) live in a scratch buffer sized for one chunk and reused by the
// next, so they are written and read back through the 50 MB L2 rather than
// kept per batch element in device memory; each projection is computed once.
//
// The products are this file's own: the 128 x 128 x 32 wmma tile loop of
// gemm_tile.cuh with epilogues written here, and a two-pass attention (first
// the row maxima and sums over all key tiles, then p = exp(s - m) / l, rounded
// to bf16, times V), which reproduces the TPU kernel's normalise-then-round
// softmax without holding a row of scores. The GEGLU item computes its gate
// tile first, keeps gelu(gate) in shared memory, and multiplies it into the
// hidden tile's epilogue.
//
// Scratch written by one block and read by another after a barrier is read
// with cp.async.cg or __ldcg (L2, never a stale L1 line).

#include <math.h>

#include "gemm_tile.cuh"

using namespace md_gemm;

namespace {

constexpr int kHeads = 8;
constexpr int kBlockQ = 16 * kWarps;  // query rows of an attention item
constexpr float kLog2e = 1.4426950408889634f;
constexpr int LDG = BN + 4;  // staged gelu(gate) row, fp32
constexpr int kGateBytes = BM * LDG * 4;
constexpr int kGemmBytes = kSmemBytes + kGateBytes;
constexpr int kMaxPairs = 20;  // a lane's share of a row of <= 1280 channels, in pairs

struct Params {
  const bf16 *x, *rk, *rv, *ck, *cv;                       // inputs
  const bf16 *wq, *wk, *wv, *wo, *wq2, *wo2, *w1, *w2;     // (out, in) row-major
  const float *bo, *bo2, *b1, *b2, *s1, *g1, *s2, *g2, *s3, *g3;
  bf16* out;
  bf16 *nrm, *q, *k, *v, *a, *act;                         // scratch, one chunk
  float* xs;                                               // the residual stream
  unsigned int* barrier;
  int batch, seq, ctx_pad, ctx_len, chunk;
  float eps;
};

// All blocks of the grid meet here. `target` counts the arrivals this block
// has asked for so far; the counter only grows (zeroed before the launch).
__device__ __forceinline__ void grid_barrier(unsigned int* counter, unsigned int& target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += gridDim.x;
    __threadfence();
    atomicAdd(counter, 1u);
    while (*reinterpret_cast<volatile unsigned int*>(counter) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ float2 load_pair(const bf16* p) {
  const unsigned int raw = __ldcg(reinterpret_cast<const unsigned int*>(p));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return __ldcg(reinterpret_cast<const float2*>(p));
}

// LayerNorm of `rows` rows of C channels (C a multiple of 64), a warp a row:
// mean and E[x^2] - mean^2 in fp32 from the row held in registers.
template <typename T>
__device__ void ln_rows(const T* in, bf16* out, const float* scale, const float* bias,
                        long long rows, int C, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + warp; r < rows;
       r += static_cast<long long>(gridDim.x) * kWarps) {
    const T* src = in + r * C;
    float2 val[kMaxPairs];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int c = 2 * lane + 64 * i;
      if (c < C) {
        val[i] = load_pair(src + c);
        sum += val[i].x + val[i].y;
        sq += val[i].x * val[i].x + val[i].y * val[i].y;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    const float mu = sum / C;
    const float rstd = rsqrtf(sq / C - mu * mu + eps);
    bf16* dst = out + r * C;
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int c = 2 * lane + 64 * i;
      if (c < C) {
        const float2 s = *reinterpret_cast<const float2*>(scale + c);
        const float2 b = *reinterpret_cast<const float2*>(bias + c);
        *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(
            (val[i].x - mu) * rstd * s.x + b.x, (val[i].y - mu) * rstd * s.y + b.y);
      }
    }
  }
}

// One 128 x 128 tile of A (rows, K) x W^T, W (N, K) row-major, first row m0
// and column n0. `epi(m, n, v)` gets eight consecutive sums of row m from
// column n on, for every m < rows and n < N (N a multiple of 8).
template <typename Epi>
__device__ __forceinline__ void gemm_item(const bf16* A, const bf16* W, long long rows, int K,
                                          int N, long long m0, int n0, unsigned char* smem,
                                          Epi epi) {
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int r0 = tid / kChunks, ck = (tid % kChunks) * 8;
  auto load = [&](int stage, int kt) {
    bf16* a_s = ring + stage * kStageElems;
    bf16* b_s = a_s + kTileElems;
    const int k = kt * BK + ck;
    const bool k_ok = k < K;
#pragma unroll
    for (int h = 0; h < kCopies; ++h) {
      const int r = r0 + kCopyRows * h;
      const long long m = m0 + r;
      const bool a_ok = k_ok && m < rows;
      cp_async16(a_s + r * LDT + ck, a_ok ? A + static_cast<size_t>(m) * K + k : A, a_ok);
      const int n = n0 + r;
      const bool b_ok = k_ok && n < N;
      cp_async16(b_s + r * LDT + ck, b_ok ? W + static_cast<size_t>(n) * K + k : W, b_ok);
    }
  };
  Acc acc;
  main_loop(acc, ring, (K + BK - 1) / BK, wm, wn, load);  // ends with a barrier: ring free
  float* scratch = reinterpret_cast<float*>(smem) + warp * 16 * LDE;
  const int row = lane / 2, c8 = (lane % 2) * 8;
#pragma unroll
  for (int j = 0; j < WN / 16; ++j) {
    const int n = n0 + wn * WN + j * 16 + c8;
#pragma unroll
    for (int i = 0; i < WM / 16; ++i) {
      wmma::store_matrix_sync(scratch, acc.f[i][j], LDE, wmma::mem_row_major);
      __syncwarp();
      const long long m = m0 + wm * WM + i * 16 + row;
      if (m < rows && n < N) epi(m, n, scratch + row * LDE + c8);
      __syncwarp();
    }
  }
  __syncthreads();  // the scratch is the ring: the next item's copies may start
}

__device__ __forceinline__ void store8(bf16* dst, const float* v) {
  __align__(16) __nv_bfloat162 out[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(out);
}

__device__ __forceinline__ void load8(const bf16* src, float* v) {
  const uint4 raw = __ldcg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(p[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

// Shared-memory plan of an attention item: head width HD in a tile of D
// columns, key tiles of BK rows in two stages.
template <int D, int BK>
struct AttnPlan {
  static constexpr int LD = D + 8, LDS = BK + 4, LDP = BK + 8;
  static constexpr int q = kBlockQ * LD * 2;
  static constexpr int kv = BK * LD * 2;
  static constexpr int s = kWarps * 16 * LDS * 4;
  static constexpr int p = kWarps * 16 * LDP * 2;
  static constexpr int total = q + s + p + 4 * kv;
  static_assert(D % 16 == 0 && BK % 16 == 0, "fragment multiples");
  static_assert(q % 128 == 0 && kv % 128 == 0 && s % (kWarps * 128) == 0 &&
                    p % (kWarps * 128) == 0, "regions stay 128-byte aligned");
};

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

// S = Q K^T of a warp's 16 query rows against a staged key tile, into s_w.
template <int D, int BK>
__device__ __forceinline__ void scores(const bf16* q_w, const bf16* kt, float* s_w) {
  using L = AttnPlan<D, BK>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int d = 0; d < D; d += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa;
    wmma::load_matrix_sync(qa, q_w + d, L::LD);
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
      wmma::load_matrix_sync(kb, kt + n * 16 * L::LD + d, L::LD);
      wmma::mma_sync(acc[n], qa, kb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < BK / 16; ++n)
    wmma::store_matrix_sync(s_w + n * 16, acc[n], L::LDS, wmma::mem_row_major);
}

// One attention item: 128 query rows [q0, q0 + 128) of one head (q_h, k_h, v_h
// and o_h point at the head's first column; row stride ld) against kv_len
// keys. The softmax is the dense one: row maximum and sum over all keys
// first, then p = bf16(exp(s - m) / l) into the P V product.
template <int HD, int D, int BK>
__device__ void attention_item(const bf16* q_h, const bf16* k_h, const bf16* v_h, bf16* o_h,
                               int q_len, int kv_len, int ld, int q0, float scale,
                               unsigned char* smem) {
  using L = AttnPlan<D, BK>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  float* s_w = reinterpret_cast<float*>(smem + L::q) + warp * 16 * L::LDS;
  bf16* p_w = reinterpret_cast<bf16*>(smem + L::q + L::s) + warp * 16 * L::LDP;
  bf16* kv_s = reinterpret_cast<bf16*>(smem + L::q + L::s + L::p);  // [stage][K, V][BK][LD]
  constexpr int kTile = BK * L::LD;

  // q * scale, rounded to bf16; rows past q_len and columns past HD are zero.
  // The staged K / V tiles' columns past HD are zeroed once: the copies never
  // touch them.
  for (int i = threadIdx.x; i < kBlockQ * L::LD / 8; i += kThreads)
    reinterpret_cast<uint4*>(q_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < 4 * kTile / 8; i += kThreads)
    reinterpret_cast<uint4*>(kv_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (int i = threadIdx.x; i < kBlockQ * (HD / 8); i += kThreads) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    if (q0 + r < q_len) {
      float v[8];
      load8(q_h + static_cast<size_t>(q0 + r) * ld + c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= scale;
      store8(q_s + r * L::LD + c, v);
    }
  }
  __syncthreads();

  const bf16* q_w = q_s + warp * 16 * L::LD;
  const int tiles = (kv_len + BK - 1) / BK;
  const int row = lane / 2, half = lane % 2;
  const float* srow = s_w + row * L::LDS;

  // pass 1: the row maximum m and l = sum exp(s - m), two lanes a row
  float m = -1e30f, l = 0.f;
  stage_rows<BK, HD, L::LD>(kv_s, k_h, 0, kv_len, ld);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    bf16* cur = kv_s + (t & 1) * 2 * kTile;
    if (t + 1 < tiles) stage_rows<BK, HD, L::LD>(kv_s + ((t + 1) & 1) * 2 * kTile, k_h,
                                                 (t + 1) * BK, kv_len, ld);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    scores<D, BK>(q_w, cur, s_w);
    __syncwarp();
    const int valid = min(BK, kv_len - t * BK);
    float tmax = m;
    for (int c = half; c < valid; c += 2) tmax = fmaxf(tmax, srow[c]);
    float sum = 0.f;
    for (int c = half; c < valid; c += 2) sum += exp2f((srow[c] - tmax) * kLog2e);
    l = l * exp2f((m - tmax) * kLog2e) + sum;
    m = tmax;
    __syncthreads();
  }
  {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, 1), l_o = __shfl_xor_sync(0xffffffffu, l, 1);
    const float m_n = fmaxf(m, m_o);
    l = l * exp2f((m - m_n) * kLog2e) + l_o * exp2f((m_o - m_n) * kLog2e);
    m = m_n;
  }
  const float inv_l = 1.f / l;

  // pass 2: O = sum_j bf16(exp(s_j - m) / l) v_j
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(oacc[j], 0.f);
  bf16* prow = p_w + row * L::LDP;
  stage_rows<BK, HD, L::LD>(kv_s, k_h, 0, kv_len, ld);
  stage_rows<BK, HD, L::LD>(kv_s + kTile, v_h, 0, kv_len, ld);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    bf16* cur = kv_s + (t & 1) * 2 * kTile;
    if (t + 1 < tiles) {
      bf16* nxt = kv_s + ((t + 1) & 1) * 2 * kTile;
      stage_rows<BK, HD, L::LD>(nxt, k_h, (t + 1) * BK, kv_len, ld);
      stage_rows<BK, HD, L::LD>(nxt + kTile, v_h, (t + 1) * BK, kv_len, ld);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    scores<D, BK>(q_w, cur, s_w);
    __syncwarp();
    const int valid = min(BK, kv_len - t * BK);
    for (int c = 2 * half; c < BK; c += 4) {
      const float e0 = c < valid ? exp2f((srow[c] - m) * kLog2e) * inv_l : 0.f;
      const float e1 = c + 1 < valid ? exp2f((srow[c + 1] - m) * kLog2e) * inv_l : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(prow + c) = __floats2bfloat162_rn(e0, e1);
    }
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa[BK / 16];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wmma::load_matrix_sync(pa[kk], p_w + kk * 16, L::LDP);
    const bf16* vt = cur + kTile;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, vt + kk * 16 * L::LD + j * 16, L::LD);
        wmma::mma_sync(oacc[j], pa[kk], vb, oacc[j]);
      }
    }
    __syncthreads();
  }

  const int c8 = half * 8;
  const int rows_left = q_len - (q0 + warp * 16);
  bf16* o_w = o_h + static_cast<size_t>(q0 + warp * 16) * ld;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::store_matrix_sync(s_w, oacc[j], L::LDS, wmma::mem_row_major);
    __syncwarp();
    const int col = j * 16 + c8;
    if (row < rows_left && col + 8 <= HD)
      store8(o_w + static_cast<size_t>(row) * ld + col, s_w + row * L::LDS + c8);
    __syncwarp();
  }
  __syncthreads();  // shared memory is free for the next item
}

template <int HD, int D, int BK>
constexpr int mega_smem() {
  return AttnPlan<D, BK>::total > kGemmBytes ? AttnPlan<D, BK>::total : kGemmBytes;
}

template <int HD, int D, int BK>
__global__ void __launch_bounds__(kThreads, 1) mega_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int C = kHeads * HD, FF = 4 * C;
  constexpr int ct = (C + BN - 1) / BN, ft = (FF + BN - 1) / BN;
  const float scale = rsqrtf(static_cast<float>(HD));
  const int qt = (p.seq + kBlockQ - 1) / kBlockQ;
  unsigned int target = 0;

  for (int b0 = 0; b0 < p.batch; b0 += p.chunk) {
    const int nb = min(p.chunk, p.batch - b0);
    const long long R = static_cast<long long>(nb) * p.seq;
    const size_t at = static_cast<size_t>(b0) * p.seq * C;
    const bf16* x = p.x + at;
    const int rt = static_cast<int>((R + BM - 1) / BM);

    // 1. LN1
    ln_rows<bf16>(x, p.nrm, p.s1, p.g1, R, C, p.eps);
    grid_barrier(p.barrier, target);

    // 2. q, k + bank K, v + bank V
    for (int item = blockIdx.x; item < 3 * rt * ct; item += gridDim.x) {
      const int which = item / (rt * ct), tile = item % (rt * ct);
      const long long m0 = static_cast<long long>(tile / ct) * BM;
      const int n0 = tile % ct * BN;
      if (which == 0) {
        gemm_item(p.nrm, p.wq, R, C, C, m0, n0, smem, [&](long long m, int n, const float* v) {
          store8(p.q + m * C + n, v);
        });
      } else {
        const bf16* bank = (which == 1 ? p.rk : p.rv) + at;
        bf16* dst = which == 1 ? p.k : p.v;
        gemm_item(p.nrm, which == 1 ? p.wk : p.wv, R, C, C, m0, n0, smem,
                  [&](long long m, int n, const float* v) {
                    float r[8];
                    load8(bank + m * C + n, r);
#pragma unroll
                    for (int e = 0; e < 8; ++e) r[e] += v[e];
                    store8(dst + m * C + n, r);
                  });
      }
    }
    grid_barrier(p.barrier, target);

    // 3. self-attention
    for (int item = blockIdx.x; item < nb * kHeads * qt; item += gridDim.x) {
      const int b = item / (kHeads * qt), h = item / qt % kHeads, q0 = item % qt * kBlockQ;
      const size_t head = static_cast<size_t>(b) * p.seq * C + h * HD;
      attention_item<HD, D, BK>(p.q + head, p.k + head, p.v + head, p.a + head, p.seq, p.seq, C,
                                q0, scale, smem);
    }
    grid_barrier(p.barrier, target);

    // 4. the residual stream starts: xs = x + a Wo^T + bo, fp32
    for (int item = blockIdx.x; item < rt * ct; item += gridDim.x) {
      gemm_item(p.a, p.wo, R, C, C, static_cast<long long>(item / ct) * BM, item % ct * BN, smem,
                [&](long long m, int n, const float* v) {
                  float r[8];
                  load8(x + m * C + n, r);
#pragma unroll
                  for (int e = 0; e < 8; ++e) p.xs[m * C + n + e] = r[e] + v[e] + p.bo[n + e];
                });
    }
    grid_barrier(p.barrier, target);

    // 5. LN2, 6. the cross-attention q
    ln_rows<float>(p.xs, p.nrm, p.s2, p.g2, R, C, p.eps);
    grid_barrier(p.barrier, target);
    for (int item = blockIdx.x; item < rt * ct; item += gridDim.x) {
      gemm_item(p.nrm, p.wq2, R, C, C, static_cast<long long>(item / ct) * BM, item % ct * BN,
                smem, [&](long long m, int n, const float* v) { store8(p.q + m * C + n, v); });
    }
    grid_barrier(p.barrier, target);

    // 7. attention against the context K/V: the padded rows are left out,
    // which is what the -1e30 mask row makes of them
    for (int item = blockIdx.x; item < nb * kHeads * qt; item += gridDim.x) {
      const int b = item / (kHeads * qt), h = item / qt % kHeads, q0 = item % qt * kBlockQ;
      const size_t head = static_cast<size_t>(b) * p.seq * C + h * HD;
      const size_t ctx = static_cast<size_t>(b0 + b) * p.ctx_pad * C + h * HD;
      attention_item<HD, D, BK>(p.q + head, p.ck + ctx, p.cv + ctx, p.a + head, p.seq, p.ctx_len,
                                C, q0, scale, smem);
    }
    grid_barrier(p.barrier, target);

    // 8. xs += a Wo2^T + bo2
    for (int item = blockIdx.x; item < rt * ct; item += gridDim.x) {
      gemm_item(p.a, p.wo2, R, C, C, static_cast<long long>(item / ct) * BM, item % ct * BN, smem,
                [&](long long m, int n, const float* v) {
                  float* dst = p.xs + m * C + n;
#pragma unroll
                  for (int e = 0; e < 8; ++e) dst[e] = __ldcg(dst + e) + v[e] + p.bo2[n + e];
                });
    }
    grid_barrier(p.barrier, target);

    // 9. LN3
    ln_rows<float>(p.xs, p.nrm, p.s3, p.g3, R, C, p.eps);
    grid_barrier(p.barrier, target);

    // 10. GEGLU: gelu_tanh(gate) of the tile first, staged in shared memory,
    // then the hidden tile times it
    float* gate_s = reinterpret_cast<float*>(smem + kSmemBytes);
    for (int item = blockIdx.x; item < rt * ft; item += gridDim.x) {
      const long long m0 = static_cast<long long>(item / ft) * BM;
      const int n0 = item % ft * BN;
      gemm_item(p.nrm, p.w1 + static_cast<size_t>(FF) * C, R, C, FF, m0, n0, smem,
                [&](long long m, int n, const float* v) {
                  float* dst = gate_s + (m - m0) * LDG + (n - n0);
#pragma unroll
                  for (int e = 0; e < 8; ++e) {
                    const float g = v[e] + p.b1[FF + n + e];
                    dst[e] = 0.5f * g *
                             (1.f + tanhf(0.7978845608028654f * (g + 0.044715f * g * g * g)));
                  }
                });
      gemm_item(p.nrm, p.w1, R, C, FF, m0, n0, smem, [&](long long m, int n, const float* v) {
        const float* g = gate_s + (m - m0) * LDG + (n - n0);
        float r[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) r[e] = (v[e] + p.b1[n + e]) * g[e];
        store8(p.act + m * FF + n, r);
      });
    }
    grid_barrier(p.barrier, target);

    // 11. out = bf16(xs + act W2^T + b2)
    for (int item = blockIdx.x; item < rt * ct; item += gridDim.x) {
      gemm_item(p.act, p.w2, R, FF, C, static_cast<long long>(item / ct) * BM, item % ct * BN,
                smem, [&](long long m, int n, const float* v) {
                  float r[8];
#pragma unroll
                  for (int e = 0; e < 8; ++e)
                    r[e] = __ldcg(p.xs + m * C + n + e) + v[e] + p.b2[n + e];
                  store8(p.out + at + m * C + n, r);
                });
    }
    // no barrier: the next chunk's phases 1-3 write nothing that phase 11
    // reads, and three barriers pass before xs is written again
  }
}

template <int HD, int D, int BK>
cudaError_t launch(Params p, cudaStream_t stream) {
  auto kern = mega_kernel<HD, D, BK>;
  constexpr int smem = mega_smem<HD, D, BK>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  if ((err = cudaMemsetAsync(p.barrier, 0, sizeof(unsigned int), stream)) != cudaSuccess)
    return err;
  void* args[] = {&p};
  // cooperative: every block is resident, which the barrier needs
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(sms), dim3(kThreads), args,
                                    smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// tensors: 31 device pointers in Params' order (x, rk, rv, ck, cv; wq, wk, wv,
// wo, wq2, wo2, w1, w2; bo, bo2, b1, b2, s1, g1, s2, g2, s3, g3; out; nrm, q, k,
// v, a, act; xs), then the barrier word. x, rk, rv, out (batch, seq, C) and ck,
// cv (batch, ctx_pad, C) bf16; weights (out, in) bf16; vectors fp32; C = 8 hd
// with hd 40, 80 or 160; scratch for `chunk` batch elements.
int md_mega_block(const void* const* t, int batch, int seq, int hd, int ctx_pad, int ctx_len,
                  int chunk, float eps, void* stream) {
  if (batch < 1 || seq < 1 || ctx_len < 1 || ctx_len > ctx_pad || chunk < 1)
    return cudaErrorInvalidValue;
  Params p;
  int i = 0;
  auto b = [&]() { return static_cast<const bf16*>(t[i++]); };
  auto f = [&]() { return static_cast<const float*>(t[i++]); };
  p.x = b(), p.rk = b(), p.rv = b(), p.ck = b(), p.cv = b();
  p.wq = b(), p.wk = b(), p.wv = b(), p.wo = b(), p.wq2 = b(), p.wo2 = b(), p.w1 = b(), p.w2 = b();
  p.bo = f(), p.bo2 = f(), p.b1 = f(), p.b2 = f();
  p.s1 = f(), p.g1 = f(), p.s2 = f(), p.g2 = f(), p.s3 = f(), p.g3 = f();
  auto m = [&]() { return static_cast<bf16*>(const_cast<void*>(t[i++])); };
  p.out = m(), p.nrm = m(), p.q = m(), p.k = m(), p.v = m(), p.a = m(), p.act = m();
  p.xs = static_cast<float*>(const_cast<void*>(t[i++]));
  p.barrier = static_cast<unsigned int*>(const_cast<void*>(t[i++]));
  p.batch = batch, p.seq = seq, p.ctx_pad = ctx_pad, p.ctx_len = ctx_len, p.chunk = chunk;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 40) return launch<40, 48, 64>(p, s);
  if (hd == 80) return launch<80, 80, 64>(p, s);
  if (hd == 160) return launch<160, 160, 64>(p, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
