// Cross-attention from the UNet tokens to the CLIP context, hand-written for
// Hopper (sm_90a).
//
//   K2 md_flash_cross  replaces mikudance_tpu/kernels/flash_attention.py
//      _cross_kernel_fullc (:598): S queries (9216 and 2304 tokens at 768^2)
//      against the 257 CLIP tokens, heads of 40 and 80 packed in C. Each block
//      reads head h's channel slice in place, with row stride C: no head-split
//      copies. hd is zero-padded to a multiple of 16 (40 -> 48) inside shared
//      memory only; the ragged last key tile is masked to -inf exactly.
//
// What bounds it on the card: S x 257 scores a head against S hd bytes of Q
// and O, so at these shapes bytes more than tensor-core work. The tile loop
// (attn_tile_kernel) is the port's first: a block owns 64 query rows (16 per
// warp) and walks K/V tiles with the exact online softmax (running max, fp32
// running sum, fp32 accumulator). Products run on nvcuda::wmma bf16 16x16x16
// fragments with fp32 accumulation; scores and the accumulator live in shared
// memory so the per-row rescale is plain code. K1 and K4 have their own
// register-resident kernels (flash_fullc.cu, flash_wide.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block, 16 per warp
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory plan of one block, in bytes. The per-warp fp32 rows are
// padded (LDS, LDO: +4 floats; LDP: +8 bf16) so the softmax lanes, which walk
// 16 rows at once, spread over the banks; the pads keep wmma's ldm rules.
// Every region size is a multiple of 128 bytes, so every region and every
// 16-row / 16-column fragment in it meets wmma's 32-byte alignment.
template <int D, int BK>
struct Plan {
  static constexpr int LDS = BK + 4, LDP = BK + 8, LDO = D + 4;
  static constexpr int q = kBlockQ * D * 2;          // Q tile, bf16
  static constexpr int k = BK * D * 2;               // K tile, bf16
  static constexpr int v = BK * D * 2;               // V tile, bf16
  static constexpr int s = kWarps * 16 * LDS * 4;    // scores, fp32, per warp
  static constexpr int p = kWarps * 16 * LDP * 2;    // probabilities, bf16, per warp
  static constexpr int o = kWarps * 16 * LDO * 4;    // output accumulator, fp32, per warp
  static constexpr int bytes = q + k + v + s + p + o;
  static_assert(D % 16 == 0 && BK % 32 == 0, "fragment multiples");
  static_assert(s % (kWarps * 128) == 0 && p % (kWarps * 128) == 0 && o % (kWarps * 128) == 0,
                "per-warp regions stay 128-byte aligned");
};

// rows [row0, row0 + ROWS) x columns [0, COLS) of a row-major bf16 matrix
// with row stride ld -> shared memory (row stride COLS). Rows >= nrows and
// columns >= ncols read as zero. 16-byte loads: the caller guarantees that ld
// and ncols are multiples of 8 and the base is 16-byte aligned.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int nrows,
                                          int ld, int ncols) {
  constexpr int kVec = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows && c < ncols)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * COLS + c) = val;
  }
}

// One block: 64 query rows of one (batch, head). D is the head width padded
// to a multiple of 16, BK the key tile.
template <int D, int BK>
__global__ void __launch_bounds__(kThreads)
attn_tile_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int q_len, int kv_len,
                 int heads, int hd, int ld, float scale_log2) {
  using L = Plan<D, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = reinterpret_cast<bf16*>(smem + L::q);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::q + L::k);
  constexpr int LDS = L::LDS, LDP = L::LDP, LDO = L::LDO;
  float* s_w = reinterpret_cast<float*>(smem + L::q + L::k + L::v) + warp * 16 * LDS;
  bf16* p_w = reinterpret_cast<bf16*>(smem + L::q + L::k + L::v + L::s) + warp * 16 * LDP;
  float* o_w = reinterpret_cast<float*>(smem + L::q + L::k + L::v + L::s + L::p) + warp * 16 * LDO;

  const int q0 = blockIdx.x * kBlockQ;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const bf16* q_bh = q + (size_t)b * q_len * ld + h * hd;
  const bf16* k_bh = k + (size_t)b * kv_len * ld + h * hd;
  const bf16* v_bh = v + (size_t)b * kv_len * ld + h * hd;

  load_tile<kBlockQ, D>(q_s, q_bh, q0, q_len, ld, hd);
  for (int i = lane; i < 16 * LDO; i += 32) o_w[i] = 0.f;

  // Softmax ownership: two lanes per query row; lane `half` takes the
  // row's columns half, half + 2, half + 4, ...
  const int row = lane / 2, half = lane % 2;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < kv_len; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<BK, D>(k_s, k_bh, k0, kv_len, ld, hd);
    load_tile<BK, D>(v_s, v_bh, k0, kv_len, ld, hd);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (fp32 accumulate)
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll 4
    for (int d = 0; d < D; d += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa;
      wmma::load_matrix_sync(qa, q_s + warp * 16 * D + d, D);
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, k_s + n * 16 * D + d, D);
        wmma::mma_sync(acc[n], qa, kb, acc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < BK / 16; ++n)
      wmma::store_matrix_sync(s_w + n * 16, acc[n], LDS, wmma::mem_row_major);
    __syncwarp();

    // Online softmax in base 2; keys past kv_len are masked to -inf. Every
    // tile holds at least one real key, so m_new is finite and the first
    // tile's correction exp2(-inf) is exactly 0.
    float* srow = s_w + row * LDS + half;
    float tile_max = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < BK; c += 2) {
      const float s = (k0 + half + c < kv_len) ? srow[c] * scale_log2 : -INFINITY;
      srow[c] = s;
      tile_max = fmaxf(tile_max, s);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_new = fmaxf(m, tile_max);
    const float corr = exp2f(m - m_new);
    float sum = 0.f;
    bf16* prow = p_w + row * LDP + half;
#pragma unroll 8
    for (int c = 0; c < BK; c += 2) {
      const float p = exp2f(srow[c] - m_new);
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * corr + sum;
    m = m_new;
    float* orow = o_w + row * LDO + half;
#pragma unroll 8
    for (int c = 0; c < D; c += 2) orow[c] *= corr;
    __syncwarp();

    // O += P V on this warp's rows
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa[BK / 16];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wmma::load_matrix_sync(pa[kk], p_w + kk * 16, LDP);
#pragma unroll 2
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, o_w + j * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, v_s + kk * 16 * D + j * 16, D);
        wmma::mma_sync(oacc, pa[kk], vb, oacc);
      }
      wmma::store_matrix_sync(o_w + j * 16, oacc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // O / l -> bf16 for the real rows and columns
  const int qrow = q0 + warp * 16 + row;
  if (qrow < q_len) {
    const float inv = 1.f / l;
    bf16* dst = o + ((size_t)b * q_len + qrow) * ld + h * hd;
    for (int c = half; c < hd; c += 2) dst[c] = __float2bfloat16(o_w[row * LDO + c] * inv);
  }
}

template <int D, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch,
                   int q_len, int kv_len, int heads, int hd, cudaStream_t stream) {
  auto kern = attn_tile_kernel<D, BK>;
  const int smem = Plan<D, BK>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((q_len + kBlockQ - 1) / kBlockQ, batch * heads);
  const float scale_log2 = kLog2e / sqrtf((float)hd);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), q_len, kv_len, heads, hd, heads * hd, scale_log2);
  return cudaGetLastError();
}

// Packed heads: the main path's head widths, 40 (level 0, padded to a tile
// width of 48 for Q, K and V alike) and 80 (level 1).
cudaError_t launch_packed(const void* q, const void* k, const void* v, void* o, int batch,
                          int q_len, int kv_len, int heads, int hd, cudaStream_t s) {
  switch (hd) {
    case 40: return launch<48, 64>(q, k, v, o, batch, q_len, kv_len, heads, hd, s);
    case 80: return launch<80, 64>(q, k, v, o, batch, q_len, kv_len, heads, hd, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int md_flash_cross(const void* q, const void* k, const void* v, void* o, int batch, int q_len,
                   int kv_len, int heads, int hd, void* stream) {
  return launch_packed(q, k, v, o, batch, q_len, kv_len, heads, hd,
                       static_cast<cudaStream_t>(stream));
}

const char* md_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
