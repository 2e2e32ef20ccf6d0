// Wide-head attention for short sequences, hand-written for Hopper (sm_90a).
//
//   K9 md_flash_resident  replaces mikudance_tpu/kernels/flash_attention.py
//      _flash_kernel_resident (:85), the branch of flash_attention_padded taken
//      while one head's K and V together stay under 6 MB. The VAE mid-block
//      attention below 512^2: one head of hd = 512 over 1024 <= S <= 3072
//      tokens, softmax(q k^T / sqrt(hd)) v with fp32 scores.
//
// What bounds it on the card: tensor-core work fed from the L2 cache. The TPU
// kernel keeps a head's whole K/V in its on-chip memory; an SM's 227 KB of
// shared memory cannot, but 6 MB a head means every head of a call sits in
// the 50 MB L2. What the bound on S buys here is the other side: a block of
// 16 query rows holds its whole score row block (16 x S fp32 <= 192 KB) in
// shared memory. So Q K^T is computed once, the softmax is one-shot (row
// maximum, then exponentials: no running maximum and no rescaling of the
// accumulator), and the output accumulator lives in registers, its 512
// columns split over the block's eight warps. K and V fragments are read
// straight from global memory (L2) into the tensor cores; only a ragged
// last tile of keys is staged through shared memory, zero-filled, and its
// columns are masked exactly. Products run on nvcuda::wmma bf16 16x16x16
// fragments with fp32 accumulation; the exponentials are cast to bf16 in
// place over the scores before P V, and the row sum divides at the end, as
// the TPU body does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;  // query rows per block
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory plan, in bytes, for a padded key count s_pad (a multiple of
// 16). Score rows carry 8 floats of padding so that the 16 rows of a
// fragment spread over the banks; the pad keeps every fragment 32-byte
// aligned. Q rows carry 8 bf16 for the same reason.
template <int D>
struct Plan {
  static constexpr int LDQ = D + 8;
  static constexpr int q = kRows * LDQ * 2;   // Q tile, bf16; later the output scratch
  static constexpr int l = kRows * 4 + 64;    // row sums, padded to keep 128-byte alignment
  static constexpr int tail = 16 * D * 2;     // ragged K, then V, tile (bf16), if any
  __host__ __device__ static int lds(int s_pad) { return s_pad + 8; }
  __host__ __device__ static int scores(int s_pad) { return kRows * lds(s_pad) * 4; }
  static int bytes(int s_pad, bool ragged) { return scores(s_pad) + q + l + (ragged ? tail : 0); }
  static_assert(D % (16 * kWarps) == 0, "the output columns split evenly over the warps");
  static_assert(q % 128 == 0 && kWarps * 16 * 16 * 4 <= q, "Q tile doubles as output scratch");
};

// 16 rows of D bf16 values, rows [row0, row0 + 16) of a matrix with row
// stride ld, to shared memory with row stride lds; rows >= nrows are zero.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, int lds, const bf16* src, int row0,
                                          int nrows, int ld) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < 16 * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * lds + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
resident_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int seq, int heads, int ld,
                int s_pad, float scale_log2) {
  using L = Plan<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lds = L::lds(s_pad);
  float* s_s = reinterpret_cast<float*>(smem);
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::scores(s_pad));
  float* l_s = reinterpret_cast<float*>(smem + L::scores(s_pad) + L::q);
  bf16* t_s = reinterpret_cast<bf16*>(smem + L::scores(s_pad) + L::q + L::l);

  const int q0 = blockIdx.x * kRows;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const size_t base = (size_t)b * seq * ld + (size_t)h * D;
  const bf16* q_bh = q + base;
  const bf16* k_bh = k + base;
  const bf16* v_bh = v + base;
  const int full_tiles = seq / 16;
  const bool ragged = seq % 16 != 0;

  load_rows<D>(q_s, L::LDQ, q_bh, q0, seq, ld);
  if (ragged) load_rows<D>(t_s, D, k_bh, full_tiles * 16, seq, ld);
  __syncthreads();

  // 1. S = Q K^T, one 16 x 16 key tile per warp in turn; K from global memory.
  for (int tile = warp; tile < full_tiles + (ragged ? 1 : 0); tile += kWarps) {
    const bool from_tail = tile == full_tiles;
    const bf16* kt = from_tail ? t_s : k_bh + (size_t)tile * 16 * ld;
    const int ldk = from_tail ? D : ld;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll 8
    for (int d = 0; d < D; d += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
      wmma::load_matrix_sync(qa, q_s + d, L::LDQ);
      wmma::load_matrix_sync(kb, kt + d, ldk);
      wmma::mma_sync(acc, qa, kb, acc);
    }
    wmma::store_matrix_sync(s_s + tile * 16, acc, lds, wmma::mem_row_major);
  }
  __syncthreads();
  if (ragged) load_rows<D>(t_s, D, v_bh, full_tiles * 16, seq, ld);  // K tail is consumed

  // 2. One-shot softmax in base 2, two rows per warp. The exponentials
  // (unnormalised, <= 1) overwrite the row's scores as bf16, 64 columns at a
  // time: the bf16 of columns [c0, c0 + 64) land on the floats of columns
  // [c0 / 2, c0 / 2 + 32), which this or an earlier round has already read.
  for (int r = 2 * warp; r < 2 * warp + 2; ++r) {
    float* srow = s_s + r * lds;
    float mx = -INFINITY;
    for (int c = lane; c < seq; c += 32) mx = fmaxf(mx, srow[c]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m = mx * scale_log2;
    __nv_bfloat162* prow = reinterpret_cast<__nv_bfloat162*>(srow);
    float sum = 0.f;
    for (int c0 = 0; c0 < s_pad; c0 += 64) {
      const int c = c0 + 2 * lane;
      float2 e = make_float2(0.f, 0.f);
      if (c < s_pad) {
        const float2 s = *reinterpret_cast<const float2*>(srow + c);
        if (c < seq) e.x = exp2f(s.x * scale_log2 - m);
        if (c + 1 < seq) e.y = exp2f(s.y * scale_log2 - m);
      }
      __syncwarp();
      if (c < s_pad) {
        // the sum counts what P V will use: the values rounded to bf16
        const __nv_bfloat162 p = __floats2bfloat162_rn(e.x, e.y);
        prow[c / 2] = p;
        sum += __low2float(p) + __high2float(p);
      }
      __syncwarp();
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) l_s[r] = sum;
  }
  __syncthreads();

  // 3. O = P V: this warp's D / 8 output columns, accumulated in registers;
  // V from global memory.
  constexpr int kFrags = D / 16 / kWarps;
  const int col0 = warp * kFrags * 16;
  const bf16* p_s = reinterpret_cast<const bf16*>(s_s);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[kFrags];
#pragma unroll
  for (int j = 0; j < kFrags; ++j) wmma::fill_fragment(oacc[j], 0.f);
#pragma unroll 2
  for (int tile = 0; tile < full_tiles; ++tile) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
    wmma::load_matrix_sync(pa, p_s + tile * 16, 2 * lds);
#pragma unroll
    for (int j = 0; j < kFrags; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
      wmma::load_matrix_sync(vb, v_bh + (size_t)tile * 16 * ld + col0 + j * 16, ld);
      wmma::mma_sync(oacc[j], pa, vb, oacc[j]);
    }
  }
  if (ragged) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
    wmma::load_matrix_sync(pa, p_s + full_tiles * 16, 2 * lds);
#pragma unroll
    for (int j = 0; j < kFrags; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
      wmma::load_matrix_sync(vb, t_s + col0 + j * 16, D);
      wmma::mma_sync(oacc[j], pa, vb, oacc[j]);
    }
  }

  // 4. O / l -> bf16, through a 16 x 16 fp32 scratch per warp (the Q tile's
  // room: Q was last read before the second barrier). Two lanes a row, eight
  // columns (one 16-byte store) each.
  float* scratch = reinterpret_cast<float*>(q_s) + warp * 256;
  const int row = lane / 2, c8 = (lane % 2) * 8;
  const float inv = 1.f / l_s[row];
  const int qrow = q0 + row;
#pragma unroll
  for (int j = 0; j < kFrags; ++j) {
    wmma::store_matrix_sync(scratch, oacc[j], 16, wmma::mem_row_major);
    __syncwarp();
    if (qrow < seq) {
      const float* src = scratch + row * 16 + c8;
      __align__(16) __nv_bfloat162 out[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        out[i] = __floats2bfloat162_rn(src[2 * i] * inv, src[2 * i + 1] * inv);
      *reinterpret_cast<uint4*>(o + base + (size_t)qrow * ld + col0 + j * 16 + c8) =
          *reinterpret_cast<const uint4*>(out);
    }
    __syncwarp();
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int seq,
                   int heads, cudaStream_t stream) {
  const int s_pad = (seq + 15) / 16 * 16;
  const int smem = Plan<D>::bytes(s_pad, seq % 16 != 0);
  auto kern = resident_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kRows - 1) / kRows, batch * heads);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), seq, heads, heads * D, s_pad, kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: (batch, seq, heads * 512) bf16, contiguous and 32-byte aligned
// (the fragment loads from global memory need it); seq <= 3072, so that the
// 16 x seq fp32 scores fit a block's shared memory.
int md_flash_resident(const void* q, const void* k, const void* v, void* o, int batch, int seq,
                      int heads, int hd, void* stream) {
  if (hd != 512 || seq < 1 || seq > 3072) return cudaErrorInvalidValue;
  return launch<512>(q, k, v, o, batch, seq, heads, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
