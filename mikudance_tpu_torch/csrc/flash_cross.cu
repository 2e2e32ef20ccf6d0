// Cross-attention from the UNet tokens to the CLIP context, hand-written for
// Hopper (sm_90a), with the context's K and V held in shared memory.
//
//   K2 md_flash_cross  replaces mikudance_tpu/kernels/flash_attention.py
//      _cross_kernel_fullc (:598, entry flash_attention_cross :631): S queries
//      (9216 and 2304 tokens at 768^2, 5184 and 1296 at 576^2; 16384, 4096
//      and 1024 at 1024^2) against the 257 CLIP tokens, heads of 40, 80 and
//      160 packed in C, the exact softmax; any 1 to 512 keys.
//
// What bounds it on the card: S x 257 scores a head against S hd bytes of Q
// and O. At (32, 9216, 320) the bytes (0.38 GB of Q and O) take 0.116 ms at
// 3.35 TB/s, the 0.64 G exponentials ~0.15 ms on the special-function units,
// the products ~0.10 ms at the bf16 tensor peak: bytes and exponentials, not
// tensor flops, so mma.sync (mma_sync.cuh) serves and wgmma is not needed.
//
// Design. A block owns one (batch, head) and a contiguous range of query
// tiles of 16 rows a warp (8 warps, 128 rows; 4 warps, 64 rows at hd 160),
// enough blocks to fill the card. It
// loads that head's K and V once into shared memory by cp.async (16-byte
// chunks of the head's channel slice, read in place at row stride C; keys
// rounded up to a multiple of 16 with zero rows, a head of 40 padded to 48
// columns with zeros), then walks its query tiles; the Q tiles go through a
// two-stage cp.async ring, so the next tile's load overlaps this tile's work.
// Per query tile a warp holds its 16 rows as ldmatrix A fragments and walks
// the keys in tiles of 64, then in tails of 16 (257 keys cost 272):
//   S = Q K^T on m16n8k16 in registers, scaled by log2(e) / sqrt(hd) in fp32;
//   the exact online softmax in base 2 in registers (running maximum and fp32
//   running sum per row, the quad's four lanes reduce; keys past S_kv are
//   -inf, so p = 0 exactly), P rounded to bf16 pairs that are the A operand
//   of P V (the FA2 register reuse);
//   O += P V with V fragments by ldmatrix.trans, O in registers.
// p is rounded to bf16 before the division by the row sum (the sum in fp32
// over the unrounded p); the TPU kernel divides first and then rounds. Both
// orders are within the port's limits of the exact softmax. Scores, P and O
// never touch shared memory.
// Heads of 160: a Q tile of 128 rows is 43 KB a stage and 512 keys of K and V
// 344 KB, over the 227 KB a block may have. So Q tiles are 64 rows (two
// stages, 43 KB) and the keys are held in chunks of at most 272 (183 KB: the
// CLIP context's 257 in one, loaded once a block as above). Past 272 keys
// each query tile walks the chunks in turn, reloading each into the same
// rows, and the online softmax's running maximum and sum carry across them. O / l leaves as bf16 through the warp's own rows
// of its Q stage (free once the Q fragments are in registers), then 16-byte
// stores along the rows.

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

constexpr int kMaxKeys = 512;         // the context the kernel takes
constexpr float kLog2e = 1.4426950408889634f;
// blocks a launch aims at, in waves of the blocks the card holds at once:
// fewer waves reload K and V less often, more even out the last wave
constexpr int kWaves = 3;

// Shared-memory plan for a head width HD: Q K^T runs over KS slices of 16
// channels (D = 16 KS columns, zero past HD); rows carry 8 bf16 of padding so
// that the 8 rows an ldmatrix reads fall on distinct banks. K and V hold up to
// `chunk` keys at a time: all 512 the kernel takes below hd 160.
template <int HD>
struct Plan {
  static constexpr int warps = HD == 160 ? 4 : 8;
  static constexpr int threads = 32 * warps;
  static constexpr int block_q = 16 * warps;   // query rows a tile
  static constexpr int chunk = HD == 160 ? 272 : kMaxKeys;
  static constexpr int KS = (HD + 15) / 16;
  static constexpr int D = 16 * KS;
  static constexpr int LD = D + 8;
  static constexpr int NT = HD / 8;            // n8 tiles of the output
  static constexpr int q_tile = block_q * LD;  // elements of one Q stage
  static constexpr int q = 2 * q_tile * 2;     // the ring's two stages, bf16
  // K then V, keys rows each: bytes
  static int kv(int keys) { return 2 * keys * LD * 2; }
  static_assert(HD % 8 == 0 && (LD * 2) % 16 == 0, "16-byte chunks and ldmatrix rows");
  static_assert(chunk % 16 == 0 && q + 2 * chunk * LD * 2 <= 232448, "one block's shared memory");
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

// The running softmax state of one warp's 16 rows: this lane's rows g and
// g + 8, their maxima (log2 domain) and its share of their sums.
template <int NT>
struct Rows {
  float o[NT][4];
  float m0, m1, l0, l1;
};

// One key tile of NJ x 16 keys (NJ = 4 for a full tile, 1 for a tail) at kt /
// vt (row stride LD), of which the first `valid` are real: S, the online
// softmax update, O += P V.
template <int HD, int NJ>
__device__ __forceinline__ void key_tile(Rows<Plan<HD>::NT>& st,
                                         const uint32_t (&qa)[Plan<HD>::KS][4], const bf16* kt,
                                         const bf16* vt, int valid, float scale_log2) {
  using L = Plan<HD>;
  constexpr int KS = L::KS, LD = L::LD, NT = L::NT;
  const int lane = threadIdx.x % 32;
  const int c2 = (lane % 4) * 2;
  const int k_row = (lane % 8) + (lane / 16) * 8, k_col = ((lane / 8) % 2) * 8;
  const int v_row = (lane % 8) + ((lane / 8) % 2) * 8, v_col = (lane / 16) * 8;

  float s[2 * NJ][4];
#pragma unroll
  for (int n = 0; n < 2 * NJ; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kb[4];
      ldsm_x4(kb, smem_addr(kt + (j * 16 + k_row) * LD + kk * 16 + k_col));
      mma_bf16(s[2 * j], qa[kk], kb[0], kb[1]);
      mma_bf16(s[2 * j + 1], qa[kk], kb[2], kb[3]);
    }
  }
  // scale, mask, the tile's row maxima
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < 2 * NJ; ++n) {
    const int key = n * 8 + c2;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = key + e < valid;
      s[n][e] = ok ? s[n][e] * scale_log2 : -INFINITY;
      s[n][2 + e] = ok ? s[n][2 + e] * scale_log2 : -INFINITY;
      mx0 = fmaxf(mx0, s[n][e]);
      mx1 = fmaxf(mx1, s[n][2 + e]);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // every tile holds a real key, so the new maxima are finite and the first
  // tile's correction ex2(-inf) is exactly 0
  const float m0 = fmaxf(st.m0, mx0), m1 = fmaxf(st.m1, mx1);
  const float corr0 = ex2(st.m0 - m0), corr1 = ex2(st.m1 - m1);
  st.m0 = m0;
  st.m1 = m1;
  st.l0 *= corr0;
  st.l1 *= corr1;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    st.o[n][0] *= corr0;
    st.o[n][1] *= corr0;
    st.o[n][2] *= corr1;
    st.o[n][3] *= corr1;
  }
  // p and O += P V, 16 keys at a time
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t pa[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float* c = s[2 * j + half];
      const float p0 = ex2(c[0] - m0), p1 = ex2(c[1] - m0);
      const float p2 = ex2(c[2] - m1), p3 = ex2(c[3] - m1);
      st.l0 += p0 + p1;
      st.l1 += p2 + p3;
      pa[2 * half] = pack_bf16(p0, p1);
      pa[2 * half + 1] = pack_bf16(p2, p3);
    }
    const bf16* vj = vt + j * 16 * LD;
#pragma unroll
    for (int n = 0; n + 1 < NT; n += 2) {
      uint32_t vb[4];
      ldsm_x4_t(vb, smem_addr(vj + v_row * LD + n * 8 + v_col));
      mma_bf16(st.o[n], pa, vb[0], vb[1]);
      mma_bf16(st.o[n + 1], pa, vb[2], vb[3]);
    }
    if constexpr (NT % 2) {
      uint32_t vb0, vb1;
      ldsm_x2_t(vb0, vb1, smem_addr(vj + v_row * LD + (NT - 1) * 8));
      mma_bf16(st.o[NT - 1], pa, vb0, vb1);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(Plan<HD>::threads, HD == 40 ? 2 : 1)
flash_cross_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, int q_len, int kv_len,
                   int heads, int tiles_per_block, float scale_log2) {
  using L = Plan<HD>;
  constexpr int KS = L::KS, LD = L::LD, NT = L::NT, kBlockQ = L::block_q;
  extern __shared__ __align__(128) unsigned char smem[];
  // rows of the K and V tiles: the keys rounded up to 16, at most a chunk
  const int keys = min((kv_len + 15) / 16 * 16, L::chunk);
  const int chunks = (kv_len + L::chunk - 1) / L::chunk;  // 1 below hd 160
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = reinterpret_cast<bf16*>(smem + L::q);
  bf16* v_s = k_s + keys * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4;

  const int ld = heads * HD;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const bf16* q_bh = q + static_cast<size_t>(b) * q_len * ld + h * HD;
  const bf16* k_bh = k + static_cast<size_t>(b) * kv_len * ld + h * HD;
  const bf16* v_bh = v + static_cast<size_t>(b) * kv_len * ld + h * HD;
  bf16* o_bh = o + static_cast<size_t>(b) * q_len * ld + h * HD;
  const int tile0 = blockIdx.x * tiles_per_block;
  const int tiles = min(tiles_per_block, (q_len + kBlockQ - 1) / kBlockQ - tile0);

  // the copies fill columns [0, HD): a head of 40 has its pad columns 40-47
  // of K and of both Q stages zeroed here once (they meet in Q K^T, and
  // 0 x garbage could be NaN)
  if constexpr (L::D > HD) {
    for (int r = threadIdx.x; r < 2 * kBlockQ + keys; r += L::threads)
      *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(smem) + r * LD + HD) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  // group 0: the first Q tile and, where one chunk holds every key, the
  // head's K and V for all of the block's tiles
  if (chunks == 1) {
    load_rows<HD>(k_s, k_bh, 0, keys, kv_len, ld);
    load_rows<HD>(v_s, v_bh, 0, keys, kv_len, ld);
  }
  load_rows<HD>(q_s, q_bh, tile0 * kBlockQ, kBlockQ, q_len, ld);
  cp_async_commit();

  for (int t = 0; t < tiles; ++t) {
    bf16* q_t = q_s + (t & 1) * L::q_tile;
    if (t + 1 < tiles)  // the other stage was released by the barrier ending tile t - 1
      load_rows<HD>(q_s + ((t + 1) & 1) * L::q_tile, q_bh, (tile0 + t + 1) * kBlockQ, kBlockQ,
                    q_len, ld);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: Q tile t (and K, V) have landed
    __syncthreads();

    bf16* q_w = q_t + warp * 16 * LD;  // this warp's rows
    uint32_t qa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldsm_x4(qa[kk], smem_addr(q_w + (lane % 16) * LD + kk * 16 + (lane / 16) * 8));

    Rows<NT> st;
#pragma unroll
    for (int n = 0; n < NT; ++n) st.o[n][0] = st.o[n][1] = st.o[n][2] = st.o[n][3] = 0.f;
    st.m0 = st.m1 = -INFINITY;
    st.l0 = st.l1 = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const int key0 = c * L::chunk, len = min(L::chunk, kv_len - key0);
      if (chunks > 1) {  // this chunk into the K and V rows, after every warp's last use
        if (c > 0) __syncthreads();  // (chunk 0: the barrier ending tile t - 1)
        load_rows<HD>(k_s, k_bh, key0, (len + 15) / 16 * 16, kv_len, ld);
        load_rows<HD>(v_s, v_bh, key0, (len + 15) / 16 * 16, kv_len, ld);
        cp_async_commit();
        cp_async_wait<0>();  // also Q tile t + 1, which the next tile waits for anyway
        __syncthreads();
      }
      const int full = len / 64, tail = (len % 64 + 15) / 16;
      for (int j = 0; j < full; ++j)
        key_tile<HD, 4>(st, qa, k_s + j * 64 * LD, v_s + j * 64 * LD, 64, scale_log2);
      for (int j = 0; j < tail; ++j) {
        const int r0 = full * 64 + j * 16;
        key_tile<HD, 1>(st, qa, k_s + r0 * LD, v_s + r0 * LD, len - r0, scale_log2);
      }
    }

    // O / l -> bf16 into this warp's Q rows (its own: no other warp reads
    // them), then 16-byte stores of whole rows
    float l0 = st.l0, l1 = st.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int c2 = (lane % 4) * 2;
    __syncwarp();  // every lane's ldmatrix of these rows is done
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(q_w + g * LD + n * 8 + c2) =
          __floats2bfloat162_rn(st.o[n][0] * inv0, st.o[n][1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(q_w + (g + 8) * LD + n * 8 + c2) =
          __floats2bfloat162_rn(st.o[n][2] * inv1, st.o[n][3] * inv1);
    }
    __syncwarp();
    const int row0 = (tile0 + t) * kBlockQ + warp * 16;
    for (int i = lane; i < 16 * NT; i += 32) {
      const int r = i / NT, c = (i % NT) * 8;
      if (row0 + r < q_len)
        *reinterpret_cast<uint4*>(o_bh + static_cast<size_t>(row0 + r) * ld + c) =
            *reinterpret_cast<const uint4*>(q_w + r * LD + c);
    }
    __syncthreads();  // every warp is done with stage t & 1 (and with the chunk)
  }
  cp_async_wait<0>();
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int q_len,
                   int kv_len, int heads, cudaStream_t stream) {
  using L = Plan<HD>;
  auto kern = flash_cross_kernel<HD>;
  const int smem = L::q + L::kv(std::min((kv_len + 15) / 16 * 16, L::chunk));
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // each (batch, head) split into ranges of query tiles, enough blocks for
  // kWaves waves of the blocks the card holds at once
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, L::threads, smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (q_len + L::block_q - 1) / L::block_q;
  const int pairs = batch * heads;
  const int ranges = std::min(q_tiles, std::max(1, (kWaves * sms * per_sm + pairs - 1) / pairs));
  const int per_block = (q_tiles + ranges - 1) / ranges;
  const dim3 grid((q_tiles + per_block - 1) / per_block, pairs);
  kern<<<grid, L::threads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), q_len, kv_len, heads, per_block,
      kLog2e / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (batch, q_len, heads * hd), k and v (batch, kv_len, heads * hd), o like
// q: bf16, contiguous, 16-byte aligned; hd 40, 80 or 160, any head count, any
// q_len >= 1, 1 <= kv_len <= 512.
int md_flash_cross(const void* q, const void* k, const void* v, void* o, int batch, int q_len,
                   int kv_len, int heads, int hd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_len < 1 || kv_len < 1 || kv_len > kMaxKeys) return cudaErrorInvalidValue;
  switch (hd) {
    case 40: return launch<40>(q, k, v, o, batch, q_len, kv_len, heads, s);
    case 80: return launch<80>(q, k, v, o, batch, q_len, kv_len, heads, s);
    case 160: return launch<160>(q, k, v, o, batch, q_len, kv_len, heads, s);
    default: return cudaErrorInvalidValue;
  }
}

// Every entry point of the library returns a cudaError_t; its message.
const char* md_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
