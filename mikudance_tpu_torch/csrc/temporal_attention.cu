// Attention over at most 32 tokens a sequence on the tensor cores, hand-written
// for Hopper (sm_90a). One kernel, two entry points, each its own
// instantiation (a kernel tag in the template arguments, so that a profile
// tells them apart):
//
//   K3  md_temporal_attention  replaces mikudance_tpu/kernels/temporal_attention.py
//       _temporal_kernel_btpc (:120, entry temporal_attention_btpc :179): the
//       motion modules' attention across T <= 32 frames on their native
//       (B, T, P, C) layout; a sequence is one (batch, position), its tokens
//       P * C apart.
//   K13 md_small_attention     replaces _temporal_kernel (:29, entry
//       temporal_attention_fused :64): (N, T, C), N sequences of T <= 32
//       tokens C apart (the UNet mid-block's self-attention on a map of at
//       most 32 tokens).
//
// Per (sequence, head), heads of 40, 80 or 160 packed in C (and 8, 16 or 24:
// the tiny twins' 4 heads at 32, 64 and 96 channels that verify_parity
// --selfcheck drives), as both TPU bodies compute it:
//     q' = bf16(q * (log2(e) / sqrt(hd)))      scaled in fp32, then rounded
//     s  = q' . bf16(k)                        fp32 accumulation
//     p  = exp2(s - max_j s)                   keys past T masked
//     o  = bf16(p / sum_j p) . bf16(v)         fp32 accumulation
// The scores are not scaled after the product.
//
// What bounds it on the card: bytes. q, k and v are read once and o written
// once, 8 B T P C bytes (0.755 GB at (2, 16, 9216, 320): 0.225 ms at 3.35
// TB/s) against 4 B P T^2 C flops (6 GFLOP, ~0.01 ms on the tensor cores).
//
// Design. A block owns a tile: `ns` whole sequences (ns * TP <= 32 rows, TP
// = T rounded up to 16) by a group of `gh` heads (gh * hd <= 320 channels),
// chosen by the wrapper (kernels/temporal_attention.py::tile_plan) so that
// the grid has at least two blocks an SM; the head group runs fastest in the
// grid, so neighbouring blocks read one row's channels side by side. Its q,
// k and v arrive by 16-byte cp.async chunks in bf16 (no fp32 staging), a
// row's channels side by side in shared memory with a 16-byte pad
// (conflict-free ldmatrix); rows past T and sequences past the end arrive as
// zeros (cp.async's zero fill), so the padded rows of V are zeros, never the
// next sequence's data. Frame T of a K3 position is the next batch element's
// frame 0 and is never read. A tile is 63 KB at most, three blocks an SM,
// whose loads overlap one another's products.
// A unit is one m16 row tile of one (sequence, head); each of the block's 4
// or 8 warps takes units in turn:
//   Q' fragments: ldmatrix, scaled in fp32 and rounded to bf16 in registers;
//   at hd 40 the third k16 step's channels 40-47 are zeroed there (and the
//   pad column of K is zero, so the last head of a group reads no garbage);
//   S = Q' K^T on mma.sync m16n8k16 (K fragments by ldmatrix), fp32 in
//   registers; the softmax there (a row spans a quad: two shuffles for the
//   maximum, two for the sum), P = p / l rounded to bf16 pairs that are the
//   A operand of P V; O += P V with V by ldmatrix.trans, at hd 160 in two
//   halves of 80 channels (fewer registers a thread).
// O goes back as bf16 over the unit's own Q rows, then the block stores
// whole rows with 16-byte stores. wgmma's 64-row minimum would waste 2-4x on
// masked scores; at these sizes the products are not the limit, so mma.sync
// is the unit.
// fp32 requests (fp32 != 0 at the entry points): the wrapper hands the kernel
// q' = bf16(q * log2(e) / sqrt(hd)), scaled in fp32 and rounded once as the
// TPU bodies do, so the kernel's own factor is exactly 1, with K and V cast
// to bf16 (the bodies round them first: the same bits); O is stored as fp32
// straight from the accumulator (a quad writes a row's 32 contiguous bytes of
// a head), never rounded to bf16. A runtime switch: only the store differs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "mma_sync.cuh"

using namespace md_cp;
using namespace md_mma;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxTokens = 32;
constexpr int kTileRows = 32;        // ns * TP at most
constexpr int kGroupChannels = 320;  // gh * hd at most
constexpr int kPad = 8;              // bf16 past a staged row's channels
constexpr int kMaxSmem = 3 * kTileRows * (kGroupChannels + kPad) * 2;
constexpr double kLog2e = 1.4426950408889634;

// Where row (sequence s, token t) of a tensor starts, in elements:
// (s / inner) * outer_stride + (s % inner) * inner_stride + t * token_stride,
// taken per block: blockIdx.y is s / inner.
struct Rows {
  long long outer_stride, inner_stride, token_stride;
  int inner;  // sequences of one outer index
};

template <int kTag, int HD, int TP>
__global__ void __launch_bounds__(kMaxThreads, 2)
short_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, void* __restrict__ o, bool o_fp32,
                       const Rows rows, int T, int ns, int gh, int groups, float q_mult) {
  constexpr int KS = (HD + 15) / 16;       // k16 steps of Q' K^T
  constexpr int NO = HD / 8;               // n8 tiles of O
  constexpr int NOH = NO > 10 ? NO / 2 : NO;  // of them at once (hd 160: two halves)
  constexpr int NS = TP / 8;               // n8 tiles of S (keys)
  constexpr int MT = TP / 16;              // m16 row tiles of a sequence
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cg = gh * HD, ld = cg + kPad, R = ns * TP, chunks = cg / 8;
  const int threads = blockDim.x, warps = threads / 32;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + R * ld;
  bf16* vs = ks + R * ld;
  // the head group runs fastest, so that neighbouring blocks read one row's
  // channels side by side
  const int group = blockIdx.x % groups, s0 = (blockIdx.x / groups) * ns;
  const long long base = blockIdx.y * rows.outer_stride + static_cast<long long>(group) * cg;

  // K's pad columns: hd 40's third k16 step reads them at the group's last head
  for (int r = threadIdx.x; r < R; r += threads)
    *reinterpret_cast<uint4*>(ks + r * ld + cg) = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < R * chunks; i += threads) {
    const int r = i / chunks, c = (i - r * chunks) * 8, s = r / TP, t = r % TP;
    const bool valid = t < T && s0 + s < rows.inner;
    const long long g =
        valid ? base + (s0 + s) * rows.inner_stride + t * rows.token_stride + c : 0;
    cp_async16(qs + r * ld + c, q + g, valid);
    cp_async16(ks + r * ld + c, k + g, valid);
    cp_async16(vs + r * ld + c, v + g, valid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c2 = 2 * (lane % 4);
  // ldmatrix row / column of this lane: A fragments (Q') and transposed B
  // fragments (V); non-transposed B fragments (K)
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);
  // a unit: one m16 row tile of one (sequence, head)
  for (int u = warp; u < ns * gh * MT; u += warps) {
    const int s = u / (gh * MT), hc = (u / MT - s * gh) * HD, mt = u % MT;
    if (s0 + s >= rows.inner) break;  // warp-uniform; later units lie further out
    bf16* qu = qs + (s * TP + 16 * mt) * ld + hc;
    const bf16* ku = ks + s * TP * ld + hc;
    const bf16* vu = vs + s * TP * ld + hc;
    float sacc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, smem_addr(qu + a_row * ld + 16 * kk + a_col));
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = pack_bf16(bf16_lo(a[i]) * q_mult, bf16_hi(a[i]) * q_mult);
      if (HD % 16 != 0 && kk == KS - 1) a[2] = a[3] = 0u;  // channels hd .. 16 KS - 1
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t b[4];
        ldsm_x4(b, smem_addr(ku + (8 * n + b_row) * ld + 16 * kk + b_col));
        mma_bf16(sacc[n], a, b[0], b[1]);
        mma_bf16(sacc[n + 1], a, b[2], b[3]);
      }
    }
    // softmax over the keys of rows g and g + 8; keys past T are masked
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (8 * n + c2 + j >= T) sacc[n][j] = sacc[n][2 + j] = -INFINITY;
      }
      m0 = fmaxf(m0, fmaxf(sacc[n][0], sacc[n][1]));
      m1 = fmaxf(m1, fmaxf(sacc[n][2], sacc[n][3]));
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      sacc[n][0] = exp2f(sacc[n][0] - m0);
      sacc[n][1] = exp2f(sacc[n][1] - m0);
      sacc[n][2] = exp2f(sacc[n][2] - m1);
      sacc[n][3] = exp2f(sacc[n][3] - m1);
      l0 += sacc[n][0] + sacc[n][1];
      l1 += sacc[n][2] + sacc[n][3];
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    // P = bf16(p / l): two n8 tiles of S side by side are one k16 A tile
    uint32_t pa[TP / 16][4];
#pragma unroll
    for (int kk = 0; kk < TP / 16; ++kk) {
      pa[kk][0] = pack_bf16(__fdiv_rn(sacc[2 * kk][0], l0), __fdiv_rn(sacc[2 * kk][1], l0));
      pa[kk][1] = pack_bf16(__fdiv_rn(sacc[2 * kk][2], l1), __fdiv_rn(sacc[2 * kk][3], l1));
      pa[kk][2] =
          pack_bf16(__fdiv_rn(sacc[2 * kk + 1][0], l0), __fdiv_rn(sacc[2 * kk + 1][1], l0));
      pa[kk][3] =
          pack_bf16(__fdiv_rn(sacc[2 * kk + 1][2], l1), __fdiv_rn(sacc[2 * kk + 1][3], l1));
    }
    // all of this row tile's Q fragments are read: its rows take O (bf16), or
    // O goes straight to memory (fp32): token 16 mt + g and 16 mt + g + 8
    __syncwarp();
    bf16* orow = qu + g * ld + c2;
    const int tok = 16 * mt + g;
    float* o32 = static_cast<float*>(o) + base + (s0 + s) * rows.inner_stride +
                 tok * rows.token_stride + hc + c2;
#pragma unroll
    for (int h0 = 0; h0 < NO; h0 += NOH) {
      float oacc[NOH][4];
#pragma unroll
      for (int n = 0; n < NOH; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < TP / 16; ++kk) {
        const bf16* vrow = vu + (16 * kk + a_row) * ld + 8 * h0;
#pragma unroll
        for (int n = 0; n < NOH; n += 2) {
          if (n + 1 < NOH) {
            uint32_t b[4];
            ldsm_x4_t(b, smem_addr(vrow + 8 * n + a_col));
            mma_bf16(oacc[n], pa[kk], b[0], b[1]);
            mma_bf16(oacc[n + 1], pa[kk], b[2], b[3]);
          } else {
            uint32_t b0, b1;
            ldsm_x2_t(b0, b1, smem_addr(vrow + 8 * n));
            mma_bf16(oacc[n], pa[kk], b0, b1);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NOH; ++n) {
        if (o_fp32) {
          if (tok < T)
            *reinterpret_cast<float2*>(o32 + 8 * (h0 + n)) = make_float2(oacc[n][0], oacc[n][1]);
          if (tok + 8 < T)
            *reinterpret_cast<float2*>(o32 + 8 * rows.token_stride + 8 * (h0 + n)) =
                make_float2(oacc[n][2], oacc[n][3]);
          continue;
        }
        *reinterpret_cast<uint32_t*>(orow + 8 * (h0 + n)) = pack_bf16(oacc[n][0], oacc[n][1]);
        *reinterpret_cast<uint32_t*>(orow + 8 * ld + 8 * (h0 + n)) =
            pack_bf16(oacc[n][2], oacc[n][3]);
      }
    }
  }
  if (o_fp32) return;
  __syncthreads();
  for (int i = threadIdx.x; i < R * chunks; i += threads) {
    const int r = i / chunks, c = (i - r * chunks) * 8, s = r / TP, t = r % TP;
    if (t < T && s0 + s < rows.inner)
      *reinterpret_cast<uint4*>(static_cast<bf16*>(o) + base + (s0 + s) * rows.inner_stride +
                                t * rows.token_stride + c) =
          *reinterpret_cast<const uint4*>(qs + r * ld + c);
  }
}

template <int kTag, int HD, int TP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, bool fp32,
                   const Rows& rows, int outer, int T, int heads, int ns, int gh, int warps,
                   cudaStream_t stream) {
  auto kern = short_attention_kernel<kTag, HD, TP>;
  // once a process, at the most any plan may ask for
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const size_t smem = static_cast<size_t>(3) * ns * TP * (gh * HD + kPad) * sizeof(bf16);
  const int groups = heads / gh;
  const long long blocks = static_cast<long long>((rows.inner + ns - 1) / ns) * groups;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // log2(e) / sqrt(hd) as the TPU body's fp32 constant: the double product,
  // rounded; 1 where the caller scaled and rounded q (fp32)
  const float q_mult =
      fp32 ? 1.f : static_cast<float>(1.0 / sqrt(static_cast<double>(HD)) * kLog2e);
  kern<<<dim3(static_cast<unsigned>(blocks), outer), 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), o,
      fp32, rows, T, ns, gh, groups, q_mult);
  return cudaGetLastError();
}

// hd 8, 16, 24, 40, 80 or 160; 1 <= T <= 32; a tile of ns sequences (ns * TP
// <= 32 rows) by gh heads (gh divides heads, gh * hd <= 320 channels); 1 to 8
// warps a block
template <int kTag>
int dispatch(const void* q, const void* k, const void* v, void* o, int fp32, const Rows& rows,
             int outer, int T, int channels, int heads, int ns, int gh, int warps,
             void* stream) {
  if (heads < 1 || channels % heads != 0 || T < 1 || T > kMaxTokens || rows.inner < 1 ||
      outer < 1 || outer > 65535 || ns < 1 || gh < 1 || heads % gh != 0 || warps < 1 ||
      32 * warps > kMaxThreads)
    return cudaErrorInvalidValue;
  const int hd = channels / heads, tp = T > 16 ? 32 : 16;
  if (ns * tp > kTileRows || gh * hd > kGroupChannels) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f = fp32 != 0;
#define MD_SHORT(HD, TP)                                                                   \
  case HD * 100 + TP:                                                                      \
    return launch<kTag, HD, TP>(q, k, v, o, f, rows, outer, T, heads, ns, gh, warps, s);
  switch (hd * 100 + tp) {
    MD_SHORT(8, 16) MD_SHORT(8, 32) MD_SHORT(16, 16) MD_SHORT(16, 32) MD_SHORT(24, 16)
    MD_SHORT(24, 32) MD_SHORT(40, 16) MD_SHORT(40, 32) MD_SHORT(80, 16) MD_SHORT(80, 32)
    MD_SHORT(160, 16) MD_SHORT(160, 32)
    default: return cudaErrorInvalidValue;
  }
#undef MD_SHORT
}

}  // namespace

extern "C" {

// q, k, v, o: (batch, frames, positions, channels) bf16, contiguous, 16-byte
// aligned; a sequence is one (batch, position); fp32 != 0: q holds q' (scaled
// by log2(e) / sqrt(hd) and rounded to bf16 by the caller) and o is fp32.
// K3's counter and symbol.
int md_temporal_attention(const void* q, const void* k, const void* v, void* o, int batch,
                          int frames, int positions, int channels, int heads, int seqs_per_tile,
                          int heads_per_tile, int warps, int fp32, void* stream) {
  const long long pc = static_cast<long long>(positions) * channels;
  const Rows rows{frames * pc, channels, pc, positions};
  return dispatch<3>(q, k, v, o, fp32, rows, batch, frames, channels, heads, seqs_per_tile,
                     heads_per_tile, warps, stream);
}

// q, k, v, o: (sequences, tokens, channels) bf16, contiguous, 16-byte
// aligned; fp32 as above. K13's counter and symbol.
int md_small_attention(const void* q, const void* k, const void* v, void* o, int sequences,
                       int tokens, int channels, int heads, int seqs_per_tile, int heads_per_tile,
                       int warps, int fp32, void* stream) {
  const Rows rows{0, static_cast<long long>(tokens) * channels, channels, sequences};
  return dispatch<13>(q, k, v, o, fp32, rows, 1, tokens, channels, heads, seqs_per_tile,
                      heads_per_tile, warps, stream);
}

}  // extern "C"
