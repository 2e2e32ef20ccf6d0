// Anchored packed-heads self-attention with its scores in registers,
// hand-written for Hopper (sm_90a).
//
//   K1 md_flash_fullc  replaces mikudance_tpu/kernels/flash_attention.py
//      _flash_kernel_fullc_nt (:485, entry flash_attention_fullc_nt :546): the
//      route of the UNet's spatial self-attention under the default switches
//      (8 heads of 40 at S = 9216, 8 heads of 80 at S = 2304 for 768^2).
//
// Per head of (B, S, C) bf16 tensors with the heads packed in C:
//     q'  = q * (log2(e) / sqrt(hd))                     fp32
//     off = bf16(sum_d q'_d q_d)                         the row's self-score
//     s   = bf16(q') . k - off                           fp32 accumulation
//     p   = bf16(exp2(clip(s, -100, 100)))
//     o   = (sum_j p_j v_j) / (sum_j p_j)                both sums fp32 over bf16 p
// which is what the TPU kernel computes with the anchor as one more bf16
// column of Q against a column of ones in K (K12 does the same; the JAX
// package calls the two bit-identical). No running maximum, so no rescale.
//
// What bounds it on the card. At hd 40 a score costs 2 * (48 + 40) tensor-core
// flops (Q K^T on the head padded to 48, P V on 40) and one exp2. At
// (32, 9216, 320) that is 21.7 G exp2: at the special-function unit's 16 a
// clock an SM (~3.9 T/s on 132 SMs) ~5.6 ms, above the 3.52 ms of the
// attention's 4 B S^2 C flops at the bf16 tensor peak. The exponent unit, not
// the tensor cores, sets this kernel's floor, so mma.sync is the product used
// here; wgmma with warp specialisation would not lift it.
//
// Design. A block of 8 warps owns 128 query rows of one (batch, head), 16 a
// warp. Q is scaled in fp32, rounded to bf16 and staged once; each warp then
// holds its 16 rows as mma.sync A fragments (ldmatrix) for the whole key loop,
// and each lane the bf16 anchors of its two rows. Key tiles of 64 rows of K
// and V go through a ring of three shared-memory stages filled by cp.async
// (16-byte chunks of the head's channel slice, read in place at row stride C;
// a head of 40 is 5 chunks a row and its pad columns 40-47 are zeroed once),
// two tiles ahead of the products, one barrier a tile. Per tile, a warp:
//   S = Q K^T on m16n8k16 (K fragments by ldmatrix), fp32, in registers;
//   subtract the anchor, clamp, ex2.approx, round to bf16 pairs: the C
//   fragments of two adjacent n8 tiles are the A fragment of P V, so P never
//   leaves the registers (the FA2 register reuse);
//   O += P V with V fragments by ldmatrix.trans, O in registers (5 or 10 n8
//   tiles for heads of 40 or 80).
// Each lane sums its rounded p in fp32 and the quad reduces once at the end;
// then O / l is written as bf16 into the head's slice. Any S: keys past S give
// p = 0 exactly, rows past S are not written. 16-byte alignment suffices.

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

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // query rows a block
constexpr int kBK = 64;               // keys a tile
constexpr int kStages = 3;            // K/V tiles in flight
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClamp = 100.f;

// Shared-memory plan for a head width HD: Q K^T runs over KS slices of 16
// channels (D = 16 KS columns, zero past HD); rows carry 8 bf16 of padding so
// that the 8 rows an ldmatrix reads fall on distinct banks (112- and 176-byte
// rows for heads of 40 and 80).
template <int HD>
struct Plan {
  static constexpr int KS = (HD + 15) / 16;
  static constexpr int D = 16 * KS;
  static constexpr int LD = D + 8;
  static constexpr int NT = HD / 8;                    // n8 tiles of the output
  static constexpr int tile = kBK * LD;                // elements of one K or V tile
  static constexpr int q = kBlockQ * LD * 2;           // Q, bf16
  static constexpr int kv = kStages * 2 * tile * 2;    // [stage][K, V][kBK][LD], bf16
  static constexpr int bytes = q + kv + kBlockQ * 4;   // + the rows' anchors, fp32
  static_assert(HD % 8 == 0 && (LD * 2) % 16 == 0, "16-byte chunks and ldmatrix rows");
};

// The block's Q tile: rows [q0, q0 + 128) of the head at q_bh (row stride ld),
// scaled and rounded to bf16 in columns [0, HD), zero in [HD, D) and in rows
// past seq; the anchors bf16(sum q' q) of the rows into off_s. Two lanes a
// row, eight channels (one 16-byte load) at a time. Ends with a barrier.
template <int HD>
__device__ __forceinline__ void prepare_q(bf16* q_s, float* off_s, const bf16* q_bh, int q0,
                                          int seq, int ld, float scale_log2) {
  using L = Plan<HD>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 2, half = lane % 2;
  const bool live = q0 + row < seq;
  const bf16* src = q_bh + static_cast<size_t>(q0 + row) * ld;
  bf16* dst = q_s + row * L::LD;
  float off = 0.f;
#pragma unroll
  for (int c = half * 8; c < L::D; c += 16) {
    __align__(16) bf16 out[8];
    *reinterpret_cast<uint4*>(out) = make_uint4(0u, 0u, 0u, 0u);
    if (live && c < HD) {
      __align__(16) bf16 in[8];
      *reinterpret_cast<uint4*>(in) = *reinterpret_cast<const uint4*>(src + c);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float raw = __bfloat162float(in[e]);
        const float scaled = raw * scale_log2;
        off += scaled * raw;
        out[e] = __float2bfloat16(scaled);
      }
    }
    *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(out);
  }
  off += __shfl_xor_sync(0xffffffffu, off, 1);
  if (half == 0) off_s[row] = __bfloat162float(__float2bfloat16(off));
  __syncthreads();
}

// Keys [row0, row0 + kBK) of K and V (the head's HD channels, row stride ld)
// -> one stage (K tile, then V tile, row stride LD) by cp.async; rows past
// seq are zero-filled.
template <int HD>
__device__ __forceinline__ void load_kv(bf16* stage, const bf16* k_bh, const bf16* v_bh, int row0,
                                        int seq, int ld) {
  using L = Plan<HD>;
  constexpr int kChunks = HD / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < 2 * kBK * kChunks; i += kThreads) {
    const int which = i / (kBK * kChunks), rem = i % (kBK * kChunks);
    const int r = rem / kChunks, c = (rem % kChunks) * 8;
    const bf16* src = which ? v_bh : k_bh;
    const bool ok = row0 + r < seq;
    cp_async16(stage + which * L::tile + r * L::LD + c,
               ok ? src + static_cast<size_t>(row0 + r) * ld + c : src, ok);
  }
}

__device__ __forceinline__ float clamp_exp2(float s) {
  return ex2(fminf(fmaxf(s, -kClamp), kClamp));
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fullc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, int seq, int heads, int ld,
                   float scale_log2) {
  using L = Plan<HD>;
  constexpr int KS = L::KS, LD = L::LD, NT = L::NT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = reinterpret_cast<bf16*>(smem + L::q);
  float* off_s = reinterpret_cast<float*>(smem + L::q + L::kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = (lane % 4) * 2;

  const int q0 = blockIdx.x * kBlockQ;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const size_t head = static_cast<size_t>(b) * seq * ld + h * HD;
  const bf16* k_bh = k + head;
  const bf16* v_bh = v + head;
  const int tiles = (seq + kBK - 1) / kBK;

  // the copies fill columns [0, HD) only: a head of 40 has its pad columns
  // 40-47 zeroed here once (they meet Q's zeros in Q K^T; 0 x garbage could
  // be NaN)
  if constexpr (L::D > HD) {
    for (int r = threadIdx.x; r < kStages * 2 * kBK; r += kThreads)
      *reinterpret_cast<uint4*>(kv_s + r * LD + HD) = make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load_kv<HD>(kv_s + s * 2 * L::tile, k_bh, v_bh, s * kBK, seq, ld);
    cp_async_commit();
  }
  prepare_q<HD>(q_s, off_s, q + head, q0, seq, ld, scale_log2);  // ends with a barrier

  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qa[kk], smem_addr(q_s + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8));
  const float off0 = off_s[warp * 16 + g], off1 = off_s[warp * 16 + g + 8];

  float oacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;  // this lane's share of the row sums of rows g, g + 8

  // ldmatrix row offsets of this lane: K tiles (two n8 tiles of keys x 16
  // channels) and V tiles (16 keys x two n8 tiles of channels, transposed)
  const int k_row = (lane % 8) + (lane / 16) * 8, k_col = ((lane / 8) % 2) * 8;
  const int v_row = (lane % 8) + ((lane / 8) % 2) * 8, v_col = (lane / 16) * 8;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();               // ... for every thread; tile t - 1's stage is free
    {
      const int next = t + kStages - 1;
      if (next < tiles)
        load_kv<HD>(kv_s + (next % kStages) * 2 * L::tile, k_bh, v_bh, next * kBK, seq, ld);
      cp_async_commit();
    }
    const bf16* kt = kv_s + (t % kStages) * 2 * L::tile;
    const bf16* vt = kt + L::tile;

    // S = Q K^T: 16 rows x 64 keys, eight n8 tiles
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kb[4];
        ldsm_x4(kb, smem_addr(kt + (j * 16 + k_row) * LD + kk * 16 + k_col));
        mma_bf16(s[2 * j], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * j + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // p and O += P V, 16 keys at a time
    const int valid = seq - t * kBK;  // real keys in this tile (>= kBK: all)
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* c = s[2 * j + half];
        float p0 = clamp_exp2(c[0] - off0), p1 = clamp_exp2(c[1] - off0);
        float p2 = clamp_exp2(c[2] - off1), p3 = clamp_exp2(c[3] - off1);
        if (valid < kBK) {  // the ragged last tile
          const int key = j * 16 + half * 8 + c2;
          if (key >= valid) p0 = p2 = 0.f;
          if (key + 1 >= valid) p1 = p3 = 0.f;
        }
        const uint32_t r0 = pack_bf16(p0, p1), r1 = pack_bf16(p2, p3);
        l0 += bf16_lo(r0) + bf16_hi(r0);
        l1 += bf16_lo(r1) + bf16_hi(r1);
        pa[2 * half] = r0;
        pa[2 * half + 1] = r1;
      }
      const bf16* vj = vt + j * 16 * LD;
#pragma unroll
      for (int n = 0; n + 1 < NT; n += 2) {
        uint32_t vb[4];
        ldsm_x4_t(vb, smem_addr(vj + v_row * LD + n * 8 + v_col));
        mma_bf16(oacc[n], pa, vb[0], vb[1]);
        mma_bf16(oacc[n + 1], pa, vb[2], vb[3]);
      }
      if constexpr (NT % 2) {
        uint32_t vb0, vb1;
        ldsm_x2_t(vb0, vb1, smem_addr(vj + v_row * LD + (NT - 1) * 8));
        mma_bf16(oacc[NT - 1], pa, vb0, vb1);
      }
    }
  }
  cp_async_wait<0>();

  // the quad's four lanes hold the row sums' parts
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  bf16* o0 = o + head + static_cast<size_t>(row0) * ld + c2;
  bf16* o1 = o0 + static_cast<size_t>(8) * ld;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (row0 < seq)
      *reinterpret_cast<__nv_bfloat162*>(o0 + n * 8) =
          __floats2bfloat162_rn(oacc[n][0] * inv0, oacc[n][1] * inv0);
    if (row1 < seq)
      *reinterpret_cast<__nv_bfloat162*>(o1 + n * 8) =
          __floats2bfloat162_rn(oacc[n][2] * inv1, oacc[n][3] * inv1);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int seq,
                   int heads, cudaStream_t stream) {
  auto kern = flash_fullc_kernel<HD>;
  constexpr int smem = Plan<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, batch * heads);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), seq, heads, heads * HD, kLog2e / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: (batch, seq, heads * hd) bf16, contiguous, 16-byte aligned,
// hd 40 or 80; any seq >= 1.
int md_flash_fullc(const void* q, const void* k, const void* v, void* o, int batch, int seq,
                   int heads, int hd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq < 1) return cudaErrorInvalidValue;
  switch (hd) {
    case 40: return launch<40>(q, k, v, o, batch, seq, heads, s);
    case 80: return launch<80>(q, k, v, o, batch, seq, heads, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
