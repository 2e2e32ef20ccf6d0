// Flash attention for heads of width 512, hand-written for Hopper (sm_90a).
// One kernel, two entry points, each its own instantiation (a kernel tag in
// the template arguments, so that a profile tells them apart):
//
//   K4 md_flash_wide      replaces mikudance_tpu/kernels/flash_attention.py
//      _flash_kernel (:44), the streamed branch of flash_attention_padded
//      (:677): the VAE mid-block's attention, one head of 512 over S = 9216
//      at 768^2 (5184 at 576^2, 16384 at 1024^2), where one head's K and V
//      pass the 6 MB that the TPU kernel keeps resident.
//   K9 md_flash_resident  replaces _flash_kernel_resident (:85), the branch
//      of flash_attention_padded taken while one head's K and V stay under
//      those 6 MB (S <= 3072: the VAE mid-block below 512^2). The two TPU
//      kernels compute one function and differ only in whether K and V stay
//      in VMEM; here every block streams key tiles from L2 at any S, so K9 is
//      K4's kernel under its own counter.
//
// The TPU kernels' function: the exact online softmax,
//     s = q . k * scale            fp32 (bf16 products)
//     m = running row maximum, p = exp(s - m) in fp32, l = sum p in fp32
//     O = O * exp(m_old - m) + bf16(p) . v, fp32;  o = O / l
// here in base 2 with log2(e) folded into the scale.
//
// What bounds it on the card: 4 B S^2 512 flops (1.39 TFLOP, 1.41 ms at the
// bf16 tensor peak for (8, 9216, 512); 0.089 ms for (8, 2304, 512)) against
// S 512 bytes a tensor. A 64-row
// block walks all keys, so every block streams the head's K and V (18.9 MB at
// S = 9216) from L2: 21.7 GB for the call, near 4 ms at L2's rate, which
// with shared memory's rate for the operands sets this design's floor.
//
// Design. A block of 16 warps owns 64 query rows and all 512 output columns,
// so Q K^T runs once for each (query block, key tile). The 64 x 512 fp32
// accumulator is 64 registers a thread: warp w holds output columns
// [32 w, 32 w + 32) of all 64 rows. Per tile of 64 keys:
//   S = Q K^T on mma.sync m16n8k16: warp w takes rows 16 (w % 4).. and keys
//     16 (w / 4).. over the full depth of 512 (Q and K by ldmatrix from shared
//     memory); the scaled scores meet in shared memory (64 x 64 fp32) only
//     for the row maximum;
//   softmax: eight lanes a row take the new maximum, the rescale factor and
//     p, sum p in fp32 and write bf16 p (64 x 64) and the factor;
//   O = O * factor + P V: P by ldmatrix, V by ldmatrix.trans, in registers.
// Q (64 x 512) stays in shared memory; K and V tiles (64 x 512 each) go
// through one slot each, filled by cp.async one phase ahead: V_t lands while
// S_t is computed, K_{t+1} while the softmax and P V of tile t run. 227,840
// bytes of shared memory, one block an SM. Any S: keys past S are masked to
// p = 0, rows past S are not written.

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

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 64;      // query rows a block
constexpr int kBK = 64;          // keys a tile
constexpr int kHD = 512;         // head width
constexpr int kLD = kHD + 8;     // bf16 row stride of Q, K, V: 8 ldmatrix rows on distinct banks
constexpr int kLDS = kBK + 8;    // fp32 row stride of the scores
constexpr int kLDP = kBK + 8;    // bf16 row stride of p
constexpr int kColsW = kHD / kWarps;  // output columns a warp: 32
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kQBytes = kBlockQ * kLD * 2;
constexpr int kTileBytes = kBK * kLD * 2;
constexpr int kSBytes = kBlockQ * kLDS * 4;
constexpr int kPBytes = kBlockQ * kLDP * 2;
constexpr int kSmem = kQBytes + 2 * kTileBytes + kSBytes + kPBytes + 2 * kBlockQ * 4;
static_assert(kSmem <= 232448, "one block's shared memory");

// rows [row0, row0 + ROWS) of a head (row stride ld) -> shared memory (row
// stride kLD) by cp.async; rows past seq are zero-filled.
template <int ROWS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int row0, int seq, int ld) {
  constexpr int kChunks = kHD / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = row0 + r < seq;
    cp_async16(dst + r * kLD + c, ok ? src + static_cast<size_t>(row0 + r) * ld + c : src, ok);
  }
}

// kTag: the kernel number (4, 9), so that each entry point has a device symbol
// of its own
template <int kTag>
__global__ void __launch_bounds__(kThreads, 1)
flash_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int seq, int heads, int ld,
                  float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = reinterpret_cast<bf16*>(smem + kQBytes);
  bf16* v_s = reinterpret_cast<bf16*>(smem + kQBytes + kTileBytes);
  float* s_s = reinterpret_cast<float*>(smem + kQBytes + 2 * kTileBytes);
  bf16* p_s = reinterpret_cast<bf16*>(smem + kQBytes + 2 * kTileBytes + kSBytes);
  float* corr_s = reinterpret_cast<float*>(smem + kQBytes + 2 * kTileBytes + kSBytes + kPBytes);
  float* l_s = corr_s + kBlockQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = (lane % 4) * 2;
  const int q0 = blockIdx.x * kBlockQ;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const size_t head = static_cast<size_t>(b) * seq * ld + h * kHD;
  const bf16* k_bh = k + head;
  const bf16* v_bh = v + head;
  const int tiles = (seq + kBK - 1) / kBK;

  stage_rows<kBlockQ>(q_s, q + head, q0, seq, ld);
  stage_rows<kBK>(k_s, k_bh, 0, seq, ld);
  cp_async_commit();

  // the softmax's ownership: eight lanes a row, eight keys each
  const int srow = threadIdx.x / 8, part = threadIdx.x % 8;
  float m = -INFINITY, l = 0.f;
  // S's: rows 16 (warp % 4).., keys 16 (warp / 4)..
  const int s_row = (warp % 4) * 16, s_key = (warp / 4) * 16;
  // ldmatrix row offsets of this lane (A / K / V^T fragments, see mma_sync.cuh)
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int k_row = (lane % 8) + (lane / 16) * 8, k_col = ((lane / 8) % 2) * 8;
  const int v_row = (lane % 8) + ((lane / 8) % 2) * 8, v_col = (lane / 16) * 8;
  const int col0 = warp * kColsW;

  float oacc[kBlockQ / 16][kColsW / 8][4];
#pragma unroll
  for (int mt = 0; mt < kBlockQ / 16; ++mt)
#pragma unroll
    for (int n = 0; n < kColsW / 8; ++n) oacc[mt][n][0] = oacc[mt][n][1] = oacc[mt][n][2] =
        oacc[mt][n][3] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();  // K_t (and Q) have landed
    __syncthreads();     // ... for every thread; P V of tile t - 1 is done with V, P and corr
    stage_rows<kBK>(v_s, v_bh, t * kBK, seq, ld);
    cp_async_commit();

    {  // S = Q K^T * scale for this warp's 16 x 16
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const bf16* qa_p = q_s + (s_row + a_row) * kLD + a_col;
      const bf16* kb_p = k_s + (s_key + k_row) * kLD + k_col;
#pragma unroll 8
      for (int kk = 0; kk < kHD / 16; ++kk) {
        uint32_t qa[4], kb[4];
        ldsm_x4(qa, smem_addr(qa_p + kk * 16));
        ldsm_x4(kb, smem_addr(kb_p + kk * 16));
        mma_bf16(acc[0], qa, kb[0], kb[1]);
        mma_bf16(acc[1], qa, kb[2], kb[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float* dst = s_s + (s_row + g) * kLDS + s_key + n * 8 + c2;
        *reinterpret_cast<float2*>(dst) = make_float2(acc[n][0] * scale_log2, acc[n][1] * scale_log2);
        *reinterpret_cast<float2*>(dst + 8 * kLDS) =
            make_float2(acc[n][2] * scale_log2, acc[n][3] * scale_log2);
      }
    }
    __syncthreads();  // the scores are complete; K's slot is free
    if (t + 1 < tiles) stage_rows<kBK>(k_s, k_bh, (t + 1) * kBK, seq, ld);
    cp_async_commit();

    {  // online softmax in base 2 for row srow, keys part * 8 ..
      const float* src = s_s + srow * kLDS + part * 8;
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      const int valid = seq - t * kBK - part * 8;  // real keys among this lane's eight
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e >= valid) x[e] = -INFINITY;
      float mx = x[0];
#pragma unroll
      for (int e = 1; e < 8; ++e) mx = fmaxf(mx, x[e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m, mx);  // finite: every tile holds a real key
      const float corr = ex2(m - m_new);  // 0 on the first tile
      float sum = 0.f;
      uint32_t pk[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const float p0 = ex2(x[e] - m_new), p1 = ex2(x[e + 1] - m_new);
        sum += p0 + p1;
        pk[e / 2] = pack_bf16(p0, p1);
      }
      *reinterpret_cast<uint4*>(p_s + srow * kLDP + part * 8) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l = l * corr + sum;
      m = m_new;
      if (part == 0) corr_s[srow] = corr;
    }
    cp_async_wait<1>();  // V_t has landed (K_{t+1} may still be in flight)
    __syncthreads();     // p, the factors and V_t are visible

    // O = O * factor + P V on this warp's 32 columns
#pragma unroll
    for (int mt = 0; mt < kBlockQ / 16; ++mt) {
      const float f0 = corr_s[mt * 16 + g], f1 = corr_s[mt * 16 + g + 8];
#pragma unroll
      for (int n = 0; n < kColsW / 8; ++n) {
        oacc[mt][n][0] *= f0;
        oacc[mt][n][1] *= f0;
        oacc[mt][n][2] *= f1;
        oacc[mt][n][3] *= f1;
      }
    }
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t vb[kColsW / 16][4];
#pragma unroll
      for (int n = 0; n < kColsW / 16; ++n)
        ldsm_x4_t(vb[n], smem_addr(v_s + (j * 16 + v_row) * kLD + col0 + n * 16 + v_col));
#pragma unroll
      for (int mt = 0; mt < kBlockQ / 16; ++mt) {
        uint32_t pa[4];
        ldsm_x4(pa, smem_addr(p_s + (mt * 16 + a_row) * kLDP + j * 16 + a_col));
#pragma unroll
        for (int n = 0; n < kColsW / 16; ++n) {
          mma_bf16(oacc[mt][2 * n], pa, vb[n][0], vb[n][1]);
          mma_bf16(oacc[mt][2 * n + 1], pa, vb[n][2], vb[n][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (part == 0) l_s[srow] = l;
  __syncthreads();
  bf16* o_bh = o + head + col0 + c2;
#pragma unroll
  for (int mt = 0; mt < kBlockQ / 16; ++mt) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    const float inv0 = 1.f / l_s[r0], inv1 = 1.f / l_s[r1];
#pragma unroll
    for (int n = 0; n < kColsW / 8; ++n) {
      if (q0 + r0 < seq)
        *reinterpret_cast<__nv_bfloat162*>(o_bh + static_cast<size_t>(q0 + r0) * ld + n * 8) =
            __floats2bfloat162_rn(oacc[mt][n][0] * inv0, oacc[mt][n][1] * inv0);
      if (q0 + r1 < seq)
        *reinterpret_cast<__nv_bfloat162*>(o_bh + static_cast<size_t>(q0 + r1) * ld + n * 8) =
            __floats2bfloat162_rn(oacc[mt][n][2] * inv1, oacc[mt][n][3] * inv1);
    }
  }
}

template <int kTag>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int seq, int heads,
           int hd, void* stream) {
  if (hd != kHD || seq < 1) return cudaErrorInvalidValue;
  auto kern = flash_wide_kernel<kTag>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, batch * heads);
  kern<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), seq, heads, heads * kHD, kLog2e / sqrtf(static_cast<float>(kHD)));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: (batch, seq, heads * 512) bf16, contiguous, 16-byte aligned
// (cp.async's rule); any seq >= 1.
int md_flash_wide(const void* q, const void* k, const void* v, void* o, int batch, int seq,
                  int heads, int hd, void* stream) {
  return launch<4>(q, k, v, o, batch, seq, heads, hd, stream);
}

// the same, K9's counter and symbol
int md_flash_resident(const void* q, const void* k, const void* v, void* o, int batch, int seq,
                      int heads, int hd, void* stream) {
  return launch<9>(q, k, v, o, batch, seq, heads, hd, stream);
}

}  // extern "C"
