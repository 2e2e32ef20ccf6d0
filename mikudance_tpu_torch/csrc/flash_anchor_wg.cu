// Anchored packed-heads self-attention on Hopper's warpgroup tensor cores
// (wgmma) with K and V fed by the Tensor Memory Accelerator (TMA),
// hand-written for sm_90a. One kernel, four entry points, each its own
// instantiation (a kernel tag in the template arguments, so that a profile
// tells them apart):
//
//   K1  md_flash_fullc            replaces mikudance_tpu/kernels/flash_attention.py
//       _flash_kernel_fullc_nt (:485, entry flash_attention_fullc_nt :546): the
//       route of the UNet's spatial self-attention under the default switches
//       (8 heads of 40 at S = 9216, of 80 at 2304, of 160 at 1024 for 1024^2).
//       Its function is K12's (the anchor rounded to bf16; the JAX package
//       calls the two TPU kernels bit-identical), so it is K12's code under
//       its own symbol and counter.
//   K10 md_flash_anchor_resident  replaces
//       _flash_kernel_fullc_resident (:158), the branch of flash_attention_fullc
//       (:278) taken while a batch element's K and V stay under its byte limit
//       (the 2304-token UNet level, 8 heads of 80; the 1296-token level of
//       576^2 training in the transposed configuration).
//   K11 md_flash_anchor_stream    replaces _flash_kernel_fullc_stream (:209),
//       the same function above the byte limit (the 9216-token level, 8 heads
//       of 40). The limit is the TPU's VMEM: here the TMA ring streams key
//       tiles of any S, so K11 is K10's kernel under its own counter.
//   K12 md_flash_fullc_t          replaces _flash_kernel_fullc_t (:357, entry
//       flash_attention_fullc_t :436): the function with the anchor rounded to
//       bf16 (the TPU kernel folds bf16(-off) into Q K^T as one more column),
//       the transposed configuration's level above the byte limit (5184
//       tokens of 576^2 training).
//
// Per head of (B, S, C) bf16 tensors with the heads packed in C:
//     q'  = q * (log2(e) / sqrt(hd))              fp32
//     off = sum_d q'_d q_d                        fp32, not rounded (K1, K12: bf16(off))
//     s   = bf16(q') . k                          fp32 accumulation
//     p   = bf16(exp2(clip(s - off, -100, 100)))
//     o   = (sum_j p_j v_j) / (sum_j p_j)         both sums in fp32 over bf16 p
// as the TPU kernels; there is no running maximum and so no rescale.
//
// What bounds it on the card. At a head of 80 the tensor cores: at
// (32, 2304, 640) the 4 B S^2 C flops take 0.440 ms at the bf16 peak, the
// S^2 B heads exponentials 0.325 ms on the special-function units; bytes are
// far below either. At a head of 40 three floors of about the same height:
// the tensor cores (~4.2 ms at (32, 9216, 320), 48 padded columns), the
// exponentials (5.2 ms: one ex2 a score, 16 a clock an SM) and instruction
// issue (~4 ms: subtraction, two-sided clamp, ex2, half a pack, and the row
// sum a score). At a head of 160 the tensor cores again: at (32, 1024, 1280)
// the flops take 0.174 ms, the exponentials 0.064 ms. mma.sync does not
// reach the tensor cores' full rate on Hopper; warpgroup MMA does.
//
// Design (FA3's shape). A block owns 64 query rows a consumer warpgroup of
// one (batch, head), plus a producer.
//   Q: each consumer thread loads its rows' pairs straight into the
//   registers of wgmma's A fragment (the mma.sync m16n8k16 layout, one warp
//   16 rows), scaled in fp32 and rounded to bf16; its share of each row's
//   fp32 anchor comes from the same unrounded values, the quad reduces.
//   K and V: tiles of 128 keys arrive by TMA in a ring of four stages (two at
//   hd 160) with full / empty mbarriers. A tile is KS boxes of 128 keys x 16
//   channels (KS = 10 at hd 160, 5 at hd 80; 3 at hd 40, padded to 48),
//   32-byte swizzled, read from a 3-D (C, S, B) tensor map at the head's
//   channel offset, so rows past S and channels past C arrive as zeros, never
//   as the next batch element's.
//   A box of K is the K-major B operand of one k16 step of Q K^T; the boxes
//   of V side by side are the N-major (transposed) B operand of P V.
//   S = Q K^T: wgmma m64n128k16, A from registers, fp32 in registers. Then in
//   registers: subtract the anchor, clamp, ex2.approx, round to bf16 pairs.
//   The accumulator layout of S is the A-fragment layout of P: O += P V is
//   wgmma m64n160k16 (hd 160), m64n80k16 (hd 80) or m64n56k16 (hd 40) with P
//   as the register A operand and O in registers. Each product is waited
//   for before its result is used; the consumer warpgroups run
//   unsynchronised, so one's exponentials can overlap the others' products.
//   Heads of 80: two consumer warpgroups and a producer warp (288 threads),
//   l summed from the packed p. (Timed on the H100 and left out: tiles of 64
//   keys; S of the next tile issued before this tile's exponentials; FA3's
//   ping-pong of the two warpgroups.)
//   Heads of 160 (SD1.5's level 2, 1024 tokens at 1024^2): two consumer
//   warpgroups, the anchor subtracted and l summed in registers as at hd 80
//   (160 is ten whole k16 steps: no pad column for a ones lane). A stage of
//   K and V is 80 KB, so two stages fit the 227 KB a block may have. S (64
//   fp32 a thread), O (m64n160: 80), Q's A fragments (40) and P (32) need
//   more than the 168 registers a thread gets when nine warps share an SM's
//   four quadrants (ptxas spilled there), so the producer is a warpgroup that
//   hands its registers to the consumers (setmaxnreg: 240). (Timed on the
//   H100 and left out: tiles of 64 keys in four stages of 40 KB, slower at
//   each of four shapes.)
//   Heads of 40, shaped by the three floors (each move timed on the H100,
//   PERF.md):
//   - The row sum rides P V, as the TPU kernel's fuse_ones does at this
//     width: each stage holds, after its V boxes, a box of ones written once
//     per block (every element 1, so the swizzle does not matter), which P V
//     reads as columns 48-55 of an n56 product. l arrives in the accumulator
//     as the fp32 sum of the bf16 p: no unpacks and adds a score.
//   - The anchor rides Q K^T: one more k16 step multiplies the ones box by an
//     A fragment holding -off in a row's first columns, as three bf16 parts
//     (hi, mid, lo) whose sum is the fp32 anchor (K12: bf16(-off) alone, the
//     TPU K12's own folding). s - off leaves the tensor cores: no
//     subtraction a score.
//   - Three consumer warpgroups (192 query rows a block) and a producer
//     warpgroup: 512 threads start at 128 registers (a block's warps spread
//     over the SM's four quadrants of 16,384), the producer drops to 24 with
//     setmaxnreg and the consumers take 160, so that while one warpgroup
//     waits on its product two others keep the special-function units busy.
//   (Timed and left out at hd 40: the row sum as an n8 product of its own;
//   three consumers with a producer warp, which holds a thread to 128
//   registers and spills; S of the next tile issued early, which spills at
//   160 registers and, with two consumers at 240, stays behind three; S in
//   halves of 64 keys.)
//   End: O / l as bf16 leaves through a per-warp staging tile in 16-byte
//   stores of the head's columns. Keys past S get p = 0 exactly; rows past S
//   are not written.
// Alignment is TMA's: 16-byte base and row stride (C a multiple of 8).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"
#include "tma_wgmma.cuh"

using namespace md_mma;
using namespace md_tma;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kBK = 128;          // keys a tile
constexpr int kBox = kBK * 32;    // bytes of a box: 128 keys x 16 channels
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClamp = 100.f;

// The instantiation of a head width (the design notes above) and its
// shared-memory plan. Heads of 40 take the three moves together: three
// consumer warpgroups, the row sum and the anchor on the tensor cores against
// a box of ones, a producer warpgroup that hands its registers to the
// consumers; heads of 80 keep two consumers and a producer warp; heads of
// 160 two consumers and a producer warpgroup. A stage holds KS boxes of K, KS
// of V (16 KS channels, zero or ignored past HD) and, with the ones, a box of
// ones; four stages, two where four do not fit (hd 160); then an output
// staging tile of 16 rows a consumer warp (rows padded by 8 bf16 against bank
// conflicts); the barriers.
template <int HD>
struct Plan {
  static constexpr bool ones = HD == 40;
  static constexpr bool producer_wg = ones || HD == 160;
  static constexpr int consumers = ones ? 3 : 2;    // warpgroups of 64 query rows
  // Registers are allocated per SM quadrant (16,384 each, one warp of every
  // warpgroup on each). With a producer warpgroup each of the consumers + 1
  // warps of a quadrant starts with launch_regs (what __launch_bounds__
  // allows, which ptxas takes when setmaxnreg is used); the producer drops to
  // 24 and the consumers take what that frees, rounded down to 8.
  static constexpr int threads = 128 * consumers + (producer_wg ? 128 : 32);
  static constexpr int producer_regs = 24;
  static constexpr int launch_regs = 512 / (consumers + 1) / 8 * 8;
  static constexpr int consumer_regs =
      ((consumers + 1) * launch_regs - producer_regs) / consumers / 8 * 8;
  static constexpr int block_q = 64 * consumers;          // query rows a block
  static constexpr int KS = (HD + 15) / 16;
  static constexpr int KA = KS + (ones ? 1 : 0);          // A fragments of Q K^T
  static constexpr int NV = 16 * KS;                      // V columns P V reads
  static constexpr int NO = NV + (ones ? 8 : 0);          // columns of P V
  static constexpr int LDO = NV + 8;
  static constexpr int tx = 2 * KS * kBox;                // bytes TMA brings a stage
  static constexpr int stage = tx + (ones ? kBox : 0);    // K, V and ones boxes
  static constexpr int out = consumers * 4 * 16 * LDO * 2;
  static constexpr int stages = 1024 + 4 * stage + out + 64 <= 232448 ? 4 : 2;
  static constexpr int bars = 2 * stages * 8;             // full, empty
  static constexpr int bytes = 1024 + stages * stage + out + bars;  // + alignment slack
  static_assert(HD % 8 == 0, "16-byte rows");
  static_assert(bytes <= 232448, "one block's shared memory");
};

// d (64 x 56, fp32) = A (64 x 16, bf16, registers) B (16 x 56, bf16, a shared-memory
// descriptor) + (accumulate ? d : 0); kTransB 1: B is N-major
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n56k16(float (&d)[28], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27"
      "}, {%28, %29, %30, %31}, %32, p, 1, 1, %34;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}

// d += A B on the width of P V: n160 at hd 160, n80 at hd 80, n56 at hd 40
// (48 V columns, 8 of ones)
template <int NO>
__device__ __forceinline__ void wgmma_out(float (&d)[NO / 2], const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  if constexpr (NO == 160) wgmma_m64n160k16<1>(d, a, desc_b, 1);
  else if constexpr (NO == 80) wgmma_m64n80k16<1>(d, a, desc_b, 1);
  else wgmma_m64n56k16<1>(d, a, desc_b, 1);
}

// What a consumer's tile update reads besides its registers.
struct Tiles {
  uint32_t base, full0, empty0;  // the ring and its barriers (shared addresses)
  int seq;
  float off0, off1;  // this lane's rows' anchors (0 where the anchor rides Q K^T)
};

// Key tile t of a consumer warpgroup: S = Q K^T, p = bf16(exp2(clip(s -
// off))) as the A fragments of P V, O += P V, the stage handed back. With the
// ones, S takes one more k16 step of -off (qa[KS]) against the ones box and P V
// sums l into its last 8 columns; without, l0 / l1 gather this lane's share
// of the row sums.
template <int HD>
__device__ __forceinline__ void tile_update(const Tiles& tl, int t,
                                            const uint32_t (&qa)[Plan<HD>::KA][4],
                                            float (&oacc)[Plan<HD>::NO / 2], float& l0,
                                            float& l1) {
  using L = Plan<HD>;
  constexpr int kStages = L::stages;
  const int lane = threadIdx.x % 32, c2 = (lane % 4) * 2;
  const int s = t % kStages;
  const uint32_t kt = tl.base + s * L::stage, vt = kt + L::KS * kBox;
  // real keys in this tile (>= kBK: all). Where it is computed moves ptxas's
  // schedule: ahead of the barrier wait is faster at hd 40, after S at hd 80
  // (timed in turns on the H100, PERF.md).
  int valid;
  if constexpr (L::ones) valid = tl.seq - t * kBK;
  mbar_wait(tl.full0 + 8 * s, (t / kStages) & 1);

  // S: one k16 step a box; K-major B, 8-key groups 256 bytes apart
  float sacc[kBK / 2];  // the first step overwrites it
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::KS; ++kk)
    wgmma_m64n128k16<0>(sacc, qa[kk], desc32(kt + kk * kBox, 16, 256), kk > 0);
  if constexpr (L::ones) wgmma_m64n128k16<0>(sacc, qa[L::KS], desc32(kt + L::tx, 16, 256), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sacc);

  if constexpr (!L::ones) valid = tl.seq - t * kBK;
  uint32_t p[kBK / 16][4];
#pragma unroll
  for (int i = 0; i < kBK / 8; ++i) {
    float p0 = ex2(fminf(fmaxf(sacc[4 * i] - tl.off0, -kClamp), kClamp));
    float p1 = ex2(fminf(fmaxf(sacc[4 * i + 1] - tl.off0, -kClamp), kClamp));
    float p2 = ex2(fminf(fmaxf(sacc[4 * i + 2] - tl.off1, -kClamp), kClamp));
    float p3 = ex2(fminf(fmaxf(sacc[4 * i + 3] - tl.off1, -kClamp), kClamp));
    if (valid < kBK) {  // the ragged last tile
      const int key = i * 8 + c2;
      if (key >= valid) p0 = p2 = 0.f;
      if (key + 1 >= valid) p1 = p3 = 0.f;
    }
    const uint32_t r0 = pack_bf16(p0, p1), r1 = pack_bf16(p2, p3);
    if constexpr (!L::ones) {
      l0 += bf16_lo(r0) + bf16_hi(r0);
      l1 += bf16_lo(r1) + bf16_hi(r1);
    }
    p[i / 2][2 * (i % 2)] = r0;
    p[i / 2][2 * (i % 2) + 1] = r1;
  }

  // O += P V: one k16 step a 16 keys; N-major B (the V boxes side by side, a
  // box apart, then the ones box; 8-key groups 256 bytes apart)
  fence_regs(oacc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_out<L::NO>(oacc, p[kk], desc32(vt + kk * 512, kBox, 256));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(oacc);
  __syncwarp();
  if (lane == 0) mbar_arrive(tl.empty0 + 8 * s);  // this warp is done with the stage
}

// kTag: the kernel number (1, 10, 11, 12), so that each entry point has a
// device symbol of its own; K1 and K12 round the anchor to bf16.
template <int HD, int kTag>
__global__ void __launch_bounds__(Plan<HD>::threads, 1)
anchor_wg_kernel(const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const bf16* __restrict__ q,
                 bf16* __restrict__ o, int seq, int heads, float scale_log2) {
  using L = Plan<HD>;
  constexpr int KS = L::KS, NO = L::NO, LDO = L::LDO, kConsumers = L::consumers;
  constexpr int kStages = L::stages;
  constexpr bool kRoundAnchor = kTag == 1 || kTag == 12;
  extern __shared__ unsigned char smem_raw[];
  // TMA's swizzled boxes and wgmma's descriptors agree on 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* out_s = reinterpret_cast<bf16*>(smem + kStages * L::stage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * L::stage + L::out);
  const uint32_t tiles_u32 = smem_addr(smem);
  const uint32_t full0 = smem_addr(bars), empty0 = smem_addr(bars + kStages);

  const int q0 = blockIdx.x * L::block_q;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int ld = heads * HD;
  const int n_tiles = (seq + kBK - 1) / kBK;

  if constexpr (L::ones) {  // a box after each stage's V boxes, bf16 1.0 throughout
    for (int i = threadIdx.x; i < kStages * kBox / 16; i += L::threads)
      reinterpret_cast<uint4*>(smem + (i / (kBox / 16)) * L::stage + L::tx)[i % (kBox / 16)] =
          make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
    // the products read shared memory through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);                   // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 4 * kConsumers);     // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {  // the producer: one lane issues the copies
    if constexpr (L::producer_wg) setmaxnreg_dec<L::producer_regs>();
    if (threadIdx.x % (L::producer_wg ? 128 : 32) == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty0 + 8 * s, (t / kStages - 1) & 1);
        const uint32_t full = full0 + 8 * s, dst = tiles_u32 + s * L::stage;
        mbar_expect_tx(full, L::tx);
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          tma_load(dst + j * kBox, &tm_k, full, h * HD + 16 * j, t * kBK, b);
          tma_load(dst + (KS + j) * kBox, &tm_v, full, h * HD + 16 * j, t * kBK, b);
        }
      }
    }
    return;
  }

  // a consumer: warp w of warpgroup wg owns rows q0 + 64 wg + 16 w + [0, 16);
  // this lane rows g and g + 8 of them
  if constexpr (L::producer_wg) setmaxnreg_inc<L::consumer_regs>();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = (lane % 4) * 2;
  const int row0 = q0 + wg * 64 + warp * 16 + g, row1 = row0 + 8;
  const size_t batch = static_cast<size_t>(b) * seq * ld;

  // Q as the A fragments of Q K^T, and this lane's share of the anchors;
  // with the ones, qa[KS] is -off as the A fragment of the anchor's k16 step
  uint32_t qa[L::KA][4];
  float off0 = 0.f, off1 = 0.f;
  {
    const bf16* q_bh = q + batch + h * HD;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = kk * 16 + half * 8 + c2;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r ? row1 : row0;
          float x0 = 0.f, x1 = 0.f;
          if (col < HD && row < seq) {
            const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
                q_bh + static_cast<size_t>(row) * ld + col);
            x0 = __low2float(x);
            x1 = __high2float(x);
          }
          const float s0 = x0 * scale_log2, s1 = x1 * scale_log2;
          (r ? off1 : off0) += s0 * x0 + s1 * x1;
          qa[kk][2 * half + r] = pack_bf16(s0, s1);
        }
      }
    }
    off0 += __shfl_xor_sync(0xffffffffu, off0, 1);
    off0 += __shfl_xor_sync(0xffffffffu, off0, 2);
    off1 += __shfl_xor_sync(0xffffffffu, off1, 1);
    off1 += __shfl_xor_sync(0xffffffffu, off1, 2);
    if constexpr (kRoundAnchor) {
      off0 = __bfloat162float(__float2bfloat16_rn(off0));
      off1 = __bfloat162float(__float2bfloat16_rn(off1));
    }
    if constexpr (L::ones) {
      // -off in columns 0, 1 and 8 of its row (lane c = 0): bf16 parts hi +
      // mid + lo that sum to the fp32 anchor (K12's is one bf16 already)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float off = r ? off1 : off0;
        const float hi = __bfloat162float(__float2bfloat16_rn(off));
        const float mid = __bfloat162float(__float2bfloat16_rn(off - hi));
        qa[KS][r] = c2 == 0 ? pack_bf16(-hi, -mid) : 0u;
        qa[KS][2 + r] = c2 == 0 ? pack_bf16(-(off - hi - mid), 0.f) : 0u;
      }
      off0 = off1 = 0.f;
    }
  }

  float oacc[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) oacc[i] = 0.f;
  const Tiles tl{tiles_u32, full0, empty0, seq, off0, off1};
  float l0 = 0.f, l1 = 0.f;  // this lane's share of the row sums (without the ones)
  for (int t = 0; t < n_tiles; ++t) tile_update<HD>(tl, t, qa, oacc, l0, l1);

  // O / l -> bf16 through this warp's staging rows, then 16-byte stores
  if constexpr (L::ones) {  // every ones column holds the whole row sum
    l0 = oacc[NO / 2 - 4];
    l1 = oacc[NO / 2 - 2];
  } else {
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  bf16* o_w = out_s + (wg * 4 + warp) * 16 * LDO;
  constexpr int kChunks = HD / 8;
#pragma unroll
  for (int n = 0; n < kChunks; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(o_w + g * LDO + n * 8 + c2) =
        __floats2bfloat162_rn(oacc[4 * n] * inv0, oacc[4 * n + 1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(o_w + (g + 8) * LDO + n * 8 + c2) =
        __floats2bfloat162_rn(oacc[4 * n + 2] * inv1, oacc[4 * n + 3] * inv1);
  }
  __syncwarp();
  const int first = q0 + wg * 64 + warp * 16;
  bf16* o_bh = o + batch + h * HD;
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    if (first + r < seq)
      *reinterpret_cast<uint4*>(o_bh + static_cast<size_t>(first + r) * ld + c) =
          *reinterpret_cast<const uint4*>(o_w + r * LDO + c);
  }
}

// (C, S, B) bf16 at x: boxes of 16 channels x kBK rows, 32-byte swizzle,
// zeros out of bounds
bool tensor_map(CUtensorMap* map, const void* x, int batch, int seq, int channels) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(channels), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(channels) * 2,
                                 static_cast<cuuint64_t>(seq) * channels * 2};
  const cuuint32_t box[3] = {16, kBK, 1};
  return encode_bf16(map, x, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_32B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

template <int HD, int kTag>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int seq,
                   int heads, cudaStream_t stream) {
  using L = Plan<HD>;
  auto kern = anchor_wg_kernel<HD, kTag>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_k, tm_v;
  if (!tensor_map(&tm_k, k, batch, seq, heads * HD) ||
      !tensor_map(&tm_v, v, batch, seq, heads * HD))
    return cudaErrorInvalidValue;
  const dim3 grid((seq + L::block_q - 1) / L::block_q, batch * heads);
  kern<<<grid, L::threads, L::bytes, stream>>>(tm_k, tm_v, static_cast<const bf16*>(q),
                                               static_cast<bf16*>(o), seq, heads,
                                               kLog2e / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

template <int kTag>
int dispatch(const void* q, const void* k, const void* v, void* o, int batch, int seq, int heads,
             int hd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq < 1) return cudaErrorInvalidValue;
  switch (hd) {
    case 40: return launch<40, kTag>(q, k, v, o, batch, seq, heads, s);
    case 80: return launch<80, kTag>(q, k, v, o, batch, seq, heads, s);
    case 160: return launch<160, kTag>(q, k, v, o, batch, seq, heads, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, o: (batch, seq, heads * hd) bf16, contiguous, 16-byte aligned
// (TMA's rule for the base and the row stride), hd 40, 80 or 160, any head
// count, any seq >= 1. The anchor rounded to bf16 (anchored_attention_t): K1's
// counter and symbol.
int md_flash_fullc(const void* q, const void* k, const void* v, void* o, int batch, int seq,
                   int heads, int hd, void* stream) {
  return dispatch<1>(q, k, v, o, batch, seq, heads, hd, stream);
}

// the same with the anchor in fp32 (anchored_attention): K10's
int md_flash_anchor_resident(const void* q, const void* k, const void* v, void* o, int batch,
                             int seq, int heads, int hd, void* stream) {
  return dispatch<10>(q, k, v, o, batch, seq, heads, hd, stream);
}

// the same, K11's counter and symbol
int md_flash_anchor_stream(const void* q, const void* k, const void* v, void* o, int batch,
                           int seq, int heads, int hd, void* stream) {
  return dispatch<11>(q, k, v, o, batch, seq, heads, hd, stream);
}

// K1's function, K12's counter and symbol
int md_flash_fullc_t(const void* q, const void* k, const void* v, void* o, int batch, int seq,
                     int heads, int hd, void* stream) {
  return dispatch<12>(q, k, v, o, batch, seq, heads, hd, stream);
}

}  // extern "C"
