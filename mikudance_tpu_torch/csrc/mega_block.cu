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
//       bf16 after the bank add, q * scale rounded to bf16, the dense softmax
//       (the true row maximum) normalised in fp32 before the bf16 cast, the
//       tanh GELU.
//
// What bounds it on the card: operations. At (32, 2304, 640) the products
// are 1.09 TFLOP and attention 0.48 (1.1 ms and 0.5 ms at the bf16 peak);
// the block's bytes, read once, take under 0.2 ms. So every product and both
// attentions run on the warpgroup tensor cores (wgmma), fed by TMA.
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
// next; each projection is computed once. The chunk is the wrapper's plan
// (kernels/_mega_plan.py): the largest its scratch limit allows, which at
// the probe's levels is the whole batch (ten barriers; on the card, larger
// chunks ran faster at every level than chunks that keep the scratch in L2).
//
// Threads: gemm_wg.cuh's three warpgroups, two consumers and a producer
// that hands its registers to them (setmaxnreg) once, at the start; each
// role then runs its own copy of the phase loop.
//   Products: the core's k loop (produce_tile / consume_tile): a ring of six
//   36 KB stages of one A box (128 rows x 64 k) and 160 rows of an nn.Linear
//   (out, in) weight, the K-major operand as it lies; wgmma m64n160k16 from
//   shared memory. The ring's position runs on from tile to tile and phase
//   to phase, so the producer loads the next tile while the consumers run
//   this one's epilogue, straight from the accumulator registers: q; k and v
//   with the bank added before the bf16 rounding; the fp32 residual stream;
//   GEGLU; + b2 and the bf16 output. GEGLU's tile is 80 hidden and the 80
//   matching gate columns, FF apart in w1: A is read once, and hidden and
//   gate meet in one accumulator.
//   Registers: one kernel holds every phase, and ptxas allocates its
//   consumers' code about as if each thread had the launch's 168 (165 at
//   heads of 40 and 80), setmaxnreg notwithstanding. Where a phase needs
//   more, it spills, or serialises the products (a wait after each wgmma):
//   tiles of 320 (160 accumulators a thread), GEGLU as two 80-wide products
//   beside the 160-wide ones, 128-key scores, and O of 160 columns beside
//   Q's 40 registers each slowed the whole kernel (timed on the card,
//   PERF.md §6). Hence 80 accumulators a thread in every product (GEGLU's
//   hidden and gate are one 160-row B operand: two boxes of 80 rows loaded
//   one after the other), 64-key scores, and O in halves.
//   Attention (flash_anchor_wg.cu's operand design): a consumer warpgroup
//   holds q * scale of 64 query rows as the A fragments of Q K^T; K and V
//   arrive by TMA in 128-key x 16-channel boxes, 32-byte swizzled, the
//   K-major B of Q K^T and side by side the N-major B of P V. Scores stay in
//   registers, 64 keys a product, and pack straight into P. The TPU kernel
//   normalises before it rounds p, so p needs the row's true maximum and sum
//   before P V: both attentions take two passes over the keys (pass 1: Q
//   K^T, running maximum and sum; pass 2: Q K^T again, p = bf16(exp(s - m) /
//   l), O += P V). At heads of 160 pass 2 runs twice, 80 of O's columns
//   each time (its V boxes only). Cross-attention's <= 320 keys in one pass
//   would hold 160 scores a thread beside O: past the 168, so it takes the
//   two passes too.
//   LayerNorm: a consumer warp a row, the row in registers.
// Barriers: one release-add a block and an acquire spin; a writer's generic
// stores are ordered before other blocks' TMA reads of them by a proxy fence
// on each side. Block 0 may stamp %globaltimer after each barrier, which
// splits the kernel's time by phase.

#include <math.h>

#include "gemm_wg.cuh"
#include "mma_sync.cuh"

using namespace md_wg;
using md_mma::ex2;
using md_mma::pack_bf16;

namespace {

constexpr int kHeads = 8;
constexpr int kKeys = 128;         // keys a tile; query rows an attention item
constexpr int kBox = kKeys * 32;   // bytes of a K or V box: 128 keys x 16 channels
constexpr int kNW = 160;           // columns of a product tile: wgmma n160
constexpr int kGegluNW = 80;       // GEGLU's hidden (and gate) columns a tile
using GP = Plan<kNW>;              // the products' ring
using GegluPlan = Plan<kNW, kGegluNW>;  // its loads: two boxes of 80 rows
static_assert(GegluPlan::stage == GP::stage && GegluPlan::stages == GP::stages,
              "GEGLU's tiles run through the products' ring");
constexpr int kRingBytes = GP::stages * GP::stage;
constexpr int kBarriers = 2 * GP::stages + 2 * 4;
constexpr int kSmemBytes = 1024 + kRingBytes + 8 * kBarriers;  // + alignment slack
constexpr int kIssuer = 256;       // the producer's lane that issues the copies
constexpr int kConsumerThreads = 256;
constexpr int kMaxPairs = 20;      // a lane's share of a row of <= 1280 channels, in pairs
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned long long kBarrierTimeoutNs = 30000000000ull;  // 30 s at one barrier
static_assert(kSmemBytes <= kSmemLimit, "shared memory");

// Attention of heads of HD channels: KS boxes of 16 channels a head (the
// last one partly the next head's, which the zero columns of Q and the
// ignored columns of O leave out); a stage is K's boxes, then a pass's V
// boxes.
template <int HD>
struct AttnPlan {
  static constexpr int KS = (HD + 15) / 16;
  // O in halves at heads of 160: P V's 80 columns a pass over the keys, so
  // that the attention holds no more registers than at heads of 80 (its 80
  // O registers beside Q's 40 spilled every product of the kernel)
  static constexpr int halves = HD > 80 ? 2 : 1;
  static constexpr int VS = KS / halves;           // V boxes a pass
  static constexpr int NV = 16 * VS;               // P V's columns a pass
  static constexpr int NK = 64;  // keys of one Q K^T product
  static constexpr int stage = (KS + VS) * kBox;
  static constexpr int stages = 4 * stage <= kRingBytes ? 4 : 3;
  static_assert(stages * stage <= kRingBytes, "the attention ring fits the products' ring");
};

struct Maps {
  CUtensorMap nrm, a, act;                       // A operands: scratch rows, boxes 64 x 128
  CUtensorMap wq, wk, wv, wo, wq2, wo2, w2;      // B operands: (out, in) weights, 64 x 160
  CUtensorMap w1;                                // GEGLU's B: 64 x 80
  CUtensorMap k, v, ck, cv;                      // keys and values: (C, rows, batch), 16 x 128
};

struct Params {
  const bf16 *x, *rk, *rv;                                 // inputs (batch, seq, C)
  const float *bo, *bo2, *b1, *b2, *s1, *g1, *s2, *g2, *s3, *g3;
  bf16* out;
  bf16 *nrm, *q, *a, *act;                                 // scratch, one chunk
  bf16 *k, *v;
  float* xs;                                               // the residual stream
  unsigned int* barrier;                                   // zero at the launch
  unsigned long long* stamps;                              // or null
  int batch, seq, ctx_len, chunk;
  float eps;
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// All of the block's threads, from the consumers' code or the producer's
// (the two roles run apart after setmaxnreg, each in its own copy of the
// phase loop)
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// All blocks of the grid meet here; the counter only grows, and `target`
// counts the arrivals this block has waited for so far.
struct GridSync {
  unsigned int* counter;
  unsigned long long* stamps;
  unsigned int target;
  int n;

  __device__ __forceinline__ void operator()() {
    // this thread's stores reach the async proxy (the next phase's TMA reads)
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    block_sync();
    if (threadIdx.x == 0) {
      target += gridDim.x;
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
      const unsigned long long t0 = global_ns();
      unsigned int seen;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter)
                     : "memory");
        if (global_ns() - t0 > kBarrierTimeoutNs) __trap();  // a block is stuck: fail, not hang
      } while (seen < target);
      if (stamps != nullptr && blockIdx.x == 0) stamps[n] = global_ns();
    }
    ++n;
    block_sync();
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
  }
};

__device__ __forceinline__ float2 load_pair(const bf16* p) {
  const unsigned int raw = __ldcg(reinterpret_cast<const unsigned int*>(p));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return __ldcg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldg_pair(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ float2 ldg_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// LayerNorm of `rows` rows of C channels (C a multiple of 64), a consumer
// warp a row: mean and E[x^2] - mean^2 in fp32 from the row in registers.
template <typename T>
__device__ __forceinline__ void ln_rows(const T* in, bf16* out, const float* scale,
                                        const float* bias, long long rows, int C, float eps) {
  constexpr int kWarps = kConsumerThreads / 32;
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
        const float2 s = ldg_pair(scale + c), b = ldg_pair(bias + c);
        store_pair(dst + c, (val[i].x - mu) * rstd * s.x + b.x, (val[i].y - mu) * rstd * s.y + b.y);
      }
    }
  }
}

// A product's loader for the core: A rows m0 + [0, 128) of a scratch map,
// B columns of a weight map. With ff > 0 (GEGLU) a tile's B is 80 hidden
// columns and the gate columns ff further on: column n of the tiles' space
// (160 a tile) is w1's row (n / 80 odd ? ff : 0) + 80 (n / 160).
struct Operands {
  const CUtensorMap *a, *w;
  int m0, k_blocks_, ff;

  __device__ int k_blocks() const { return k_blocks_; }
  __device__ void load_a(int kb, uint32_t dst, uint32_t bar) const {
    tma_load(dst, a, bar, kb * BK, m0);
  }
  __device__ void load_b(int kb, int n, uint32_t dst, uint32_t bar) const {
    if (ff > 0) n = n / kGegluNW % 2 * ff + n / (2 * kGegluNW) * kGegluNW;
    tma_load(dst, w, bar, kb * BK, n);
  }
};

// What a product phase does with a consumer's accumulators, per pair of
// columns (n, n + 1) of a row of the chunk (at: the chunk's first value):
enum class Epi {
  kQ,          // q = bf16(acc)
  kK,          // k = bf16(acc + bank K)
  kV,          // v = bf16(acc + bank V)
  kStream,     // xs = x + acc + bo: the residual stream, fp32 from here on
  kAddStream,  // xs += acc + bo2
  kGeglu,      // act = bf16((hidden + b1[n]) gelu_tanh(gate + b1[4C + n]))
  kOut,        // out = bf16(xs + acc + b2)
};

__device__ __forceinline__ float gelu_tanh(float g) {
  return 0.5f * g * (1.f + tanhf(0.7978845608028654f * (g + 0.044715f * g * g * g)));
}

// A consumer thread's part of a tile's epilogue, straight from the wgmma
// accumulator layout: acc[4 i + 2 e + {0, 1}] are row m0 + 64 wg + 16 warp +
// lane / 4 + 8 e, columns 8 i + 2 (lane % 4) + {0, 1} of the tile (from n0
// on; GEGLU: its hidden columns for i < 10, the gate columns 80 further on
// for i >= 10). Every pointer comes from the kernel's parameters here, after
// the k loop, so that little besides the accumulators is live through it.
template <Epi kEpi, int C>
__device__ __forceinline__ void epilogue(const float (&acc)[kNW / 2], const Params& p, size_t at,
                                         long long rows, int m0, int n0) {
  constexpr int kLd = kEpi == Epi::kGeglu ? 4 * C : C;
  constexpr int kPairs = (kEpi == Epi::kGeglu ? kGegluNW : kNW) / 8;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const long long r0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const int c0 = n0 + lane % 4 * 2;
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long row = r0 + 8 * e;
      if (row >= rows) continue;
      const int n = c0 + 8 * i, j = 4 * i + 2 * e;
      const long long o = row * kLd + n;
      const float v0 = acc[j], v1 = acc[j + 1];
      if constexpr (kEpi == Epi::kQ) {
        store_pair(p.q + o, v0, v1);
      } else if constexpr (kEpi == Epi::kK || kEpi == Epi::kV) {
        const float2 b = ldg_pair((kEpi == Epi::kK ? p.rk : p.rv) + at + o);
        store_pair((kEpi == Epi::kK ? p.k : p.v) + o, v0 + b.x, v1 + b.y);
      } else if constexpr (kEpi == Epi::kStream) {
        const float2 x = ldg_pair(p.x + at + o), b = ldg_pair(p.bo + n);
        store_pair(p.xs + o, x.x + v0 + b.x, x.y + v1 + b.y);
      } else if constexpr (kEpi == Epi::kAddStream) {
        const float2 x = load_pair(p.xs + o), b = ldg_pair(p.bo2 + n);
        store_pair(p.xs + o, x.x + v0 + b.x, x.y + v1 + b.y);
      } else if constexpr (kEpi == Epi::kGeglu) {
        const float2 bh = ldg_pair(p.b1 + n), bg = ldg_pair(p.b1 + 4 * C + n);
        constexpr int kGate = kGegluNW / 2;  // the gate's accumulators follow the hidden ones
        store_pair(p.act + o, (v0 + bh.x) * gelu_tanh(acc[j + kGate] + bg.x),
                   (v1 + bh.y) * gelu_tanh(acc[j + kGate + 1] + bg.y));
      } else {
        const float2 x = load_pair(p.xs + o), b = ldg_pair(p.b2 + n);
        store_pair(p.out + at + o, x.x + v0 + b.x, x.y + v1 + b.y);
      }
    }
  }
}

// One product tile through the core: the issuer loads, the consumers
// multiply and run the phase's epilogue; the producer's other lanes have
// nothing to do. B columns n0 + [0, 160) of the tiles' space: a C-wide
// product's output columns, or GEGLU's act columns n0 / 2 + [0, 80) as
// hidden and gate (see Operands).
template <bool kConsumer, Epi kEpi, int C>
__device__ __forceinline__ void product(const Operands& op, const Ring& ring, uint32_t& it, int n0,
                                        const Params& p, size_t at, long long rows) {
  if constexpr (kConsumer) {
    float acc[1][kNW / 2];
    consume_tile<kNW>(acc, ring, it, op.k_blocks());
    epilogue<kEpi, C>(acc[0], p, at, rows, op.m0, kEpi == Epi::kGeglu ? n0 / 2 : n0);
  } else if (threadIdx.x == kIssuer) {
    // GEGLU's B is two boxes of 80 rows, hidden and gate, one after the
    // other in the stage: the consumers see one 160-row operand
    produce_tile<kNW, kEpi == Epi::kGeglu ? kGegluNW : kNW>(op, ring, it, n0);
  }
}

// A phase of C-wide products: (row tile, column tile) items round robin
template <bool kConsumer, Epi kEpi, int C>
__device__ __forceinline__ uint32_t product_phase(const CUtensorMap* a, const CUtensorMap* w,
                                                  int k_blocks, int row_tiles, const Params& p,
                                                  size_t at, long long rows, Ring ring,
                                                  uint32_t it) {
  constexpr int ct = C / kNW;
  for (int item = blockIdx.x; item < row_tiles * ct; item += gridDim.x) {
    const int m0 = item / ct * 128, n0 = item % ct * kNW;
    product<kConsumer, kEpi, C>(Operands{a, w, m0, k_blocks, 0}, ring, it, n0, p, at, rows);
  }
  return it;
}

// q, k + bank K and v + bank V: the three products of a row tile adjacent
template <bool kConsumer, int C>
__device__ __forceinline__ uint32_t qkv_phase(const Maps& mp, int row_tiles, const Params& p,
                                              size_t at, long long rows, Ring ring, uint32_t it) {
  constexpr int ct = C / kNW;
  for (int item = blockIdx.x; item < 3 * row_tiles * ct; item += gridDim.x) {
    const int which = item / ct % 3, m0 = item / (3 * ct) * 128, n0 = item % ct * kNW;
    if (which == 0)
      product<kConsumer, Epi::kQ, C>(Operands{&mp.nrm, &mp.wq, m0, C / BK, 0}, ring, it, n0, p, at,
                                     rows);
    else if (which == 1)
      product<kConsumer, Epi::kK, C>(Operands{&mp.nrm, &mp.wk, m0, C / BK, 0}, ring, it, n0, p, at,
                                     rows);
    else
      product<kConsumer, Epi::kV, C>(Operands{&mp.nrm, &mp.wv, m0, C / BK, 0}, ring, it, n0, p, at,
                                     rows);
  }
  return it;
}

// GEGLU: (row tile, 80 act columns) items round robin
template <bool kConsumer, int C>
__device__ __forceinline__ uint32_t geglu_phase(const Maps& mp, int row_tiles, const Params& p,
                                                size_t at, long long rows, Ring ring, uint32_t it) {
  constexpr int ft = 4 * C / kGegluNW;
  for (int item = blockIdx.x; item < row_tiles * ft; item += gridDim.x) {
    const int m0 = item / ft * 128, n0 = item % ft * kGegluNW;
    product<kConsumer, Epi::kGeglu, C>(Operands{&mp.nrm, &mp.w1, m0, C / BK, 4 * C}, ring, it,
                                       2 * n0, p, at, rows);
  }
  return it;
}

// d (64 x 64, fp32) = A (64 x 16, bf16, registers) B (16 x 64, K-major 32-byte
// swizzled) + (accumulate ? d : 0): the scores of 64 keys
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (64 x 48, fp32) += A (64 x 16, bf16, registers) B (16 x 48, N-major 32-byte
// swizzled): P V at heads of 40 (three boxes of 16 channels)
__device__ __forceinline__ void wgmma_m64n48k16_pv(float (&d)[24], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}

// S = Q K^T of this warpgroup's rows against NK keys of the K boxes from kt
// on (8-key groups 256 bytes apart), waited for
template <int HD, int NK>
__device__ __forceinline__ void scores(float (&s)[NK / 2],
                                       const uint32_t (&qa)[AttnPlan<HD>::KS][4], uint32_t kt) {
  static_assert(NK == 64, "the scores of 64 keys: wgmma m64n64k16");
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < AttnPlan<HD>::KS; ++kk) {
    const uint64_t desc = desc32(kt + kk * kBox, 16, 256);
    wgmma_m64n64k16(s, qa[kk], desc, kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// keys at or past `valid` of a tile's scores drop out: -1e30 gives them no
// part in a maximum and exp 0 once a real key has set it (key 0 is real, and
// a lane's sum is rescaled by its maximum's distance from the row's)
template <int NK>
__device__ __forceinline__ void mask_keys(float (&s)[NK / 2], int valid) {
  if (valid >= NK) return;
  const int c = threadIdx.x % 4 * 2;
#pragma unroll
  for (int i = 0; i < NK / 8; ++i) {
    if (8 * i + c >= valid) s[4 * i] = s[4 * i + 2] = -1e30f;
    if (8 * i + c + 1 >= valid) s[4 * i + 1] = s[4 * i + 3] = -1e30f;
  }
}

// this lane's share of its two rows' maxima and sums over a tile: m is
// raised to the tile's maximum, l rescaled to it (the online form, exact up
// to rounding: the maximum is the true one once the row ends)
template <int NK>
__device__ __forceinline__ void max_sum(const float (&s)[NK / 2], float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = m[r];
#pragma unroll
    for (int i = 0; i < NK / 8; ++i) t = fmaxf(t, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
    float sum = 0.f;
    const float tl = t * kLog2e;
#pragma unroll
    for (int i = 0; i < NK / 8; ++i)
      sum += ex2(fmaf(s[4 * i + 2 * r], kLog2e, -tl)) +
             ex2(fmaf(s[4 * i + 2 * r + 1], kLog2e, -tl));
    l[r] = l[r] * ex2((m[r] - t) * kLog2e) + sum;
    m[r] = t;
  }
}

// the quad that shares a row: its maximum, and its lanes' sums rescaled to it
__device__ __forceinline__ void quad_rows(float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mn = fmaxf(m[r], mo);
      l[r] = l[r] * ex2((m[r] - mn) * kLog2e) + lo * ex2((mo - mn) * kLog2e);
      m[r] = mn;
    }
  }
}

// O += P V of NK keys: p = bf16(exp(s - m) / l) as the A fragments (the
// scores' accumulator layout is theirs), V's boxes side by side at vt, the
// N-major B; waited for
template <int HD, int NK>
__device__ __forceinline__ void pv(const float (&s)[NK / 2], const float (&ml)[2],
                                   const float (&inv)[2], float (&o)[AttnPlan<HD>::NV / 2],
                                   uint32_t vt) {
  uint32_t p[NK / 16][4];
#pragma unroll
  for (int i = 0; i < NK / 8; ++i) {
    const float p0 = ex2(fmaf(s[4 * i], kLog2e, -ml[0])) * inv[0];
    const float p1 = ex2(fmaf(s[4 * i + 1], kLog2e, -ml[0])) * inv[0];
    const float p2 = ex2(fmaf(s[4 * i + 2], kLog2e, -ml[1])) * inv[1];
    const float p3 = ex2(fmaf(s[4 * i + 3], kLog2e, -ml[1])) * inv[1];
    p[i / 2][2 * (i % 2)] = pack_bf16(p0, p1);
    p[i / 2][2 * (i % 2) + 1] = pack_bf16(p2, p3);
  }
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    const uint64_t desc = desc32(vt + kk * 512, kBox, 256);
    if constexpr (AttnPlan<HD>::NV == 80) wgmma_m64n80k16<1>(o, p[kk], desc, 1);
    else wgmma_m64n48k16_pv(o, p[kk], desc);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// The attention ring's stage i (in the order both sides pass through it):
// its shared address, the wait for its boxes, and a consumer warp's hand-back.
template <int HD>
__device__ __forceinline__ uint32_t attn_stage(const Ring& r, uint32_t i) {
  return r.base + (i % AttnPlan<HD>::stages) * AttnPlan<HD>::stage;
}
template <int HD>
__device__ __forceinline__ void attn_wait(const Ring& r, uint32_t i) {
  mbar_wait(r.full0 + 8 * (i % AttnPlan<HD>::stages), (i / AttnPlan<HD>::stages) & 1);
}
template <int HD>
__device__ __forceinline__ void attn_release(const Ring& r, uint32_t i) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(r.empty0 + 8 * (i % AttnPlan<HD>::stages));
}

// The producer's loads of one attention item: every key tile, K alone in
// the first pass, then K and V's boxes of O's columns (a half of them at
// heads of 160, twice).
template <int HD>
__device__ __forceinline__ void attention_loads(const CUtensorMap* km, const CUtensorMap* vm,
                                                const Ring& r, uint32_t& it, int b, int h,
                                                int kv_len) {
  using P = AttnPlan<HD>;
  const int tiles = (kv_len + kKeys - 1) / kKeys;
  for (int pass = 0; pass <= P::halves; ++pass) {
    for (int t = 0; t < tiles; ++t, ++it) {
      const uint32_t s = it % P::stages;
      if (it >= P::stages) mbar_wait(r.empty0 + 8 * s, (it / P::stages - 1) & 1);
      const uint32_t full = r.full0 + 8 * s, dst = r.base + s * P::stage;
      mbar_expect_tx(full, (P::KS + (pass ? P::VS : 0)) * kBox);
#pragma unroll
      for (int j = 0; j < P::KS; ++j)
        tma_load(dst + j * kBox, km, full, h * HD + 16 * j, t * kKeys, b);
      if (pass) {
        const int c0 = h * HD + (pass - 1) * P::NV;
#pragma unroll
        for (int j = 0; j < P::VS; ++j)
          tma_load(dst + (P::KS + j) * kBox, vm, full, c0 + 16 * j, t * kKeys, b);
      }
    }
  }
}

// A consumer warpgroup's part of one attention item: its 64 of the query
// rows q0 + [0, 128) of one head (q and o point at the head's first column,
// row stride ld) against kv_len keys. Ring order as attention_loads.
template <int HD>
__device__ __forceinline__ void attention_rows(const Ring& r, uint32_t& it, const bf16* q, bf16* o,
                                               int ld, int q_len, int q0, int kv_len) {
  using P = AttnPlan<HD>;
  constexpr int KS = P::KS;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int c2 = lane % 4 * 2;
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const float scale = 1.f / sqrtf(static_cast<float>(HD));

  // q * scale rounded to bf16, as Q K^T's A fragments; columns past HD and
  // rows past q_len are zero
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = kk * 16 + half * 8 + c2;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + 8 * e;
        float2 x = make_float2(0.f, 0.f);
        if (col < HD && row < q_len) x = load_pair(q + static_cast<size_t>(row) * ld + col);
        qa[kk][2 * half + e] = pack_bf16(x.x * scale, x.y * scale);
      }
    }
  }

  const int tiles = (kv_len + kKeys - 1) / kKeys;
  constexpr int NK = P::NK;
  // pass 1: the rows' maxima and sums
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  for (int t = 0; t < tiles; ++t, ++it) {
    attn_wait<HD>(r, it);
#pragma unroll
    for (int part = 0; part < kKeys / NK; ++part) {
      // keys part NK + [0, NK) of the tile: 8-key groups 256 bytes apart in
      // K's boxes (and 16-key steps 512 bytes apart in V's); none real: skip
      const int valid = kv_len - t * kKeys - part * NK;
      if (valid <= 0) break;
      float s[NK / 2];
      scores<HD, NK>(s, qa, attn_stage<HD>(r, it) + part * NK * 32);
      mask_keys<NK>(s, valid);
      max_sum<NK>(s, m, l);
    }
    attn_release<HD>(r, it);
  }
  quad_rows(m, l);
  const float ml[2] = {m[0] * kLog2e, m[1] * kLog2e}, inv[2] = {1.f / l[0], 1.f / l[1]};

  // pass 2: the scores again, O += bf16(exp(s - m) / l) V, a half of O's
  // columns at a time
#pragma unroll 1
  for (int half = 0; half < P::halves; ++half) {
    float oacc[P::NV / 2];
#pragma unroll
    for (int i = 0; i < P::NV / 2; ++i) oacc[i] = 0.f;
    for (int t = 0; t < tiles; ++t, ++it) {
      attn_wait<HD>(r, it);
      const uint32_t kt = attn_stage<HD>(r, it), vt = kt + KS * kBox;
#pragma unroll
      for (int part = 0; part < kKeys / NK; ++part) {
        const int valid = kv_len - t * kKeys - part * NK;
        if (valid <= 0) break;
        float s[NK / 2];
        scores<HD, NK>(s, qa, kt + part * NK * 32);
        mask_keys<NK>(s, valid);
        pv<HD, NK>(s, ml, inv, oacc, vt + part * NK / 16 * 512);
      }
      attn_release<HD>(r, it);
    }

    // O is normalised already: bf16 pairs straight to o, columns < HD
#pragma unroll
    for (int n = 0; n < P::NV / 8; ++n) {
      const int col = half * P::NV + 8 * n + c2;
      if (col >= HD) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + 8 * e;
        if (row < q_len)
          store_pair(o + static_cast<size_t>(row) * ld + col, oacc[4 * n + 2 * e],
                     oacc[4 * n + 2 * e + 1]);
      }
    }
  }
}

// One attention phase: items (batch element, head, 128 query rows) round
// robin; q, o (seq, C) a batch element; keys and values batch element kv_b0 +
// b of km / vm.
template <int HD, bool kConsumer>
__device__ __forceinline__ uint32_t attention_phase(Ring r, uint32_t it, const CUtensorMap* km,
                                                    const CUtensorMap* vm, const bf16* q, bf16* o,
                                                    int nb, int seq, int kv_b0, int kv_len) {
  constexpr int C = kHeads * HD;
  const int qt = (seq + kKeys - 1) / kKeys;
  for (int item = blockIdx.x; item < nb * kHeads * qt; item += gridDim.x) {
    const int b = item / (kHeads * qt), h = item / qt % kHeads, q0 = item % qt * kKeys;
    if constexpr (kConsumer) {
      const size_t head = static_cast<size_t>(b) * seq * C + h * HD;
      attention_rows<HD>(r, it, q + head, o + head, C, seq, q0, kv_len);
    } else if (threadIdx.x == kIssuer) {
      attention_loads<HD>(km, vm, r, it, kv_b0 + b, h, kv_len);
    }
  }
  return it;
}

// The block's walk through the phases, chunk by chunk, in one role: the
// consumers (kConsumer) or the producer, whose lane kIssuer issues every copy.
template <int HD, bool kConsumer>
__device__ __forceinline__ void walk(const Maps& mp, const Params& p, Ring gr, Ring ar) {
  constexpr int C = kHeads * HD, FF = 4 * C;
  GridSync sync{p.barrier, p.stamps, 0u, 1};
  uint32_t git = 0, ait = 0;  // the rings' positions (issuer and consumers alike)

  for (int b0 = 0; b0 < p.batch; b0 += p.chunk) {
    const int nb = min(p.chunk, p.batch - b0);
    const long long R = static_cast<long long>(nb) * p.seq;
    const size_t at = static_cast<size_t>(b0) * p.seq * C;
    const int rt = static_cast<int>((R + 127) / 128);

    // 1. LN1
    if constexpr (kConsumer) ln_rows<bf16>(p.x + at, p.nrm, p.s1, p.g1, R, C, p.eps);
    sync();
    // 2. q, k + bank K, v + bank V
    git = qkv_phase<kConsumer, C>(mp, rt, p, at, R, gr, git);
    sync();
    // 3. self-attention
    ait = attention_phase<HD, kConsumer>(ar, ait, &mp.k, &mp.v, p.q, p.a, nb, p.seq, 0, p.seq);
    sync();
    // 4. the residual stream starts: xs = x + a Wo^T + bo, fp32
    git = product_phase<kConsumer, Epi::kStream, C>(&mp.a, &mp.wo, C / BK, rt, p, at, R, gr, git);
    sync();
    // 5. LN2
    if constexpr (kConsumer) ln_rows<float>(p.xs, p.nrm, p.s2, p.g2, R, C, p.eps);
    sync();
    // 6. the cross-attention q
    git = product_phase<kConsumer, Epi::kQ, C>(&mp.nrm, &mp.wq2, C / BK, rt, p, at, R, gr, git);
    sync();
    // 7. attention against the context K/V; keys from ctx_len on are padding
    ait = attention_phase<HD, kConsumer>(ar, ait, &mp.ck, &mp.cv, p.q, p.a, nb, p.seq, b0,
                                         p.ctx_len);
    sync();
    // 8. xs += a Wo2^T + bo2
    git = product_phase<kConsumer, Epi::kAddStream, C>(&mp.a, &mp.wo2, C / BK, rt, p, at, R, gr,
                                                         git);
    sync();
    // 9. LN3
    if constexpr (kConsumer) ln_rows<float>(p.xs, p.nrm, p.s3, p.g3, R, C, p.eps);
    sync();
    // 10. GEGLU: act = (h + b1) * gelu_tanh(g + b1')
    git = geglu_phase<kConsumer, C>(mp, rt, p, at, R, gr, git);
    sync();
    // 11. out = bf16(xs + act W2^T + b2)
    git = product_phase<kConsumer, Epi::kOut, C>(&mp.act, &mp.w2, FF / BK, rt, p, at, R, gr, git);
    // no barrier: the next chunk's LN1 writes only nrm, which this phase does
    // not read; its products (q, k, v, which act overlays) wait one barrier,
    // its residual stream three
  }
  if (p.stamps != nullptr) sync();  // the last phase's end, for the stamps
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
mega_kernel(const __grid_constant__ Maps mp, const __grid_constant__ Params p) {
  using AP = AttnPlan<HD>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzled boxes and wgmma's descriptors agree from a 1024-byte base
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem), bars = base + kRingBytes;
  const Ring gr{base, bars, bars + 8 * GP::stages};
  const Ring ar{base, bars + 16 * GP::stages, bars + 16 * GP::stages + 8 * AP::stages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < GP::stages; ++s) {
      mbar_init(gr.full0 + 8 * s, 1);   // the issuer's expect_tx
      mbar_init(gr.empty0 + 8 * s, 8);  // one arrival a consumer warp
    }
    for (int s = 0; s < AP::stages; ++s) {
      mbar_init(ar.full0 + 8 * s, 1);
      mbar_init(ar.empty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (p.stamps != nullptr && blockIdx.x == 0) p.stamps[0] = global_ns();
  }
  __syncthreads();
  // each role runs its own copy of the phase loop after setmaxnreg, so that
  // ptxas gives each the registers of its role
  if (threadIdx.x >= kConsumerThreads) {
    setmaxnreg_dec<kProducerRegs>();
    walk<HD, false>(mp, p, gr, ar);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    walk<HD, true>(mp, p, gr, ar);
  }
}

// a bf16 matrix (cols, rows) row-major in boxes of 64 x box_rows, 128-byte swizzle
bool map2(CUtensorMap* map, const void* base, long long rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  return tensor_map(map, base, 2, dims, strides, box);
}

// (C, rows, batch) bf16: boxes of 16 channels x 128 rows, 32-byte swizzle,
// zeros past the rows (never the next batch element's)
bool map3(CUtensorMap* map, const void* base, int batch, int rows, int C) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(rows) * C * 2};
  const cuuint32_t box[3] = {16, kKeys, 1};
  return encode_bf16(map, base, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_32B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

template <int HD>
cudaError_t launch(const void* const* t, Params p, int ctx_pad, cudaStream_t stream) {
  constexpr int C = kHeads * HD, FF = 4 * C;
  const long long rows = static_cast<long long>(p.chunk) * p.seq;  // scratch rows
  Maps m;
  // t: x, rk, rv, ck, cv; wq, wk, wv, wo, wq2, wo2, w1, w2 (see md_mega_block)
  const bool ok = map2(&m.nrm, p.nrm, rows, C, 128) && map2(&m.a, p.a, rows, C, 128) &&
                  map2(&m.act, p.act, rows, FF, 128) && map2(&m.wq, t[5], C, C, kNW) &&
                  map2(&m.wk, t[6], C, C, kNW) && map2(&m.wv, t[7], C, C, kNW) &&
                  map2(&m.wo, t[8], C, C, kNW) && map2(&m.wq2, t[9], C, C, kNW) &&
                  map2(&m.wo2, t[10], C, C, kNW) && map2(&m.w1, t[11], 2 * FF, C, kGegluNW) &&
                  map2(&m.w2, t[12], C, FF, kNW) && map3(&m.k, p.k, p.chunk, p.seq, C) &&
                  map3(&m.v, p.v, p.chunk, p.seq, C) && map3(&m.ck, t[3], p.batch, ctx_pad, C) &&
                  map3(&m.cv, t[4], p.batch, ctx_pad, C);
  if (!ok) return cudaErrorInvalidValue;
  auto kern = mega_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, kSmemBytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  if ((err = cudaMemsetAsync(p.barrier, 0, sizeof(unsigned int), stream)) != cudaSuccess)
    return err;
  void* args[] = {&m, &p};
  // cooperative: every block is resident, which the barrier needs
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(sms), dim3(kThreads), args,
                                    kSmemBytes, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// tensors: 31 device pointers (x, rk, rv, ck, cv; wq, wk, wv, wo, wq2, wo2,
// w1, w2; bo, bo2, b1, b2, s1, g1, s2, g2, s3, g3; out; nrm, q, k, v, a, act;
// xs), then the barrier word. x, rk, rv, out (batch, seq, C) and ck, cv
// (batch, ctx_pad, C) bf16; weights (out, in) bf16; vectors fp32; C = 8 hd
// with hd 40, 80 or 160; scratch for `chunk` batch elements (act may overlay
// q, k, v and a: the phases that write it read none of them). stamps: null,
// or room for 2 + 10 ceil(batch / chunk) %globaltimer readings of block 0
// (the start, after each barrier, the end).
int md_mega_block(const void* const* t, int batch, int seq, int hd, int ctx_pad, int ctx_len,
                  int chunk, float eps, void* stamps, void* stream) {
  if (batch < 1 || seq < 1 || ctx_len < 1 || ctx_len > ctx_pad || chunk < 1 || chunk > batch)
    return cudaErrorInvalidValue;
  Params p;
  int i = 0;
  auto b = [&]() { return static_cast<const bf16*>(t[i++]); };
  auto f = [&]() { return static_cast<const float*>(t[i++]); };
  auto m = [&]() { return static_cast<bf16*>(const_cast<void*>(t[i++])); };
  p.x = b(), p.rk = b(), p.rv = b();
  i = 13;  // ck, cv and the weights go through tensor maps
  p.bo = f(), p.bo2 = f(), p.b1 = f(), p.b2 = f();
  p.s1 = f(), p.g1 = f(), p.s2 = f(), p.g2 = f(), p.s3 = f(), p.g3 = f();
  p.out = m(), p.nrm = m(), p.q = m(), p.k = m(), p.v = m(), p.a = m(), p.act = m();
  p.xs = static_cast<float*>(const_cast<void*>(t[i++]));
  p.barrier = static_cast<unsigned int*>(const_cast<void*>(t[i++]));
  p.stamps = static_cast<unsigned long long*>(stamps);
  p.batch = batch, p.seq = seq, p.ctx_len = ctx_len, p.chunk = chunk;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 40) return launch<40>(t, p, ctx_pad, s);
  if (hd == 80) return launch<80>(t, p, ctx_pad, s);
  if (hd == 160) return launch<160>(t, p, ctx_pad, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
