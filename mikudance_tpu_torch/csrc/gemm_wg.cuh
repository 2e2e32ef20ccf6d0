// The warpgroup GEMM core of the two GEMM-shaped kernels (K7 md_linear in
// linear.cu, K8 md_conv3x3 in conv2d.cu) and of the products inside the
// mega-block K14 (mega_block.cu), hand-written for Hopper (sm_90a).
//
// Both compute a (rows x K) by (K x columns) product, bf16 in, fp32
// accumulation, and differ only in where a row of the left operand comes
// from: a token row (K7), or a 3x3 neighbour's channels at one tap (K8). A
// kernel gives the core a loader (which TMA boxes make k block kb, and which
// output row a tile row is); everything else lives here.
//
// What bounds the two on the card: operations at the UNets' widths, where
// the tensor cores wait on L2: every k block brings (128 + BN) x 64 operands
// from L2 for 128 x BN x 64 multiply-adds, and the card's L2 delivers ~7 TB/s
// (measured here: the k loop at 6.8-7.3 TB/s of operand traffic across the
// UNet and VAE shapes, PERF.md), so the widest tile a block can hold in
// registers wins. Bytes bound the narrow products (Cin 320). mma.sync does
// not reach Hopper's tensor-core rate; warpgroup MMA does, so the product is
// wgmma with both operands in shared memory, fed by the Tensor Memory
// Accelerator.
//
// Design (a block an output tile of 128 rows x BN columns):
//   Ring. A (128 rows x 64 k) and B (BN rows x 64 k) arrive by TMA into a ring
//   of stages with full / empty mbarriers: 128-byte rows, 128-byte swizzled,
//   which is the K-major operand layout wgmma reads (8-row groups 1024 bytes
//   apart; a k16 step is 32 bytes further along the row). TMA writes zeros
//   for coordinates out of range, so k past Cin, rows past the end and
//   columns past Cout need no mask in the loop.
//   Warpgroups. One producer warpgroup (one lane issues the copies, three
//   warps stage the tile's bias) and two consumer warpgroups of 64 rows x BN
//   (384 threads). Registers go per SM quadrant: 3 warps x 168 at launch, the
//   producer drops to 40 with setmaxnreg and the consumers take 232 (BN 320
//   holds 160 fp32 accumulators a thread).
//   Product. Each consumer issues wgmma m64nNWk16 with both operands from
//   shared-memory descriptors, NH products of NW columns (BN = NH NW, NW at
//   most 256) for each of the four k16 steps of a stage, and keeps one group
//   in flight (wait_group 1) before it hands the previous stage back.
//   Epilogue, in the TPU kernels' order: bias in fp32, one rounding to bf16
//   into a staging tile in the (then free) ring, then 16-byte stores spread
//   over a warp's lanes in row order, the residual read ahead and added in
//   bf16 on the way. Rows the loader drops and columns at or past Cout are
//   not written; a Cout that is not a multiple of 8 (the 3- and 4-channel
//   conv outputs, no residual) is stored element by element.
//   Grid: one block a tile, the column tiles of one row tile adjacent in
//   launch order, so the left operand comes from device memory once and from
//   the 50 MB L2 after that.
// Tile widths: BN 320 (two products of 160) where it divides Cout, else 256
// or 160 where one does, else 128 with the last column tile masked; the
// wrapper picks (kernels/_gemm_plan.py::column_tile) and the entry point
// instantiates.
// The k loop's two halves (produce_tile, consume_tile) stand alone, with the
// ring's position carried by the caller: K14's persistent kernel runs them
// tile after tile under epilogues of its own, the producer already loading
// the next tile while the consumers store this one.
// Not here (ROADMAP S6): a persistent grid for K7 and K8, multicast of the
// weight tile across a cluster (which halves the L2 traffic of B).
//
// The mbarrier, TMA, setmaxnreg, wgmma-fence and tensor-map helpers are
// tma_wgmma.cuh's, which K10-K12 (flash_anchor_wg.cu) share.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "tma_wgmma.cuh"

namespace md_wg {

using namespace md_tma;

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;                // rows of a tile: two consumer warpgroups of 64
constexpr int BK = 64;                 // k of a stage: 128 bytes of bf16 a row
constexpr int kThreads = 384;          // two consumer warpgroups and the producer
constexpr int kProducerRegs = 40;      // 40 + 2 x 232 = 3 x 168, a quadrant's share at launch
constexpr int kConsumerRegs = 232;
constexpr int kSmemLimit = 232448;     // dynamic shared memory a block may have

// The plan of a tile width BN: wgmma's N (NW, at most 256; by default 160 at
// BN 320, else BN) and the products a k16 step takes to cover BN (NH = BN /
// NW); the ring's stages (A, then B), the barriers after them, then the
// tile's bias; the output staging tile (rows padded by 8 bf16 against bank
// conflicts) reuses the ring.
template <int BN, int NW_ = (BN > 256 ? BN / 2 : BN)>
struct Plan {
  static constexpr int NW = NW_;
  static constexpr int NH = BN / NW;
  static constexpr int a_bytes = BM * BK * 2;
  static constexpr int stage = a_bytes + BN * BK * 2;
  static constexpr int fit = (kSmemLimit - 1024 - 256) / stage;
  static constexpr int stages = fit < 6 ? fit : 6;
  static constexpr int ldo = BN + 8;
  static constexpr int bias_offset = stages * stage + 2 * stages * 8;  // the tile's bias, fp32
  static constexpr int bytes = 1024 + bias_offset + BN * 4;           // + alignment slack
  static_assert(NW % 8 == 0 && NW >= 8 && NW <= 256 && NH * NW == BN, "wgmma's N");
  static_assert(stages >= 3, "a ring");
  static_assert(BM * ldo * 2 <= stages * stage, "the staging tile fits the ring");
  static_assert(bytes <= kSmemLimit, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A shared-memory matrix descriptor of a K-major operand, 128-byte swizzle:
// start address, 8-row groups 1024 bytes apart (the leading offset is unused
// for this layout; the fields hold 16-byte units).
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}

// d (64 x 256, fp32) += A (64 x 16) B (16 x 256), both bf16 K-major in shared
// memory (descriptors); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 160, fp32) += A (64 x 16) B (16 x 160), both bf16 K-major in shared
// memory (descriptors); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n160k16(float (&d)[80], uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128, fp32) += A (64 x 16) B (16 x 128), both bf16 K-major in shared
// memory (descriptors); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int NW>
__device__ __forceinline__ void wgmma_n(float (&d)[NW / 2], uint64_t desc_a, uint64_t desc_b,
                                        int scale_d) {
  if constexpr (NW == 256) wgmma_m64n256k16(d, desc_a, desc_b, scale_d);
  else if constexpr (NW == 160) wgmma_m64n160k16(d, desc_a, desc_b, scale_d);
  else wgmma_m64n128k16(d, desc_a, desc_b, scale_d);
}

__device__ __forceinline__ float bias_at(const void* bias, int bias_fp32, int n) {
  if (bias == nullptr) return 0.f;
  return bias_fp32 ? static_cast<const float*>(bias)[n]
                   : __bfloat162float(static_cast<const bf16*>(bias)[n]);
}

// A ring of Plan<BN>'s stages in shared memory and its full / empty barriers
// (shared addresses). Both sides count the k blocks they have passed through
// it (`it`), so a persistent kernel carries the barriers' phases from one
// tile to the next; a one-tile kernel starts both at 0.
struct Ring {
  uint32_t base, full0, empty0;
};

// The producer's half of a tile's k loop, one lane: k block kb of A and the
// NH boxes of B, columns n0 + h NW, into the next stage once the consumers
// have handed it back.
template <int BN, int NW_ = Plan<BN>::NW, class Loader>
__device__ __forceinline__ void produce_tile(const Loader& ld, const Ring& r, uint32_t& it,
                                             int n0) {
  using L = Plan<BN, NW_>;
  constexpr int S = L::stages, NW = L::NW;
  const int k_blocks = ld.k_blocks();
  for (int kb = 0; kb < k_blocks; ++kb, ++it) {
    const uint32_t s = it % S;
    if (it >= S) mbar_wait(r.empty0 + 8 * s, (it / S - 1) & 1);
    const uint32_t full = r.full0 + 8 * s, a = r.base + s * L::stage;
    mbar_expect_tx(full, L::stage);
    ld.load_a(kb, a, full);
#pragma unroll
    for (int h = 0; h < L::NH; ++h)
      ld.load_b(kb, n0 + h * NW, a + L::a_bytes + h * NW * BK * 2, full);
  }
}

// The consumers' half, each warpgroup wg (0 or 1) its 64 rows: acc[h] = the
// tile's rows 64 wg + [0, 64) times B columns h NW + [0, NW), in the wgmma
// accumulator layout; every stage is handed back, the last once its
// products are done.
template <int BN, int NW_ = Plan<BN>::NW>
__device__ __forceinline__ void consume_tile(float (&acc)[Plan<BN, NW_>::NH][NW_ / 2],
                                             const Ring& r, uint32_t& it, int k_blocks) {
  using L = Plan<BN, NW_>;
  constexpr int S = L::stages, NW = L::NW;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  for (int kb = 0; kb < k_blocks; ++kb, ++it) {
    const uint32_t s = it % S;
    mbar_wait(r.full0 + 8 * s, (it / S) & 1);
    const uint32_t a = r.base + s * L::stage + wg * 64 * 128;
    const uint32_t b = r.base + s * L::stage + L::a_bytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int h = 0; h < L::NH; ++h)  // the first k16 step overwrites acc
        wgmma_n<NW>(acc[h], desc128(a + 32 * kk), desc128(b + h * NW * BK * 2 + 32 * kk),
                    kb > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the products of the stage before are done: hand it back
    if (kb > 0 && lane == 0) mbar_arrive(r.empty0 + 8 * ((it - 1) % S));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < L::NH; ++h) fence_regs(acc[h]);
  if (k_blocks > 0 && lane == 0) mbar_arrive(r.empty0 + 8 * ((it - 1) % S));
}

// What the epilogue writes: y[row * cout + n] for the tile's columns
// n0 + [0, BN), bias (bf16 or fp32, or null) and residual (or null) alike.
struct Out {
  bf16* y;
  const void* bias;
  const bf16* residual;
  int n0, cout, bias_fp32;
};

// One output tile, the whole block. The loader `ld` gives
//   int k_blocks()                                    k blocks of 64
//   void load_a(int kb, uint32_t dst, uint32_t bar)   TMA copy of k block kb of
//                                                     the left operand (128 rows)
//   void load_b(int kb, int n, uint32_t dst, uint32_t bar)
//                                                     ... of the weight, columns
//                                                     n + [0, NW)
//   long long row(int r)                              output row of tile row r, or -1
template <int BN, class Loader>
__device__ __forceinline__ void gemm_tile(const Loader& ld, const Out& out) {
  using L = Plan<BN>;
  constexpr int S = L::stages, NW = L::NW, NH = L::NH;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: TMA and wgmma agree on it
  // from a 1024-byte aligned base
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full0 = ring + S * L::stage, empty0 = full0 + 8 * S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);    // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 8);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int k_blocks = ld.k_blocks();
  float* bias_s = reinterpret_cast<float*>(smem + L::bias_offset);
  if (wg == 2) {  // the producer: one lane issues the copies
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 288) {  // its last three warps stage the bias for the epilogue
      for (int c = threadIdx.x - 288; c < BN; c += 96)
        bias_s[c] = out.n0 + c < out.cout ? bias_at(out.bias, out.bias_fp32, out.n0 + c) : 0.f;
      asm volatile("bar.arrive 1, 352;\n" ::: "memory");
    } else if (threadIdx.x == 256) {
      uint32_t it = 0;
      produce_tile<BN>(ld, Ring{ring, full0, empty0}, it, out.n0);
    }
    return;
  }

  // a consumer: warpgroup wg owns tile rows 64 wg + [0, 64)
  setmaxnreg_inc<kConsumerRegs>();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  float acc[NH][NW / 2];
  uint32_t it = 0;
  consume_tile<BN>(acc, Ring{ring, full0, empty0}, it, k_blocks);

  // bias in fp32, one rounding, into this warpgroup's 64 staging rows; the
  // ring is free once both consumers are past their last product (and the
  // bias is staged)
  asm volatile("bar.sync 1, 352;\n" ::: "memory");
  const int g = lane / 4, c2 = (lane % 4) * 2;
  bf16* st = reinterpret_cast<bf16*>(smem) + wg * 64 * L::ldo;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int i = 0; i < NW / 8; ++i) {
      const int col = h * NW + 8 * i + c2;
      const float2 b = *reinterpret_cast<const float2*>(bias_s + col);
      *reinterpret_cast<__nv_bfloat162*>(st + (warp * 16 + g) * L::ldo + col) =
          __floats2bfloat162_rn(acc[h][4 * i] + b.x, acc[h][4 * i + 1] + b.y);
      *reinterpret_cast<__nv_bfloat162*>(st + (warp * 16 + g + 8) * L::ldo + col) =
          __floats2bfloat162_rn(acc[h][4 * i + 2] + b.x, acc[h][4 * i + 3] + b.y);
    }
  }
  __syncwarp();

  // staging rows -> y: each warp stores the 16 rows it staged, their 16-byte
  // chunks spread over the lanes in row order
  constexpr int kChunks = BN / 8;                // 16-byte chunks of a row
  constexpr int kIters = 16 * kChunks / 32;      // chunks a lane
  static_assert(16 * kChunks % 32 == 0, "whole passes");
  const int valid = out.cout - out.n0;           // columns of this tile in y
  if (out.cout % 8 != 0) {  // element by element (no residual)
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const long long row = ld.row(wg * 64 + r);
      if (row < 0) continue;
      for (int c = lane; c < BN && c < valid; c += 32)
        out.y[static_cast<size_t>(row) * out.cout + out.n0 + c] = st[r * L::ldo + c];
    }
  } else if (out.residual == nullptr) {
#pragma unroll 4
    for (int t = 0; t < kIters; ++t) {
      const int idx = lane + 32 * t, r = warp * 16 + idx / kChunks, j = idx % kChunks;
      const long long row = ld.row(wg * 64 + r);
      if (row < 0 || 8 * j >= valid) continue;
      *reinterpret_cast<uint4*>(out.y + row * out.cout + out.n0 + 8 * j) =
          *reinterpret_cast<const uint4*>(st + r * L::ldo + 8 * j);
    }
  } else {
    // this lane's residual chunks are read first, then added in bf16 on the
    // way out
    long long at[kIters];
    uint4 res[kIters];
#pragma unroll
    for (int t = 0; t < kIters; ++t) {
      const int idx = lane + 32 * t, r = warp * 16 + idx / kChunks, j = idx % kChunks;
      const long long row = ld.row(wg * 64 + r);
      at[t] = row < 0 || 8 * j >= valid ? -1 : row * out.cout + out.n0 + 8 * j;
      if (at[t] >= 0) res[t] = __ldg(reinterpret_cast<const uint4*>(out.residual + at[t]));
    }
#pragma unroll
    for (int t = 0; t < kIters; ++t) {
      if (at[t] < 0) continue;
      const int idx = lane + 32 * t, r = warp * 16 + idx / kChunks, j = idx % kChunks;
      uint4 v = *reinterpret_cast<const uint4*>(st + r * L::ldo + 8 * j);
      __nv_bfloat162* vh = reinterpret_cast<__nv_bfloat162*>(&v);
      const __nv_bfloat162* rh = reinterpret_cast<const __nv_bfloat162*>(&res[t]);
#pragma unroll
      for (int e = 0; e < 4; ++e) vh[e] = __hadd2(vh[e], rh[e]);
      *reinterpret_cast<uint4*>(out.y + at[t]) = v;
    }
  }
}

// A bf16 tensor of `rank` dimensions at base (dims innermost first, strides
// in bytes of dimensions 1 .. rank - 1), boxes of `box`, 128-byte swizzle,
// zeros out of bounds. The innermost box dimension is 64 (128 bytes).
inline bool tensor_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box) {
  return encode_bf16(map, base, rank, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
}

// lets `kern` have tile width BN's dynamic shared memory
template <int BN, class Kernel>
cudaError_t allow_smem(Kernel kern) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan<BN>::bytes);
}

}  // namespace md_wg
