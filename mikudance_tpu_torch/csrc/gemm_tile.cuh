// The mma.sync GEMM tile of the mega-block probe K14 (mega_block.cu),
// hand-written for Hopper (sm_90a). K7 (md_linear) and K8 (md_conv3x3) were
// built on it until they moved to the warpgroup core of gemm_wg.cuh; it stays
// for K14 until K14 moves there too (ROADMAP S8).
//
// A (rows x K) by (K x columns) product in bf16 with fp32 accumulation, the
// left operand's rows loaded by the caller. What lives here: the tile plan,
// the k loop over a ring of cp.async stages (main_loop; cp_async.cuh, a copy
// that is out of range writes zeros) and the warp-level product of one staged
// k-slice (mma_stage). K14 writes its own epilogues through a 16 x 16 fp32
// scratch of LDE-wide rows per warp.
//
// Tile plan: a block of 8 warps owns a 128 x 128 output tile; the k loop
// walks slices of 32 through a ring of three shared-memory stages filled by
// cp.async, one barrier a slice. A warp owns 64 x 32 of the tile as 4 x 2
// nvcuda::wmma 16x16x16 fragments, which stay in registers for the whole k
// loop; two blocks share an SM (__launch_bounds__(256, 2) holds the kernels
// to 128 registers). Both operands are staged k-contiguous (the right operand is given as
// (columns, K) row-major, i.e. column-major K x columns), rows padded by 8
// bf16 so that the 16 rows of a fragment fall into different banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>

#include "cp_async.cuh"

namespace md_gemm {

using namespace nvcuda;
using namespace md_cp;
typedef __nv_bfloat16 bf16;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kStages = 3;
constexpr int LDT = BK + 8;                          // staged row, bf16 (80 bytes)
constexpr int kTileElems = BM * LDT;                 // one operand's stage (BM == BN)
constexpr int kStageElems = 2 * kTileElems;          // left and right operand
constexpr int kSmemBytes = kStages * kStageElems * 2;
constexpr int WM = 64, WN = 32;                      // a warp's part of the tile
constexpr int kChunks = BK / 8;                      // 16-byte copies in a staged row
constexpr int kCopyRows = kThreads / kChunks;        // rows the block copies at once
constexpr int kCopies = BM / kCopyRows;              // copies a thread makes per operand tile
constexpr int LDE = 20;                              // K14's epilogue scratch row, fp32
static_assert(BM == BN, "one loader shape for both operands");
static_assert(kThreads % kChunks == 0 && BM % kCopyRows == 0, "the copies tile the stage");
static_assert(kWarps == (BM / WM) * (BN / WN), "warps tile the block");
static_assert(kWarps * 16 * LDE * 4 <= kSmemBytes, "epilogue scratch fits the ring");

struct Acc {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[WM / 16][WN / 16];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < WM / 16; ++i)
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) wmma::fill_fragment(f[i][j], 0.f);
  }
};

// acc += A_stage x B_stage for this warp's 64 x 32 part; a_s, b_s are one
// stage's operand tiles (row stride LDT), wm / wn the warp's tile coordinates.
__device__ __forceinline__ void mma_stage(Acc& acc, const bf16* a_s, const bf16* b_s, int wm,
                                          int wn) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[WN / 16];
#pragma unroll
    for (int j = 0; j < WN / 16; ++j)
      wmma::load_matrix_sync(b[j], b_s + (wn * WN + j * 16) * LDT + kk, LDT);
#pragma unroll
    for (int i = 0; i < WM / 16; ++i) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, a_s + (wm * WM + i * 16) * LDT + kk, LDT);
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) wmma::mma_sync(acc.f[i][j], a, b[j], acc.f[i][j]);
    }
  }
}

// The k loop: `load(stage, kt)` starts the cp.async copies of slice kt into
// ring stage `stage` (every thread calls it); kt_count slices in all.
template <typename Load>
__device__ __forceinline__ void main_loop(Acc& acc, bf16* ring, int kt_count, int wm, int wn,
                                          Load load) {
  acc.zero();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_count) load(s, s);
    cp_async_commit();  // a group a slot, empty or not, keeps the count uniform
  }
  for (int kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<kStages - 2>();  // slice kt has landed (for this thread's copies)
    __syncthreads();               // ... and for everyone's; stage (kt - 1) % kStages is free
    const int next = kt + kStages - 1;
    if (next < kt_count) load(next % kStages, next);
    cp_async_commit();
    const bf16* a_s = ring + (kt % kStages) * kStageElems;
    mma_stage(acc, a_s, a_s + kTileElems, wm, wn);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the epilogue reuses it
}

}  // namespace md_gemm
