// Shared pieces of the two GEMM-shaped kernels (K7 md_linear, K8 md_conv3x3),
// hand-written for Hopper (sm_90a).
//
// Both compute a (rows x K) by (K x columns) product in bf16 with fp32
// accumulation and differ only in where a row of the left operand comes
// from (a token row; a 3x3 neighbourhood gathered on the fly). What they
// share lives here: the tile plan, the k loop over a ring of cp.async stages
// (cp_async.cuh; a copy that is out of range writes zeros), the warp-level
// product of one staged k-slice, and the epilogue (bias in fp32, one rounding
// to bf16, optional residual added in bf16).
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
constexpr int LDE = 20;                              // epilogue scratch row, fp32
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

__device__ __forceinline__ float bias_at(const void* bias, int bias_fp32, int n) {
  if (bias == nullptr) return 0.f;
  return bias_fp32 ? static_cast<const float*>(bias)[n]
                   : __bfloat162float(static_cast<const bf16*>(bias)[n]);
}

// y[m, n] = bf16(acc + bias[n]) (+ residual[m, n], added in bf16) for this
// warp's part of the tile whose first row / column are m0 / n0. Rows >= rows
// and columns >= cols are dropped. Each fragment goes through a 16 x 16 fp32
// scratch of the warp; two lanes a row, eight columns (one 16-byte store
// when cols is a multiple of 8, which a residual requires) each.
__device__ __forceinline__ void epilogue(Acc& acc, float* scratch_all, int wm, int wn,
                                         long long m0, int n0, long long rows, int cols,
                                         const void* bias, int bias_fp32, const bf16* residual,
                                         bf16* y) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = scratch_all + warp * 16 * LDE;
  const int row = lane / 2, c8 = (lane % 2) * 8;
  const bool vec = cols % 8 == 0;
#pragma unroll
  for (int j = 0; j < WN / 16; ++j) {
    const int n = n0 + wn * WN + j * 16 + c8;
    float bv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) bv[e] = n + e < cols ? bias_at(bias, bias_fp32, n + e) : 0.f;
#pragma unroll
    for (int i = 0; i < WM / 16; ++i) {
      wmma::store_matrix_sync(scratch, acc.f[i][j], LDE, wmma::mem_row_major);
      __syncwarp();
      const long long m = m0 + wm * WM + i * 16 + row;
      if (m < rows && n < cols) {
        const float* src = scratch + row * LDE + c8;
        const size_t at = static_cast<size_t>(m) * cols + n;
        if (vec) {
          __align__(16) __nv_bfloat162 out[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            out[e] = __floats2bfloat162_rn(src[2 * e] + bv[2 * e], src[2 * e + 1] + bv[2 * e + 1]);
          if (residual != nullptr) {
            __align__(16) __nv_bfloat162 res[4];
            *reinterpret_cast<uint4*>(res) = *reinterpret_cast<const uint4*>(residual + at);
#pragma unroll
            for (int e = 0; e < 4; ++e) out[e] = __hadd2(out[e], res[e]);
          }
          *reinterpret_cast<uint4*>(y + at) = *reinterpret_cast<const uint4*>(out);
        } else {
          // a column count off the vector (the 3- and 4-channel conv outputs,
          // which take no residual): element by element
          for (int e = 0; e < 8 && n + e < cols; ++e)
            y[at + e] = __float2bfloat16(src[e] + bv[e]);
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace md_gemm
