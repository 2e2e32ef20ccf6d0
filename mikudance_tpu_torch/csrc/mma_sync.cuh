// Warp-level tensor-core primitives for the kernels that keep their tiles in
// registers (flash_wide.cu, flash_cross.cu; flash_anchor_wg.cu takes the
// exponential and the bf16 packing), for Hopper (sm_90a).
//
// mma.sync m16n8k16, bf16 in, fp32 accumulate. With g = lane / 4 and
// c = lane % 4 a lane holds:
//   A (16 x 16, row-major) a[0] = rows g, cols 2c..2c+1; a[1] = rows g + 8;
//     a[2] = row g, cols 2c + 8..; a[3] = row g + 8, cols 2c + 8..
//   B (16 x 8, k x n)      b0 = k rows 2c..2c+1 of col g; b1 = k rows 2c + 8..
//   C (16 x 8, fp32)       d[0..1] = row g, cols 2c..2c+1; d[2..3] = row g + 8.
// Two C tiles side by side (16 x 16) are, packed to bf16 pairs, the A operand
// of the next product: d[0..1], d[2..3] of the left tile are a[0], a[1], those
// of the right tile a[2], a[3]. Every bf16 pair keeps the lower column in the
// lower 16 bits.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace md_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and r[i] receives its lane's pair of matrix i (row lane / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// The same, each matrix transposed: r[i] holds rows 2c..2c+1 of column g.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// Two matrices, transposed; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// d += A B on one m16n8k16 tile
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to bf16 and packed, lo in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
// the two bf16 of a packed pair, back in fp32 (exact)
__device__ __forceinline__ float bf16_lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

}  // namespace md_mma
