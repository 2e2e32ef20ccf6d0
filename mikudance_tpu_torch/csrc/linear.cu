// Row-major fused linear, hand-written for Hopper (sm_90a).
//
//   K7 md_linear  replaces mikudance_tpu/kernels/linear.py _linear_kernel (:48)
//      and _linear_res_kernel (:56): y = bf16(x W^T + b) [+ residual] on token
//      rows, the products of the transformer block's row-major chain
//      (q / k / v / to_out, the cross-attention q and to_out, the GEGLU pair).
//      The sum runs in fp32, the bias is added in fp32, the result is rounded
//      to bf16 once and the residual is then added in bf16: two roundings, in
//      the TPU kernel's order.
//
// x is (rows, Cin) bf16 row-major; w is an nn.Linear weight (Cout, Cin)
// row-major, which is W^T k-contiguous: the right operand is read in place.
//
// What bounds it on the card: at the chain's shapes (rows 294912 ... 4608,
// Cin and Cout 320 ... 10240) bytes and operations are of one order, e.g.
// (294912, 320 -> 2560) needs 0.5 ms either way, so x must come from device
// memory once. The TPU kernel keeps all of W on chip and walks the rows; 227
// KB of shared memory cannot hold a 1280 x 10240 weight, so the grid runs
// over (row tile, column tile) with the column tiles of one row tile
// adjacent in launch order: the row tile's x is read from device memory by
// the first of them and from the 50 MB L2 by the others. The TPU's resident-W
// limit (8 MB) is not carried over. Tile plan and epilogue: gemm_tile.cuh.

#include "gemm_tile.cuh"

using namespace md_gemm;

namespace {

__global__ void __launch_bounds__(kThreads, 2)
linear_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, const void* bias,
              int bias_fp32, const bf16* residual, bf16* __restrict__ y, long long rows, int cin,
              int cout, int col_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const long long tile = blockIdx.x;
  const long long m0 = tile / col_tiles * BM;
  const int n0 = static_cast<int>(tile % col_tiles) * BN;

  // this thread's copies of a slice: rows r0, r0 + kCopyRows, ... of each
  // operand, elements [ck, ck + 8) of the slice
  const int r0 = tid / kChunks, ck = (tid % kChunks) * 8;
  auto load = [&](int stage, int kt) {
    bf16* a_s = ring + stage * kStageElems;
    bf16* b_s = a_s + kTileElems;
    const int k = kt * BK + ck;
    const bool k_ok = k < cin;
#pragma unroll
    for (int h = 0; h < kCopies; ++h) {
      const int r = r0 + kCopyRows * h;
      const long long m = m0 + r;
      const bool a_ok = k_ok && m < rows;
      cp_async16(a_s + r * LDT + ck, a_ok ? x + static_cast<size_t>(m) * cin + k : x, a_ok);
      const int n = n0 + r;
      const bool b_ok = k_ok && n < cout;
      cp_async16(b_s + r * LDT + ck, b_ok ? w + static_cast<size_t>(n) * cin + k : w, b_ok);
    }
  };

  Acc acc;
  main_loop(acc, ring, (cin + BK - 1) / BK, wm, wn, load);
  epilogue(acc, reinterpret_cast<float*>(smem), wm, wn, m0, n0, rows, cout, bias, bias_fp32,
           residual, y);
}

}  // namespace

extern "C" {

// x (rows, cin), w (cout, cin), residual / y (rows, cout): bf16, contiguous,
// 16-byte aligned; cin and cout multiples of 8. bias (cout,) bf16 or fp32, or
// null; residual may be null.
int md_linear(const void* x, const void* w, const void* bias, const void* residual, void* y,
              long long rows, int cin, int cout, int bias_fp32, void* stream) {
  if (rows < 1 || cin < 8 || cout < 8 || cin % 8 || cout % 8) return cudaErrorInvalidValue;
  const int col_tiles = (cout + BN - 1) / BN;
  const long long tiles = (rows + BM - 1) / BM * col_tiles;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(linear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return err;
  linear_kernel<<<static_cast<unsigned>(tiles), kThreads, kSmemBytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias, bias_fp32,
      static_cast<const bf16*>(residual), static_cast<bf16*>(y), rows, cin, cout, col_tiles);
  return cudaGetLastError();
}

}  // extern "C"
