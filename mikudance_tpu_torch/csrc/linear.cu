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
// What bounds it on the card: at the chain's shapes (rows 294912 ... 4608,
// Cin and Cout 320 ... 10240) bytes and operations are of one order, e.g.
// (294912, 320 -> 2560) needs 0.5 ms either way, so x must come from device
// memory once. The TPU kernel keeps all of W on chip and walks the rows; 227
// KB of shared memory cannot hold a 1280 x 10240 weight, so the grid runs
// over (row tile, column tile) with the column tiles of one row tile
// adjacent in launch order: the row tile's x is read from device memory by
// the first of them and from the 50 MB L2 by the others. The TPU's resident-W
// limit (8 MB) is not carried over.
//
// The product is gemm_wg.cuh's warpgroup core; this file is its loader. Two
// 2-D tensor maps: x as (Cin, rows) in boxes of 64 x 128, and the weight, an
// nn.Linear (Cout, Cin), which is already the K-major right operand, read in
// place as (Cin, Cout) in boxes of 64 x NW (two boxes a k block at a tile of
// 320). TMA's zeros past Cin, rows and Cout stand in for every mask of the k
// loop.

#include "gemm_wg.cuh"

using namespace md_wg;

namespace {

struct RowLoader {
  const CUtensorMap *x, *w;
  long long rows;
  int m0, k_blocks_;

  __device__ int k_blocks() const { return k_blocks_; }
  __device__ void load_a(int kb, uint32_t dst, uint32_t bar) const {
    tma_load(dst, x, bar, kb * BK, m0);
  }
  __device__ void load_b(int kb, int n, uint32_t dst, uint32_t bar) const {
    tma_load(dst, w, bar, kb * BK, n);
  }
  __device__ long long row(int r) const { return m0 + r < rows ? m0 + r : -1; }
};

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
linear_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
              const void* bias, int bias_fp32, const bf16* residual, bf16* __restrict__ y,
              long long rows, int cin, int cout, int col_tiles) {
  const int m0 = blockIdx.x / col_tiles * BM;
  const int n0 = blockIdx.x % col_tiles * BN;
  const RowLoader ld{&tm_x, &tm_w, rows, m0, (cin + BK - 1) / BK};
  gemm_tile<BN>(ld, Out{y, bias, residual, n0, cout, bias_fp32});
}

template <int BN>
cudaError_t launch(const void* x, const void* w, const void* bias, const void* residual, void* y,
                   long long rows, int cin, int cout, int bias_fp32, cudaStream_t stream) {
  auto kern = linear_kernel<BN>;
  cudaError_t err = allow_smem<BN>(kern);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_x, tm_w;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(rows)};
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(cout)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cin) * 2};
  const cuuint32_t x_box[2] = {BK, BM}, w_box[2] = {BK, Plan<BN>::NW};
  if (!tensor_map(&tm_x, x, 2, x_dims, strides, x_box) ||
      !tensor_map(&tm_w, w, 2, w_dims, strides, w_box))
    return cudaErrorInvalidValue;
  const int col_tiles = (cout + BN - 1) / BN;
  const long long tiles = (rows + BM - 1) / BM * col_tiles;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(tiles), kThreads, Plan<BN>::bytes, stream>>>(
      tm_x, tm_w, bias, bias_fp32, static_cast<const bf16*>(residual), static_cast<bf16*>(y),
      rows, cin, cout, col_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (rows, cin), w (cout, cin), residual / y (rows, cout): bf16, contiguous,
// 16-byte aligned (TMA's rule for the base and the row stride); cin and cout
// multiples of 8. bias (cout,) bf16 or fp32, or null; residual may be null.
// bn: the tile width (320, 256, 160 or 128) the wrapper's plan picked.
int md_linear(const void* x, const void* w, const void* bias, const void* residual, void* y,
              long long rows, int cin, int cout, int bias_fp32, int bn, void* stream) {
  // TMA's coordinates are 32-bit: a row tile starts below 2^31
  if (rows < 1 || rows > 0x7fffffffLL - BM || cin < 8 || cout < 8 || cin % 8 || cout % 8)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 320: return launch<320>(x, w, bias, residual, y, rows, cin, cout, bias_fp32, s);
    case 256: return launch<256>(x, w, bias, residual, y, rows, cin, cout, bias_fp32, s);
    case 160: return launch<160>(x, w, bias, residual, y, rows, cin, cout, bias_fp32, s);
    case 128: return launch<128>(x, w, bias, residual, y, rows, cin, cout, bias_fp32, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
