// 3x3 stride-1 SAME convolution on NHWC, hand-written for Hopper (sm_90a).
//
//   K8 md_conv3x3  replaces mikudance_tpu/kernels/conv2d.py _conv3_kernel (:46):
//      y = bf16(conv3x3(x, w) + b) as an implicit GEMM over the nine taps, the
//      stride-1 3x3 convolutions of the UNets' resnet blocks and samplers, MAN,
//      the SD VAE and the temporal decoder. fp32 accumulation, bias added in
//      fp32, one rounding.
//
// x is (N, H, W, Cin) bf16; the weight comes repacked as (3, 3, Cout, Cin)
// (taps outermost, Cin contiguous), so that for each tap the right operand is
// a (Cout, Cin) row-major matrix exactly as in md_linear.
//
// What bounds it on the card: operations (9 Cin multiply-adds an output
// element against 2 bytes read and written), so the limit is how well the
// tensor cores are fed. The output is cut into tiles of 128 consecutive pixels
// (over n, y, x) by 128 output channels. The k loop walks tap by tap and, in a
// tap, Cin in slices of BK: a pixel's slice of the left operand is a run of
// its neighbour's channels at that tap, copied by cp.async straight from x, or
// zeros where the neighbour lies outside the picture. No padded copy of x
// exists in device memory (the TPU kernel pads x there first), any Cin that
// is a multiple of 8 is taken slice by slice (2560 on the UNet's up path),
// and every offset is 64-bit ((8, 768, 768, 128) has 6e8 elements). Column
// tiles of one pixel tile are adjacent in launch order, so the halo rows and
// the other column tiles' reads of x come from L2. Tile plan and epilogue:
// gemm_tile.cuh.

#include "gemm_tile.cuh"

using namespace md_gemm;

namespace {

__global__ void __launch_bounds__(kThreads, 2)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp, const void* bias,
               int bias_fp32, bf16* __restrict__ y, long long pixels, int height, int width,
               int cin, int cout, int col_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const long long tile = blockIdx.x;
  const long long m0 = tile / col_tiles * BM;
  const int n0 = static_cast<int>(tile % col_tiles) * BN;

  // this thread's copies of a slice: pixels r0, r0 + kCopyRows, ... of the
  // tile (and the same rows of the weight tile), channels [ck, ck + 8) of the
  // slice. Per pixel: which of the nine neighbours exist.
  const int r0 = tid / kChunks, ck = (tid % kChunks) * 8;
  unsigned taps[kCopies];
#pragma unroll
  for (int h = 0; h < kCopies; ++h) {
    const long long m = m0 + r0 + kCopyRows * h;
    taps[h] = 0;
    if (m < pixels) {
      const int px = static_cast<int>(m % width);
      const int py = static_cast<int>(m / width % height);
      for (int t = 0; t < 9; ++t) {
        const int yy = py + t / 3 - 1, xx = px + t % 3 - 1;
        if (yy >= 0 && yy < height && xx >= 0 && xx < width) taps[h] |= 1u << t;
      }
    }
  }
  const int slices = (cin + BK - 1) / BK;  // per tap
  auto load = [&](int stage, int kt) {
    bf16* a_s = ring + stage * kStageElems;
    bf16* b_s = a_s + kTileElems;
    const int tap = kt / slices;
    const int c = (kt - tap * slices) * BK + ck;
    const bool c_ok = c < cin;
    const long long shift = static_cast<long long>(tap / 3 - 1) * width + (tap % 3 - 1);
#pragma unroll
    for (int h = 0; h < kCopies; ++h) {
      const int r = r0 + kCopyRows * h;
      const bool a_ok = c_ok && (taps[h] >> tap & 1u);
      const long long m = m0 + r + shift;  // the neighbour, in the same picture when a_ok
      cp_async16(a_s + r * LDT + ck, a_ok ? x + static_cast<size_t>(m) * cin + c : x, a_ok);
      const int n = n0 + r;
      const bool b_ok = c_ok && n < cout;
      cp_async16(b_s + r * LDT + ck,
                 b_ok ? wp + (static_cast<size_t>(tap) * cout + n) * cin + c : wp, b_ok);
    }
  };

  Acc acc;
  main_loop(acc, ring, 9 * slices, wm, wn, load);
  epilogue(acc, reinterpret_cast<float*>(smem), wm, wn, m0, n0, pixels, cout, bias, bias_fp32,
           nullptr, y);
}

}  // namespace

extern "C" {

// x (images, height, width, cin) and y (images, height, width, cout): bf16,
// contiguous NHWC, 16-byte aligned; wp (3, 3, cout, cin) bf16 contiguous;
// cin a multiple of 8; bias (cout,) bf16 or fp32, or null.
int md_conv3x3(const void* x, const void* wp, const void* bias, void* y, int images, int height,
               int width, int cin, int cout, int bias_fp32, void* stream) {
  if (images < 1 || height < 1 || width < 1 || cin < 8 || cin % 8 || cout < 1)
    return cudaErrorInvalidValue;
  const long long pixels = static_cast<long long>(images) * height * width;
  const int col_tiles = (cout + BN - 1) / BN;
  const long long tiles = (pixels + BM - 1) / BM * col_tiles;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  conv3x3_kernel<<<static_cast<unsigned>(tiles), kThreads, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wp), bias, bias_fp32,
      static_cast<bf16*>(y), pixels, height, width, cin, cout, col_tiles);
  return cudaGetLastError();
}

}  // extern "C"
