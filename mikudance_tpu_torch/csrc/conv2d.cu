// 3x3 stride-1 SAME convolution on NHWC, hand-written for Hopper (sm_90a).
//
//   K8 md_conv3x3  replaces mikudance_tpu/kernels/conv2d.py _conv3_kernel (:46):
//      y = bf16(conv3x3(x, w) + b) as an implicit GEMM over the nine taps, the
//      stride-1 3x3 convolutions of the UNets' resnet blocks and samplers, MAN,
//      the SD VAE and the temporal decoder. fp32 accumulation, bias added in
//      fp32, one rounding.
//
// x is (N, H, W, Cin) bf16 with W a multiple of 8; the weight comes repacked
// as (3, 3, Cout, Cin) (taps outermost, Cin contiguous), so that for each tap
// the right operand is a (Cout, Cin) K-major matrix exactly as in md_linear.
//
// What bounds it on the card: operations (9 Cin multiply-adds an output
// element against 2 bytes read and written), so the limit is how well the
// tensor cores are fed. The product is gemm_wg.cuh's warpgroup core; this
// file is its loader.
//   An output tile is 128 pixels by BN output channels: a Wb x Hb rectangle
//   of Nb = 128 / (Wb Hb) consecutive images, as the TPU kernel tiles by image
//   rows. Wb is the largest of 64, 32, 16, 8 that divides W; Hb (a power of
//   two) and Nb are picked by the wrapper to waste the fewest rows where H
//   or N is not a multiple (24 x 24 maps take 8 x 8 x 2 boxes, not 8 x 16).
//   x is a 4-D tensor map (Cin, W, H, N). For tap (dy, dx) and channel block
//   c0 the left operand is one box (64, Wb, Hb, Nb) at (c0, x0 + dx - 1,
//   y0 + dy - 1, n0): it lands as 128 pixel rows of 128 bytes, 128-byte
//   swizzled, the K-major A operand as it stands. TMA's zeros for coordinates
//   out of range (negative ones included) are the SAME padding: no mask, no
//   padded copy of x (the TPU kernel pads x in device memory first), and a
//   box at an image's border reads zeros, never the next image (the map's
//   rows end with each image).
//   The weight is a 3-D map (Cin, Cout, 9), boxes (64, NW, 1): a box past
//   Cout reads zeros, never the next tap's rows (which a 2-D (Cin, 9 Cout)
//   map would).
//   The k loop walks 9 taps x ceil(Cin / 64) channel blocks; TMA zero-fills
//   channels past Cin in both operands. The epilogue maps tile row m to pixel
//   (n0 + m / (Wb Hb), y0 + m / Wb % Hb, x0 + m % Wb) and drops rows past H
//   or N; its offsets are 64-bit ((8, 768, 768, 128) has 6e8 elements).

#include "gemm_wg.cuh"

using namespace md_wg;

namespace {

struct TapLoader {
  const CUtensorMap *x, *w;
  int image0, y0, x0, c_blocks, images, height, width, wb_log2, hb_log2;

  __device__ int k_blocks() const { return 9 * c_blocks; }
  __device__ void load_a(int kb, uint32_t dst, uint32_t bar) const {
    const int tap = kb / c_blocks, c0 = (kb - tap * c_blocks) * BK;
    tma_load(dst, x, bar, c0, x0 + tap % 3 - 1, y0 + tap / 3 - 1, image0);
  }
  __device__ void load_b(int kb, int n, uint32_t dst, uint32_t bar) const {
    const int tap = kb / c_blocks, c0 = (kb - tap * c_blocks) * BK;
    tma_load(dst, w, bar, c0, n, tap);
  }
  __device__ long long row(int r) const {
    const int image = image0 + (r >> (wb_log2 + hb_log2));
    const int yy = y0 + ((r >> wb_log2) & ((1 << hb_log2) - 1));
    const int xx = x0 + (r & ((1 << wb_log2) - 1));
    return image < images && yy < height
               ? (static_cast<long long>(image) * height + yy) * width + xx
               : -1;
  }
};

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
               const void* bias, int bias_fp32, bf16* __restrict__ y, int images, int height,
               int width, int cin, int cout, int col_tiles, int wb_log2, int hb_log2) {
  const int tile = blockIdx.x / col_tiles;
  const int n0 = blockIdx.x % col_tiles * BN;
  const int tiles_x = width >> wb_log2, tiles_y = (height + (1 << hb_log2) - 1) >> hb_log2;
  const int in_image = tile % (tiles_x * tiles_y);
  const int image0 = tile / (tiles_x * tiles_y) * (BM >> (wb_log2 + hb_log2));
  const TapLoader ld{&tm_x, &tm_w, image0, in_image / tiles_x << hb_log2,
                     in_image % tiles_x << wb_log2, (cin + BK - 1) / BK, images, height, width,
                     wb_log2, hb_log2};
  gemm_tile<BN>(ld, Out{y, bias, nullptr, n0, cout, bias_fp32});
}

template <int BN>
cudaError_t launch(const void* x, const void* wp, const void* bias, void* y, int images,
                   int height, int width, int cin, int cout, int bias_fp32, int wb_log2,
                   int hb_log2, cudaStream_t stream) {
  auto kern = conv3x3_kernel<BN>;
  cudaError_t err = allow_smem<BN>(kern);
  if (err != cudaSuccess) return err;
  const int wb = 1 << wb_log2, hb = 1 << hb_log2, nb = BM / (wb * hb);
  CUtensorMap tm_x, tm_w;
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(width),
                                static_cast<cuuint64_t>(height),
                                static_cast<cuuint64_t>(images)};
  const cuuint64_t x_strides[3] = {static_cast<cuuint64_t>(cin) * 2,
                                   static_cast<cuuint64_t>(width) * cin * 2,
                                   static_cast<cuuint64_t>(height) * width * cin * 2};
  const cuuint32_t x_box[4] = {BK, static_cast<cuuint32_t>(wb), static_cast<cuuint32_t>(hb),
                               static_cast<cuuint32_t>(nb)};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(cout), 9};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(cin) * 2,
                                   static_cast<cuuint64_t>(cout) * cin * 2};
  const cuuint32_t w_box[3] = {BK, Plan<BN>::NW, 1};
  if (!tensor_map(&tm_x, x, 4, x_dims, x_strides, x_box) ||
      !tensor_map(&tm_w, wp, 3, w_dims, w_strides, w_box))
    return cudaErrorInvalidValue;
  const int col_tiles = (cout + BN - 1) / BN;
  const long long tiles = static_cast<long long>((images + nb - 1) / nb) * (width / wb) *
                          ((height + hb - 1) / hb) * col_tiles;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(tiles), kThreads, Plan<BN>::bytes, stream>>>(
      tm_x, tm_w, bias, bias_fp32, static_cast<bf16*>(y), images, height, width, cin, cout,
      col_tiles, wb_log2, hb_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (images, height, width, cin) and y (images, height, width, cout): bf16,
// contiguous NHWC, 16-byte aligned; wp (3, 3, cout, cin) bf16 contiguous,
// 16-byte aligned; cin a multiple of 8 (TMA's 16-byte row stride); bias
// (cout,) bf16 or fp32, or null. The tile plan the wrapper picked: bn (320,
// 256, 160 or 128) output channels by a box of wb (64, 32, 16 or 8, dividing
// width) x hb (a power of two, wb hb <= 128) pixels of 128 / (wb hb) images.
int md_conv3x3(const void* x, const void* wp, const void* bias, void* y, int images, int height,
               int width, int cin, int cout, int bias_fp32, int bn, int wb, int hb,
               void* stream) {
  if (images < 1 || height < 1 || width < 1 || cin < 8 || cin % 8 || cout < 1 || wb < 8 ||
      wb > 64 || (wb & (wb - 1)) || width % wb || hb < 1 || (hb & (hb - 1)) || wb * hb > BM)
    return cudaErrorInvalidValue;
  const int wl = __builtin_ctz(wb), hl = __builtin_ctz(hb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 320:
      return launch<320>(x, wp, bias, y, images, height, width, cin, cout, bias_fp32, wl, hl, s);
    case 256:
      return launch<256>(x, wp, bias, y, images, height, width, cin, cout, bias_fp32, wl, hl, s);
    case 160:
      return launch<160>(x, wp, bias, y, images, height, width, cin, cout, bias_fp32, wl, hl, s);
    case 128:
      return launch<128>(x, wp, bias, y, images, height, width, cin, cout, bias_fp32, wl, hl, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
