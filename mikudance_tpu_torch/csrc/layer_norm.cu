// Row LayerNorm over the last axis, hand-written for Hopper (sm_90a).
//
//   K6 md_layer_norm  replaces mikudance_tpu/kernels/layer_norm.py _ln_kernel
//      (:51). x is (rows, C), bf16 or fp32; per row the mean, then the centred
//      variance, in fp32 from the row held on chip; y = (x - mean) *
//      rsqrt(var + eps) * w + b, cast to x's type.
//
// What bounds it on the card: memory, one read and one write of x. The
// design: a row is taken by a group of L lanes (8, 16 or 32, aligned within
// the warp), chosen by the wrapper (kernels/layer_norm.py::lane_plan) so that
// each lane holds whole 16-byte vectors: width 320 in bf16 is 40 vectors,
// 8 lanes of 5; 640 is 16 lanes of 5; 1280 32 of 5; 1024 32 of 4. The row
// stays in registers, so x is read from device memory once and both
// statistics passes run on registers (the TPU kernel holds a block of rows
// in VMEM for the same reason); sums cross the group by shuffles with
// offsets under L. A vector count that no L divides is taken by 32 lanes
// with a masked tail. One lane group takes one row; a block of 8 warps
// takes 8 x (32 / L) rows and the grid covers the rows once (more warps in
// flight than a grid-stride loop over rows with w and b staged, which moved
// fewer bytes a second on an H100). A lane loads its vectors before it uses
// any and keeps them as stored (20 registers for 5 vectors), converting as
// it reads; w and b (2C values, resident in L1) are read as vectors where
// they are used. A warp leaves only as a whole, so every lane reaches every
// shuffle; rows past the end are masked.

#include "norm_core.cuh"

using namespace md_norm;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVectorsPerLane = 10;
constexpr int kMaxWidth = 1280;

// T: x's type; P: w's and b's; VPL: vectors a lane holds at most. A lane of
// group sub takes the row's vectors sub, sub + L, ... below nv = C / V.
template <typename T, typename P, int VPL>
__global__ void __launch_bounds__(kThreads)
ln_kernel(const T* __restrict__ x, const P* __restrict__ w, const P* __restrict__ b,
          T* __restrict__ y, long long rows, int C, int L, float eps) {
  constexpr int V = Vec16<T>::N;
  const int lane = threadIdx.x % 32, sub = lane % L, nv = C / V;
  const long long first = ((long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32) * (32 / L);
  if (first >= rows) return;  // whole warps
  const long long row = first + lane / L;
  const bool live = row < rows;
  uint4 raw[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int j = k * L + sub;
    raw[k] = live && j < nv ? load_raw16(x + row * C + j * V) : make_uint4(0u, 0u, 0u, 0u);
  }
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    float v[V];
    unpack(raw[k], v);
#pragma unroll
    for (int i = 0; i < V; ++i) sum += v[i];
  }
  const float mean = group_sum(sum, L) / (float)C;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    if (k * L + sub < nv) {
      float v[V];
      unpack(raw[k], v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = v[i] - mean;
        sq = fmaf(d, d, sq);
      }
    }
  }
  const float inv = rsqrtf(group_sum(sq, L) / (float)C + eps);
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int j = k * L + sub;
    if (live && j < nv) {
      float v[V], wv[V], bv[V];
      unpack(raw[k], v);
      load_params<V>(w, j * V, wv);
      load_params<V>(b, j * V, bv);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = affine<false>((v[i] - mean) * inv, wv[i], bv[i]);
      store16(y + row * C + j * V, v);
    }
  }
}

template <typename T, typename P, int VPL>
int launch(const void* x, const void* w, const void* b, void* y, long long rows, int C, int L,
           float eps, cudaStream_t stream) {
  const long long rows_a_block = (long long)(kThreads / 32) * (32 / L);
  const unsigned grid = (unsigned)((rows + rows_a_block - 1) / rows_a_block);
  ln_kernel<T, P, VPL><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const P*>(w), static_cast<const P*>(b),
      static_cast<T*>(y), rows, C, L, eps);
  return cudaGetLastError();
}

template <typename T, typename P>
int by_vectors(const void* x, const void* w, const void* b, void* y, long long rows, int C,
               int L, int vpl, float eps, cudaStream_t s) {
  switch (vpl) {  // the wrapper rounds a lane's vectors up to one of these
    case 1: return launch<T, P, 1>(x, w, b, y, rows, C, L, eps, s);
    case 2: return launch<T, P, 2>(x, w, b, y, rows, C, L, eps, s);
    case 4: return launch<T, P, 4>(x, w, b, y, rows, C, L, eps, s);
    case 5: return launch<T, P, 5>(x, w, b, y, rows, C, L, eps, s);
    case 8: return launch<T, P, 8>(x, w, b, y, rows, C, L, eps, s);
    case 10: return launch<T, P, 10>(x, w, b, y, rows, C, L, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x, y: (rows, C) contiguous, bf16 (x_fp32 = 0) or fp32, 16-byte aligned;
// w, b: (C,) fp32 (w_fp32 = 1) or bf16, 16-byte aligned. The wrapper
// guarantees C a multiple of the 16-byte vector, rows >= 1, and picks the
// lanes a row L (8, 16 or 32) and the vectors a lane vpl (1, 2, 4, 5, 8 or
// 10) with L * vpl * vector >= C.
int md_layer_norm(const void* x, const void* w, const void* b, void* y, long long rows, int C,
                  int L, int vpl, float eps, int x_fp32, int w_fp32, void* stream) {
  const int vec = x_fp32 ? 4 : 8;
  if (C % vec != 0 || C > kMaxWidth || rows < 1 || (L != 8 && L != 16 && L != 32) || vpl < 1 ||
      vpl > kMaxVectorsPerLane || (long long)L * vpl * vec < C ||
      (rows + kThreads / 32 - 1) / (kThreads / 32) > 2147483647LL)  // blocks of 8 rows at least
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_fp32)
    return w_fp32 ? by_vectors<float, float>(x, w, b, y, rows, C, L, vpl, eps, s)
                  : by_vectors<float, bf16>(x, w, b, y, rows, C, L, vpl, eps, s);
  return w_fp32 ? by_vectors<bf16, float>(x, w, b, y, rows, C, L, vpl, eps, s)
                : by_vectors<bf16, bf16>(x, w, b, y, rows, C, L, vpl, eps, s);
}

}  // extern "C"
