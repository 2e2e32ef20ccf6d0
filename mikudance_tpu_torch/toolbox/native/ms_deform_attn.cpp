// Multi-scale deformable attention — C++ CPU forward kernel.
//
// The port's own copy of mikudance_tpu/toolbox/native/ms_deform_attn.cpp: a
// CPU counterpart of the reference XPose's only native component (the CUDA
// extension in models/UniPose/ops/; its CPU file is an unimplemented stub).
// Used host-side via ctypes and as a second implementation that the port's
// grid_sample form (toolbox/deformable.py) is held to.
//
// Semantics: sampling locations in [0,1] per level; bilinear sampling with
// align_corners=false and zero padding; output = sum over levels/points of
// attention_weight * sampled value.
//
// Build: g++ -O3 -shared -fPIC -o libmsda.so ms_deform_attn.cpp
// (toolbox/native/__init__.py builds it into build/native/ at first use)

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// value:   (B, S, H, D)        S = sum_l h_l*w_l
// shapes:  (L, 2) int64        (h_l, w_l)
// locs:    (B, Q, H, L, P, 2)  float  (x, y) in [0,1]
// weights: (B, Q, H, L, P)     float
// out:     (B, Q, H*D)         float
void msda_forward(
    const float* value, const int64_t* shapes,
    const float* locs, const float* weights, float* out,
    int64_t B, int64_t S, int64_t H, int64_t D,
    int64_t L, int64_t Q, int64_t P) {

  // level start offsets
  int64_t offsets[64];
  int64_t off = 0;
  for (int64_t l = 0; l < L; ++l) {
    offsets[l] = off;
    off += shapes[2 * l] * shapes[2 * l + 1];
  }

  std::memset(out, 0, sizeof(float) * B * Q * H * D);

  for (int64_t b = 0; b < B; ++b) {
    for (int64_t q = 0; q < Q; ++q) {
      for (int64_t hh = 0; hh < H; ++hh) {
        float* o = out + ((b * Q + q) * H + hh) * D;
        for (int64_t l = 0; l < L; ++l) {
          const int64_t lh = shapes[2 * l], lw = shapes[2 * l + 1];
          for (int64_t p = 0; p < P; ++p) {
            const int64_t li =
                ((((b * Q + q) * H + hh) * L + l) * P + p);
            const float w_attn = weights[li];
            const float x = locs[2 * li] * lw - 0.5f;
            const float y = locs[2 * li + 1] * lh - 0.5f;
            const int64_t x0 = (int64_t)floorf(x), y0 = (int64_t)floorf(y);
            const float dx = x - x0, dy = y - y0;
            const float cw[4] = {(1 - dx) * (1 - dy), dx * (1 - dy),
                                 (1 - dx) * dy, dx * dy};
            const int64_t xs[4] = {x0, x0 + 1, x0, x0 + 1};
            const int64_t ys[4] = {y0, y0, y0 + 1, y0 + 1};
            for (int c = 0; c < 4; ++c) {
              if (xs[c] < 0 || xs[c] >= lw || ys[c] < 0 || ys[c] >= lh)
                continue;
              const int64_t s_idx = offsets[l] + ys[c] * lw + xs[c];
              const float* v = value + ((b * S + s_idx) * H + hh) * D;
              const float wc = w_attn * cw[c];
              for (int64_t d = 0; d < D; ++d) o[d] += wc * v[d];
            }
          }
        }
      }
    }
  }
}

}  // extern "C"
