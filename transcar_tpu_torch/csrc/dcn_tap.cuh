// The bilinear taps of a DCNv2 3x3 / stride 1 / pad 1 / dilation 1 conv,
// shared by K1 (dcn_forward.cu) and K3 (dcn_backward.cu).
//
// With p = (n*H + i)*W + j and tap k = 3r + c, the sample sits at
// (py, px) = (i - 1 + r + dy_k, j - 1 + c + dx_k) with dy_k = om[p, 2k],
// dx_k = om[p, 2k+1] and the mask sigmoid(om[p, 18+k]); all of it in
// float32.  Its four corners (y0 + {0,1}, x0 + {0,1}), y0 = floor(py),
// carry the weights (1-fy or fy) * (1-fx or fx); a corner outside the image
// is padding (offset -1, weight 0).
#pragma once

#include <cuda_bf16.h>

#include <cstddef>

namespace dcn {

// One (pixel, tap): four corners as pixel indices into x (-1 = outside
// the image), their bilinear weights without the mask, the mask
// sigmoid(m) and the fractions (fy, fx) of the sample position.
struct Tap {
  int off[4];
  float w[4];
  float sig, fy, fx;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ Tap make_tap(const T* __restrict__ om, int p, int k,
                                        int H, int W) {
  Tap t;
  const int HW = H * W;
  const int n = p / HW, r = p - n * HW, i = r / W, j = r - i * W;
  const T* o = om + static_cast<size_t>(p) * 27;
  const float py = static_cast<float>(i - 1 + k / 3) + to_float(o[2 * k]);
  const float px = static_cast<float>(j - 1 + k % 3) + to_float(o[2 * k + 1]);
  t.sig = 1.f / (1.f + expf(-to_float(o[18 + k])));
  const float y0f = floorf(py), x0f = floorf(px);
  t.fy = py - y0f;
  t.fx = px - x0f;
  const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
  const float wy[2] = {1.f - t.fy, t.fy};
  const float wx[2] = {1.f - t.fx, t.fx};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int yy = y0 + (c >> 1), xx = x0 + (c & 1);
    const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
    t.off[c] = in ? (n * H + yy) * W + xx : -1;
    t.w[c] = in ? wy[c >> 1] * wx[c & 1] : 0.f;
  }
  return t;
}

__device__ __forceinline__ Tap empty_tap() {
  Tap t;
#pragma unroll
  for (int c = 0; c < 4; ++c) { t.off[c] = -1; t.w[c] = 0.f; }
  t.sig = t.fy = t.fx = 0.f;
  return t;
}

}  // namespace dcn
