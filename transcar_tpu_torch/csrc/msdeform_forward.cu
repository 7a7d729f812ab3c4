// Multi-scale deformable attention forward (K7), float32 throughout.
//
// Replaces transcar_tpu/ops/pallas_msdeform.py::_enc_pair (the Pallas
// _enc_kernel).  The wrapper, the bound and the design are described in
// transcar_tpu_torch/ops/pallas_msdeform.py.
//
//   out[b, q, h*D + d] = sum_{l,p} a[b,q,h,l,p] *
//                        bilinear(value_l[b, :, :, h, d], loc[b,q,h,l,p])
//
// with grid_sample(align_corners=False) coordinates, x = u * W_l - 0.5,
// y = v * H_l - 0.5, and zero padding.  Layouts (contiguous float32):
// value [B, S, H, D], loc [B, Q, H, L, P, 2] (x, y), attn [B, Q, H, L, P],
// out [B, Q, H, D].  One warp per (b, q, h); lane i holds channels
// d = i, i + 32, ...; every tap is one coalesced read of D floats.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 8;          // warps per block

struct Levels {
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
};

__global__ void __launch_bounds__(32 * kWarps)
msdeform_forward_kernel(const float* __restrict__ value,
                        const float* __restrict__ loc,
                        const float* __restrict__ attn,
                        float* __restrict__ out, Levels lv, long long items,
                        int S, int Q, int H, int D, int L, int P) {
  const long long item = static_cast<long long>(blockIdx.x) * kWarps
                         + (threadIdx.x >> 5);             // (b, q, h)
  if (item >= items) return;                 // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int h = static_cast<int>(item % H);
  const long long b = item / H / Q;
  const long long row = static_cast<long long>(H) * D;      // token stride
  const float* vb = value + b * S * row + static_cast<long long>(h) * D;
  const float2* loc_i = reinterpret_cast<const float2*>(loc) + item * L * P;
  const float* att_i = attn + item * L * P;
  float* out_i = out + item * D;

  for (int d = lane; d - lane < D; d += 32) {
    const bool active = d < D;
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l >= L) break;
      const int hl = lv.h[l], wl = lv.w[l];
      const float* vl = vb + lv.start[l] * row + d;
      for (int p = 0; p < P; ++p) {
        const float2 uv = __ldg(loc_i + l * P + p);       // warp broadcast
        const float a = __ldg(att_i + l * P + p);
        // the plain version's rounding: one multiply, then one subtract
        const float x = __fsub_rn(__fmul_rn(uv.x, static_cast<float>(wl)),
                                  0.5f);
        const float y = __fsub_rn(__fmul_rn(uv.y, static_cast<float>(hl)),
                                  0.5f);
        if (!(isfinite(x) && isfinite(y))) {
          acc += __int_as_float(0x7fc00000);   // NaN, as the plain version
          continue;
        }
        const float x0 = floorf(x), y0 = floorf(y);
        const float tx = x - x0, ty = y - y0;
        // validity in float, and indices from clamped values: a far-off
        // location forms no out-of-range int
        const bool vx0 = active && x0 >= 0.f && x0 <= wl - 1.f;
        const bool vx1 = active && x0 >= -1.f && x0 <= wl - 2.f;
        const bool vy0 = y0 >= 0.f && y0 <= hl - 1.f;
        const bool vy1 = y0 >= -1.f && y0 <= hl - 2.f;
        const int ix = static_cast<int>(fminf(fmaxf(x0, -1.f), wl));
        const int iy = static_cast<int>(fminf(fmaxf(y0, -1.f), hl));
        float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;
        const long long t00 = (static_cast<long long>(iy) * wl + ix) * row;
        const long long t10 = t00 + wl * row;
        if (vy0 && vx0) v00 = __ldg(vl + t00);
        if (vy0 && vx1) v01 = __ldg(vl + t00 + row);
        if (vy1 && vx0) v10 = __ldg(vl + t10);
        if (vy1 && vx1) v11 = __ldg(vl + t10 + row);
        const float s = v00 * ((1.f - ty) * (1.f - tx))
                        + v01 * ((1.f - ty) * tx)
                        + v10 * (ty * (1.f - tx))
                        + v11 * (ty * tx);
        acc = fmaf(a, s, acc);     // a off-map sample still meets a, as
                                   // in the plain version (0 · NaN = NaN)
      }
    }
    if (active) out_i[d] = acc;
  }
}

}  // namespace

extern "C" int msdeform_forward_f32(const void* value, const void* loc,
                                    const void* attn, void* out, int B,
                                    int S, int Q, int H, int D, int L, int P,
                                    const int* level_h, const int* level_w,
                                    const int* level_start, void* stream) {
  if (L < 1 || L > kMaxLevels || P < 1 || D < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{};
  for (int l = 0; l < L; ++l) {
    lv.h[l] = level_h[l];
    lv.w[l] = level_w[l];
    lv.start[l] = level_start[l];
  }
  const long long items = static_cast<long long>(B) * Q * H;
  if (items == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (items + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  msdeform_forward_kernel<<<static_cast<unsigned>(blocks), 32 * kWarps, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<float*>(out), lv, items,
      S, Q, H, D, L, P);
  return static_cast<int>(cudaGetLastError());
}
