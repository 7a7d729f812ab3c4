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
// out [B, Q, H, D].
//
// Two kernels:
// - msdeform_forward_group_kernel, for D % 8 == 0, D <= 64 and 16-byte
//   aligned value and out (the pillar head's D = 32): one lane group per
//   query (msdeform_gather.cuh; G = 4 lanes of 8 channels for D = 32, so
//   a warp holds 8 neighbouring queries of one (batch, head)).  The warp
//   walks the queries' L * P samples together, level by level, R samples
//   a group in flight (8 a warp): it issues the 16-byte loads
//   of every corner row of those samples first, then adds a * sum_corner
//   w_corner v_corner into 8 accumulators a lane, in the first kernel's
//   (level, point) order and with its expression, and stores the query's
//   output row as V float4 a lane; no sum across lanes.  A block holds
//   kGroupWarps such runs of one head, head fastest.
// - msdeform_forward_kernel, for other D: one warp per (b, q, h); lane i
//   holds channels d = i, i + 32, ...; every tap is one coalesced read of
//   D floats.

#include <cuda_runtime.h>

#include <cstdint>

#include "msdeform_gather.cuh"

namespace {

using msd::corners;
using msd::Corners;
using msd::kMaxLevels;
using msd::Levels;
using msd::make_levels;

constexpr int kWarps = 8;          // warps per block

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

constexpr int kGroupWarps = 4;     // warps per block of the group kernel
constexpr int kGroupMaxD = 64;

// One channel of a sample: the first kernel's expression, so that the
// compiler contracts it into the same multiply and three fused adds.
__device__ __forceinline__ float bilinear(float v00, float v01, float v10, float v11,
                                          float w00, float w01, float w10, float w11) {
  return v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11;
}

// K7 with one lane group of G lanes per query (V float4 chunks a lane): a
// warp owns 32 / G neighbouring queries of one (batch, head) and walks
// their L * P samples together, R samples a group in flight (8 a warp:
// the corner rows of R samples take 16 R V registers a lane, and at D =
// 32 two samples a group (108 registers) ran 1.15x the time of one (H100),
// more warps a SM hiding the loads better than more loads a warp).
template <int G, int V>
__global__ void __launch_bounds__(32 * kGroupWarps)
msdeform_forward_group_kernel(const float* __restrict__ value,
                              const float* __restrict__ loc,
                              const float* __restrict__ attn,
                              float* __restrict__ out, Levels lv, int q_blocks,
                              int S, int Q, int H, int D, int L, int P) {
  constexpr int NG = 32 / G;                  // queries a warp holds
  constexpr int R = 8 / NG > 0 ? 8 / NG : 1;  // samples a group in flight
  __shared__ int s_h[kMaxLevels], s_w[kMaxLevels], s_start[kMaxLevels];
  msd::stage_levels(lv, s_h, s_w, s_start);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane / G, j = lane % G;
  // block -> (b, run of kGroupWarps * NG queries, head), head fastest
  const int h = static_cast<int>(blockIdx.x % H);
  const int rest = static_cast<int>(blockIdx.x / H);
  const long long b = rest / q_blocks;
  const int q0 = ((rest % q_blocks) * kGroupWarps + warp) * NG;
  if (q0 >= Q) return;                       // whole warps leave together
  const bool live_q = q0 + gi < Q;
  const long long item = (b * Q + (live_q ? q0 + gi : q0)) * H + h;
  const long long row = static_cast<long long>(H) * D;       // token stride
  const float* vb = value + b * S * row + static_cast<long long>(h) * D;
  const int LP = L * P;
  const float2* loc_i = reinterpret_cast<const float2*>(loc) + item * LP;
  const float* att_i = attn + item * LP;
  const float inv_p = 1.f / P;

  float4 acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < LP; s0 += R) {
    float4 t[R][4][V];
    Corners c[R];
    float a[R];
    // every load of the R samples first ...
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = s0 + r < LP ? s0 + r : s0;
      const bool live = live_q && s0 + r < LP;
      const int l = msd::small_div(s, inv_p);
      const int wl = s_w[l];
      const float2 uv = live ? __ldg(loc_i + s) : make_float2(0.f, 0.f);
      a[r] = live ? __ldg(att_i + s) : 0.f;
      c[r] = corners(uv, s_h[l], wl);
      msd::load_taps<G, V>(vb + static_cast<long long>(s_start[l]) * row, row, wl,
                           c[r], live, j, D, t[r]);
    }
    // ... then the sums, sample by sample in (level, point) order
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (s0 + r >= LP) break;                // uniform over the warp
      const float tx = c[r].tx, ty = c[r].ty;
      const float w00 = (1.f - ty) * (1.f - tx), w01 = (1.f - ty) * tx;
      const float w10 = ty * (1.f - tx), w11 = ty * tx;
      // a non-finite location reads zeros and meets NaN, as in the plain
      // version; an off-map sample still meets a (0 · NaN = NaN)
      const float af = c[r].finite ? a[r] : __int_as_float(0x7fc00000);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float4 *v = &t[r][0][k], *v1 = &t[r][1][k], *v2 = &t[r][2][k],
                     *v3 = &t[r][3][k];
        acc[k].x = fmaf(af, bilinear(v->x, v1->x, v2->x, v3->x, w00, w01, w10, w11),
                        acc[k].x);
        acc[k].y = fmaf(af, bilinear(v->y, v1->y, v2->y, v3->y, w00, w01, w10, w11),
                        acc[k].y);
        acc[k].z = fmaf(af, bilinear(v->z, v1->z, v2->z, v3->z, w00, w01, w10, w11),
                        acc[k].z);
        acc[k].w = fmaf(af, bilinear(v->w, v1->w, v2->w, v3->w, w00, w01, w10, w11),
                        acc[k].w);
      }
    }
  }
  if (!live_q) return;
  float* out_i = out + item * D;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = msd::chunk_channel<G>(k, j);
    if (ch < D) *reinterpret_cast<float4*>(out_i + ch) = acc[k];
  }
}

// The group kernel's launch for G lanes of V float4 chunks a query.
template <int G, int V>
int launch_forward_group(const float* value, const float* loc, const float* attn,
                         float* out, const Levels& lv, int B, int S, int Q, int H,
                         int D, int L, int P, cudaStream_t stream) {
  const int per_block = kGroupWarps * (32 / G);
  const int q_blocks = (Q + per_block - 1) / per_block;
  const long long blocks = static_cast<long long>(B) * q_blocks * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  msdeform_forward_group_kernel<G, V>
      <<<static_cast<unsigned>(blocks), 32 * kGroupWarps, 0, stream>>>(
          value, loc, attn, out, lv, q_blocks, S, Q, H, D, L, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int msdeform_forward_f32(const void* value, const void* loc,
                                    const void* attn, void* out, int B,
                                    int S, int Q, int H, int D, int L, int P,
                                    const int* level_h, const int* level_w,
                                    const int* level_start, void* stream) {
  Levels lv;
  if (P < 1 || D < 1 || H < 1 ||
      !make_levels(L, level_h, level_w, level_start, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
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

// K7 on the lane-group kernel: D % 8 == 0, D <= 64, 16-byte aligned value
// and out; any other call returns cudaErrorInvalidValue.  G is the least
// power of two with 8 G >= D (V = 2 chunks, 8 channels a lane).
extern "C" int msdeform_forward_group_f32(const void* value, const void* loc,
                                          const void* attn, void* out, int B,
                                          int S, int Q, int H, int D, int L,
                                          int P, const int* level_h,
                                          const int* level_w,
                                          const int* level_start, void* stream) {
  Levels lv;
  if (B < 0 || Q < 0 || H < 1 || P < 1 || D < 8 || D % 8 != 0 ||
      D > kGroupMaxD || !msd::aligned16(value) || !msd::aligned16(out) ||
      !make_levels(L, level_h, level_w, level_start, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto v = static_cast<const float*>(value);
  const auto lc = static_cast<const float*>(loc);
  const auto at = static_cast<const float*>(attn);
  const auto o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (D <= 8 ? 1 : D <= 16 ? 2 : D <= 32 ? 4 : 8) {
    case 1:
      return launch_forward_group<1, 2>(v, lc, at, o, lv, B, S, Q, H, D, L, P, st);
    case 2:
      return launch_forward_group<2, 2>(v, lc, at, o, lv, B, S, Q, H, D, L, P, st);
    case 4:
      return launch_forward_group<4, 2>(v, lc, at, o, lv, B, S, Q, H, D, L, P, st);
    default:
      return launch_forward_group<8, 2>(v, lc, at, o, lv, B, S, Q, H, D, L, P, st);
  }
}
