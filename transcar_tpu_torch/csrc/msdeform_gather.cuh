// The per-sample arithmetic of the multi-scale deformable attention
// kernels, float32: the level table, the bilinear footprint of one sample
// (corners()), a lane group's channel ownership and the lane-group gather
// and scatter of a sample's four corner rows.
//
// The lane-group kernels of K7 (msdeform_forward.cu) and K8
// (msdeform_backward.cu) read their corners through corners() and
// load_taps(); K9's source list takes corners() too.  The first
// K7 kernel keeps its own inline copy of corners(): shared as a function,
// it took that kernel from 80 to 100 registers and 1.56x the time on an
// H100; the group kernels compute it once for 8 channels a lane, where
// the first kernels compute it once a channel.
//
// Lane-group layout: G lanes own one sample (a warp holds 32 / G samples at
// a time); lane j of a group holds the float4 chunks k < V of the head's
// channels 4 (k G + j) .. 4 (k G + j) + 3 (chunk_channel()), so each load
// instruction of a group reads G x 16 contiguous bytes of one corner row
// and a row of D = 4 G V channels takes V instructions.  A chunk at or
// past D holds zeros.
#pragma once

#include <cuda_runtime.h>

namespace msd {

constexpr int kMaxLevels = 8;

struct Levels {
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
};

// The bilinear footprint of one sample on a level of hl x wl cells, with
// grid_sample(align_corners=False) coordinates x = u * W_l - 0.5,
// y = v * H_l - 0.5 and zero padding, rounded as K7 and the plain version
// round it.
struct Corners {
  bool finite;                 // false for a non-finite location
  bool v00, v01, v10, v11;     // which corners lie on the map
  long long tok;               // token of corner (y0, x0) within the level
  float tx, ty;                // fractional position inside the cell
};

__device__ __forceinline__ Corners corners(float2 uv, int hl, int wl) {
  Corners c{};
  // the plain version's rounding: one multiply, then one subtract
  const float x = __fsub_rn(__fmul_rn(uv.x, static_cast<float>(wl)), 0.5f);
  const float y = __fsub_rn(__fmul_rn(uv.y, static_cast<float>(hl)), 0.5f);
  c.finite = isfinite(x) && isfinite(y);
  if (!c.finite) return c;
  const float x0 = floorf(x), y0 = floorf(y);
  c.tx = x - x0;
  c.ty = y - y0;
  // validity in float, and the index from clamped values: a far-off
  // location forms no out-of-range int
  const bool vx0 = x0 >= 0.f && x0 <= wl - 1.f;
  const bool vx1 = x0 >= -1.f && x0 <= wl - 2.f;
  const bool vy0 = y0 >= 0.f && y0 <= hl - 1.f;
  const bool vy1 = y0 >= -1.f && y0 <= hl - 2.f;
  c.v00 = vy0 && vx0;
  c.v01 = vy0 && vx1;
  c.v10 = vy1 && vx0;
  c.v11 = vy1 && vx1;
  const int ix = static_cast<int>(fminf(fmaxf(x0, -1.f), wl));
  const int iy = static_cast<int>(fminf(fmaxf(y0, -1.f), hl));
  c.tok = static_cast<long long>(iy) * wl + ix;
  return c;
}

// The level table of a launch; false if L is out of range.
inline bool make_levels(int L, const int* level_h, const int* level_w,
                        const int* level_start, Levels* lv) {
  if (L < 1 || L > kMaxLevels) return false;
  *lv = Levels{};
  for (int l = 0; l < L; ++l) {
    lv->h[l] = level_h[l];
    lv->w[l] = level_w[l];
    lv->start[l] = level_start[l];
  }
  return true;
}

// Whether a pointer is 16-byte aligned (rows read or written as float4).
inline bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// The first channel of lane j's chunk k in a group of G lanes.
template <int G>
__device__ __forceinline__ int chunk_channel(int k, int j) {
  return 4 * (k * G + j);
}

// The level table of a launch, copied into shared memory by thread 0 for
// the group kernels, which index it by a level known only at run time;
// the caller synchronises.
__device__ __forceinline__ void stage_levels(const Levels& lv, int* s_h, int* s_w,
                                             int* s_start) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      s_h[l] = lv.h[l];
      s_w[l] = lv.w[l];
      s_start[l] = lv.start[l];
    }
  }
}

// a / b for small non-negative ints, by the float reciprocal inv = 1 / b:
// (a + 0.5) / b lies at least 0.5 / b from an integer, far past the
// rounding of the product for a < 2^20
__device__ __forceinline__ int small_div(int a, float inv) {
  return static_cast<int>((static_cast<float>(a) + 0.5f) * inv);
}

// Issue lane j's loads of the four corner rows of one sample: t[corner][k]
// (corners 00, 01, 10, 11) is chunk k, zero where the corner is off the
// map, the chunk past D, the sample dead or its location non-finite.  vl:
// the level's first token of this (batch, head); row: the token stride
// H * D.  The rows must be 16-byte aligned (D % 4 == 0, aligned base).
template <int G, int V>
__device__ __forceinline__ void load_taps(const float* vl, long long row, int wl,
                                          const Corners& c, bool live, int j, int D,
                                          float4 (&t)[4][V]) {
  const long long t00 = c.tok * row, t10 = t00 + wl * row;
  const bool ok = live && c.finite;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = chunk_channel<G>(k, j);
    const bool in = ok && ch < D;
    const float* p = vl + ch;
    t[0][k] = in && c.v00 ? __ldg(reinterpret_cast<const float4*>(p + t00)) : zero;
    t[1][k] = in && c.v01 ? __ldg(reinterpret_cast<const float4*>(p + t00 + row)) : zero;
    t[2][k] = in && c.v10 ? __ldg(reinterpret_cast<const float4*>(p + t10)) : zero;
    t[3][k] = in && c.v11 ? __ldg(reinterpret_cast<const float4*>(p + t10 + row)) : zero;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

}  // namespace msd
