// Multi-scale deformable attention backward, float32 throughout: K8
// (d_attn and d_loc) and K9 (d_value), two kernels and two launches.
//
// Replaces transcar_tpu/ops/pallas_msdeform.py::_bwd_taps_pair (K8, the
// Pallas _bwd_taps_kernel) and ::_bwd_value_pair (K9, _bwd_value_kernel).
// The wrapper, the bound and the design are described in
// transcar_tpu_torch/ops/pallas_msdeform.py.
//
// For the forward out[b, q, h*D + d] = sum_{l,p} a * s_d, with a =
// attn[b,q,h,l,p], the sample s = bilinear(value_l[b, :, :, h, :],
// loc[b,q,h,l,p]) = v00 w00 + v01 w01 + v10 w10 + v11 w11 (corner weights
// w00 = (1-ty)(1-tx), w01 = (1-ty) tx, w10 = ty (1-tx), w11 = ty tx; a
// corner off the map reads 0) and g = d_out[b, q, h*D : (h+1)*D]:
//
//   K8  d_attn[b,q,h,l,p]     = sum_d g_d s_d
//       d_loc[b,q,h,l,p, 0]   = a * sum_d g_d ds_d/dtx * W_l
//       d_loc[b,q,h,l,p, 1]   = a * sum_d g_d ds_d/dty * H_l
//         ds/dtx = (v01 - v00)(1-ty) + (v11 - v10) ty
//         ds/dty = (v10 - v00)(1-tx) + (v11 - v01) tx
//   K9  d_value[b, corner, h, d] += (g_d * a) * w_corner   (float atomics)
//
// tx = x - floor(x) is differentiated with floor's zero derivative, as
// autograd does: at an integer coordinate the derivative is the one-sided
// one towards the next cell.  A non-finite location gives NaN d_attn and
// d_loc and adds nothing to d_value.  Layouts (contiguous float32): value
// and d_value [B, S, H, D], loc and d_loc [B, Q, H, L, P, 2] (x, y), attn
// and d_attn [B, Q, H, L, P], d_out [B, Q, H, D]; d_value is zeroed by the
// caller.  One warp per (b, q, h); lane i holds channels d = i, i + 32, ...
// so every tap is one coalesced read (K8) or atomic add (K9) of D floats.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 8;          // warps per block

struct Levels {
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
};

// The bilinear footprint of one sample on a level of hl x wl cells, with
// grid_sample(align_corners=False) coordinates x = u * W_l - 0.5,
// y = v * H_l - 0.5 and zero padding, rounded as K7 (msdeform_forward.cu,
// which keeps the same arithmetic inline: shared as this function, it took
// K7 from 80 to 100 registers and 1.56x the time on an H100) and the plain
// version round it.
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(32 * kWarps)
msdeform_backward_taps_kernel(const float* __restrict__ value,
                              const float* __restrict__ loc,
                              const float* __restrict__ attn,
                              const float* __restrict__ d_out,
                              float* __restrict__ d_loc,
                              float* __restrict__ d_attn, Levels lv,
                              long long items, int S, int Q, int H, int D,
                              int L, int P) {
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
  const float* g_i = d_out + item * D;
  float2* dloc_i = reinterpret_cast<float2*>(d_loc) + item * L * P;
  float* dattn_i = d_attn + item * L * P;
  const float g0 = lane < D ? __ldg(g_i + lane) : 0.f;    // first 32 ch.

#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= L) break;
    const int hl = lv.h[l], wl = lv.w[l];
    const float* vl = vb + lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const float2 uv = __ldg(loc_i + l * P + p);         // warp broadcast
      const float a = __ldg(att_i + l * P + p);
      const Corners c = corners(uv, hl, wl);
      float sg = 0.f, sx = 0.f, sy = 0.f;
      if (c.finite) {
        const float tx = c.tx, ty = c.ty;
        const long long t00 = c.tok * row;
        const long long t10 = t00 + wl * row;
        for (int d = lane; d - lane < D; d += 32) {
          const bool active = d < D;
          float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;
          if (active && c.v00) v00 = __ldg(vl + t00 + d);
          if (active && c.v01) v01 = __ldg(vl + t00 + row + d);
          if (active && c.v10) v10 = __ldg(vl + t10 + d);
          if (active && c.v11) v11 = __ldg(vl + t10 + row + d);
          const float g = d == lane ? g0 : (active ? __ldg(g_i + d) : 0.f);
          const float s = v00 * ((1.f - ty) * (1.f - tx))
                          + v01 * ((1.f - ty) * tx)
                          + v10 * (ty * (1.f - tx))
                          + v11 * (ty * tx);
          const float dx = (v01 - v00) * (1.f - ty) + (v11 - v10) * ty;
          const float dy = (v10 - v00) * (1.f - tx) + (v11 - v01) * tx;
          sg = fmaf(g, s, sg);
          sx = fmaf(g, dx, sx);
          sy = fmaf(g, dy, sy);
        }
      }
      sg = warp_sum(sg);
      sx = warp_sum(sx);
      sy = warp_sum(sy);
      if (lane == 0) {
        const float nan = __int_as_float(0x7fc00000);
        dattn_i[l * P + p] = c.finite ? sg : nan;
        dloc_i[l * P + p] = c.finite
            ? make_float2((a * sx) * static_cast<float>(wl),
                          (a * sy) * static_cast<float>(hl))
            : make_float2(nan, nan);
      }
    }
  }
}

__global__ void __launch_bounds__(32 * kWarps)
msdeform_backward_value_kernel(const float* __restrict__ loc,
                               const float* __restrict__ attn,
                               const float* __restrict__ d_out,
                               float* __restrict__ d_value, Levels lv,
                               long long items, int S, int Q, int H, int D,
                               int L, int P) {
  const long long item = static_cast<long long>(blockIdx.x) * kWarps
                         + (threadIdx.x >> 5);             // (b, q, h)
  if (item >= items) return;
  const int lane = threadIdx.x & 31;
  const int h = static_cast<int>(item % H);
  const long long b = item / H / Q;
  const long long row = static_cast<long long>(H) * D;
  float* db = d_value + b * S * row + static_cast<long long>(h) * D;
  const float2* loc_i = reinterpret_cast<const float2*>(loc) + item * L * P;
  const float* att_i = attn + item * L * P;
  const float* g_i = d_out + item * D;
  const float g0 = lane < D ? __ldg(g_i + lane) : 0.f;

#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= L) break;
    const int hl = lv.h[l], wl = lv.w[l];
    float* dl = db + lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const float2 uv = __ldg(loc_i + l * P + p);
      const float a = __ldg(att_i + l * P + p);
      const Corners c = corners(uv, hl, wl);
      if (!c.finite || !(c.v00 || c.v01 || c.v10 || c.v11)) continue;
      const float tx = c.tx, ty = c.ty;
      const float w00 = (1.f - ty) * (1.f - tx), w01 = (1.f - ty) * tx;
      const float w10 = ty * (1.f - tx), w11 = ty * tx;
      const long long t00 = c.tok * row;
      const long long t10 = t00 + wl * row;
      for (int d = lane; d - lane < D; d += 32) {
        if (d >= D) break;
        const float ga = (d == lane ? g0 : __ldg(g_i + d)) * a;
        if (c.v00) atomicAdd(dl + t00 + d, ga * w00);
        if (c.v01) atomicAdd(dl + t00 + row + d, ga * w01);
        if (c.v10) atomicAdd(dl + t10 + d, ga * w10);
        if (c.v11) atomicAdd(dl + t10 + row + d, ga * w11);
      }
    }
  }
}

// The launch shape shared by K8 and K9: blocks of kWarps warps over the
// B*Q*H items; 0 blocks for no items, -1 for an invalid shape.
long long launch_blocks(int B, int Q, int H, int D, int P,
                        long long* items) {
  if (B < 0 || Q < 0 || P < 1 || D < 1 || H < 1) return -1;
  *items = static_cast<long long>(B) * Q * H;
  const long long blocks = (*items + kWarps - 1) / kWarps;
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

}  // namespace

extern "C" int msdeform_backward_taps_f32(
    const void* value, const void* loc, const void* attn, const void* d_out,
    void* d_loc, void* d_attn, int B, int S, int Q, int H, int D, int L,
    int P, const int* level_h, const int* level_w, const int* level_start,
    void* stream) {
  Levels lv;
  long long items = 0;
  const long long blocks = launch_blocks(B, Q, H, D, P, &items);
  if (blocks < 0 ||
      !make_levels(L, level_h, level_w, level_start, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  msdeform_backward_taps_kernel<<<static_cast<unsigned>(blocks),
                                  32 * kWarps, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const float*>(d_out),
      static_cast<float*>(d_loc), static_cast<float*>(d_attn), lv, items, S,
      Q, H, D, L, P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int msdeform_backward_value_f32(
    const void* loc, const void* attn, const void* d_out, void* d_value,
    int B, int S, int Q, int H, int D, int L, int P, const int* level_h,
    const int* level_w, const int* level_start, void* stream) {
  Levels lv;
  long long items = 0;
  const long long blocks = launch_blocks(B, Q, H, D, P, &items);
  if (blocks < 0 ||
      !make_levels(L, level_h, level_w, level_start, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  msdeform_backward_value_kernel<<<static_cast<unsigned>(blocks),
                                   32 * kWarps, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(loc), static_cast<const float*>(attn),
      static_cast<const float*>(d_out), static_cast<float*>(d_value), lv,
      items, S, Q, H, D, L, P);
  return static_cast<int>(cudaGetLastError());
}
